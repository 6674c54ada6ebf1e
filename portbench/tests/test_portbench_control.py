"""On the card, at each cell's own size: the control (the program's own
bfloat16 path, the precision below the configuration's) fails the cell's
correctness check, and the sound program passes it on the same seed.  A
short window, one seed a cell (portbench/control.py takes a dozen)."""

import pytest
import torch

from portbench import control
from portbench.harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_sound_passes(card, cell):
    c = spec.cell(cell)
    sound = control.reading(c, 20260919, 2.0, "sound", card)
    low = control.reading(c, 20260919, 2.0, "control", card)
    assert sound["correct"] is True, sound
    assert low.get("correct") is not True, low
