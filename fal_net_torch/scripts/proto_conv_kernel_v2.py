"""K4 on the card: the 3x3 conv from phase-permuted weights
(``ops.conv3x3.conv3x3_v2``, which launches ``csrc/conv3x3_wgmma.cu`` on
their variant 0) at the JAX prototype's cases
(scripts/proto_conv_kernel_v2.py), against its plain versions and cuDNN.

    python -m fal_net_torch.scripts.proto_conv_kernel_v2

Prints what ``fal_net_torch.scripts.proto_conv_kernel`` prints, per case.
A disagreement raises.  Runs on the GPU only.
"""

from __future__ import annotations

import argparse

from fal_net_torch.ops.conv3x3 import conv3x3_v2, conv3x3_v2_plain, permuted_weights
from fal_net_torch.scripts._conv_bench import run_cases

# (B, Cin, H, W, Cout), scripts/proto_conv_kernel_v2.py:168-171
CASES = [
    (1, 32, 384, 1280, 32),
    (8, 64, 192, 640, 64),
]


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)  # --help only
    return run_cases("K4 v2", conv3x3_v2, conv3x3_v2_plain, permuted_weights, CASES)


if __name__ == "__main__":
    main()
