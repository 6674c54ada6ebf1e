"""Run logging (counterpart of fal_net_tpu/utils/logging.py): the settings
dump, a JSONL scalar stream and, where it imports, TensorBoard.

``settings.txt`` is the reference's config dump (Train_Stage1_K.py:73-85).
The JSONL stream (``metrics.jsonl``) is always written, opened for append
as JAX's is (a resumed run writes both files in its own new directory);
TensorBoard is used when ``tensorboardX`` or ``torch.utils.tensorboard``
imports.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict

import numpy as np


def dump_settings(save_path: str, cfg: Any) -> None:
    os.makedirs(save_path, exist_ok=True)
    if dataclasses.is_dataclass(cfg):
        items = dataclasses.asdict(cfg)
    elif isinstance(cfg, dict):
        items = cfg
    else:
        items = vars(cfg)
    lines = ["-------TRAINING SETTINGS---------"]
    lines += [f"{k:>15s}: {v}" for k, v in sorted(items.items())]
    text = "\n".join(lines)
    print(text)
    with open(os.path.join(save_path, "settings.txt"), "w") as f:
        f.write(text + "\n")


class MetricsLogger:
    def __init__(self, save_path: str, name: str = "metrics"):
        os.makedirs(save_path, exist_ok=True)
        self._f = open(os.path.join(save_path, f"{name}.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter  # type: ignore
        except ImportError:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(os.path.join(save_path, "tb"))

    def scalars(self, step: int, values: Dict[str, Any], prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in values.items():
            key = f"{prefix}{k}"
            rec[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def image(self, step: int, tag: str, image_hwc) -> None:
        if self._tb is not None:
            self._tb.add_image(tag, np.asarray(image_hwc), int(step), dataformats="HWC")

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
