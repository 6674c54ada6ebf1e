"""Quickstart on the PyTorch/CUDA port: train + evaluate FAL-net on synthetic
stereo, no dataset needed.

    python examples/quickstart_synthetic_torch.py [--device cpu]

The port's counterpart of ``examples/quickstart_synthetic.py``, step by
step: a shifted-pattern stereo dataset (right view = left shifted by a
constant disparity), a tiny FAL-net trained for a few stage-1 steps, then
inference with multi-scale post-processing.  It runs on the GPU (``cuda``)
unless ``--device cpu`` asks for the CPU; without a card it raises.  It
trains on one device: the port's multi-GPU training is DistributedDataParallel
through ``python -m fal_net_torch.cli.train --num_devices K``.  Swap ``tiny``
for ``B`` and point the data layer at KITTI for the real thing (see README).

``main`` returns the training history and the post-processed disparity,
(1, 1, H, W) on the CPU.
"""

import argparse
import os
import sys

# runnable straight from a source checkout (python examples/...) without
# installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from fal_net_torch.eval.postprocess import ms_post_process
from fal_net_torch.train import Stage1Config, Trainer
from fal_net_torch.utils.device import resolve_device


class SyntheticStereo:
    """Right view = left shifted by DISP pixels -> the network can learn
    to predict DISP everywhere."""

    DISP = 6

    def __init__(self, n=64, h=64, w=128):
        self.n, self.h, self.w = n, h, w

    def __len__(self):
        return self.n

    def get(self, index, rng):
        r = np.random.default_rng(index)
        wide = r.random((self.h, self.w + self.DISP, 3)).astype(np.float32)
        return {
            "left": wide[:, : self.w] - 0.5,
            "right": wide[:, self.DISP :] - 0.5,
            "max_disp": np.float32(24.0),
            "name": f"synth_{index}",
        }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default: cuda; cpu only when asked for)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = Stage1Config(
        model="tiny",
        num_levels=9,
        crop_size=(64, 128),
        batch_size=8,
        epochs=2,
        lr=4e-4,
        max_disp=24.0,
        min_disp=2.0,
        a_p=0.0,  # no perceptual net in the quickstart
        print_freq=4,
        workers=2,
    )
    trainer = Trainer(cfg, stage="stage1", device=device, train_dataset=SyntheticStereo())
    result = trainer.fit(save_path="runs/quickstart")
    print("training history:", [round(h["loss"], 4) for h in result["history"]])

    # inference + ms post-processing on a fresh sample
    sample = SyntheticStereo().get(999, None)
    left = torch.from_numpy(sample["left"]).permute(2, 0, 1)[None].contiguous().to(device)
    model = trainer.model.eval()

    def disp_fn(im):
        return model(im, cfg.min_disp, cfg.max_disp, ret_disp=True).disp

    with torch.no_grad():
        disp = disp_fn(left)
        disp_pp = ms_post_process(left, disp_fn, disp).cpu()
    d = disp_pp[0, 0].numpy()
    print(
        f"predicted disparity: median {np.median(d):.2f} px, "
        f"range [{d.min():.2f}, {d.max():.2f}] "
        f"(ground truth {SyntheticStereo.DISP}; a couple of quickstart epochs "
        f"only starts pulling the prior toward it — train longer to converge)"
    )
    return {"history": result["history"], "disparity": disp_pp}


if __name__ == "__main__":
    main()
