"""K3 on the card: the K-packed 3x3 conv (``ops.conv3x3.conv3x3_packed``, which
launches the TF32 wgmma kernel ``csrc/conv3x3_wgmma.cu``) at the JAX
prototype's cases (scripts/proto_conv_kernel.py), against its plain versions
and cuDNN.

    python -m fal_net_torch.scripts.proto_conv_kernel

Per case it prints the kernel's time (CUDA events, median after warm-up)
and TFLOP/s, the TF32 plain version's time, ``F.conv2d``'s time with TF32
off and on, the speed-ups, and the kernel's max abs error against the plain
version on TF32-truncated operands (``conv3x3_tf32_plain``) and against the
fp32 plain version, with cuDNN TF32's own error against the latter.  A
disagreement raises.  Runs on the GPU only.
"""

from __future__ import annotations

import argparse

from fal_net_torch.ops.conv3x3 import conv3x3_packed, conv3x3_packed_plain, repack_weights
from fal_net_torch.scripts._conv_bench import run_cases

# (B, Cin, H, W, Cout), scripts/proto_conv_kernel.py:130-135
CASES = [
    (1, 32, 384, 1280, 32),  # stem residual conv, full res
    (1, 64, 192, 640, 64),  # level-1 residual conv
    (8, 64, 192, 640, 64),  # training batch
    (1, 96, 384, 1280, 49),  # decoder tail iconv1
]


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)  # --help only
    return run_cases("K3 packed", conv3x3_packed, conv3x3_packed_plain, repack_weights, CASES)


if __name__ == "__main__":
    main()
