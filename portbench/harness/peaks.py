"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  A card set below 700 W runs under
them; every run prints its card's limit beside the shares."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # on the CUDA cores
TF32_FLOPS = 494.7e12  # tensor cores
BF16_FLOPS = 989.4e12  # tensor cores

# a configuration's compute dtype -> the peak its convolutions run against:
# fp32 convolutions run in TF32 on the card (PyTorch's cuDNN default)
CONV_PEAK = {"float32": TF32_FLOPS, "bfloat16": BF16_FLOPS}
