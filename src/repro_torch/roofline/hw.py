"""NVIDIA H100 SXM constants for the roofline model (per card).

From NVIDIA's public H100 datasheet ("NVIDIA H100 Tensor Core GPU",
https://www.nvidia.com/en-us/data-center/h100/), the SXM part, dense
rates (no sparsity), at the card's full 700 W power limit: a card set
below it runs slower under load, so a measured time is read beside the
card's name and power limit.
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
NVLINK_BW = 900e9             # bytes/s per card, NVLink (4th generation)
HBM_BYTES = 80 * 10**9        # capacity per card (80 GB)
L2_BYTES = 50 * 2**20       # L2 cache (50 MB)
