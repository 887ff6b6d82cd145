"""Published peaks of one NVIDIA H100 SXM, the yardstick of every share.

NVIDIA's H100 data sheet ("NVIDIA H100 Tensor Core GPU"), the SXM part,
dense rates (no sparsity), at the card's full 700 W power limit; a card
set below it runs slower under load, so the result line of a run names
the card. Copied from the program's ``roofline/hw.py``, and kept here
so that a change to the program cannot move the yardstick.
"""

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores, dense
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # bytes/s, HBM3
HBM_BYTES = 80 * 10**9        # capacity per card (80 GB)
