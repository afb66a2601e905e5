"""The card's published figures, frozen for the benchmark.

A copy of ``src/repro_torch/roofline/hw.py``'s peaks (NVIDIA's H100 SXM
data sheet, dense rates, the 700 W part), kept here so that a change to
the program cannot move the yardstick.  A card set below 700 W runs
slower under load than these peaks; every result names the card.
"""

# NVIDIA H100 80GB HBM3, 700.00 W: bf16 tensor cores, dense
PEAK_FLOPS_BF16 = 989e12          # FLOP/s
# TF32 tensor cores, dense: the rate of the recurrences' 3xTF32 products
PEAK_FLOPS_TF32 = 495e12          # FLOP/s
# HBM3
HBM_BYTES_PER_S = 3.35e12         # bytes/s
