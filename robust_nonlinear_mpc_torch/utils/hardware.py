"""Published peaks of one NVIDIA H100 (NVIDIA's data sheet, SXM part, dense
rates without sparsity, at the full 700 W power limit): the bounds that
`chip_smoke.py` holds the kernels against and the roofline fields of the
bench twin's record."""

import torch

# HBM3 bytes per second
PEAK_BYTES = 3.35e12
# FLOP/s: float32 and float64 on the CUDA cores, bfloat16 on the tensor cores
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}
