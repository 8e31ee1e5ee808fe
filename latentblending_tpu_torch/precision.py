"""The port's float32 setting, shared by its scripts and chip_smoke.py.

PyTorch leaves `torch.backends.cudnn.allow_tf32` on by default, so an f32
convolution (the f32 VAE's, LPIPS's) would run on TF32 tensor cores with a
10-bit mantissa; `torch.backends.cuda.matmul.allow_tf32` is off by default
but a caller may have turned it on. The JAX package computes these in full
float32, and the port is held to it in that precision. The hand-written
kernels (csrc/) do not read these switches.

The package itself never changes them: they are process-wide, and a
library should not change its caller's global state. The port's example
scripts (apps/) and chip_smoke.py call disable_tf32() first.
"""
from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Full float32 for cuBLAS matmuls and cuDNN convolutions in this process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
