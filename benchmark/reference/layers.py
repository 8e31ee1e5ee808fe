"""Linear and convolution layers of the plain reference, and the precision
they compute in.

The reference computes in float32 with TF32 off. `Precision` selects the
lower precisions of the control: the UNet's matmuls and convolutions with
weights and inputs rounded through float8 e4m3 (one scale per tensor, the
step below the configuration's bfloat16), and the float32 parts (VAE,
CLIP) on TF32.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

_E4M3_MAX = 448.0


@dataclasses.dataclass
class Precision:
    """fp8: round matmul/conv weights and inputs through float8 e4m3."""

    fp8: bool = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded through float8 e4m3 with one scale for the tensor."""
    scale = x.abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Linear(nn.Linear):
    def __init__(self, cin: int, cout: int, bias: bool = True, prec: Precision | None = None):
        super().__init__(cin, cout, bias=bias, device="meta")
        self.prec = prec or Precision()

    def forward(self, x):
        if self.prec.fp8:
            return F.linear(fp8_round(x), fp8_round(self.weight), self.bias)
        return F.linear(x, self.weight, self.bias)


class Conv2d(nn.Conv2d):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 prec: Precision | None = None):
        super().__init__(cin, cout, k, stride=stride, padding=padding, device="meta")
        self.prec = prec or Precision()

    def forward(self, x):
        if self.prec.fp8:
            return self._conv_forward(fp8_round(x), fp8_round(self.weight), self.bias)
        return self._conv_forward(x, self.weight, self.bias)


def group_norm(groups: int, ch: int, eps: float) -> nn.GroupNorm:
    return nn.GroupNorm(groups, ch, eps=eps, device="meta")


def layer_norm(ch: int, eps: float = 1e-5) -> nn.LayerNorm:
    return nn.LayerNorm(ch, eps=eps, device="meta")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None, chunk: int = 1) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + mask) v in plain matmuls, q/k/v [B, H, L, d];
    `chunk` batch rows at a time to bound the [B, H, L, L] scores."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for i in range(0, q.shape[0], chunk):
        s = torch.matmul(q[i:i + chunk], k[i:i + chunk].transpose(-1, -2)) * scale
        if mask is not None:
            s = s + mask
        outs.append(torch.matmul(torch.softmax(s, dim=-1), v[i:i + chunk]))
    return torch.cat(outs, dim=0)


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 for cuBLAS and cuDNN inside the block (the control's float32
    parts); off (full float32) otherwise."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
