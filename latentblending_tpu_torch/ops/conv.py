"""C1: 3x3, stride-1, padding-1 convolution in float32 — the hand-written
CUDA kernel and its plain PyTorch version.

Replaces no TPU kernel: the JAX package's convolutions are XLA's (flax
`nn.Conv`). C1 takes the port's float32 3x3 stride-1 convolutions off
cuDNN, which runs them in float32 on the CUDA cores (FFMA) with TF32 off:
the f32 VAE decoder's 31 a decode call (mid block 4, up blocks 24,
upsamplers 3), and the encoder's and an f32 UNet's stride-1 ones.

Kernel: csrc/conv3x3_f32.cu, an implicit GEMM on TF32 wgmma in 3xTF32
(hi/lo operand split, ~f32 accuracy), NCHW in and out, the padding from
TMA's out-of-bounds zeros, the bias added in its epilogue, the weights
split per tile (no copy of them is kept).

`route(conv, x)` is the module's choice (models/layers.py::Conv3x3): a
CUDA float32 input, contiguous, to a 3x3 stride-1 padding-1 convolution
whose channels and width the kernel takes; everything else stays on
F.conv2d. (An NHWC-strided input stays there too: an f32 UNet called on
the holder's NHWC latents keeps its residual stream in those strides, and
its two upsamplers' convs, which read the stream itself, run on cuDNN.) `conv3x3_f32` takes CUDA tensors to the kernel (or raises) and
CPU tensors to `conv3x3_reference`; nothing falls back from one to the
other.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from latentblending_tpu_torch import profiling

# the kernel's K blocks are 8 input channels; its output-channel tiles are
# 128 wide and the route asks for whole halves of one (narrower layers,
# conv_out's 3 or 4 channels, would waste most of a tile); its input boxes
# need rows of a multiple of 16 bytes (TMA strides)
CIN_MULTIPLE = 8
COUT_MULTIPLE = 64
W_MULTIPLE = 4


def takes(conv: torch.nn.Conv2d, shape, dtype: torch.dtype) -> bool:
    """Whether C1 computes `conv` on a float32 input of `shape` [B, C, H, W]
    (the device and the layout aside)."""
    return (dtype == torch.float32 and conv.weight.dtype == torch.float32 and len(shape) == 4
            and tuple(conv.kernel_size) == (3, 3) and tuple(conv.stride) == (1, 1)
            and tuple(conv.padding) == (1, 1) and tuple(conv.dilation) == (1, 1) and conv.groups == 1
            and conv.padding_mode == "zeros" and shape[1] == conv.in_channels
            and conv.in_channels % CIN_MULTIPLE == 0 and conv.out_channels % COUT_MULTIPLE == 0
            and shape[3] % W_MULTIPLE == 0)


def route(conv: torch.nn.Conv2d, x: torch.Tensor) -> bool:
    """The module's route: C1 for a contiguous CUDA input it takes."""
    return x.is_cuda and x.is_contiguous() and takes(conv, x.shape, x.dtype)


def conv3x3_reference(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """Plain version, the kernel's GEMM in PyTorch: for each of the 9 taps,
    the zero-padded input shifted by the tap times that tap's [Cout, Cin]
    weights, summed over the taps, plus the bias. x [B, Cin, H, W], weight
    [Cout, Cin, 3, 3] → [B, Cout, H, W] in x's dtype."""
    B, _, H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    out = None
    for r in range(3):
        for s in range(3):
            term = torch.einsum("oc,bchw->bohw", weight[:, :, r, s], xp[:, :, r:r + H, s:s + W])
            out = term if out is None else out + term
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def conv3x3_f32(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """3x3 convolution, stride 1, zero padding 1: x [B, Cin, H, W] float32,
    weight [Cout, Cin, 3, 3], bias [Cout] or None → [B, Cout, H, W]."""
    if stride != 1 or padding != 1:
        raise ValueError(f"conv3x3_f32: stride {stride}, padding {padding}; C1 is stride 1, padding 1")
    if not x.is_cuda:
        return conv3x3_reference(x, weight, bias)
    tensors = [x, weight] + ([bias] if bias is not None else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"conv3x3_f32: float32 only, got {[t.dtype for t in tensors]}")
    if any(not t.is_cuda or t.device != x.device for t in tensors):
        raise ValueError("conv3x3_f32: x, weight and bias must be on the same CUDA device")
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"conv3x3_f32: x {tuple(x.shape)} and weight {tuple(weight.shape)} are not "
                         f"[B, Cin, H, W] and [Cout, Cin, 3, 3]")
    B, Cin, H, W = x.shape
    Cout = weight.shape[0]
    if bias is not None and tuple(bias.shape) != (Cout,):
        raise ValueError(f"conv3x3_f32: bias {tuple(bias.shape)} for {Cout} output channels")
    if Cin % CIN_MULTIPLE or W % W_MULTIPLE:
        raise ValueError(f"conv3x3_f32: Cin {Cin} (a multiple of {CIN_MULTIPLE}) and W {W} (a multiple of "
                         f"{W_MULTIPLE}) do not fit the kernel's tiles")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3_f32: x, weight and bias must be contiguous (NCHW, OIHW)")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("conv3x3_f32: x, weight and bias must start on a 16-byte boundary (TMA, 16-byte loads)")
    from latentblending_tpu_torch.ops import _build

    out = torch.empty((B, Cout, H, W), dtype=torch.float32, device=x.device)
    _build.launch("lb_conv3x3_f32", x, weight, bias if bias is not None else 0, out, B, Cin, Cout, H, W)
    profiling.count("C1")
    return out
