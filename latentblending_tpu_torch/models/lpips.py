"""LPIPS perceptual distance (AlexNet trunk), in PyTorch.

Counterpart of latentblending_tpu/models/lpips.py, the reference's gap
metric: input [-1,1] → fixed per-channel shift/scale → AlexNet convs with
taps relu1..relu5 (3×3/stride-2 max-pools, unpadded, before conv2 and
conv3) → per-tap unit-normalisation over channels → squared difference →
learned 1×1 conv (lin) → mean over H and W → sum over the taps, in f32.

The parameters carry the `lpips` package's state-dict names
(net.slice1.0 ... net.slice5.10, lin{i}.model.1.weight), so a dump of
lpips.LPIPS(net="alex").state_dict() loads with load_state_dict. Public
tensors keep the JAX layout: images [B,H,W,3] in [-1,1]. LPIPS has no
Pallas kernel in the JAX package (flax convs and max-pools), so here it is
F.conv2d and F.max_pool2d, the same code on the CPU and on the card.
"""
from __future__ import annotations

import copy
from typing import Mapping, Optional

import torch
import torch.nn as nn

from latentblending_tpu_torch.models.layers import init_like_jax_
from latentblending_tpu_torch.models.perceptual import pair_device, prep_uint8, staging_device

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# (out channels, kernel, stride, pad, max-pool before) of AlexNet's five convs
_ALEX = [(64, 11, 4, 2, False), (192, 5, 1, 2, True), (384, 3, 1, 1, True), (256, 3, 1, 1, False),
         (256, 3, 1, 1, False)]
# torchvision's alexnet.features index of each conv; the `lpips` package
# slices the features after each relu: slice s holds indices [lo, hi)
_CONV_INDEX = [0, 3, 6, 8, 10]
_SLICES = [(0, 2), (2, 5), (5, 8), (8, 10), (10, 12)]


class _Lin(nn.Module):
    """The `lpips` package's NetLinLayer: (dropout, 1×1 conv) as `model`,
    the dropout an identity here (eval only)."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Identity(), nn.Conv2d(channels, 1, 1, bias=False))


class _AlexTrunk(nn.Module):
    def __init__(self):
        super().__init__()
        feats: dict[int, nn.Module] = {}
        c_in = 3
        for idx, (c, k, s, p, pool) in zip(_CONV_INDEX, _ALEX):
            if pool:
                feats[idx - 1] = nn.MaxPool2d(3, 2)
            feats[idx] = nn.Conv2d(c_in, c, k, s, p)
            feats[idx + 1] = nn.ReLU()
            c_in = c
        for s, (lo, hi) in enumerate(_SLICES, 1):
            seq = nn.Sequential()
            for x in range(lo, hi):
                seq.add_module(str(x), feats[x])
            setattr(self, f"slice{s}", seq)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        taps = []
        for s in range(1, len(_SLICES) + 1):
            x = getattr(self, f"slice{s}")(x)
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """forward(img0, img1): both [B,H,W,3] in [-1,1] → [B] distances (f32)."""

    def __init__(self):
        super().__init__()
        self.net = _AlexTrunk()
        for i, (c, *_rest) in enumerate(_ALEX):
            setattr(self, f"lin{i}", _Lin(c))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1), persistent=False)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        B = img0.shape[0]
        x = torch.cat([img0, img1], dim=0).float().permute(0, 3, 1, 2)
        taps = self.net((x - self.shift) / self.scale)
        total = torch.zeros((B,), dtype=torch.float32, device=img0.device)
        for i, f in enumerate(taps):
            n = f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10)
            w = getattr(self, f"lin{i}").model((n[:B] - n[B:]) ** 2)
            total = total + torch.mean(w, dim=(1, 2, 3))
        return total


def convert_lpips_state_dict(state: Mapping) -> dict[str, torch.Tensor]:
    """The `lpips` package's state dict (net.sliceK.i.*, linK.model.1.*;
    its scaling_layer buffers are the constants above and are dropped) →
    float32 tensors under the same names, the keys LPIPS carries."""
    with torch.device("meta"):
        keys = set(LPIPS().state_dict())
    return {k: torch.as_tensor(v).detach().to(torch.float32) for k, v in state.items() if k in keys}


def load_lpips_torch_file(path: str) -> dict[str, torch.Tensor]:
    """An `lpips` package checkpoint (.pth) → the state dict LPIPSScorer
    takes. The official file ships only the lin layers; the AlexNet trunk
    comes from torchvision, so pass a merged dump of
    lpips.LPIPS(net="alex").state_dict()."""
    return convert_lpips_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def random_lpips_state_dict(seed: int = 0) -> dict[str, torch.Tensor]:
    """The weight-free stand-in: flax's init (lecun-normal kernels, zero
    biases) from a torch.Generator seeded with `seed`, then the absolute
    value of every parameter (LPIPS lins are non-negative), as the JAX
    package's LPIPSScorer does without weights."""
    model = LPIPS()
    with torch.no_grad():
        init_like_jax_(model, torch.Generator().manual_seed(int(seed)))
        for p in model.parameters():
            p.abs_()
    return model.state_dict()


class LPIPSScorer:
    """distance(uint8 imgs) → float; distance_batch([-1,1] [B,H,W,3] pairs)
    → [B]. params: a state dict under the `lpips` package's names
    (convert_lpips_state_dict), or None for the random stand-in drawn from
    `seed`.

    Built for a device (the engine passes its holder's), the model lives
    there and both calls compute there. Built with device=None,
    distance_batch computes on its inputs' device (the model copied there
    once) and distance on the card."""

    def __init__(self, params: Optional[Mapping] = None, seed: int = 0, device=None):
        self.device = None if device is None else torch.device(device)
        if params is None:
            params = random_lpips_state_dict(seed)
        self.model = LPIPS()
        self.model.load_state_dict(convert_lpips_state_dict(params), strict=True)
        self.model.to(self.device or "cpu").eval().requires_grad_(False)
        self._copies: dict[torch.device, LPIPS] = {}

    @staticmethod
    def _prep(img, device=None) -> torch.Tensor:
        return prep_uint8(img, device)

    def _model_on(self, device: torch.device) -> LPIPS:
        if self.device is not None or device.type == "cpu":
            return self.model
        if device not in self._copies:
            self._copies[device] = copy.deepcopy(self.model).to(device)
        return self._copies[device]

    @torch.no_grad()
    def distance(self, img_a, img_b) -> float:
        dev = staging_device(self.device)
        return float(self.distance_batch(self._prep(img_a, dev), self._prep(img_b, dev))[0])

    @torch.no_grad()
    def distance_batch(self, imgs_a: torch.Tensor, imgs_b: torch.Tensor) -> torch.Tensor:
        return self._model_on(pair_device(self.device, imgs_a, imgs_b))(imgs_a, imgs_b)
