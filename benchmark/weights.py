"""Random weights made from the run's seed, the same for the program and
the reference.

Each model part takes one standard normal draw, in one call, from a
torch.Generator on the device, seeded from the run's seed and the part's
index in its architecture's PARTS (benchmark/reference/<architecture>.py),
laid over its tensors in sorted name order, so the values depend only on
the seed and on the reference architecture's names and shapes (HF key
names, which the program's modules share). Matrices and convolutions are
scaled by fan_in^-1/2, biases by 0.05; norm scales are 1 + 0.1 n and norm
shifts 0.1 n. A part held in bfloat16 by the configuration (SDXL's UNet,
its norms excepted) is rounded to bfloat16, which the reference computes
on in float32. Tensors the program has and the reference does not (the
VAE's encoder) take a second draw of the same part.
"""
from __future__ import annotations

import torch

def is_norm(name: str) -> bool:
    """A GroupNorm or LayerNorm parameter (its module's name holds "norm")."""
    return "norm" in name.rsplit(".", 2)[-2]


def _values(flat: torch.Tensor, offset: int, name: str, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    v = flat[offset:offset + n].view(shape)
    if is_norm(name):
        return 1.0 + 0.1 * v if name.endswith("weight") else 0.1 * v
    if len(shape) >= 2:
        return v * (n // shape[0]) ** -0.5
    return 0.05 * v


@torch.no_grad()
def fill(tensors: dict[str, torch.Tensor], names: list[tuple[str, tuple]], seed: int, part_index: int,
         dtype: str, device) -> None:
    """Write the draw of one part into `tensors` (name → tensor): first over
    `names`, the reference's (name, shape) list, then a second draw over the
    names of `tensors` not in it. A part's non-norm values are rounded to
    its dtype (a torch dtype's name) before they are stored in any dtype."""
    known = dict(names)
    extra = [(k, tuple(t.shape)) for k, t in tensors.items() if k not in known]
    for draw, group in enumerate((sorted(names), sorted(extra))):
        if not group:
            continue
        total = sum(torch.Size(s).numel() for _, s in group)
        gen = torch.Generator(device=device).manual_seed((int(seed) * 16 + part_index * 2 + draw) % (2 ** 63))
        flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        offset = 0
        for name, shape in group:
            v = _values(flat, offset, name, shape)
            offset += v.numel()
            if not is_norm(name):
                v = v.to(getattr(torch, dtype))
            dst = tensors[name]
            if tuple(dst.shape) != tuple(shape):
                raise ValueError(f"weights: {name} is {tuple(dst.shape)}, the reference has {tuple(shape)}")
            dst.copy_(v)
        del flat


def names_of(module: torch.nn.Module) -> list[tuple[str, tuple]]:
    return sorted((k, tuple(t.shape)) for k, t in module.state_dict().items())


def fill_parts(modules: dict, reference: dict, parts, cfg: dict, seed: int, device) -> None:
    """Fill each part of `modules` (name → module) with its draw over the
    names of the same part of `reference` (the reference's modules, on meta
    or not): `parts` the architecture's (name, dtype key) pairs in order,
    the dtype the configuration's run "dtypes" under that key."""
    for i, (part, key) in enumerate(parts):
        fill(dict(modules[part].state_dict()), names_of(reference[part]), seed, i, cfg["run"]["dtypes"][key],
             device)
