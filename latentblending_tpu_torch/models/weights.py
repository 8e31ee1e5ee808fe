"""Parameter conversion from the JAX package's flax trees to port modules.

The port's modules carry the HF checkpoint key names and torch layouts, so
a diffusers/transformers state dict loads directly. `params_from_jax` is
the inverse of latentblending_tpu/models/weights.py's convert_*_state_dict:
for every key of a port module it computes where the JAX converter would
have put it (fold list indices into their parent, "down_blocks.0" →
"down_blocks_0"; the VAE's and CLIP's path fixups; weight →
kernel/scale/embedding) and undoes the leaf transform (Dense [in,out] →
Linear [out,in], Conv HWIO → OIHW). The key mapping is recomputed here
with string operations only, so the port never imports JAX or flax.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

_NUM = re.compile(r"^\d+$")


def _merge_numeric(segments: list[str]) -> list[str]:
    out: list[str] = []
    for s in segments:
        if _NUM.match(s) and out:
            out[-1] = f"{out[-1]}_{s}"
        else:
            out.append(s)
    return out


def _vae_fixup(path: list[str]) -> list[str]:
    if path[0] in ("decoder", "encoder") and len(path) > 3:
        top, *mid, leaf_mod, param = path
        return [top, "_".join(mid), leaf_mod, param]
    return path


def _clip_fixup(path: list[str]) -> list[str]:
    if path[:2] == ["text_model", "embeddings"]:
        if path[2] == "position_embedding":
            return ["position_embedding"]
        return path[2:]
    if path[:2] == ["text_model", "encoder"]:
        rest = path[2:]
        if len(rest) >= 3 and rest[1] == "mlp":
            rest = [rest[0], f"mlp_{rest[2]}"] + rest[3:]
        return rest
    if path[0] == "text_model":
        return path[1:]
    return path


def jax_path(key: str, ndim: int, kind: str) -> tuple[tuple[str, ...], str]:
    """Where the JAX converter puts torch key `key` of a tensor with `ndim`
    dims, and the leaf transform: 'none', 'T' (Dense) or 'HWIO' (Conv)."""
    path = _merge_numeric(key.split("."))
    if kind == "vae":
        path = _vae_fixup(path)
    elif kind == "clip":
        path = _clip_fixup(path)
    *mods, param = path
    if param != "weight" or len(path) == 1:
        return tuple(path), "none"
    if mods and mods[-1] in ("token_embedding", "shared", "position_embedding"):
        return tuple(mods + ["embedding"]), "none"
    if ndim == 1:
        return tuple(mods + ["scale"]), "none"
    if ndim == 2:
        return tuple(mods + ["kernel"]), "T"
    if ndim == 4:
        return tuple(mods + ["kernel"]), "HWIO"
    raise ValueError(f"unhandled weight rank {ndim} at {key}")


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict[tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def _kind(module: nn.Module) -> str:
    from latentblending_tpu_torch.models.clip import CLIPTextEncoder
    from latentblending_tpu_torch.models.unet import UNet2DCondition
    from latentblending_tpu_torch.models.vae import VAE

    for cls, kind in ((UNet2DCondition, "unet"), (VAE, "vae"), (CLIPTextEncoder, "clip")):
        if isinstance(module, cls):
            return kind
    raise TypeError(f"no JAX counterpart known for {type(module).__name__}")


def params_from_jax(flax_params: Mapping, module: nn.Module) -> dict[str, torch.Tensor]:
    """Flax param tree (leaves as numpy arrays) of the JAX UNet, VAE or a
    CLIP tower → state dict for the matching port `module` (which may live
    on the meta device). Raises if a key is missing or a leaf is left over."""
    kind = _kind(module)
    flat = _flatten(flax_params)
    state: dict[str, torch.Tensor] = {}
    used = set()
    for key, ref in module.state_dict().items():
        path, how = jax_path(key, ref.ndim, kind)
        if path not in flat:
            raise KeyError(f"{key}: no JAX parameter at {'/'.join(path)}")
        val = np.asarray(flat[path])
        if val.dtype.name == "bfloat16":
            val = val.astype(np.float32)
        if how == "T":
            val = val.T
        elif how == "HWIO":
            val = val.transpose(3, 2, 0, 1)
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {val.shape} vs port {tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.array(val, copy=True, order="C"))
        used.add(path)
    extra = set(flat) - used
    if extra:
        raise KeyError(f"JAX parameters with no port key: {sorted('/'.join(p) for p in extra)[:10]}")
    return state
