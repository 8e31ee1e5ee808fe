"""Checkpoint reading, and parameter conversion from the JAX package's
flax trees to port modules.

The port's modules carry the HF checkpoint key names and torch layouts, so
a diffusers/transformers state dict loads directly: `read_safetensors`
maps one .safetensors file (no `safetensors` package needed), and
`load_sdxl_unet` / `load_sdxl_vae` / `load_clip` read a HF snapshot's
subdirectory as the JAX package's loaders of the same names do (every
*.safetensors in sorted order, a later file's tensors overriding an
earlier one's). `params_from_jax` is
the inverse of latentblending_tpu/models/weights.py's convert_*_state_dict:
for every key of a port module it computes where the JAX converter would
have put it (fold list indices into their parent, "down_blocks.0" →
"down_blocks_0"; the VAE's and CLIP's path fixups; weight →
kernel/scale/embedding) and undoes the leaf transform (Dense [in,out] →
Linear [out,in], Conv HWIO → OIHW); for LPIPS it inverts
latentblending_tpu/models/lpips.py's convert_lpips_state_dict. The key
mapping is recomputed here with string operations only, so the port never
imports JAX or flax.
"""
from __future__ import annotations

import json
import os
import re
import struct
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


# LPIPS: the `lpips` package's trunk slices → the JAX module's conv names
_LPIPS_CONVS = {"net.slice1.0": "conv1", "net.slice2.3": "conv2", "net.slice3.6": "conv3", "net.slice4.8": "conv4",
                "net.slice5.10": "conv5"}


def _lpips_path(key: str) -> tuple[tuple[str, ...], str]:
    """Where latentblending_tpu's convert_lpips_state_dict puts `key`."""
    mod, param = key.rsplit(".", 1)
    if mod in _LPIPS_CONVS:
        return (_LPIPS_CONVS[mod], "kernel" if param == "weight" else "bias"), "HWIO" if param == "weight" else "none"
    lin = re.fullmatch(r"(lin\d)\.model\.1", mod)
    if lin and param == "weight":
        return (lin.group(1), "kernel"), "HWIO"
    raise KeyError(f"{key}: no LPIPS parameter of that name")


def _kind(module: nn.Module) -> str:
    from latentblending_tpu_torch.models.clip import CLIPTextEncoder
    from latentblending_tpu_torch.models.lpips import LPIPS
    from latentblending_tpu_torch.models.unet import UNet2DCondition
    from latentblending_tpu_torch.models.vae import VAE

    for cls, kind in ((UNet2DCondition, "unet"), (VAE, "vae"), (CLIPTextEncoder, "clip"), (LPIPS, "lpips")):
        if isinstance(module, cls):
            return kind
    raise TypeError(f"no JAX counterpart known for {type(module).__name__}")


def params_from_jax(flax_params: Mapping, module: nn.Module) -> dict[str, torch.Tensor]:
    """Flax param tree (leaves as numpy arrays) of the JAX UNet, VAE, a
    CLIP tower or LPIPS → state dict for the matching port `module` (which may live
    on the meta device). Raises if a key is missing or a leaf is left over."""
    kind = _kind(module)
    flat = _flatten(flax_params)
    state: dict[str, torch.Tensor] = {}
    used = set()
    for key, ref in module.state_dict().items():
        path, how = _lpips_path(key) if kind == "lpips" else jax_path(key, ref.ndim, kind)
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


# --------------------------------------------------------------- safetensors

# safetensors dtype → (little-endian numpy storage, torch dtype); BF16 is
# read as its 16-bit pattern and reinterpreted
_ST_DTYPES = {"F32": (np.dtype("<f4"), torch.float32), "F16": (np.dtype("<f2"), torch.float16),
              "BF16": (np.dtype("<u2"), torch.bfloat16)}


def read_safetensors(path: str, skip=frozenset()) -> dict[str, torch.Tensor]:
    """One .safetensors file → {name: CPU tensor} (the names in `skip`
    left out unread), mapped, not read: an
    8-byte little-endian header length, a JSON header (dtype, shape and
    data_offsets per tensor, an optional __metadata__ entry), then the raw
    little-endian bytes. The tensors view a copy-on-write map of the file,
    so its pages are read once, when a module's load_state_dict copies
    them. F32, F16 and BF16 are read; any other dtype, a header or a
    tensor that runs past the end of the file, or a tensor whose byte
    count does not fit its shape raises ValueError."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the end of the file ({size} bytes)")
        header = json.loads(f.read(n))
    base = 8 + n
    data = np.memmap(path, dtype=np.uint8, mode="c") if size > base else np.zeros(0, np.uint8)
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__" or name in skip:
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; F32, F16 and BF16 are read")
        np_dt, t_dt = _ST_DTYPES[info["dtype"]]
        shape = [int(d) for d in info["shape"]]
        start, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - start != count * np_dt.itemsize or not 0 <= start <= end or base + end > size:
            raise ValueError(f"{path}: {name} {shape} {info['dtype']} at bytes [{start}, {end}) does not fit "
                             f"a file of {size} bytes")
        raw = data[base + start : base + end]
        if (base + start) % np_dt.itemsize:
            raw = raw.copy()  # an unaligned tensor: torch needs aligned storage
        t = torch.from_numpy(raw.view(np_dt).reshape(shape))
        out[name] = t.view(torch.bfloat16) if t_dt == torch.bfloat16 else t
    return out


def _load_safetensors_dir(path: str, skip=frozenset()) -> dict[str, torch.Tensor]:
    """Every *.safetensors under `path` in sorted order, a later file's
    tensors overriding an earlier one's (latentblending_tpu's loader: of
    diffusion_pytorch_model.fp16.safetensors and its full-precision twin,
    the twin wins)."""
    files = sorted(os.path.join(path, f) for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    state: dict[str, torch.Tensor] = {}
    for f in files:
        state.update(read_safetensors(f, skip))
    return state


def load_sdxl_unet(snapshot_dir: str) -> dict[str, torch.Tensor]:
    """snapshot_dir/unet/*.safetensors → the UNet's state dict (HF names)."""
    return _load_safetensors_dir(os.path.join(snapshot_dir, "unet"))


def load_sdxl_vae(snapshot_dir: str) -> dict[str, torch.Tensor]:
    return _load_safetensors_dir(os.path.join(snapshot_dir, "vae"))


# CLIP keys of real checkpoints that the text tower does not use: the
# contrastive `logit_scale` (the JAX converter drops it) and
# `text_model.embeddings.position_ids` (an int64 buffer of older
# transformers checkpoints)
CLIP_UNUSED = frozenset({"logit_scale", "text_model.embeddings.position_ids"})


def load_clip(snapshot_dir: str, subdir: str) -> dict[str, torch.Tensor]:
    """snapshot_dir/subdir/*.safetensors → a CLIP tower's state dict, without
    the keys in CLIP_UNUSED."""
    return _load_safetensors_dir(os.path.join(snapshot_dir, subdir), CLIP_UNUSED)
