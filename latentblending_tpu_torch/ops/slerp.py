"""K1: batched per-row slerp — the hand-written CUDA kernel's two entry
points and their plain PyTorch versions.

Replaces the Pallas TPU kernel latentblending_tpu/ops/pallas_kernels.py
(`slerp_pallas`, dispatched by `slerp_batched_auto`). Kernel:
csrc/slerp.cu, one body with two entry points:

- `slerp_rows(a, b, fract)`: per-row slerp. The per-level path's crossfeed
  once per denoise step (runtime/denoise.py::denoise_scan) and the parental
  mix of a stem round over all (step, stem) rows (engine/blending.py).
- `slerp_tree_step(latents, p1, p2, parent_fract, mix_coeff, window,
  win_mask)`: one step of the fused tree scans (denoise_scan_tree, and
  denoise_scan_tree_seg over the live rows) in one launch — the live
  parental mix of two rows of the batch (parent 1 from
  the window where win_mask is set), rounded to the storage type, then the
  crossfeed slerp toward it; the kernel gathers the parent rows itself.

On the H100 K1 is bound by latency (rows of 32-256 KB, 2-40 rows): each
row is split over a cluster of 8 CTAs that hold their slices in
registers and combine the three sums through distributed shared memory in
rank order, so device memory sees one read and one write and a run
repeats bit for bit.

A CUDA tensor goes to the kernel (or raises); a CPU tensor goes to the
plain version; nothing falls back from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from latentblending_tpu_torch import profiling
from latentblending_tpu_torch.ops import _build
from latentblending_tpu_torch.ops.interp import interpolate_spherical_batched

_ROWS = {torch.float32: "lb_slerp_rows_f32", torch.bfloat16: "lb_slerp_rows_bf16"}
_TREE = {torch.float32: "lb_slerp_tree_step_f32", torch.bfloat16: "lb_slerp_tree_step_bf16"}

# index tensors whose range was checked, with the (version, rows) checked:
# the scan passes the same parent indices at every step, so the check
# (one device→host read) runs once per index tensor, not once per step
_INDEX_CHECKED = WeakIdKeyDictionary()


def slerp_rows_reference(a: torch.Tensor, b: torch.Tensor, fract: torch.Tensor) -> torch.Tensor:
    """Plain version: a, b [B, ...]; fract [B] → [B, ...] in a's dtype."""
    return interpolate_spherical_batched(a, b, fract)


def slerp_tree_step_reference(latents, p1, p2, parent_fract, mix_coeff, window=None, win_mask=None):
    """Plain version of one fused tree step: parent 1's state is
    latents[p1[r]], or the window [...] where win_mask[r]; the parental mix
    m = slerp(p1 state, latents[p2[r]], parent_fract[r]) in latents' dtype;
    returns slerp(latents[r], m, mix_coeff[r]) for every row."""
    p1_state = latents.index_select(0, p1)
    if window is not None:
        mask = win_mask.reshape((-1,) + (1,) * (latents.ndim - 1))
        p1_state = torch.where(mask, window.to(latents.dtype).expand_as(latents), p1_state)
    m = slerp_rows_reference(p1_state, latents.index_select(0, p2), parent_fract)
    return slerp_rows_reference(latents, m, mix_coeff)


def _check_cuda(name: str, ref: torch.Tensor, **tensors) -> None:
    """All tensors on ref's CUDA device and contiguous; ref of a kernel dtype."""
    if ref.dtype not in _ROWS:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported (float32, bfloat16)")
    for key, t in tensors.items():
        if not t.is_cuda or t.device != ref.device:
            raise ValueError(f"{name}: {key} must be on {ref.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def _check_fract(name: str, key: str, f: torch.Tensor, rows: int) -> None:
    if f.dtype != torch.float32 or f.shape != (rows,):
        raise ValueError(f"{name}: {key} must be float32 [{rows}], got {f.dtype} {tuple(f.shape)}")


def _check_index(key: str, idx: torch.Tensor, rows: int) -> None:
    """int64 [rows] with every entry in [0, rows)."""
    if idx.dtype != torch.int64 or idx.shape != (rows,):
        raise ValueError(f"slerp_tree_step: {key} must be int64 [{rows}], got {idx.dtype} {tuple(idx.shape)}")
    if _INDEX_CHECKED.get(idx) == (idx._version, rows):
        return
    with profiling.wait("index"):
        lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < 0 or hi >= rows:
        raise ValueError(f"slerp_tree_step: {key} holds rows {lo}..{hi}, outside [0, {rows})")
    _INDEX_CHECKED[idx] = (idx._version, rows)


def host_checked_index(idx, rows: int, device) -> torch.Tensor:
    """A parent-index tensor for slerp_tree_step on `device`, from host
    indices whose range is checked here, on the host: slerp_tree_step then
    makes no device→host read for it."""
    arr = np.ascontiguousarray(idx, np.int64)
    if arr.shape != (rows,) or (rows and (arr.min() < 0 or arr.max() >= rows)):
        raise ValueError(f"slerp_tree_step: indices must be [{rows}] in [0, {rows}), got {arr.tolist()}")
    t = torch.from_numpy(arr).to(device)
    if t.is_cuda:
        _INDEX_CHECKED[t] = (t._version, rows)
    return t


def slerp_rows(a: torch.Tensor, b: torch.Tensor, fract: torch.Tensor) -> torch.Tensor:
    """Per-row slerp of a, b [B, ...] with fractions fract [B] (f32 math);
    a CUDA call counts one launch in the profiling registry's K1_rows."""
    if not a.is_cuda:
        return slerp_rows_reference(a, b, fract)
    _check_cuda("slerp_rows", a, a=a, b=b, fract=fract)
    if b.dtype != a.dtype or b.shape != a.shape:
        raise ValueError(f"slerp_rows: a {tuple(a.shape)} {a.dtype} vs b {tuple(b.shape)} {b.dtype}")
    rows = a.shape[0]
    _check_fract("slerp_rows", "fract", fract, rows)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    _build.launch(_ROWS[a.dtype], a, b, fract, out, rows, a.numel() // rows)
    profiling.count("K1_rows")
    return out


def slerp_tree_step(latents: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, parent_fract: torch.Tensor,
                    mix_coeff: torch.Tensor, window: torch.Tensor | None = None,
                    win_mask: torch.Tensor | None = None) -> torch.Tensor:
    """One fused tree step over latents [B, ...]: for each row r,
    m = slerp(window if win_mask[r] else latents[p1[r]], latents[p2[r]],
    parent_fract[r]) rounded to latents' dtype, and the result row
    slerp(latents[r], m, mix_coeff[r]). p1, p2 int64 [B]; parent_fract,
    mix_coeff f32 [B]; window latents.shape[1:] with win_mask bool [B], or
    both None. Returns a new tensor (other rows read latents[r] as a parent).
    A CUDA call counts one launch in the profiling registry's K1_tree."""
    if (window is None) != (win_mask is None):
        raise ValueError("slerp_tree_step: window and win_mask go together")
    if not latents.is_cuda:
        return slerp_tree_step_reference(latents, p1, p2, parent_fract, mix_coeff, window, win_mask)
    extra = {} if window is None else {"window": window, "win_mask": win_mask}
    _check_cuda("slerp_tree_step", latents, latents=latents, p1=p1, p2=p2, parent_fract=parent_fract,
                mix_coeff=mix_coeff, **extra)
    rows = latents.shape[0]
    _check_fract("slerp_tree_step", "parent_fract", parent_fract, rows)
    _check_fract("slerp_tree_step", "mix_coeff", mix_coeff, rows)
    if window is not None:
        if window.dtype != latents.dtype or window.shape != latents.shape[1:]:
            raise ValueError(f"slerp_tree_step: window must be {latents.dtype} {tuple(latents.shape[1:])}, "
                             f"got {window.dtype} {tuple(window.shape)}")
        if win_mask.dtype != torch.bool or win_mask.shape != (rows,):
            raise ValueError(f"slerp_tree_step: win_mask must be bool [{rows}], got {win_mask.dtype} "
                             f"{tuple(win_mask.shape)}")
    out = torch.empty_like(latents)
    if latents.numel() == 0:
        return out
    _check_index("p1", p1, rows)
    _check_index("p2", p2, rows)
    _build.launch(_TREE[latents.dtype], latents, p1, p2, parent_fract, mix_coeff, window, win_mask,
            out, rows, latents.numel() // rows)
    profiling.count("K1_tree")
    return out
