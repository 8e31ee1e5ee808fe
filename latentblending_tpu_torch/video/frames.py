"""Frame fill-up: expand K keyframes to exactly fps×duration frames by
linear interpolation.

Counterpart of latentblending_tpu/video/frames.py. The per-gap insert
counts come from ops/schedules.frame_insert_counts. The host lerp follows
the JAX package's numpy rule (`_lerp_u8`: f32, clip, truncating cast); its
native SIMD kernel (native/frame_interp.cpp) is host code and is not part
of the port. `add_frames_linear_interp_device` runs the lerp as batched
torch ops on a device (LB_DEVICE_FILLUP=1 in the engine).
"""
from __future__ import annotations

import numpy as np
import torch

from latentblending_tpu_torch.ops.schedules import frame_insert_counts


def _lerp_u8(img0_f32: np.ndarray, img1_f32: np.ndarray, fract: float) -> np.ndarray:
    out = (1.0 - fract) * img0_f32 + fract * img1_f32
    return np.clip(out, 0, 255).astype(np.uint8)


def fillup_plan(nmb_keyframes: int, nmb_frames_target: int) -> tuple[np.ndarray, np.ndarray]:
    """(left_index[T], fract[T]) describing every output frame as a lerp of
    keyframes left_index[t] and left_index[t]+1."""
    counts = frame_insert_counts(nmb_keyframes, nmb_frames_target)
    left, fract = [], []
    for i in range(nmb_keyframes - 1):
        left.append(i)
        fract.append(0.0)
        fr = np.linspace(0, 1, counts[i] + 2)[1:-1]
        left.extend([i] * len(fr))
        fract.extend(fr.tolist())
    left.append(nmb_keyframes - 1)
    fract.append(0.0)
    return np.asarray(left, np.int32), np.asarray(fract, np.float32)


def stream_frames_lazy(handles: list, nmb_frames_target: int, resolve):
    """Streaming fill-up over lazily-resolved keyframes.

    `resolve(handle) -> uint8 HWC array` is called the first time a keyframe
    is needed, strictly left to right, so encoding of earlier gaps overlaps
    the device→host copies of later keyframes. The yielded in-between
    frames are fresh arrays; keyframes are yielded as resolved."""
    K = len(handles)
    if nmb_frames_target <= K:
        for h in handles:
            yield np.ascontiguousarray(np.asarray(resolve(h)), dtype=np.uint8)
        return
    counts = frame_insert_counts(K, nmb_frames_target)
    cur = np.ascontiguousarray(np.asarray(resolve(handles[0])), dtype=np.uint8)
    cur_f = cur.astype(np.float32)
    for i in range(K - 1):
        nxt = np.ascontiguousarray(np.asarray(resolve(handles[i + 1])), dtype=np.uint8)
        yield cur
        nxt_f = nxt.astype(np.float32)
        for f in np.linspace(0, 1, counts[i] + 2)[1:-1]:
            yield _lerp_u8(cur_f, nxt_f, float(f))
        cur, cur_f = nxt, nxt_f
    yield cur


def stream_gaps_device(handles: list, nmb_frames_target: int, resolve, device, per_call: int):
    """stream_frames_lazy on a device, a gap at a time: uint8 [F, H, W, 3]
    tensors on `device`, the first keyframe alone, then each gap's
    in-between frames with the next keyframe after them (each keyframe
    alone when there is nothing to fill). A gap of more than `per_call`
    frames comes in batches of `per_call` in order, each lerped on its
    own, so a long gap takes no more memory than `per_call` frames. The
    same plan and `_lerp_u8`'s rule (f32 weights, each product and the sum
    rounded, clip, truncating cast) as torch ops, a batch's fractions at
    once."""
    def key(h) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(np.asarray(resolve(h)), dtype=np.uint8)).to(device)

    K = len(handles)
    counts = frame_insert_counts(K, nmb_frames_target) if nmb_frames_target > K else [0] * (K - 1)
    cur = key(handles[0])
    yield cur[None]
    cur_f = cur.float()
    for i in range(K - 1):
        nxt = key(handles[i + 1])
        nxt_f = nxt.float()
        fr = np.linspace(0, 1, counts[i] + 2)[1:-1]
        for s in range(0, len(fr) + 1, per_call):
            part = fr[s:s + per_call]
            shape = (len(part),) + (1,) * cur.ndim
            w0 = torch.tensor(1.0 - part, dtype=torch.float32, device=device).reshape(shape)
            w1 = torch.tensor(part, dtype=torch.float32, device=device).reshape(shape)
            batch = (w0 * cur_f + w1 * nxt_f).clamp_(0, 255).to(torch.uint8)
            # the gap's last batch ends with the next keyframe
            yield torch.cat([batch, nxt[None]]) if s + per_call > len(fr) else batch
        cur_f = nxt_f


def stream_frames_linear_interp(list_imgs: list, nmb_frames_target: int):
    """Generator over the interpolated frames of already-resolved keyframes."""
    yield from stream_frames_lazy(list_imgs, nmb_frames_target, lambda im: im)


def add_frames_linear_interp_device(list_imgs: list, nmb_frames_target: int, device="cuda",
                                    chunk: int = 90) -> list[np.ndarray]:
    """Device-side fill-up: the interpolation runs as batched lerps on
    `device` (round to nearest, as the JAX package's device path), and the
    host receives ready uint8 frames, one copy per chunk of frames."""
    K = len(list_imgs)
    if nmb_frames_target <= K:
        return [np.asarray(im).astype(np.uint8) for im in list_imgs]
    left, fract = fillup_plan(K, nmb_frames_target)
    keys = torch.from_numpy(np.stack([np.asarray(im) for im in list_imgs])).to(device, torch.float32)
    frames: list[np.ndarray] = []
    for s in range(0, len(left), chunk):
        li = torch.from_numpy(left[s:s + chunk].astype(np.int64)).to(device)
        fr = torch.from_numpy(fract[s:s + chunk]).to(device).reshape(-1, *([1] * (keys.ndim - 1)))
        out = keys[li] * (1.0 - fr) + keys[(li + 1).clamp_(max=K - 1)] * fr
        arr = (out + 0.5).clamp_(0.0, 255.0).to(torch.uint8).cpu().numpy()
        frames.extend(arr[i] for i in range(arr.shape[0]))
    return frames


def add_frames_linear_interp(
    list_imgs: list,
    fps_target: float | None = None,
    duration_target: float | None = None,
    nmb_frames_target: int | None = None,
) -> list[np.ndarray]:
    """Returns a list of exactly nmb_frames_target (or fps×duration) uint8
    frames, keyframes preserved in order."""
    if nmb_frames_target is not None and fps_target is not None:
        raise ValueError("You cannot specify both fps_target and nmb_frames_target")
    if nmb_frames_target is None:
        if fps_target is None or duration_target is None:
            raise ValueError("Specify duration_target and fps_target OR nmb_frames_target")
        nmb_frames_target = int(round(fps_target * duration_target))
    imgs = [np.asarray(im) for im in list_imgs]
    if nmb_frames_target <= len(imgs):
        return [im.astype(np.uint8) for im in imgs]
    return list(stream_frames_linear_interp(imgs, nmb_frames_target))
