"""On-disk cache of a transition's diffusion tree.

Counterpart of latentblending_tpu/engine/tree_cache.py, in the same file
format, so a tree saved by either package loads into the other. The whole
tree (trajectories, fracts, injection depths, similarities, keyframe
images) goes to one .npz: a transition can be re-loaded, re-rendered at
another duration or fps, or extended with deeper levels without recompute.

Format (version 2): trajectories in the engine's own latent dtype, bf16
stored as uint16 bit patterns so the file stays plain numpy; `meta`
records the format version, model spec name, image dims, scheduler type
and latent dtype, and load_tree checks them against the receiving engine
(TreeCacheMismatch). Version-1 files (f32, minimal meta) still load.
"""
from __future__ import annotations

import json

import numpy as np
import torch

FORMAT_VERSION = 2


class TreeCacheMismatch(ValueError):
    """A saved tree is incompatible with the engine it's being loaded into."""


def save_tree(be, fp_npz: str) -> None:
    """Serialize engine.tree_* to fp_npz (portable numpy archive). Pending
    keyframe handles (a streaming run's) are resolved first. Under a
    process group global rank 0 writes the file and the other ranks wait
    for it (parallel/mesh.write_on_rank0)."""
    from latentblending_tpu_torch.parallel.mesh import write_on_rank0

    write_on_rank0(_save_tree, be, fp_npz)


def _save_tree(be, fp_npz: str) -> None:
    from latentblending_tpu_torch.engine.blending import _PendingImage, resolve_image
    from latentblending_tpu_torch.video.i420 import to_rgb

    N = be.num_inference_steps
    store_bf16 = be.dh.dtype == torch.bfloat16
    arrays: dict[str, np.ndarray] = {}
    valid = np.zeros((len(be.tree_latents), N), bool)
    for b, branch in enumerate(be.tree_latents):
        for i, lat in enumerate(branch):
            if lat is not None:
                lat = lat.detach().cpu()
                if store_bf16:
                    # bf16 bit patterns as uint16: the npz needs no bf16 dtype to open
                    a = lat.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
                else:
                    a = lat.float().numpy()
                arrays[f"lat_{b}_{i}"] = a
                valid[b, i] = True
    cache: dict = {}
    imgs = [to_rgb(resolve_image(im, cache)) if isinstance(im, _PendingImage) else np.asarray(im)
            for im in be.tree_final_imgs]
    arrays["valid"] = valid
    arrays["fracts"] = np.asarray(be.tree_fracts, np.float64)
    arrays["idx_injection"] = np.asarray(be.tree_idx_injection, np.int32)
    arrays["similarities"] = np.asarray(be.tree_similarities, np.float64)
    arrays["imgs"] = np.stack(imgs)
    arrays["meta"] = np.frombuffer(
        json.dumps(
            {
                "format_version": FORMAT_VERSION,
                "num_inference_steps": N,
                "prompt1": be.prompt1,
                "prompt2": be.prompt2,
                "negative_prompt": be.negative_prompt,
                "seed1": be.seed1,
                "seed2": be.seed2,
                "model_spec": be.dh.spec.name,
                "scheduler_type": be.dh.schedule.config.scheduler_type,
                "height_img": be.dh.height_img,
                "width_img": be.dh.width_img,
                "latent_dtype": "bfloat16" if store_bf16 else "float32",
            }
        ).encode(),
        dtype=np.uint8,
    )
    np.savez_compressed(fp_npz, **arrays)


def _check(cond: bool, what: str, saved, current) -> None:
    if not cond:
        raise TreeCacheMismatch(
            f"saved tree was produced with {what}={saved!r} but this engine "
            f"runs {what}={current!r} — re-run the transition (or construct "
            f"a matching holder/engine) instead of loading this cache"
        )


def load_tree(be, fp_npz: str) -> dict:
    """Restore engine.tree_* from fp_npz onto the holder's device and dtype;
    returns the saved metadata.

    Validates model spec, dimensions and scheduler type against the
    receiving engine (TreeCacheMismatch); version-1 files lack those fields
    and skip the checks they can't make."""
    data = np.load(fp_npz, allow_pickle=False)
    meta = json.loads(bytes(data["meta"]).decode())
    version = int(meta.get("format_version", 1))
    if version > FORMAT_VERSION:
        raise TreeCacheMismatch(
            f"tree cache {fp_npz} is format v{version}; this build reads up to v{FORMAT_VERSION}"
        )
    valid = data["valid"]
    nb, N = valid.shape
    _check(meta["num_inference_steps"] == N, "num_inference_steps(meta/file)", meta["num_inference_steps"], N)
    if "model_spec" in meta:
        _check(meta["model_spec"] == be.dh.spec.name, "model_spec", meta["model_spec"], be.dh.spec.name)
    if "scheduler_type" in meta:
        cur = be.dh.schedule.config.scheduler_type
        _check(meta["scheduler_type"] == cur, "scheduler_type", meta["scheduler_type"], cur)
    if "height_img" in meta:
        saved_hw = (meta["height_img"], meta["width_img"])
        _check(
            saved_hw == (be.dh.height_img, be.dh.width_img),
            "dimensions (height, width)", saved_hw, (be.dh.height_img, be.dh.width_img),
        )
    # dims double-check against the latent payload (v1 files have no meta to compare)
    first = next((f"lat_{b}_{i}" for b in range(nb) for i in range(N) if valid[b, i]), None)
    if first is not None:
        lat_hw = tuple(int(x) for x in data[first].shape[1:3])
        want_hw = (be.dh.height_latent, be.dh.width_latent)
        _check(lat_hw == want_hw, "latent dims (h, w)", lat_hw, want_hw)

    bf16 = meta.get("latent_dtype", "float32") == "bfloat16"

    def _lat(b: int, i: int) -> torch.Tensor:
        a = data[f"lat_{b}_{i}"]
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if bf16 else torch.from_numpy(a)
        return t.to(device=be.dh.device, dtype=be.dh.dtype)

    be.num_inference_steps = N
    be.dh.set_num_inference_steps(N)
    be.tree_latents = [
        [_lat(b, i) if valid[b, i] else None for i in range(N)] for b in range(nb)
    ]
    be.tree_fracts = [float(f) for f in data["fracts"]]
    be.tree_idx_injection = [int(i) for i in data["idx_injection"]]
    be.tree_similarities = [float(s) for s in data["similarities"]]
    be.tree_final_imgs = [data["imgs"][i] for i in range(data["imgs"].shape[0])]
    # rebuild the device-resident similarity images so the batched policy
    # path stays index-aligned with the restored tree
    be._imgs_dev = [be.lpips._prep(im, be.dh.device)[0] for im in be.tree_final_imgs]
    be._sims_pending = None
    be.seed1, be.seed2 = meta["seed1"], meta["seed2"]
    return meta
