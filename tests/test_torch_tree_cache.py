"""The port's tree cache (latentblending_tpu_torch/engine/tree_cache.py)
against the JAX package's, on the CPU, tiny-turbo in f32 (Euler, so the
JAX package's seeded noise is the only draw to share).

- A tree the JAX package saves loads into the port (trajectories, fracts,
  injection depths, similarities and keyframes exactly), and the port's
  extend_transition continues it to the keyframes the JAX engine gets from
  the same file: tree_fracts equal, uint8 keyframes within 1 LSB,
  similarities rtol 1e-4 (the bounds of tests/test_torch_slice.py).
- The reverse: a tree the port saves, continued by both packages.
- bf16 trajectories cross as uint16 bit patterns, bit for bit, both ways.
- Version-1 files (f32, minimal meta) load; every TreeCacheMismatch check
  fires (model spec, scheduler type, dimensions, a newer format, the
  step count of meta against the file, a v1 file's latent dims).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine import tree_cache as jtc
from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine import tree_cache as ttc
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.runtime.holder import SDXLHolder as THolder
from tests.torch_port_util import inject_jax_noise, port_holder_from_jax

PROMPTS = ("photo of a forest at dawn", "photo of a city at night", "blurry, low quality")
EXTEND = ([3], [2])


def _prompted(be):
    be.set_negative_prompt(PROMPTS[2])  # read by the next embeddings
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    return be


@pytest.fixture(scope="module")
def holders():
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-turbo")
    inject_jax_noise(tdh, jdh)
    return jdh, tdh


def _j(jdh):
    return _prompted(JEngine(jdh, run_benchmark=False))


def _t(tdh):
    return _prompted(TEngine(tdh))


def _assert_restored(be, ref_fracts, ref_sims, ref_imgs, ref_latents):
    assert be.tree_fracts == ref_fracts
    assert be.tree_similarities == ref_sims
    assert len(be.tree_final_imgs) == len(ref_imgs) == len(be._imgs_dev)
    for a, b in zip(be.tree_final_imgs, ref_imgs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for branch, ref in zip(be.tree_latents, ref_latents):
        for lat, want in zip(branch, ref):
            assert (lat is None) == (want is None)
            if lat is not None:
                np.testing.assert_array_equal(np.asarray(lat, np.float32), np.asarray(want, np.float32))


def _assert_same_extension(jbe, tbe):
    jimgs = jbe.extend_transition(*EXTEND)
    timgs = tbe.extend_transition(*EXTEND)
    assert len(timgs) == len(jimgs) == 14
    assert tbe.tree_fracts == jbe.tree_fracts
    assert tbe.tree_idx_injection == list(jbe.tree_idx_injection)
    for t, j in zip(timgs, jimgs):
        assert np.abs(np.asarray(t).astype(int) - np.asarray(j).astype(int)).max() <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)


def test_jax_tree_loads_into_the_port_and_extends(holders, tmp_path, monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    jdh, tdh = holders
    jbe = _j(jdh)
    jbe.run_transition(fixed_seeds=[420, 421])
    fp = str(tmp_path / "jax.npz")
    jtc.save_tree(jbe, fp)
    tbe = _t(tdh)
    meta = ttc.load_tree(tbe, fp)
    assert meta["model_spec"] == "tiny-turbo" and meta["scheduler_type"] == "euler"
    assert (meta["format_version"], meta["latent_dtype"]) == (2, "float32")
    assert (tbe.seed1, tbe.seed2) == (420, 421)
    _assert_restored(tbe, jbe.tree_fracts, jbe.tree_similarities, jbe.tree_final_imgs, jbe.tree_latents)
    assert all(lat.dtype == torch.float32 and lat.device.type == "cpu" for lat in tbe.tree_latents[0])
    jbe2 = _j(jdh)
    jtc.load_tree(jbe2, fp)
    _assert_same_extension(jbe2, tbe)


def test_port_tree_loads_into_jax_and_extends(holders, tmp_path, monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    jdh, tdh = holders
    src = _t(tdh)
    # a streaming run leaves pending keyframe handles: save_tree resolves them
    src.run_transition_streaming(fixed_seeds=[5, 6], keyframe_format="i420")
    src.finalize_report()
    fp = str(tmp_path / "port.npz")
    ttc.save_tree(src, fp)
    src.resolve_keyframes()
    jbe = _j(jdh)
    meta = jtc.load_tree(jbe, fp)
    assert meta["model_spec"] == "tiny-turbo" and (jbe.seed1, jbe.seed2) == (5, 6)
    _assert_restored(jbe, src.tree_fracts, src.tree_similarities, src.tree_final_imgs, src.tree_latents)
    tbe = _t(tdh)
    ttc.load_tree(tbe, fp)
    _assert_same_extension(jbe, tbe)


def test_bf16_trees_cross_bit_for_bit(holders, tmp_path, monkeypatch):
    tbe = _prompted(TEngine(THolder.from_random("tiny-turbo", seed=1, dtype=torch.bfloat16, device="cpu")))
    tbe.set_branching(nmb_max_branches=4)
    tbe.run_transition(fixed_seeds=[1, 2])
    fp = str(tmp_path / "port_bf16.npz")
    ttc.save_tree(tbe, fp)
    data = np.load(fp)
    assert data["lat_0_0"].dtype == np.uint16
    assert json.loads(bytes(data["meta"]).decode())["latent_dtype"] == "bfloat16"

    # the JAX engine loads and saves in its holder's dtype, which is all the
    # cache reads of it: the module's holder, set to bf16
    jdh, _ = holders
    monkeypatch.setattr(jdh, "dtype", jnp.bfloat16)
    jbe = JEngine(jdh, run_benchmark=False)
    jtc.load_tree(jbe, fp)
    pairs = [(a, b) for x, y in zip(jbe.tree_latents, tbe.tree_latents) for a, b in zip(x, y) if b is not None]
    assert len(pairs) >= 8
    for lat, want in pairs:
        assert lat.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(lat).view(np.uint16), want.view(torch.int16).numpy().view(np.uint16))
    fp2 = str(tmp_path / "jax_bf16.npz")
    jtc.save_tree(jbe, fp2)
    assert np.load(fp2)["lat_0_0"].dtype == np.uint16
    back = TEngine(THolder.from_random("tiny-turbo", seed=1, dtype=torch.bfloat16, device="cpu"))
    ttc.load_tree(back, fp2)
    for branch, ref in zip(back.tree_latents, tbe.tree_latents):
        for lat, want in zip(branch, ref):
            assert (lat is None) == (want is None)
            if lat is not None:
                assert lat.dtype == torch.bfloat16 and torch.equal(lat, want)


_V1_DROP = ("format_version", "model_spec", "scheduler_type", "height_img", "width_img", "latent_dtype")


def _rewrite(fp_in: str, fp_out: str, meta_update: dict | None = None, drop_meta=(), latents=None):
    data = dict(np.load(fp_in))
    meta = json.loads(bytes(data["meta"]).decode())
    meta.update(meta_update or {})
    for k in drop_meta:
        meta.pop(k)
    if latents is not None:
        for k in [k for k in data if k.startswith("lat_")]:
            data[k] = latents(data[k])
    data["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(fp_out, **data)
    return fp_out


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    tdh = THolder.from_random("tiny-turbo", seed=2, dtype=torch.float32, device="cpu")
    be = _prompted(TEngine(tdh))
    be.set_branching(nmb_max_branches=4)
    be.run_transition(fixed_seeds=[7, 8])
    fp = str(tmp_path_factory.mktemp("tree") / "tree.npz")
    ttc.save_tree(be, fp)
    return fp, be


def test_v1_files_load(saved, tmp_path):
    fp, be = saved
    v1 = _rewrite(fp, str(tmp_path / "v1.npz"), drop_meta=_V1_DROP)
    fresh = TEngine(THolder.from_random("tiny-turbo", seed=2, dtype=torch.float32, device="cpu"))
    meta = ttc.load_tree(fresh, v1)
    assert "format_version" not in meta and (fresh.seed1, fresh.seed2) == (7, 8)
    _assert_restored(fresh, be.tree_fracts, be.tree_similarities, be.tree_final_imgs, be.tree_latents)


def _base_engine():
    be = TEngine(THolder.from_random("tiny-base", seed=0, dtype=torch.float32, device="cpu"), run_benchmark=False)
    be.set_num_inference_steps(4)
    return be


def _other_scheduler():
    dh = THolder.from_random("tiny-turbo", seed=0, dtype=torch.float32, device="cpu")
    dh.set_scheduler_type("euler_ancestral")
    return TEngine(dh)


def _other_size():
    be = TEngine(THolder.from_random("tiny-turbo", seed=0, dtype=torch.float32, device="cpu"))
    be.set_dimensions((96, 96))
    return be


_MISMATCHES = {
    # case: (receiving engine, rewrite of the saved file or None, message)
    "model_spec": ("base", None, "model_spec"),
    "scheduler_type": ("scheduler", None, "scheduler_type"),
    "dimensions": ("size", None, "dimensions"),
    "format": ("plain", {"meta_update": {"format_version": 3}}, "format v3"),
    "steps": ("plain", {"meta_update": {"num_inference_steps": 6}}, "num_inference_steps"),
    "v1_latent_dims": ("plain", {"drop_meta": _V1_DROP, "latents": lambda a: a[:, :8, :8]}, "latent dims"),
}


@pytest.mark.parametrize("case", list(_MISMATCHES))
def test_mismatches_raise(case, saved, tmp_path):
    fp, _ = saved
    kind, rewrite, match = _MISMATCHES[case]
    engine = {"base": _base_engine, "scheduler": _other_scheduler, "size": _other_size,
              "plain": lambda: TEngine(THolder.from_random("tiny-turbo", seed=0, dtype=torch.float32,
                                                           device="cpu"))}[kind]()
    if rewrite is not None:
        fp = _rewrite(fp, str(tmp_path / f"{case}.npz"), **rewrite)
    with pytest.raises(ttc.TreeCacheMismatch, match=match):
        ttc.load_tree(engine, fp)
