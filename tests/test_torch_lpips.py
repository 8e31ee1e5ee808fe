"""LPIPS in the port (latentblending_tpu_torch/models/lpips.py) against the
JAX package's, and the engine with similarity_metric="lpips".

- the module: JAX LPIPS weights carried across by params_from_jax, the
  same images, at 64x64 and 72x88, B=3, f32: distances within rtol 1e-4
  and atol 1e-6;
- a synthetic state dict under the `lpips` package's key names (with its
  scaling_layer buffers), loaded by the port and converted by JAX
  convert_lpips_state_dict: the same distances (same bound), and the
  torch-file loader gives the same tensors;
- the parameter count: AlexNet's five convs (2,469,696) and the five lins
  (1,152), as tests/test_lpips_golden.py pins it for the JAX package;
- the engine: tiny-turbo run_transition with similarity_metric="lpips" and
  the same weights, fused and per-level (LB_FUSED=0), against JAX with
  the JAX seeded noise injected: tree_fracts equal, uint8 keyframes within
  1 LSB, similarities within rtol 1e-4;
- the metric's resolution (None → lpips with weights, else nlpd; lpips
  without weights warns and takes the stand-in) and apply_config switching
  it both ways, keeping the weights given;
- both scorers (NLPD and LPIPS) compute on the device they were built for,
  which the engine takes from its holder.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.models import lpips as jl
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.engine.config import EngineConfig
from latentblending_tpu_torch.models import lpips as tl
from latentblending_tpu_torch.models.perceptual import NLPDScorer
from latentblending_tpu_torch.models.weights import params_from_jax
from tests.torch_port_util import inject_jax_noise, np_tree, port_holder_from_jax

PROMPTS = ("photo of a forest at dawn", "photo of a city at night")


@pytest.fixture(scope="module")
def jax_scorer():
    return jl.LPIPSScorer(image_hw=(64, 64), seed=3)


def _pair(hw, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (3,) + hw + (3,)).astype(np.float32)
    b = np.clip(a + 0.3 * rng.normal(size=a.shape), -1, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("hw", [(64, 64), (72, 88)])
def test_lpips_module_matches_jax(jax_scorer, hw):
    model = tl.LPIPS()
    model.load_state_dict(params_from_jax(np_tree(jax_scorer.params), model), strict=True)
    a, b = _pair(hw, 1)
    want = np.asarray(jax_scorer._fn(jax_scorer.params, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def _lpips_package_state(seed: int) -> dict:
    """A state dict under the `lpips` package's names and shapes, its
    scaling_layer buffers included, with positive random values."""
    rng = np.random.default_rng(seed)
    shapes = {"net.slice1.0": (64, 3, 11, 11), "net.slice2.3": (192, 64, 5, 5), "net.slice3.6": (384, 192, 3, 3),
              "net.slice4.8": (256, 384, 3, 3), "net.slice5.10": (256, 256, 3, 3)}
    state = {"scaling_layer.shift": np.array([-0.030, -0.088, -0.188], np.float32).reshape(1, 3, 1, 1),
             "scaling_layer.scale": np.array([0.458, 0.448, 0.450], np.float32).reshape(1, 3, 1, 1)}
    for k, shp in shapes.items():
        fan_in = int(np.prod(shp[1:]))
        state[f"{k}.weight"] = (rng.normal(size=shp) / np.sqrt(fan_in)).astype(np.float32)
        state[f"{k}.bias"] = (0.01 * rng.normal(size=shp[:1])).astype(np.float32)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        state[f"lin{i}.model.1.weight"] = np.abs(rng.normal(size=(1, c, 1, 1))).astype(np.float32) / c
    return state


def test_lpips_package_state_dict_loads_as_in_jax(tmp_path):
    state = _lpips_package_state(7)
    jparams = jl.convert_lpips_state_dict(state)
    fp = tmp_path / "lpips_alex.pth"
    torch.save({k: torch.from_numpy(v) for k, v in state.items()}, fp)
    loaded = tl.load_lpips_torch_file(str(fp))
    assert set(loaded) == set(tl.LPIPS().state_dict())
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), state[k])
    scorer = tl.LPIPSScorer(params=loaded, device="cpu")
    a, b = _pair((64, 64), 2)
    want = np.asarray(jl.LPIPS().apply({"params": jparams}, jnp.asarray(a), jnp.asarray(b)))
    got = scorer.distance_batch(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    u = ((a[0] + 1) * 127.5).astype(np.uint8)
    v = ((b[0] + 1) * 127.5).astype(np.uint8)
    want1 = jl.LPIPSScorer(params=jparams).distance(u, v)
    assert scorer.distance(u, v) == pytest.approx(want1, rel=1e-4, abs=1e-6)


def test_lpips_parameter_count_and_stand_in():
    model = tl.LPIPS()
    n_conv = sum(p.numel() for k, p in model.named_parameters() if k.startswith("net."))
    n_lin = sum(p.numel() for k, p in model.named_parameters() if k.startswith("lin"))
    assert (n_conv, n_lin) == (2_469_696, 1_152)
    sd = tl.random_lpips_state_dict(seed=4)
    assert all(bool((v >= 0).all()) for v in sd.values())
    assert all(not v.any() for k, v in sd.items() if k.endswith(".bias"))
    # lecun-normal kernels: std of 1/sqrt(fan_in) after the truncation
    w = sd["net.slice3.6.weight"]
    std = float(torch.sqrt((w * w).mean()))
    assert std == pytest.approx(1 / np.sqrt(192 * 9), rel=0.05)
    assert all(torch.equal(sd[k], v) for k, v in tl.random_lpips_state_dict(seed=4).items())


# ----------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def holders():
    jdh = JHolder.from_random("tiny-turbo", seed=0, dtype=jnp.float32)
    tdh = port_holder_from_jax(jdh, "tiny-turbo")
    inject_jax_noise(tdh, jdh)
    return jdh, tdh


def _setup(be):
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    return be


@pytest.mark.parametrize("gate", [None, "0"])
def test_lpips_transition_matches_jax(holders, jax_scorer, gate, monkeypatch):
    if gate is None:
        monkeypatch.delenv("LB_FUSED", raising=False)
    else:
        monkeypatch.setenv("LB_FUSED", gate)
    jdh, tdh = holders
    tparams = params_from_jax(np_tree(jax_scorer.params), tl.LPIPS())
    jbe = _setup(JEngine(jdh, similarity_metric="lpips", lpips_params=jax_scorer.params, run_benchmark=False))
    tbe = _setup(TEngine(tdh, similarity_metric="lpips", lpips_params=tparams))
    assert isinstance(tbe.lpips, tl.LPIPSScorer) and tbe.similarity_metric == "lpips"
    jimgs = jbe.run_transition(fixed_seeds=[420, 421])
    timgs = tbe.run_transition(fixed_seeds=[420, 421])
    for be in (jbe, tbe):
        assert bool(be.last_report.levels[0].get("fused")) is (gate is None)
    assert tbe.tree_fracts == list(jbe.tree_fracts)
    assert len(timgs) == len(jimgs) == 12
    for t, j in zip(timgs, jimgs):
        assert np.abs(t.astype(int) - np.asarray(j).astype(int)).max() <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)


def test_metric_resolution_and_apply_config(holders, caplog):
    jdh, tdh = holders
    weights = tl.random_lpips_state_dict(seed=9)
    assert TEngine(tdh).similarity_metric == "nlpd"
    be = TEngine(tdh, do_compile=True, lpips_params=weights)
    assert be.similarity_metric == "lpips" and isinstance(be.lpips, tl.LPIPSScorer)
    with caplog.at_level(logging.WARNING):
        stand_in = TEngine(tdh, similarity_metric="lpips")
    assert "without weights" in caplog.text and isinstance(stand_in.lpips, tl.LPIPSScorer)
    with pytest.raises(ValueError):
        TEngine(tdh, similarity_metric="ssim")

    # switch to nlpd and back: the weights given to the constructor return
    be.apply_config(EngineConfig(similarity_metric="nlpd"))
    assert be.similarity_metric == "nlpd" and isinstance(be.lpips, NLPDScorer)
    assert be.get_config().similarity_metric == "nlpd"
    be.apply_config(EngineConfig(similarity_metric="lpips"))
    assert be.similarity_metric == "lpips"
    for k, v in be.lpips.model.state_dict().items():
        assert torch.equal(v, weights[k])
    # the JAX engine switches the same way
    jbe = JEngine(jdh, run_benchmark=False)
    jbe.apply_config(jbe.get_config().__class__(similarity_metric="lpips"))
    be2 = TEngine(tdh)
    be2.apply_config(EngineConfig(similarity_metric="lpips"))
    assert (jbe.similarity_metric, be2.similarity_metric) == ("lpips", "lpips")
    assert type(jbe.lpips).__name__ == type(be2.lpips).__name__ == "LPIPSScorer"


def test_scorers_compute_on_their_device(holders, monkeypatch):
    """Both scorers hand the metric tensors on the device they were built
    for, from uint8 images (distance) and from device batches
    (distance_batch), and refuse batches that lie elsewhere rather than
    copy them; the engine builds them on its holder's device. The metric
    is replaced by a stub that records its inputs' devices, and the
    scorers are built for the meta device, so the check runs on the CPU."""
    from latentblending_tpu_torch.models import perceptual as tp

    seen = []

    def stub(a, b, *rest):
        seen.append((a.device.type, b.device.type))
        return torch.zeros(a.shape[0])

    monkeypatch.setattr(tp, "nlpd_distance", stub)
    nlpd = tp.NLPDScorer(device="meta")
    lp = tl.LPIPSScorer(device="meta")
    assert next(lp.model.parameters()).device.type == "meta"
    lp.model = stub
    u8 = np.zeros((8, 8, 3), np.uint8)
    for scorer in (nlpd, lp):
        assert scorer.distance(u8, u8) == 0.0
        scorer.distance_batch(torch.zeros(2, 8, 8, 3, device="meta"), torch.zeros(2, 8, 8, 3, device="meta"))
        with pytest.raises(ValueError, match="built for meta"):
            scorer.distance_batch(torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 3))
    assert seen == [("meta", "meta")] * 4
    _, tdh = holders
    for metric in ("nlpd", "lpips"):
        assert TEngine(tdh, similarity_metric=metric).lpips.device == tdh.device


def test_default_scorers_keep_their_inputs_device(monkeypatch):
    """Built with no device, both scorers compute distance_batch where its
    inputs lie (a meta batch stays on meta, the LPIPS weights copied there
    and kept on the CPU as well), and distance stages its uint8 images on
    the card: with none it raises instead of scoring on the CPU."""
    from latentblending_tpu_torch.models import perceptual as tp

    nlpd, lp = tp.NLPDScorer(), tl.LPIPSScorer()
    x = torch.zeros(2, 64, 64, 3, device="meta")
    for scorer in (nlpd, lp):
        assert scorer.device is None
        out = scorer.distance_batch(x, x)
        assert out.device.type == "meta" and tuple(out.shape) == (2,)
    assert next(lp.model.parameters()).device.type == "cpu"
    y = torch.zeros(2, 64, 64, 3)
    assert lp.distance_batch(y, y).device.type == "cpu" and not lp._copies.get(torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    u8 = np.zeros((64, 64, 3), np.uint8)
    for scorer in (nlpd, lp):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scorer.distance(u8, u8)
