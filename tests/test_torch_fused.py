"""The fused single-call transition of the port against the JAX package.

- runtime: denoise_scan_tree, port vs JAX, for euler, euler_ancestral and
  dpmpp_2m with per-row pin steps, with and without a recycled-edge window
  (JAX per-step draws injected). Trajectories within rtol 5e-3 / atol
  5e-4, the repo's f32 tiny bound.
- engine: run_transition with LB_FUSED unset takes the fused path in both
  packages (tiny-turbo, tiny-ancestral; then the recycled chain, branch1
  crossfeed and dpmpp_2m on a 5-stem plan). tree_fracts and
  tree_idx_injection exactly equal, uint8 keyframes within 1 LSB,
  similarities rtol 1e-4, final latents of every branch within the f32
  tiny bound.
- the port's fused path equals its per-level path for Euler (keyframes
  within 1 LSB, final latents rtol/atol 2e-4, as tests/test_fused_tree.py).
- the gate: LB_FUSED=0 and recycle_img2 go per-level, LB_FUSED=1 goes fused
  whatever the cost model says; the single-level cost model gives the JAX
  package's numbers for the same calibration inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.ops.scheduler import SDXL_TURBO_SCHEDULER, make_schedule
from latentblending_tpu.runtime import denoise as jd
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine import blending as tb
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from latentblending_tpu_torch.runtime import denoise as td
from latentblending_tpu_torch.runtime.holder import SDXLHolder as THolder
from tests.torch_port_util import inject_jax_noise, port_holder_from_jax, tiny_unet_pair

POOLED = 48
N = 3
PROMPTS = ("photo of a forest at dawn", "photo of a city at night")


# ---------------------------------------------------------------- runtime


@pytest.fixture(scope="module")
def unets():
    return tiny_unet_pair(POOLED)


@pytest.mark.parametrize("sched,use_cfg,window", [
    ("euler", False, True),
    ("euler_ancestral", True, False),
    ("dpmpp_2m", True, False),
    ("dpmpp_2m", False, True),
])
def test_denoise_scan_tree_matches_jax(unets, sched, use_cfg, window):
    """Rows: edge 1, edge 2 (parents: themselves), two stems between them
    pinned at step 1 (coefficient 1.0 there). With a window, rows 0, 2 and
    3 read their parent-1 state from it."""
    j_apply, params, t_apply = unets
    rng = np.random.default_rng(20)
    B = 4
    lat = rng.normal(size=(B, 8, 8, 4)).astype(np.float32) * 4.0
    parent_idx = np.array([[0, 0], [0, 0], [0, 1], [0, 1]], np.int32)
    parent_fract = np.array([0.0, 0.0, 0.3, 0.7], np.float32)
    pins = np.array([0, 0, 1, 1], np.int32)
    coeffs = rng.uniform(0.2, 0.8, size=(N, B)).astype(np.float32)
    coeffs[0] = 0.0
    coeffs[1, 2:] = 1.0
    win = rng.normal(size=(N, 8, 8, 4)).astype(np.float32) * 3.0 if window else None
    win_mask = np.array([True, False, True, True]) if window else None
    pe, ne = (rng.normal(size=(B, 77, 64)).astype(np.float32) for _ in range(2))
    pool, npool = (rng.normal(size=(B, POOLED)).astype(np.float32) for _ in range(2))
    tids = np.tile(np.array([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]], np.float32), (B, 1))
    g = np.array([5.0, 2.0, 3.0, 4.0], np.float32)
    sch = make_schedule(SDXL_TURBO_SCHEDULER, N)
    plan_kw = dict(num_steps=N, idx_start=0, batch=B, use_cfg=use_cfg,
                   guidance_rescale=0.7 if use_cfg else 0.0, sched=sched)
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    z = np.stack([np.asarray(jax.random.normal(k, (B, 8, 8, 4), jnp.float32)) for k in keys])

    jcond = jd.Conditioning(*(jnp.asarray(x) for x in (pe, pool, tids, ne, npool, tids)))
    want = jd.denoise_scan_tree(
        j_apply, params, jd.DenoisePlan(**plan_kw), jnp.asarray(lat), jcond, jnp.asarray(parent_idx),
        jnp.asarray(parent_fract), jnp.asarray(coeffs), jnp.asarray(sch.sigmas), jnp.asarray(sch.timesteps),
        jnp.asarray(g), step_keys=keys, win_steps=None if win is None else jnp.asarray(win),
        win_mask=None if win_mask is None else jnp.asarray(win_mask), pin_steps=jnp.asarray(pins),
    )
    tcond = td.Conditioning(*(torch.from_numpy(x) for x in (pe, pool, tids, ne, npool, tids)))
    with torch.no_grad():
        got = td.denoise_scan_tree(
            t_apply, td.DenoisePlan(**plan_kw), torch.from_numpy(lat), tcond, torch.from_numpy(parent_idx),
            torch.from_numpy(parent_fract), torch.from_numpy(coeffs), sch.sigmas, sch.timesteps,
            torch.from_numpy(g), noise=torch.from_numpy(z), win_steps=None if win is None else torch.from_numpy(win),
            win_mask=win_mask, pin_steps=pins,
        )
    assert got.shape == (N, B, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-3, atol=5e-4)


def test_tree_ancestral_without_noise_raises():
    plan = td.DenoisePlan(num_steps=2, idx_start=0, batch=1, use_cfg=False, sched="euler_ancestral")
    with pytest.raises(ValueError, match="noise"):
        td.denoise_scan_tree(None, plan, torch.zeros(1, 8, 8, 4), None, torch.zeros(1, 2, dtype=torch.long),
                             torch.zeros(1), torch.zeros(2, 1), np.ones(3, np.float32), np.ones(2, np.float32),
                             torch.ones(1))


def test_dpmpp_step_mask_keeps_bool_results():
    """dpmpp_2m_step with a per-row mask equals the bool form row by row."""
    from latentblending_tpu_torch.ops.scheduler import dpmpp_2m_step

    rng = np.random.default_rng(3)
    x, d, od = (torch.from_numpy(rng.normal(size=(2, 4, 4, 4)).astype(np.float32)) for _ in range(3))
    s = [torch.tensor(v) for v in (14.6, 3.0, 1.2)]
    mask = torch.tensor([True, False]).reshape(-1, 1, 1, 1)
    got = dpmpp_2m_step(x, d, od, *s, mask)
    assert torch.equal(got[0:1], dpmpp_2m_step(x[0:1], d[0:1], od[0:1], *s, True))
    assert torch.equal(got[1:2], dpmpp_2m_step(x[1:2], d[1:2], od[1:2], *s, False))


# ----------------------------------------------------------------- engine


def _setup(be, stems=None):
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    if stems is not None:
        be.set_branching(nmb_max_branches=stems)
    return be


@pytest.fixture(scope="module")
def holders():
    """(JAX holder, port holder with its weights and its noise) per spec."""
    out = {}
    for spec in ("tiny-turbo", "tiny-ancestral"):
        jdh = JHolder.from_random(spec, seed=0, dtype=jnp.float32)
        tdh = port_holder_from_jax(jdh, spec)
        inject_jax_noise(tdh, jdh)
        out[spec] = (jdh, tdh)
    return out


def _assert_same_transition(jbe, tbe, jimgs, timgs, recycled=False):
    for be in (jbe, tbe):
        assert be.last_report.levels[0].get("fused") is True
        assert be.last_report.levels[0].get("recycled") is recycled
    assert tbe.tree_fracts == list(jbe.tree_fracts)
    assert tbe.tree_idx_injection == list(jbe.tree_idx_injection)
    assert len(timgs) == len(jimgs) == len(tbe.tree_fracts)
    for t, j in zip(timgs, jimgs):
        assert t.shape == (128, 128, 3) and t.dtype == np.uint8
        assert np.abs(t.astype(int) - np.asarray(j).astype(int)).max() <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)
    for t, j in zip(tbe.tree_latents, jbe.tree_latents):
        np.testing.assert_allclose(t[-1].numpy(), np.asarray(j[-1]), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("spec", ["tiny-turbo", "tiny-ancestral"])
def test_default_run_transition_is_fused_and_matches_jax(spec, holders, monkeypatch):
    monkeypatch.delenv("LB_FUSED", raising=False)
    jdh, tdh = holders[spec]
    jbe = _setup(JEngine(jdh, run_benchmark=False))
    tbe = _setup(TEngine(tdh))
    jimgs = jbe.run_transition(fixed_seeds=[420, 421])
    timgs = tbe.run_transition(fixed_seeds=[420, 421])
    assert len(timgs) == 12
    _assert_same_transition(jbe, tbe, jimgs, timgs)
    assert [i.shape[0] if i is not None else None for i in tbe.tree_latents[1]] == [None, None, 1, 1]


@pytest.mark.parametrize("variant", ["recycled", "branch1", "dpmpp_2m"])
def test_fused_variants_match_jax(variant, holders, monkeypatch):
    """The windowed fused scan of a chained transition (swap_forward +
    recycle_img1), branch1 crossfeed folded into edge 2's coefficients, and
    dpmpp_2m's per-row pin gating (tests/test_fused_tree.py's cases)."""
    monkeypatch.delenv("LB_FUSED", raising=False)
    jdh, tdh = holders["tiny-turbo"]
    saved = (jdh.schedule, tdh.schedule)
    try:
        if variant == "dpmpp_2m":
            jdh.set_scheduler_type("dpmpp_2m")
            tdh.set_scheduler_type("dpmpp_2m")
        out = []
        for be in (JEngine(jdh, run_benchmark=False), TEngine(tdh)):
            _setup(be, stems=5)
            # partial parental crossfeed: each stem's own solver state and
            # history then reach its keyframe (at turbo's default 1/1/1 a
            # stem is re-pinned to its parents at every step but the last)
            be.set_parental_crossfeed(0.3, 0.6, 0.9)
            if variant == "branch1":
                be.set_branch1_crossfeed(0.5, 0.7, 0.2)
            imgs = be.run_transition(fixed_seeds=[5, 6])
            if variant == "recycled":
                be.swap_forward()
                be.set_prompt2("photo of a bird")
                imgs = be.run_transition(recycle_img1=True, fixed_seeds=[6, 7])
            out.append((be, [np.asarray(im) for im in imgs]))
    finally:
        jdh.schedule, tdh.schedule = saved
    (jbe, jimgs), (tbe, timgs) = out
    assert len(timgs) == 7
    _assert_same_transition(jbe, tbe, jimgs, timgs, recycled=variant == "recycled")


def test_port_fused_equals_per_level_euler(monkeypatch):
    """Deterministic Euler: the fused scan reproduces the per-level path."""
    tdh = THolder.from_random("tiny-turbo", seed=0, dtype=torch.float32, device="cpu")
    be = _setup(TEngine(tdh), stems=5)
    monkeypatch.setenv("LB_FUSED", "0")
    imgs_ref = [im.copy() for im in be.run_transition(fixed_seeds=[5, 6])]
    fr_ref = list(be.tree_fracts)
    lat_ref = [t[-1].clone() for t in be.tree_latents]
    assert not be.last_report.levels[0].get("fused")
    monkeypatch.delenv("LB_FUSED")
    imgs = be.run_transition(fixed_seeds=[5, 6])
    assert be.last_report.levels[0].get("fused") is True
    assert be.tree_fracts == fr_ref
    for a, b in zip(imgs_ref, imgs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    for a, t in zip(lat_ref, be.tree_latents):
        np.testing.assert_allclose(a.numpy(), t[-1].numpy(), rtol=2e-4, atol=2e-4)


def test_gate_fallbacks(monkeypatch):
    tdh = THolder.from_random("tiny-turbo", seed=1, dtype=torch.float32, device="cpu")
    be = _setup(TEngine(tdh), stems=3)
    monkeypatch.delenv("LB_FUSED", raising=False)
    be.run_transition(fixed_seeds=[1, 2])
    assert be.last_report.levels[0].get("fused") is True
    # a recycled edge 2 has no window on its side → per-level
    be.run_transition(recycle_img2=True, fixed_seeds=[1, 2])
    assert not be.last_report.levels[0].get("fused")
    monkeypatch.setenv("LB_FUSED", "0")
    be.run_transition(fixed_seeds=[1, 2])
    assert not be.last_report.levels[0].get("fused")
    # calibrated, fused priced prohibitively: auto goes per-level, "1" fused
    be.dt_sync, be.dt_unet_step_fused, be._dt_fused_output = 1e-6, 10.0, 0.0
    be._dt_step_by_batch = {2: 1e-4, 3: 1e-4}
    monkeypatch.delenv("LB_FUSED")
    assert be.predict_transition_time()["path"] == "per-level" and not be._fused_predicted_faster(False)
    be.run_transition(fixed_seeds=[1, 2])
    assert not be.last_report.levels[0].get("fused")
    monkeypatch.setenv("LB_FUSED", "1")
    be.run_transition(fixed_seeds=[1, 2])
    assert be.last_report.levels[0].get("fused") is True


def test_fused_calibration_is_warm_only_and_separate(monkeypatch):
    """The first fused call of a holder is cold (no sample); the second
    calibrates dt_unet_step_fused and the output tail, not dt_unet_step."""
    monkeypatch.delenv("LB_FUSED", raising=False)
    be = _setup(TEngine(THolder.from_random("tiny-turbo", seed=1, dtype=torch.float32, device="cpu")), stems=3)
    be.run_transition(fixed_seeds=[1, 2])
    assert not be.dh.last_run_was_warm and be.dt_unet_step_fused is None
    be.run_transition(fixed_seeds=[1, 2])
    assert be.dh.last_run_was_warm and be.dt_unet_step_fused > 0 and be._dt_fused_output > 0
    assert be.dt_unet_step == 0.01 and not be._dt_unet_step_measured
    assert be.planner_calibrated()


@pytest.mark.parametrize("gate", ["auto", "0", "1"])
def test_cost_model_matches_jax(gate, holders, monkeypatch):
    """predict_transition_time / planner_calibrated / the auto gate with the
    calibration inputs of tests/test_cost_model.py: equal results."""
    if gate == "auto":
        monkeypatch.delenv("LB_FUSED", raising=False)
    else:
        monkeypatch.setenv("LB_FUSED", gate)
    jdh, tdh = holders["tiny-turbo"]
    jbe, tbe = JEngine(jdh, run_benchmark=False), TEngine(tdh)
    cases = [
        (([2, 3], [3, 1]), dict(dt_unet_step=0.10, dt_vae=0.01, dt_sync=0.05, dt_unet_step_fused=0.08),
         {1: 0.30, 2: 0.10, 3: 0.12}, None),
        (([2], [5]), dict(dt_unet_step=0.10, dt_vae=0.01, dt_sync=0.05, dt_unet_step_fused=0.02),
         {2: 0.10, 5: 0.11}, None),
        (([2], [5]), dict(dt_unet_step=0.10, dt_vae=0.01, dt_sync=0.05, dt_unet_step_fused=0.5),
         {1: 0.3, 2: 0.10, 5: 0.11}, 0.2),
        (([2], [4]), dict(dt_unet_step=0.1, dt_vae=0.0, dt_sync=None, dt_unet_step_fused=None), {}, None),
    ]
    for plan, dts, by_batch, out_tail in cases:
        for be in (jbe, tbe):
            be.list_idx_injection, be.list_nmb_stems = plan
            for k, v in dts.items():
                setattr(be, k, v)
            be._dt_step_by_batch = dict(by_batch)
            be._dt_fused_output = out_tail
        for recycled1 in (False, True):
            assert tbe.predict_transition_time(recycled1) == jbe.predict_transition_time(recycled1)
            assert tbe.planner_calibrated(recycled1) == jbe.planner_calibrated(recycled1)
            if len(plan[0]) == 1:
                assert tbe._fused_predicted_faster(recycled1) == jbe._fused_predicted_faster(recycled1)


def test_measure_sync_overhead_takes_min(monkeypatch):
    be = TEngine(THolder.from_random("tiny-turbo", seed=1, dtype=torch.float32, device="cpu"))
    assert be.dt_sync is None
    got = be.measure_sync_overhead(reps=3)
    assert got == be.dt_sync and 0.0 <= got < 5.0
    walls = iter([200.0, 200.005, 200.006, 200.0062, 200.0063, 200.0064])
    monkeypatch.setattr(tb.time, "time", lambda: next(walls))
    be.measure_sync_overhead(reps=3)
    assert be.dt_sync == pytest.approx(0.0001)
    # observations min-fold; the placeholder step cost is replaced outright
    be._observe_unet_step(0.12)
    be._observe_unet_step(0.22)
    assert be.dt_unet_step == 0.12 and be._observe(0.2, 0.1) == 0.1 and be._observe(None, 0.5) == 0.5
    # a resolution change drops run-time calibrations
    be._dt_step_by_batch, be.dt_unet_step_fused, be._dt_fused_output = {2: 0.1}, 0.05, 0.2
    be.set_dimensions((256, 256))
    assert (be._dt_step_by_batch, be.dt_unet_step_fused, be._dt_fused_output) == ({}, None, None)
