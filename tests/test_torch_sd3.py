"""SD3 in the port (models/mmdit.py, models/t5.py, the flow-matching
schedule, SD3Holder) against the benchmark's plain float32 reference
(benchmark/reference/{mmdit,t5,sd35,vae}.py), at tiny widths on weights
drawn by benchmark/weights.py (norm scales 1 + 0.1 n, biases 0.05 n, so
no parameter is at its neutral value).

Tolerances: the port and the reference compute in float32 on the same
weights and differ only in the order of their sums (the port's fused
modulation, its attention through attention_reference's einsum), which
reads ~1e-6 relative at these widths; 1e-4 relative leaves room for other
BLAS builds and is still orders of magnitude below any wrong term (a
dropped bias, a swapped shift and scale, or a missing norm reads 1e-2 and
more). Keyframes are uint8: a 1-level difference is a rounding tie.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import mmdit as ref_mmdit
from benchmark.reference import sd35 as ref_sd35
from benchmark.reference import t5 as ref_t5
from benchmark.reference.transition import Models, Request, Transition, Tree
from benchmark.reference.vae import VAEDecoder
from latentblending_tpu_torch.engine.blending import BlendingEngine
from latentblending_tpu_torch.models import mmdit, t5
from latentblending_tpu_torch.models.sd3_configs import TINY_SD3
from latentblending_tpu_torch.ops import attention
from latentblending_tpu_torch.ops.scheduler import SD3_SCHEDULER, make_schedule
from latentblending_tpu_torch.runtime.holder import SD3Holder

torch.set_num_threads(1)  # several test workers share the cores
REL = 1e-4


def _cfg() -> dict:
    """The benchmark's SD3.5-Large configuration at tiny-sd3's widths."""
    from benchmark.tests.test_harness_sd35 import tiny_sd35_config

    return tiny_sd35_config()


def _filled_pair(port: torch.nn.Module, ref: torch.nn.Module, seed: int = 5):
    """The port module and the reference module (built on meta) with the
    same drawn float32 weights."""
    weights.fill(dict(port.state_dict()), weights.names_of(ref), seed, 0, "float32", "cpu")
    ref = ref.to_empty(device="cpu").eval().requires_grad_(False)
    ref.load_state_dict(port.state_dict(), strict=True)
    return port.eval().requires_grad_(False), ref


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.parametrize("pre_only", [False, True])
def test_mmdit_block_matches_reference(pre_only):
    cfg = TINY_SD3.mmdit
    port, ref = _filled_pair(mmdit.JointTransformerBlock(cfg, pre_only),
                             ref_mmdit.Block(cfg.inner_dim, cfg.num_attention_heads, cfg.attention_head_dim,
                                             pre_only, ref_mmdit.Precision()))
    g = torch.Generator().manual_seed(1)
    x, c = torch.randn(2, 64, cfg.inner_dim, generator=g), torch.randn(2, 45, cfg.inner_dim, generator=g)
    temb = torch.randn(2, cfg.inner_dim, generator=g)
    with torch.no_grad():
        px, pc = port(x, c, temb)
        rx, rc = ref(x, c, temb)
    assert _rel(px, rx) < REL
    if pre_only:
        assert pc is None and rc is None
    else:
        assert _rel(pc, rc) < REL


def test_mmdit_matches_reference():
    cfg = _cfg()["transformer"]
    port, ref = _filled_pair(mmdit.MMDiT(TINY_SD3.mmdit), ref_mmdit.MMDiT(cfg))
    g = torch.Generator().manual_seed(2)
    # 16x16 latents: 8x8 patches of the 12x12 table, cropped at (2, 2)
    x = torch.randn(3, 16, 16, 16, generator=g)
    ctx = torch.randn(3, 77 + 32, cfg["joint_attention_dim"], generator=g)
    pooled = torch.randn(3, cfg["pooled_projection_dim"], generator=g)
    t = torch.tensor([1000.0, 500.0, 8.9])
    with torch.no_grad():
        got = port(x, t, ctx, pooled)
        want = ref(x, t, ctx, pooled)
    assert got.shape == x.shape
    assert _rel(got, want) < REL
    # the position table is diffusers' (its first row: sin 0 = 0, cos 0 = 1
    # in each half) and centre-cropped
    table = mmdit.sincos_table(8, 12, 8)
    np.testing.assert_array_equal(table[0], [0, 0, 1, 1, 0, 0, 1, 1])
    np.testing.assert_allclose(table, ref_mmdit.sincos_2d(8, 12, 8), rtol=0, atol=0)


def test_t5_matches_reference_past_the_max_distance():
    cfg = dict(_cfg()["text_encoder_3"])
    port, ref = _filled_pair(t5.T5Encoder(TINY_SD3.t5), ref_t5.T5Encoder(cfg))
    # 300 tokens: relative distances up to 299, past max_distance 128
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, cfg["vocab_size"], (2, 300)))
    with torch.no_grad():
        assert _rel(port(ids), ref(ids)) < REL
    rel = torch.tensor([0, -1, 1, -7, 7, -8, 8, 20, -20, 127, 128, 200, -200, 299])
    got = t5.relative_position_bucket(rel, 32, 128)
    # transformers' buckets: below 8 exact (+16 for keys after the query),
    # then 8 + floor(log(n/8) / log(16) * 8), at most 15
    assert got.tolist() == [0, 1, 17, 7, 23, 8, 24, 26, 10, 31, 31, 31, 15, 31]
    assert torch.equal(got, ref_t5.bucket(rel, 32, 128))


def test_t5_tokenizer_matches_reference():
    tok = t5.T5HashTokenizer(1000, 1, 0, 32)
    texts = ["a red fox in fresh snow", "", "  many   words " * 20]
    got = tok(texts)
    want = np.stack([ref_t5.hash_tokenize(x, 1000, 1, 0, 32) for x in texts])
    np.testing.assert_array_equal(got, want)
    assert got[1].tolist() == [1] + [0] * 31 and got[2, -1] == 1


def test_vae_decode_with_shift_and_no_post_quant_conv():
    cfg = _cfg()
    dh = SD3Holder.from_random("tiny-sd3", dtype=torch.float32, device="cpu")
    assert not hasattr(dh.vae, "post_quant_conv") and not hasattr(dh.vae, "quant_conv")
    ref = VAEDecoder(cfg["vae"])
    weights.fill(dict(dh.vae.state_dict()), weights.names_of(ref), 3, 0, "float32", "cpu")
    ref = ref.to_empty(device="cpu").eval()
    ref.load_state_dict({k: v for k, v in dh.vae.state_dict().items() if k.startswith("decoder.")}, strict=True)
    z = torch.randn(2, 16, 16, 16, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = dh.decode_to_pm1_batched(z)
        _, want = ref(z)
        _, unshifted = ref(z - cfg["vae"]["shift_factor"] * cfg["vae"]["scaling_factor"])
    assert _rel(got, want) < REL
    assert _rel(got, unshifted) > 100 * REL  # the shift is applied


# diffusers' FlowMatchEulerDiscreteScheduler(shift=3.0).set_timesteps(28),
# its float32 steps replayed: the training grid's ends in float32, the
# linspace between them in float64, shifted, cast to float32
def _diffusers_flow_sigmas(n: int, shift: float = 3.0, T: int = 1000) -> np.ndarray:
    train = torch.from_numpy(np.linspace(1, T, T, dtype=np.float32)[::-1].copy()) / T
    train = shift * train / (1 + (shift - 1) * train)
    s_max, s_min = train[0].item(), train[-1].item()
    sig = np.linspace(s_max * T, s_min * T, n) / T
    sig = torch.from_numpy(shift * sig / (1 + (shift - 1) * sig)).to(torch.float32)
    return torch.cat([sig, torch.zeros(1)]).numpy()


DIFFUSERS_28_HEAD = [1.0, 0.9873806238174438, 0.9741077423095703, 0.9601293206214905, 0.9453874826431274]
DIFFUSERS_28_TAIL = [0.19982698559761047, 0.1109057292342186, 0.008928571827709675, 0.0]


def test_flow_schedule_matches_diffusers():
    st = make_schedule(SD3_SCHEDULER, 28)
    want = _diffusers_flow_sigmas(28)
    np.testing.assert_array_equal(want[:5], np.float32(DIFFUSERS_28_HEAD))
    np.testing.assert_array_equal(want[-4:], np.float32(DIFFUSERS_28_TAIL))
    np.testing.assert_allclose(st.sigmas, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(st.timesteps, want[:-1] * 1000, rtol=1e-6)
    assert st.init_noise_sigma == 1.0 and st.sigmas.dtype == np.float32 and len(st.sigmas) == 29
    t_ref, s_ref = ref_sd35.flow_schedule({"_class_name": "FlowMatchEulerDiscreteScheduler",
                                           "num_train_timesteps": 1000, "shift": 3.0}, 28)
    np.testing.assert_allclose(st.sigmas, s_ref, rtol=1e-6)


def _engine(cfg, seed: int):
    from benchmark.systems import sd35

    be = sd35.build(cfg, seed, "cpu")
    be.set_dimensions((cfg["run"]["width"], cfg["run"]["height"]))
    be.set_num_inference_steps(cfg["run"]["num_inference_steps"])
    be.set_branching(depth_strength=0.5, nmb_max_branches=6)
    be.placement_policy = "predictive"
    return be


def test_tiny_sd3_transition_matches_reference_tree():
    cfg, seed = _cfg(), 11
    be = _engine(cfg, seed)
    assert (be.list_idx_injection, be.list_nmb_stems) == ([4, 5, 6, 7], [1, 1, 1, 1])
    assert be.guidance_scale_base == 3.5
    req = Request("a red fox in fresh snow", "a lighthouse on a cliff", "blurry", 123, 456)
    be.set_negative_prompt(req.negative)
    be.set_prompt1(req.prompt1)
    be.set_prompt2(req.prompt2)
    imgs = np.stack(be.run_transition(fixed_seeds=[req.seed1, req.seed2]))
    assert all(lv.get("fused") for lv in be.last_report.levels) and len(be.last_report.levels) == 4
    finals = torch.cat([lat[-1].float() for lat in be.tree_latents])
    tree = Tree(list(be.tree_fracts), [int(i) for i in be.tree_idx_injection], imgs, finals, "fused-multi")
    out = Transition(Models(cfg, seed, "cpu"), req, "predictive").run(tree)
    assert out["fracts"] == tree.fracts and out["idx"] == tree.idx and out["mismatch"] == 0
    rel = (finals - out["finals"]).flatten(1).norm(dim=1) / out["finals"].flatten(1).norm(dim=1)
    assert float(rel.max()) < REL
    diff = np.abs(imgs.astype(np.int32) - out["keyframes"].numpy().astype(np.int32))
    assert diff.max() <= 1


def test_sd3_holder_refuses_what_it_cannot_do():
    dh = SD3Holder.from_random("tiny-sd3", dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError):
        dh.image2latent(np.zeros((128, 128, 3), np.uint8))
    with pytest.raises(ValueError):
        dh.set_scheduler_type("euler")
    with pytest.raises(NotImplementedError):
        SD3Holder(TINY_SD3, {"mmdit": dh.mmdit, "t5": dh.t5, "vae": dh.vae, "clip1": dh.clip1, "clip2": dh.clip2},
                  dtype=torch.float32, device="cpu", mesh=object())
    be = BlendingEngine(dh, run_benchmark=False)
    with pytest.raises(NotImplementedError):
        be.set_keyframe1_image(np.zeros((128, 128, 3), np.uint8))
    assert dh.get_noise(1).shape == (1, 16, 16, 16) and dh.default_time_ids(2) is None


def test_t5_span_and_k2_tail_counter_in_the_report(monkeypatch):
    """With the card stood in (attention._on_card, attention._launch), the
    MMDiT's joint attention of 64 + 77 + 32 = 173 tokens is a K2 launch at a
    length that is no multiple of 128, counted under K2 and K2_tail; each
    embed holds a t5 span; tools/span_report reads both."""
    from latentblending_tpu_torch.tools import span_report

    launches = []

    def fake_launch(name, q, k, v, out):
        launches.append((name, tuple(q.shape)))
        out.copy_(attention.attention_reference(q, k, v))

    monkeypatch.setattr(attention, "_on_card", lambda t: True)
    monkeypatch.setattr(attention, "_launch", fake_launch)
    # K2's (64, bf16) key: one head of 64 in bfloat16
    spec = dataclasses.replace(TINY_SD3, mmdit=dataclasses.replace(TINY_SD3.mmdit, attention_head_dim=64,
                                                                   num_attention_heads=1, caption_projection_dim=64))
    dh = SD3Holder.from_random(spec, dtype=torch.bfloat16, device="cpu")
    be = BlendingEngine(dh, run_benchmark=False)
    be.set_branching(depth_strength=0.5, nmb_max_branches=6)
    be.placement_policy = "predictive"
    be.set_prompt1("a red fox")
    be.set_prompt2("a lighthouse")
    be.run_transition(fixed_seeds=[1, 2])
    rep = be.last_report
    # the segmented scan: one CFG-folded MMDiT call a step (8), one launch a block (2)
    assert {n for n, _ in launches} == {"lb_attention_fwd_d64_bf16"}
    assert {s[1] for _, s in launches} == {64 + 77 + 32}
    assert rep.counters["K2"] == rep.counters["K2_tail"] == len(launches) == 8 * 2
    spans = {s.id: s for s in rep.spans}
    t5_spans = [s for s in rep.spans if s.name == "t5"]
    # one in each embed (carried ones, taken before the transition opened,
    # hang under its root)
    n_embed = sum(s.name == "embed" for s in rep.spans)
    assert len(t5_spans) == n_embed >= 2
    assert all(s.parent == rep.traces[0].root.id or spans[s.parent].name == "embed" for s in t5_spans)
    nums = span_report._numbers(rep, 1.0)
    assert nums["K2_tail"] == rep.counters["K2_tail"] and "t5_host_s" in nums and "t5_device_s" in nums
