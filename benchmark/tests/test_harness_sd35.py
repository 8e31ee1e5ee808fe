"""The sd35 architecture at the port's tiny SD3 spec (tiny-sd3), through
run.run_cell on the CPU: the program's SD3Holder under the predictive
policy against benchmark/reference/sd35.py's replay reaches `correct`;
a keyframe altered where the call returns it, or T5's relative-position
bias dropped in the program, does not. Also: the parts views cover the
models' tensors once each, and every draw stays under 10 GB of float32 at
the published widths."""
from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from benchmark import run
from benchmark.reference import sd35 as ref_sd35
from benchmark.tests.test_harness_reference import SEED
from benchmark.tests.tiny import REPO, tiny_root

# tiny-sd3's numbers (latentblending_tpu_torch/models/sd3_configs.py) in the
# configuration's keys
TINY = {
    "transformer": dict(sample_size=16, num_layers=2, attention_head_dim=16, num_attention_heads=2,
                        joint_attention_dim=64, caption_projection_dim=32, pooled_projection_dim=80,
                        pos_embed_max_size=12),
    "text_encoder_3": dict(vocab_size=1000, d_model=64, d_kv=16, d_ff=96, num_layers=2, num_heads=4),
    "vae": dict(block_out_channels=[16, 16, 32, 32], layers_per_block=1, norm_num_groups=4),
    "text_encoder": dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_attention_heads=2,
                         num_hidden_layers=2, projection_dim=32, eos_token_id=999),
    "text_encoder_2": dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_attention_heads=2,
                           num_hidden_layers=2, projection_dim=48, eos_token_id=999),
}
# the tiny cell's limits: its sound readings over seeds 1-4 were at most
# latent_rel 4.8e-7, keyframe_mad and decode_mad 1.2e-4 (the float32
# program against the float32 reference differ by summation order alone);
# the limits sit 200x and 4000x above them, under the faults below
LIMITS = {"latent_rel": 1e-4, "keyframe_mad": 0.5, "decode_mad": 0.5, "placement": 0.0, "structure": 0}


def tiny_sd35_config() -> dict:
    with open(os.path.join(REPO, "benchmark", "configs", "sd35-large-1024.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(name="tiny-sd35", port_spec="tiny-sd3")
    for key, vals in TINY.items():
        cfg[key].update(vals)
    tok = {"vocab_size": 1000, "bos_token_id": 0, "eos_token_id": 999}
    cfg["tokenizer"] = {"tokenizer": dict(tok, pad_token_id=999), "tokenizer_2": dict(tok, pad_token_id=0),
                        "tokenizer_3": {"vocab_size": 1000, "eos_token_id": 1, "pad_token_id": 0}}
    r = cfg["run"]
    r.update(width=128, height=128, num_inference_steps=8, max_sequence_length=32)
    # float32 throughout: the tiny cell checks the program's wiring, not its precision
    r["dtypes"] = {"mmdit": "float32", "t5": "float32", "t5_compute": "float32", "vae": "float32", "clip": "float32",
                   "latents": "float32"}
    r["plan"] = {"idx_injection": [4, 5, 6, 7], "stems": [1, 1, 1, 1]}
    return cfg


@pytest.fixture
def sd35_root(tmp_path):
    torch.set_num_threads(2)
    tmp = str(tmp_path)
    bench = tiny_root(tmp, {"t.sd35": ("base", "predictive")})
    cfg = tiny_sd35_config()
    with open(os.path.join(tmp, "benchmark", "configs", "tiny-sd35.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"] = [{"name": "tiny-sd35", "file": "benchmark/configs/tiny-sd35.json"}]
    bench["workloads"][0]["config"] = "tiny-sd35"
    with open(os.path.join(tmp, "benchmark", "checks", "t.sd35.json"), "w") as f:
        json.dump({"sample_transitions": 1, "path": "fused-multi", "limits": LIMITS}, f)
    return tmp, bench


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_sd35_cell_is_correct(sd35_root, trace):
    tmp, bench = sd35_root
    res = run.run_cell(bench, "t.sd35", SEED, 0.0, trace, "cpu", root=tmp)
    assert res["correct"], res["check"]
    assert res["check"]["structure"]["value"] == 0 and res["check"]["placement"]["value"] == 0
    assert ("mfu.predictive" in res["metrics"]) == trace


def test_tiny_sd35_altered_keyframe_is_not_correct(sd35_root, monkeypatch):
    from benchmark.calls import run_transition

    tmp, bench = sd35_root
    real = run_transition.Call.call

    def altered(self, engine, req, n):
        imgs, product = real(self, engine, req, n)
        imgs[2] = imgs[2].copy()
        imgs[2][:64, :64] += 16
        return imgs, product

    monkeypatch.setattr(run_transition.Call, "call", altered)
    res = run.run_cell(bench, "t.sd35", SEED, 0.0, False, "cpu", root=tmp)
    assert not res["correct"], res["check"]
    assert res["check"]["keyframe_mad"]["value"] > LIMITS["keyframe_mad"]


def test_tiny_sd35_without_t5_bias_is_not_correct(sd35_root, monkeypatch):
    from latentblending_tpu_torch.models import t5

    tmp, bench = sd35_root
    monkeypatch.setattr(t5.T5Attention, "position_bias", lambda self, length, device: torch.zeros((), device=device))
    res = run.run_cell(bench, "t.sd35", SEED, 0.0, False, "cpu", root=tmp)
    assert not res["correct"], res["check"]
    assert res["check"]["latent_rel"]["value"] > LIMITS["latent_rel"]


def test_parts_cover_the_models_and_stay_under_10_gb():
    with open(os.path.join(REPO, "benchmark", "configs", "sd35-large-1024.json")) as f:
        cfg = json.load(f)
    parts = ref_sd35.parts(cfg)
    assert [n for n, _ in ref_sd35.PARTS] == list(parts)
    sizes = {n: sum(t.numel() for t in m.state_dict().values()) for n, m in parts.items()}
    assert max(sizes.values()) * 4 < 10e9, sizes
    whole = {n: sum(t.numel() for t in parts[p].model.state_dict().values()) for n, p in (("mmdit", "mmdit0"),
                                                                                          ("t5", "t5_0"))}
    assert sum(v for n, v in sizes.items() if n.startswith("mm")) == whole["mmdit"]
    assert sum(v for n, v in sizes.items() if n.startswith("t5")) == whole["t5"] == 4_762_310_656
