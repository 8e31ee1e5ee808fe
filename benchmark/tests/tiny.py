"""Tiny configurations of the port's CPU test specs (tiny-ancestral:
SDXL-Turbo's sampler; tiny-base: SDXL-base's with CFG and a multi-level
plan), in the benchmark's configuration format, and a root that holds a
BENCHMARK.json of tiny cells for runs on the CPU."""
from __future__ import annotations

import copy
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))


def _load(name):
    with open(os.path.join(REPO, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def tiny_config(kind: str) -> dict:
    """kind 'turbo' (4 steps, euler-ancestral, one level) or 'base' (8
    steps, Euler, CFG, three levels)."""
    cfg = copy.deepcopy(_load("sdxl-turbo-512" if kind == "turbo" else "sdxl-base-1024"))
    cfg["name"] = f"tiny-{kind}"
    cfg["port_spec"] = "tiny-ancestral" if kind == "turbo" else "tiny-base"
    cfg["unet"].update(sample_size=16, block_out_channels=[32, 64, 128], layers_per_block=1,
                       attention_head_dim=[1, 2, 4], transformer_layers_per_block=[1, 1, 1],
                       cross_attention_dim=64, norm_num_groups=8, addition_time_embed_dim=8,
                       projection_class_embeddings_input_dim=48 + 6 * 8)
    cfg["vae"].update(block_out_channels=[16, 16, 32, 32], layers_per_block=1, norm_num_groups=4)
    te = dict(vocab_size=1000, hidden_size=32, intermediate_size=64, num_attention_heads=2,
              num_hidden_layers=2, eos_token_id=999)
    cfg["text_encoder"].update(te)
    cfg["text_encoder_2"].update(te, hidden_act="gelu", projection_dim=48)
    cfg["tokenizer"] = {"tokenizer": {"vocab_size": 1000, "bos_token_id": 0, "eos_token_id": 999,
                                      "pad_token_id": 999},
                        "tokenizer_2": {"vocab_size": 1000, "bos_token_id": 0, "eos_token_id": 999,
                                        "pad_token_id": 0}}
    run = cfg["run"]
    run.update(width=128, height=128)
    if kind == "base":
        run.update(num_inference_steps=8)
        run["plan"] = {"idx_injection": [4, 5, 6, 7], "stems": [2, 2, 1, 1]}
        run["engine"]["branching"] = {"depth_strength": 0.5, "nmb_max_branches": 8}
    return cfg


# limits of the tiny cells, from tiny runs' own readings over seeds 1-6
# (test_harness_reference.py's docstring gives them)
LIMITS = {
    "turbo": {"latent_rel": 0.012, "keyframe_mad": 1.5, "decode_mad": 0.01, "placement": 0.0, "structure": 0},
    "base": {"latent_rel": 0.04, "keyframe_mad": 2.5, "decode_mad": 0.01, "placement": 0.02, "structure": 0},
}

MOVIE_LIMITS = {"movie_key_coef": 0.0, "movie_mid_coef": 0.0}


def tiny_root(tmp, cells: dict) -> dict:
    """Write tiny cells {name: (kind, traffic)} under `tmp` as a checkout
    would hold them; returns the BENCHMARK.json dict."""
    for sub in ("configs", "traffic", "checks"):
        os.makedirs(os.path.join(tmp, "benchmark", sub), exist_ok=True)
    real = {("turbo", "transition"): "turbo512.transition", ("base", "transition"): "base1024.transition",
            ("base", "predictive"): "base1024.predictive", ("turbo", "movie"): "turbo512.movie"}
    tiny_of = {real[v]: k for k, v in cells.items()}
    bench = _load_bench()
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny_of[w] for w in m["workloads"] if w in tiny_of]
    bench.update(configs=[], workloads=[])
    for name, (kind, traffic) in cells.items():
        cfg = tiny_config(kind)
        path = f"benchmark/configs/{cfg['name']}.json"
        with open(os.path.join(tmp, path), "w") as f:
            json.dump(cfg, f)
        if cfg["name"] not in [c["name"] for c in bench["configs"]]:
            bench["configs"].append({"name": cfg["name"], "file": path})
        bench["workloads"].append({"name": name, "config": cfg["name"], "traffic": traffic, "chips": 1})
        with open(os.path.join(REPO, "benchmark", "traffic", traffic + ".json")) as f:
            mix = json.load(f)
        with open(os.path.join(tmp, "benchmark", "traffic", traffic + ".json"), "w") as f:
            json.dump(dict(mix, trace_seconds=0.0, movie_seconds=2), f)
        check = {"sample_transitions": 1, "path": "fused" if kind == "turbo" else (
                     "per-level" if traffic == "transition" else "fused-multi"),
                 "limits": dict(LIMITS[kind], **(MOVIE_LIMITS if traffic == "movie" else {}))}
        with open(os.path.join(tmp, "benchmark", "checks", name + ".json"), "w") as f:
            json.dump(check, f)
    return bench


def _load_bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)
