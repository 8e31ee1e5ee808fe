"""A second architecture added without an edit to the shared modules: a toy
registered under benchmark.systems.toy, benchmark.reference.toy and
benchmark.yardstick.toy in sys.modules (no file), with 16-channel
latents, three weight parts and a flow-matching Euler step, whose system
is the plain reference put in the program's place (as the calibrate
control is), runs through run.run_cell to correct with latent_rel 0; a
keyframe altered where the toy produces it does not."""
from __future__ import annotations

import json
import os
import sys
import types

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark import run
from benchmark.reference import sampler
from benchmark.reference.clip import hash_tokenize
from benchmark.reference.layers import Conv2d, Linear
from benchmark.reference.transition import Models, Request, Transition, Tree
from benchmark.reference.vae import pm1_to_uint8
from benchmark.tests.test_harness_reference import SEED
from benchmark.tests.tiny import tiny_config, tiny_root

CH, DOWN, SHIFT = 16, 8, 3.0


# -- benchmark.reference.toy --

class _Text(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.embed = nn.Embedding(cfg["tokenizer"]["vocab_size"], CH, device="meta")

    def forward(self, ids):
        return self.embed(ids).mean(dim=1)


class _Denoiser(nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = Linear(CH, CH)

    def forward(self, x, cond, sigma: float):
        """The velocity of rows x [B,h,w,c] under conditions cond [B,c]."""
        return self.proj(x + sigma * cond[:, None, None, :]) - x


class _Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(CH, 3, 1)

    def forward(self, z):
        pm1 = torch.tanh(F.interpolate(self.conv(z.permute(0, 3, 1, 2)), scale_factor=DOWN, mode="nearest"))
        pm1 = pm1.permute(0, 2, 3, 1)
        return pm1_to_uint8(pm1), pm1


def _parts(cfg, control=False):
    return {"text": _Text(cfg), "denoiser": _Denoiser(), "decoder": _Decoder()}


def _latent_shape(cfg):
    return cfg["run"]["height"] // DOWN, cfg["run"]["width"] // DOWN, CH


class _Steps:
    def __init__(self, m, prompts):
        self.m, self.run = m, m.cfg["run"]
        t = np.linspace(1.0, 0.0, self.run["num_inference_steps"] + 1)
        self.sigmas = SHIFT * t / (1.0 + (SHIFT - 1.0) * t)
        self.ancestral = False
        tok = m.cfg["tokenizer"]
        ids = np.stack([hash_tokenize(p, tok["vocab_size"], tok["bos_token_id"], tok["eos_token_id"],
                                      tok["pad_token_id"]) for p in prompts])
        self.cond = m.parts["text"](torch.as_tensor(ids, device=m.device))

    def noise(self, seed):
        gen = torch.Generator(device=self.m.device).manual_seed(int(seed))
        return torch.randn((1,) + _latent_shape(self.m.cfg), generator=gen, device=self.m.device)

    def output(self, x, i, fracts):
        f = torch.tensor(fracts, dtype=torch.float32, device=x.device)[:, None]
        cond = (1 - f) * self.cond[0:1] + f * self.cond[1:2]
        sigma = float(self.sigmas[i])
        den = self.m.parts["denoiser"]
        v = den(x, cond, sigma)
        u = den(x, self.cond[2:3].expand(len(fracts), -1), sigma)
        g = torch.tensor([sampler.guidance_at(fr, self.run["guidance_scale"], self.run["guidance_scale_mid_damper"])
                          for fr in fracts], device=x.device)[:, None, None, None]
        return u + g * (v - u)

    def step(self, x, v, i, noise):
        """Flow-matching Euler: x + (sigma_next - sigma) v."""
        return x + (float(self.sigmas[i + 1]) - float(self.sigmas[i])) * v

    def decode(self, z):
        return self.m.parts["decoder"](z)


# -- benchmark.systems.toy: the reference in the program's place --

class _Engine:
    def __init__(self, cfg, seed, device):
        self.models = Models(cfg, seed, device)
        cf = cfg["run"]["parental_crossfeed"]
        self.parental_crossfeed_power, self.parental_crossfeed_range, self.parental_crossfeed_decay = (
            cf["power"], cf["range"], cf["decay"])
        self.guidance_scale_base = cfg["run"]["guidance_scale"]
        self.list_idx_injection, self.list_nmb_stems = [], []
        self.plan = cfg["run"]["plan"]
        self.placement_policy = None
        self.prompts = ["", "", ""]

    def set_dimensions(self, size):
        pass

    def set_num_inference_steps(self, n):
        pass

    def set_branching(self, depth_strength, nmb_max_branches):
        self.list_idx_injection, self.list_nmb_stems = self.plan["idx_injection"], self.plan["stems"]

    def set_negative_prompt(self, text):
        self.prompts[2] = text

    def set_prompt1(self, text):
        self.prompts[0] = text

    def set_prompt2(self, text):
        self.prompts[1] = text

    def run_transition(self, fixed_seeds):
        """The tree the predictive rule places, replayed by the reference."""
        fr, inj, sims = [0.0, 1.0], [0, 0], [1.0]
        for d, k in zip(self.list_idx_injection, self.list_nmb_stems):
            rule, sims = sampler.place(k, fr, sims)
            for f in rule:
                pos = sampler.bracket(f, fr)[0] + 1
                fr.insert(pos, f)
                inj.insert(pos, d)
        req = Request(self.prompts[0], self.prompts[1], self.prompts[2], *fixed_seeds)
        out = Transition(self.models, req, self.placement_policy).run(Tree(fr, inj, None, None, "fused-multi"))
        self.tree_fracts, self.tree_idx_injection = out["fracts"], out["idx"]
        self.tree_latents = [[z] for z in out["finals"].split(1)]
        self.last_report = types.SimpleNamespace(phases={}, levels=[{"fused": True}] * len(self.list_nmb_stems))
        return [self._keyframe(k) for k in out["keyframes"].cpu().numpy()]

    @staticmethod
    def _keyframe(k):
        return k


def _module(name, **attrs):
    mod = types.ModuleType(name)
    mod.__dict__.update(attrs)
    return mod


@pytest.fixture
def toy(monkeypatch, tmp_path):
    """A tiny root whose one cell, t.toy, runs the toy architecture under
    the predictive mix, with every limit 0."""
    torch.set_num_threads(2)
    mods = {
        "benchmark.reference.toy": _module("benchmark.reference.toy", PARTS=(
            ("text", "text"), ("denoiser", "denoiser"), ("decoder", "decoder")), parts=_parts,
            latent_shape=_latent_shape, Steps=_Steps),
        "benchmark.systems.toy": _module("benchmark.systems.toy", build=_Engine, hooked=lambda e: (
            e.models.parts["denoiser"], e.models.parts["decoder"])),
        "benchmark.yardstick.toy": _module("benchmark.yardstick.toy", ATTENTION_KERNELS=(),
                                           model_seconds_at_peak=lambda cfg: 1e-9,
                                           attention_bound_seconds=lambda cfg: 1e-9),
    }
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    tmp = str(tmp_path)
    bench = tiny_root(tmp, {"t.toy": ("base", "predictive")})
    cfg = tiny_config("base")
    for key in ("unet", "vae", "text_encoder", "text_encoder_2", "port_spec"):
        del cfg[key]
    cfg.update(name="tiny-toy", architecture="toy", tokenizer=cfg["tokenizer"]["tokenizer"])
    cfg["run"]["dtypes"] = {"text": "float32", "denoiser": "bfloat16", "decoder": "float32"}
    with open(os.path.join(tmp, "benchmark", "configs", "tiny-toy.json"), "w") as f:
        json.dump(cfg, f)
    bench["configs"] = [{"name": "tiny-toy", "file": "benchmark/configs/tiny-toy.json"}]
    bench["workloads"][0]["config"] = "tiny-toy"
    with open(os.path.join(tmp, "benchmark", "checks", "t.toy.json"), "w") as f:
        json.dump({"sample_transitions": 1, "path": "fused-multi",
                   "limits": dict.fromkeys(("latent_rel", "keyframe_mad", "decode_mad", "placement", "structure"),
                                           0)}, f)
    return tmp, bench


@pytest.mark.parametrize("trace", [False, True])
def test_a_second_architecture_runs_to_correct(toy, trace):
    tmp, bench = toy
    res = run.run_cell(bench, "t.toy", SEED, 0.0, trace, "cpu", root=tmp)
    assert res["correct"], res["check"]
    assert res["check"]["latent_rel"]["value"] == 0.0
    # the toy's own yardstick costs the work: mfu read through it
    assert ("mfu.predictive" in res["metrics"]) == trace


def test_a_toy_keyframe_altered_is_not_correct(toy, monkeypatch):
    tmp, bench = toy

    def altered(k):
        k = k.copy()
        k[:16, :16] += 16
        return k

    monkeypatch.setattr(_Engine, "_keyframe", staticmethod(altered))
    res = run.run_cell(bench, "t.toy", SEED, 0.0, False, "cpu", root=tmp)
    assert not res["correct"], res["check"]
    assert res["check"]["keyframe_mad"]["value"] > 0
