"""SD3 (Stable Diffusion 3.5) computed plainly, for configurations whose
"architecture" is "sd35" (benchmark/architecture.py): three text towers
(CLIP-L and OpenCLIP bigG, both projected, their penultimate states side
by side, zero-padded to T5's width and followed along the sequence by
T5's tokens; the two projected pooled features concatenated), the MMDiT
on the flow-matching velocity at T·σ, classifier-free guidance dampened
toward the middle of the transition, Euler steps of the shifted
flow-matching schedule, 16-channel latents at 1/8 of the image, and the
AutoencoderKL decode with its shift and no post-quant convolution.

Departures from diffusers' StableDiffusion3Pipeline, each also the
program's:
- tokenizers: word hashes (clip.hash_tokenize, t5.hash_tokenize) in place
  of CLIP's BPE and T5's SentencePiece; T5's row is the hashed words, eos
  (1) and pad (0) to max_sequence_length, with no bos;
- CLIP-L's pooled feature is read at its first end-of-text token, 49407
  (the configuration's eos_token_id), where transformers' legacy
  eos_token_id 2 reads the largest token id; the two agree for BPE ids;
- guidance: one scale per keyframe, lowered toward the middle of the
  transition (latent blending's damper), where the pipeline has one scale;
- the schedule is computed in float64 (diffusers: its ends in float32);
- the ensemble runs each CFG row alone, in float32 with TF32 off.

The weights: the MMDiT is drawn in four parts of consecutive blocks and
T5 in three, so that no draw of weights.fill exceeds about 9 GB of
float32 at SD3.5-Large's widths; each part is a view of its model that
holds the named submodules under their own names (`view`), the program's
parts the same views of its modules.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference import sampler
from benchmark.reference import t5 as ref_t5
from benchmark.reference.clip import TextEncoder, hash_tokenize
from benchmark.reference.layers import Precision
from benchmark.reference.mmdit import MMDiT
from benchmark.reference.vae import VAEDecoder

MMDIT_PARTS, T5_PARTS = 4, 3

# the weight parts in the order that seeds their draws, each with the key
# of its dtype under the run's "dtypes"
PARTS = tuple([(f"mmdit{i}", "mmdit") for i in range(MMDIT_PARTS)] + [(f"t5_{i}", "t5") for i in range(T5_PARTS)]
              + [("vae", "vae"), ("clip1", "clip"), ("clip2", "clip")])


def _chunks(n: int, k: int) -> list[range]:
    """k consecutive ranges covering range(n) (some empty where n < k)."""
    return [range(n * i // k, n * (i + 1) // k) for i in range(k)]


def part_paths(cfg: dict) -> dict:
    """The submodules of the MMDiT and T5 each weight part holds: the
    MMDiT's embedders and output layers with its first blocks, then blocks
    in order; T5's token table with its first blocks, its final norm with
    its last."""
    out = {}
    ends = ["pos_embed", "time_text_embed", "context_embedder", "norm_out", "proj_out"]
    for i, r in enumerate(_chunks(cfg["transformer"]["num_layers"], MMDIT_PARTS)):
        out[f"mmdit{i}"] = (ends if i == 0 else []) + [f"transformer_blocks.{j}" for j in r]
    chunks = _chunks(cfg["text_encoder_3"]["num_layers"], T5_PARTS)
    for i, r in enumerate(chunks):
        out[f"t5_{i}"] = ((["shared"] if i == 0 else []) + [f"encoder.block.{j}" for j in r]
                          + (["encoder.final_layer_norm"] if i == len(chunks) - 1 else []))
    return out


class _View(nn.Module):
    """Submodules of a model under their dotted names (state-dict keys as the
    model's own); `model` is the whole, unregistered."""


def view(model: nn.Module, paths: list[str]) -> nn.Module:
    v = _View()
    object.__setattr__(v, "model", model)
    for path in paths:
        node, src = v, model
        names = path.split(".")
        for name in names[:-1]:
            src = src.get_submodule(name)
            if name not in node._modules:
                node.add_module(name, nn.Module())
            node = node._modules[name]
        node.add_module(names[-1], src.get_submodule(names[-1]))
    return v


def split(models: dict, cfg: dict) -> dict:
    """{'mmdit', 't5', 'vae', 'clip1', 'clip2'} → the parts by name (views
    of the MMDiT and T5, which must cover every tensor of both)."""
    out = {}
    for name, paths in part_paths(cfg).items():
        out[name] = view(models["mmdit" if name.startswith("mmdit") else "t5"], paths)
    for whole in ("mmdit", "t5"):
        keys = set(models[whole].state_dict())
        got = [k for n, v in out.items() if n.startswith(whole[:2]) for k in v.state_dict()]
        if sorted(got) != sorted(keys):
            raise ValueError(f"the {whole} parts do not cover its tensors once each")
    out.update(vae=models["vae"], clip1=models["clip1"], clip2=models["clip2"])
    return out


def parts(cfg: dict, control: bool = False) -> dict:
    """The parts on meta, by name. control: the MMDiT's matmuls and its patch
    convolution through float8 e4m3, the step below its bfloat16 (the
    float32 parts and T5 take TF32 from the transition's context)."""
    c1 = dict(cfg["text_encoder"], projection=True)
    c2 = dict(cfg["text_encoder_2"], projection=True)
    models = {"mmdit": MMDiT(cfg["transformer"], Precision(fp8=control)),
              "t5": ref_t5.T5Encoder(cfg["text_encoder_3"], Precision()),
              "vae": VAEDecoder(cfg["vae"], Precision()),
              "clip1": TextEncoder(c1, Precision()), "clip2": TextEncoder(c2, Precision())}
    return split(models, cfg)


def latent_shape(cfg: dict) -> tuple[int, int, int]:
    """(h, w, channels) of a latent: 1/8 of the image."""
    run = cfg["run"]
    return run["height"] // 8, run["width"] // 8, cfg["vae"]["latent_channels"]


def flow_schedule(sched: dict, n: int) -> tuple[np.ndarray, np.ndarray]:
    """FlowMatchEulerDiscreteScheduler.set_timesteps with a static shift s:
    σ = linspace(σ_max, σ_min, n) between the shifted training grid's ends,
    shifted again; (timesteps T·σ [n], σ [n+1] with a terminal 0)."""
    if sched["_class_name"] != "FlowMatchEulerDiscreteScheduler" or sched.get("use_dynamic_shifting"):
        raise ValueError(f"the reference has no sampler for {sched}")
    T, s = sched["num_train_timesteps"], sched["shift"]

    def shift(x):
        return s * x / (1.0 + (s - 1.0) * x)

    sig = shift(np.linspace(shift(1.0), shift(1.0 / T), n, dtype=np.float64))
    return T * sig, np.concatenate([sig, [0.0]])


def _embed(m, texts: list[str]):
    cfg = m.cfg
    tok = cfg["tokenizer"]
    texts = [x.replace("_", " ") for x in texts]
    rows = []
    for key, clip in (("tokenizer", m.parts["clip1"]), ("tokenizer_2", m.parts["clip2"])):
        t = tok[key]
        ids = np.stack([hash_tokenize(x, t["vocab_size"], t["bos_token_id"], t["eos_token_id"], t["pad_token_id"])
                        for x in texts])
        rows.append(clip(torch.as_tensor(ids, device=m.device)))
    t3 = tok["tokenizer_3"]
    ids3 = np.stack([ref_t5.hash_tokenize(x, t3["vocab_size"], t3["eos_token_id"], t3["pad_token_id"],
                                          cfg["run"]["max_sequence_length"]) for x in texts])
    t5 = m.parts["t5_0"].model(torch.as_tensor(ids3, device=m.device))
    (pen1, pool1), (pen2, pool2) = rows
    clip = torch.cat([pen1, pen2], dim=-1)
    clip = F.pad(clip, (0, t5.shape[-1] - clip.shape[-1]))
    return torch.cat([clip, t5], dim=1), torch.cat([pool1, pool2], dim=-1)


class Steps:
    """The model's side of one transition on the parts of `m` (a
    transition.Models): the conditioning of `prompts` (prompt 1, prompt 2,
    negative) and its mix by fraction, the guided velocity, the
    flow-matching Euler step, the initial noise and the decode."""

    def __init__(self, m, prompts: list[str]):
        self.m, self.cfg = m, m.cfg
        run = self.cfg["run"]
        self.h, self.w, self.c = latent_shape(self.cfg)
        self.timesteps, self.sigmas = flow_schedule(self.cfg["scheduler"], run["num_inference_steps"])
        self.ancestral = False
        self.cfg_on = run["guidance_scale"] > 1.0
        self.mmdit = m.parts["mmdit0"].model
        self.pe, self.pooled = _embed(m, prompts)

    def _cond(self, fracts: list[float]):
        f = torch.tensor(fracts, dtype=torch.float32, device=self.m.device)
        pe = (1 - f)[:, None, None] * self.pe[0:1] + f[:, None, None] * self.pe[1:2]
        pool = (1 - f)[:, None] * self.pooled[0:1] + f[:, None] * self.pooled[1:2]
        if self.cfg_on:
            n = len(fracts)
            pe = torch.cat([self.pe[2:3].expand(n, -1, -1), pe])
            pool = torch.cat([self.pooled[2:3].expand(n, -1), pool])
        return pe, pool

    def noise(self, seed: int) -> torch.Tensor:
        """The initial latent [1,h,w,c] of a keyframe seed (σ_max = 1)."""
        gen = torch.Generator(device=self.m.device).manual_seed(int(seed))
        return torch.randn((1, self.h, self.w, self.c), generator=gen, device=self.m.device, dtype=torch.float32)

    def output(self, x, i: int, fracts: list[float]):
        """The guided velocity of rows x [B,h,w,c] at step i (the state
        itself is the model's input)."""
        pe, pool = self._cond(fracts)
        rows = 2 if self.cfg_on else 1
        inp = torch.cat([x] * rows).permute(0, 3, 1, 2)
        t = torch.tensor([float(self.timesteps[i])], device=x.device)
        v = torch.cat([self.mmdit(inp[j:j + 1], t, pe[j:j + 1], pool[j:j + 1])
                       for j in range(inp.shape[0])]).permute(0, 2, 3, 1)
        if not self.cfg_on:
            return v
        run = self.cfg["run"]
        g = torch.tensor([sampler.guidance_at(f, run["guidance_scale"], run["guidance_scale_mid_damper"])
                          for f in fracts], device=x.device)[:, None, None, None]
        u, c = v.chunk(2)
        return u + g * (c - u)

    def step(self, x, v, i: int, noise):
        """x + (σ_{i+1} - σ_i) v."""
        return x + v * (float(self.sigmas[i + 1]) - float(self.sigmas[i]))

    def decode(self, z: torch.Tensor):
        """A final latent [1,h,w,c] → (uint8 [1,H,W,3], [-1,1] [1,H,W,3]):
        z / scaling_factor + shift_factor, decoded."""
        return self.m.parts["vae"](z)
