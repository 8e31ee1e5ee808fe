"""SDXL computed plainly, for configurations whose "architecture" is
"sdxl" (benchmark/architecture.py): two CLIP towers (both penultimate
states side by side, the second's projected pooled feature), the UNet on
epsilon with SDXL's time ids, classifier-free guidance dampened toward
the middle of the transition, Euler or Euler-ancestral steps, 4-channel
latents at 1/8 of the image, and the AutoencoderKL decode.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import sampler
from benchmark.reference.clip import TextEncoder, hash_tokenize
from benchmark.reference.layers import Precision
from benchmark.reference.unet import UNet
from benchmark.reference.vae import VAEDecoder

# the weight parts in the order that seeds their draws (weights.fill's
# part index), each with the key of its dtype under the run's "dtypes"
PARTS = (("unet", "unet"), ("vae", "vae"), ("clip1", "clip"), ("clip2", "clip"))


def parts(cfg: dict, control: bool = False) -> dict:
    """The parts on meta, by name. control: the UNet's matmuls and
    convolutions through float8 e4m3, the step below its bfloat16 (the
    float32 parts take TF32 from the transition's context)."""
    c1 = dict(cfg["text_encoder"], projection=False)
    c2 = dict(cfg["text_encoder_2"], projection=True)
    return {"unet": UNet(cfg["unet"], Precision(fp8=control)), "vae": VAEDecoder(cfg["vae"], Precision()),
            "clip1": TextEncoder(c1, Precision()), "clip2": TextEncoder(c2, Precision())}


def latent_shape(cfg: dict) -> tuple[int, int, int]:
    """(h, w, channels) of a latent: 1/8 of the image."""
    run = cfg["run"]
    return run["height"] // 8, run["width"] // 8, cfg["vae"]["latent_channels"]


def _embed(m, texts: list[str]):
    tok = m.cfg["tokenizer"]
    rows = []
    for key, clip in (("tokenizer", m.parts["clip1"]), ("tokenizer_2", m.parts["clip2"])):
        t = tok[key]
        ids = np.stack([hash_tokenize(x.replace("_", " "), t["vocab_size"], t["bos_token_id"], t["eos_token_id"],
                                      t["pad_token_id"]) for x in texts])
        rows.append(clip(torch.as_tensor(ids, device=m.device)))
    (pen1, _), (pen2, pooled) = rows
    return torch.cat([pen1, pen2], dim=-1), pooled


class Steps:
    """The model's side of one transition on the parts of `m` (a
    transition.Models): the conditioning of `prompts` (prompt 1, prompt 2,
    negative) and its mix by fraction, the guided epsilon, the sampler's
    step, the initial noise and the decode."""

    def __init__(self, m, prompts: list[str]):
        self.m, self.cfg = m, m.cfg
        run = self.cfg["run"]
        self.h, self.w, self.c = latent_shape(self.cfg)
        self.timesteps, self.sigmas, self.init_sigma = sampler.schedule(self.cfg["scheduler"],
                                                                        run["num_inference_steps"])
        self.ancestral = sampler.is_ancestral(self.cfg["scheduler"])
        self.cfg_on = run["guidance_scale"] > 1.0
        self.pe, self.pooled = _embed(m, prompts)
        H, W = run["height"], run["width"]
        self.tids = torch.tensor([[H, W, 0, 0, H, W]], dtype=torch.float32, device=m.device)

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
        """The initial latent [1,h,w,c] of a keyframe seed."""
        gen = torch.Generator(device=self.m.device).manual_seed(int(seed))
        x = torch.randn((1, self.h, self.w, self.c), generator=gen, device=self.m.device, dtype=torch.float32)
        return x * self.init_sigma

    def output(self, x, i: int, fracts: list[float]):
        """The guided epsilon of rows x [B,h,w,c] at step i."""
        sigma = float(self.sigmas[i])
        lmi = x / (sigma ** 2 + 1.0) ** 0.5
        pe, pool = self._cond(fracts)
        rows = 2 if self.cfg_on else 1
        inp = torch.cat([lmi] * rows).permute(0, 3, 1, 2)
        t = torch.tensor([float(self.timesteps[i])], device=x.device)
        unet = self.m.parts["unet"]
        eps = torch.cat([unet(inp[j:j + 1], t, pe[j:j + 1], pool[j:j + 1], self.tids)
                         for j in range(inp.shape[0])]).permute(0, 2, 3, 1)
        if not self.cfg_on:
            return eps
        run = self.cfg["run"]
        g = torch.tensor([sampler.guidance_at(f, run["guidance_scale"], run["guidance_scale_mid_damper"])
                          for f in fracts], device=x.device)[:, None, None, None]
        u, c = eps.chunk(2)
        return u + g * (c - u)

    def step(self, x, eps, i: int, noise):
        """Step i of the sampler; noise: the ancestral draw of the rows, or None."""
        return sampler.euler_step(x, eps, float(self.sigmas[i]), float(self.sigmas[i + 1]), noise)

    def decode(self, z: torch.Tensor):
        """A final latent [1,h,w,c] → (uint8 [1,H,W,3], [-1,1] [1,H,W,3])."""
        return self.m.parts["vae"](z)
