"""A latent blending transition computed plainly: the text conditioning of
both prompts, both edges denoised from their seeds' noise, every level's
stems started from the parental mix at their injection step and crossfed
toward it, and every keyframe decoded, all in float32 (TF32 off).

The tree it replays is the one the program built (the fractions and the
injection step of each keyframe), and it judges how that tree was placed:
under a value-independent plan (the fused single-level transition and the
predictive policy) by the placement rule on predicted distances, exactly;
under the measured policy by the rule on the reference's own NLPD distances
(`placement_regret`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import sampler
from benchmark.reference.clip import TextEncoder, hash_tokenize
from benchmark.reference.layers import Precision, tf32
from benchmark.reference.nlpd import nlpd
from benchmark.reference.unet import UNet
from benchmark.reference.vae import VAEDecoder, i420_to_rgb, pm1_to_i420
from benchmark.weights import PARTS, fill, names_of, part_dtype


@dataclasses.dataclass
class Request:
    prompt1: str
    prompt2: str
    negative: str
    seed1: int
    seed2: int


@dataclasses.dataclass
class Tree:
    """What the program produced for one transition."""

    fracts: list
    idx: list
    keyframes: np.ndarray  # uint8 [K,H,W,3] in tree order
    finals: torch.Tensor  # final latents [K,h,w,4] in tree order
    path: str


class Models:
    """The reference's four parts, built on `device` from the run's seed."""

    def __init__(self, cfg: dict, seed: int, device, prec: Precision | None = None):
        self.cfg, self.device = cfg, torch.device(device)
        self.prec = prec or Precision()
        c1 = dict(cfg["text_encoder"], projection=False)
        c2 = dict(cfg["text_encoder_2"], projection=True)
        mods = {"unet": UNet(cfg["unet"], self.prec), "vae": VAEDecoder(cfg["vae"], Precision()),
                "clip1": TextEncoder(c1, Precision()), "clip2": TextEncoder(c2, Precision())}
        for i, part in enumerate(PARTS):
            m = mods[part].to_empty(device=self.device).eval().requires_grad_(False)
            names = names_of(m)
            fill(dict(m.state_dict()), names, seed, i, part_dtype(cfg, part), self.device)
            setattr(self, part, m)


def _embed(m: Models, texts: list[str]):
    tok = m.cfg["tokenizer"]
    rows = []
    for key, clip in (("tokenizer", m.clip1), ("tokenizer_2", m.clip2)):
        t = tok[key]
        ids = np.stack([hash_tokenize(x.replace("_", " "), t["vocab_size"], t["bos_token_id"], t["eos_token_id"],
                                      t["pad_token_id"]) for x in texts])
        rows.append(clip(torch.as_tensor(ids, device=m.device)))
    (pen1, _), (pen2, pooled) = rows
    return torch.cat([pen1, pen2], dim=-1), pooled


class Transition:
    """Replays one transition of `cfg` for `req` on the tree `tree`."""

    def __init__(self, m: Models, req: Request, policy: str, control: bool = False, keyframe_format: str = "rgb"):
        """policy: the engine's placement policy, 'measured' or 'predictive'.
        keyframe_format: 'i420' where the keyframes leave the device as 4:2:0
        planes (the movie call), so the uint8 keyframe is their RGB."""
        self.m, self.cfg, self.req, self.policy = m, m.cfg, req, policy
        self.keyframe_format = keyframe_format
        self.control = control
        run = self.cfg["run"]
        self.N = run["num_inference_steps"]
        self.H, self.W = run["height"], run["width"]
        self.h, self.w = self.H // 8, self.W // 8
        self.timesteps, self.sigmas, self.init_sigma = sampler.schedule(self.cfg["scheduler"], self.N)
        self.ancestral = sampler.is_ancestral(self.cfg["scheduler"])
        self.cfg_on = run["guidance_scale"] > 1.0
        with torch.no_grad(), tf32(control):
            pe, pooled = _embed(m, [req.prompt1, req.prompt2, req.negative])
        self.pe, self.pooled = pe, pooled
        self.tids = torch.tensor([[self.H, self.W, 0, 0, self.H, self.W]], dtype=torch.float32, device=m.device)

    def _cond(self, fracts: list[float]):
        f = torch.tensor(fracts, dtype=torch.float32, device=self.m.device)
        pe = (1 - f)[:, None, None] * self.pe[0:1] + f[:, None, None] * self.pe[1:2]
        pool = (1 - f)[:, None] * self.pooled[0:1] + f[:, None] * self.pooled[1:2]
        if self.cfg_on:
            n = len(fracts)
            pe = torch.cat([self.pe[2:3].expand(n, -1, -1), pe])
            pool = torch.cat([self.pooled[2:3].expand(n, -1), pool])
        return pe, pool

    def _noise(self, seed: int) -> torch.Tensor:
        gen = torch.Generator(device=self.m.device).manual_seed(int(seed))
        x = torch.randn((1, self.h, self.w, 4), generator=gen, device=self.m.device, dtype=torch.float32)
        return x * self.init_sigma

    def _eps(self, x, i: int, fracts: list[float]):
        """The guided epsilon of rows x [B,h,w,4] at step i."""
        sigma = float(self.sigmas[i])
        lmi = x / (sigma ** 2 + 1.0) ** 0.5
        pe, pool = self._cond(fracts)
        rows = 2 if self.cfg_on else 1
        inp = torch.cat([lmi] * rows).permute(0, 3, 1, 2)
        t = torch.tensor([float(self.timesteps[i])], device=x.device)
        eps = torch.cat([self.m.unet(inp[j:j + 1], t, pe[j:j + 1], pool[j:j + 1], self.tids)
                         for j in range(inp.shape[0])]).permute(0, 2, 3, 1)
        if not self.cfg_on:
            return eps
        run = self.cfg["run"]
        g = torch.tensor([sampler.guidance_at(f, run["guidance_scale"], run["guidance_scale_mid_damper"])
                          for f in fracts], device=x.device)[:, None, None, None]
        u, c = eps.chunk(2)
        return u + g * (c - u)

    def _step(self, x, eps, i: int, noise):
        return sampler.euler_step(x, eps, float(self.sigmas[i]), float(self.sigmas[i + 1]), noise)

    def _decode(self, finals: torch.Tensor):
        u8, pm1 = [], []
        for j in range(finals.shape[0]):
            a, b = self.m.vae(finals[j:j + 1])
            u8.append(a if self.keyframe_format == "rgb" else i420_to_rgb(*pm1_to_i420(b)))
            pm1.append(b)
        return torch.cat(u8), torch.cat(pm1)

    def decode(self, finals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 keyframes and [-1,1] images of final latents [K,h,w,4] (the
        decode stage alone)."""
        with torch.no_grad(), tf32(self.control):
            return self._decode(finals.float())

    @torch.no_grad()
    def run(self, tree: Tree) -> dict:
        """Keyframes, final latents and placement numbers of the replayed tree."""
        with tf32(self.control):
            return self._run(tree)

    def _draws(self, tree: Tree):
        """The euler-ancestral draws: one generator per transition seeded from
        both keyframe seeds, one call [N, B, h, w, 4] over the fused batch
        (edges, then stems in placement order)."""
        if not self.ancestral:
            return None
        if tree.path != "fused":
            raise ValueError(f"ancestral draws are laid out for the fused path, the program took {tree.path!r}")
        base = (int(self.req.seed1) * 1_000_003 + int(self.req.seed2)) & 0x7FFFFFFF
        gen = torch.Generator(device=self.m.device).manual_seed((base * 1_000_003) % (2 ** 63))
        return torch.randn((self.N, len(tree.fracts), self.h, self.w, 4), generator=gen, device=self.m.device)

    def _run(self, tree: Tree) -> dict:
        run = self.cfg["run"]
        N = self.N
        policy = self.policy
        draws = self._draws(tree)
        # edges: both rows over all N steps
        x = torch.cat([self._noise(self.req.seed1), self._noise(self.req.seed2)])
        traj = {0.0: [], 1.0: []}
        for i in range(N):
            eps = self._eps(x, i, [0.0, 1.0])
            x = self._step(x, eps, i, None if draws is None else draws[i, 0:2])
            traj[0.0].append(x[0:1])
            traj[1.0].append(x[1:2])
        fr, inj = [0.0, 1.0], [0, 0]
        u8, pm1 = self._decode(torch.cat([traj[0.0][-1], traj[1.0][-1]]))
        img = {0.0: (u8[0:1], pm1[0:1]), 1.0: (u8[1:2], pm1[1:2])}
        sims = [1.0] if policy == "predictive" else self._sims(fr, img)
        mismatch, regret = 0, 0.0
        row = 2
        cf = run["parental_crossfeed"]
        for idx, k in zip(run["plan"]["idx_injection"], run["plan"]["stems"]):
            chosen = sorted(f for f, d in zip(tree.fracts, tree.idx) if d == idx)
            rule, predicted = sampler.place(k, fr, sims)
            if policy == "predictive":
                mismatch += len(set(rule) ^ set(chosen)) + abs(len(chosen) - k)
            else:
                regret = max(regret, sampler.placement_regret(k, fr, sims, chosen))
            # the program's stems, in the rule's order where it followed the
            # rule (the fused batch's row order, which the draws follow)
            order = rule if set(rule) == set(chosen) else chosen
            if len(order) != k:
                return {"mismatch": mismatch + abs(len(order) - k), "regret": 1.0}
            coeff = sampler.parental_crossfeed(N, idx, cf["power"], cf["range"], cf["decay"])
            parents = [sampler.bracket(f, fr) for f in order]
            pf = torch.tensor([(f - fr[a]) / (fr[b] - fr[a]) for f, (a, b) in zip(order, parents)],
                              device=x.device)

            def mix(i):
                return sampler.slerp(torch.cat([traj[fr[a]][i] for a, _ in parents]),
                                     torch.cat([traj[fr[b]][i] for _, b in parents]), pf)

            x = mix(idx - 1)
            for f in order:
                traj[f] = [None] * idx
            for i in range(idx, N):
                if i > idx:
                    x = sampler.slerp(x, mix(i - 1), coeff[i])
                eps = self._eps(x, i, order)
                x = self._step(x, eps, i, None if draws is None else draws[i, row:row + k])
                for r, f in enumerate(order):
                    traj[f].append(x[r:r + 1])
            row += k
            su8, spm1 = self._decode(x)
            for r, f in enumerate(order):
                img[f] = (su8[r:r + 1], spm1[r:r + 1])
                pos = sampler.bracket(f, fr)[0] + 1
                fr.insert(pos, f)
                inj.insert(pos, idx)
            sims = predicted if policy == "predictive" else self._sims(fr, img)
        return {"fracts": fr, "idx": inj, "keyframes": torch.cat([img[f][0] for f in fr]),
                "pm1": torch.cat([img[f][1] for f in fr]),
                "finals": torch.cat([traj[f][-1] for f in fr]), "mismatch": mismatch, "regret": regret}

    def _sims(self, fr, img):
        pm1 = torch.cat([img[f][1] for f in fr])
        return [float(v) for v in nlpd(pm1[:-1], pm1[1:])]

