"""A latent blending transition computed plainly: the text conditioning of
both prompts, both edges denoised from their seeds' noise, every level's
stems started from the parental mix at their injection step and crossfed
toward it, and every keyframe decoded, all in float32 (TF32 off).

What belongs to the model (its weight parts, conditioning, guided output,
sampler step, noise and decode) is the configuration's architecture
module, benchmark/reference/<architecture>.py; this module replays the
tree. The tree it replays is the one the program built (the fractions and
the injection step of each keyframe), and it judges how that tree was
placed: under a value-independent plan (the fused single-level transition
and the predictive policy) by the placement rule on predicted distances,
exactly; under the measured policy by the rule on the reference's own NLPD
distances (`placement_regret`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import architecture
from benchmark.reference import sampler
from benchmark.reference.layers import tf32
from benchmark.reference.nlpd import nlpd
from benchmark.reference.vae import i420_to_rgb, pm1_to_i420
from benchmark.weights import fill_parts


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
    finals: torch.Tensor  # final latents [K,h,w,c] in tree order
    path: str


class Models:
    """The reference's parts of the configuration's architecture, built on
    `device` from the run's seed; control: the parts one precision below
    the configuration's (the architecture module says where)."""

    def __init__(self, cfg: dict, seed: int, device, control: bool = False):
        self.cfg, self.device = cfg, torch.device(device)
        self.arch = architecture.load("reference", cfg)
        self.parts = {name: m.to_empty(device=self.device).eval().requires_grad_(False)
                      for name, m in self.arch.parts(cfg, control).items()}
        fill_parts(self.parts, self.parts, self.arch.PARTS, cfg, seed, self.device)


class Transition:
    """Replays one transition of `cfg` for `req` on the tree `tree`."""

    def __init__(self, m: Models, req: Request, policy: str, control: bool = False, keyframe_format: str = "rgb"):
        """policy: the engine's placement policy, 'measured' or 'predictive'.
        keyframe_format: 'i420' where the keyframes leave the device as 4:2:0
        planes (the movie call), so the uint8 keyframe is their RGB."""
        self.m, self.cfg, self.req, self.policy = m, m.cfg, req, policy
        self.keyframe_format = keyframe_format
        self.control = control
        self.N = self.cfg["run"]["num_inference_steps"]
        with torch.no_grad(), tf32(control):
            self.steps = m.arch.Steps(m, [req.prompt1, req.prompt2, req.negative])

    def _decode(self, finals: torch.Tensor):
        u8, pm1 = [], []
        for j in range(finals.shape[0]):
            a, b = self.steps.decode(finals[j:j + 1])
            u8.append(a if self.keyframe_format == "rgb" else i420_to_rgb(*pm1_to_i420(b)))
            pm1.append(b)
        return torch.cat(u8), torch.cat(pm1)

    def decode(self, finals: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """uint8 keyframes and [-1,1] images of final latents [K,h,w,c] (the
        decode stage alone)."""
        with torch.no_grad(), tf32(self.control):
            return self._decode(finals.float())

    @torch.no_grad()
    def run(self, tree: Tree) -> dict:
        """Keyframes, final latents and placement numbers of the replayed tree."""
        with tf32(self.control):
            return self._run(tree)

    def _draws(self, tree: Tree):
        """The ancestral sampler's draws: one generator per transition seeded
        from both keyframe seeds, one call [N, B, h, w, c] over the fused
        batch (edges, then stems in placement order)."""
        if not self.steps.ancestral:
            return None
        if tree.path != "fused":
            raise ValueError(f"ancestral draws are laid out for the fused path, the program took {tree.path!r}")
        base = (int(self.req.seed1) * 1_000_003 + int(self.req.seed2)) & 0x7FFFFFFF
        gen = torch.Generator(device=self.m.device).manual_seed((base * 1_000_003) % (2 ** 63))
        return torch.randn((self.N, len(tree.fracts)) + self.m.arch.latent_shape(self.cfg), generator=gen,
                           device=self.m.device)

    def _run(self, tree: Tree) -> dict:
        run = self.cfg["run"]
        N = self.N
        policy = self.policy
        draws = self._draws(tree)
        # edges: both rows over all N steps
        x = torch.cat([self.steps.noise(self.req.seed1), self.steps.noise(self.req.seed2)])
        traj = {0.0: [], 1.0: []}
        for i in range(N):
            out = self.steps.output(x, i, [0.0, 1.0])
            x = self.steps.step(x, out, i, None if draws is None else draws[i, 0:2])
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
                out = self.steps.output(x, i, order)
                x = self.steps.step(x, out, i, None if draws is None else draws[i, row:row + k])
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

