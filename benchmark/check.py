"""Whether what the timed path produced is correct: a sample of the
window's transitions, drawn from the seed, replayed by the plain reference
once the program is freed, and compared number by number with the cell's
limits (benchmark/checks/<cell>.json).

Numbers, each the worst over the sampled transitions:
- latent_rel: the worst keyframe's |program - reference| / |reference| of
  the final latents, the reference computing the whole transition from the
  prompts and seeds (text conditioning, denoiser, sampler, tree);
- keyframe_mad: the worst keyframe's mean |program - reference| in uint8
  levels, over the same whole transition and its decode;
- decode_mad: the same against the reference's decode of the program's own
  final latents: the decode stage alone, at float32's precision;
- placement: fractions placed otherwise than the rule on predicted
  distances (a count), or, under the measured policy, the worst relative
  regret of a placement on the reference's NLPD distances;
- structure: keyframes whose count, fraction or injection step differ from
  the plan, plus 1 where the engine took another path than the cell's;
and the numbers of the mix's call (benchmark/calls/<call>.py), such as a
movie's JPEG samples.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from benchmark import calls
from benchmark.reference.transition import Models, Transition, Tree


def sample(n_records: int, n: int, seed: int) -> list[int]:
    """Indices of the transitions to check, drawn from the run's seed."""
    rng = random.Random(f"check:{seed}")
    return sorted(rng.sample(range(n_records), min(n, n_records)))


def keep(record) -> tuple:
    """What the check needs of a record, off the program's state: the
    request, a Tree (final latents stacked on the device) and the call's
    product."""
    finals = torch.cat([f.float() for f in record.finals])
    return record.request, Tree(record.fracts, record.idx, record.keyframes, finals, record.path), record.product


def _mad(a, b) -> float:
    """The worst keyframe's mean |a - b| over uint8 [K,H,W,3] stacks."""
    a = torch.as_tensor(np.asarray(a)).to(torch.int32)
    b = torch.as_tensor(np.asarray(b)).to(torch.int32)
    return float((a - b).abs().float().mean(dim=(1, 2, 3)).max())


def judge(ref: Transition, out: dict, tree: Tree, path: str) -> tuple[dict, object]:
    """The numbers of one transition against the reference's replay, and
    the reference's decode of the program's final latents ([-1,1])."""
    structure = int(tree.path != path)
    if "keyframes" not in out or out["fracts"] != tree.fracts or out["idx"] != tree.idx:
        structure += 1 + abs(len(tree.fracts) - len(out.get("fracts", [])))
        return {"latent_rel": 1.0, "keyframe_mad": 255.0, "decode_mad": 255.0,
                "placement": out["mismatch"] + out["regret"], "structure": structure}, None
    dec, dec_pm1 = ref.decode(tree.finals)
    ref_f = out["finals"].float()
    rel = (tree.finals.float() - ref_f).flatten(1).norm(dim=1) / ref_f.flatten(1).norm(dim=1)
    return {
        "latent_rel": float(rel.max()),
        "keyframe_mad": _mad(tree.keyframes, out["keyframes"].cpu()),
        "decode_mad": _mad(tree.keyframes, dec.cpu()),
        "placement": float(out["mismatch"] if ref.policy == "predictive" else out["regret"]),
        "structure": structure,
    }, dec_pm1


def worst(rows: list[dict]) -> dict:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def check(cfg: dict, cell_check: dict, mix: dict, kept: list, seed: int, device) -> dict:
    """Replay the kept transitions and judge each; the worst numbers."""
    models = Models(cfg, seed, device)
    call = calls.load(mix["call"])
    rows = []
    worst_row = {k: float(v) for k, v in cell_check["limits"].items()}
    for req, tree, product in kept:
        if tree.path != cell_check["path"]:
            # another path than the cell's: judged as a structure fault, unreplayed
            rows.append(dict({k: max(1.0, 2 * v) for k, v in worst_row.items()}, structure=1))
            continue
        ref = Transition(models, req, mix["placement_policy"], keyframe_format=call.KEYFRAME_FORMAT)
        out = ref.run(tree)
        row, dec_pm1 = judge(ref, out, tree, cell_check["path"])
        extra = call.judge(dec_pm1, tree, product, mix)
        row["structure"] += extra.pop("structure", 0)
        row.update(extra)
        rows.append(row)
    return worst(rows)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """correct, and each number beside its limit."""
    table = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), table
