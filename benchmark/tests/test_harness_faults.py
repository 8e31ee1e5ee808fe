"""A run with the timed path broken underneath comes out not correct, for
each fault a keyframe cell can have: a sampler step that returns its state
unchanged; half of the UNet's batch left out and the mean of the rest
given to it; a keyframe altered where it is produced (one 16x16 block of
the uint8 conversion); and, in the movie, in-between samples coded at
fractions 1.2 times their own (J2's answer altered) and keyframe samples
whose DC coefficients are off by 2 (J1's answer altered); and, under the
measured policy, stems placed in the gap of least distance. The harness's look
for a chip is skipped: the tiny cells run on the CPU. (No cell spans chips,
so there is no exchange to leave out.)"""
from __future__ import annotations

import pytest
import torch

from benchmark import run
from benchmark.tests.test_harness_reference import CELLS, SEED
from benchmark.tests.tiny import tiny_root


def _step_unchanged(mp):
    from latentblending_tpu_torch.runtime import denoise

    mp.setattr(denoise, "euler_step", lambda sample, *a, **k: sample)
    mp.setattr(denoise, "euler_ancestral_step", lambda sample, *a, **k: sample)


def _half_batch(mp):
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    orig = SDXLHolder._unet_apply

    def half(self, lat, t, pe, pool, tids):
        h = max(1, lat.shape[0] // 2)
        out = orig(self, lat[:h], t, pe[:h], pool[:h], tids[:h])
        rest = out.mean(dim=0, keepdim=True).expand((lat.shape[0] - h,) + tuple(out.shape[1:]))
        return torch.cat([out, rest.to(out.dtype)])

    mp.setattr(SDXLHolder, "_unet_apply", half)


def _answer_altered(mp):
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    orig = SDXLHolder.to_uint8_device

    def altered(imgs):
        u8 = orig(imgs).clone()
        u8[0, :16, :16] += 16
        return u8

    mp.setattr(SDXLHolder, "to_uint8_device", staticmethod(altered))


def _lerp_fraction(mp):
    from latentblending_tpu_torch.video import jpeg

    orig = jpeg.coef_lerp_batch_reference

    def off(a, b, ts):
        return orig(a, b, [min(1.0, t * 1.2) if t < 1.0 else t for t in ts])

    mp.setattr(jpeg, "coef_lerp_batch_reference", off)


def _dc_off(mp):
    from latentblending_tpu_torch.video import jpeg

    orig = jpeg.fdct_quant_reference

    def off(frames, quality, fmt="i420"):
        coef = orig(frames, quality, fmt).clone()
        coef[..., 0] += 2
        return coef

    mp.setattr(jpeg, "fdct_quant_reference", off)


def _placement_altered(mp):
    """Each stem of a measured level placed in the gap of least distance."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine

    orig = BlendingEngine._plan_placements

    def least(self, k, idx_injection):
        if self._predictive() or len(self.tree_similarities) < 2:
            return orig(self, k, idx_injection)
        saved = self.tree_similarities
        self.tree_similarities = [-s for s in saved]
        try:
            return orig(self, k, idx_injection)
        finally:
            self.tree_similarities = saved

    mp.setattr(BlendingEngine, "_plan_placements", least)


MOVIE_FAULTS = {"lerp_fraction": _lerp_fraction, "dc_off": _dc_off}
FAULTS = {"step_unchanged": _step_unchanged, "half_batch": _half_batch, "answer_altered": _answer_altered}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    tmp = str(tmp_path_factory.mktemp("bench"))
    return tmp, tiny_root(tmp, CELLS)


@pytest.mark.parametrize("cell, fault", [(c, f) for c in ("t.turbo", "t.base") for f in sorted(FAULTS)]
                         + [("t.movie", f) for f in sorted(MOVIE_FAULTS)] + [("t.base", "placement_altered")])
def test_a_broken_path_is_not_correct(root, cell, fault, monkeypatch):
    tmp, bench = root
    dict(FAULTS, **MOVIE_FAULTS, placement_altered=_placement_altered)[fault](monkeypatch)
    res = run.run_cell(bench, cell, SEED, 0.1, False, "cpu", root=tmp)
    assert not res["correct"], res["check"]
