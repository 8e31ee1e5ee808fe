"""The port's tracer (latentblending_tpu_torch/profiling.py) on tiny CPU
engines: one span tree per transition (parents, transition ids, the
writer thread's spans under the transition they write, carried embeds,
garbage collections), `phases` as the phase spans' sums, the profiler's
`lb::` ranges only under a profile, and `host_syncs` exact on the fused,
fused-multi and per-level paths. A `gpu` test holds the device intervals
on the card."""
from __future__ import annotations

import collections
import gc
import math

import numpy as np
import pytest
import torch

from latentblending_tpu_torch import profiling
from latentblending_tpu_torch.engine.blending import BlendingEngine
from latentblending_tpu_torch.runtime.holder import SDXLHolder

torch.set_num_threads(1)  # several test workers share the cores
CHUNK = 4  # keyframes per fetch chunk (LB_FETCH_CHUNK's default)


@pytest.fixture
def turbo(monkeypatch):
    for var in ("LB_FUSED", "LB_FETCH_CHUNK", "LB_KEYFRAME_I420"):
        monkeypatch.delenv(var, raising=False)
    be = BlendingEngine(SDXLHolder.from_random("tiny-turbo", seed=1, dtype=torch.float32, device="cpu"))
    be.set_prompt1("a lighthouse")
    be.set_prompt2("a forest")
    return be


@pytest.fixture
def base(monkeypatch):
    for var in ("LB_FUSED", "LB_FETCH_CHUNK"):
        monkeypatch.delenv(var, raising=False)
    be = BlendingEngine(SDXLHolder.from_random("tiny-base", seed=1, dtype=torch.float32, device="cpu"),
                        run_benchmark=False)
    be.set_num_inference_steps(8)
    be.set_branching(depth_strength=0.5, nmb_max_branches=8)  # [4, 5, 6, 7] x [2, 2, 1, 1]
    be.set_prompt1("a lighthouse")
    be.set_prompt2("a forest")
    return be


def _by_name(rep) -> collections.Counter:
    return collections.Counter(s.name for s in rep.spans)


def _check_tree(rep) -> dict:
    """Every span of the report under its transition's root; returns them by id."""
    spans = {s.id: s for s in rep.spans}
    roots = [s for s in rep.spans if s.parent is None]
    assert [r.name for r in roots] == ["transition"] and roots[0].attrs == {"transition_id": rep.transition_id}
    for s in rep.spans:
        assert s.transition_id == rep.transition_id
        assert s.parent is None or s.parent in spans, s.name
        assert s.start_ns is not None and s.end_ns is not None and s.end_ns >= s.start_ns, s.name
    return spans


def _ancestors(s, spans) -> list:
    out = []
    while s.parent is not None:
        s = spans[s.parent]
        out.append(s.name)
    return out


def test_a_transition_is_one_span_tree(base):
    """Per-level path: the root, the carried embeds, level > round > the
    denoise phase > step > unet, a step span a denoise step with its step
    and rows; levels' wall_s are their spans'; ids count transitions."""
    rep0_id = base._transitions
    base.run_transition(fixed_seeds=[10, 20])
    rep = base.last_report
    assert rep.transition_id == rep0_id + 1
    spans = _check_tree(rep)
    names = _by_name(rep)
    # the constructor's two embeds and the two set_prompt ones, before the transition
    assert names["embed"] == 4
    assert all(spans[s.parent].name == "transition" for s in rep.spans if s.name == "embed")
    N, plan = base.num_inference_steps, list(zip(base.list_idx_injection, base.list_nmb_stems))
    steps = [s for s in rep.spans if s.name == "step"]
    assert len(steps) == N + sum(N - i for i, _ in plan)
    assert names["unet"] == len(steps) and names["level"] == len(plan) and names["round"] == len(plan)
    assert [s.attrs for s in steps[:N]] == [{"step": j, "rows": 2} for j in range(N)]
    for s in steps[N:]:
        assert _ancestors(s, spans)[:4] == ["denoise", "round", "level", "transition"]
    assert all(spans[s.parent].name == "step" for s in rep.spans if s.name == "unet")
    levels = [s for s in rep.spans if s.name == "level"]
    assert [lv["wall_s"] for lv in rep.levels] == [round(s.host_s, 3) for s in levels]
    assert [(s.attrs["idx_injection"], s.attrs["stems"]) for s in levels] == [tuple(map(int, p)) for p in plan]
    assert rep.wall_s == rep.spans[0].host_s
    d = rep.as_dict()
    assert d["transition_id"] == rep.transition_id and len(d["spans"]) == len(rep.spans)
    assert d["spans"][0]["name"] == "transition" and d["host_syncs"] == rep.host_syncs
    # the next transition: the next id, no embed left to carry
    base.run_transition(fixed_seeds=[10, 20])
    assert base.last_report.transition_id == rep.transition_id + 1
    assert "embed" not in _by_name(base.last_report)


def test_gc_during_a_transition_is_a_span():
    with profiling.recording():
        trace = profiling.Trace(7)
        with profiling.span("step", step=0, rows=1):
            gc.collect()
        trace.finish()
    gcs = [s for s in trace.spans if s.name == "gc"]
    assert gcs and gcs[0].attrs["generation"] == 2 and "collected" in gcs[0].attrs
    assert trace.spans[gcs[0].parent].name == "step" and gcs[0].transition_id == 7
    n = len(trace.spans)
    gc.collect()  # no transition open: recorded nowhere
    with profiling.span("step"):
        pass
    assert len(trace.spans) == n


def test_phases_are_the_phase_spans(turbo, tmp_path):
    """phases keeps its keys and counts on the fused path, and each total is
    its phase spans' host seconds; the movie's movie_write holds the
    writer's fetch, encode and finalize spans."""
    turbo.run_transition(fixed_seeds=[420, 421])
    rep = turbo.last_report
    assert set(rep.phases) == {"denoise", "vae_decode", "similarity", "similarity_sync", "keyframe_fetch"}
    for name, p in rep.phases.items():
        phase_spans = [s for s in rep.spans if s.name == name]
        assert p["count"] == len(phase_spans) == 1
        assert p["total_s"] == round(sum(s.host_s for s in phase_spans), 4)
    turbo.run_movie_transition(str(tmp_path / "m.mp4"), 2, fps=8, fixed_seeds=[420, 421])
    rep = turbo.last_report
    spans = _check_tree(rep)
    mw = [s for s in rep.spans if s.name == "movie_write"]
    assert rep.phases["movie_write"] == {"total_s": round(mw[0].host_s, 4), "count": 1,
                                         "mean_s": round(mw[0].host_s, 4)}
    names = _by_name(rep)
    assert names["encode"] == len(turbo.tree_final_imgs) and names["finalize"] == 1
    for name in ("encode", "finalize", "fetch"):
        inside = [s for s in rep.spans if s.name == name and "movie_write" in _ancestors(s, spans)]
        assert inside, name
    assert [sorted(s.attrs) for s in rep.spans if s.name == "encode"][:2] == [["frames"], ["frames", "gap"]]


def test_session_parts_keep_their_writer_spans(turbo, tmp_path):
    """run_multi_transition: each part's writer thread records into its
    part's transition; the merged report keeps every part's tree, and
    lpips_sync counts one blocked read a part."""
    from latentblending_tpu_torch.engine.session import Keyframe, MovieProject, run_multi_transition

    project = MovieProject([Keyframe("a lighthouse", 1), Keyframe("a forest", 2), Keyframe("a desert", 3)],
                           width=128, height=128, num_inference_steps=4)
    run_multi_transition(turbo, project, str(tmp_path / "s.mp4"), duration_single_trans=1, fps=8,
                         overlap_write=True)
    rep = turbo.last_report
    assert rep.transition_id is None and len(rep.traces) == 2
    assert rep.phases["lpips_sync"]["count"] == 2 and rep.phases["lpips_sync"]["total_s"] >= 0
    ids = [t.transition_id for t in rep.traces]
    assert ids[1] == ids[0] + 1
    for t in rep.traces:
        encodes = [s for s in t.spans if s.name == "encode"]
        assert encodes and all(s.transition_id == t.transition_id and s.parent == t.root.id for s in encodes)
    assert len(rep.as_dict()["spans"]) == sum(len(t.spans) for t in rep.traces)


def test_lb_ranges_only_under_a_profile(turbo, monkeypatch):
    """Under a torch.profiler session every recorded span is an lb:: host
    range on the profiler's timeline; outside one the tracer opens none."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        turbo.run_transition(fixed_seeds=[420, 421])
    names = collections.Counter(e.name for e in prof.events() if e.name.startswith("lb::"))
    want = _by_name(turbo.last_report)
    for name in ("transition", "step", "unet", "vae.decode", "similarity.pass", "sync.denoise", "denoise"):
        assert names["lb::" + name] == want[name], name
    opened = []
    real = profiling._RANGE
    monkeypatch.setattr(profiling, "_RANGE", lambda name: opened.append(name) or real(name))
    turbo.run_transition(fixed_seeds=[420, 421])
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        turbo.run_transition(fixed_seeds=[420, 421])
    assert len(opened) == len(turbo.last_report.spans)


def _syncs(rep) -> dict:
    return dict(collections.Counter(s.name for s in rep.spans if s.name.startswith("sync.")))


def test_host_syncs_fused(turbo):
    """Fused: the denoise's sync, one read a fetch chunk, the deferred
    similarities' read."""
    turbo.run_transition(fixed_seeds=[420, 421])
    rep = turbo.last_report
    k = 2 + int(turbo.list_nmb_stems[0])
    assert _syncs(rep) == {"sync.denoise": 1, "sync.fetch": math.ceil(k / CHUNK), "sync.sims": 1}
    assert rep.host_syncs == 2 + math.ceil(k / CHUNK) == rep.counters["host_syncs"]


def test_host_syncs_fused_multi(base, monkeypatch):
    """The segmented multi-level transition (predictive): as fused."""
    monkeypatch.setenv("LB_FUSED", "1")
    base.placement_policy = "predictive"
    base.run_transition(fixed_seeds=[10, 20])
    rep = base.last_report
    assert all(lv.get("seg") for lv in rep.levels)
    k = 2 + sum(int(n) for n in base.list_nmb_stems)
    assert _syncs(rep) == {"sync.denoise": 1, "sync.fetch": math.ceil(k / CHUNK), "sync.sims": 1}
    assert rep.host_syncs == 2 + math.ceil(k / CHUNK)


def test_host_syncs_per_level(base):
    """Measured per-level: the edges' sync and similarity read, per round
    its sync, its similarity read (the last round's deferred to the
    report), one read a fetch chunk (the edges' and each round's)."""
    base.run_transition(fixed_seeds=[10, 20])
    rep = base.last_report
    stems = [int(n) for n in base.list_nmb_stems]
    R = len(stems)
    want = {"sync.denoise": 1 + R, "sync.sims": 1 + (R - 1) + 1,
            "sync.fetch": 1 + sum(math.ceil(k / CHUNK) for k in stems)}
    assert _syncs(rep) == want
    assert stems == [2, 2, 1, 1] and rep.host_syncs == sum(want.values()) == 15


@pytest.mark.gpu
def test_device_intervals_on_gpu():
    """On the card each step, decode, similarity pass and embed span has
    its device interval once run_transition returns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events have no CPU mode)")
    be = BlendingEngine(SDXLHolder.from_random("tiny-turbo", seed=1, dtype=torch.float32, device="cuda"))
    be.set_prompt1("a lighthouse")
    be.set_prompt2("a forest")
    be.run_transition(fixed_seeds=[420, 421])
    timed = [s for s in be.last_report.spans if s.name in ("step", "vae.decode", "similarity.pass", "embed")]
    assert {s.name for s in timed} == {"step", "vae.decode", "similarity.pass", "embed"}
    assert all(s.device_s is not None and s.device_s > 0 for s in timed)
    assert np.isfinite([s.device_s for s in timed]).all()


def test_span_report_names_gaps_by_program_span():
    """tools/span_report.named_gaps: a gap is named by the innermost lb::
    span open on the host when it began and the op that ended it; its
    seconds go to the innermost spans open on the host while it lasted;
    device ranges are not ops."""
    from latentblending_tpu_torch.tools.span_report import named_gaps

    class Ev:
        def __init__(self, name, dev, start, dur):
            self.args = name, dev, start, dur

        def name(self):
            return self.args[0]

        def device_type(self):
            return self.args[1]

        def start_ns(self):
            return self.args[2]

        def duration_ns(self):
            return self.args[3]

    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    events = [Ev("lb::transition", cpu, 0, 1000), Ev("lb::step", cpu, 10, 400), Ev("lb::unet", cpu, 20, 300),
              Ev("lb::sync.sims", cpu, 600, 300), Ev("aten::mm", cpu, 30, 5),
              Ev("gemm", cuda, 100, 100), Ev("bench::unet", cuda, 100, 300), Ev("lb::step", cuda, 100, 300),
              Ev("norm", cuda, 250, 50), Ev("Memcpy DtoH", cuda, 700, 20), Ev("late", cuda, 950, 10)]
    out = named_gaps(events)
    assert out["ops"] == 4 and out["busy_s"] == pytest.approx(180e-9) and out["window_s"] == pytest.approx(860e-9)
    assert out["idle_gaps"] == [["lb::unet > Memcpy DtoH", pytest.approx(400e-9)],
                                ["lb::sync.sims > late", pytest.approx(230e-9)],
                                ["lb::unet > norm", pytest.approx(50e-9)]]
    # [200, 250) in unet; [300, 700): unet to 320, step to 410, transition to 600, sync.sims;
    # [720, 950): sync.sims to 900, transition
    assert out["idle_s_by_span"] == {"lb::unet": pytest.approx(70e-9), "lb::step": pytest.approx(90e-9),
                                     "lb::transition": pytest.approx(240e-9), "lb::sync.sims": pytest.approx(280e-9)}


def test_counters_lose_no_update_across_threads():
    """Threads counting into one registry counter at a tiny switch
    interval: no increment is lost."""
    import sys
    import threading

    before, interval = profiling.counter("stress"), sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [profiling.count("stress") for _ in range(20000)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counter("stress") - before == 8 * 20000
