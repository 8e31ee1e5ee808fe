"""The program's own spans in a traced run: the port's tracer opens host
ranges `lb::<span>` of the profiler's function scope, which the profiler
records on the host alone (no device-side copy, unlike a user-scope
record_function). So a trace that holds them reduces to the same device
ops, scopes, busy time, kernels and idle gaps as the same trace without
them, and the readers of the device trace read the same numbers."""
from __future__ import annotations

import torch

from benchmark.metrics import Run, attn_roofline, kernels_per_transition, unet_device_s, vae_device_s
from benchmark.tests.test_harness_trace import _Ev, _prof
from benchmark.tests.tiny import tiny_config
from benchmark.trace import reduce

CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"

EVENTS = [
    _Ev("bench::transition", CPU, 0, 2000),
    _Ev("bench::unet", CPU, 100, 300),
    _Ev("cudaLaunchKernel", CPU, 150, 5, corr=1),
    _Ev("cuLaunchKernel", CPU, 160, 5, corr=2),
    _Ev("bench::vae", CPU, 500, 300),
    _Ev("cudaLaunchKernel", CPU, 550, 5, corr=3),
    _Ev("cudaMemcpyAsync", CPU, 900, 5, corr=4),
    _Ev("attention_d64_bf16_kernel<64, 128, 2>", CUDA, 200, 100, corr=1),
    _Ev("gemm", CUDA, 320, 100, corr=2),
    _Ev("bench::unet", CUDA, 200, 220),
    _Ev("attention_d512_f32_kernel", CUDA, 600, 80, corr=3),
    _Ev("Memcpy DtoH (Device -> Pinned)", CUDA, 1200, 50, corr=4),
]

LB = [  # the program's ranges, host side only, nested as the tracer opens them
    _Ev("lb::transition", CPU, 10, 1980, corr=101),
    _Ev("lb::denoise", CPU, 90, 330, corr=102),
    _Ev("lb::step", CPU, 95, 320, corr=1),  # correlation ids of host ranges may equal a launch's
    _Ev("lb::unet", CPU, 99, 305, corr=2),
    _Ev("lb::vae.decode", CPU, 490, 320, corr=3),
    _Ev("lb::sync.fetch", CPU, 880, 400, corr=4),
    _Ev("lb::gc", CPU, 1500, 30, corr=105),
]


def _run(trace) -> Run:
    return Run(cfg=tiny_config("turbo"), records=[], window_s=1.0, trace=trace, traced=1, scoped=trace, scoped_n=1)


def test_program_ranges_leave_the_reduction_unchanged():
    plain, traced = reduce(_prof(EVENTS), 1e-6), reduce(_prof(EVENTS + LB), 1e-6)
    assert traced.ops == plain.ops
    assert [o.name for o in traced.ops if o.name.startswith("lb::")] == []
    assert traced.busy_s() == plain.busy_s() and traced.kernels() == plain.kernels()
    assert traced.idle_gaps() == plain.idle_gaps()
    assert traced.top_ops() == plain.top_ops()
    for reader in (kernels_per_transition, unet_device_s, vae_device_s, attn_roofline):
        assert reader.read(_run(traced)) == reader.read(_run(plain)), reader.__name__


def test_the_tracer_opens_function_scope_ranges():
    """The tracer's range is the profiler's function-scope one, recorded on
    the host alone: what the reduction above assumes of the program's
    ranges."""
    from latentblending_tpu_torch import profiling

    assert profiling._RANGE is torch._C._profiler._RecordFunctionFast
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording():
            trace = profiling.Trace(1)
            with profiling.span("step", step=0, rows=1):
                torch.ones(4).add_(1)
            trace.finish()
    names = [(e.name(), str(e.device_type())) for e in prof.profiler.kineto_results.events()
             if e.name().startswith("lb::")]
    assert sorted(names) == [("lb::step", CPU), ("lb::transition", CPU)]
