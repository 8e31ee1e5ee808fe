"""The trace reduction on hand-made event lists, in the form the
profiler's KinetoEvent gives them (the kind inferred from device and name):
device ops attributed through their launch's correlation id to the
innermost bench:: range open on the host, busy time as the union of device
intervals, idle gaps named by the op that ended them; and a traced run of a
tiny cell on the CPU, through both of its profiles."""
from __future__ import annotations

import types

import pytest
import torch

from benchmark import run
from benchmark.trace import reduce


class _Ev:
    def __init__(self, name, dev, start, dur, corr=0):
        self._n, self._d, self._s, self._u, self._c = name, dev, start, dur, corr

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u

    def correlation_id(self):
        return self._c


def _prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


def test_reduce_attributes_and_times_device_ops():
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"  # str() of torch.autograd.DeviceType
    events = [
        _Ev("bench::transition", cpu, 0, 1000),
        _Ev("bench::unet", cpu, 100, 300),
        _Ev("cudaLaunchKernel", cpu, 150, 5, corr=1),  # inside bench::unet
        _Ev("cuLaunchKernel", cpu, 500, 5, corr=2),  # after it: bench::transition
        _Ev("cudaMemcpyAsync", cpu, 600, 5, corr=3),
        _Ev("aten::add", cpu, 140, 20, corr=99),
        _Ev("attention_d64_bf16_kernel<64, 128, 2>", cuda, 200, 100, corr=1),
        _Ev("bench::unet", cuda, 200, 100),  # the device copy of the range
        _Ev("gemm", cuda, 250, 100, corr=2),  # overlaps the first
        _Ev("Memcpy DtoH (Device -> Pinned)", cuda, 700, 50, corr=3),
    ]
    tr = reduce(_prof(events), 1e-6)
    assert [(o.name[:9], o.kind, o.scope) for o in tr.ops] == [
        ("attention", "kernel", "bench::unet"), ("gemm", "kernel", "bench::transition"),
        ("Memcpy Dt", "gpu_memcpy", "bench::transition")]
    assert tr.busy_s() == pytest.approx(200e-9)  # [200, 350) and [700, 750)
    assert len(tr.kernels()) == 2
    assert tr.device_s(lambda o: o.scope == "bench::unet") == pytest.approx(100e-9)
    assert tr.idle_gaps() == [["bench::transition > Memcpy DtoH (Device -> Pinned)", pytest.approx(350e-9)]]
    assert tr.top_ops(1) == [["gemm", pytest.approx(100e-9)]] or tr.top_ops(1)[0][1] == pytest.approx(100e-9)


def test_a_device_profile_has_no_scopes():
    """A profile of the device alone records launches but no ranges."""
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    events = [_Ev("cudaLaunchKernel", cpu, 10, 5, corr=1), _Ev("cudaLaunchKernel", cpu, 20, 5, corr=2),
              _Ev("gemm", cuda, 100, 50, corr=1), _Ev("Memset (Device)", cuda, 400, 10, corr=2)]
    tr = reduce(_prof(events), 1e-6)
    assert [(o.kind, o.scope) for o in tr.ops] == [("kernel", ""), ("gpu_memset", "")]
    assert tr.busy_s() == pytest.approx(60e-9)
    assert tr.idle_gaps() == [["host > Memset (Device)", pytest.approx(250e-9)]]


def test_a_traced_run_reports_per_layer_metrics(tmp_path):
    """A --trace 1 run of a tiny cell on the CPU: both profiles taken, a
    transition after them for the host-clock rates, correct."""
    from benchmark.tests.test_harness_reference import SEED
    from benchmark.tests.tiny import tiny_root

    torch.set_num_threads(2)
    bench = tiny_root(str(tmp_path), {"t.turbo": ("turbo", "transition")})
    res = run.run_cell(bench, "t.turbo", SEED, 0.1, True, "cpu", root=str(tmp_path))
    assert res["correct"], res["check"]
    assert res["attempted"] >= 3
    assert {"mfu", "denoise_s", "embed_s", "kernels_per_transition"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0 and set(res["breakdown"]) == {"device_ops", "idle_gaps"}
