"""Attention kernels' share of their roofline, in %: the bound of the
attention work the traced transitions need (gated UNet self-attention over
the needed image evals, the VAE mid-block attention per keyframe) over the
device time the trace gives the port's attention kernels (K2, K3)."""
from benchmark.yardstick import work

# the port's K2 (d=64) and K3 (d=512) kernels, by their profiler names
ATTENTION_KERNELS = ("attention_d64_", "attention_d512_")


def read(run):
    if run.trace is None or not run.traced:
        return None
    t = run.trace.device_s(lambda o: o.kind == "kernel" and any(k in o.name for k in ATTENTION_KERNELS))
    if t <= 0:
        return None
    return 100.0 * run.traced * work.attention_bound_seconds(run.cfg) / t
