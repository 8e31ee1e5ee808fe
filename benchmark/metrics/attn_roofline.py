"""Attention kernels' share of their roofline, in %: the bound of the
attention work the traced transitions need over the device time the trace
gives the port's kernels that run it, both from the architecture's
yardstick module (SDXL: gated UNet self-attention over the needed image
evals and the VAE mid-block attention per keyframe, on K2 and K3)."""
from benchmark import architecture


def read(run):
    if run.trace is None or not run.traced:
        return None
    ys = architecture.load("yardstick", run.cfg)
    t = run.trace.device_s(lambda o: o.kind == "kernel" and any(k in o.name for k in ys.ATTENTION_KERNELS))
    if t <= 0:
        return None
    return 100.0 * run.traced * ys.attention_bound_seconds(run.cfg) / t
