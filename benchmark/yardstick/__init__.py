"""Peaks, operation counts and the work a transition needs.

work.py counts what a transition's plan needs (row-steps, image evals,
keyframes) for any architecture; what that work costs is the
architecture's module, named as a configuration's "architecture"
(benchmark/architecture.py). Each has

- `model_seconds_at_peak(cfg)`: the model work a transition needs, each
  part at the peak of its configured dtype (the numerator of `mfu`);
- `attention_bound_seconds(cfg)`: the bound of the attention-kernel work
  a transition needs (the numerator of `attn_roofline`);
- `ATTENTION_KERNELS`: parts of the profiler names of the program's
  kernels that run that work.
"""
