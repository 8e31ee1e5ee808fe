"""Device time of the kernels launched inside the UNet's forward, per
transition of the attributed trace, in s."""


def read(run):
    if run.scoped is None or not run.scoped_n:
        return None
    return run.scoped.device_s(lambda o: o.scope == "bench::unet") / run.scoped_n
