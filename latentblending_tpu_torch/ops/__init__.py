"""The port's ops: the names of latentblending_tpu/ops/__init__.py's
`__all__`, each loaded on first use (importing latentblending_tpu_torch.ops
loads none of its modules), plus the modules themselves: attention (K2/K3),
slerp (K1), interp, scheduler, schedules, resize, flops and _build."""

# name → module of this package it lives in
_EXPORTS = {
    "interpolate_linear": "interp",
    "interpolate_linear_pytree": "interp",
    "interpolate_spherical": "interp",
    "interpolate_spherical_batched": "interp",
    "SchedulerConfig": "scheduler",
    "SchedulerState": "scheduler",
    "SDXL_BASE_SCHEDULER": "scheduler",
    "SDXL_TURBO_SCHEDULER": "scheduler",
    "make_schedule": "scheduler",
    "scale_model_input": "scheduler",
    "euler_step": "scheduler",
    "branch1_crossfeed_coeffs": "schedules",
    "parental_crossfeed_coeffs": "schedules",
    "guidance_mid_dampening": "schedules",
    "turbo_branching_plan": "schedules",
    "time_based_branching_plan": "schedules",
    "get_closest_idx": "schedules",
    "frame_insert_counts": "schedules",
}


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(name)
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


__all__ = list(_EXPORTS)
