"""latentblending_tpu_torch — the PyTorch/CUDA port of latentblending_tpu.

Same module names as the JAX package, so each counterpart is easy to find.
The port imports torch and never jax; its hand-written CUDA kernels live in
csrc/ and are built on first use (ops/_build.py). Every export loads
lazily, so `import latentblending_tpu_torch` imports no torch and builds no
model:

    from latentblending_tpu_torch import BlendingEngine, SDXLHolder

The exported names are the JAX package's `__all__`. `yml_load` and
`yml_save` are the PyYAML-free ones of yaml_text.py (utils.py keeps its
byte copy of the JAX module, which needs PyYAML).
"""

__version__ = "0.1.0"

# name → module it lives in (relative to this package); the value's own
# name is the key unless the pair gives another
_EXPORTS = {
    "BlendingEngine": "engine.blending",
    "EngineConfig": "engine.config",
    "SDXLHolder": "runtime.holder",
    # drop-in alias of the reference package's holder class
    "DiffusersHolder": ("runtime.holder", "SDXLHolder"),
    "interpolate_spherical": "ops.interp",
    "interpolate_spherical_batched": "ops.interp",
    "interpolate_linear": "ops.interp",
    "add_frames_linear_interp": "video.frames",
    "Keyframe": "engine.session",
    "MovieProject": "engine.session",
    "run_multi_transition": "engine.session",
    "MovieSaver": "video.writer",
    "concatenate_movies": "video.writer",
    "read_movie_frames": "video.writer",
    "get_spacing": "utils",
    "get_time": "utils",
    "yml_load": "yaml_text",
    "yml_save": "yaml_text",
}


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(name)
    module, attr = target if isinstance(target, tuple) else (target, name)
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), attr)


__all__ = list(_EXPORTS)
