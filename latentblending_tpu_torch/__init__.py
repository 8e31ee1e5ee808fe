"""latentblending_tpu_torch — the PyTorch/CUDA port of latentblending_tpu.

Same module names as the JAX package, so each counterpart is easy to find.
The port imports torch and never jax; its hand-written CUDA kernels live in
csrc/ and are built on first use (ops/_build.py). Heavy modules load lazily:

    from latentblending_tpu_torch.runtime.holder import SDXLHolder
    from latentblending_tpu_torch.engine.blending import BlendingEngine
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name == "BlendingEngine":
        from latentblending_tpu_torch.engine.blending import BlendingEngine

        return BlendingEngine
    if name == "SDXLHolder":
        from latentblending_tpu_torch.runtime.holder import SDXLHolder

        return SDXLHolder
    raise AttributeError(name)


__all__ = ["BlendingEngine", "SDXLHolder"]
