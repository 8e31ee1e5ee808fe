"""Helpers shared by the tests/test_torch_*.py parity tests: move values
between the JAX package and its PyTorch port (latentblending_tpu_torch)
through numpy, with the same parameters on both sides."""
from __future__ import annotations

import jax
import numpy as np
import torch

from latentblending_tpu_torch.models.weights import params_from_jax
from latentblending_tpu_torch.runtime import holder as th

# The suite runs in several worker processes at once. torch's default
# intra-op pool (one thread per core in every worker) then oversubscribes
# the cores, and the tiny-shape CPU tests slow down by up to 100x; one
# thread per worker keeps them near their single-process time.
torch.set_num_threads(1)


def np_tree(tree):
    """Flax param tree → the same tree with numpy float32 leaves."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def to_torch(x, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x, np.float32))).to(dtype)


def port_module(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Load a JAX-initialised flax tree into a freshly built port module."""
    module.load_state_dict(params_from_jax(np_tree(flax_params), module), strict=True)
    return module.eval()


def port_holder_from_jax(jdh, spec: str, vae_dtype=None) -> "th.SDXLHolder":
    """A port SDXLHolder (float32 UNet, VAE in vae_dtype: None is float32;
    CPU) carrying a JAX holder's parameters."""
    metas = th.build_modules(th.SPECS[spec], torch.float32, torch.device("meta"), vae_dtype)
    sds = {k: params_from_jax(np_tree(jdh.params[k]), m) for k, m in metas.items()}
    return th.SDXLHolder.from_state_dicts(spec, sds, dtype=torch.float32, vae_dtype=vae_dtype, device="cpu")


def jax_ancestral_draws(seed_base: int, call: int, exec_steps: int, shape) -> np.ndarray:
    """The per-step euler_ancestral draws the JAX holder makes for its
    `call`-th denoise call (latentblending_tpu/runtime/holder.py)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(int(seed_base)), call), exec_steps)
    return np.stack([np.asarray(jax.random.normal(k, tuple(shape), jax.numpy.float32)) for k in keys])


def jax_ancestral_step_draws(seed_base: int, call: int, shapes) -> list[np.ndarray]:
    """The JAX holder's euler_ancestral draws for a `call`-th denoise call
    whose step i draws shapes[i] (the segmented scan's live batch)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(int(seed_base)), call), len(shapes))
    return [np.asarray(jax.random.normal(k, tuple(s), jax.numpy.float32)) for k, s in zip(keys, shapes)]


def inject_jax_noise(tdh, jdh) -> None:
    """Make the port holder `tdh` draw the JAX holder's seeded noise and
    per-call euler_ancestral draws (torch RNG cannot reproduce jax.random)."""
    tdh.get_noise = lambda seed: to_torch(jdh.get_noise(seed))
    tdh.ancestral_noise = lambda steps, shape: torch.from_numpy(
        jax_ancestral_draws(tdh.noise_seed_base, tdh._noise_call, steps, shape))
    tdh.ancestral_noise_steps = lambda shapes: [
        torch.from_numpy(z) for z in jax_ancestral_step_draws(tdh.noise_seed_base, tdh._noise_call, shapes)]


def tiny_unet_pair(pooled: int = 48, seed: int = 3):
    """The tiny UNet in both packages with the same JAX-initialised
    parameters: (jax apply(params, lat, t, pe, pool, tids), params,
    port apply(lat, t, pe, pool, tids)), latents in [B,h,w,4] on both."""
    import jax.numpy as jnp

    from latentblending_tpu.models import configs as JC
    from latentblending_tpu.models.unet import UNet2DCondition as JUNet
    from latentblending_tpu_torch.models import configs as TC
    from latentblending_tpu_torch.models.unet import UNet2DCondition as TUNet

    ju = JUNet(JC.TINY_UNET)
    params = jax.jit(ju.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 4)), jnp.float32(0.0), jnp.zeros((1, 77, 64)),
        jnp.zeros((1, pooled)), jnp.zeros((1, 6)),
    )["params"]
    tu = port_module(TUNet(TC.TINY_UNET, pooled_dim=pooled), params)

    def t_apply(lat, t, pe, pool, tids):
        return tu(lat.permute(0, 3, 1, 2), t, pe, pool, tids).permute(0, 2, 3, 1).contiguous()

    return (lambda p, lat, t, pe, pool, tids: ju.apply({"params": p}, lat, t, pe, pool, tids)), params, t_apply


def mjpeg_writers(monkeypatch, coef_lerp: str) -> None:
    """Both packages' movie writers on the same backend: LB_WRITER=mjpeg,
    LB_COEF_LERP=`coef_lerp` ("1": the coefficient lerp; "0": the pixel
    path), and no ffmpeg binary visible to the JAX writer (its `auto`
    backend would take one, and its concatenate_movies would use it)."""
    from latentblending_tpu.video import writer as jax_writer

    monkeypatch.setenv("LB_WRITER", "mjpeg")
    monkeypatch.setenv("LB_COEF_LERP", coef_lerp)
    monkeypatch.setattr(jax_writer, "_ffmpeg_exe", lambda: None)



def jax_params_from_port(module: torch.nn.Module, kind: str) -> dict:
    """A port module's state dict as the JAX package's flax param tree
    (jnp float32 leaves): the inverse of params_from_jax, by the same key
    map (models/weights.jax_path). kind: 'unet', 'vae' or 'clip'."""
    import jax.numpy as jnp

    from latentblending_tpu_torch.models.weights import jax_path

    tree: dict = {}
    for key, t in module.state_dict().items():
        path, how = jax_path(key, t.ndim, kind)
        a = t.detach().float().cpu().numpy()
        if how == "T":
            a = a.T
        elif how == "HWIO":
            a = a.transpose(2, 3, 1, 0)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(np.ascontiguousarray(a))
    return tree
