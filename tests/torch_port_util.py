"""Helpers shared by the tests/test_torch_*.py parity tests: move values
between the JAX package and its PyTorch port (latentblending_tpu_torch)
through numpy, with the same parameters on both sides."""
from __future__ import annotations

import jax
import numpy as np
import torch

from latentblending_tpu_torch.models.weights import params_from_jax
from latentblending_tpu_torch.runtime import holder as th


def np_tree(tree):
    """Flax param tree → the same tree with numpy float32 leaves."""
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), tree)


def to_torch(x, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(x, np.float32))).to(dtype)


def port_module(module: torch.nn.Module, flax_params) -> torch.nn.Module:
    """Load a JAX-initialised flax tree into a freshly built port module."""
    module.load_state_dict(params_from_jax(np_tree(flax_params), module), strict=True)
    return module.eval()


def port_holder_from_jax(jdh, spec: str) -> "th.SDXLHolder":
    """A port SDXLHolder (float32, CPU) carrying a JAX holder's parameters."""
    metas = th.build_modules(th.SPECS[spec], torch.float32, torch.device("meta"))
    sds = {k: params_from_jax(np_tree(jdh.params[k]), m) for k, m in metas.items()}
    return th.SDXLHolder.from_state_dicts(spec, sds, dtype=torch.float32, device="cpu")


def jax_ancestral_draws(seed_base: int, call: int, exec_steps: int, shape) -> np.ndarray:
    """The per-step euler_ancestral draws the JAX holder makes for its
    `call`-th denoise call (latentblending_tpu/runtime/holder.py)."""
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(int(seed_base)), call), exec_steps)
    return np.stack([np.asarray(jax.random.normal(k, tuple(shape), jax.numpy.float32)) for k in keys])
