"""The slice as a whole: BlendingEngine.run_transition(fixed_seeds=[420,421])
in the JAX package (per-level path, LB_FUSED=0) and in the port, with the
same parameters, the JAX seeded noise injected into the port, and for the
ancestral solver the JAX per-step draws injected too.

Bounds: tree_fracts and tree_idx_injection exactly equal (a single-round
level places stems independently of the similarity values); uint8
keyframes within 1 LSB; similarities rtol 1e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.engine.blending import BlendingEngine as JEngine
from latentblending_tpu.runtime.holder import SDXLHolder as JHolder
from latentblending_tpu_torch.engine.blending import BlendingEngine as TEngine
from tests.torch_port_util import jax_ancestral_draws, port_holder_from_jax, to_torch

PROMPTS = ("photo of a forest at dawn", "photo of a city at night", "blurry, low quality")


def _setup(be):
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    be.set_negative_prompt(PROMPTS[2])
    # set_negative_prompt only takes effect at the next embedding
    be.set_prompt1(PROMPTS[0])
    be.set_prompt2(PROMPTS[1])
    return be


@pytest.mark.parametrize("spec", ["tiny-turbo", "tiny-ancestral"])
def test_run_transition_matches_jax(spec, monkeypatch):
    monkeypatch.setenv("LB_FUSED", "0")
    jdh = JHolder.from_random(spec, seed=0, dtype=jnp.float32)
    jbe = _setup(JEngine(jdh, run_benchmark=False))
    jimgs = jbe.run_transition(fixed_seeds=[420, 421])

    tdh = port_holder_from_jax(jdh, spec)
    tdh.get_noise = lambda seed: to_torch(jdh.get_noise(seed))
    tdh.ancestral_noise = lambda steps, shape: torch.from_numpy(
        jax_ancestral_draws(tdh.noise_seed_base, tdh._noise_call, steps, shape))
    tbe = _setup(TEngine(tdh))
    timgs = tbe.run_transition(fixed_seeds=[420, 421])

    assert tbe.list_idx_injection == list(jbe.list_idx_injection)
    assert tbe.tree_fracts == jbe.tree_fracts
    assert tbe.tree_idx_injection == jbe.tree_idx_injection
    assert len(timgs) == len(jimgs) == 12
    for t, j in zip(timgs, jimgs):
        assert t.shape == (128, 128, 3) and t.dtype == np.uint8
        assert np.abs(t.astype(int) - np.asarray(j).astype(int)).max() <= 1
    np.testing.assert_allclose(tbe.tree_similarities, jbe.tree_similarities, rtol=1e-4)
    assert tbe.get_state_dict() == {k: v for k, v in jbe.get_state_dict().items()}


def test_swap_forward_and_recycle(monkeypatch):
    """swap_forward moves keyframe 2 to keyframe 1, and a recycled first
    trajectory is reused unchanged (port only; JAX semantics)."""
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    be = _setup(TEngine(SDXLHolder.from_random("tiny-turbo", seed=1, dtype=torch.float32)))
    be.set_branching(nmb_max_branches=4)
    be.run_transition(fixed_seeds=[5, 6])
    last = be.tree_latents[-1][-1].clone()
    be.swap_forward()
    assert torch.equal(be.tree_latents[0][-1], last) and be.prompt1 == be.prompt2
    imgs = be.run_transition(recycle_img1=True, fixed_seeds=[5, 9])
    assert torch.equal(be.tree_latents[0][-1], last)
    assert len(imgs) == 6 and be.tree_fracts[0] == 0.0 and be.tree_fracts[-1] == 1.0
