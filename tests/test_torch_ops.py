"""Parity of the port's ops (latentblending_tpu_torch.ops) with the JAX
package: interpolation, the K1 slerp kernel's plain version (against the
Pallas kernel in interpret mode), the scheduler, the K2/K3 attention plain
version (against jax.nn.dot_product_attention) and the kernel gate.
Inputs come from numpy seeds; each test states its tolerance. The GPU test
at the end runs only where a CUDA device is present."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu.ops import interp as jinterp
from latentblending_tpu.ops import scheduler as jsched
from latentblending_tpu.ops.pallas_kernels import slerp_pallas
from latentblending_tpu_torch.models import layers as tlayers
from latentblending_tpu_torch.ops import attention as tattn
from latentblending_tpu_torch.ops import interp as tinterp
from latentblending_tpu_torch.ops import scheduler as tsched
from latentblending_tpu_torch.ops import slerp as tslerp


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# ---------------------------------------------------------------- interp / K1

@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (3, 16, 16, 4), (1, 7, 5, 3)])
def test_slerp_rows_reference_matches_pallas_interpret(shape):
    """K1 plain version vs the TPU kernel (interpret mode), f32: 1e-5."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=shape).astype(np.float32)
    b = rng.normal(size=shape).astype(np.float32)
    f = rng.uniform(0, 1, size=shape[0]).astype(np.float32)
    want = slerp_pallas(jnp.asarray(a), jnp.asarray(b), jnp.asarray(f), interpret=True)
    got = tslerp.slerp_rows_reference(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(f))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_slerp_rows_bf16_matches_pallas_interpret():
    """bf16 inputs, f32 math, bf16 output: 2e-2 (one bf16 rounding)."""
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    b = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    f = np.array([0.25, 0.75], np.float32)
    want = slerp_pallas(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16), jnp.asarray(f), interpret=True)
    got = tslerp.slerp_rows(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16(), torch.from_numpy(f))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=2e-2, atol=2e-2)


def test_slerp_rows_cpu_tensor_takes_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    rng = np.random.default_rng(2)
    a, b = (torch.from_numpy(rng.normal(size=(3, 4, 4, 4)).astype(np.float32)) for _ in range(2))
    f = torch.tensor([0.0, 0.5, 1.0])
    before = tslerp.launches
    np.testing.assert_array_equal(_np(tslerp.slerp_rows(a, b, f)), _np(tslerp.slerp_rows_reference(a, b, f)))
    assert tslerp.launches == before


@pytest.mark.parametrize("fract", [0.0, 0.3, 1.0])
def test_interpolate_spherical_matches_jax(fract):
    rng = np.random.default_rng(3)
    a = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    b = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    want = jinterp.interpolate_spherical(jnp.asarray(a), jnp.asarray(b), fract)
    got = tinterp.interpolate_spherical(torch.from_numpy(a), torch.from_numpy(b), fract)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_interpolate_spherical_batched_and_lerp_match_jax():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(4, 6, 6, 4)).astype(np.float32)
    b = rng.normal(size=(4, 6, 6, 4)).astype(np.float32)
    f = np.array([0.0, 0.1, 0.5, 0.9], np.float32)
    want = jinterp.interpolate_spherical_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(f))
    got = tinterp.interpolate_spherical_batched(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(f))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)
    # pytree lerp of a conditioning tuple, and the uint8 host lerp
    jt = jinterp.interpolate_linear_pytree((jnp.asarray(a), jnp.asarray(b)), (jnp.asarray(b), jnp.asarray(a)), 0.3)
    tt = tinterp.interpolate_linear_pytree((torch.from_numpy(a), torch.from_numpy(b)),
                                           (torch.from_numpy(b), torch.from_numpy(a)), 0.3)
    for x, y in zip(jt, tt):
        np.testing.assert_allclose(_np(y), np.asarray(x), rtol=1e-6, atol=1e-6)
    u0 = rng.integers(0, 256, size=(5, 5, 3), dtype=np.uint8)
    u1 = rng.integers(0, 256, size=(5, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tinterp.interpolate_linear(u0, u1, 0.4), jinterp.interpolate_linear(u0, u1, 0.4))


# ------------------------------------------------------------------ scheduler

@pytest.mark.parametrize("cfg", ["SDXL_BASE_SCHEDULER", "SDXL_TURBO_SCHEDULER", "SDXL_TURBO_EULER_SCHEDULER"])
@pytest.mark.parametrize("n", [1, 4, 30])
def test_schedule_tables_equal_jax(cfg, n):
    js = jsched.make_schedule(getattr(jsched, cfg), n)
    ts = tsched.make_schedule(getattr(tsched, cfg), n)
    np.testing.assert_array_equal(ts.sigmas, js.sigmas)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert ts.init_noise_sigma == js.init_noise_sigma


def test_solver_steps_match_jax():
    """scale_model_input, euler, euler_ancestral (σ_up/σ_down, including the
    terminal σ_next=0 step) and dpmpp_2m, f32: rtol 1e-6 / atol 1e-6."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    e = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    z = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    d_old = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    T = torch.from_numpy
    f32 = lambda v: (jnp.float32(v), torch.tensor(v, dtype=torch.float32))  # noqa: E731
    close = lambda t, j: np.testing.assert_allclose(_np(t), np.asarray(j), rtol=1e-6, atol=1e-6)  # noqa: E731
    for s, sn, sp in ((14.6146, 4.0817, 14.6146), (1.6129, 0.6932, 4.0817), (0.6932, 0.0, 1.6129)):
        (js, ts), (jsn, tsn), (jsp, tsp) = f32(s), f32(sn), f32(sp)
        close(tsched.scale_model_input(T(x), ts), jsched.scale_model_input(jnp.asarray(x), js))
        close(tsched.euler_step(T(x), T(e), ts, tsn), jsched.euler_step(jnp.asarray(x), jnp.asarray(e), js, jsn))
        ju, jd = jsched.ancestral_sigmas(js, jsn)
        tu, td = tsched.ancestral_sigmas(ts, tsn)
        close(tu, ju)
        close(td, jd)
        close(tsched.euler_ancestral_step(T(x), T(e), ts, tsn, T(z)),
              jsched.euler_ancestral_step(jnp.asarray(x), jnp.asarray(e), js, jsn, jnp.asarray(z)))
        for use2 in (False, True):
            close(tsched.dpmpp_2m_step(T(x), T(e), T(d_old), tsp, ts, tsn, use2),
                  jsched.dpmpp_2m_step(jnp.asarray(x), jnp.asarray(e), jnp.asarray(d_old), jsp, js, jsn, use2))
    # the terminal ancestral step adds no noise
    tu, td = tsched.ancestral_sigmas(torch.tensor(0.6932), torch.tensor(0.0))
    assert float(tu) == 0.0 and float(td) == 0.0


# ------------------------------------------------------------ attention K2/K3

@pytest.mark.parametrize("b,l,h,d", [(2, 64, 4, 64), (1, 128, 10, 64), (2, 64, 1, 512)])
def test_attention_reference_matches_jax(b, l, h, d):
    """K2 (d=64, multi-head) and K3 (d=512, one head) plain version vs
    jax.nn.dot_product_attention, f32: rtol 1e-5 / atol 1e-5."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=(b, l, h, d)).astype(np.float32) for _ in range(3))
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tattn.attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    before = (tattn.launches_self, tattn.launches_vae)
    got2 = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(_np(got2), _np(got))
    assert (tattn.launches_self, tattn.launches_vae) == before


def test_attention_reference_with_mask_matches_jax():
    """The masked (CLIP causal) plain path, f32: rtol 1e-5 / atol 1e-5."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=(2, 77, 2, 16)).astype(np.float32) for _ in range(3))
    mask = np.triu(np.full((77, 77), np.finfo(np.float32).min, np.float32), k=1)[None, None]
    want = jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias=jnp.asarray(mask))
    got = tattn.attention_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                    bias=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_dispatch_rules(monkeypatch):
    """The kernel gate keeps the JAX rules (test_pallas_kernels.py), with
    the tensor's CUDA-ness in place of the TPU backend check."""
    gate = tlayers._use_flash_attention
    monkeypatch.delenv("LB_FLASH", raising=False)
    monkeypatch.delenv("LB_FLASH_MIN", raising=False)
    assert gate(4096, 4096, None, True)
    assert gate(1024, 1024, None, True)
    assert not gate(512, 512, None, True)  # below default min
    assert not gate(4096, 77, None, True)  # cross-attention
    assert not gate(4096, 4096, object(), True)  # masked
    assert not gate(1280, 1280, None, True)  # not 512-aligned
    monkeypatch.setenv("LB_FLASH_MIN", "512")
    assert gate(512, 512, None, True)
    monkeypatch.setenv("LB_FLASH_MIN", "2048")
    assert not gate(1024, 1024, None, True)
    monkeypatch.setenv("LB_FLASH", "0")
    assert not gate(4096, 4096, None, True)
    monkeypatch.delenv("LB_FLASH")
    monkeypatch.delenv("LB_FLASH_MIN")
    assert not gate(4096, 4096, None, False)  # CPU tensors never take the kernel


# ------------------------------------------------------------------ on the GPU

@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu():
    """Each CUDA kernel against its plain version on the card, at the main
    path's shapes (bounds as in chip_smoke.py): K1 bf16 2e-2 / f32 1e-5,
    K2 2e-2 abs vs f32, K3 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, bound in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        a, b = (torch.randn((10, 64, 64, 4), generator=g, device="cuda").to(dtype) for _ in range(2))
        f = torch.rand((10,), generator=g, device="cuda")
        n = tslerp.launches
        got = tslerp.slerp_rows(a, b, f).float()
        assert tslerp.launches == n + 1
        want = tslerp.slerp_rows_reference(a, b, f).float()
        assert bool(((got - want).abs() <= bound + bound * want.abs()).all())
    q, k, v = (torch.randn((2, 1024, 10, 64), generator=g, device="cuda").bfloat16() for _ in range(3))
    got = tattn.flash_attention(q, k, v).float()
    assert (got - tattn.attention_reference(q.float(), k.float(), v.float())).abs().max().item() <= 2e-2
    q, k, v = (torch.randn((1, 4096, 1, 512), generator=g, device="cuda") for _ in range(3))
    got = tattn.flash_attention(q, k, v)
    want = tattn.attention_reference(q, k, v)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    with pytest.raises(TypeError):
        tattn.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16())  # no d=512 bf16 kernel
