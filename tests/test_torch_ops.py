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
from latentblending_tpu_torch import profiling
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
    before = profiling.counter("K1_rows")
    np.testing.assert_array_equal(_np(tslerp.slerp_rows(a, b, f)), _np(tslerp.slerp_rows_reference(a, b, f)))
    assert profiling.counter("K1_rows") == before


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
    before = (profiling.counter("K2"), profiling.counter("K3"))
    got2 = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_array_equal(_np(got2), _np(got))
    assert (profiling.counter("K2"), profiling.counter("K3")) == before


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

def test_kernel_library_builds_once_under_concurrent_first_calls(monkeypatch):
    """_build.library() under 8 concurrent first calls (a threaded server's
    first requests) builds and loads the library once; build and the
    loader are stubbed, so no nvcc runs."""
    import threading
    import time

    from latentblending_tpu_torch.ops import _build

    builds, loads = [], []
    start = threading.Barrier(8)

    def fake_build(verbose=False):
        builds.append(threading.get_ident())
        time.sleep(0.05)  # a build takes a while: the others arrive meanwhile
        return "liblbkernels.so"

    class FakeLib:
        def __getattr__(self, name):
            return type("Entry", (), {})()

    def fake_cdll(path):
        loads.append(path)
        return FakeLib()

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_LIBRARY", None)
    got = []

    def first_call():
        start.wait()
        got.append(_build.library())

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and loads == ["liblbkernels.so"]
    assert len(got) == 8 and all(lib is got[0] for lib in got)


def test_kernel_signatures_match_the_c_entries():
    """Every ctypes signature in ops/_build.py has a C entry of that name in
    csrc/*.cu whose parameters it passes one for one: pointers (and the
    trailing stream) as c_void_p, int as c_int, int64_t as c_int64, float
    as c_float; every C entry has a signature."""
    import ctypes
    import re

    from latentblending_tpu_torch.ops import _build

    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_int64: "int64_t", ctypes.c_float: "float"}
    entries = {}
    for src in _build.CSRC_DIR.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            types = [" ".join(p.split()[:-1]) for p in params.split(",")]
            entries[name] = ["pointer" if "*" in t else t.replace("const ", "") for t in types]
    assert set(entries) == set(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        assert [kinds[t] for t in argtypes] == entries[name], name


@pytest.mark.gpu
def test_kernels_match_plain_versions_on_gpu():
    """Each CUDA kernel against its plain version on the card, at the main
    path's shapes (per-level and fused), SDXL-base 1024²'s, and one peaked
    case each (q scaled by 4), with the bounds of chip_smoke.py: K1 bf16
    2e-2 / f32 1e-5 (and exact at fractions 0 and 1), K2 2e-2 abs vs f32,
    K3 1e-4 relative; K2 in f32 as K3; K3 in bf16 1e-2 relative; a head
    dim and dtype with no kernel raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype, bound in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
        a, b = (torch.randn((10, 64, 64, 4), generator=g, device="cuda").to(dtype) for _ in range(2))
        f = torch.rand((10,), generator=g, device="cuda")
        n = profiling.counter("K1_rows")
        got = tslerp.slerp_rows(a, b, f).float()
        assert profiling.counter("K1_rows") == n + 1
        want = tslerp.slerp_rows_reference(a, b, f).float()
        assert bool(((got - want).abs() <= bound + bound * want.abs()).all())
    # the fused scan's rows: fraction exactly 0 (row 0 slerped with itself)
    # returns a, exactly 1 (the pin) returns b, bit for bit
    a, b = (torch.randn((12, 64, 64, 4), generator=g, device="cuda").bfloat16() for _ in range(2))
    b[0] = a[0]
    f = torch.rand((12,), generator=g, device="cuda")
    f[0:2], f[2:4] = 0.0, 1.0
    got = tslerp.slerp_rows(a, b, f)
    assert torch.equal(got[0:2], a[0:2]) and torch.equal(got[2:4], b[2:4])
    k2_cases = [((10, 1024, 10, 64), 1.0), ((2, 1024, 10, 64), 1.0), ((12, 1024, 10, 64), 1.0),
                ((2, 4096, 10, 64), 1.0), ((2, 1024, 20, 64), 1.0), ((10, 1024, 10, 64), 4.0)]
    for shape, peak in k2_cases:
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        q, k, v = (q * peak).bfloat16(), k.bfloat16(), v.bfloat16()
        n = profiling.counter("K2")
        got = tattn.flash_attention(q, k, v).float()
        assert profiling.counter("K2") == n + 1
        assert (got - tattn.attention_reference(q.float(), k.float(), v.float())).abs().max().item() <= 2e-2, shape
    k3_cases = [((4, 4096, 1, 512), 1.0), ((2, 4096, 1, 512), 1.0), ((1, 16384, 1, 512), 1.0),
                ((2, 4096, 1, 512), 4.0)]
    for shape, peak in k3_cases:
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        q = q * peak
        n = profiling.counter("K3")
        got = tattn.flash_attention(q, k, v)
        assert profiling.counter("K3") == n + 1
        want = tattn.attention_reference(q, k, v)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), shape
    # K2 in f32 (a float32 UNet) and K3 in bf16 (a bf16 VAE, decode and encode)
    for shape, peak in [((12, 1024, 10, 64), 1.0), ((2, 1024, 10, 64), 1.0), ((10, 1024, 10, 64), 4.0)]:
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        q = q * peak
        n = profiling.counter("K2_f32")
        got = tattn.flash_attention(q, k, v)
        assert profiling.counter("K2_f32") == n + 1
        want = tattn.attention_reference(q, k, v)
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item(), shape
    for shape, peak in [((4, 4096, 1, 512), 1.0), ((8, 4096, 1, 512), 1.0), ((1, 4096, 1, 512), 1.0),
                        ((1, 16384, 1, 512), 1.0), ((2, 4096, 1, 512), 4.0)]:
        q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
        q, k, v = (q * peak).bfloat16(), k.bfloat16(), v.bfloat16()
        n = profiling.counter("K3_bf16")
        got = tattn.flash_attention(q, k, v).float()
        assert profiling.counter("K3_bf16") == n + 1
        want = tattn.attention_reference(q.float(), k.float(), v.float())
        assert (got - want).abs().max().item() <= 1e-2 * want.abs().max().item(), shape
    with pytest.raises(TypeError):
        tattn.flash_attention(q.half(), k.half(), v.half())  # no d=512 fp16 kernel
    with pytest.raises(ValueError):
        tattn.flash_attention(*(torch.randn((1, 4096, 2, 512), device="cuda") for _ in range(3)))  # one head only
    with pytest.raises(ValueError):
        tattn.flash_attention(*(torch.randn((1, 1088, 1, 64), device="cuda").bfloat16() for _ in range(3)))
