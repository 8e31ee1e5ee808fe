"""K1 in the port (latentblending_tpu_torch/ops/slerp.py, csrc/slerp.cu):
the fused tree step's plain version against the JAX scan body's mix, a CPU
emulation of the kernel's split reduction, and (on a card) both kernel
entry points against their plain versions.

Inputs come from numpy seeds; each test states its tolerance. JAX is
imported inside the tests that compare with it. The `gpu` test's cases are
also in chip_smoke.py's K1 phase, which runs them on the card.
"""
import numpy as np
import pytest
import torch

from latentblending_tpu_torch import profiling
from latentblending_tpu_torch.ops import slerp as tslerp

F32, BF16 = torch.float32, torch.bfloat16


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _tree_inputs(rng, rows, shape, window: bool):
    """A fused-scan-like step: row 0 an edge (self parents, parental
    fraction 0), row 1 its recycled twin (window parent, fraction 0, mix 1),
    a self-parent stem, pins at mix 1, fraction 0/1 parental mixes."""
    lat = rng.normal(size=(rows,) + shape).astype(np.float32)
    p1 = rng.integers(0, rows, size=rows)
    p2 = rng.integers(0, rows, size=rows)
    p1[0] = p2[0] = 0
    p1[1] = p2[1] = 1
    p1[4] = p2[4] = 4
    pf = rng.uniform(0, 1, size=rows).astype(np.float32)
    pf[0:2] = 0.0
    pf[3] = 1.0
    mc = rng.uniform(0, 1, size=rows).astype(np.float32)
    mc[0] = 0.0
    mc[1:4] = 1.0
    win = rng.normal(size=shape).astype(np.float32) if window else None
    mask = np.zeros(rows, bool)
    if window:
        mask[1] = True
        mask[5] = True
    return lat, p1.astype(np.int64), p2.astype(np.int64), pf, mc, win, mask


# ------------------------------------------------- (a) plain tree step vs JAX

@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_step_reference_matches_jax_scan_mix(dtype, window):
    """slerp_tree_step_reference vs the JAX scan body (runtime/denoise.py
    denoise_scan_tree: jnp.take, jnp.where on the window, the parental
    interpolate_spherical_batched, then the crossfeed slerp_pallas in
    interpret mode). f32: rtol 1e-5 / atol 1e-6 (sums in another order,
    the Pallas acos polynomial); bf16: 2e-2 relative and absolute (one bf16
    rounding of the parental mix and of the result)."""
    import jax.numpy as jnp

    from latentblending_tpu.ops.interp import interpolate_spherical_batched
    from latentblending_tpu.ops.pallas_kernels import slerp_pallas

    rng = np.random.default_rng(10)
    lat, p1, p2, pf, mc, win, mask = _tree_inputs(rng, 6, (8, 8, 4), window)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jl = jnp.asarray(lat, jdt)
    p1_state = jnp.take(jl, jnp.asarray(p1, jnp.int32), axis=0)
    if window:
        p1_state = jnp.where(jnp.asarray(mask)[:, None, None, None],
                             jnp.broadcast_to(jnp.asarray(win)[None], jl.shape).astype(jdt), p1_state)
    m = interpolate_spherical_batched(p1_state, jnp.take(jl, jnp.asarray(p2, jnp.int32), axis=0), jnp.asarray(pf))
    want = np.asarray(slerp_pallas(jl, m, jnp.asarray(mc), interpret=True), np.float32)

    tdt = getattr(torch, dtype)
    got = tslerp.slerp_tree_step_reference(
        torch.from_numpy(lat).to(tdt), torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(pf),
        torch.from_numpy(mc), None if win is None else torch.from_numpy(win).to(tdt),
        torch.from_numpy(mask) if window else None)
    assert got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), want, **tol)


@pytest.mark.parametrize("window", [False, True])
def test_tree_step_cpu_tensor_takes_plain_version(window):
    """A CPU tensor runs the plain version bit for bit and launches
    nothing; window without win_mask is refused."""
    rng = np.random.default_rng(11)
    lat, p1, p2, pf, mc, win, mask = (torch.from_numpy(x) if x is not None else None
                                      for x in _tree_inputs(rng, 6, (4, 4, 4), window))
    before = (profiling.counter("K1_rows"), profiling.counter("K1_tree"))
    got = tslerp.slerp_tree_step(lat, p1, p2, pf, mc, win, mask if window else None)
    want = tslerp.slerp_tree_step_reference(lat, p1, p2, pf, mc, win, mask if window else None)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert (profiling.counter("K1_rows"), profiling.counter("K1_tree")) == before
    # exact fractions: mix 0 keeps the row, parental 0 then mix 1 gives parent 1's state
    assert torch.equal(got[0], lat[0])
    assert torch.equal(got[1], win if window else lat[1])
    with pytest.raises(ValueError):
        tslerp.slerp_tree_step(lat, p1, p2, pf, mc, lat[0], None)


# ----------------------------------- (b) the kernel's split reduction on CPU

def _unit_elems(n: int, dtype) -> int:
    """Elements per load unit in csrc/slerp.cu: 16 bytes when a row is a
    multiple of 16 bytes (pointers are aligned here), else one element."""
    size = 2 if dtype == BF16 else 4
    return 16 // size if (n * size) % 16 == 0 else 1


def _kernel_row_sums(x: np.ndarray, y: np.ndarray, cluster: int, elems: int) -> np.ndarray:
    """(sum x², sum y², sum xy) as csrc/slerp.cu reduces them, in float32:
    rank k of the cluster owns units [k*per, (k+1)*per); thread t of a CTA
    accumulates units t, t+T, ... in order; warps reduce by xor shuffles,
    warps are summed in order, and the C triples in rank order 0..C-1.
    (The kernel fuses each multiply-add; numpy rounds twice.)"""
    n_units = x.size // elems
    per = -(-n_units // cluster)
    threads = min(256, max(32, -(-per // 32) * 32))
    total = np.zeros(3, np.float32)
    for k in range(cluster):
        lo, hi = min(n_units, k * per), min(n_units, (k + 1) * per)
        rounds = max(1, -(-(hi - lo) // threads))
        pad = rounds * threads * elems - (hi - lo) * elems
        xs = np.pad(x[lo * elems:hi * elems], (0, pad)).reshape(rounds, threads, elems)
        ys = np.pad(y[lo * elems:hi * elems], (0, pad)).reshape(rounds, threads, elems)
        acc = np.zeros((3, threads), np.float32)
        for r in range(rounds):
            for j in range(elems):
                a, b = xs[r, :, j], ys[r, :, j]
                acc = acc + np.stack([a * a, b * b, a * b])
        w = acc.reshape(3, threads // 32, 32)
        for off in (16, 8, 4, 2, 1):
            w = w + w[..., np.arange(32) ^ off]
        cta = w[:, 0, 0]
        for wi in range(1, threads // 32):
            cta = cta + w[:, wi, 0]
        total = cta if k == 0 else total + cta
    return total


def _kernel_slerp(x: np.ndarray, y: np.ndarray, f: float, cluster: int, dtype) -> torch.Tensor:
    """One row as the kernel computes it: split sums, f32 weights, cast."""
    s = _kernel_row_sums(x, y, cluster, _unit_elems(x.size, dtype))
    dot = s[2] / np.maximum(np.sqrt(s[0] * s[1]), np.float32(1e-20))
    dot = np.clip(dot, np.float32(-1.0 + 1e-7), np.float32(1.0 - 1e-7))
    theta0 = np.arccos(dot)
    sin0 = np.sin(theta0)
    theta_t = theta0 * np.float32(f)
    s0, s1 = np.sin(theta0 - theta_t) / sin0, np.sin(theta_t) / sin0
    return torch.from_numpy((x * s0 + y * s1).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("n", [16384, 1000, 105])
@pytest.mark.parametrize("cluster", [1, 8, 16])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
def test_split_reduction_emulation(dtype, cluster, n):
    """slerp_rows as the kernel splits it (16 384 = a 512² latent row,
    1000 = a short vector row, 105 = a ragged row on the scalar path)
    against slerp_rows_reference: f32 within rtol 1e-5 / atol 1e-6 (sums
    in another order); bf16 within one bf16 rounding (2e-2 relative and
    absolute); fractions 0 and 1, and a row slerped with itself at both,
    return a and b bit for bit."""
    rng = np.random.default_rng(n + cluster)
    a = torch.from_numpy(rng.normal(size=(5, n)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.normal(size=(5, n)).astype(np.float32)).to(dtype)
    b[3] = a[3]
    b[4] = a[4]
    f = np.array([0.0, 1.0, 0.37, 0.0, 1.0], np.float32)
    got = torch.stack([_kernel_slerp(_np(a[r]), _np(b[r]), f[r], cluster, dtype) for r in range(5)])
    want = tslerp.slerp_rows_reference(a, b, torch.from_numpy(f))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == F32 else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert torch.equal(got[0], a[0]) and torch.equal(got[1], b[1])
    assert torch.equal(got[3], a[3]) and torch.equal(got[4], a[4])


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
def test_split_reduction_emulation_tree_step(dtype):
    """The tree step as the kernel computes it (two split reductions at
    C = 8, the parental mix rounded to the storage type in between)
    against slerp_tree_step_reference with a window row: f32 rtol 1e-5 /
    atol 1e-6; bf16 2e-2 relative and absolute; the exact rows bit for bit."""
    rng = np.random.default_rng(12)
    lat, p1, p2, pf, mc, win, mask = _tree_inputs(rng, 8, (16, 16, 4), True)
    tl = torch.from_numpy(lat).to(dtype)
    tw = torch.from_numpy(win).to(dtype)
    rows = []
    for r in range(8):
        p1_state = tw if mask[r] else tl[p1[r]]
        m = _kernel_slerp(_np(p1_state).ravel(), _np(tl[p2[r]]).ravel(), pf[r], 8, dtype)
        rows.append(_kernel_slerp(_np(tl[r]).ravel(), _np(m), mc[r], 8, dtype).reshape(tl.shape[1:]))
    got = torch.stack(rows)
    want = tslerp.slerp_tree_step_reference(tl, torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(pf),
                                            torch.from_numpy(mc), tw, torch.from_numpy(mask))
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == F32 else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert torch.equal(got[0], tl[0]) and torch.equal(got[1], tw) and torch.equal(got[3], tl[p2[3]])


# ------------------------------------------------------------- (c) on a card

# bounds of chip_smoke.py's K1_BOUND: |got - want| <= bound + bound |want|
_GPU_BOUND = {F32: 1e-5, BF16: 2e-2}


def _close(got, want, dtype) -> bool:
    bound = _GPU_BOUND[dtype]
    return bool(((got.float() - want.float()).abs() <= bound + bound * want.float().abs()).all())


@pytest.mark.gpu
def test_slerp_kernels_match_plain_versions_on_gpu():
    """Both kernel entries against their plain versions on the card, within
    chip_smoke.py's K1 bounds (bf16 2e-2, f32 1e-5): slerp_rows at the main
    path's shapes ([2|10|12|40,64,64,4], 1024² rows [2,128,128,4]; in f32
    those take two register chunks per CTA), a ragged row and a misaligned
    one (the scalar path), fractions 0 and 1 bit for bit; slerp_tree_step
    at [12,64,64,4] with and without a window row, pins and a self-parent
    row, at 1024² rows in f32 and on ragged rows, its exact rows bit for
    bit; every
    launch repeated gives the same bits; the wrappers refuse what the
    kernel does not take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    cases = [((2, 64, 64, 4), BF16), ((10, 64, 64, 4), BF16), ((10, 64, 64, 4), F32), ((40, 64, 64, 4), BF16),
             ((12, 64, 64, 4), BF16), ((2, 128, 128, 4), BF16), ((3, 5, 7, 3), BF16), ((3, 5, 7, 3), F32),
             ((4, 16, 16, 4), F32), ((2, 128, 128, 4), F32)]  # the last: two register chunks per CTA
    for shape, dtype in cases:
        a, b = (torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(2))
        f = torch.rand((shape[0],), generator=g, device="cuda")
        f[0], f[1] = 0.0, 1.0
        n = profiling.counter("K1_rows")
        got = tslerp.slerp_rows(a, b, f)
        assert profiling.counter("K1_rows") == n + 1
        assert _close(got, tslerp.slerp_rows_reference(a, b, f), dtype), (shape, dtype)
        assert torch.equal(got[0], a[0]) and torch.equal(got[1], b[1]), (shape, dtype)
        assert torch.equal(got, tslerp.slerp_rows(a, b, f)), (shape, dtype)
    # a row start that is not 16-byte aligned takes the scalar path
    base = torch.randn((2 * 1024 + 1,), generator=g, device="cuda")
    a, b = base[1:].view(2, 1024), base[:-1].view(2, 1024)
    f = torch.tensor([0.3, 1.0], device="cuda")
    got = tslerp.slerp_rows(a, b, f)
    assert _close(got, tslerp.slerp_rows_reference(a, b, f), F32) and torch.equal(got[1], b[1])

    rng = np.random.default_rng(13)
    for dtype in (BF16, F32):
        for window in (False, True):
            lat, p1, p2, pf, mc, win, mask = _tree_inputs(rng, 12, (64, 64, 4), window)
            cu = {"latents": torch.from_numpy(lat).to(dtype).cuda(), "p1": torch.from_numpy(p1).cuda(),
                  "p2": torch.from_numpy(p2).cuda(), "parent_fract": torch.from_numpy(pf).cuda(),
                  "mix_coeff": torch.from_numpy(mc).cuda(),
                  "window": torch.from_numpy(win).to(dtype).cuda() if window else None,
                  "win_mask": torch.from_numpy(mask).cuda() if window else None}
            n = profiling.counter("K1_tree")
            got = tslerp.slerp_tree_step(**cu)
            assert profiling.counter("K1_tree") == n + 1
            assert _close(got, tslerp.slerp_tree_step_reference(**cu), dtype), (dtype, window)
            lat_c = cu["latents"]
            assert torch.equal(got[0], lat_c[0])  # mix 0
            assert torch.equal(got[1], cu["window"] if window else lat_c[1])  # parental 0, mix 1
            assert torch.equal(got[3], lat_c[int(p2[3])])  # parental 1, mix 1
            assert torch.equal(got, tslerp.slerp_tree_step(**cu))
    # the tree step on rows of two register chunks per CTA, then ragged rows
    for shape in ((128, 128, 4), (5, 7, 3)):
        lat, p1, p2, pf, mc, win, mask = _tree_inputs(rng, 6, shape, True)
        cu = [torch.from_numpy(lat).cuda(), torch.from_numpy(p1).cuda(), torch.from_numpy(p2).cuda(),
              torch.from_numpy(pf).cuda(), torch.from_numpy(mc).cuda(), torch.from_numpy(win).cuda(),
              torch.from_numpy(mask).cuda()]
        got = tslerp.slerp_tree_step(*cu)
        assert _close(got, tslerp.slerp_tree_step_reference(*cu), F32), shape
        assert torch.equal(got[0], cu[0][0]) and torch.equal(got[1], cu[5]), shape

    lat, idx, fr = cu[0], cu[1], cu[3]
    with pytest.raises(TypeError):
        tslerp.slerp_rows(lat.half(), lat.half(), fr)
    with pytest.raises(ValueError):
        tslerp.slerp_rows(lat, lat[:, :1], fr)
    with pytest.raises(ValueError):
        tslerp.slerp_tree_step(lat, idx + 6, idx, fr, fr)  # parent row out of range
    with pytest.raises(ValueError):
        tslerp.slerp_tree_step(lat, idx.int(), idx, fr, fr)
    with pytest.raises(ValueError):
        tslerp.slerp_tree_step(lat, idx, idx, fr, fr, cu[5][:1], cu[6])  # window of another shape
    with pytest.raises(ValueError):
        tslerp.slerp_tree_step(lat, idx, idx, fr, fr, cu[5], cu[6].float())
    with pytest.raises(ValueError):
        tslerp.slerp_tree_step(lat, idx.cpu(), idx, fr, fr)
