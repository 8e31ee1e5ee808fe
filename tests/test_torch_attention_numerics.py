"""The arithmetic of the port's four attention kernels, emulated on the CPU
with plain tensor code, held against the plain version
(`attention_reference`) and `jax.nn.dot_product_attention`.

The CUDA kernels cannot run here, so these tests show that the rounding
each kernel does fits the bounds `chip_smoke.py` holds it to on the card:

- K2 (csrc/attention_d64_bf16.cu): bf16 q/k/v, scores in f32, the online
  softmax over 128-key tiles (exp2 with log2(e)/sqrt(d) folded in), P
  rounded to bf16 before P V, the row sum from the unrounded P, the output
  rounded to bf16. Bound: 2e-2 max abs against the f32 result.
- K3 (csrc/attention_d512_f32.cu): f32 q/k/v, both products in 3xTF32 on
  TF32 wgmma as K2 in f32 below, the online softmax over 32-key tiles, and
  the scores as the kernel's 4-CTA cluster forms them: four f32 partial
  scores over the d quarters [128r, 128r + 128), one per CTA, each in
  3xTF32, summed in rank order ((s0 + s1) + s2) + s3 in every CTA. Bound:
  1e-4 * max |f32 result|.
- K2 in f32 (csrc/attention_d64_f32.cu): both products in 3xTF32 on TF32
  wgmma (hi = x truncated to TF32, lo = x - hi truncated as the tensor
  core reads it; one f32 accumulator per product, into which go per 8-wide
  k step first every lo*hi, then every hi*lo, then every hi*hi; P V adds
  into the running O after its rescale), the online softmax over 64-key
  tiles, several heads. Bound: K3's, 1e-4 * max |f32 result|.
- K3 in bf16 (csrc/attention_d512_bf16.cu): K2's arithmetic at d=512 over
  64-key tiles (bf16 q/k/v, P rounded to bf16 before P V, the row sum
  from the unrounded P), with the scores as the kernel's 2-CTA cluster
  forms them: two f32 partial scores over the d halves [0, 256) and
  [256, 512), one per CTA, summed in f32. Bound: 1e-2 * max |f32 result|:
  relative, as K3 f32's, because at d=512 the outputs shrink as L grows
  (order 0.1 at L=4096), where K2's absolute 2e-2 would be too loose to
  fail a kernel that dropped a key tile.

Inputs come from numpy seeds; the peaked cases scale q by 4 so that the
running max is rescaled across tiles."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentblending_tpu_torch.ops import attention as tattn

LOG2E = 1.4426950408889634
K2_BK = 128
K3_BF16_BK = 64
K3_F32_BK = 32
K3_RANKS = 4
K3_FOLD = 8
K2_F32_BK = 64
K2_ABS_BOUND = 2e-2
K3_REL_BOUND = 1e-4
K3_BF16_REL_BOUND = 1e-2


def _tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to nearest TF32 (10 mantissa bits, ties away from zero)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """Truncate f32 to TF32 (what the tensor core reads of an f32 operand)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    """x ~ hi + lo with hi rounded to nearest TF32 (cvt.rna), lo read by the
    tensor core truncated: the split the kernels do not use (they truncate,
    _split_trunc), kept as the yardstick for it."""
    hi = _tf32_round(x)
    return hi, _tf32_trunc(x - hi)


def _split_trunc(x: torch.Tensor):
    hi = _tf32_trunc(x)
    return hi, _tf32_trunc(x - hi)


def _add_rz(acc: torch.Tensor, prod: torch.Tensor) -> torch.Tensor:
    """acc + prod (f64) rounded toward zero to f32: a model of the tensor
    core's add into its accumulator, which drops the low bits of the sum
    (on the H100 K3 f32's error grew with the number of adds into one
    accumulator, ~0.4 ulp an add)."""
    r = acc.double() + prod
    f = r.float()
    return torch.where(f.double().abs() > r.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _wgmma_3xtf32(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor, passes: int = 3,
                  truncate: bool = False) -> torch.Tensor:
    """acc + a @ b as K2 f32's TF32 wgmma computes it, one 8-wide k step
    (one wgmma m64nNk8) at a time into the one accumulator: every lo*hi
    step, then every hi*lo, then every hi*hi (leading dimensions batch).
    passes=1 gives the single TF32 pass (hi*hi only) the kernel does not
    use; truncate=True adds each step's products (exact: TF32 times TF32
    fits f32) by _add_rz instead of f32's round to nearest."""
    ah, al = _split_trunc(a)
    bh, bl = _split_trunc(b)
    terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
    for x, y in terms:
        for k0 in range(0, a.shape[-1], 8):
            if truncate:
                acc = _add_rz(acc, x[..., k0:k0 + 8].double() @ y[..., k0:k0 + 8, :].double())
            else:
                acc = acc + x[..., k0:k0 + 8] @ y[..., k0:k0 + 8, :]
    return acc


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in f32 with one rounding (fmaf)."""
    return (a.double() * b.double() + c.double()).float()


def _online_attention(q, k, v, bk, scores, pv, accumulate=None, fold=None):
    """Flash forward over bk-key tiles for one (batch, head): q [Lq, d], k
    and v [Lk, d] f32; scores(q, k_tile) and pv(p, v_tile) are the kernel's
    products, or accumulate(o, p, v_tile) adds P V into the rescaled O
    itself. fold: every `fold` tiles, before that tile's P V, O is added by
    f32 FMAs into its fold (rescaled by the softmax rescales since the last
    fold) and restarts from 0, as K3 f32 does."""
    Lq, d = q.shape
    scale_log2 = d ** -0.5 * LOG2E
    m = torch.full((Lq,), -torch.inf)
    l = torch.zeros(Lq)
    o = torch.zeros(Lq, d)
    o_fold, c = torch.zeros(Lq, d), torch.ones(Lq)
    for t, j0 in enumerate(range(0, k.shape[0], bk)):
        s = scores(q, k[j0:j0 + bk])
        m_new = torch.maximum(m, s.max(dim=1).values * scale_log2)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * scale_log2 - m_new[:, None])
        l = l * alpha + p.sum(dim=1)
        o = o * alpha[:, None]
        c = c * alpha
        if fold and t > 0 and t % fold == 0:
            o_fold, o, c = _fma(o_fold, c[:, None], o), torch.zeros_like(o), torch.ones_like(c)
        if accumulate is None:
            o = o + pv(p, v[j0:j0 + bk])
        else:
            o = accumulate(o, p, v[j0:j0 + bk])
        m = m_new
    return _fma(o_fold, c[:, None], o) / l[:, None]


def _per_head(fn, q, k, v):
    """Apply fn over the (batch, head) pairs of [B, L, H, d] tensors."""
    out = torch.empty_like(q)
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            out[b, :, h] = fn(q[b, :, h], k[b, :, h], v[b, :, h])
    return out


def k2_emulation(q, k, v):
    """K2's arithmetic on bf16 q/k/v [B, L, H, 64] → bf16."""
    q, k, v = q.float(), k.float(), v.float()
    fn = lambda q_, k_, v_: _online_attention(  # noqa: E731
        q_, k_, v_, K2_BK, lambda a, b: a @ b.T, lambda p, vt: p.bfloat16().float() @ vt)
    return _per_head(fn, q, k, v).bfloat16()


def k3_bf16_emulation(q, k, v):
    """K3 bf16's arithmetic on bf16 q/k/v [B, L, 1, 512] → bf16: per
    K3_BF16_BK-key tile, the scores are the sum of two f32 partials over the d
    halves (each CTA of the cluster computes one), P is rounded to bf16
    before P V and the row sum keeps the unrounded P."""
    q, k, v = q.float(), k.float(), v.float()
    half = q.shape[-1] // 2

    def scores(a, b):
        return a[:, :half] @ b[:, :half].T + a[:, half:] @ b[:, half:].T

    fn = lambda q_, k_, v_: _online_attention(  # noqa: E731
        q_, k_, v_, K3_BF16_BK, scores, lambda p, vt: p.bfloat16().float() @ vt)
    return _per_head(fn, q, k, v).bfloat16()


def k3_rank_sum(slots) -> torch.Tensor:
    """The full scores as a CTA of K3 f32's cluster forms them from its
    exchange slots, one a rank (its own partial written there, the peers'
    copied in bit for bit): ((s0 + s1) + s2) + s3."""
    s0, s1, s2, s3 = slots
    return ((s0 + s1) + s2) + s3


def k3_emulation(q, k, v, pv_passes: int = 3, fold: int | None = K3_FOLD, truncate: bool = True):
    """K3 f32's arithmetic on f32 q [B, Lq, 1, 512], k/v [B, Lk, 1, 512]:
    32-key tiles; the scores the rank-order sum of four partials over the d
    quarters, each by _wgmma_3xtf32 from a zero accumulator (lo*hi with
    A = Q lo from shared memory, then hi*lo, hi*hi); P V by _wgmma_3xtf32
    into the rescaled O (each CTA's 128 columns of O alone, which the
    columns' independence makes the same as all 512 at once), folded every
    K3_FOLD tiles; the row sum from the unsplit P; the tensor core's adds
    truncating (_add_rz). pv_passes=1 gives the single TF32 pass for P V
    the kernel does not use, fold=None an O that is never folded."""
    quarter = q.shape[-1] // K3_RANKS

    def scores(a, b):
        qs = a.reshape(a.shape[0], K3_RANKS, quarter).transpose(0, 1)
        ks = b.reshape(b.shape[0], K3_RANKS, quarter).permute(1, 2, 0)
        parts = _wgmma_3xtf32(a.new_zeros(K3_RANKS, a.shape[0], b.shape[0]), qs, ks, truncate=truncate)
        return k3_rank_sum(list(parts))

    def accumulate(o, p, vt):
        return _wgmma_3xtf32(o, p, vt, pv_passes, truncate)

    fn = lambda q_, k_, v_: _online_attention(q_, k_, v_, K3_F32_BK, scores, None, accumulate, fold)  # noqa: E731
    return _per_head(fn, q, k, v)


def k2_f32_emulation(q, k, v, score_passes: int = 3, pv_passes: int = 3):
    """K2 f32's arithmetic on f32 q/k/v [B, L, H, 64]: 64-key tiles, both
    products by _wgmma_3xtf32 (S from a zero accumulator, P V into the
    rescaled O), the row sum from the unsplit P. score_passes=1 or
    pv_passes=1 gives a single TF32 pass for that product."""
    def scores(a, b):
        return _wgmma_3xtf32(a.new_zeros(a.shape[0], b.shape[0]), a, b.T, score_passes)

    def accumulate(o, p, vt):
        return _wgmma_3xtf32(o, p, vt, pv_passes)

    fn = lambda q_, k_, v_: _online_attention(q_, k_, v_, K2_F32_BK, scores, None, accumulate)  # noqa: E731
    return _per_head(fn, q, k, v)


def _inputs(shape, seed, peak):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    return q * peak, k, v


def _jax_attention(q, k, v):
    return np.asarray(jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)), np.float32)


@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (1, 1024, 2, 64)])
@pytest.mark.parametrize("peak", [1.0, 4.0])
def test_k2_arithmetic_fits_its_bound(shape, peak):
    """K2 emulation vs the f32 plain result and JAX on the same bf16 inputs:
    max abs error <= 2e-2 (bf16 P and output rounding of values of order 1)."""
    q, k, v = _inputs(shape, 20 + shape[1], peak)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = k2_emulation(tq, tk, tv).float()
    want = tattn.attention_reference(tq.float(), tk.float(), tv.float())
    assert (got - want).abs().max().item() <= K2_ABS_BOUND
    jq, jk, jv = (x.float().numpy() for x in (tq, tk, tv))
    assert np.abs(got.numpy() - _jax_attention(jq, jk, jv)).max() <= K2_ABS_BOUND


@pytest.mark.parametrize("shape", [(1, 256, 1, 512), (1, 1024, 1, 512)])
@pytest.mark.parametrize("peak", [1.0, 4.0])
def test_k3_arithmetic_fits_its_bound(shape, peak):
    """K3 emulation (3xTF32 on TF32 wgmma for both products, four partial
    scores over the d quarters summed in rank order, 32-key tiles) vs the
    f32 plain result and JAX: max abs error <= 1e-4 * max |f32 result|."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(shape, 30 + shape[1], peak))
    got = k3_emulation(q, k, v)
    want = tattn.attention_reference(q, k, v)
    bound = K3_REL_BOUND * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound
    assert np.abs(got.numpy() - _jax_attention(q.numpy(), k.numpy(), v.numpy())).max() <= bound


@pytest.mark.parametrize("shape", [(2, 256, 2, 64), (1, 1024, 2, 64)])
@pytest.mark.parametrize("peak", [1.0, 4.0])
def test_k2_f32_arithmetic_fits_its_bound(shape, peak):
    """K2 f32 emulation (3xTF32 on TF32 wgmma for both products: truncated
    hi, one accumulator, cross terms first; 64-key tiles, several heads) vs
    the f32 plain result and JAX: max abs error <= 1e-4 * max |f32 result|,
    K3 f32's bound."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(shape, 50 + shape[1], peak))
    got = k2_f32_emulation(q, k, v)
    want = tattn.attention_reference(q, k, v)
    bound = K3_REL_BOUND * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound
    assert np.abs(got.numpy() - _jax_attention(q.numpy(), k.numpy(), v.numpy())).max() <= bound


@pytest.mark.parametrize("shape", [(1, 256, 1, 512), (1, 1024, 1, 512)])
@pytest.mark.parametrize("peak", [1.0, 4.0])
def test_k3_bf16_arithmetic_fits_its_bound(shape, peak):
    """K3 bf16 emulation (bf16 operands, two f32 partial scores over the d
    halves, P rounded to bf16, 64-key tiles) vs the f32 plain result and JAX
    on the same bf16 inputs: max abs error <= 1e-2 * max |f32 result|
    (measured 2.0e-3 to 3.3e-3)."""
    q, k, v = _inputs(shape, 60 + shape[1], peak)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = k3_bf16_emulation(tq, tk, tv).float()
    want = tattn.attention_reference(tq.float(), tk.float(), tv.float())
    bound = K3_BF16_REL_BOUND * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound
    jq, jk, jv = (x.float().numpy() for x in (tq, tk, tv))
    assert np.abs(got.numpy() - _jax_attention(jq, jk, jv)).max() <= bound


def test_k3_bf16_bound_fails_a_dropped_key_tile():
    """At the encode's L=4096 the bound tells a kernel that skipped one of
    its 64 key tiles (K3_BF16_BK keys) from a right one: the emulation stays
    inside it, the attention over the other 63 tiles (rounded to bf16)
    leaves it by more than 10x, where K2's absolute 2e-2 sits at 14% of
    max |f32 result|."""
    q, k, v = _inputs((1, 4096, 1, 512), 64, 1.0)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    want = tattn.attention_reference(tq.float(), tk.float(), tv.float())
    bound = K3_BF16_REL_BOUND * want.abs().max().item()
    keep = torch.ones(4096, dtype=torch.bool)
    keep[2048:2048 + K3_BF16_BK] = False
    dropped = tattn.attention_reference(tq.float(), tk[:, keep].float(), tv[:, keep].float()).bfloat16().float()
    assert (k3_bf16_emulation(tq, tk, tv).float() - want).abs().max().item() <= bound
    assert (dropped - want).abs().max().item() > 10 * bound


def test_k3_bf16_partial_scores_agree_in_both_ctas():
    """Each CTA of K3 bf16's cluster adds the partner's partial scores to its
    own (rank 0: s0 + s1, rank 1: s1 + s0). f32 addition is commutative, so
    both hold bit-equal scores, and with them the same P, row max and row
    sum for their two halves of O."""
    q, k, _ = _inputs((1, 256, 1, 512), 70, 4.0)
    tq, tk = (torch.from_numpy(x[0, :, 0]).bfloat16().float() for x in (q, k))
    s0 = tq[:, :256] @ tk[:64, :256].T
    s1 = tq[:, 256:] @ tk[:64, 256:].T
    assert torch.equal(s0 + s1, s1 + s0)
    full = tq @ tk[:64].T  # one 512-long sum: the split moves it at most at the f32 rounding level
    assert (s0 + s1 - full).abs().max().item() <= 1e-5 * full.abs().max().item()


def test_k3_f32_partial_scores_agree_in_all_four_ctas():
    """Each CTA of K3 f32's 4-CTA cluster writes its partial scores into its
    slot and receives the peers' into theirs, bit for bit, then sums the
    four slots in rank order (k3_rank_sum): the four CTAs hold bit-equal
    scores, and with them the same P, row max and row sum for their
    quarters of O. Adding its own partial first and the peers' after (an
    order that differs between CTAs) would not: f32 addition is not
    associative, and on these scores some bits differ."""
    q, k, _ = _inputs((1, 256, 1, 512), 71, 4.0)
    tq, tk = (torch.from_numpy(x[0, :, 0]) for x in (q, k))
    quarter = 512 // K3_RANKS
    parts = [_wgmma_3xtf32(torch.zeros(256, K3_F32_BK), tq[:, r * quarter:(r + 1) * quarter],
                           tk[:K3_F32_BK, r * quarter:(r + 1) * quarter].T) for r in range(K3_RANKS)]
    # CTA r's slots: its own partial at r, the peers' copies elsewhere
    sums = [k3_rank_sum([parts[r] if i == r else parts[i].clone() for i in range(K3_RANKS)])
            for r in range(K3_RANKS)]
    assert all(torch.equal(sums[0], s) for s in sums[1:])
    own_first = []
    for r in range(K3_RANKS):
        acc = parts[r]
        for x in (parts[i] for i in range(K3_RANKS) if i != r):
            acc = acc + x
        own_first.append(acc)
    assert not all(torch.equal(own_first[0], s) for s in own_first[1:])
    full = tq @ tk[:K3_F32_BK].T  # one 512-long f32 sum: 3xTF32 and the split move it at the f32 rounding level
    assert (sums[0] - full).abs().max().item() <= 1e-5 * full.abs().max().item()


def test_k3_single_tf32_pass_for_pv_does_not_fit():
    """Why P V is split too: with one TF32 pass for P V (scores still in
    3xTF32), the peaked case leaves the 1e-4 relative bound, while the
    kernel's 3xTF32 stays well inside it."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 512, 1, 512), 41, 4.0))
    want = tattn.attention_reference(q, k, v)
    bound = K3_REL_BOUND * want.abs().max().item()
    err1 = (k3_emulation(q, k, v, pv_passes=1) - want).abs().max().item()
    err3 = (k3_emulation(q, k, v) - want).abs().max().item()
    assert err1 > bound
    assert err3 < bound / 10


def test_k3_f32_fold_keeps_truncating_adds_in_the_bound():
    """Why K3 f32 folds O every K3_FOLD tiles: with the tensor core's adds
    truncating (_add_rz), an O accumulated over a base decode's 16384 keys
    in one accumulator (3 adds per 8 keys) leaves the 1e-4 relative bound,
    as the kernel did on the H100 before the fold (1.3e-4), while the
    folded one stays inside a tenth of it (16 query rows: the kernel's rows
    are independent)."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 16384, 1, 512), 43, 1.0))
    q = q[:, :16]
    want = tattn.attention_reference(q, k, v)
    bound = K3_REL_BOUND * want.abs().max().item()
    err_one = (k3_emulation(q, k, v, fold=None) - want).abs().max().item()
    err_folded = (k3_emulation(q, k, v) - want).abs().max().item()
    assert err_one > bound
    assert err_folded < bound / 10


@pytest.mark.parametrize("single", ["scores", "pv"])
def test_k2_f32_single_tf32_pass_does_not_fit(single):
    """Why both of K2 f32's products keep three passes: with one TF32 pass
    for the scores or for P V (the other in 3xTF32), the peaked case leaves
    the 1e-4 relative bound, while the kernel's 3xTF32 stays well inside it."""
    q, k, v = (torch.from_numpy(x) for x in _inputs((1, 512, 2, 64), 42, 4.0))
    want = tattn.attention_reference(q, k, v)
    bound = K3_REL_BOUND * want.abs().max().item()
    one = {"score_passes": 1} if single == "scores" else {"pv_passes": 1}
    err1 = (k2_f32_emulation(q, k, v, **one) - want).abs().max().item()
    err3 = (k2_f32_emulation(q, k, v) - want).abs().max().item()
    assert err1 > bound
    assert err3 < bound / 10


def test_k2_f32_split_truncates_as_the_tensor_core():
    """K2 f32's hi is x truncated to TF32 (what the tensor core reads of the
    raw f32 operand), lo = x - hi is exact and below 2^-10 |x|, and the
    tensor core's reading of lo (truncated again) keeps x to ~2^-20."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11), 1.0 - 2 ** -24, 3.14159265])
    hi, lo = _split_trunc(x)
    assert hi[0].item() == 1.0 and hi[1].item() == 1.0 and hi[3].item() == -1.0  # toward zero
    assert hi[2].item() == 1.0 + 2 ** -10 and hi[4].item() == 1.0 - 2 ** -11
    assert ((x - hi).abs() < x.abs() * 2 ** -10).all()
    assert ((hi + lo - x).abs() <= x.abs() * 2 ** -20).all()


def test_tf32_split_rounds_as_the_kernel():
    """The rounded split (_split, the yardstick of the kernels' truncated
    one): hi is round-to-nearest (ties away) at 10 mantissa bits; hi + lo
    keeps x to ~2^-21 relative, one bit more than the truncated split's
    ~2^-20 (test_k2_f32_split_truncates_as_the_tensor_core), which the
    wgmma kernels take because the tensor core truncates the raw f32
    operand for free."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12, 3.14159265])
    hi, lo = _split(x)
    assert hi[0].item() == 1.0 and hi[4].item() == 1.0
    assert hi[1].item() == 1.0 + 2 ** -10 and hi[3].item() == -(1.0 + 2 ** -10)  # ties away from zero
    assert hi[2].item() == 1.0 + 2 ** -9
    assert ((hi + lo - x).abs() <= x.abs() * 2 ** -21).all()
