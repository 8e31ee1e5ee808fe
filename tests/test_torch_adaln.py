"""M1 (latentblending_tpu_torch/ops/adaln.py, csrc/adaln_bf16.cu) on the CPU:
the plain versions against the MMDiT's unfused expressions bit for bit, the
route and the wrapper's refusals on the shape and dtype predicate, every
M1 site of a full-width SD3.5-Large block on meta tensors, the M1 counter
in a tiny SD3 transition's report (the card stood in by monkeypatching
`adaln._on_card` and `adaln._launch`), and the kernel's arithmetic
emulated against the bound chip_smoke.py holds it to on the card.

The kernel itself runs only on the card (chip_smoke.py's M1 cases)."""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from latentblending_tpu_torch.engine.blending import BlendingEngine
from latentblending_tpu_torch.models import mmdit
from latentblending_tpu_torch.models.sd3_configs import SD35_LARGE, TINY_SD3
from latentblending_tpu_torch.ops import adaln
from latentblending_tpu_torch.runtime.holder import SD3Holder

torch.set_num_threads(1)  # several test workers share the cores

MODES = ("ln_modulate", "gated_residual", "gated_residual+norm")


def _inputs(B: int, L: int, D: int, dtype, seed: int = 0) -> tuple:
    """x, y [B, L, D] and six modulation vectors [B, D], chunks of one
    [B, 6D] tensor as the adaLN linear gives them (batch stride 6D)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, L, D, generator=g).to(dtype)
    y = torch.randn(B, L, D, generator=g).to(dtype)
    vectors = (torch.randn(B, 6 * D, generator=g) * 0.5).to(dtype).chunk(6, dim=1)
    return x, y, vectors


def _unfused(mode: str, x, y, shift, scale, gate):
    """The MMDiT's expressions before M1 (models/mmdit.py's _ln, _modulate
    and the block's residuals), written out."""
    dt = x.dtype

    def norm(t):
        ln = F.layer_norm(t.float(), (t.shape[-1],), eps=1e-6)
        return (ln * (1.0 + scale.float()[:, None]) + shift.float()[:, None]).to(dt)

    if mode == "ln_modulate":
        return norm(x)
    x = (x.float() + gate.float()[:, None] * y.float()).to(dt)
    return x if mode == "gated_residual" else (x, norm(x))


def _call(fn_mode: str, fns, x, y, shift, scale, gate):
    ln_modulate, gated_residual = fns
    if fn_mode == "ln_modulate":
        return ln_modulate(x, shift, scale)
    if fn_mode == "gated_residual":
        return gated_residual(x, gate, y)
    return gated_residual(x, gate, y, shift, scale)


def _same(got, want) -> bool:
    if isinstance(want, tuple):
        return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    return torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,L,D", [(1, 45, 64), (3, 64, 64), (1, 64, 2432), (3, 45, 2432)])
def test_plain_versions_equal_the_unfused_expressions(B, L, D, mode, dtype):
    x, y, (shift, scale, gate, *_) = _inputs(B, L, D, dtype, seed=B * 100 + L)
    want = _unfused(mode, x, y, shift, scale, gate)
    assert _same(_call(mode, (adaln.ln_modulate_reference, adaln.gated_residual_reference),
                       x, y, shift, scale, gate), want)
    # a CPU tensor takes the plain version through the wrappers the MMDiT calls
    assert _same(_call(mode, (adaln.ln_modulate, adaln.gated_residual), x, y, shift, scale, gate), want)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _vecs(B: int, D: int, dtype=torch.bfloat16) -> tuple:
    return _meta(B, 6 * D, dtype=dtype).chunk(6, dim=1)[:3]


# case: (x, vectors, y) -> whether M1 takes it
ROUTE_CASES = {
    "SD3.5 image rows [12, 4096, 2432]": (lambda: (_meta(12, 4096, 2432), _vecs(12, 2432), None), True),
    "SD3.5 text rows with y [4, 333, 2432]": (lambda: (_meta(4, 333, 2432), _vecs(4, 2432), _meta(4, 333, 2432)),
                                              True),
    "tiny rows [2, 45, 64]": (lambda: (_meta(2, 45, 64), _vecs(2, 64), _meta(2, 45, 64)), True),
    "float32": (lambda: (_meta(2, 45, 64, dtype=torch.float32), _vecs(2, 64, torch.float32), None), False),
    "float32 vectors": (lambda: (_meta(2, 45, 64), _vecs(2, 64, torch.float32), None), False),
    "a non-contiguous x (channel-major tokens)": (lambda: (_meta(2, 64, 45).transpose(1, 2), _vecs(2, 64), None),
                                                  False),
    "a non-contiguous y": (lambda: (_meta(2, 45, 64), _vecs(2, 64), _meta(2, 64, 45).transpose(1, 2)), False),
    "D = 12": (lambda: (_meta(2, 45, 12), _vecs(2, 12), None), False),
    "D over MAX_D": (lambda: (_meta(1, 4, adaln.MAX_D + 8), _vecs(1, adaln.MAX_D + 8), None), False),
    "vectors strided within a row": (lambda: (_meta(2, 45, 64), (_meta(2, 128)[:, ::2],) * 2, None), False),
    "vectors of another batch": (lambda: (_meta(2, 45, 64), _vecs(3, 64), None), False),
    "y of another shape": (lambda: (_meta(2, 45, 64), _vecs(2, 64), _meta(2, 44, 64)), False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_takes_only_contiguous_bf16_rows_of_a_multiple_of_8(case, monkeypatch):
    """On the card the wrappers launch M1 on what it takes and raise on
    everything else, launching nothing: no CUDA input takes the plain
    version."""
    build, want = ROUTE_CASES[case]
    x, vectors, y = build()
    assert adaln.takes(x, vectors, y) is want
    launches = []
    monkeypatch.setattr(adaln, "_on_card", lambda t: True)
    monkeypatch.setattr(adaln, "_launch", lambda name, *args: launches.append(name))
    for name in ("ln_modulate_reference", "gated_residual_reference"):
        monkeypatch.setattr(adaln, name, lambda *a, name=name: pytest.fail(f"{name} called"))

    def call():
        if y is None:
            return adaln.ln_modulate(x, *vectors[:2])
        return adaln.gated_residual(x, vectors[0], y, *vectors[1:3])

    if want:
        call()
        assert launches == ["lb_adaln_modulate_bf16" if y is None else "lb_gated_residual_bf16"]
    else:
        with pytest.raises((TypeError, ValueError)):
            call()
        assert launches == []


def _stand_in_card(monkeypatch) -> list:
    """adaln's card stood in: every tensor counts as on the card, and a
    launch computes the plain version into the kernel's outputs; returns the
    launches' entry names."""
    launches = []

    def fake_launch(name, *args):
        launches.append(name)
        if name == "lb_adaln_modulate_bf16":
            x, shift, _, scale, _, out = args[:6]
            out.copy_(adaln.ln_modulate_reference(x, shift, scale))
            return
        x, gate, _, y, shift, _, scale, _, x_out, out = args[:10]
        if isinstance(out, torch.Tensor):
            xr, nr = adaln.gated_residual_reference(x, gate, y, shift, scale)
            out.copy_(nr)
        else:
            xr = adaln.gated_residual_reference(x, gate, y)
        x_out.copy_(xr)

    monkeypatch.setattr(adaln, "_on_card", lambda t: True)
    monkeypatch.setattr(adaln, "_launch", fake_launch)
    return launches


REFUSALS = {
    "float32": (TypeError, lambda x, y, v: adaln.ln_modulate(x.float(), v[0].float(), v[1].float())),
    "float32 vectors": (TypeError, lambda x, y, v: adaln.gated_residual(x, v[2].float(), y)),
    "a non-contiguous x": (ValueError, lambda x, y, v: adaln.ln_modulate(x.transpose(0, 1), v[0], v[1])),
    "D = 12": (ValueError, lambda x, y, v: adaln.ln_modulate(x[..., :12].contiguous(), v[0][:, :12],
                                                            v[1][:, :12])),
    "shift without scale": (ValueError, lambda x, y, v: adaln.gated_residual(x, v[2], y, v[0])),
    "y of another shape": (ValueError, lambda x, y, v: adaln.gated_residual(x, v[2], y[:, :-1].contiguous())),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case, monkeypatch):
    launches = _stand_in_card(monkeypatch)
    error, call = REFUSALS[case]
    x, y, vectors = _inputs(3, 5, 64, torch.bfloat16)
    with pytest.raises(error):
        call(x, y, vectors)
    assert launches == []


@pytest.mark.parametrize("pre_only", [False, True])
def test_every_adaln_site_of_a_full_width_block_takes_m1(pre_only, monkeypatch):
    """A full-width SD3.5-Large block (meta tensors: shapes only) at 1024²'s
    4096 image and 333 text rows: each norm and residual is one M1 launch,
    none takes the plain version; 6 a block, 4 in the context_pre_only one,
    1 in norm_out: 227 an MMDiT call."""
    launches = _stand_in_card(monkeypatch)
    for name in ("ln_modulate_reference", "gated_residual_reference"):
        monkeypatch.setattr(adaln, name, lambda *a, name=name: pytest.fail(f"{name} called"))
    monkeypatch.setattr(adaln, "_launch", lambda name, *args: launches.append(name))
    cfg = SD35_LARGE.mmdit
    D = cfg.inner_dim
    with torch.device("meta"):
        blk = mmdit.JointTransformerBlock(cfg, pre_only).to(torch.bfloat16)
        norm_out = mmdit._NormOut(D).to(torch.bfloat16)
    x, c, temb = _meta(4, 4096, D), _meta(4, 333, D), _meta(4, D)
    x2, c2 = blk(x, c, temb)
    assert x2.shape == x.shape and (c2 is None) == pre_only
    assert len(launches) == (4 if pre_only else 6)
    assert launches.count("lb_adaln_modulate_bf16") == 2
    norm_out(x2, temb)
    assert len(launches) == (5 if pre_only else 7)
    assert 6 * (cfg.num_layers - 1) + 4 + 1 == 227


def test_m1_counter_in_a_tiny_sd3_transition_report(monkeypatch):
    """With the card stood in, every adaLN norm and gated residual of a bf16
    tiny SD3 transition is an M1 launch, counted under M1 in the report:
    6 L - 1 an MMDiT call of L blocks."""
    launches = _stand_in_card(monkeypatch)
    dh = SD3Holder.from_random(TINY_SD3, dtype=torch.bfloat16, device="cpu")
    calls = []
    dh.mmdit.register_forward_hook(lambda m, args, out: calls.append(1))
    be = BlendingEngine(dh, run_benchmark=False)
    be.set_branching(depth_strength=0.5, nmb_max_branches=6)
    be.placement_policy = "predictive"
    be.set_prompt1("a red fox")
    be.set_prompt2("a lighthouse")
    be.run_transition(fixed_seeds=[1, 2])
    per_call = 6 * TINY_SD3.mmdit.num_layers - 1
    assert len(calls) == 8  # the segmented scan: one CFG-folded MMDiT call a step
    assert be.last_report.counters["M1"] == len(launches) == len(calls) * per_call


def _ulp_bf16(r: torch.Tensor) -> torch.Tensor:
    """bf16's rounding step at |r| (float64): 2^(floor(log2 |r|) - 7)."""
    _, e = torch.frexp(r)
    return torch.ldexp(torch.ones_like(r), (e - 8).clamp_min(-133))


def _kernel_emulated(mode: str, x, y, shift, scale, gate, warps: int, vpt: int):
    """The kernel's arithmetic in float32: x' by one product and one sum
    (no FMA) rounded to bf16; the row's sums per thread over its loads (a
    load 8 elements, thread t's loads t, t + 32 warps, ...), a warp's by
    butterfly, the warps' in order; mean and variance by division, then
    (x - mean) * rstd * (1 + scale) + shift, each step rounded to float32."""
    xf = x.float()
    if mode != "ln_modulate":
        xf = (xf + gate.float()[:, None] * y.float()).to(torch.bfloat16).float()
        if mode == "gated_residual":
            return xf.to(torch.bfloat16)
    B, L, D = x.shape
    threads = 32 * warps
    nvec = D // 8
    pad = torch.zeros(B, L, vpt * threads * 8)
    pad[..., :D] = xf

    def row_sum(v):  # v [B, L, vpt*threads*8] -> [B, L]
        t = v.view(B, L, vpt, threads, 8)
        part = torch.zeros(B, L, threads)
        for i in range(vpt):
            for j in range(8):
                part = part + t[:, :, i, :, j]
        lanes = part.view(B, L, warps, 32)
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[..., torch.arange(32) ^ o]
        s = torch.zeros(B, L)
        for w in range(warps):
            s = s + lanes[:, :, w, 0]
        return s

    mean = row_sum(pad) / D
    live = (torch.arange(vpt * threads * 8) < nvec * 8).float()
    dev = (pad - mean[..., None]) * live
    rstd = torch.rsqrt(row_sum(dev * dev) / D + 1e-6)
    n = (xf - mean[..., None]) * rstd[..., None]
    out = (n * (1.0 + scale.float()[:, None]) + shift.float()[:, None]).to(torch.bfloat16)
    return out if mode == "ln_modulate" else (xf.to(torch.bfloat16), out)


# chip_smoke.py's M1 bound: against the float64 expression (of the rounded
# x' for the fused form), at least M1_ULP_SHARE of the outputs within one
# bf16 rounding step and max |M1 - f64| <= M1_REL_BOUND * max |f64|
M1_ULP_SHARE = 0.999
M1_REL_BOUND = 2.0 ** -7


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("B,L,D,warps,vpt", [(2, 33, 2432, 5, 2), (1, 17, 64, 1, 1), (1, 9, 8192, 8, 4)])
def test_kernel_arithmetic_within_a_rounding_step(B, L, D, warps, vpt, mode):
    x, y, (shift, scale, gate, *_) = _inputs(B, L, D, torch.bfloat16, seed=D)
    x = x * 3 + 0.5  # rows off zero mean, as the residual stream's are
    got = _kernel_emulated(mode, x, y, shift, scale, gate, warps, vpt)
    plain = _call(mode, (adaln.ln_modulate_reference, adaln.gated_residual_reference), x, y, shift, scale, gate)
    if mode == "gated_residual":
        assert torch.equal(got, plain)  # the same float32 operations: x' bit for bit
        return
    if mode != "ln_modulate":
        assert torch.equal(got[0], plain[0])
        x, got, plain = got[0], got[1], plain[1]
    xd = x.double()
    ln = (xd - xd.mean(-1, keepdim=True)) / torch.sqrt(xd.var(-1, unbiased=False, keepdim=True) + 1e-6)
    want = ln * (1 + scale.double()[:, None]) + shift.double()[:, None]
    for out in (got, plain):
        err = (out.double() - want).abs()
        assert (err <= _ulp_bf16(want)).double().mean().item() >= M1_ULP_SHARE
        assert err.max().item() <= M1_REL_BOUND * want.abs().max().item()
    # a wrong statistic (the variance without its mean) fails the bound
    bad = ln * torch.sqrt(xd.var(-1, unbiased=False, keepdim=True) + 1e-6) / torch.sqrt(
        xd.pow(2).mean(-1, keepdim=True) + 1e-6)
    bad = (bad * (1 + scale.double()[:, None]) + shift.double()[:, None]).to(torch.bfloat16)
    assert (bad.double() - want).abs().max().item() > M1_REL_BOUND * want.abs().max().item()
