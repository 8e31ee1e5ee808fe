#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (latentblending_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one NVIDIA Hopper GPU
(the kernels are built for sm_90a). In order, it:

1. prints the card (nvidia-smi name and power limit) and the TF32 switches;
2. builds the hand-written CUDA kernels from latentblending_tpu_torch/csrc
   and prints the build time;
3. runs each kernel at the shapes of the SDXL-Turbo 512² main path — both
   the per-level and the fused transition (K1 [12,64,64,4] with exact 0/1
   fractions and a row slerped with itself, K2 [12,1024,10,64]) — and, for
   K2/K3, of SDXL-base 1024², plus a peaked case with q scaled by 4,
   against its plain PyTorch version on the same inputs, printing the max
   abs/rel error and both times (CUDA events, median of 20 runs after
   warm-up); prints the tensor-core instruction counts of the built SASS;
4. checks the slice on a small input: the tiny-turbo transition on the GPU
   agrees with the same transition on the CPU, on the default (fused) path
   and with LB_FUSED=0 (per-level), and on the GPU the fused transition
   agrees with the per-level one (deterministic Euler);
5. drives the main path at full width: SDXLHolder.from_random("sdxl-turbo")
   (random weights from a seed), BlendingEngine, set_prompt1/2,
   set_negative_prompt, then
   - run_transition(fixed_seeds=[420, 421]) on the default path, which must
     be the fused one: 12 uint8 512×512 keyframes, 11 finite similarities,
     each kernel launched during that call; first and warm wall, peak memory;
   - the same with LB_FUSED=0 (the per-level path);
   - run_transition_streaming(keyframe_format="i420"): each resolved handle
     within 1 of the host I420 conversion of the fused RGB keyframe;
   - measure_sync_overhead(), then predict_transition_time() beside the
     measured warm walls of both paths;
6. prints one JSON line with every kernel's numbers, then the final line
   {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the final line.
It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEEDS = [420, 421]

# error bounds of each kernel against its plain version (stated, not tuned):
# K1 bf16: |got - want| <= 2e-2 + 2e-2 |want| (bf16 output rounding);
# K1 f32: the same with 1e-5 (f32 sums in another order);
# K2: max abs error <= 2e-2 against the plain result in f32 from the same
#     bf16 inputs (bf16 output rounding of values of order 1);
# K3: max abs error <= 1e-4 * max |plain result| (f32 both sides).
K1_BOUND = {"bfloat16": 2e-2, "float32": 1e-5}
K2_ABS_BOUND = 2e-2
K3_REL_BOUND = 1e-4


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _print_sass_counts(lib) -> None:
    """Tensor-core instructions per kernel in the built library's SASS
    (cuobjdump from the CUDA toolkit; informational)."""
    from latentblending_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(_build.find_nvcc())), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        print("sass: cuobjdump not found", flush=True)
        return
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=120).stdout
    for section in sass.split("Function : ")[1:]:
        lines = section.splitlines()
        # instruction lines read "/*addr*/  OPCODE ...;", encoding lines "/* 0x... */"
        ops = [ln.split("*/", 1)[1].strip() for ln in lines[1:] if ln.strip().startswith("/*") and ";" in ln]
        print(f"sass {lines[0].strip()}: {len(ops)} instructions, HGMMA {sum('HGMMA' in o for o in ops)}, "
              f"HMMA {sum('HMMA' in o for o in ops)}", flush=True)


def _median_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _slerp_case(torch, g, shape, dtype, pins: bool = False) -> dict:
    """slerp_rows vs slerp_rows_reference within K1_BOUND. pins=True is the
    fused scan's case: rows 0-1 at fraction exactly 0 (row 0 slerped with
    itself, as edge 1's parental mix), rows 2-3 at exactly 1 (the pin);
    the kernel must return a there, resp. b, bit for bit."""
    from latentblending_tpu_torch.ops import slerp

    a = torch.randn(shape, generator=g, device="cuda").to(dtype)
    b = torch.randn(shape, generator=g, device="cuda").to(dtype)
    f = torch.rand((shape[0],), generator=g, device="cuda")
    if pins:
        b[0] = a[0]
        f[0:2] = 0.0
        f[2:4] = 1.0
    got = slerp.slerp_rows(a, b, f)
    want = slerp.slerp_rows_reference(a, b, f).float()
    torch.cuda.synchronize()
    err = (got.float() - want).abs()
    bound = K1_BOUND[str(dtype).split(".")[1]]
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound + bound * want.abs()).all())
    if pins:
        ok = ok and bool(torch.equal(got[0:2], a[0:2]) and torch.equal(got[2:4], b[2:4]))
    case = {
        "shape": list(shape), "dtype": str(dtype).split(".")[1], "pins": pins,
        "max_abs_err": err.max().item(),
        "max_rel_err": (err / want.abs().clamp_min(1e-6)).max().item(),
        "ms": _median_ms(torch, lambda: slerp.slerp_rows(a, b, f)),
        "plain_ms": _median_ms(torch, lambda: slerp.slerp_rows_reference(a, b, f)),
        "bound": bound, "ok": ok,
    }
    print("K1 slerp_rows", json.dumps(case), flush=True)
    if not ok:
        raise AssertionError(f"K1 outside its bound: {case}")
    return case


def _attention_case(torch, g, shape, dtype, peak: float) -> dict:
    """flash_attention vs attention_reference on the same inputs: K2 (bf16)
    against the plain result in f32 within K2_ABS_BOUND, K3 (f32) within
    K3_REL_BOUND * max |plain|."""
    from latentblending_tpu_torch.ops import attention

    q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    q, k, v = (q * peak).to(dtype), k.to(dtype), v.to(dtype)
    got = attention.flash_attention(q, k, v).float()
    want = attention.attention_reference(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    case = {
        "shape": list(shape), "dtype": str(dtype).split(".")[1], "q_scale": peak,
        "max_abs_err": err, "max_rel_err": err / want.abs().max().item(),
        "finite": bool(torch.isfinite(got).all()),
        "ms": _median_ms(torch, lambda: attention.flash_attention(q, k, v)),
        "plain_ms": _median_ms(torch, lambda: attention.attention_reference(q, k, v)),
    }
    del got, want
    if dtype == torch.bfloat16:
        case["bound"] = K2_ABS_BOUND
        case["ok"] = case["finite"] and case["max_abs_err"] <= K2_ABS_BOUND
    else:
        case["bound"] = K3_REL_BOUND
        case["ok"] = case["finite"] and case["max_rel_err"] <= K3_REL_BOUND
    name = "K2 attention d64" if dtype == torch.bfloat16 else "K3 attention d512"
    print(name, json.dumps(case), flush=True)
    if not case["ok"]:
        raise AssertionError(f"{name} outside its bound: {case}")
    return case


def kernel_phases(torch) -> dict:
    """Each kernel vs its plain version at the main path's shapes. The first
    case of each kernel is the one the kernels line reports."""
    g = torch.Generator(device="cuda").manual_seed(0)
    # K1: per-level crossfeed [10,...] (bf16 and f32), per-level parental
    # mix [40,...], fused scan [12,...] (parental mix + crossfeed, with pins)
    res = {"K1": [_slerp_case(torch, g, (10, 64, 64, 4), torch.bfloat16),
                  _slerp_case(torch, g, (10, 64, 64, 4), torch.float32),
                  _slerp_case(torch, g, (40, 64, 64, 4), torch.bfloat16),
                  _slerp_case(torch, g, (12, 64, 64, 4), torch.bfloat16, pins=True)]}
    # K2 / K3 at every shape of the path (SDXL-Turbo 512²: UNet batches 2,
    # 10 and, fused, 12; VAE decode chunks 2-4) and of SDXL-base 1024²,
    # plus one peaked case each (q scaled by 4: the running max is rescaled
    # across key tiles)
    k2_cases = [((10, 1024, 10, 64), 1.0), ((2, 1024, 10, 64), 1.0), ((12, 1024, 10, 64), 1.0),
                ((2, 4096, 10, 64), 1.0), ((2, 1024, 20, 64), 1.0), ((10, 1024, 10, 64), 4.0)]
    k3_cases = [((4, 4096, 1, 512), 1.0), ((2, 4096, 1, 512), 1.0), ((1, 16384, 1, 512), 1.0),
                ((2, 4096, 1, 512), 4.0)]
    res["K2"] = [_attention_case(torch, g, shape, torch.bfloat16, peak) for shape, peak in k2_cases]
    res["K3"] = [_attention_case(torch, g, shape, torch.float32, peak) for shape, peak in k3_cases]
    return res


@contextlib.contextmanager
def _lb_fused(value):
    """Run with LB_FUSED set to `value` (None: unset, the default path)."""
    old = os.environ.pop("LB_FUSED", None)
    if value is not None:
        os.environ["LB_FUSED"] = value
    try:
        yield
    finally:
        os.environ.pop("LB_FUSED", None)
        if old is not None:
            os.environ["LB_FUSED"] = old


def _run_engine(torch, spec: str, device: str, dtype, weights_from=None):
    """Engine with prompts set; random weights from seed 0, or the weights
    and seeded noise of the holder `weights_from` (on another device)."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    if weights_from is None:
        dh = SDXLHolder.from_random(spec, seed=0, dtype=dtype, device=device)
    else:
        src = weights_from
        dh = SDXLHolder.from_state_dicts(
            spec, {k: getattr(src, k).state_dict() for k in ("unet", "vae", "clip1", "clip2")},
            dtype=dtype, device=device,
        )
        # a CUDA generator draws other numbers than a CPU one: share the draws
        dh.get_noise = lambda seed: src.get_noise(seed).to(device)
    be = BlendingEngine(dh)
    be.set_negative_prompt("blurry, low quality")  # read by the next embeddings
    be.set_prompt1("photo of a forest at dawn, mist between the trees")
    be.set_prompt2("photo of a city at night, neon lights in the rain")
    return be


def _lsb(xs, ys) -> int:
    return max(int(abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(xs, ys))


def small_input_check(torch) -> None:
    """The tiny-turbo slice on the GPU against the same slice on the CPU, on
    both paths, and the GPU's fused transition against its per-level one."""
    cpu = _run_engine(torch, "tiny-turbo", "cpu", torch.float32)
    gpu = _run_engine(torch, "tiny-turbo", "cuda", torch.float32, weights_from=cpu.dh)
    gpu_imgs = {}
    for gate, fused in ((None, True), ("0", False)):
        outs = {}
        with _lb_fused(gate):
            for device, be in (("cpu", cpu), ("cuda", gpu)):
                imgs = [im.copy() for im in be.run_transition(fixed_seeds=SEEDS)]
                if bool(be.last_report.levels[0].get("fused")) != fused:
                    raise AssertionError(f"tiny-turbo LB_FUSED={gate} on {device}: {be.last_report.levels}")
                outs[device] = (imgs, list(be.tree_fracts), list(be.tree_similarities))
        (ic, fc, sc), (ig, fg, sg) = outs["cpu"], outs["cuda"]
        lsb = _lsb(ic, ig)
        sim_rel = max(abs(a - b) / max(abs(a), 1e-12) for a, b in zip(sc, sg))
        path = "fused" if fused else "per-level"
        print(f"small input (tiny-turbo, f32, {path}): {len(ig)} keyframes, max |gpu - cpu| = {lsb} LSB, "
              f"similarities max rel diff {sim_rel:.3e}", flush=True)
        if fc != fg or len(ic) != 12 or len(ig) != 12:
            raise AssertionError(f"tiny-turbo {path} tree differs: cpu {fc} vs gpu {fg}")
        # bound: f32 on both sides, sums in another order -> at most a 1-LSB
        # rounding flip per pixel; allow 2 for flips compounded through the VAE
        if lsb > 2 or sim_rel > 1e-3:
            raise AssertionError(f"tiny-turbo {path} GPU vs CPU outside bound: {lsb} LSB, sims rel {sim_rel}")
        gpu_imgs[path] = ig
    # deterministic Euler: the fused scan reproduces the per-level path up to
    # batch-size reassociation (bound of tests/test_fused_tree.py: 1 LSB)
    lsb = _lsb(gpu_imgs["fused"], gpu_imgs["per-level"])
    print(f"small input on the GPU: fused vs per-level max {lsb} LSB", flush=True)
    if lsb > 1:
        raise AssertionError(f"tiny-turbo fused vs per-level on the GPU: {lsb} LSB > 1")


def _zero_counts() -> None:
    from latentblending_tpu_torch.ops import attention, slerp

    slerp.launches = 0
    attention.launches_self = 0
    attention.launches_vae = 0


def _read_counts() -> dict:
    from latentblending_tpu_torch.ops import attention, slerp

    return {"K1": slerp.launches, "K2": attention.launches_self, "K3": attention.launches_vae}


def _check_transition(be, imgs, counts: dict, fused: bool, label: str) -> None:
    """12 uint8 keyframes of the holder's size, 11 finite similarities,
    the expected path, and each kernel launched."""
    hw = (be.dh.height_img, be.dh.width_img, 3)
    if bool(be.last_report.levels[0].get("fused")) != fused:
        raise AssertionError(f"{label}: expected fused={fused}, report levels {be.last_report.levels}")
    if len(imgs) != 12:
        raise AssertionError(f"{label}: expected 12 keyframes, got {len(imgs)}")
    for im in imgs:
        if im.shape != hw or str(im.dtype) != "uint8":
            raise AssertionError(f"{label}: bad keyframe {im.shape} {im.dtype}")
    sims = list(be.tree_similarities)
    if len(sims) != 11 or not all(s == s and abs(s) != float("inf") for s in sims):
        raise AssertionError(f"{label}: similarities not 11 finite values: {sims}")
    if min(counts.values()) < 1:
        raise AssertionError(f"{label}: a kernel of the path was not launched: {counts}")


def _drive_path(torch, be, fused: bool, label: str) -> dict:
    """First (counted) and warm run_transition of one path; returns its
    numbers and the first run's keyframes."""
    _zero_counts()
    t0 = time.perf_counter()
    imgs = [im.copy() for im in be.run_transition(fixed_seeds=SEEDS)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _read_counts()
    _check_transition(be, imgs, counts, fused, label)
    print(f"{label}: launches during run_transition {json.dumps(counts)}, first call {first_s:.4f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs2 = be.run_transition(fixed_seeds=SEEDS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    same = all((a == b).all() for a, b in zip(imgs, imgs2))
    print(f"{label}: warm wall {warm_s:.4f} s, peak memory {peak} bytes ({peak / 2**30:.2f} GiB), "
          f"keyframes reproduce: {same}", flush=True)
    print(f"{label}: phases (warm run, host clock): {json.dumps(be.last_report.phases)}", flush=True)
    print(f"{label}: tree_fracts {[round(f, 6) for f in be.tree_fracts]}", flush=True)
    print(f"{label}: similarities {list(be.tree_similarities)}", flush=True)
    if not same:
        raise AssertionError(f"{label}: run_transition with the same seeds gave different keyframes")
    return {"counts": counts, "first_s": first_s, "warm_s": warm_s, "peak": peak, "imgs": imgs}


def main_path(torch, be) -> dict:
    """The port's entry points at full width: the default (fused) path, the
    per-level path, the streaming I420 contract and the cost model. Returns
    the default path's launch counts."""
    from latentblending_tpu_torch.engine.blending import resolve_image
    from latentblending_tpu_torch.video.i420 import rgb_to_i420

    fused = _drive_path(torch, be, True, "fused (default)")
    with _lb_fused("0"):
        per_level = _drive_path(torch, be, False, "per-level (LB_FUSED=0)")

    # streaming contract: pinned host copies behind CUDA events, I420 planes
    handles = be.run_transition_streaming(fixed_seeds=SEEDS, keyframe_format="i420")
    cache: dict = {}
    planes = [resolve_image(h, cache) for h in handles]
    be.finalize_report()
    H, W = be.dh.height_img, be.dh.width_img
    worst = 0
    for p, rgb in zip(planes, fused["imgs"]):
        if p.shape != (H * 3 // 2, W) or str(p.dtype) != "uint8":
            raise AssertionError(f"i420 keyframe {p.shape} {p.dtype}")
        worst = max(worst, int(abs(p.astype(int) - rgb_to_i420(rgb).astype(int)).max()))
    print(f"streaming i420: {len(planes)} handles → [{H * 3 // 2},{W}] uint8 planes in {len(cache)} host "
          f"batches, max |device - host rgb_to_i420| = {worst} (bound 1), fused={be.last_report.levels[0]}",
          flush=True)
    if len(planes) != 12 or worst > 1 or be.last_report.levels[0].get("fused") is not True:
        raise AssertionError(f"streaming i420 outside its bound: {len(planes)} planes, max diff {worst}, "
                             f"levels {be.last_report.levels}")

    be.measure_sync_overhead()
    pred = be.predict_transition_time()
    print("cost model: " + json.dumps({
        "predicted": pred, "planner_calibrated": be.planner_calibrated(),
        "measured_warm_s": {"fused": fused["warm_s"], "per-level": per_level["warm_s"]},
        "dt_unet_step_fused": be.dt_unet_step_fused, "dt_fused_output": be._dt_fused_output,
        "dt_step_by_batch": be._dt_step_by_batch, "dt_unet_step": be.dt_unet_step,
        "dt_vae": be.dt_vae, "dt_sync": be.dt_sync,
    }), flush=True)
    return fused["counts"]


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "latentblending_tpu_torch")):
        print("chip_smoke.py: latentblending_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    sys.modules["jax"] = None  # the port must run without JAX
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    print(f"card: {_card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    from latentblending_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.3f} s -> {os.path.relpath(lib, ROOT)}", flush=True)
    _build.library()
    _print_sass_counts(lib)

    kres = kernel_phases(torch)
    small_input_check(torch)

    t0 = time.perf_counter()
    be = _run_engine(torch, "sdxl-turbo", "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    unet_params = sum(p.numel() for p in be.dh.unet.parameters())
    print(f"setup: SDXL-Turbo holder (UNet {unet_params} params bf16, VAE f32, CLIP-L + bigG) "
          f"and engine in {time.perf_counter() - t0:.3f} s", flush=True)
    if unet_params != 2_567_463_684:
        raise AssertionError(f"UNet has {unet_params} parameters, not SDXL's 2567463684")
    counts = main_path(torch, be)

    sources = {"K1": "latentblending_tpu_torch/csrc/slerp.cu",
               "K2": "latentblending_tpu_torch/csrc/attention_d64_bf16.cu",
               "K3": "latentblending_tpu_torch/csrc/attention_d512_f32.cu"}
    replaces = {"K1": "latentblending_tpu/ops/pallas_kernels.py:87",
                "K2": "latentblending_tpu/models/layers.py:192",
                "K3": "latentblending_tpu/models/layers.py:373"}
    names = {"K1": "slerp_rows", "K2": "attention_d64_bf16 (wgmma, TMA)",
             "K3": "attention_d512_f32 (3xTF32 mma.sync, 2-CTA cluster)"}
    kernels = [
        {"name": names[k], "route": "cuda", "source": sources[k], "replaces": replaces[k],
         "launches": counts[k], "max_abs_err": max(c["max_abs_err"] for c in kres[k]),
         "ms": kres[k][0]["ms"], "plain_ms": kres[k][0]["plain_ms"]}
        for k in ("K1", "K2", "K3")
    ]
    print(f"chip_smoke.py ran for {time.perf_counter() - t_start:.1f} s", flush=True)
    print(_card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
