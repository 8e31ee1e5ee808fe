#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (latentblending_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one NVIDIA Hopper GPU
(the kernels are built for sm_90a). In order, it:

1. prints the card (nvidia-smi name and power limit) and the TF32 switches;
2. builds the hand-written CUDA kernels from latentblending_tpu_torch/csrc
   and prints the build time;
3. runs each kernel at the shapes of the SDXL-Turbo 512² main path (and,
   for K2/K3, of SDXL-base 1024², plus a peaked case with q scaled by 4)
   against its plain PyTorch version on the same inputs, printing the max
   abs/rel error and both times (CUDA events, median of 20 runs after
   warm-up); prints the tensor-core instruction counts of the built SASS;
4. checks the slice on a small input: the tiny-turbo transition on the GPU
   agrees with the same transition run on the CPU;
5. drives the main path at full width: SDXLHolder.from_random("sdxl-turbo")
   (random weights from a seed), BlendingEngine, set_prompt1/2,
   set_negative_prompt, run_transition(fixed_seeds=[420, 421]); asserts 12
   uint8 512×512 keyframes, finite similarities, and that each kernel was
   launched during that run; prints the warm wall time and peak memory;
6. prints one JSON line with every kernel's numbers, then the final line
   {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the final line.
It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

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
    """Each kernel vs its plain version at the main path's shapes."""
    from latentblending_tpu_torch.ops import slerp

    g = torch.Generator(device="cuda").manual_seed(0)
    res = {}

    k1 = []
    for shape, dtype in (((10, 64, 64, 4), torch.bfloat16), ((10, 64, 64, 4), torch.float32),
                         ((40, 64, 64, 4), torch.bfloat16)):
        a = torch.randn(shape, generator=g, device="cuda").to(dtype)
        b = torch.randn(shape, generator=g, device="cuda").to(dtype)
        f = torch.rand((shape[0],), generator=g, device="cuda")
        got = slerp.slerp_rows(a, b, f).float()
        want = slerp.slerp_rows_reference(a, b, f).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        bound = K1_BOUND[str(dtype).split(".")[1]]
        ok = bool((err <= bound + bound * want.abs()).all())
        case = {
            "shape": list(shape), "dtype": str(dtype).split(".")[1],
            "max_abs_err": err.max().item(),
            "max_rel_err": (err / want.abs().clamp_min(1e-6)).max().item(),
            "ms": _median_ms(torch, lambda: slerp.slerp_rows(a, b, f)),
            "plain_ms": _median_ms(torch, lambda: slerp.slerp_rows_reference(a, b, f)),
            "bound": bound, "ok": ok,
        }
        print("K1 slerp_rows", json.dumps(case), flush=True)
        if not ok:
            raise AssertionError(f"K1 outside its bound: {case}")
        k1.append(case)
    res["K1"] = k1

    # K2 / K3 at every shape of the path (SDXL-Turbo 512²: UNet batches 2 and
    # 10, VAE decode chunks 2-4) and of SDXL-base 1024², plus one peaked case
    # each (q scaled by 4: the running max is rescaled across key tiles).
    # The first case of each is the one the kernels line reports.
    k2_cases = [((10, 1024, 10, 64), 1.0), ((2, 1024, 10, 64), 1.0), ((2, 4096, 10, 64), 1.0),
                ((2, 1024, 20, 64), 1.0), ((10, 1024, 10, 64), 4.0)]
    k3_cases = [((4, 4096, 1, 512), 1.0), ((2, 4096, 1, 512), 1.0), ((1, 16384, 1, 512), 1.0),
                ((2, 4096, 1, 512), 4.0)]
    res["K2"] = [_attention_case(torch, g, shape, torch.bfloat16, peak) for shape, peak in k2_cases]
    res["K3"] = [_attention_case(torch, g, shape, torch.float32, peak) for shape, peak in k3_cases]
    return res


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


def small_input_check(torch) -> None:
    """The tiny-turbo slice on the GPU against the same slice on the CPU."""
    outs = {}
    cpu = _run_engine(torch, "tiny-turbo", "cpu", torch.float32)
    gpu = _run_engine(torch, "tiny-turbo", "cuda", torch.float32, weights_from=cpu.dh)
    for device, be in (("cpu", cpu), ("cuda", gpu)):
        imgs = be.run_transition(fixed_seeds=[420, 421])
        outs[device] = (imgs, list(be.tree_fracts), list(be.tree_similarities))
    (ic, fc, sc), (ig, fg, sg) = outs["cpu"], outs["cuda"]
    lsb = max(int(abs(a.astype(int) - b.astype(int)).max()) for a, b in zip(ic, ig))
    sim_rel = max(abs(a - b) / max(abs(a), 1e-12) for a, b in zip(sc, sg))
    print(f"small input (tiny-turbo, f32): {len(ig)} keyframes, max |gpu - cpu| = {lsb} LSB, "
          f"similarities max rel diff {sim_rel:.3e}", flush=True)
    if fc != fg or len(ic) != len(ig):
        raise AssertionError(f"tiny-turbo tree differs: cpu {fc} vs gpu {fg}")
    # bound: f32 on both sides, sums in another order -> at most a 1-LSB
    # rounding flip per pixel; allow 2 for flips compounded through the VAE
    if lsb > 2 or sim_rel > 1e-3:
        raise AssertionError(f"tiny-turbo GPU vs CPU outside bound: {lsb} LSB, sims rel {sim_rel}")


def main_path(torch) -> dict:
    from latentblending_tpu_torch.ops import attention, slerp

    t0 = time.perf_counter()
    be = _run_engine(torch, "sdxl-turbo", "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    unet_params = sum(p.numel() for p in be.dh.unet.parameters())
    print(f"setup: SDXL-Turbo holder (UNet {unet_params} params bf16, VAE f32, CLIP-L + bigG) "
          f"and engine in {time.perf_counter() - t0:.3f} s", flush=True)
    if unet_params != 2_567_463_684:
        raise AssertionError(f"UNet has {unet_params} parameters, not SDXL's 2567463684")

    # first run: counted; second run: warm wall time
    slerp.launches = 0
    attention.launches_self = 0
    attention.launches_vae = 0
    t0 = time.perf_counter()
    imgs = be.run_transition(fixed_seeds=[420, 421])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {"K1": slerp.launches, "K2": attention.launches_self, "K3": attention.launches_vae}
    print(f"launches during run_transition: {json.dumps(counts)} (first run {first_s:.3f} s)", flush=True)

    if len(imgs) != 12:
        raise AssertionError(f"expected 12 keyframes, got {len(imgs)}")
    for im in imgs:
        if im.shape != (512, 512, 3) or str(im.dtype) != "uint8":
            raise AssertionError(f"bad keyframe {im.shape} {im.dtype}")
    sims = list(be.tree_similarities)
    if len(sims) != 11 or not all(s == s and abs(s) != float("inf") for s in sims):
        raise AssertionError(f"similarities not 11 finite values: {sims}")
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path was not launched: {counts}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs2 = be.run_transition(fixed_seeds=[420, 421])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    same = all((a == b).all() for a, b in zip(imgs, imgs2))
    print(f"run_transition warm wall {warm_s:.4f} s, peak memory {peak} bytes "
          f"({peak / 2**30:.2f} GiB), keyframes reproduce: {same}", flush=True)
    print(f"phases (warm run, host clock, synced at phase ends): {json.dumps(be.last_report.phases)}", flush=True)
    print(f"tree_fracts {[round(f, 6) for f in be.tree_fracts]}", flush=True)
    print(f"similarities {sims}", flush=True)
    if not same:
        raise AssertionError("run_transition with the same seeds gave different keyframes")
    return counts


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "latentblending_tpu_torch")):
        print("chip_smoke.py: latentblending_tpu_torch/ not found beside this script", file=sys.stderr)
        return 2
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
    counts = main_path(torch)

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
    print(_card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
