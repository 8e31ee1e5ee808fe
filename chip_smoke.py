#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (latentblending_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one NVIDIA Hopper GPU
(the kernels are built for sm_90a). In order, it:

1. prints the card (nvidia-smi name and power limit), turns TF32 off
   (precision.disable_tf32, as the port's scripts do) and prints the
   switches;
2. builds the hand-written CUDA kernels from latentblending_tpu_torch/csrc
   (K1-K3, and J1-J3 of the movie's JPEG encoder)
   and prints the build time, ptxas's registers/spills per kernel and the
   tensor-core and local-memory instruction counts of the built SASS; it
   fails unless K3 bf16 (attention_d512_bf16: wgmma and TMA over a 2-CTA
   cluster) and K2 in f32 (attention_d64_f32: 3xTF32 on TF32 wgmma) have
   HGMMA, no HMMA and no spill loads or stores;
3. runs each kernel at the shapes of the SDXL-Turbo 512² main path — the
   per-level and the fused transition — and of the SDXL-base 1024² paths,
   against its plain PyTorch version on the same inputs: K1 slerp_rows at
   [2|10|12|40,64,64,4], [2|3|90,128,128,4] (bf16, [2,…] also f32), ragged
   rows and a misaligned row (the scalar path), exact 0/1 fractions; K1
   slerp_tree_step at [12,64,64,4] with and without a window row, pins
   and a self-parent row, at [5|6|10,128,128,4] and on ragged rows; the K1
   wrappers' refusals; K2/K3 at every path shape (K2 up to the base CFG
   batch [20,4096,10,64]) plus a peaked case (q scaled by 4); K2 in f32 at
   [12|2,1024,10,64], [10,…] peaked and [4,4096,10,64], K3 in bf16 at
   [4|8|1,4096,1,512], [1,16384,1,512], [2,…] peaked and [1,192,1,512]
   (three key tiles); the K2/K3 wrapper's refusals (no kernel for fp16,
   one head at d=512, K2 f32's L a multiple of 128).
   The f32 kernels are held to K3_REL_BOUND, K2 bf16 to K2_ABS_BOUND and
   K3 bf16 to K3_BF16_REL_BOUND.
   For each case it prints the max abs/rel error, the kernel's device time
   (CUDA-graph replay of 10 launches, median of 10), the time of one call
   (CUDA events, median of 20), the plain version's and, for K2/K3,
   scaled_dot_product_attention's device time (the port never calls it),
   the bound (bytes over 3.35 TB/s or operations over the peak of the unit
   that runs them) and the share of it reached;
4. checks the slice on a small input: the tiny-turbo transition on the GPU
   agrees with the same transition on the CPU, on the default (fused) path
   and with LB_FUSED=0 (per-level), and on the GPU the fused transition
   agrees with the per-level one (deterministic Euler);
5. drives the main path at full width: SDXLHolder.from_random("sdxl-turbo")
   (random weights from a seed), BlendingEngine, set_prompt1/2,
   set_negative_prompt, then
   - run_transition(fixed_seeds=[420, 421]) on the default path, which must
     be the fused one: 12 uint8 512×512 keyframes, 11 finite similarities,
     each kernel launched exactly as often as the plan gives
     (_expected_launches: slerp_tree_step once per step, 4; slerp_rows
     never; K2 40; K3 3); first and warm wall, peak memory;
   - the same with LB_FUSED=0 (the per-level path: slerp_rows, K2, K3);
   - run_transition_streaming(keyframe_format="i420"): each resolved handle
     within 1 of the host I420 conversion of the fused RGB keyframe;
   - measure_sync_overhead(), then predict_transition_time() beside the
     measured warm walls of both paths;
   - one warm run of each path under torch.profiler: device time, busy
     share, kernel counts and the costliest kernels;
6. the movie (movie_phase) on the same engine, fused (LB_FUSED=1): one warm
   run_transition, then run_movie_transition of the README example's
   length (12 s at 30 fps) cold and warm, each with K1-K3 launched as the
   fused transition launches them, J1 once per keyframe and J3 once per
   sample (plus the quality probes of the first keyframe), J2 once per
   in-between frame, backend "mjpeg+coef-lerp"; the file parsed with the
   port's read_samples (360 samples of 512x512 at 30 fps, each from SOI to
   EOI); J1 on the first two keyframes' I420 planes, J2 at the first two
   in-between fractions and J3 on those four frames equal to their plain
   versions, and the file's samples equal to those bytes; each kernel's
   times and ms a frame for keyframe and in-between encodes;
   write_movie_transition (RGB keyframes) for 2 s with the coefficient lerp
   and with LB_COEF_LERP=0 (pixel lerp on the card, J1 and J3 per frame),
   one frame of each: J1 (RGB) against its plain version, the sample
   the kernels' bytes; save_tree, load_tree
   into a fresh engine and extend_transition([3], [4]) with exact
   launches; run_multi_transition on a 3-keyframe MovieProject, 2 s a part
   (120 samples). The movies go to a temporary directory;
7. the reference-facing surface (reference_api_phase) on the same holder:
   an LPIPS engine (seeded random weights under the `lpips` package's
   names) on the fused and per-level paths with exact launches (LPIPS
   launches none of K1-K3), its distances on the card against the CPU
   (LPIPS_REL_BOUND) and the pass's times at 512² and 1024²; the gap
   between the metrics on one engine switched by apply_config;
   write_imgs_transition (12 JPEGs: J1's RGB route once, J3 per file, the
   first file equal to encode_rgb of its keyframe; J1 RGB on all 12
   keyframes against its plain version and timed); the reference's single-branch loop for 3
   stems with exact launches, cold and warm, beside one per-level round
   of 3 stems; compute_preview_images over 4 seeds; the holder written as
   a full-width HF snapshot with a minimal safetensors writer, loaded by
   SDXLHolder.from_pretrained and held bit for bit against its source,
   then apps/example_single_trans.main on it (a 2 s movie of 60 samples);
8. image keyframes (image_phase) at SDXL-Turbo 512² on a holder with the
   turbo UNet and CLIP and a bf16 copy of the VAE: set_keyframe1_image on
   a 512² picture (one K3 bf16 launch, the encode) and
   run_transition(recycle_img1=True), the fused path; set_keyframe2_image
   on a 640×768 picture (resized on the card) and
   run_transition(recycle_img2=True), the per-level path; each cold and
   warm with exact launches; then the same 12 latents decoded by the f32
   and the bf16 VAE at 512² and one latent at 1024² (LSB apart, ms per
   keyframe);
9. an f32 copy of the turbo UNet (f32_unet_phase): one fused
   run_transition at 512², cold and warm, K2 f32 launched steps × 10 times;
10. drives SDXL-base 1024² (base_phase): BlendingEngine(dh) runs
   benchmark_speed; negative prompt; set_branching(depth_strength=0.5,
   nmb_max_branches=10), the plan [15,18,21,24,27] x [3,2,1,1,1]; then the
   measured-policy per-level path, the predictive policy's segmented
   fused-multi path and its per-level path (LB_FUSED=0), each cold and
   warm: 10 keyframes, 9 finite similarities, the exact launches (fused-
   multi: tree step 30, slerp_rows 0, K2 2100, K3 10; per-level: tree step
   0, slerp_rows 80, K2 5250, K3 10), identical tree_fracts on the two
   predictive paths, walls, both memory peaks; then the three warm walls
   again in turns (b, c, a, a, c, b) with the card's clock and power, one
   profiled run of each predictive path, and the cost model's predictions
   beside the measured walls;
11. prints one JSON line with every kernel entry's numbers (K1 rows, K1
   tree step, K2 bf16 and f32, K3 f32 and bf16, J1 and its RGB route,
   J2, J3), then the final line
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
# K3: max abs error <= 1e-4 * max |plain result| (f32 both sides);
# K2 in f32 takes K3's bound (3xTF32 both);
# K3 in bf16: max abs error <= 1e-2 * max |plain result| (bf16 operands, P
#     and output; relative, because at d=512 and L=16384 the outputs are of
#     order 0.01-0.1, so an absolute 2e-2 would be a fifth of the largest
#     and too loose to fail a kernel that dropped a key tile); the bounds
#     are emulated on the CPU in
#     tests/test_torch_attention_numerics.py.
K1_BOUND = {"bfloat16": 2e-2, "float32": 1e-5}
K2_ABS_BOUND = 2e-2
K3_REL_BOUND = 1e-4
K3_BF16_REL_BOUND = 1e-2


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _card_state() -> str:
    """The card's SM clock, power draw and temperature now (nvidia-smi)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def _opcode(instruction: str) -> str:
    """The opcode of a SASS instruction ("@P0 LDL.64 R2, [R1] ;" -> "LDL")."""
    return next((t for t in instruction.split() if not t.startswith("@")), "").split(".")[0]


def _print_sass_counts(lib) -> dict:
    """Tensor-core and local-memory instructions per kernel in the built
    library's SASS (cuobjdump from the CUDA toolkit), printed and returned
    as {function name: {"instructions", "HGMMA", "HMMA", "local"}}; "local"
    counts LDL/STL, the loads and stores of spilled registers."""
    from latentblending_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(os.path.realpath(_build.find_nvcc())), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        raise RuntimeError(f"sass: {cuobjdump} not found")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=120).stdout
    counts = {}
    for section in sass.split("Function : ")[1:]:
        lines = section.splitlines()
        # instruction lines read "/*addr*/  OPCODE ...;", encoding lines "/* 0x... */"
        ops = [ln.split("*/", 1)[1].strip() for ln in lines[1:] if ln.strip().startswith("/*") and ";" in ln]
        c = {"instructions": len(ops), "HGMMA": sum("HGMMA" in o for o in ops), "HMMA": sum("HMMA" in o for o in ops),
             "local": sum(_opcode(o) in ("LDL", "STL") for o in ops)}
        counts[lines[0].strip()] = c
        print(f"sass {lines[0].strip()}: {c['instructions']} instructions, HGMMA {c['HGMMA']}, HMMA {c['HMMA']}, "
              f"local {c['local']}", flush=True)
    return counts


def _check_wgmma_sass(counts: dict, kernel: str) -> None:
    """`kernel` (a substring of its function name) runs its products on
    wgmma only (HGMMA > 0, HMMA = 0) and spills nothing (no LDL/STL)."""
    found = {name: c for name, c in counts.items() if kernel in name}
    if not found:
        raise AssertionError(f"sass: no function named like {kernel}")
    for name, c in found.items():
        if c["HGMMA"] == 0 or c["HMMA"] or c["local"]:
            raise AssertionError(f"sass {name}: expected HGMMA > 0, HMMA = 0 and no local memory, got {c}")
    print(f"sass {kernel}: wgmma only, no spills", flush=True)


# published H100 SXM peaks (NVIDIA's data sheet, dense): device memory rate,
# bf16 tensor-core, TF32 tensor-core and f32 (CUDA core) operations
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
GRAPH_LAUNCHES = 10  # launches per captured graph when timing device time
_SIDE: dict = {}  # the one side stream of the timing warm-ups


def _median_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """One call, CUDA events around it: includes the host's launch time."""
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


def _device_ms(torch, fn, reps: int = 10) -> float:
    """Device time of one call: GRAPH_LAUNCHES calls captured in a CUDA
    graph, the graph replayed `reps` times (CUDA events), median / count.
    The replay leaves out the host's launch time."""
    side = _SIDE.setdefault("stream", torch.cuda.Stream())
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / GRAPH_LAUNCHES)
    del graph
    return statistics.median(times)


def _bound(nbytes: float, flops: float, peak: str) -> dict:
    """Least time the card could take: the larger of bytes over the memory
    rate and flops over the peak of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "bound_peak": peak}


def _timings(torch, case: dict, kernel, plain, library=None) -> dict:
    """Device and call times of the kernel, the plain version and (where
    given) the library call; the share of the bound the kernel reaches."""
    case["ms"] = _device_ms(torch, kernel)
    case["call_ms"] = _median_ms(torch, kernel)
    case["plain_ms"] = _device_ms(torch, plain)
    case["library_ms"] = None if library is None else _device_ms(torch, library)
    case["bound_us"] = case["bound_ms"] * 1e3
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    return case


def _k1_close(torch, got, want, dtype) -> tuple:
    """(within K1_BOUND and finite, max abs error, max rel error, bound)."""
    bound = K1_BOUND[str(dtype).split(".")[1]]
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound + bound * want.float().abs()).all())
    return ok, err.max().item(), (err / want.float().abs().clamp_min(1e-6)).max().item(), bound


def _slerp_case(torch, g, shape, dtype, pins: bool = False, misaligned: bool = False) -> dict:
    """slerp_rows vs slerp_rows_reference within K1_BOUND. Every case has
    row 0 at fraction exactly 0 and row 1 at exactly 1 (a, resp. b, bit for
    bit). pins=True is the fused scan's case: rows 0-1 at 0 (row 0 slerped
    with itself, as edge 1's parental mix), rows 2-3 at exactly 1 (the pin).
    misaligned=True starts a one element past a 16-byte boundary (the
    kernel's scalar path)."""
    from latentblending_tpu_torch.ops import slerp

    a = torch.randn(shape, generator=g, device="cuda").to(dtype)
    if misaligned:
        a = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(shape)
    b = torch.randn(shape, generator=g, device="cuda").to(dtype)
    f = torch.rand((shape[0],), generator=g, device="cuda")
    f[0], f[1] = 0.0, 1.0
    exact = [(0, a), (1, b)]
    if pins:
        b[0] = a[0]
        f[0:2] = 0.0
        f[2:4] = 1.0
        exact = [(0, a), (1, a), (2, b), (3, b)]
    got = slerp.slerp_rows(a, b, f)
    want = slerp.slerp_rows_reference(a, b, f)
    torch.cuda.synchronize()
    ok, abs_err, rel_err, bound = _k1_close(torch, got, want, dtype)
    ok = ok and all(torch.equal(got[r], src[r]) for r, src in exact)
    ok = ok and torch.equal(got, slerp.slerp_rows(a, b, f))  # repeats bit for bit
    rows, n, size = shape[0], a.numel() // shape[0], a.element_size()
    case = {"entry": "slerp_rows", "shape": list(shape), "dtype": str(dtype).split(".")[1], "pins": pins,
            "misaligned": misaligned, "max_abs_err": abs_err, "max_rel_err": rel_err, "bound": bound, "ok": ok,
            **_bound(3 * rows * n * size + 4 * rows, 9 * rows * n, "f32")}
    _timings(torch, case, lambda: slerp.slerp_rows(a, b, f), lambda: slerp.slerp_rows_reference(a, b, f))
    print("K1 slerp_rows", json.dumps(case), flush=True)
    if not ok:
        raise AssertionError(f"K1 slerp_rows outside its bound: {case}")
    return case


def _tree_case(torch, g, shape, dtype, window: bool = True, one_chunk: bool = True) -> dict:
    """slerp_tree_step vs slerp_tree_step_reference within K1_BOUND, as the
    fused scan calls it: row 0 an edge (self parents, parental fraction 0,
    mix 0: itself bit for bit), row 1 the recycled edge (fraction 0, mix 1:
    the window, or without one itself, bit for bit), rows 2-3 pinned (mix
    1; row 3 at parental fraction 1: its parent 2 bit for bit), row 4 a
    self-parent stem, the rest random parents. Where a CTA's slice is one
    register chunk (one_chunk), the result is also held within 1 ulp of the
    two-call composition; on longer slices the tree step's second round
    sums the chunks in another order, and the ulps are only printed."""
    from latentblending_tpu_torch.ops import slerp

    rows = shape[0]
    lat = torch.randn(shape, generator=g, device="cuda").to(dtype)
    win = torch.randn(shape[1:], generator=g, device="cuda").to(dtype) if window else None
    p1 = torch.randint(0, rows, (rows,), generator=g, device="cuda")
    p2 = torch.randint(0, rows, (rows,), generator=g, device="cuda")
    p1[0:2], p2[0:2] = torch.arange(2, device="cuda"), torch.arange(2, device="cuda")
    p1[4], p2[4] = 4, 4
    pf = torch.rand((rows,), generator=g, device="cuda")
    mc = torch.rand((rows,), generator=g, device="cuda")
    pf[0:2], pf[3] = 0.0, 1.0
    mc[0], mc[1:4] = 0.0, 1.0
    mask = None
    if window:
        mask = torch.zeros((rows,), dtype=torch.bool, device="cuda")
        mask[1] = True
    args = (lat, p1, p2, pf, mc, win, mask)
    got = slerp.slerp_tree_step(*args)
    want = slerp.slerp_tree_step_reference(*args)
    torch.cuda.synchronize()
    ok, abs_err, rel_err, bound = _k1_close(torch, got, want, dtype)
    ok = ok and torch.equal(got[0], lat[0]) and torch.equal(got[1], win if window else lat[1])
    ok = ok and torch.equal(got[3], lat[int(p2[3])]) and torch.equal(got, slerp.slerp_tree_step(*args))
    # the two-call composition it replaces (gathers, the window select, two
    # slerp_rows launches): within 1 ulp of the storage type
    def two_calls():
        p1_state = lat.index_select(0, p1)
        if window:
            p1_state = torch.where(mask[:, None, None, None], win.expand_as(lat), p1_state)
        return slerp.slerp_rows(lat, slerp.slerp_rows(p1_state, lat.index_select(0, p2), pf), mc)

    ref2 = two_calls().float()
    mant_bits = 7 if dtype == torch.bfloat16 else 23
    ulp = torch.ldexp(torch.ones_like(ref2), torch.frexp(ref2)[1] - 1 - mant_bits)
    ulps = ((got.float() - ref2).abs() / ulp).max()
    ok = ok and (ulps.item() <= 1 or not one_chunk)
    n, size = lat.numel() // rows, lat.element_size()
    # latents read once, the window once, out written once; indices, fractions, mask
    nbytes = (2 * rows * n + (n if window else 0)) * size + rows * (8 + 8 + 4 + 4 + (1 if window else 0))
    case = {"entry": "slerp_tree_step", "shape": list(shape), "dtype": str(dtype).split(".")[1],
            "window_rows": 1 if window else 0, "max_abs_err": abs_err, "max_rel_err": rel_err, "bound": bound,
            "max_ulps_vs_two_calls": ulps.item(), "bit_equal_to_two_calls": torch.equal(got.float(), ref2),
            "ok": ok, **_bound(nbytes, 18 * rows * n, "f32")}
    _timings(torch, case, lambda: slerp.slerp_tree_step(*args), lambda: slerp.slerp_tree_step_reference(*args))
    case["two_calls_ms"] = _device_ms(torch, two_calls)
    print("K1 slerp_tree_step", json.dumps(case), flush=True)
    if not ok:
        raise AssertionError(f"K1 slerp_tree_step outside its bound: {case}")
    return case


def _wrapper_refusals(torch, g) -> None:
    """The K1 wrappers raise on what the kernel does not take: a dtype
    without a kernel, mismatched shapes, a parent row out of range, int32
    indices, a window of another shape, a mask that is not bool, indices
    on another device."""
    from latentblending_tpu_torch.ops import slerp

    lat = torch.randn((6, 5, 7, 3), generator=g, device="cuda")
    idx = torch.arange(6, device="cuda")
    fr = torch.rand((6,), generator=g, device="cuda")
    mask = torch.zeros((6,), dtype=torch.bool, device="cuda")
    calls = [
        (TypeError, lambda: slerp.slerp_rows(lat.half(), lat.half(), fr)),
        (ValueError, lambda: slerp.slerp_rows(lat, lat[:, :1], fr)),
        (ValueError, lambda: slerp.slerp_tree_step(lat, idx + 6, idx, fr, fr)),
        (ValueError, lambda: slerp.slerp_tree_step(lat, idx.int(), idx, fr, fr)),
        (ValueError, lambda: slerp.slerp_tree_step(lat, idx, idx, fr, fr, lat[0, :1], mask)),
        (ValueError, lambda: slerp.slerp_tree_step(lat, idx, idx, fr, fr, lat[0], mask.float())),
        (ValueError, lambda: slerp.slerp_tree_step(lat, idx.cpu(), idx, fr, fr)),
    ]
    for i, (error, call) in enumerate(calls):
        try:
            call()
        except error:
            continue
        raise AssertionError(f"K1 wrapper refusal {i}: expected {error.__name__}")
    print(f"K1 wrappers: {len(calls)} refusals raised", flush=True)


def _sdpa(torch, q, k, v):
    """torch's scaled_dot_product_attention on [B,L,H,d] inputs with the
    first backend that takes them (flash, efficient, cuDNN, math, in that
    order): (callable, backend name). A yardstick only: the port never
    calls it."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return call, backend.name
    raise RuntimeError("scaled_dot_product_attention: no backend takes these inputs")


def _attention_case(torch, g, shape, dtype, peak: float) -> dict:
    """flash_attention vs attention_reference on the same inputs: K2 bf16
    against the plain result in f32 within K2_ABS_BOUND, K3 bf16 within
    K3_BF16_REL_BOUND * max |plain|, an f32 one (K3, K2 f32) within
    K3_REL_BOUND * max |plain|."""
    from latentblending_tpu_torch.ops import attention

    q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    q, k, v = (q * peak).to(dtype), k.to(dtype), v.to(dtype)
    got = attention.flash_attention(q, k, v).float()
    want = attention.attention_reference(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    B, L, H, d = shape
    flops = 4 * B * H * L * L * d
    nbytes = 4 * B * L * H * d * q.element_size()
    case = {
        "shape": list(shape), "dtype": str(dtype).split(".")[1], "q_scale": peak,
        "max_abs_err": err, "max_rel_err": err / want.abs().max().item(),
        "finite": bool(torch.isfinite(got).all()),
    }
    del got, want
    if dtype == torch.bfloat16:
        case.update(_bound(nbytes, flops, "bf16"))
        if d == 512:
            case["bound"] = K3_BF16_REL_BOUND
            case["ok"] = case["finite"] and case["max_rel_err"] <= K3_BF16_REL_BOUND
        else:
            case["bound"] = K2_ABS_BOUND
            case["ok"] = case["finite"] and case["max_abs_err"] <= K2_ABS_BOUND
    else:
        # the f32 kernels run 3xTF32 on the tensor cores: three TF32 products
        # for each f32 one, so the bound is 3 x flops over the TF32 peak; the bounds
        # of the f32 CUDA cores and of one TF32 pass are printed beside it
        case.update(_bound(nbytes, 3 * flops, "tf32"))
        case["flops"], case["bound_peak"] = flops, "3xtf32"
        case["bound_f32_cuda_core_us"] = _bound(nbytes, flops, "f32")["bound_ms"] * 1e3
        case["bound_tf32_one_pass_us"] = _bound(nbytes, flops, "tf32")["bound_ms"] * 1e3
        case["bound"] = K3_REL_BOUND
        case["ok"] = case["finite"] and case["max_rel_err"] <= K3_REL_BOUND
    library, case["library_backend"] = _sdpa(torch, q, k, v)
    _timings(torch, case, lambda: attention.flash_attention(q, k, v),
             lambda: attention.attention_reference(q, k, v), library)
    name = {(64, torch.bfloat16): "K2 attention d64", (64, torch.float32): "K2 attention d64 f32",
            (512, torch.float32): "K3 attention d512", (512, torch.bfloat16): "K3 attention d512 bf16"}[(d, dtype)]
    print(name, json.dumps(case), flush=True)
    if not case["ok"]:
        raise AssertionError(f"{name} outside its bound: {case}")
    return case


def _attention_refusals(torch, g) -> None:
    """flash_attention raises on a CUDA tensor whose (head dim, dtype) has
    no kernel (fp16 at d=64 and d=512), on the d=512 kernels' one-head
    rule and on a sequence K2 f32's 128-row query tiles do not divide;
    nothing falls back to the plain version."""
    from latentblending_tpu_torch.ops import attention

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]

    calls = [
        (TypeError, lambda: attention.flash_attention(*qkv((2, 1024, 10, 64), torch.float16))),
        (TypeError, lambda: attention.flash_attention(*qkv((1, 4096, 1, 512), torch.float16))),
        (ValueError, lambda: attention.flash_attention(*qkv((1, 4096, 2, 512), torch.bfloat16))),
        (ValueError, lambda: attention.flash_attention(*qkv((1, 1088, 10, 64), torch.float32))),
    ]
    before = _read_counts()
    for i, (error, call) in enumerate(calls):
        try:
            call()
        except error:
            continue
        raise AssertionError(f"flash_attention refusal {i}: expected {error.__name__}")
    if _read_counts() != before:
        raise AssertionError("a refused flash_attention call launched a kernel")
    print(f"K2/K3 wrapper: {len(calls)} refusals raised (no kernel for fp16; one head at d=512; "
          f"K2 f32's L a multiple of 128)", flush=True)


def kernel_phases(torch) -> dict:
    """Each kernel vs its plain version at the main path's shapes. The first
    case of each kernel is the one the kernels line reports."""
    g = torch.Generator(device="cuda").manual_seed(0)
    # K1 slerp_rows: per-level crossfeed [10,...] (bf16 and f32) and edges
    # [2,...], per-level parental mix [40,...], the pinned case [12,...],
    # SDXL-base 1024² rows (in f32 two register chunks per CTA), ragged and
    # misaligned rows (scalar path); slerp_tree_step: the fused scan's step
    # [12,...] with and without the window, on 1024² and on ragged rows
    bf16, f32 = torch.bfloat16, torch.float32
    res = {"K1_rows": [_slerp_case(torch, g, (10, 64, 64, 4), bf16),
                       _slerp_case(torch, g, (10, 64, 64, 4), f32),
                       _slerp_case(torch, g, (2, 64, 64, 4), bf16),
                       _slerp_case(torch, g, (40, 64, 64, 4), bf16),
                       _slerp_case(torch, g, (12, 64, 64, 4), bf16, pins=True),
                       _slerp_case(torch, g, (2, 128, 128, 4), bf16),
                       _slerp_case(torch, g, (2, 128, 128, 4), f32),
                       _slerp_case(torch, g, (4, 16, 16, 4), f32),
                       _slerp_case(torch, g, (3, 5, 7, 3), f32),
                       _slerp_case(torch, g, (3, 5, 7, 3), bf16),
                       _slerp_case(torch, g, (2, 1024), f32, misaligned=True),
                       # SDXL-base 1024² per-level: level 1's crossfeed
                       # (3 stems) and parental mix (30 steps x 3 stems)
                       _slerp_case(torch, g, (3, 128, 128, 4), bf16),
                       _slerp_case(torch, g, (90, 128, 128, 4), bf16)],
           "K1_tree": [_tree_case(torch, g, (12, 64, 64, 4), bf16),
                       _tree_case(torch, g, (12, 64, 64, 4), bf16, window=False),
                       _tree_case(torch, g, (12, 64, 64, 4), f32),
                       _tree_case(torch, g, (12, 64, 64, 4), f32, window=False),
                       _tree_case(torch, g, (6, 128, 128, 4), f32, one_chunk=False),
                       _tree_case(torch, g, (6, 5, 7, 3), f32),
                       # SDXL-base 1024² segmented scan: the last segment's
                       # live rows, and the first stem segment's
                       _tree_case(torch, g, (10, 128, 128, 4), bf16, window=False),
                       _tree_case(torch, g, (5, 128, 128, 4), bf16, window=False)]}
    _wrapper_refusals(torch, g)
    # K2 / K3 at every shape of the path (SDXL-Turbo 512²: UNet batches 2,
    # 10 and, fused, 12; VAE decode chunks 2-4) and of SDXL-base 1024²
    # (UNet batches 4-20 with CFG at both attention levels; decode chunk 1),
    # plus one peaked case each (q scaled by 4: the running max is rescaled
    # across key tiles)
    # SDXL-base 1024² with CFG: the edges' batch 4 and the segmented
    # scan's largest, 20
    k2_cases = [((10, 1024, 10, 64), 1.0), ((2, 1024, 10, 64), 1.0), ((12, 1024, 10, 64), 1.0),
                ((2, 4096, 10, 64), 1.0), ((2, 1024, 20, 64), 1.0), ((10, 1024, 10, 64), 4.0),
                ((4, 4096, 10, 64), 1.0), ((20, 4096, 10, 64), 1.0), ((20, 1024, 20, 64), 1.0)]
    k3_cases = [((4, 4096, 1, 512), 1.0), ((2, 4096, 1, 512), 1.0), ((1, 16384, 1, 512), 1.0),
                ((2, 4096, 1, 512), 4.0)]
    res["K2"] = [_attention_case(torch, g, shape, torch.bfloat16, peak) for shape, peak in k2_cases]
    res["K3"] = [_attention_case(torch, g, shape, torch.float32, peak) for shape, peak in k3_cases]
    # K2 in f32 (an f32 UNet: the fused batch 12, the edges' 2, the
    # per-level stems' 10 peaked, SDXL-base 1024²'s CFG edges 4); K3 in bf16 (a bf16 VAE: fused and
    # per-level decode chunks 4, 8 and 2, the encode's 1, the 1024² decode)
    k2_f32_cases = [((12, 1024, 10, 64), 1.0), ((2, 1024, 10, 64), 1.0), ((10, 1024, 10, 64), 4.0),
                    ((4, 4096, 10, 64), 1.0)]
    # (+ three key tiles: the kernel's peeled last tile after two loop steps)
    k3_bf16_cases = [((4, 4096, 1, 512), 1.0), ((8, 4096, 1, 512), 1.0), ((1, 4096, 1, 512), 1.0),
                     ((1, 16384, 1, 512), 1.0), ((2, 4096, 1, 512), 4.0), ((1, 192, 1, 512), 1.0)]
    res["K2_f32"] = [_attention_case(torch, g, shape, torch.float32, peak) for shape, peak in k2_f32_cases]
    res["K3_bf16"] = [_attention_case(torch, g, shape, torch.bfloat16, peak) for shape, peak in k3_bf16_cases]
    _attention_refusals(torch, g)
    # cuBLAS keeps a workspace for each stream it ran on (the timing's side
    # and capture streams): release them, so the main path's peak memory
    # counts the main path's own allocations only
    torch.cuda.synchronize()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    print(f"cuBLAS workspaces released: {clear is not None}; allocated after the kernel phases: "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
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


_COUNT_KEYS = ("K1_rows", "K1_tree", "K2", "K2_f32", "K3", "K3_bf16", "J1", "J1_rgb", "J2", "J3")


def _zero_counts() -> None:
    from latentblending_tpu_torch.ops import attention, slerp
    from latentblending_tpu_torch.video import jpeg

    slerp.launches = 0
    slerp.launches_tree_step = 0
    attention.launches_self = 0
    attention.launches_self_f32 = 0
    attention.launches_vae = 0
    attention.launches_vae_bf16 = 0
    jpeg.launches_fdct = 0
    jpeg.launches_fdct_rgb = 0
    jpeg.launches_lerp = 0
    jpeg.launches_huffman = 0


def _read_counts() -> dict:
    from latentblending_tpu_torch.ops import attention, slerp
    from latentblending_tpu_torch.video import jpeg

    return {"K1_rows": slerp.launches, "K1_tree": slerp.launches_tree_step, "K2": attention.launches_self,
            "K2_f32": attention.launches_self_f32, "K3": attention.launches_vae,
            "K3_bf16": attention.launches_vae_bf16, "J1": jpeg.launches_fdct, "J1_rgb": jpeg.launches_fdct_rgb,
            "J2": jpeg.launches_lerp,
            "J3": jpeg.launches_huffman}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _expected_launches(be, path: str, k2_per_eval: int, recycled: int = 0) -> dict:
    """The launches of each kernel one run_transition of `path` makes on
    the engine's plan: K1's tree step once per denoise step on the fused
    paths (a recycled edge 1 rides along as a window); on the per-level
    path slerp_rows once per step of each denoise call (the edges' unless
    both are recycled, then each round's) and once per round for the
    parental mix; K2 k2_per_eval times per UNet eval, in the UNet's dtype;
    K3 once per VAE decode call (decode_chunk keyframes each; a recycled
    edge's keyframe is still decoded), in the VAE's dtype."""
    N = be.dh.num_inference_steps
    dc = be.dh.decode_chunk
    n_kf = 2 + sum(int(n) for n in be.list_nmb_stems)
    k2 = "K2_f32" if str(be.dh.dtype) == "torch.float32" else "K2"
    k3 = "K3_bf16" if str(be.dh.vae_dtype) == "torch.bfloat16" else "K3"
    out = dict.fromkeys(_COUNT_KEYS, 0)
    if path in ("fused", "fused-multi"):
        fc = int(os.environ.get("LB_FETCH_CHUNK", "4"))
        out.update({"K1_tree": N, k2: N * k2_per_eval,
                    k3: sum(_ceil(min(fc, n_kf - j), dc) for j in range(0, n_kf, fc))})
        return out
    rounds = [(int(idx), k) for idx, n in zip(be.list_idx_injection, be.list_nmb_stems)
              for k in be._round_sizes(int(n))]
    edge_steps = 0 if recycled == 2 else N
    evals = edge_steps + sum(N - idx for idx, _ in rounds)
    out.update({"K1_rows": edge_steps + sum(N - idx + 1 for idx, _ in rounds), k2: evals * k2_per_eval,
                k3: _ceil(2, dc) + sum(_ceil(k, dc) for _, k in rounds)})
    return out


def _report_path(be) -> str:
    levels = be.last_report.levels
    if all(e.get("seg") for e in levels):
        return "fused-multi"
    return "fused" if levels[0].get("fused") else "per-level"


def _check_transition(be, imgs, counts: dict, path: str, k2_per_eval: int, label: str, recycled: int = 0) -> None:
    """The plan's keyframes (2 edges + its stems) as uint8 of the holder's
    size, one finite similarity per gap, the expected path, and exactly the
    launches _expected_launches gives for it."""
    hw = (be.dh.height_img, be.dh.width_img, 3)
    n_kf = 2 + sum(int(n) for n in be.list_nmb_stems)
    if _report_path(be) != path:
        raise AssertionError(f"{label}: expected the {path} path, report levels {be.last_report.levels}")
    if len(imgs) != n_kf:
        raise AssertionError(f"{label}: expected {n_kf} keyframes, got {len(imgs)}")
    for im in imgs:
        if im.shape != hw or str(im.dtype) != "uint8":
            raise AssertionError(f"{label}: bad keyframe {im.shape} {im.dtype}")
    sims = list(be.tree_similarities)
    if len(sims) != n_kf - 1 or not all(s == s and abs(s) != float("inf") for s in sims):
        raise AssertionError(f"{label}: similarities not {n_kf - 1} finite values: {sims}")
    want = _expected_launches(be, path, k2_per_eval, recycled)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def _drive_path(torch, be, path: str, label: str, k2_per_eval: int, **recycle) -> dict:
    """First (counted) and warm run_transition of one path (recycle: the
    recycle_img1/2 arguments); returns its numbers and the first run's
    keyframes and tree."""
    _zero_counts()
    t0 = time.perf_counter()
    imgs = [im.copy() for im in be.run_transition(fixed_seeds=SEEDS, **recycle)]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _read_counts()
    _check_transition(be, imgs, counts, path, k2_per_eval, label, sum(bool(v) for v in recycle.values()))
    print(f"{label}: launches during run_transition {json.dumps(counts)} (as expected), first call {first_s:.4f} s",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    imgs2 = be.run_transition(fixed_seeds=SEEDS, **recycle)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    # the caching allocator may hand out a whole cached block for a smaller
    # request; the requested bytes leave that rounding out
    requested = torch.cuda.memory_stats().get("requested_bytes.all.peak")
    same = all((a == b).all() for a, b in zip(imgs, imgs2))
    print(f"{label}: warm wall {warm_s:.4f} s, peak memory {peak} bytes ({peak / 2**30:.2f} GiB), "
          f"peak requested {requested} bytes, keyframes reproduce: {same}; card after it (SM clock, "
          f"power, temperature): {_card_state()}", flush=True)
    print(f"{label}: phases (warm run, host clock): {json.dumps(be.last_report.phases)}", flush=True)
    print(f"{label}: tree_fracts {[round(f, 6) for f in be.tree_fracts]}", flush=True)
    print(f"{label}: similarities {list(be.tree_similarities)}", flush=True)
    if not same or _report_path(be) != path:
        raise AssertionError(f"{label}: the warm run gave other keyframes or another path ({be.last_report.levels})")
    return {"counts": counts, "first_s": first_s, "warm_s": warm_s, "peak": peak, "requested": requested,
            "imgs": imgs, "fracts": list(be.tree_fracts)}


# UNet self-attention layers on K2 per eval: at 512² the 640-channel level
# (32², 10 layers); at 1024² also the 1280-channel level (32², 60 layers)
K2_PER_EVAL = {512: 10, 1024: 70}


def main_path(torch, be) -> dict:
    """The port's entry points at full width: the default (fused) path, the
    per-level path, the streaming I420 contract and the cost model. Returns
    each path's launch counts."""
    from latentblending_tpu_torch.engine.blending import resolve_image
    from latentblending_tpu_torch.video.i420 import rgb_to_i420

    k2 = K2_PER_EVAL[be.dh.height_img]
    fused = _drive_path(torch, be, "fused", "fused (default)", k2)
    with _lb_fused("0"):
        per_level = _drive_path(torch, be, "per-level", "per-level (LB_FUSED=0)", k2)

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
    if len(planes) != len(fused["imgs"]) or worst > 1 or be.last_report.levels[0].get("fused") is not True:
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
    return {"fused": fused["counts"], "per-level": per_level["counts"]}, {"fused": fused["warm_s"],
                                                                          "per-level": per_level["warm_s"]}


# the README example's movie: 12 s at 30 fps
MOVIE_SECONDS, MOVIE_FPS = 12, 30


def _movie_samples(fp: str, n: int, hw: tuple, fps: float, label: str) -> list:
    """The file's samples, after checking that it is this muxer's MJPEG MP4
    with n samples of size hw at fps, each running from SOI to EOI."""
    from latentblending_tpu_torch.video.mjpeg_mp4 import read_samples

    got = read_samples(fp)
    if got is None:
        raise AssertionError(f"{label}: {fp} is not an MJPEG MP4 of the port's muxer")
    samples, shape, rate = got
    if len(samples) != n or tuple(shape) != tuple(hw) or abs(rate - fps) > 1e-9:
        raise AssertionError(f"{label}: {len(samples)} samples of {shape} at {rate} fps, expected {n} of {hw} at {fps}")
    bad = [i for i, x in enumerate(samples) if x[:2] != b"\xff\xd8" or x[-2:] != b"\xff\xd9"]
    if bad:
        raise AssertionError(f"{label}: samples {bad[:10]} do not run from SOI to EOI")
    return samples


def _expect_counts(counts: dict, want: dict, label: str) -> None:
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def _check_jpeg_counts(counts: dict, keyframes: int, frames: int, lerped: int, label: str) -> int:
    """J1 once per keyframe (or frame, on the pixel path) and J3 once per
    sample, plus the same number of quality probes in each (the first
    keyframe's calibrate_quality), J2 once per lerped frame; returns the
    probes."""
    probes = counts["J1"] - keyframes
    if not (0 <= probes <= 7 and counts["J3"] == frames + probes and counts["J2"] == lerped):
        raise AssertionError(f"{label}: JPEG launches {counts}, expected J1 {keyframes} + p, J2 {lerped}, "
                             f"J3 {frames} + p with 0 <= p <= 7")
    return probes


def _jpeg_exact(torch, label: str, got, want) -> int:
    """Kernel against plain version, exactly; returns the max abs error (0)."""
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel differs from its plain version")
    return 0


def _jpeg_kernel_checks(torch, be, samples: list, quality: int, target: int) -> dict:
    """J1-J3 on the movie's first two keyframes (the I420 planes the engine
    shipped) and the first two in-between fractions, each exactly equal to
    its plain version, and those four frames' bytes equal to the file's
    samples; then each kernel's times (device time by CUDA-graph replay for
    J1 and J2; J3 and the plain versions by CUDA events around one call,
    J3 including its read of the length and its copy to the host; the plain
    J3, a Python bit writer, by the host clock on these four frames) and
    ms a frame for keyframe encodes (J1+J3) and in-between frames (J2+J3)."""
    import numpy as np

    from latentblending_tpu_torch.ops.schedules import frame_insert_counts
    from latentblending_tpu_torch.video import jpeg

    H, W = be.dh.height_img, be.dh.width_img
    planes = be.dh.to_i420_device(torch.stack(be._imgs_dev[:2])).contiguous()
    coef = jpeg.fdct_quant(planes, quality)
    j1_err = _jpeg_exact(torch, "J1 (I420)", coef, jpeg.fdct_quant_reference(planes, quality))
    gap = frame_insert_counts(len(be._imgs_dev), target)[0]
    fracts = [float(f) for f in np.linspace(0, 1, gap + 2)[1:3]]
    lerps = [jpeg.coef_lerp(coef[0], coef[1], f) for f in fracts]
    j2_err = max(_jpeg_exact(torch, f"J2 t={f}", c, jpeg.coef_lerp_reference(coef[0], coef[1], f))
                 for f, c in zip(fracts, lerps))
    header = jpeg.jfif_header(H, W, quality)
    plain_s, scans = [], {}
    for idx, c in ((0, coef[0]), (1, lerps[0]), (2, lerps[1]), (gap + 1, coef[1])):
        scan = jpeg.huffman_scan(c)
        t0 = time.perf_counter()
        want = jpeg.huffman_scan_reference(c)
        plain_s.append(time.perf_counter() - t0)
        if scan != want:
            raise AssertionError(f"J3: sample {idx}'s scan differs from the plain coder's")
        if samples[idx] != header + scan + jpeg.EOI:
            raise AssertionError(f"movie sample {idx} is not the kernels' bytes for its frame")
        scans[idx] = scan
    print(f"movie kernels vs plain: J1 on 2 keyframes [2,{H * 3 // 2},{W}] q{quality}, J2 at t={fracts}, J3 on "
          f"samples 0, 1, 2, {gap + 1}: all equal, and equal to the file's samples", flush=True)

    def times(case: dict, kernel, plain_ms: float, graph: bool = True) -> dict:
        # the plain versions copy small tables to the card, which a CUDA graph
        # cannot capture: CUDA events around one call time them
        case["call_ms"] = _median_ms(torch, kernel)
        case["ms"] = _device_ms(torch, kernel) if graph else case["call_ms"]
        case.update(plain_ms=plain_ms, library_ms=None, bound_us=case["bound_ms"] * 1e3)
        case["share_of_bound"] = case["bound_ms"] / case["ms"]
        return case

    one = planes[:1].contiguous()
    coef_bytes = coef[0].numel() * 2
    j1 = times({"shape": f"[1,{H * 3 // 2},{W}] uint8 I420 -> [{coef.shape[1]},64] int16", "max_abs_err": j1_err,
                **_bound(one.numel() + coef_bytes, 0, "bf16")},
               lambda: jpeg.fdct_quant(one, quality),
               _median_ms(torch, lambda: jpeg.fdct_quant_reference(one, quality)))
    j2 = times({"shape": f"2 x [{coef.shape[1]},64] int16", "max_abs_err": j2_err, **_bound(3 * coef_bytes, 0, "bf16")},
               lambda: jpeg.coef_lerp(coef[0], coef[1], fracts[0]),
               _median_ms(torch, lambda: jpeg.coef_lerp_reference(coef[0], coef[1], fracts[0])))
    # J3 reads the scan's length on the host: its time is one call's, reads included
    j3 = times({"shape": f"[{coef.shape[1]},64] int16 -> {len(scans[0])} bytes (keyframe 0)", "max_abs_err": 0,
                **_bound(coef_bytes + len(scans[0]), 0, "bf16")},
               lambda: jpeg.huffman_scan(coef[0]), statistics.median(plain_s) * 1e3, graph=False)
    pair = jpeg.CoefFrames(coef[0], coef[1], H, W, quality)
    per_frame = {"keyframe (J1+J3)": _median_ms(torch, lambda: jpeg.encode_coefs(jpeg.fdct_quant(one, quality)[0],
                                                                                  H, W, quality)),
                 "in-between (J2+J3)": _median_ms(torch, lambda: pair.lerp(fracts[0]))}
    for name, case in (("J1", j1), ("J2", j2), ("J3", j3)):
        print(f"{name} {case['shape']}: device {case['ms']:.5f} ms, one call {case['call_ms']:.5f} ms, plain "
              f"{case['plain_ms']:.5f} ms, bound {case['bound_us']:.3f} us ({case['bound_by']}), share "
              f"{case['share_of_bound']:.1%}", flush=True)
    print(f"movie ms a frame at {H}x{W} (CUDA events, one call each, host reads included): {json.dumps(per_frame)}",
          flush=True)
    return {"J1": [j1], "J2": [j2], "J3": [j3]}


def movie_phase(torch, be) -> dict:
    """The movie path at full width on the main path's engine, fused
    (LB_FUSED=1, the path an uncalibrated engine takes): one warm
    run_transition for its wall; run_movie_transition of the README's
    length cold (counted) and warm; its file parsed and J1-J3 held against
    their plain versions on its samples; write_movie_transition (RGB
    keyframes) for 2 s with the coefficient lerp and with LB_COEF_LERP=0;
    save_tree, load_tree into a fresh engine on the same holder and one
    extend_transition level; run_multi_transition on a 3-keyframe project.
    Movies go to a temporary directory. Returns the launch counts of each
    counted run and J1-J3's kernel numbers."""
    import tempfile

    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.engine.session import Keyframe, MovieProject, run_multi_transition
    from latentblending_tpu_torch.engine.tree_cache import load_tree, save_tree
    from latentblending_tpu_torch.ops.schedules import frame_insert_counts
    from latentblending_tpu_torch.video import jpeg
    from latentblending_tpu_torch.video.frames import stream_frames_lazy_device

    H, W = be.dh.height_img, be.dh.width_img
    k2 = K2_PER_EVAL[H]
    target = MOVIE_SECONDS * MOVIE_FPS
    counts: dict = {}
    old_coef = os.environ.pop("LB_COEF_LERP", None)
    with tempfile.TemporaryDirectory(prefix="lb_movie_") as tmp, _lb_fused("1"):
        t0 = time.perf_counter()
        be.run_transition(fixed_seeds=SEEDS)
        torch.cuda.synchronize()
        trans_warm = time.perf_counter() - t0

        fp = os.path.join(tmp, "movie.mp4")
        walls = []
        for run in ("cold", "warm"):
            _zero_counts()
            t0 = time.perf_counter()
            imgs = be.run_movie_transition(fp, MOVIE_SECONDS, fps=MOVIE_FPS, fixed_seeds=SEEDS)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            c = _read_counts()
            # K1-K3 as the fused transition launches them; J1-J3 as the movie needs
            _check_transition(be, imgs, {**c, "J1": 0, "J1_rgb": 0, "J2": 0, "J3": 0}, "fused", k2, f"movie ({run})")
            n_kf = len(be.tree_final_imgs)
            probes = _check_jpeg_counts(c, n_kf, target, target - n_kf, f"movie ({run})")
            if run == "cold":
                counts["movie (run_movie_transition)"] = c
        if be.last_writer_backend != "mjpeg+coef-lerp":
            raise AssertionError(f"movie: backend {be.last_writer_backend}, expected mjpeg+coef-lerp")
        q = be.last_jpeg_quality
        samples = _movie_samples(fp, target, (H, W), MOVIE_FPS, "movie")
        phases = be.last_report.phases
        print(f"movie: run_movie_transition {MOVIE_SECONDS} s at {MOVIE_FPS} fps, {len(samples)} samples of "
              f"{H}x{W} ({os.path.getsize(fp)} bytes), backend {be.last_writer_backend}, settled quality {q} "
              f"({probes} probe encodes), cold wall {walls[0]:.4f} s, warm wall {walls[1]:.4f} s beside "
              f"run_transition's warm wall {trans_warm:.4f} s; warm phases: movie_write "
              f"{json.dumps(phases.get('movie_write'))}, keyframe_fetch {json.dumps(phases.get('keyframe_fetch'))}; "
              f"launches (cold) {json.dumps(counts['movie (run_movie_transition)'])}", flush=True)
        kres = _jpeg_kernel_checks(torch, be, samples, q, target)

        # the finished tree's movie from its RGB keyframes, then the pixel path
        rgb_target = 2 * MOVIE_FPS
        for label, coef_lerp in (("movie rgb (write_movie_transition)", None),
                                 ("movie pixel (LB_COEF_LERP=0)", "0")):
            if coef_lerp is not None:
                os.environ["LB_COEF_LERP"] = coef_lerp
            fp2 = os.path.join(tmp, f"rgb_{coef_lerp}.mp4")
            _zero_counts()
            t0 = time.perf_counter()
            try:
                be.write_movie_transition(fp2, 2, fps=MOVIE_FPS)
            finally:
                os.environ.pop("LB_COEF_LERP", None)
            wall = time.perf_counter() - t0
            c = counts[label] = _read_counts()
            pixel = coef_lerp == "0"
            _check_jpeg_counts(c, rgb_target if pixel else n_kf, rgb_target, 0 if pixel else rgb_target - n_kf, label)
            if c["J1_rgb"] != c["J1"]:
                raise AssertionError(f"{label}: every J1 launch should take the RGB route, got {c}")
            s2 = _movie_samples(fp2, rgb_target, (H, W), MOVIE_FPS, label)
            q2 = be.last_jpeg_quality
            idx = 1 if pixel else 0
            frame = torch.from_numpy(be.tree_final_imgs[0]).to(be.dh.device)
            if pixel:  # the first in-between frame, lerped on the card as the writer lerps it
                ins = frame_insert_counts(n_kf, rgb_target)[0]
                frame = list(stream_frames_lazy_device(be.tree_final_imgs[:2], ins + 2, lambda im: im,
                                                       be.dh.device))[1]
            got = jpeg.fdct_quant(frame[None].contiguous(), q2, "rgb")
            want = jpeg.fdct_quant_reference(frame[None].contiguous(), q2, "rgb")
            _jpeg_exact(torch, f"{label}: J1 (RGB)", got, want)
            # J3 against its plain coder ran on the movie's frames (4 at most at 512²: it is slow)
            if s2[idx] != jpeg.jfif_header(H, W, q2) + jpeg.huffman_scan(got[0]) + jpeg.EOI:
                raise AssertionError(f"{label}: sample {idx} is not the kernels' bytes for its frame")
            print(f"{label}: {len(s2)} samples in {wall:.4f} s, backend {be.last_writer_backend}, quality {q2}, "
                  f"sample {idx}: J1 (RGB) equals its plain version and the file the kernels' bytes; "
                  f"launches {json.dumps(c)}", flush=True)

        # the tree cache: save, load into a fresh engine, one more level
        fp3 = os.path.join(tmp, "tree.npz")
        save_tree(be, fp3)
        be2 = BlendingEngine(be.dh)
        meta = load_tree(be2, fp3)
        be2.set_negative_prompt(meta["negative_prompt"])
        be2.set_prompt1(meta["prompt1"])
        be2.set_prompt2(meta["prompt2"])
        idx_inj, stems = 3, 4
        n_before = len(be2.tree_final_imgs)
        _zero_counts()
        t0 = time.perf_counter()
        ext = be2.extend_transition([idx_inj], [stems])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts["tree cache: extend_transition"] = _read_counts()
        N = be2.num_inference_steps
        want = dict.fromkeys(_COUNT_KEYS, 0)
        want.update({"K1_rows": N - idx_inj + 1, "K2": (N - idx_inj) * k2, "K3": _ceil(stems, be2.dh.decode_chunk)})
        _expect_counts(c, want, "tree cache: extend_transition")
        sims = list(be2.tree_similarities)
        if len(ext) != n_before + stems or len(sims) != len(ext) - 1 or not all(
                x == x and abs(x) != float("inf") for x in sims):
            raise AssertionError(f"tree cache: {len(ext)} keyframes from {n_before}, similarities {sims}")
        print(f"tree cache: {os.path.getsize(fp3)} bytes, loaded {n_before} keyframes into a fresh engine, "
              f"extend_transition([{idx_inj}], [{stems}]) in {wall:.4f} s -> {len(ext)} keyframes, {len(sims)} finite "
              f"similarities, launches {json.dumps(c)} (as expected)", flush=True)
        del be2

        # a chained session: 3 keyframes, 2 s a part, into one movie
        project = MovieProject([Keyframe("photo of a forest at dawn, mist between the trees", SEEDS[0]),
                                Keyframe("photo of a city at night, neon lights in the rain", SEEDS[1],
                                         "blurry, low quality"),
                                Keyframe("photo of a desert at noon, dunes under a white sky", 422)],
                               width=W, height=H, num_inference_steps=be.num_inference_steps)
        fp4 = os.path.join(tmp, "multi.mp4")
        _zero_counts()
        t0 = time.perf_counter()
        run_multi_transition(be, project, fp4, duration_single_trans=2, fps=MOVIE_FPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = counts["run_multi_transition"] = _read_counts()
        s4 = _movie_samples(fp4, 2 * 2 * MOVIE_FPS, (H, W), MOVIE_FPS, "run_multi_transition")
        n_kf = 2 * len(be.tree_final_imgs)  # each part writes its two edges
        _check_jpeg_counts(c, n_kf, len(s4), len(s4) - n_kf, "run_multi_transition")
        if be.last_writer_backend != "mjpeg+coef-lerp":
            raise AssertionError(f"run_multi_transition: backend {be.last_writer_backend}")
        print(f"run_multi_transition: 3 keyframes, 2 parts of {2 * MOVIE_FPS} frames -> {len(s4)} samples in "
              f"{wall:.4f} s, backend {be.last_writer_backend}, launches {json.dumps(c)}", flush=True)
    if old_coef is not None:
        os.environ["LB_COEF_LERP"] = old_coef
    return {"counts": counts, "kres": kres}


# LPIPS on the card against the plain CPU run of the same module on the
# same images: max relative difference of the distances. f32 on both sides
# with TF32 off, so only the order of the convolutions' sums differs
# (cuDNN's algorithms against the CPU's). The first card run measured
# 1.2e-7 at 512² (H100); the bound leaves two orders of magnitude for
# other algorithm choices, and a TF32 convolution (10-bit mantissa) would
# break it.
LPIPS_REL_BOUND = 1e-5
_ST_DTYPES = {"torch.float32": "F32", "torch.float16": "F16", "torch.bfloat16": "BF16"}


def _write_safetensors(torch, path: str, state: dict) -> int:
    """A minimal safetensors writer (the package has a reader only): the
    8-byte little-endian header length, the JSON header padded to 8 bytes,
    then each tensor's bytes in name order. Returns the file's size."""
    import struct

    names = sorted(state)
    header, off = {}, 0
    for k in names:
        t = state[k]
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _ST_DTYPES[str(t.dtype)], "shape": list(t.shape), "data_offsets": [off, off + n]}
        off += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for k in names:
            f.write(state[k].detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return 8 + len(head) + off


# the SDXL-Turbo checkpoint's scheduler_config.json (its solver and spacing)
TURBO_SCHEDULER_JSON = {"_class_name": "EulerAncestralDiscreteScheduler", "beta_start": 0.00085, "beta_end": 0.012,
                        "beta_schedule": "scaled_linear", "num_train_timesteps": 1000, "prediction_type": "epsilon",
                        "steps_offset": 1, "timestep_spacing": "trailing"}


def _write_snapshot(torch, dh, root: str) -> int:
    """The holder's four modules as a HF snapshot directory; returns the bytes written."""
    total = 0
    for sub, mod, name in (("unet", dh.unet, "diffusion_pytorch_model"), ("vae", dh.vae, "diffusion_pytorch_model"),
                           ("text_encoder", dh.clip1, "model"), ("text_encoder_2", dh.clip2, "model")):
        os.makedirs(os.path.join(root, sub))
        total += _write_safetensors(torch, os.path.join(root, sub, f"{name}.safetensors"), mod.state_dict())
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(TURBO_SCHEDULER_JSON, f)
    return total


def _finite(xs) -> bool:
    return all(x == x and abs(x) != float("inf") for x in xs)


def _single_branch_loop(torch, be, idx: int, stems: int) -> dict:
    """The reference's loop, one branch at a time: both edges
    (compute_latents1/2, each decoded by latent2image), the tree's
    similarities, then `stems` times get_mixing_parameters, _find_parents,
    set_guidance_mid_dampening, compute_latents_mix and insert_into_tree.
    Returns the wall of each step (host clock, each step synchronized)."""
    walls: dict = {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = walls.get(name, 0.0) + time.perf_counter() - t0
        return out

    lat1 = step("compute_latents1", be.compute_latents1)
    lat2 = step("compute_latents2", be.compute_latents2)

    def edges():
        be.tree_latents = [lat1, lat2]
        be.tree_fracts = [0.0, 1.0]
        be.tree_idx_injection = [0, 0]
        be.tree_final_imgs = [be.dh.latent2image(lat1[-1]), be.dh.latent2image(lat2[-1])]
        be._imgs_dev = []
        be.tree_similarities = be.get_tree_similarities()

    step("edge keyframes + get_tree_similarities", edges)
    for _ in range(stems):
        fract, b1, b2 = step("get_mixing_parameters", lambda: be.get_mixing_parameters(idx))
        if be._find_parents(fract, idx) != (b1, b2):
            raise AssertionError(f"single-branch loop: _find_parents disagrees with get_mixing_parameters at {fract}")
        be.set_guidance_mid_dampening(fract)
        lat = step("compute_latents_mix", lambda: be.compute_latents_mix(fract, b1, b2, idx))
        step("insert_into_tree", lambda: be.insert_into_tree(fract, idx, lat))
    n = 2 + stems
    if (len(be.tree_fracts) != n or len(be.tree_latents) != n or len(be.tree_final_imgs) != n
            or be.tree_fracts != sorted(be.tree_fracts) or len(be.tree_similarities) != n - 1
            or not _finite(be.tree_similarities)):
        raise AssertionError(f"single-branch loop: tree {be.tree_fracts}, similarities {be.tree_similarities}")
    return walls


def reference_api_phase(torch, be_main, nlpd_walls: dict) -> dict:
    """The reference-facing surface at full width, on the SDXL-Turbo 512²
    holder of the main path:
    1. LPIPS: BlendingEngine(dh, similarity_metric="lpips", lpips_params=
       seeded random weights under the `lpips` package's names), the fused
       and the per-level (LB_FUSED=0) run_transition, each with K1-K3
       launched exactly as the NLPD runs launch them (LPIPS launches none);
       the card's distances against the plain CPU run of the same module
       and keyframes (LPIPS_REL_BOUND); the pass's time, host time, peak
       requested bytes and costliest kernels for 11 pairs at 512² and 9
       pairs at 1024²; the gap between the metrics: the LPIPS engine
       switched by apply_config between them in turns, per run the wall,
       the similarity phases and the allocator's cudaMalloc, cudaFree and
       retry counts, then one profiled fused run of each;
    2. write_imgs_transition of those 12 keyframes into a temporary
       directory: J1 (RGB route) once, J3 once per keyframe, each file from
       SOI to EOI, the first equal to encode_rgb of its keyframe, lowres.yaml
       the yaml_text of get_state_dict(); J1's RGB route on the 12
       keyframes at once (the batch write_imgs_transition gives it)
       against its plain version, its times and bound;
    3. the reference's single-branch loop (_single_branch_loop, 3 stems)
       first with exact launches, then warm, beside a per-level transition
       of the same 3 stems in one round;
    4. compute_preview_images over 4 seeds: one batched denoise and one
       batched decode;
    5. from_pretrained at full width: the holder's modules written as a HF
       snapshot (about 8.7 GB; the free disk printed first), loaded with
       SDXLHolder.from_pretrained(spec="sdxl-turbo") and compared tensor by
       tensor, bit for bit (UNet and CLIP after the loader's rounding to
       bf16); then apps.example_single_trans.main(["--snapshot", dir,
       "--duration", "2"]): its MP4 of 60 samples, exact launches. The
       snapshot is removed after.
    Returns the launch counts of each counted run and J1 RGB's numbers."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from latentblending_tpu_torch.apps import example_single_trans
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.models.lpips import LPIPSScorer, random_lpips_state_dict
    from latentblending_tpu_torch.ops.scheduler import SDXL_TURBO_SCHEDULER
    from latentblending_tpu_torch.runtime.holder import SDXLHolder
    from latentblending_tpu_torch.video import jpeg
    from latentblending_tpu_torch.yaml_text import dump

    dh = be_main.dh
    H, W = dh.height_img, dh.width_img
    N = dh.num_inference_steps
    k2 = K2_PER_EVAL[H]
    counts: dict = {}

    # ---- 1. LPIPS
    weights = random_lpips_state_dict(seed=5)
    be = BlendingEngine(dh, similarity_metric="lpips", lpips_params=weights)
    be.set_negative_prompt("blurry, low quality")
    be.set_prompt1("photo of a forest at dawn, mist between the trees")
    be.set_prompt2("photo of a city at night, neon lights in the rain")
    runs = {"lpips, fused": _drive_path(torch, be, "fused", "lpips, fused (default)", k2)}
    with _lb_fused("0"):
        runs["lpips, per-level"] = _drive_path(torch, be, "per-level", "lpips, per-level (LB_FUSED=0)", k2)
    counts.update({name: r["counts"] for name, r in runs.items()})
    print("lpips vs nlpd warm walls (s): " + json.dumps({
        "lpips": {"fused": runs["lpips, fused"]["warm_s"], "per-level": runs["lpips, per-level"]["warm_s"]},
        "nlpd": nlpd_walls}), flush=True)
    a, b = torch.stack(be._imgs_dev[:-1]), torch.stack(be._imgs_dev[1:])
    got = be.lpips.distance_batch(a, b)
    want = LPIPSScorer(params=weights, device="cpu").distance_batch(a.cpu(), b.cpu())
    rel = float(((got.cpu() - want).abs() / want.abs()).max())
    g = torch.Generator(device=dh.device).manual_seed(11)
    big_a = torch.rand((9, 1024, 1024, 3), generator=g, device=dh.device) * 2 - 1
    big_b = torch.rand((9, 1024, 1024, 3), generator=g, device=dh.device) * 2 - 1
    lp: dict = {}
    for size, (x, y) in ((H, (a, b)), (1024, (big_a, big_b))):
        be.lpips.distance_batch(x, y)  # first call: algorithm choice, allocator growth
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        be.lpips.distance_batch(x, y)
        torch.cuda.synchronize()
        peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
        ms = _median_ms(torch, lambda: be.lpips.distance_batch(x, y), reps=5, warmup=1)
        t0 = time.perf_counter()
        be.lpips.distance_batch(x, y)
        host_ms = (time.perf_counter() - t0) * 1e3  # the call's return, before the card is done
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            be.lpips.distance_batch(x, y)
            torch.cuda.synchronize()
        _, by_name = _device_kernels(torch, prof)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
        lp[size] = {"pairs": x.shape[0], "ms": ms, "host_ms": host_ms, "peak_requested_above_before": peak - before,
                    "device_ms": sum(t for t, _ in by_name.values()),
                    "top": [{"name": n[:80], "ms": t, "calls": c} for n, (t, c) in top]}
    print(f"lpips pass (CUDA events, one call; peak requested bytes above those held before; one profiled call): "
          f"{json.dumps(lp)}; card vs CPU distances at {H}x{W} max rel diff {rel:.3e} (bound {LPIPS_REL_BOUND})",
          flush=True)
    if rel > LPIPS_REL_BOUND or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"lpips: card vs CPU distances {rel} > {LPIPS_REL_BOUND}")
    del big_a, big_b

    # the gap between the metrics, on one engine (the LPIPS engine switched
    # by apply_config: same holder, tree and engine state): nlpd, lpips,
    # lpips, nlpd on each path; per run the wall, the similarity phases and
    # the allocator's cudaMalloc / cudaFree / retry counts (a cudaFree waits
    # for the card), then one profiled fused run of each metric (device
    # time against wall)
    cfg = be.get_config()
    turns: dict = {}
    for gate, path in (("1", "fused"), ("0", "per-level")):
        with _lb_fused(gate):
            for metric in ("nlpd", "lpips", "lpips", "nlpd"):
                be.apply_config(dataclasses.replace(cfg, similarity_metric=metric))
                m0 = torch.cuda.memory_stats()
                t0 = time.perf_counter()
                be.run_transition(fixed_seeds=SEEDS)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                m1 = torch.cuda.memory_stats()
                if _report_path(be) != path:
                    raise AssertionError(f"turns {metric} {path}: report levels {be.last_report.levels}")
                ph = be.last_report.phases
                turns.setdefault(f"{metric}, {path}", []).append({
                    "wall_s": wall,
                    "similarity_s": sum(v["total_s"] for k_, v in ph.items() if k_.startswith("similarity")),
                    **{k_: m1[k_] - m0[k_] for k_ in ("num_device_alloc", "num_device_free", "num_alloc_retries")}})
    print("lpips vs nlpd on one engine in turns: " + json.dumps(turns) + f"; card after them {_card_state()}",
          flush=True)
    for metric in ("nlpd", "lpips"):
        be.apply_config(dataclasses.replace(cfg, similarity_metric=metric))
        profile_paths(torch, be, ((f"{metric}, fused", "1"),))

    # ---- 2. write_imgs_transition
    with tempfile.TemporaryDirectory(prefix="lb_imgs_") as tmp:
        _zero_counts()
        t0 = time.perf_counter()
        be.write_imgs_transition(tmp)
        wall = time.perf_counter() - t0
        c = counts["write_imgs_transition"] = _read_counts()
        n_kf = len(be.tree_final_imgs)
        want_c = dict.fromkeys(_COUNT_KEYS, 0)
        want_c.update({"J1": 1, "J1_rgb": 1, "J3": n_kf})
        _expect_counts(c, want_c, "write_imgs_transition")
        names = sorted(os.listdir(tmp))
        if names != sorted([f"lowres_img_{i:04d}.jpg" for i in range(n_kf)] + ["lowres.yaml"]):
            raise AssertionError(f"write_imgs_transition wrote {names}")
        files = [open(os.path.join(tmp, f"lowres_img_{i:04d}.jpg"), "rb").read() for i in range(n_kf)]
        if any(x[:2] != b"\xff\xd8" or x[-2:] != b"\xff\xd9" for x in files):
            raise AssertionError("write_imgs_transition: a file does not run from SOI to EOI")
        frames = torch.from_numpy(np.stack(be.tree_final_imgs)).to(dh.device)
        if files[0] != jpeg.encode_rgb(frames[:1], 75)[0]:
            raise AssertionError("write_imgs_transition: file 0 is not encode_rgb of keyframe 0")
        with open(os.path.join(tmp, "lowres.yaml"), encoding="utf-8") as f:
            if f.read() != dump(be.get_state_dict()):
                raise AssertionError("write_imgs_transition: lowres.yaml is not the engine's state")
        print(f"write_imgs_transition: {n_kf} JPEGs ({sum(map(len, files))} bytes) and lowres.yaml in {wall:.4f} s, "
              f"launches {json.dumps(c)} (as expected)", flush=True)
    # J1's RGB route at the batch write_imgs_transition gives it: all the
    # keyframes in one call
    coef = jpeg.fdct_quant(frames, 75, "rgb")
    err = _jpeg_exact(torch, f"J1 (RGB) on the {n_kf} keyframes", coef, jpeg.fdct_quant_reference(frames, 75, "rgb"))
    j1 = {"shape": f"[{n_kf},{H},{W},3] uint8 RGB -> [{n_kf},{coef.shape[1]},64] int16", "max_abs_err": err,
          **_bound(frames.numel() + coef.numel() * 2, 0, "bf16")}
    j1["call_ms"] = _median_ms(torch, lambda: jpeg.fdct_quant(frames, 75, "rgb"))
    j1["ms"] = _device_ms(torch, lambda: jpeg.fdct_quant(frames, 75, "rgb"))
    j1["plain_ms"] = _median_ms(torch, lambda: jpeg.fdct_quant_reference(frames, 75, "rgb"))
    j1.update(library_ms=None, bound_us=j1["bound_ms"] * 1e3, share_of_bound=j1["bound_ms"] / j1["ms"])
    print(f"J1 (RGB) {j1['shape']}: equal to its plain version; device {j1['ms']:.5f} ms, one call "
          f"{j1['call_ms']:.5f} ms, plain {j1['plain_ms']:.5f} ms, bound {j1['bound_us']:.3f} us ({j1['bound_by']}), "
          f"share {j1['share_of_bound']:.1%}", flush=True)

    # ---- 3. the single-branch loop, beside one per-level round of as many stems
    idx, stems = int(be.list_idx_injection[0]), 3
    _zero_counts()
    first = _single_branch_loop(torch, be, idx, stems)
    c = counts["single-branch loop"] = _read_counts()
    # each edge: one denoise of N steps (slerp_rows once per step); each stem:
    # the parental mix (one slerp_rows) and N - idx steps; one decode per keyframe
    want_c = dict.fromkeys(_COUNT_KEYS, 0)
    want_c.update({"K1_rows": 2 * N + stems * (N - idx + 1), "K2": (2 * N + stems * (N - idx)) * k2,
                   "K3": 2 + stems})
    _expect_counts(c, want_c, "single-branch loop")
    warm = _single_branch_loop(torch, be, idx, stems)
    print(f"single-branch loop ({stems} stems at idx {idx}): launches {json.dumps(c)} (as expected); walls (s) first "
          f"{json.dumps(first)}, warm {json.dumps(warm)}; warm total {sum(warm.values()):.4f} s; tree_fracts "
          f"{[round(f, 6) for f in be.tree_fracts]}, similarities {be.tree_similarities}", flush=True)
    be.set_branching(nmb_max_branches=stems)
    with _lb_fused("0"):
        round3 = _drive_path(torch, be, "per-level", f"per-level, one round of {stems} stems", k2)
    counts[f"per-level, {stems} stems"] = round3["counts"]
    be.set_branching()
    print(f"single-branch loop warm {sum(warm.values()):.4f} s against one per-level round of the same "
          f"{stems} stems {round3['warm_s']:.4f} s", flush=True)

    # ---- 4. previews
    seeds = [1, 2, 3, 4]
    _zero_counts()
    t0 = time.perf_counter()
    prev = be.compute_preview_images(seeds)
    first_s = time.perf_counter() - t0
    c = counts["compute_preview_images"] = _read_counts()
    want_c = dict.fromkeys(_COUNT_KEYS, 0)
    want_c.update({"K1_rows": N, "K2": N * k2, "K3": _ceil(len(seeds), dh.decode_chunk)})
    _expect_counts(c, want_c, "compute_preview_images")
    if len(prev) != len(seeds) or any(p.shape != (H, W, 3) or str(p.dtype) != "uint8" for p in prev):
        raise AssertionError(f"compute_preview_images: {[(p.shape, p.dtype) for p in prev]}")
    t0 = time.perf_counter()
    be.compute_preview_images(seeds)
    print(f"compute_preview_images({seeds}): {len(prev)} uint8 {H}x{W} images, first {first_s:.4f} s, warm "
          f"{time.perf_counter() - t0:.4f} s, launches {json.dumps(c)} (as expected)", flush=True)
    del be

    # ---- 5. from_pretrained at full width, and the example script on it
    tmp_root = tempfile.gettempdir()
    du = shutil.disk_usage(tmp_root)
    print(f"disk at {tmp_root}: total {du.total} bytes, free {du.free} bytes; the snapshot is written in full "
          f"(UNet, VAE and both CLIP towers at full width)", flush=True)
    snap = tempfile.mkdtemp(prefix="sdxl-turbo-snapshot-")
    try:
        t0 = time.perf_counter()
        nbytes = _write_snapshot(torch, dh, snap)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dh2 = SDXLHolder.from_pretrained(snap, spec="sdxl-turbo", device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        n_t = 0
        for name in ("unet", "vae", "clip1", "clip2"):
            got_sd = getattr(dh2, name).state_dict()
            for k, v in getattr(dh, name).state_dict().items():
                ref_v = v if name == "vae" else v.to(dh2.dtype).to(v.dtype)
                if got_sd[k].dtype != v.dtype or not torch.equal(got_sd[k], ref_v):
                    raise AssertionError(f"from_pretrained: {name} {k} differs from its source")
                n_t += 1
        if dh2.schedule.config != SDXL_TURBO_SCHEDULER:
            raise AssertionError(f"from_pretrained: scheduler {dh2.schedule.config}, not {TURBO_SCHEDULER_JSON}")
        print(f"from_pretrained: {nbytes} bytes written in {write_s:.3f} s, then read and loaded onto the card in "
              f"{load_s:.3f} s ({nbytes / load_s / 1e9:.2f} GB/s; page cache warm: the files were just written by "
              f"this process); {n_t} tensors equal to their sources bit for bit (UNet and CLIP after the rounding "
              f"to {dh2.dtype}), scheduler {dh2.schedule.config.scheduler_type}", flush=True)
        del dh2, got_sd
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="lb_app_") as tmp:
            out = os.path.join(tmp, "example1.mp4")
            _zero_counts()
            t0 = time.perf_counter()
            app = example_single_trans.main(["--snapshot", snap, "--duration", "2", "--out", out])
            torch.cuda.synchronize()
            app_s = time.perf_counter() - t0
            c = counts["example_single_trans --snapshot"] = _read_counts()
            n_kf = len(app.tree_final_imgs)
            k_want = _expected_launches(app, "fused", k2)
            kk = [k for k in _COUNT_KEYS if k[0] == "K"]
            _expect_counts({k: c[k] for k in kk}, {k: k_want[k] for k in kk}, "example_single_trans (K1-K3)")
            _check_jpeg_counts(c, n_kf, 2 * MOVIE_FPS, 2 * MOVIE_FPS - n_kf, "example_single_trans")
            samples = _movie_samples(out, 2 * MOVIE_FPS, (H, W), MOVIE_FPS, "example_single_trans")
            print(f"example_single_trans --snapshot (from_pretrained, run_transition, write_movie_transition 2 s): "
                  f"{len(samples)} samples in {app_s:.3f} s, {n_kf} keyframes, launches {json.dumps(c)}", flush=True)
            del app
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"counts": counts, "kres": {"J1_rgb": [j1]}}


def _test_image(h: int, w: int, seed: int):
    """A smooth uint8 [h, w, 3] test picture (sinusoids and a seeded phase),
    made on the host as a user's image would arrive."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [127.5 + 127.5 * np.sin(xx / rng.uniform(9, 40) + rng.uniform(0, 6)) * np.cos(yy / rng.uniform(9, 40))
             for _ in range(3)]
    return np.stack(chans, -1).round().astype(np.uint8)


def _encode_counted(torch, be, setter, image, label: str) -> dict:
    """set_keyframe{1,2}_image with the launch counts zeroed: one K3 launch
    (the encoder's mid block) in the VAE's dtype, nothing else."""
    _zero_counts()
    t0 = time.perf_counter()
    setter(image)
    torch.cuda.synchronize()
    counts = _read_counts()
    want = dict.fromkeys(counts, 0)
    want["K3_bf16" if str(be.dh.vae_dtype) == "torch.bfloat16" else "K3"] = 1
    print(f"{label}: {image.shape[0]}x{image.shape[1]} uint8 image encoded in {time.perf_counter() - t0:.4f} s "
          f"(first call), launches {json.dumps(counts)}", flush=True)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    return counts


def image_phase(torch, turbo_dh) -> dict:
    """Image keyframes at SDXL-Turbo 512², full width, on a holder with the
    turbo holder's UNet and CLIP towers and a bf16 copy of its VAE
    (vae_dtype=torch.bfloat16): set_keyframe1_image on a 512² picture, then
    run_transition(recycle_img1=True) (the fused path, the image trajectory
    as its window); set_keyframe2_image on a 640×768 picture (resized on
    the card), then run_transition(recycle_img2=True) (the per-level path);
    each first and warm, with exact launches (K3 bf16 for every decode and
    encode). Then the same 12 final latents decoded by the f32 and the bf16
    VAE at 512², and one latent at 1024²: LSB apart and ms per keyframe."""
    import copy

    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.models.layers import cast_keep_norms_f32
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    t0 = time.perf_counter()
    vae16 = cast_keep_norms_f32(copy.deepcopy(turbo_dh.vae), torch.bfloat16)
    dh = SDXLHolder("sdxl-turbo", {"unet": turbo_dh.unet, "vae": vae16, "clip1": turbo_dh.clip1,
                                   "clip2": turbo_dh.clip2}, dtype=torch.bfloat16, vae_dtype=torch.bfloat16,
                    device="cuda")
    be = BlendingEngine(dh)
    be.set_negative_prompt("blurry, low quality")
    be.set_prompt1("photo of a forest at dawn, mist between the trees")
    be.set_prompt2("photo of a city at night, neon lights in the rain")
    torch.cuda.synchronize()
    print(f"setup: image-keyframe holder (the turbo UNet and CLIP, a bf16 VAE copy; decode_chunk "
          f"{dh.decode_chunk}) and engine in {time.perf_counter() - t0:.3f} s", flush=True)
    k2 = K2_PER_EVAL[dh.height_img]
    counts = {"image 1 encode": _encode_counted(torch, be, be.set_keyframe1_image, _test_image(512, 512, 1),
                                                "set_keyframe1_image")}
    run1 = _drive_path(torch, be, "fused", "image 1, fused (recycle_img1)", k2, recycle_img1=True)
    finals = torch.cat([t[-1] for t in be.tree_latents], dim=0)
    counts["image 1, fused"] = run1["counts"]
    counts["image 2 encode"] = _encode_counted(torch, be, be.set_keyframe2_image, _test_image(640, 768, 2),
                                               "set_keyframe2_image")
    run2 = _drive_path(torch, be, "per-level", "image 2, per-level (recycle_img2)", k2, recycle_img2=True)
    counts["image 2, per-level"] = run2["counts"]
    # where the time goes with a bf16 VAE: the main path's fused transition
    # (no image), as profile_paths runs it for the f32 VAE
    profile_paths(torch, be, (("fused, bf16 VAE", "1"),))

    # f32 against bf16 decodes of the same latents
    g = torch.Generator(device=dh.device).manual_seed(3)
    big = torch.randn((1, 128, 128, 4), generator=g, device=dh.device).to(torch.bfloat16)
    for size, lat in ((512, finals), (1024, big)):
        stats = {}
        for name, h in (("f32", turbo_dh), ("bf16", dh)):
            h.set_dimensions((size, size))
            h.to_uint8_device(h.decode_to_pm1_batched(lat))  # first call: algorithm choice, allocator growth
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u8 = h.to_uint8_device(h.decode_to_pm1_batched(lat))
            torch.cuda.synchronize()
            stats[name] = (u8, (time.perf_counter() - t0) * 1e3 / lat.shape[0], h.decode_chunk)
            h.set_dimensions(None)
        diff = (stats["f32"][0].int() - stats["bf16"][0].int()).abs()
        print(f"decode f32 vs bf16 VAE at {size}²: {lat.shape[0]} latents, max {diff.max().item()} LSB, mean "
              f"{diff.float().mean().item():.4f} LSB, share of values apart {(diff > 0).float().mean().item():.4f}; "
              f"ms per keyframe f32 {stats['f32'][1]:.3f} (chunk {stats['f32'][2]}), bf16 {stats['bf16'][1]:.3f} "
              f"(chunk {stats['bf16'][2]})", flush=True)
    return counts


def f32_unet_phase(torch, turbo_dh) -> dict:
    """A holder whose UNet is an f32 copy of the turbo UNet (10.3 GB, freed
    after): one fused run_transition at 512², first and warm; K2 runs in
    f32 (steps x 10 launches of K2 f32, none of K2 bf16)."""
    import copy

    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    t0 = time.perf_counter()
    unet32 = copy.deepcopy(turbo_dh.unet).float()
    dh = SDXLHolder("sdxl-turbo", {"unet": unet32, "vae": turbo_dh.vae, "clip1": turbo_dh.clip1,
                                   "clip2": turbo_dh.clip2}, dtype=torch.float32, device="cuda")
    be = BlendingEngine(dh)
    be.set_negative_prompt("blurry, low quality")
    be.set_prompt1("photo of a forest at dawn, mist between the trees")
    be.set_prompt2("photo of a city at night, neon lights in the rain")
    torch.cuda.synchronize()
    print(f"setup: f32-UNet holder ({sum(p.numel() * p.element_size() for p in unet32.parameters())} bytes of "
          f"UNet weights) and engine in {time.perf_counter() - t0:.3f} s", flush=True)
    run = _drive_path(torch, be, "fused", "f32 UNet, fused", K2_PER_EVAL[dh.height_img])
    del be, dh, unet32
    torch.cuda.empty_cache()
    return {"f32 UNet, fused": run["counts"]}


BASE_PLAN = ([15, 18, 21, 24, 27], [3, 2, 1, 1, 1])


def base_phase(torch, turbo_dh) -> dict:
    """SDXL-base 1024² at full width through BlendingEngine(dh), whose
    constructor runs benchmark_speed: the holder takes the SDXL-Turbo
    holder's four modules (the architecture is the same; only the UNet's
    sample_size differs). Negative prompt set, then
    set_branching(depth_strength=0.5, nmb_max_branches=10), the plan
    [15,18,21,24,27] x [3,2,1,1,1]. Three paths, each cold and then warm:
    (a) the default measured policy (per-level), (b) the predictive policy
    under the auto gate (the segmented fused-multi path), (c) the
    predictive policy with LB_FUSED=0 (per-level). (b) and (c) place the
    same stems; their keyframes are compared. Returns each path's launches."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.runtime.holder import SDXL_BASE, SDXLHolder

    t0 = time.perf_counter()
    dh = SDXLHolder(SDXL_BASE, {k: getattr(turbo_dh, k) for k in ("unet", "vae", "clip1", "clip2")},
                    dtype=torch.bfloat16, device="cuda")
    be = BlendingEngine(dh)
    torch.cuda.synchronize()
    print(f"setup: SDXL-base {dh.height_img}² holder (the SDXL-Turbo modules) and engine with "
          f"benchmark_speed in {time.perf_counter() - t0:.3f} s: " + json.dumps({
              "dt_unet_step": be.dt_unet_step, "dt_vae": be.dt_vae, "dt_sync": be.dt_sync,
              "dt_step_by_batch": be._dt_step_by_batch}), flush=True)
    be.set_negative_prompt("blurry, low quality")  # read by the next embeddings
    be.set_prompt1("photo of a forest at dawn, mist between the trees")
    be.set_prompt2("photo of a city at night, neon lights in the rain")
    be.set_branching(depth_strength=0.5, nmb_max_branches=10)
    plan = (list(be.list_idx_injection), list(be.list_nmb_stems))
    segs, row_steps = be._seg_plan(False)
    print(f"base plan {plan}: segments {segs}, {row_steps} useful row-steps, guidance "
          f"{be.guidance_scale_base} (CFG), {be.num_inference_steps} steps", flush=True)
    if plan != BASE_PLAN:
        raise AssertionError(f"base plan {plan}, expected {BASE_PLAN}")
    k2 = K2_PER_EVAL[dh.height_img]
    runs = {"base measured, per-level": _drive_path(torch, be, "per-level", "base (a) measured, per-level", k2)}
    be.placement_policy = "predictive"
    runs["base predictive, fused-multi"] = _drive_path(torch, be, "fused-multi", "base (b) predictive, fused-multi", k2)
    with _lb_fused("0"):
        runs["base predictive, per-level"] = _drive_path(torch, be, "per-level",
                                                         "base (c) predictive, LB_FUSED=0", k2)
    b, c = runs["base predictive, fused-multi"], runs["base predictive, per-level"]
    lsb = _lsb(b["imgs"], c["imgs"])
    print(f"base (b) vs (c): tree_fracts identical: {b['fracts'] == c['fracts']}, keyframes max {lsb} LSB apart "
          f"(bf16 UNet; CFG batches 4 to 20 against 4, 6, 4, 2, 2, 2)", flush=True)
    if b["fracts"] != c["fracts"]:
        raise AssertionError(f"base (b) and (c) placed different stems: {b['fracts']} vs {c['fracts']}")

    # warm walls again, in turns (b, c, a, a, c, b), with the card's state
    # after each: whether a difference between the paths is the path's or
    # the card's (a card under load may clock down at its power limit)
    turns = {name: [] for name in runs}
    b_, c_, a_ = "base predictive, fused-multi", "base predictive, per-level", "base measured, per-level"
    for name in (b_, c_, a_, a_, c_, b_):
        be.placement_policy = "measured" if "measured" in name else "predictive"
        with _lb_fused("1" if "fused-multi" in name else "0"):
            t0 = time.perf_counter()
            be.run_transition(fixed_seeds=SEEDS)
            torch.cuda.synchronize()
            turns[name].append(time.perf_counter() - t0)
        print(f"base turn {name}: warm wall {turns[name][-1]:.4f} s, path {_report_path(be)}, card {_card_state()}",
              flush=True)
        if _report_path(be) != ("fused-multi" if name == b_ else "per-level"):
            raise AssertionError(f"base turn {name}: report levels {be.last_report.levels}")
    # where the time goes on the two predictive paths (each ran warm just above)
    be.placement_policy = "predictive"
    profile_paths(torch, be, (("base predictive, fused-multi", "1"), ("base predictive, per-level", "0")))

    # the cost model, calibrated by the runs above (dt_vae measured by
    # benchmark_speed), beside the measured warm walls
    preds = {}
    for policy in ("measured", "predictive"):
        be.placement_policy = policy
        preds[policy] = {"predicted": be.predict_transition_time(), "planner_calibrated": be.planner_calibrated()}
    print("base cost model: " + json.dumps({
        **preds, "measured_warm_s": {name: [r["warm_s"]] + turns[name] for name, r in runs.items()},
        "dt_unet_step_fused_multi": be.dt_unet_step_fused_multi, "dt_fused_output": be._dt_fused_output,
        "dt_step_by_batch": be._dt_step_by_batch, "dt_unet_step": be.dt_unet_step, "dt_vae": be.dt_vae,
        "dt_sync": be.dt_sync,
    }), flush=True)
    return {name: r["counts"] for name, r in runs.items()}


def _device_kernels(torch, prof) -> tuple:
    """The device kernel events of a torch.profiler run, and {name: (ms, calls)}."""
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, c + 1)
    return kernels, by_name


def profile_paths(torch, be, paths=(("fused", "1"), ("per-level", "0"))) -> None:
    """One run_transition of each (label, LB_FUSED) path under
    torch.profiler, device activity only (every path ran warm before; the
    profiler's processing of the host-side op events would take minutes on
    the SDXL-base paths' 10^5 kernels). Prints the profiled wall, the
    device time (sum of the kernel events; one stream, so they do not
    overlap), the busy share, the kernel count, K1's launches and the
    gather/select kernels, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    # LB_FUSED=1: after measure_sync_overhead the engine is calibrated, and
    # its auto gate would price the paths instead of taking the fused one
    for label, gate in paths:
        with _lb_fused(gate):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                be.run_transition(fixed_seeds=SEEDS)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels, by_name = _device_kernels(torch, prof)
        if not kernels:
            raise AssertionError(f"profile {label}: the profiler recorded no device kernel")
        device_ms = sum(t for t, _ in by_name.values())

        def count(*words):
            return sum(c for name, (_, c) in by_name.items() if any(w in name for w in words))

        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        print(f"profile {label}: " + json.dumps({
            "path": _report_path(be), "profiled_wall_s": wall, "device_ms": device_ms, "busy_share": device_ms / 1e3 / wall,
            "kernel_calls": len(kernels), "k1_slerp_kernel_calls": count("slerp_kernel"),
            "index_select_calls": count("index_select", "indexSelect"),
            "where_calls": count("where"),
            "top": [{"name": name[:90], "ms": t, "calls": c} for name, (t, c) in top],
        }), flush=True)


def _kernels_line(kres: dict, counts: dict) -> list:
    """One entry per kernel entry point: its first case's numbers and its
    launches during the counted (first) run of each path, summed."""
    replaces_k1 = "latentblending_tpu/ops/pallas_kernels.py:87"
    meta = {
        "K1_rows": ("slerp_rows (cluster-split rows)", "latentblending_tpu_torch/csrc/slerp.cu", replaces_k1),
        "K1_tree": ("slerp_tree_step (parental mix + crossfeed, cluster-split rows)",
                    "latentblending_tpu_torch/csrc/slerp.cu", replaces_k1),
        "K2": ("attention_d64_bf16 (wgmma, TMA)", "latentblending_tpu_torch/csrc/attention_d64_bf16.cu",
               "latentblending_tpu/models/layers.py:192"),
        "K2_f32": ("attention_d64_f32 (3xTF32 wgmma, TMA, operands split once per tile)", "latentblending_tpu_torch/csrc/attention_d64_f32.cu",
                   "latentblending_tpu/models/layers.py:192"),
        "K3": ("attention_d512_f32 (3xTF32 mma.sync, 2-CTA cluster)",
               "latentblending_tpu_torch/csrc/attention_d512_f32.cu", "latentblending_tpu/models/layers.py:373"),
        "K3_bf16": ("attention_d512_bf16 (wgmma, TMA, 2-CTA cluster)",
                    "latentblending_tpu_torch/csrc/attention_d512_bf16.cu", "latentblending_tpu/models/layers.py:373"),
        # no TPU kernel: the work the JAX package does on the host through libjpeg
        "J1": ("jpeg_fdct_quant (libjpeg's islow DCT and quantize, from I420 or RGB)",
               "latentblending_tpu_torch/csrc/jpeg.cu", "latentblending_tpu/video/_jpeg_lerp.py:66"),
        # the same entry on RGB frames (libjpeg's color conversion and 2x2
        # downsampling first): movie frames on the pixel path and
        # write_imgs_transition's keyframes, which the JAX package saves with PIL
        "J1_rgb": ("jpeg_fdct_quant, RGB route (color conversion, 2x2 downsampling, DCT, quantize)",
                   "latentblending_tpu_torch/csrc/jpeg.cu", "latentblending_tpu/engine/blending.py:1761"),
        "J2": ("jpeg_coef_lerp (an in-between frame's coefficients)", "latentblending_tpu_torch/csrc/jpeg.cu",
               "latentblending_tpu/video/_jpeg_lerp.py:107"),
        "J3": ("jpeg_huffman (baseline Huffman coding and byte stuffing: 4 launches a count)",
               "latentblending_tpu_torch/csrc/jpeg.cu", "latentblending_tpu/video/_jpeg_lerp.py:66"),
    }
    kernels = []
    for k, (name, source, replaces) in meta.items():
        first = kres[k][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(c[k] for c in counts.values()),
            "launches_by_path": {path: c[k] for path, c in counts.items()},
            "max_abs_err": max(c["max_abs_err"] for c in kres[k]),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"], "shape": first["shape"],
        })
    return kernels


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
    from latentblending_tpu_torch.precision import disable_tf32

    disable_tf32()  # the port's scripts make the same call
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    from latentblending_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.3f} s -> {os.path.relpath(lib, ROOT)}", flush=True)
    _build.library()
    sass = _print_sass_counts(lib)
    for kernel in ("attention_d512_bf16", "attention_d64_f32"):
        _check_wgmma_sass(sass, kernel)

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
    print(f"allocated before the main path: {torch.cuda.memory_allocated()} bytes", flush=True)
    counts, nlpd_walls = main_path(torch, be)
    profile_paths(torch, be)
    movie = movie_phase(torch, be)
    counts.update(movie["counts"])
    kres.update(movie["kres"])
    ref = reference_api_phase(torch, be, nlpd_walls)
    counts.update(ref["counts"])
    kres.update(ref["kres"])
    be.tree_latents, be._imgs_dev, be.tree_final_imgs = [None, None], [], []
    torch.cuda.empty_cache()
    counts.update(image_phase(torch, be.dh))
    torch.cuda.empty_cache()
    counts.update(f32_unet_phase(torch, be.dh))
    counts.update(base_phase(torch, be.dh))

    kernels = _kernels_line(kres, counts)
    print(f"chip_smoke.py ran for {time.perf_counter() - t_start:.1f} s", flush=True)
    print(_card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
