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
   cluster), K3 in f32 (attention_d512_f32: 3xTF32 on TF32 wgmma and TMA
   over a 4-CTA cluster) and K2 in f32 (attention_d64_f32: 3xTF32 on TF32
   wgmma) and C1 (conv3x3_f32: 3xTF32 on TF32 wgmma) have HGMMA, no HMMA
   and no spill loads or stores, and unless J1's fdct_quant_kernel has no
   local memory, and unless M1's adaln_kernel has none;
3. holds J1 exactly against its plain version on frames made here
   (j1_exact_cases: noise at the movie path's batches [1|4,768,512] I420
   and [12|34,512,512,3] RGB and at odd sizes, 0, 255 and checkerboards of
   period 1 and 8, q 1, 50, 90 and 100, one launch a call); then runs each kernel at the shapes of the SDXL-Turbo 512² main path — the
   per-level and the fused transition — and of the SDXL-base 1024² paths,
   against its plain PyTorch version on the same inputs: K1 slerp_rows at
   [2|10|12|40,64,64,4], [2|3|90,128,128,4] (bf16, [2,…] also f32), ragged
   rows and a misaligned row (the scalar path), exact 0/1 fractions; K1
   slerp_tree_step at [12,64,64,4] with and without a window row, pins
   and a self-parent row, at [5|6|10,128,128,4], at SD3.5-Large's
   16-channel [6|12,128,128,16] and on ragged rows; the K1 wrappers'
   refusals; K2/K3 at every path shape (K2 up to the base CFG batch
   [20,4096,10,64], and SD3.5-Large's joint attention [4|12,4429,38,64]
   on K2's tail instantiation, with [2,77|4480,38,64] and a peaked
   [3,200,38,64]; at a length that ends in a partial key tile, the plain
   result without that tile must fall outside the bound) plus a peaked
   case (q scaled by 4), K3 in f32
   also at [1,64|128|192,1,512] (2, 4 and 6 key tiles), and at the
   distributed phase's local shapes [5,1024,10,64] and [10,1024,5,64]; K2 in f32 at
   [12|2,1024,10,64], [10,…] peaked and [4,4096,10,64], K3 in bf16 at
   [4|8|1,4096,1,512], [1,16384,1,512], [2,…] peaked and [1,192,1,512]
   (three key tiles); the K2/K3 wrapper's refusals (no kernel for fp16,
   one head at d=512, K2 f32's L a multiple of 128); C1 at every shape of
   the f32 VAE decoder's 31 3x3 convolutions a decode call at SDXL-Turbo
   512² (batch 4) and SDXL-base 1024² (batch 1), against F.conv2d in
   float64 (cuDNN's FFMA and TF32 errors beside it, TF32 outside the
   bound), at least C1_MIN_SPEEDUP times cuDNN's FFMA kernel, the calls of
   a decode summed, then at an f32 UNet's shapes, narrow and ragged images
   and SD3.5-Large's decoder conv_in (16 -> 512 channels at 128²);
   C1's wrapper's refusals (bf16, stride 2, Cin 4, non-contiguous);
   M1 (ln_modulate, gated_residual, and gated_residual with the norm) at
   SD3.5-Large's [4|12,4096|333,2432] bf16 rows, and at the widths that
   take the kernel's other instantiations (D 1536: one load a thread, 8192:
   four, 72: one warp with dead lanes), against the float64 expression
   (M1_ULP_SHARE of the outputs within a bf16 rounding step, M1_REL_BOUND)
   and x' against the plain version bit for bit, with the unfused PyTorch
   chain's device time beside it (both over copies of the inputs that
   keep a replay's working set at 4x L2 or more), then what an MMDiT
   call's 227 launches take; M1's wrapper's refusals (float32, a
   non-contiguous x, D = 12).
   The f32 attention kernels are held to K3_REL_BOUND, C1 to
   C1_REL_BOUND, K2 bf16 to K2_ABS_BOUND and K3 bf16 to K3_BF16_REL_BOUND.
   For each case it prints the max abs/rel error, the kernel's device time
   (CUDA-graph replay of 10 launches, median of 10), the time of one call
   (CUDA events, median of 20), the plain version's and, for K2/K3,
   scaled_dot_product_attention's, for C1 cuDNN's FFMA convolution's device
   time (the port never calls either),
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
     never; K2 40; K3 3; C1 93, 31 a decode call, in the counter and in the
     report); first and warm wall, peak memory;
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
   fused transition launches them, J1 once per fetch chunk (on the
   engine's device batch: no keyframe is read back and uploaded), J3 once
   per keyframe (the first keyframe's call, then one call per gap coding its
   in-between frames and the next keyframe) and J2 once per gap, plus the
   quality probes of the first keyframe (a J1 and a one-frame J3 call
   each), J1 coding every keyframe once (J1_frames) and J3 every sample
   once (J3_frames), backend
   "mjpeg+coef-lerp"; the warm movie wall beside the warm transition wall;
   the file parsed with the port's read_samples (360 samples of 512x512 at
   30 fps, each from SOI to EOI); J1 on keyframe 0's and on the first
   fetch chunk's I420 planes against its plain version, batched J2 on all of gap 0's
   fractions, batched J3 on gap 0 (its in-between frames and keyframe 1)
   against the plain coder on every frame and against the file's samples,
   J3 on keyframe 0 against sample 0; the kernels' times (J2 and J3 at
   F = 1 and at the gap's F; J3's device time by CUDA-graph replay of its
   device half) and ms a frame for keyframes and for a gap; J3 on noise
   batches (512² F=33, 1024² F=8) against per-frame calls and the plain
   coder on two frames each, with the call's peak device bytes;
   write_movie_transition (RGB keyframes, read on the host: J1 once a
   keyframe) for 2 s with the coefficient lerp, sample 0 the kernels'
   bytes, and with LB_COEF_LERP=0 (pixel lerp on the card, J1 and J3 once
   a gap), J1 (RGB) on the largest gap's batch against its plain version
   and its samples the kernels' bytes; J1's times (device, one call,
   plain, the bound of bytes or integer operations) at each batch;
   save_tree, load_tree
   into a fresh engine and extend_transition([3], [4]) with exact
   launches; run_multi_transition on a 3-keyframe MovieProject, 2 s a part
   (120 samples). The movies go to a temporary directory;
7. the reference-facing surface (reference_api_phase) on the same holder:
   an LPIPS engine (seeded random weights under the `lpips` package's
   names) on the fused and per-level paths with exact launches (LPIPS
   launches none of K1-K3), its distances on the card against the CPU
   (LPIPS_REL_BOUND) and the pass's times at 512² and 1024²; the gap
   between the metrics on one engine switched by apply_config;
   write_imgs_transition (12 JPEGs: J1's RGB route and J3 once each, the
   first file equal to encode_rgb of its keyframe; J1 RGB on all 12
   keyframes against its plain version and timed); the reference's single-branch loop for 3
   stems with exact launches, cold and warm, beside one per-level round
   of 3 stems; compute_preview_images over 4 seeds; the holder written as
   a full-width HF snapshot with a minimal safetensors writer, loaded by
   SDXLHolder.from_pretrained and held bit for bit against its source,
   then apps/example_single_trans.main on it (a 2 s movie of 60 samples);
8. the serving path (serving_phase) on the same engine, over HTTP:
   apps.server.serve(MultiUserRouter({"sdxl-turbo": engine}, 4 previews))
   on 127.0.0.1; /health, /session 512x512, /previews cold and warm with
   exact launches (K1 slerp_rows 4, K2 40, K3 per decode chunk, J1's RGB
   route and J3 once each), each file fetched and decoded by the port's
   decoder; /select and /keyframe twice, /movie (t_per_segment 2) counted
   and warm, its MP4 read back by read_movie_frames (60 frames, its ends
   against the keyframes in PSNR, host ms a frame); two users' /previews
   at once (both 200, no grad_fn on the handler threads); malformed bodies
   400, an unknown file token 403; LPIPS on 9 pairs at 1024² in model
   calls of at most 4 pairs, with its peak requested bytes;
9. image keyframes (image_phase) at SDXL-Turbo 512² on a holder with the
   turbo UNet and CLIP and a bf16 copy of the VAE: set_keyframe1_image on
   a 512² picture (one K3 bf16 launch, the encode) and
   run_transition(recycle_img1=True), the fused path; set_keyframe2_image
   on a 640×768 picture (resized on the card) and
   run_transition(recycle_img2=True), the per-level path; each cold and
   warm with exact launches; then the same 12 latents decoded by the f32
   and the bf16 VAE at 512² and one latent at 1024² (LSB apart, ms per
   keyframe);
10. an f32 copy of the turbo UNet (f32_unet_phase): one fused
   run_transition at 512², cold and warm, K2 f32 launched steps × 10 times;
11. drives SDXL-base 1024² (base_phase): BlendingEngine(dh) runs
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
12. drives SD3.5-Large 1024² (sd3_phase) once the turbo and base holders
   are dropped: SD3Holder.from_random("sd35-large") at full width (MMDiT
   8,056,627,520 and T5 encoder 4,762,310,656 parameters), the predictive
   policy, set_branching(depth_strength=0.5, nmb_max_branches=6), the plan
   [14,18,22,26] x [1,1,1,1]; the segmented fused-multi path cold and
   warm: 6 keyframes, 5 finite similarities, the exact launches (tree step
   28, K2 and K2_tail 1064, K3 6, C1 192: 32 a decode call, M1 6356: 227
   an MMDiT call, also in the report), wall and memory peak;
13. the multi-GPU layer (distributed_phase), once the SD3 holder is
   dropped: one NCCL rank in this process on mesh (1,1) runs
   SDXL-Turbo 512²'s run_transition(fixed_seeds=[420, 421]) on the
   per-level path with exactly the per-level launches, its keyframes bit
   for bit main_path's per-level ones; then two child processes
   (`chip_smoke.py --mesh-child ...`) share the card over gloo (NCCL
   refuses two ranks on one device) and run the same transition on mesh
   (2,1), the stem batch sharded, and (1,2), the UNet's transformer
   blocks Megatron-sharded: per rank the same launches, K2 at the local
   shapes ([5|1,1024,10,64] and [10|2,1024,5,64]), both ranks' keyframes
   byte-equal, tree_fracts main_path's, the keyframes within
   MESH_LSB_BOUND (max) and MESH_LSB_MEAN_BOUND (mean) of main_path's; it prints the collectives of each
   transition and the walls, which are no multi-GPU speed (gloo stages
   every collective through host memory, on one card). K2 at the two
   local shapes is timed in the kernel phases;
14. prints one JSON line with every kernel entry's numbers (K1 rows, K1
   tree step, K2 bf16 and f32, K3 f32 and bf16, C1, M1, J1 and its RGB
   route, J2, J3, and K2 at the two meshes' local shapes), then the final line
   {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without the final line.
It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import gc
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
# C1: max abs error <= 1e-5 * max |F.conv2d in float64| (3xTF32 into an
#     accumulator refreshed every K block of 72: the card read 0.9-1.0e-6,
#     cuDNN's FFMA 2-4e-6 at K = 4608; one TF32 pass, cuDNN with
#     allow_tf32, ~3e-4 and is shown to fail it; emulated on the CPU in
#     tests/test_torch_conv.py).
# M1: against the float64 expression (of the rounded x' where a residual
#     precedes the norm), at least M1_ULP_SHARE of the norm's outputs within
#     one bf16 rounding step and max |M1 - f64| <= M1_REL_BOUND * max |f64|
#     (one bf16 step of the largest output: rounding to nearest reads up to
#     half a step, 2^-8 of a value just above a power of two, and the row
#     statistics' float32 sums in another order may tip a rounding to the
#     other neighbour; the first card run read 2.1-3.2e-3, as the plain
#     chain did); x' equal to the plain version's
#     bit for bit (the same float32 product and sum); emulated on the CPU in
#     tests/test_torch_adaln.py.
K1_BOUND = {"bfloat16": 2e-2, "float32": 1e-5}
K2_ABS_BOUND = 2e-2
K3_REL_BOUND = 1e-4
K3_BF16_REL_BOUND = 1e-2
C1_REL_BOUND = 1e-5
M1_ULP_SHARE = 0.999
M1_REL_BOUND = 2.0 ** -7


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
# bf16 tensor-core, TF32 tensor-core and f32 (CUDA core) operations. int32:
# C-level integer operations (each add, multiply or shift one, as _j1_ops
# counts them) at the most an SM can issue: 4 schedulers x 32 lanes a clock
# (the ALU pipe's IADD3/LEA/shifts beside IMAD on the FMA pipe), each
# instruction doing at most two counted operations (IMAD a multiply and an
# add, IADD3 two adds, LEA a shift and an add), x 132 SMs x 1.98 GHz, the
# clock of the data sheet's 67 TFLOP/s f32 (132 x 128 x 2 x 1.98e9, an FMA two)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int32": 132 * 128 * 2 * 1.98e9}
GRAPH_LAUNCHES = 10  # launches per captured graph when timing device time
L2_BYTES = 50 * 2 ** 20  # H100 SXM's L2
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
    row 0 at fraction exactly 0 and row 1 (where there is one) at exactly 1
    (a, resp. b, bit for bit). pins=True is the fused scan's case: rows 0-1 at 0 (row 0 slerped
    with itself, as edge 1's parental mix), rows 2-3 at exactly 1 (the pin).
    misaligned=True starts a one element past a 16-byte boundary (the
    kernel's scalar path)."""
    from latentblending_tpu_torch.ops import slerp

    a = torch.randn(shape, generator=g, device="cuda").to(dtype)
    if misaligned:
        a = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(shape)
    b = torch.randn(shape, generator=g, device="cuda").to(dtype)
    f = torch.rand((shape[0],), generator=g, device="cuda")
    f[0], f[1:2] = 0.0, 1.0
    exact = [(0, a), (1, b)][:shape[0]]
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
    B, L, H, d = shape

    def plain(q, k, v):
        # one batch row at a time where the whole batch's f32 scores would
        # pass 8 GB (SD3's joint attention, [12, 4429, 38, 64]: 36 GB)
        if B * H * L * L * 4 <= 8e9:
            return attention.attention_reference(q, k, v)
        return torch.cat([attention.attention_reference(q[i:i + 1], k[i:i + 1], v[i:i + 1]) for i in range(B)])

    got = attention.flash_attention(q, k, v).float()
    want = plain(q.float(), k.float(), v.float())
    # at a length that ends in a partial key tile (K2's tail instantiation),
    # the plain result without that tile: what a kernel that skipped it would
    # give, which must fall outside the bound
    cut = L - L % 128 if dtype == torch.bfloat16 and d == 64 else L
    dropped = (plain(q.float(), k[:, :cut].float(), v[:, :cut].float()) - want).abs().max().item() \
        if 0 < cut < L else None
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    flops = 4 * B * H * L * L * d
    nbytes = 4 * B * L * H * d * q.element_size()
    case = {
        "shape": list(shape), "dtype": str(dtype).split(".")[1], "q_scale": peak,
        "max_abs_err": err, "max_rel_err": err / want.abs().max().item(),
        "finite": bool(torch.isfinite(got).all()),
    }
    if dropped is not None:
        case["tail_tile_dropped_abs_err"] = dropped
    del got, want
    if dtype == torch.bfloat16:
        case.update(_bound(nbytes, flops, "bf16"))
        if d == 512:
            case["bound"] = K3_BF16_REL_BOUND
            case["ok"] = case["finite"] and case["max_rel_err"] <= K3_BF16_REL_BOUND
        else:
            case["bound"] = K2_ABS_BOUND
            case["ok"] = (case["finite"] and case["max_abs_err"] <= K2_ABS_BOUND
                          and (dropped is None or dropped > K2_ABS_BOUND))
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
    _timings(torch, case, lambda: attention.flash_attention(q, k, v), lambda: plain(q, k, v), library)
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


# the SDXL VAE decoder's 31 stride-1 3x3 convolutions a decode call, as
# (Cin, Cout, side at a 64x64 latent, calls): the mid block and up block 0
# at the latent's side, up blocks 1-3 after each 2x upsampler (whose conv
# is the first at its side); SDXL-base 1024² doubles every side
C1_DECODER = [(512, 512, 64, 10), (512, 512, 128, 7), (512, 512, 256, 1), (512, 256, 256, 1), (256, 256, 256, 5),
              (256, 256, 512, 1), (256, 128, 512, 1), (128, 128, 512, 5)]
# (the other shapes C1 takes: an f32 UNet's levels at 512² (320 output
# channels: half an output tile), its concatenated skips, narrow images
# (runs of 2 x 32 and 4 x 16 pixels), ragged edges, and SD3.5-Large 1024²'s
# decoder conv_in: its 16 latent channels in take C1, once a decode call)
C1_OTHER = [(2, 320, 320, 64, 64), (2, 640, 640, 32, 32), (2, 2560, 1280, 16, 16), (2, 960, 320, 64, 64),
            (1, 64, 128, 33, 100), (3, 8, 64, 5, 12), (1, 16, 192, 3, 4), (1, 16, 512, 128, 128)]
# C1 launches: one a stride-1 3x3 convolution of an f32 module that the
# route takes (tests/test_torch_conv.py holds it to these counts): 31 a
# decode call of an f32 VAE (C1_DECODER), 34 an eval of an f32 SDXL UNet
# as the holder calls it: of its 36 (conv_in, conv_out and the stride-2
# downsamplers stay on cuDNN) the two upsamplers' convs see the residual
# stream in NHWC strides (the holder passes the latents as an NHWC view, so
# conv_in's output and the stream keep them; GroupNorm's output, which the
# resnets' convs take, is NCHW) and stay on cuDNN
C1_PER_DECODE = 31
C1_PER_UNET_EVAL = 34
C1_MIN_SPEEDUP = 1.5  # over cuDNN's FFMA kernel at every decoder shape


def _conv_case(torch, g, B: int, cin: int, cout: int, hw, timed: bool, calls: int = 0) -> dict:
    """C1 against F.conv2d in float64 on the same inputs (weights at the
    modules' 1/sqrt(fan-in) scale), within C1_REL_BOUND * max |result|;
    cuDNN's FFMA (TF32 off) and TF32 errors beside it, the TF32 one outside
    the bound. timed: device, one-call, plain and cuDNN FFMA (library) ms,
    the bound (3 x flops over the TF32 peak) and C1's speedup over cuDNN,
    at least C1_MIN_SPEEDUP (a timed case is a decoder shape, where cuDNN's
    TF32 route runs on the tensor cores: its error must fail the bound)."""
    import torch.nn.functional as F

    from latentblending_tpu_torch.ops import conv

    h, w = (hw, hw) if isinstance(hw, int) else hw
    x = torch.randn((B, cin, h, w), generator=g, device="cuda")
    wt = torch.randn((cout, cin, 3, 3), generator=g, device="cuda") * (9 * cin) ** -0.5
    b = torch.randn((cout,), generator=g, device="cuda") * 0.1
    got = conv.conv3x3_f32(x, wt, b)
    want = F.conv2d(x.double(), wt.double(), b.double(), padding=1)
    scale = want.abs().max().item()

    def rel(y):
        return (y.double() - want).abs().max().item() / scale

    case = {"shape": [B, cin, cout, h, w], "calls_a_decode": calls, "max_abs_err": rel(got) * scale,
            "max_rel_err": rel(got), "cudnn_ffma_rel_err": rel(F.conv2d(x, wt, b, padding=1)),
            "finite": bool(torch.isfinite(got).all()), "bound": C1_REL_BOUND}
    torch.backends.cudnn.allow_tf32 = True
    try:
        case["cudnn_tf32_rel_err"] = rel(F.conv2d(x, wt, b, padding=1))
    finally:
        torch.backends.cudnn.allow_tf32 = False
    del got, want
    case["ok"] = case["finite"] and case["max_rel_err"] <= C1_REL_BOUND
    flops = 2 * B * h * w * cout * cin * 9
    case.update(_bound(4 * (x.numel() + wt.numel() + b.numel() + B * cout * h * w), 3 * flops, "tf32"))
    case["flops"], case["bound_peak"] = flops, "3xtf32"
    if timed:
        _timings(torch, case, lambda: conv.conv3x3_f32(x, wt, b), lambda: conv.conv3x3_reference(x, wt, b),
                 lambda: F.conv2d(x, wt, b, padding=1))
        case["speedup_over_cudnn"] = case["library_ms"] / case["ms"]
        case["ok"] = (case["ok"] and case["speedup_over_cudnn"] >= C1_MIN_SPEEDUP
                      and case["cudnn_tf32_rel_err"] > C1_REL_BOUND)
    print("C1 conv3x3 f32", json.dumps(case), flush=True)
    if not case["ok"]:
        raise AssertionError(f"C1 outside its bound (error, or TF32 not outside it, or under "
                             f"{C1_MIN_SPEEDUP}x cuDNN): {case}")
    return case


def c1_cases(torch, g) -> list:
    """C1 at every decoder shape of SDXL-Turbo 512² (decode chunk 4) and
    SDXL-base 1024² (chunk 1), timed, then at the other shapes it takes;
    a per-shape table of C1 against cuDNN's FFMA kernel, weighted by the
    calls a decode makes."""
    cases = [_conv_case(torch, g, B, cin, cout, side * scale, True, n)
             for B, scale in ((4, 1), (1, 2)) for cin, cout, side, n in C1_DECODER]
    for label, part in (("SDXL-Turbo 512², chunk 4", cases[:len(C1_DECODER)]),
                        ("SDXL-base 1024², chunk 1", cases[len(C1_DECODER):])):
        c1 = sum(c["ms"] * c["calls_a_decode"] for c in part)
        cudnn = sum(c["library_ms"] * c["calls_a_decode"] for c in part)
        print(f"C1 a decode call, {label}: {c1:.3f} ms of C1 against {cudnn:.3f} ms of cuDNN FFMA over the "
              f"{sum(c['calls_a_decode'] for c in part)} convolutions ({cudnn / c1:.2f}x)", flush=True)
    return cases + [_conv_case(torch, g, B, cin, cout, (h, w), False) for B, cin, cout, h, w in C1_OTHER]


def _conv_refusals(torch, g) -> None:
    """conv3x3_f32 raises on a CUDA input C1 does not take (bf16, stride 2,
    Cin 4, a non-contiguous input) and launches nothing."""
    from latentblending_tpu_torch.ops import conv

    x = torch.randn((1, 8, 8, 8), generator=g, device="cuda")
    w = torch.randn((64, 8, 3, 3), generator=g, device="cuda")
    calls = [
        (TypeError, lambda: conv.conv3x3_f32(x.bfloat16(), w.bfloat16())),
        (ValueError, lambda: conv.conv3x3_f32(x, w, stride=2)),
        (ValueError, lambda: conv.conv3x3_f32(x[:, :4].contiguous(), w[:, :4].contiguous())),
        (ValueError, lambda: conv.conv3x3_f32(x.transpose(2, 3), w)),
    ]
    before = _c1_count()
    for i, (error, call) in enumerate(calls):
        try:
            call()
        except error:
            continue
        raise AssertionError(f"conv3x3_f32 refusal {i}: expected {error.__name__}")
    if _c1_count() != before:
        raise AssertionError("a refused conv3x3_f32 call launched C1")
    print(f"C1 wrapper: {len(calls)} refusals raised (bf16, stride 2, Cin 4, a non-contiguous input)", flush=True)


# M1 at SD3.5-Large 1024²'s rows: the image stream (4096 rows) and the text
# stream (333) at the CFG batches of the edges (4) and of the segmented
# scan's last segment (12), D = 2432
M1_SHAPES = [(4, 4096, 2432), (12, 4096, 2432), (4, 333, 2432), (12, 333, 2432)]
# the kernel's other instantiations: one load a thread in 6 warps (D 1536,
# SD3.5-Medium's width), four in 8 warps (D 8192, the widest it takes), and
# one warp with 23 of its 32 lanes dead (D 72)
M1_WIDTHS = [(4, 4096, 1536), (2, 333, 8192), (3, 45, 72)]
M1_MODES = ("ln_modulate", "gated_residual", "gated_residual+norm")


def _ulp_bf16(torch, r):
    """bf16's rounding step at |r| (float64): 2^(floor(log2 |r|) - 7)."""
    _, e = torch.frexp(r)
    return torch.ldexp(torch.ones_like(r), (e - 8).clamp_min(-133))


def _adaln_case(torch, g, shape, mode: str) -> dict:
    """M1 (mode: ln_modulate, gated_residual, or gated_residual with the
    norm) on bf16 rows against the float64 expression (M1_ULP_SHARE,
    M1_REL_BOUND) and x' against the plain version bit for bit; the share of
    the norm's outputs bit-equal to the plain bf16 chain; device, one-call
    and plain (the unfused PyTorch chain) ms, the bound (bytes over 3.35
    TB/s: each row read once, each output written once, the vectors once)
    and its share. The vectors are chunks of one [B, 6D] tensor, as the
    adaLN linear gives them. Device times replay the call over `copies`
    sets of inputs in turn, outputs kept, so that a replay touches at least
    4x L2 and a small case reads device memory as it does in the MMDiT
    (where the GEMMs between two calls evict its rows); at most 64 sets,
    so the D = 72 case stays in L2 (it checks the arithmetic, not a time)."""
    from latentblending_tpu_torch.ops import adaln

    B, L, D = shape
    x = torch.randn(shape, generator=g, device="cuda").bfloat16()
    y = torch.randn(shape, generator=g, device="cuda").bfloat16()
    shift, scale, gate = (torch.randn((B, 6 * D), generator=g, device="cuda") * 0.5).bfloat16().chunk(6, dim=1)[:3]
    args = {"ln_modulate": (x, shift, scale), "gated_residual": (x, gate, y),
            "gated_residual+norm": (x, gate, y, shift, scale)}[mode]
    kernel, plain = ((adaln.ln_modulate, adaln.ln_modulate_reference) if mode == "ln_modulate"
                     else (adaln.gated_residual, adaln.gated_residual_reference))
    got, want_plain = kernel(*args), plain(*args)
    case = {"shape": list(shape), "mode": mode, "finite": True, "x_out_bit_equal": None, "max_abs_err": 0.0,
            "max_rel_err": None, "within_1_ulp_share": None}
    if mode != "ln_modulate":
        xk, xp = (got[0], want_plain[0]) if mode == "gated_residual+norm" else (got, want_plain)
        case["x_out_bit_equal"] = bool(torch.equal(xk, xp))
        case["max_abs_err"] = (xk.float() - xp.float()).abs().max().item()
        case["finite"] = bool(torch.isfinite(xk).all())
    if mode != "gated_residual":
        src = x if mode == "ln_modulate" else got[0]
        out, out_plain = (got, want_plain) if mode == "ln_modulate" else (got[1], want_plain[1])
        xd = src.double()
        ln = (xd - xd.mean(-1, keepdim=True)) * torch.rsqrt(xd.var(-1, unbiased=False, keepdim=True) + 1e-6)
        want = ln * (1 + scale.double()[:, None]) + shift.double()[:, None]
        del xd, ln
        err = (out.double() - want).abs()
        scale_max = want.abs().max().item()
        case.update({"max_abs_err": err.max().item(), "max_rel_err": err.max().item() / scale_max,
                     "within_1_ulp_share": (err <= _ulp_bf16(torch, want)).double().mean().item(),
                     "plain_max_rel_err": (out_plain.double() - want).abs().max().item() / scale_max,
                     "plain_bit_equal_share": (out == out_plain).double().mean().item(),
                     "finite": case["finite"] and bool(torch.isfinite(out).all())})
        del err, want
    del got, want_plain
    case["ok"] = (case["finite"] and case["x_out_bit_equal"] is not False
                  and (mode == "gated_residual"
                       or (case["within_1_ulp_share"] >= M1_ULP_SHARE and case["max_rel_err"] <= M1_REL_BOUND)))
    rows = B * L * D * 2
    nbytes = {"ln_modulate": 2 * rows + 2 * B * D * 2, "gated_residual": 3 * rows + B * D * 2,
              "gated_residual+norm": 4 * rows + 3 * B * D * 2}[mode]
    case.update(_bound(nbytes, 0, "bf16"))
    copies = min(-(-4 * L2_BYTES // nbytes), 64)
    sets = [args]
    for _ in range(copies - 1):
        base = torch.randn((B, 6 * D), generator=g, device="cuda").bfloat16().chunk(6, dim=1)
        sets.append(tuple(base[i] if t.dim() == 2 else torch.randn_like(t, dtype=torch.float32).bfloat16()
                          for i, t in enumerate(args)))
    case["copies"] = copies
    case["ms"] = _device_ms(torch, lambda: [kernel(*a) for a in sets]) / copies
    case["call_ms"] = _median_ms(torch, lambda: kernel(*args))
    case["plain_ms"] = _device_ms(torch, lambda: [plain(*a) for a in sets]) / copies
    case["library_ms"] = None
    case["bound_us"] = case["bound_ms"] * 1e3
    case["share_of_bound"] = case["bound_ms"] / case["ms"]
    del sets
    print("M1 adaln bf16", json.dumps(case), flush=True)
    if not case["ok"]:
        raise AssertionError(f"M1 outside its bound (x' not the plain x', or the norm off the f64 expression): {case}")
    return case


def m1_cases(torch, g) -> list:
    """M1's three forms at every SD3.5-Large 1024² row shape and at
    M1_WIDTHS; the time an MMDiT call would spend in them at the image and
    text shapes of a batch, beside the plain chain's."""
    cases = [_adaln_case(torch, g, shape, mode) for shape in M1_SHAPES + M1_WIDTHS for mode in M1_MODES]
    # a call of 38 blocks: the image stream's 38 norm1 and norm_out, 38
    # residuals with the FF's norm and 38 without; the text stream's 38
    # norm1_context, 37 and 37 (it ends at the last block's attention)
    per_call = {"ln_modulate": (39, 38), "gated_residual": (38, 37), "gated_residual+norm": (38, 37)}
    img, txt = M1_SHAPES[0][1], M1_SHAPES[2][1]
    for B in (4, 12):
        by = {(c["shape"][1], c["mode"]): c for c in cases if c["shape"][0] == B and c["shape"][2] == 2432}

        def call_ms(key, rows=(img, txt)):
            return sum(by[(L, m)][key] * n for m, counts in per_call.items() for L, n in zip((img, txt), counts)
                       if L in rows)

        m1, plain, bound = call_ms("ms"), call_ms("plain_ms"), call_ms("bound_ms")
        img_share = call_ms("bound_ms", (img,)) / call_ms("ms", (img,))
        print(f"M1 an MMDiT call at batch {B} ({sum(a + b for a, b in per_call.values())} launches): {m1:.3f} ms of "
              f"M1 against {plain:.3f} ms of the plain chain ({plain / m1:.2f}x), bound {bound:.3f} ms "
              f"({bound / m1:.1%}; the image rows' alone {img_share:.1%})", flush=True)
    return cases


def _adaln_refusals(torch, g) -> None:
    """ln_modulate and gated_residual raise on CUDA inputs M1 does not take
    (float32, a non-contiguous x, D = 12) and launch nothing."""
    from latentblending_tpu_torch import profiling
    from latentblending_tpu_torch.ops import adaln

    x = torch.randn((2, 16, 64), generator=g, device="cuda").bfloat16()
    v = torch.randn((2, 64), generator=g, device="cuda").bfloat16()
    calls = [
        (TypeError, lambda: adaln.ln_modulate(x.float(), v.float(), v.float())),
        (ValueError, lambda: adaln.gated_residual(x.transpose(0, 1), v[:1], x.transpose(0, 1))),
        (ValueError, lambda: adaln.ln_modulate(x[..., :12].contiguous(), v[:, :12], v[:, :12])),
    ]
    before = profiling.counter("M1")
    for i, (error, call) in enumerate(calls):
        try:
            call()
        except error:
            continue
        raise AssertionError(f"M1 refusal {i}: expected {error.__name__}")
    if profiling.counter("M1") != before:
        raise AssertionError("a refused M1 call launched M1")
    print(f"M1 wrapper: {len(calls)} refusals raised (float32, a non-contiguous x, D = 12)", flush=True)


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
                       _tree_case(torch, g, (5, 128, 128, 4), bf16, window=False),
                       # SD3.5-Large 1024²'s segmented scan: 16-channel rows,
                       # 4x a base row (four register chunks a CTA), the
                       # last segment's 6 live rows, and 12
                       _tree_case(torch, g, (6, 128, 128, 16), bf16, window=False, one_chunk=False),
                       _tree_case(torch, g, (12, 128, 128, 16), bf16, window=False, one_chunk=False)]}
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
                ((4, 4096, 10, 64), 1.0), ((20, 4096, 10, 64), 1.0), ((20, 1024, 20, 64), 1.0),
                # SD3.5-Large 1024²'s joint attention, 4096 + 333 tokens on
                # K2's tail instantiation: the edges' CFG batch 4 and the
                # segmented scan's largest, 12; the tail alone, two batches
                # reading each other's bounds, and a peaked ragged case
                ((4, 4429, 38, 64), 1.0), ((12, 4429, 38, 64), 1.0), ((2, 77, 38, 64), 1.0),
                ((2, 4480, 38, 64), 1.0), ((3, 200, 38, 64), 4.0)]
    # (+ the shortest sequences K3's 64-row query tiles take: 2, 4 and 6
    # of its 32-key tiles, the peeled last two alone and after loop steps)
    k3_cases = [((4, 4096, 1, 512), 1.0), ((2, 4096, 1, 512), 1.0), ((1, 16384, 1, 512), 1.0),
                ((2, 4096, 1, 512), 4.0), ((1, 64, 1, 512), 1.0), ((1, 128, 1, 512), 1.0),
                ((1, 192, 1, 512), 1.0)]
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
    res["C1"] = c1_cases(torch, g)
    _conv_refusals(torch, g)
    res["M1"] = m1_cases(torch, g)
    _adaln_refusals(torch, g)
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


def _run_engine(torch, spec: str, device: str, dtype, weights_from=None, mesh=None):
    """Engine with prompts set; random weights from seed 0 (on `mesh`, if
    given), or the weights and seeded noise of the holder `weights_from`
    (on another device)."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.runtime.holder import SDXLHolder

    if weights_from is None:
        dh = SDXLHolder.from_random(spec, seed=0, dtype=dtype, device=device, mesh=mesh)
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


# J1 and J3 count calls, J1_frames and J3_frames the frames those calls coded
_COUNT_KEYS = ("K1_rows", "K1_tree", "K2", "K2_tail", "K2_f32", "K3", "K3_bf16", "J1", "J1_rgb", "J1_frames", "J2",
               "J3", "J3_frames", "M1")


_COUNTS_ZERO: dict = {}  # the profiling registry's counters at the last _zero_counts


def _zero_counts() -> None:
    from latentblending_tpu_torch import profiling

    _COUNTS_ZERO.clear()
    _COUNTS_ZERO.update(profiling.counters())


def _read_counts() -> dict:
    """The launch counters (profiling's registry) since the last _zero_counts."""
    from latentblending_tpu_torch import profiling

    return {k: profiling.counter(k) - _COUNTS_ZERO.get(k, 0) for k in _COUNT_KEYS}


def _c1_count() -> int:
    """C1's launches since the last _zero_counts (kept out of _COUNT_KEYS:
    the paths' launch checks derive it, _check_c1)."""
    from latentblending_tpu_torch import profiling

    return profiling.counter("C1") - _COUNTS_ZERO.get("C1", 0)


_C1_LAUNCHES: dict = {}  # a counted path's label -> C1's launches in it (the kernels line)


def _check_c1(be, counts: dict, c1: int, k2_per_eval: int, label: str) -> None:
    """C1 ran once for every stride-1 3x3 convolution of the f32 modules:
    C1_PER_DECODE a decode call of an f32 VAE (K3's launches; one more where
    the latents have 16 channels, SD3's, whose conv_in then takes C1) and
    C1_PER_UNET_EVAL an eval of an f32 UNet (K2 f32's over k2_per_eval),
    in the counted run and in the last run's report."""
    per_decode = C1_PER_DECODE + (be.dh.spec.vae.latent_channels % 8 == 0)
    want = per_decode * counts["K3"] + C1_PER_UNET_EVAL * counts["K2_f32"] // k2_per_eval
    in_report = be.last_report.counters.get("C1", 0)
    print(f"{label}: C1 launches {c1}, in the last run's report {in_report} (expected {want}: "
          f"{per_decode} x {counts['K3']} f32 decode calls + {C1_PER_UNET_EVAL} x "
          f"{counts['K2_f32'] // k2_per_eval} f32 UNet evals)", flush=True)
    if c1 != want or in_report != want:
        raise AssertionError(f"{label}: C1 launched {c1} times ({in_report} in the report), expected {want}")
    _C1_LAUNCHES[label] = c1


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _expected_launches(be, path: str, k2_per_eval: int, recycled: int = 0) -> dict:
    """The launches of each kernel one run_transition of `path` makes on
    the engine's plan: K1's tree step once per denoise step on the fused
    paths (a recycled edge 1 rides along as a window); on the per-level
    path slerp_rows once per step of each denoise call (the edges' unless
    both are recycled, then each round's) and once per round for the
    parental mix; K2 k2_per_eval times per denoiser eval, in its dtype
    (SD3's joint sequence, image patches + 77 CLIP + T5's tokens, is no
    multiple of 128, so its launches are K2_tail ones too; every SDXL UNet
    attention length is); K3 once per VAE decode call (decode_chunk
    keyframes each; a recycled edge's keyframe is still decoded), in the
    VAE's dtype; M1 6 L - 1 times per eval of an MMDiT of L blocks (its
    adaLN norms and gated residuals)."""
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
    else:
        rounds = [(int(idx), k) for idx, n in zip(be.list_idx_injection, be.list_nmb_stems)
                  for k in be._round_sizes(int(n))]
        edge_steps = 0 if recycled == 2 else N
        evals = edge_steps + sum(N - idx for idx, _ in rounds)
        out.update({"K1_rows": edge_steps + sum(N - idx + 1 for idx, _ in rounds), k2: evals * k2_per_eval,
                    k3: _ceil(2, dc) + sum(_ceil(k, dc) for _, k in rounds)})
    out["K2_tail"] = out["K2"] if hasattr(be.dh, "mmdit") else 0
    if hasattr(be.dh, "mmdit"):  # M1: 6 a block, 4 in the last, 1 in norm_out an MMDiT eval
        out["M1"] = out["K2"] // k2_per_eval * (6 * be.dh.mmdit.cfg.num_layers - 1)
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


def _check_trace(be, label: str) -> None:
    """The last transition's span tree on the card: every denoise step, VAE
    decode and similarity pass (and embed, where the transition took one)
    has its device interval; prints the tracer's per-transition numbers."""
    rep = be.last_report
    timed = [s for s in rep.spans if s.name in ("step", "vae.decode", "similarity.pass", "embed")]
    missing = sorted({s.name for s in timed if not (s.device_s or 0) > 0})
    if be.dh.device.type == "cuda" and (missing or not any(s.name == "step" for s in timed)):
        raise AssertionError(f"{label}: spans without a device interval: {missing}")
    steps = [s for s in timed if s.name == "step"]

    def total(name, attr):
        return sum(getattr(s, attr) or 0.0 for s in timed if s.name == name)

    print(f"{label}: tracer, transition {rep.transition_id}: host_syncs {rep.host_syncs}, "
          f"{len(steps)} steps at {1e3 * total('step', 'host_s') / max(1, len(steps)):.3f} ms host and "
          f"{1e3 * total('step', 'device_s') / max(1, len(steps)):.3f} ms device a step, decodes "
          f"{total('vae.decode', 'device_s'):.4f} s and similarity passes {total('similarity.pass', 'device_s'):.4f} s "
          f"of device time", flush=True)


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
    c1 = _c1_count()
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
    _check_trace(be, label)
    _check_c1(be, counts, c1, k2_per_eval, label)
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
    each path's launch counts, each path's warm wall and the per-level
    path's keyframes and tree_fracts (the distributed phase's reference)."""
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
    return ({"fused": fused["counts"], "per-level": per_level["counts"]},
            {"fused": fused["warm_s"], "per-level": per_level["warm_s"]},
            {"imgs": per_level["imgs"], "fracts": per_level["fracts"]})


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


def _check_jpeg_counts(counts: dict, j1: int, j1_frames: int, j3: int, frames: int, lerp_calls: int,
                       label: str) -> int:
    """The movie writer's JPEG launches: the quality probes P of the
    movie's first sample (calibrate_quality: one J1 and one J3 call of that
    frame alone each, the last probe's bytes the sample), then j1 J1 calls
    coding j1_frames frames (one a fetch chunk from the engine's device
    batches, one a keyframe read on the host, one a gap on the pixel path)
    and j3 J3 calls coding every other sample once (one a gap, and a later
    part's first keyframe), and lerp_calls J2 calls (one a gap;
    CoefFrames.lerp_many and the pixel path split a gap above
    MAX_CALL_COEF_BYTES, 170 frames at 512², which no movie here reaches).
    Returns P."""
    probes = counts["J3"] - j3
    want = {"J1": j1 + probes, "J1_frames": j1_frames + probes, "J2": lerp_calls, "J3_frames": frames - 1 + probes}
    if not 1 <= probes <= 8 or any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: JPEG launches {counts}, expected J3 {j3} + P and {want} with P = {probes} "
                             f"in 1..8")
    return probes


def _fetch_chunks(n_kf: int) -> int:
    """The engine's fetch chunks for n_kf keyframes of one fused transition."""
    return _ceil(n_kf, int(os.environ.get("LB_FETCH_CHUNK", "4")))


def _j1_ops(B: int, h: int, w: int, rgb: bool) -> int:
    """libjpeg's integer operations (each add, subtract, multiply, shift,
    compare or divide one) for B frames: a block's DCT rows (58 each) and
    columns (60 each), level shift (64) and quantize (5 a coefficient: abs,
    rounding add, divide, compare, sign), for the blocks libjpeg transforms
    (not the dummy ones); from RGB also rgb_ycc_convert (7 a component of a
    pixel) and h2v2_downsample (5 a chroma sample)."""
    my, mx = _ceil(h, 16), _ceil(w, 16)
    ops = (_ceil(h, 8) * _ceil(w, 8) + 2 * my * mx) * (8 * 58 + 8 * 60 + 64 + 64 * 5)
    if rgb:
        ops += h * w * 3 * 7 + 2 * (8 * my) * (8 * mx) * 5
    return B * ops


def _j1_case(torch, frames, quality: int, fmt: str, label: str) -> dict:
    """J1 on `frames` against its plain version (exactly, one launch coding
    every frame), then timed: device time (CUDA-graph replay), one call
    (CUDA events), the plain version (CUDA events), the bound (the larger
    of the bytes read and written over the memory rate and libjpeg's
    integer operations over PEAK_FLOPS["int32"]) and its share."""
    from latentblending_tpu_torch.profiling import counter
    from latentblending_tpu_torch.video import jpeg

    B = frames.shape[0]
    n, nf = counter("J1"), counter("J1_frames")
    coef = jpeg.fdct_quant(frames, quality, fmt)
    if (counter("J1"), counter("J1_frames")) != (n + 1, nf + B):
        raise AssertionError(f"J1 ({label}): {counter('J1') - n} calls of {counter('J1_frames') - nf} "
                             f"frames, expected 1 of {B}")
    err = _jpeg_exact(torch, f"J1 ({label})", coef, jpeg.fdct_quant_reference(frames, quality, fmt))
    h, w = (frames.shape[1] * 2 // 3, frames.shape[2]) if fmt == "i420" else tuple(frames.shape[1:3])
    case = {"shape": f"[{','.join(map(str, frames.shape))}] uint8 {fmt.upper()} -> [{B},{coef.shape[1]},64] int16 "
                     f"({label})", "max_abs_err": err,
            **_bound(frames.numel() + coef.numel() * 2, _j1_ops(B, h, w, fmt == "rgb"), "int32")}
    case["ms"] = _device_ms(torch, lambda: jpeg.fdct_quant(frames, quality, fmt))
    case["call_ms"] = _median_ms(torch, lambda: jpeg.fdct_quant(frames, quality, fmt))
    case["plain_ms"] = _median_ms(torch, lambda: jpeg.fdct_quant_reference(frames, quality, fmt), reps=5)
    case.update(library_ms=None, bound_us=case["bound_ms"] * 1e3, share_of_bound=case["bound_ms"] / case["ms"])
    print(f"J1 {case['shape']}: equal to its plain version; device {case['ms']:.5f} ms (CUDA-graph replay), one call "
          f"{case['call_ms']:.5f} ms, plain {case['plain_ms']:.5f} ms, bound {case['bound_us']:.3f} us "
          f"({case['bound_by']}: {case['bytes']} bytes, {case['flops']} integer operations), share "
          f"{case['share_of_bound']:.2%}", flush=True)
    return case


def _checkerboard(torch, shape: tuple, fmt: str, period: int, device: str):
    """0/255 checkerboard frames of `period` (all 0 or all 255 for period 0 / -1)."""
    if period <= 0:
        return torch.full(shape, 0 if period == 0 else 255, dtype=torch.uint8, device=device)
    yy = torch.arange(shape[1], device=device).reshape(-1, 1) // period
    xx = torch.arange(shape[2], device=device).reshape(1, -1) // period
    board = (((yy + xx) % 2) * 255).to(torch.uint8)
    board = board[..., None] if fmt == "rgb" else board
    return board.expand(shape).contiguous()


def j1_exact_cases(torch, device: str = "cuda") -> None:
    """J1 exactly against its plain version on frames made here, before the
    engine (a wrong J1 fails in seconds): noise at the movie path's batches
    ([1|4,768,512] I420: a keyframe and a fetch chunk; [12|34,512,512,3]
    RGB: write_imgs_transition's keyframes and a pixel gap) and at an odd
    size (I420 516x772, RGB 50x70); all-0, all-255 and 0/255 checkerboards
    of period 1 and 8 (the worst cases of the transform's odd terms) at
    512², 36x34 (I420) and 13x21 (RGB); each at q 1, 50, 90 and 100, one
    launch coding every frame."""
    from latentblending_tpu_torch import profiling
    from latentblending_tpu_torch.video import jpeg

    g = torch.Generator(device=device).manual_seed(14)
    cases = [((shape, fmt), torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8))
             for shape, fmt in [((1, 768, 512), "i420"), ((4, 768, 512), "i420"), ((12, 512, 512, 3), "rgb"),
                                ((34, 512, 512, 3), "rgb"), ((2, 774, 772), "i420"), ((2, 50, 70, 3), "rgb")]]
    for period in (0, -1, 1, 8):
        for shape, fmt in [((2, 768, 512), "i420"), ((2, 512, 512, 3), "rgb"), ((2, 54, 34), "i420"),
                           ((2, 13, 21, 3), "rgb")]:
            cases.append(((shape, fmt), _checkerboard(torch, shape, fmt, period, device)))
    for (shape, fmt), frames in cases:
        for q in (1, 50, 90, 100):
            n, nf = profiling.counter("J1"), profiling.counter("J1_frames")
            got = jpeg.fdct_quant(frames, q, fmt)
            if (profiling.counter("J1"), profiling.counter("J1_frames")) != (n + 1, nf + shape[0]):
                raise AssertionError(f"J1 {shape} {fmt}: not one launch of {shape[0]} frames")
            _jpeg_exact(torch, f"J1 {list(shape)} {fmt} q{q}", got, jpeg.fdct_quant_reference(frames, q, fmt))
    print(f"J1 against its plain version, exactly, on {len(cases)} inputs x 4 qualities (noise at "
          f"[1|4,768,512] I420, [12|34,512,512,3] RGB, I420 516x772, RGB 50x70; 0, 255 and checkerboards of "
          f"period 1 and 8 at 512², I420 36x34, RGB 13x21): all equal, one launch a call", flush=True)


def _jpeg_exact(torch, label: str, got, want) -> int:
    """Kernel against plain version, exactly; returns the max abs error (0)."""
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{label}: kernel differs from its plain version")
    return 0


def _peak_bytes(torch, fn) -> tuple:
    """fn's result and the device bytes its call held at its peak above
    what was allocated before it: (result, max_memory_allocated bytes,
    requested bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base, req0 = torch.cuda.memory_allocated(), torch.cuda.memory_stats()["requested_bytes.all.current"]
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base, torch.cuda.memory_stats()["requested_bytes.all.peak"] - req0


def _j3_times(torch, coef, plain_s: float) -> dict:
    """J3 on coef [F, n, 64]: device time of its device half by CUDA-graph
    replay (plan known, no host read), one call with its two host syncs and
    the copy to pinned memory (CUDA events), ms a frame, the plain coder's
    time (host clock, measured by the caller), the bound (coefficients read
    and scans written once over 3.35 TB/s) and its share."""
    from latentblending_tpu_torch.video import jpeg

    scans = jpeg.huffman_scan_batch(coef)
    plan = jpeg.huffman_scan_device(coef)[2]  # read once: the graph's calls take it and read nothing
    case = {"F": coef.shape[0], "scan_bytes": sum(map(len, scans)),
            **_bound(coef.numel() * 2 + sum(map(len, scans)), 0, "bf16")}
    case["ms"] = _device_ms(torch, lambda: jpeg._huffman_scan_replay(coef, plan))
    case["call_ms"] = _median_ms(torch, lambda: jpeg.huffman_scan_batch(coef))
    case.update(ms_a_frame=case["call_ms"] / case["F"], plain_ms=plain_s * 1e3, library_ms=None,
                bound_us=case["bound_ms"] * 1e3, share_of_bound=case["bound_ms"] / case["ms"])
    return case


def _jpeg_kernel_checks(torch, be, samples: list, quality: int, target: int) -> dict:
    """J1-J3 on the movie's first gap: J1 on its first keyframe and on its
    first fetch chunk (the I420 planes the engine codes) against its plain
    version, timed (_j1_case); batched J2 on all
    the gap's fractions against its plain version; batched J3 on the gap's
    in-between frames and keyframe 1, as the writer codes them, against the
    plain coder on every frame and against the file's samples; J3 on
    keyframe 0 alone against sample 0. Then the kernels' times (device time
    by CUDA-graph replay, J2 and J3 at F = 1 and at the gap's F; one call
    by CUDA events, J3's with its host reads; the plain coder by the host
    clock) and ms a frame for keyframe encodes (J1+J3) and for the gap
    (CoefFrames.lerp_many, J2+J3, the next keyframe's sample included)."""
    import numpy as np

    from latentblending_tpu_torch.ops.schedules import frame_insert_counts
    from latentblending_tpu_torch.video import jpeg

    H, W = be.dh.height_img, be.dh.width_img
    chunk = int(os.environ.get("LB_FETCH_CHUNK", "4"))
    planes = be.dh.to_i420_device(torch.stack(be._imgs_dev[:chunk])).contiguous()
    j1 = [_j1_case(torch, planes[:1], quality, "i420", "keyframe 0"),
          _j1_case(torch, planes, quality, "i420", "the first fetch chunk")]
    coef = jpeg.fdct_quant(planes[:2], quality)
    gap = frame_insert_counts(len(be._imgs_dev), target)[0]
    fracts = [float(f) for f in np.linspace(0, 1, gap + 2)[1:]]  # the writer's: t = 1 is keyframe 1
    batch = jpeg.coef_lerp_batch(coef[0], coef[1], fracts)  # samples 1 .. gap + 1, as the writer codes them
    j2_err = _jpeg_exact(torch, f"J2 at the gap's {gap + 1} fractions", batch,
                         jpeg.coef_lerp_batch_reference(coef[0], coef[1], fracts))
    _jpeg_exact(torch, "J2 at t = 1 against keyframe 1", batch[-1], coef[1])
    scans = jpeg.huffman_scan_batch(batch)
    t0 = time.perf_counter()
    want = [jpeg.huffman_scan_reference(c) for c in batch]
    plain_batch_s = time.perf_counter() - t0
    header = jpeg.jfif_header(H, W, quality)
    for f, (scan, w) in enumerate(zip(scans, want)):
        if scan != w:
            raise AssertionError(f"J3: gap 0's frame {f} (sample {f + 1}) differs from the plain coder's")
        if samples[f + 1] != header + scan + jpeg.EOI:
            raise AssertionError(f"movie sample {f + 1} is not the batched kernels' bytes for its frame")
    one = coef[:1].contiguous()
    t0 = time.perf_counter()
    want0 = jpeg.huffman_scan_reference(one[0])
    plain_one_s = time.perf_counter() - t0
    if jpeg.huffman_scan_batch(one) != [want0] or samples[0] != header + want0 + jpeg.EOI:
        raise AssertionError("J3: keyframe 0 differs from the plain coder's or from sample 0")
    print(f"movie kernels vs plain: J1 on keyframe 0 and on the first fetch chunk [{chunk},{H * 3 // 2},{W}] "
          f"q{quality}; J2 batched on gap 0's "
          f"{gap + 1} fractions (t = 1 equal to keyframe 1); J3 batched on gap 0 ([{gap + 1},{coef.shape[1]},64]: {gap} in-between frames and "
          f"keyframe 1) against the plain coder on all {gap + 1} frames and the file's samples 1..{gap + 1}; J3 on "
          f"keyframe 0 against sample 0: all equal", flush=True)

    coef_bytes = coef[0].numel() * 2
    j2 = {}
    for F in (gap + 1, 1):
        ts = fracts[:F]
        c = j2[F] = {"F": F, "shape": f"2 x [{coef.shape[1]},64] int16 -> [{F},{coef.shape[1]},64] (batched)",
                     "max_abs_err": j2_err, **_bound((2 + F) * coef_bytes, 0, "bf16")}
        c["ms"] = _device_ms(torch, lambda: jpeg.coef_lerp_batch(coef[0], coef[1], ts))
        c["call_ms"] = _median_ms(torch, lambda: jpeg.coef_lerp_batch(coef[0], coef[1], ts))
        c["plain_ms"] = _median_ms(torch, lambda: jpeg.coef_lerp_batch_reference(coef[0], coef[1], ts), reps=5)
        c.update(ms_a_frame=c["call_ms"] / F, library_ms=None, bound_us=c["bound_ms"] * 1e3,
                 share_of_bound=c["bound_ms"] / c["ms"])
    j3 = {gap + 1: _j3_times(torch, batch, plain_batch_s), 1: _j3_times(torch, one, plain_one_s)}
    j3[gap + 1]["shape"] = f"[{gap + 1},{coef.shape[1]},64] int16 -> {j3[gap + 1]['scan_bytes']} bytes (gap 0, batched)"
    j3[1]["shape"] = f"[1,{coef.shape[1]},64] int16 -> {j3[1]['scan_bytes']} bytes (keyframe 0)"
    for c in j3.values():
        c["max_abs_err"] = 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            jpeg.huffman_scan_batch(batch)
        torch.cuda.synchronize()
    kernels = {name: (round(ms / calls, 5), calls) for name, (ms, calls) in _device_kernels(torch, prof)[1].items()}
    print(f"J3 F={gap + 1} by kernel (torch.profiler over 3 calls: ms a launch, launches seen): {json.dumps(kernels)}",
          flush=True)
    pair = jpeg.CoefFrames(coef[0], coef[1], H, W, quality)
    per_frame = {"keyframe (J1+J3)": _median_ms(torch, lambda: jpeg.encode_coefs(jpeg.fdct_quant(planes[:1], quality)[0],
                                                                                  H, W, quality)),
                 f"gap of {gap} + keyframe (J2+J3, lerp_many), a frame":
                     _median_ms(torch, lambda: pair.lerp_many(fracts), reps=10) / (gap + 1)}
    for name, case in [(f"J2 F={F}", c) for F, c in j2.items()] + [(f"J3 F={F}", c) for F, c in j3.items()]:
        print(f"{name} {case['shape']}: device {case['ms']:.5f} ms (CUDA-graph replay), one call "
              f"{case['call_ms']:.5f} ms" + (f" ({case['ms_a_frame']:.5f} a frame)" if "ms_a_frame" in case else "")
              + f", plain {case['plain_ms']:.5f} ms, bound {case['bound_us']:.3f} us ({case['bound_by']}), share "
              f"{case['share_of_bound']:.2%}", flush=True)
    print(f"movie ms a frame at {H}x{W} (CUDA events, host reads included): {json.dumps(per_frame)}", flush=True)
    return {"J1": j1, "J2": [j2[gap + 1], j2[1]], "J3": [j3[gap + 1], j3[1]]}


def _j3_stress(torch, cases=(((512, 512), 33), ((1024, 1024), 8))) -> None:
    """J3 on batches of noise frames (I420 noise at q 90: long scans, many
    0xFF bytes to stuff): 512² at F = 33 and 1024² at F = 8, each against
    per-frame calls of the kernels and the plain coder on its first and
    last frames, with the call's peak device bytes above what was held
    before it."""
    import numpy as np

    from latentblending_tpu_torch.video import jpeg

    rng = np.random.default_rng(13)
    for (h, w), F in cases:
        frames = torch.from_numpy(rng.integers(0, 256, (F, h * 3 // 2, w), dtype=np.uint8)).cuda()
        coef = jpeg.fdct_quant(frames, 90)
        del frames
        scans, peak, req = _peak_bytes(torch, lambda: jpeg.huffman_scan_batch(coef))
        if scans != [jpeg.huffman_scan(c) for c in coef]:
            raise AssertionError(f"J3 stress {h}x{w} F={F}: the batch differs from per-frame calls")
        for f in (0, F - 1):
            if scans[f] != jpeg.huffman_scan_reference(coef[f]):
                raise AssertionError(f"J3 stress {h}x{w} F={F}: frame {f} differs from the plain coder's")
        nbytes = sum(map(len, scans))
        print(f"J3 stress {h}x{w} noise F={F}: {nbytes} scan bytes ({sum(x.count(bytes([255, 0])) for x in scans)} "
              f"stuffed 0xFF), equal to per-frame calls and to the plain coder on frames 0 and {F - 1}; peak device "
              f"bytes of the call {peak} (requested {req}) beside {coef.numel() * 2} of coefficients", flush=True)


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
    from latentblending_tpu_torch.video.frames import stream_gaps_device

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
        trans_phases = {k: v["total_s"] for k, v in be.last_report.phases.items()}

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
            _check_transition(be, imgs, {**c, **{k: 0 for k in _COUNT_KEYS if k[0] == "J"}}, "fused", k2,
                              f"movie ({run})")
            n_kf = len(be.tree_final_imgs)
            # J1 once a fetch chunk, on the engine's device batch (no upload)
            probes = _check_jpeg_counts(c, _fetch_chunks(n_kf), n_kf, n_kf - 1, target, n_kf - 1, f"movie ({run})")
            if run == "cold":
                counts["movie (run_movie_transition)"] = c
        if be.last_writer_backend != "mjpeg+coef-lerp":
            raise AssertionError(f"movie: backend {be.last_writer_backend}, expected mjpeg+coef-lerp")
        q = be.last_jpeg_quality
        samples = _movie_samples(fp, target, (H, W), MOVIE_FPS, "movie")
        phases = {k: v["total_s"] for k, v in be.last_report.phases.items()}
        print(f"movie: run_movie_transition {MOVIE_SECONDS} s at {MOVIE_FPS} fps, {len(samples)} samples of "
              f"{H}x{W} ({os.path.getsize(fp)} bytes), backend {be.last_writer_backend}, settled quality {q} "
              f"({probes} probe encodes), cold wall {walls[0]:.4f} s, warm wall {walls[1]:.4f} s beside "
              f"run_transition's warm wall {trans_warm:.4f} s (movie - transition, warm: "
              f"{walls[1] - trans_warm:.4f} s); warm phases (s): movie {json.dumps(phases)}, transition "
              f"{json.dumps(trans_phases)}; "
              f"launches (cold) {json.dumps(counts['movie (run_movie_transition)'])}", flush=True)
        kres = _jpeg_kernel_checks(torch, be, samples, q, target)
        _j3_stress(torch)

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
            ins = frame_insert_counts(n_kf, rgb_target)
            if pixel:  # J1 and J3 once a gap: its in-between frames and the next keyframe
                _check_jpeg_counts(c, n_kf - 1, rgb_target - 1, n_kf - 1, rgb_target, 0, label)
            else:  # the keyframes are on the host: J1 once a keyframe after keyframe 0's probes
                _check_jpeg_counts(c, n_kf - 1, n_kf - 1, n_kf - 1, rgb_target, n_kf - 1, label)
            if c["J1_rgb"] != c["J1"]:
                raise AssertionError(f"{label}: every J1 launch should take the RGB route, got {c}")
            s2 = _movie_samples(fp2, rgb_target, (H, W), MOVIE_FPS, label)
            q2 = be.last_jpeg_quality
            header = jpeg.jfif_header(H, W, q2)
            if pixel:
                # the largest gap's batch, lerped on the card as the writer lerps it, against the plain J1 and
                # the file's samples
                g = max(range(n_kf - 1), key=lambda i: ins[i])
                gap = list(stream_gaps_device(be.tree_final_imgs[g:g + 2], ins[g] + 2, lambda im: im,
                                              be.dh.device, ins[g] + 1))[1].contiguous()
                kres_pixel = _j1_case(torch, gap, q2, "rgb", f"the pixel movie's largest gap, {g}")
                got = jpeg.fdct_quant(gap, q2, "rgb")
                idx = 1 + sum(ins[i] + 1 for i in range(g))
                if s2[idx:idx + len(gap)] != [header + x + jpeg.EOI for x in jpeg.huffman_scan_batch(got)]:
                    raise AssertionError(f"{label}: samples {idx}..{idx + len(gap) - 1} are not the kernels' bytes "
                                         f"for gap {g}")
                what = f"samples {idx}..{idx + len(gap) - 1} (gap {g}, {len(gap)} frames)"
            else:
                frame = torch.from_numpy(be.tree_final_imgs[0]).to(be.dh.device)[None].contiguous()
                got = jpeg.fdct_quant(frame, q2, "rgb")
                _jpeg_exact(torch, f"{label}: J1 (RGB)", got, jpeg.fdct_quant_reference(frame, q2, "rgb"))
                # J3 against its plain coder ran on the movie's frames (4 at most at 512²: it is slow)
                if s2[0] != header + jpeg.huffman_scan(got[0]) + jpeg.EOI:
                    raise AssertionError(f"{label}: sample 0 is not the kernels' bytes for its frame")
                what = "sample 0"
            print(f"{label}: {len(s2)} samples in {wall:.4f} s, backend {be.last_writer_backend}, quality {q2}, "
                  f"{what}: J1 (RGB) equals its plain version and the file the kernels' bytes; "
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
        n_kf = len(be.tree_final_imgs)
        # each part's keyframes from its device batches, a fetch chunk a J1 call; the second part's
        # first keyframe is coded alone by J3 (the quality settled in the first part)
        _check_jpeg_counts(c, 2 * _fetch_chunks(n_kf), 2 * n_kf, 2 * (n_kf - 1) + 1, len(s4), 2 * (n_kf - 1),
                           "run_multi_transition")
        if be.last_writer_backend != "mjpeg+coef-lerp":
            raise AssertionError(f"run_multi_transition: backend {be.last_writer_backend}")
        print(f"run_multi_transition: 3 keyframes, 2 parts of {2 * MOVIE_FPS} frames -> {len(s4)} samples in "
              f"{wall:.4f} s, backend {be.last_writer_backend}, launches {json.dumps(c)}", flush=True)
    if old_coef is not None:
        os.environ["LB_COEF_LERP"] = old_coef
    kres["J1_rgb"] = [kres_pixel]
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
       directory: J1 (RGB route) once, J3 once for all keyframes, each file from
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
        want_c.update({"J1": 1, "J1_rgb": 1, "J1_frames": n_kf, "J3": 1, "J3_frames": n_kf})
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
    j1 = _j1_case(torch, frames.contiguous(), 75, "rgb", f"write_imgs_transition's {n_kf} keyframes")

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
            # run_transition resolved the keyframes: J1 once a keyframe read on the host
            _check_jpeg_counts(c, n_kf - 1, n_kf - 1, n_kf - 1, 2 * MOVIE_FPS, n_kf - 1, "example_single_trans")
            samples = _movie_samples(out, 2 * MOVIE_FPS, (H, W), MOVIE_FPS, "example_single_trans")
            print(f"example_single_trans --snapshot (from_pretrained, run_transition, write_movie_transition 2 s): "
                  f"{len(samples)} samples in {app_s:.3f} s, {n_kf} keyframes, launches {json.dumps(c)}", flush=True)
            del app
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"counts": counts, "kres": {"J1_rgb": [j1]}}


# serving_phase: the decoded movie's first and last frames against the
# engine's first and last RGB keyframes, PSNR in dB. The samples are J1/J3's
# JPEGs of the keyframes' I420 planes at the settled quality (55-90): chroma
# subsampling and quantization, nothing else, lie between them. Tiny-turbo's
# noise-like keyframes on the CPU: 24.7 dB at 128x128, against 9.8 dB for
# the first frame beside the last keyframe; SDXL-Turbo's random-weight
# keyframes on the H100 (quality settled at 62): 22.3 dB against 9.9. So
# each end must reach the bound and beat the other end's keyframe by
# SERVING_PSNR_MARGIN_DB.
SERVING_PSNR_DB = 20.0
SERVING_PSNR_MARGIN_DB = 6.0
SERVING_PREVIEWS = 4
SERVING_SECONDS = 2
LPIPS_CHUNK_PAIRS = 9


def _http(base: str, path: str, payload=None, raw: bytes | None = None) -> tuple:
    """(status, body bytes, content type) of a GET (payload and raw None) or
    a POST to the local server, straight, never through a proxy."""
    import urllib.error
    import urllib.request

    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    data = raw if raw is not None else (None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with opener.open(req, timeout=600) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


def _http_json(base: str, path: str, payload=None, want: int = 200) -> dict:
    status, body, _ = _http(base, path, payload)
    if status != want:
        raise AssertionError(f"serving: {path} {payload} answered {status}, expected {want}: {body[:300]!r}")
    return json.loads(body)


def _psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _fetch_jpegs(base: str, urls: list, hw: tuple, label: str) -> list:
    """Each URL fetched over /files/ and decoded by the port's decoder to
    uint8 [H, W, 3]; returns the host ms of each decode."""
    from latentblending_tpu_torch.video import jpeg_decode

    ms = []
    for url in urls:
        status, body, ctype = _http(base, url)
        if status != 200 or ctype != "image/jpeg":
            raise AssertionError(f"{label}: {url} answered {status} {ctype}")
        t0 = time.perf_counter()
        img = jpeg_decode.decode(body)
        ms.append((time.perf_counter() - t0) * 1e3)
        if img.shape != (*hw, 3) or str(img.dtype) != "uint8":
            raise AssertionError(f"{label}: {url} decodes to {img.shape} {img.dtype}")
    return ms


def serving_phase(torch, be) -> dict:
    """The serving path over HTTP at full width, on the SDXL-Turbo 512²
    engine of the main path (random weights, bf16 UNet, f32 VAE):
    latentblending_tpu_torch.apps.server.serve(router, port=0) on 127.0.0.1
    over MultiUserRouter({"sdxl-turbo": engine}, nmb_preview_images=4).
    1. /health; /session at 512x512;
    2. /previews cold and warm, counted (sequential requests): K1 slerp_rows
       once per step, K2 steps x 10, K3 once per decode chunk (the
       previews' batched denoise and decode), J1 once (its RGB route, the 4
       previews in one call), J3 once (the 4 files in one call); each of
       the 4 files fetched
       over /files/<token> and decoded by the port's decoder to
       [512,512,3] uint8;
    3. /select and /keyframe twice (new previews between), then /movie with
       t_per_segment=2, counted and then again warm: K1-K3 as the fused
       transition launches them (LB_FUSED=1), J1 and J3 per keyframe plus
       the quality probes (one J3 call for the gap and the last keyframe),
       J2 once per gap; the MP4
       fetched, round(2 x 30) frames read back by read_movie_frames, the
       first and last at SERVING_PSNR_DB or more against the engine's first
       and last keyframes, and SERVING_PSNR_MARGIN_DB above the other end's;
       host ms a decoded frame;
    4. two users' /previews sent at once from two threads: both 200 with 4
       decodable JPEGs, and every decode output on the handler threads
       without a grad_fn (grad mode is thread-local);
    5. each malformed body gets 400, an unknown /files/ token 403;
    6. LPIPS on 9 pairs at 1024² (seeded random weights): the pairs reach
       the model in calls of at most 4; peak requested bytes above those
       held before, beside PR 10's unchunked 8.45 GB, and the pass's time.
    Prints the warm /previews and /movie walls (host clock) and the phase's
    peak memory. Returns the launch counts of each counted request."""
    import shutil
    import tempfile
    import threading

    import numpy as np

    from latentblending_tpu_torch.apps.gradio_ui import MultiUserRouter
    from latentblending_tpu_torch.apps.server import serve
    from latentblending_tpu_torch.models.lpips import LPIPSScorer, random_lpips_state_dict
    from latentblending_tpu_torch.video.writer import read_movie_frames

    dh = be.dh
    H, W = dh.height_img, dh.width_img
    N = dh.num_inference_steps
    k2 = K2_PER_EVAL[H]
    counts: dict = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    workdir = tempfile.mkdtemp(prefix="lb_serve_")
    cwd = os.getcwd()
    os.chdir(workdir)  # the router writes its movies and project files here
    router = MultiUserRouter({"sdxl-turbo": be}, nmb_preview_images=SERVING_PREVIEWS)
    np.random.seed(12)  # the router draws the preview seeds from numpy's global generator
    httpd = serve(router, port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        health = _http_json(base, "/health")
        if health != {"ok": True, "models": ["sdxl-turbo"]}:
            raise AssertionError(f"serving: /health {health}")
        uid = _http_json(base, "/session", {"model": "sdxl-turbo", "width": W, "height": H})["user_id"]

        # ---- previews, counted, cold and warm
        want_prev = dict.fromkeys(_COUNT_KEYS, 0)
        want_prev.update({"K1_rows": N, "K2": N * k2, "K3": _ceil(SERVING_PREVIEWS, dh.decode_chunk),
                          "J1": 1, "J1_rgb": 1, "J1_frames": SERVING_PREVIEWS, "J3": 1,
                          "J3_frames": SERVING_PREVIEWS})
        prev_walls, decode_ms = [], []
        for run in ("cold", "warm"):
            _zero_counts()
            t0 = time.perf_counter()
            r = _http_json(base, "/previews", {"user_id": uid, "prompt": "photo of a lighthouse in a storm",
                                               "negative_prompt": "blurry, low quality"})
            prev_walls.append(time.perf_counter() - t0)
            c = counts[f"serving /previews ({run})"] = _read_counts()
            _expect_counts(c, want_prev, f"serving /previews ({run})")
            if len(r["images"]) != SERVING_PREVIEWS:
                raise AssertionError(f"serving: /previews gave {r['images']}")
            decode_ms += _fetch_jpegs(base, r["images"], (H, W), f"serving /previews ({run})")
        print(f"serving /previews ({SERVING_PREVIEWS} at {H}x{W}): walls cold {prev_walls[0]:.4f} s, warm "
              f"{prev_walls[1]:.4f} s (host clock, request to response); launches {json.dumps(c)} (as expected); "
              f"each file decoded by the port's decoder, {np.mean(decode_ms):.2f} ms a preview", flush=True)

        # ---- two keyframes, then the movie
        _http_json(base, "/select", {"user_id": uid, "index": 0})
        _http_json(base, "/keyframe", {"user_id": uid})
        _http_json(base, "/previews", {"user_id": uid, "prompt": "photo of a calm sea at dawn, soft light",
                                       "negative_prompt": "blurry, low quality"})
        _http_json(base, "/select", {"user_id": uid, "index": 2})
        if len(_http_json(base, "/keyframe", {"user_id": uid})["movie"]) != 2:
            raise AssertionError("serving: /keyframe did not give 2 keyframes")
        target = int(round(SERVING_SECONDS * MOVIE_FPS))
        movie_walls = []
        with _lb_fused("1"):
            for run in ("cold", "warm"):
                _zero_counts()
                t0 = time.perf_counter()
                r = _http_json(base, "/movie", {"user_id": uid, "t_per_segment": SERVING_SECONDS})
                movie_walls.append(time.perf_counter() - t0)
                c = _read_counts()
                if run == "cold":
                    counts["serving /movie"] = c
                k_want = _expected_launches(be, "fused", k2)
                kk = [k for k in _COUNT_KEYS if k[0] == "K"]
                _expect_counts({k: c[k] for k in kk}, {k: k_want[k] for k in kk}, f"serving /movie ({run}, K1-K3)")
                n_kf = len(be.tree_final_imgs)
                probes = _check_jpeg_counts(c, _fetch_chunks(n_kf), n_kf, n_kf - 1, target, n_kf - 1,
                                            f"serving /movie ({run})")
        status, mp4, ctype = _http(base, r["movie_url"])
        if status != 200 or ctype != "video/mp4" or r["json_url"] is None:
            raise AssertionError(f"serving: movie {status} {ctype}, project {r['json_url']}")
        fp = os.path.join(workdir, "served.mp4")
        with open(fp, "wb") as f:
            f.write(mp4)
        t0 = time.perf_counter()
        frames = read_movie_frames(fp)
        read_s = time.perf_counter() - t0
        if len(frames) != target or any(f.shape != (H, W, 3) for f in frames):
            raise AssertionError(f"serving: read_movie_frames gave {len(frames)} frames, expected {target}")
        kfs = be.tree_final_imgs
        psnr = {"first": _psnr(frames[0], kfs[0]), "last": _psnr(frames[-1], kfs[-1]),
                "first vs last keyframe": _psnr(frames[0], kfs[-1])}
        psnr["last vs first keyframe"] = _psnr(frames[-1], kfs[0])
        if (min(psnr["first"], psnr["last"]) < SERVING_PSNR_DB
                or psnr["first"] < psnr["first vs last keyframe"] + SERVING_PSNR_MARGIN_DB
                or psnr["last"] < psnr["last vs first keyframe"] + SERVING_PSNR_MARGIN_DB):
            raise AssertionError(f"serving: movie ends against the keyframes {psnr} (bound {SERVING_PSNR_DB} dB, "
                                 f"margin {SERVING_PSNR_MARGIN_DB} dB)")
        print(f"serving /movie (2 keyframes, t_per_segment {SERVING_SECONDS}): walls cold {movie_walls[0]:.4f} s, "
              f"warm {movie_walls[1]:.4f} s (host clock); {len(mp4)} bytes, settled quality "
              f"{be.last_jpeg_quality} ({probes} probes), launches {json.dumps(counts['serving /movie'])} (as "
              f"expected); read_movie_frames: {len(frames)} frames in {read_s:.3f} s, "
              f"{read_s / len(frames) * 1e3:.2f} ms a frame (host); PSNR dB {json.dumps(psnr)} "
              f"(bound {SERVING_PSNR_DB}, margin {SERVING_PSNR_MARGIN_DB})", flush=True)

        # ---- two users at once
        users = [_http_json(base, "/session", {"width": W, "height": H})["user_id"] for _ in range(2)]
        seen, lock = [], threading.Lock()
        decode = dh.decode_to_pm1_batched

        def watched(latents):
            out = decode(latents)
            with lock:
                seen.append((threading.current_thread().name, torch.is_grad_enabled(), out.grad_fn is None,
                             out.requires_grad))
            return out

        dh.decode_to_pm1_batched = watched
        results: dict = {}

        def ask(u):
            results[u] = _http(base, "/previews", {"user_id": u, "prompt": f"photo of a garden, user {u}"})

        try:
            threads = [threading.Thread(target=ask, args=(u,), name=f"client-{u}") for u in users]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            both_s = time.perf_counter() - t0
        finally:
            del dh.decode_to_pm1_batched
        for u in users:
            status, body, _ = results[u]
            if status != 200:
                raise AssertionError(f"serving: concurrent /previews for {u}: {status} {body[:200]!r}")
            _fetch_jpegs(base, json.loads(body)["images"], (H, W), "serving concurrent /previews")
        if len(seen) != 2 or not all(no_fn and not req for _, _, no_fn, req in seen):
            raise AssertionError(f"serving: decodes on the handler threads {seen}")
        print(f"serving: 2 users' /previews at once: both 200 with {SERVING_PREVIEWS} decodable JPEGs in "
              f"{both_s:.4f} s; decodes on the handler threads (thread, grad enabled, no grad_fn, requires_grad): "
              f"{seen}", flush=True)

        # ---- malformed requests and unknown tokens
        bad = [("/previews", b'"x"'), ("/previews", b"[1]"), ("/previews", b"3"), ("/previews", b"{x"),
               ("/previews", {"user_id": 5}), ("/select", {"user_id": uid}), ("/select", {"user_id": uid, "index": "0"}),
               ("/session", {"width": "512"}), ("/session", {"height": [1]}),
               ("/movie", {"user_id": uid, "t_per_segment": "2"}),
               ("/reorder", {"user_id": uid, "index": 0, "direction": "up"})]
        codes = []
        for path, body in bad:
            if isinstance(body, bytes):
                codes.append(_http(base, path, raw=body)[0])
            else:
                codes.append(_http(base, path, body)[0])
        forbidden = _http(base, "/files/not-a-token")[0]
        if set(codes) != {400} or forbidden != 403:
            raise AssertionError(f"serving: malformed requests gave {codes}, an unknown token {forbidden}")
        print(f"serving: {len(bad)} malformed requests each 400, an unknown /files/ token 403", flush=True)
        torch.cuda.synchronize()
        stats = torch.cuda.memory_stats()
        print(f"serving peak memory: max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, requested "
              f"peak {stats['requested_bytes.all.peak']} bytes", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        os.chdir(cwd)
        shutil.rmtree(workdir, ignore_errors=True)

    # ---- LPIPS at 1024², now in chunks of at most 4 pairs
    scorer = LPIPSScorer(params=random_lpips_state_dict(seed=5), device=dh.device)
    model, batches = scorer.model, []

    def counted(a, b):
        batches.append(a.shape[0])
        return model(a, b)

    scorer.model = counted
    g = torch.Generator(device=dh.device).manual_seed(11)
    xa = torch.rand((LPIPS_CHUNK_PAIRS, 1024, 1024, 3), generator=g, device=dh.device) * 2 - 1
    xb = torch.rand((LPIPS_CHUNK_PAIRS, 1024, 1024, 3), generator=g, device=dh.device) * 2 - 1
    scorer.distance_batch(xa, xb)  # first call: algorithm choice, allocator growth
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    torch.cuda.reset_peak_memory_stats()
    batches.clear()
    d = scorer.distance_batch(xa, xb)
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before
    pass_batches = list(batches)  # the timed passes below append to `batches` too
    if max(pass_batches) > 4 or sum(pass_batches) != LPIPS_CHUNK_PAIRS or not bool(torch.isfinite(d).all()):
        raise AssertionError(f"serving: LPIPS pair batches {pass_batches}, distances {d}")
    ms = _median_ms(torch, lambda: scorer.distance_batch(xa, xb), reps=5, warmup=1)
    # one model call at each batch size: does the peak follow the pairs?
    by_batch = {}
    for nb in (1, 2, 4):
        model(xa[:nb], xb[:nb])
        torch.cuda.synchronize()
        before_nb = torch.cuda.memory_stats()["requested_bytes.all.current"]
        torch.cuda.reset_peak_memory_stats()
        model(xa[:nb], xb[:nb])
        torch.cuda.synchronize()
        by_batch[nb] = torch.cuda.memory_stats()["requested_bytes.all.peak"] - before_nb
    print(f"lpips {LPIPS_CHUNK_PAIRS} pairs at 1024x1024 in model calls of {pass_batches} pairs (largest "
          f"{max(pass_batches)}): peak requested {peak} bytes above those held before ({peak / 1e9:.3f} GB; PR 10's "
          f"unchunked call: 8.45 GB), {ms:.3f} ms a pass (CUDA events); one model call's peak above those held "
          f"before, by pairs: {json.dumps(by_batch)}", flush=True)
    del xa, xb, scorer, model
    torch.cuda.empty_cache()
    return counts


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


SD3_PLAN = ([14, 18, 22, 26], [1, 1, 1, 1])


def sd3_phase(torch) -> dict:
    """SD3.5-Large 1024² at full width (all 38 MMDiT blocks, T5-XXL, both
    CLIP towers, the 16-channel f32 VAE; random weights from seed 0) through
    BlendingEngine under the predictive policy, as the benchmark's
    sd35l1024.predictive cell runs it: set_branching(depth_strength=0.5,
    nmb_max_branches=6) at 28 steps gives the plan [14,18,22,26] x
    [1,1,1,1] on the segmented fused-multi path. Counted, then warm: K1's
    tree step once a step on [2..6,128,128,16] rows, K2 and K2_tail once a
    block and eval at the joint length 4429 (CFG batches 4 to 12), K3 once
    and C1 32 times a decode call. Returns the path's launches."""
    from latentblending_tpu_torch.engine.blending import BlendingEngine
    from latentblending_tpu_torch.runtime.holder import SD3Holder

    t0 = time.perf_counter()
    dh = SD3Holder.from_random("sd35-large", seed=0, dtype=torch.bfloat16, device="cuda")
    be = BlendingEngine(dh, run_benchmark=False)
    torch.cuda.synchronize()
    n_mmdit, n_t5 = (sum(p.numel() for p in m.parameters()) for m in (dh.mmdit, dh.t5))
    print(f"setup: SD3.5-Large holder (MMDiT {n_mmdit} params bf16, T5 encoder {n_t5} bf16, CLIP-L + bigG and "
          f"the VAE f32) and engine in {time.perf_counter() - t0:.3f} s; allocated "
          f"{torch.cuda.memory_allocated()} bytes", flush=True)
    if (n_mmdit, n_t5) != (8_056_627_520, 4_762_310_656):
        raise AssertionError(f"SD3.5-Large: MMDiT {n_mmdit} and T5 {n_t5} parameters, not 8056627520 and 4762310656")
    be.set_negative_prompt("blurry, low quality")  # read by the next embeddings
    be.set_prompt1("photo of a forest at dawn, mist between the trees")
    be.set_prompt2("photo of a city at night, neon lights in the rain")
    be.set_branching(depth_strength=0.5, nmb_max_branches=6)
    be.placement_policy = "predictive"
    plan = (list(be.list_idx_injection), list(be.list_nmb_stems))
    print(f"SD3.5-Large plan {plan}, guidance {be.guidance_scale_base} (CFG), {be.num_inference_steps} steps",
          flush=True)
    if plan != SD3_PLAN:
        raise AssertionError(f"SD3.5-Large plan {plan}, expected {SD3_PLAN}")
    label = "SD3.5-Large predictive, fused-multi"
    run = _drive_path(torch, be, "fused-multi", label, dh.mmdit.cfg.num_layers)
    in_report = be.last_report.counters.get("M1", 0)
    print(f"{label}: M1 launches {run['counts']['M1']} ({6 * dh.mmdit.cfg.num_layers - 1} an MMDiT call), in the "
          f"last run's report {in_report}", flush=True)
    if in_report != run["counts"]["M1"]:
        raise AssertionError(f"{label}: M1 {in_report} in the report, {run['counts']['M1']} counted")
    return {label: run["counts"]}


# The two-rank meshes' keyframes against the unsharded per-level run's, in
# LSB of the uint8 RGB keyframes: the largest difference and the mean.
# Set from the first run on the card (NVIDIA H100 80GB HBM3, 700.00 W):
# (2,1) max 5, mean 0.496; (1,2) max 6, mean 0.509; each bound twice the
# larger reading. The keyframes are not bit-equal because (2,1) runs the
# UNet at half the batch (other cuBLAS/cuDNN kernels, other summation
# orders; the phase also holds (2,1) bit-equal to the same halves run one
# after another in one process, _split_transition) and (1,2) rounds each
# row-parallel layer's two bf16 partial products before their f32 sum; a
# random-weight bf16 UNet over 4 steps and the decoder carry those
# last-bit differences to a few LSB.
MESH_LSB_BOUND = 12
MESH_LSB_MEAN_BOUND = 1.0
MESH_CHILD_TIMEOUT_S = 600
MESHES_ON_ONE_CARD = ((2, 1), (1, 2))


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def _recording_launches():
    """Counts, by (kernel, shape, dtype), the K1 slerp_rows calls (the
    denoise's crossfeed, the engine's parental mix) and the K2 calls (d=64
    flash_attention in the UNet) made inside the block, at the bindings
    the engine and the UNet call."""
    import collections

    from latentblending_tpu_torch.engine import blending
    from latentblending_tpu_torch.models import layers
    from latentblending_tpu_torch.runtime import denoise

    launched: collections.Counter = collections.Counter()
    attn, rows_d, rows_b = layers.flash_attention, denoise.slerp_rows, blending.slerp_rows

    def key(kernel, x):
        return (kernel, tuple(x.shape), str(x.dtype).split(".")[1])

    def attention(q, k, v):
        if q.shape[-1] == 64:
            launched[key("K2", q)] += 1
        return attn(q, k, v)

    def recorded(fn):
        def slerp_rows(a, b, f):
            launched[key("K1_rows", a)] += 1
            return fn(a, b, f)
        return slerp_rows

    layers.flash_attention, denoise.slerp_rows, blending.slerp_rows = attention, recorded(rows_d), recorded(rows_b)
    try:
        yield launched
    finally:
        layers.flash_attention, denoise.slerp_rows, blending.slerp_rows = attn, rows_d, rows_b


def _mesh_transition(torch, mesh, label: str) -> dict:
    """One counted run_transition(fixed_seeds=SEEDS) of a full-width
    SDXL-Turbo engine (random weights from seed 0) on `mesh`: the per-level
    path with exactly the unsharded per-level launches (K1 slerp_rows, K2,
    K3 per rank), and K2 called at the mesh's local shapes (the unsharded
    rows over 'data', rounded up by the pad, and the heads over 'model').
    Returns, besides, every (kernel, shape, dtype) K1 and K2 launched at:
    the shapes the phase then holds against their plain versions."""
    import collections

    t0 = time.perf_counter()
    be = _run_engine(torch, "sdxl-turbo", "cuda", torch.bfloat16, mesh=mesh)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    before = dict(mesh.collectives)
    with _recording_launches() as launched:
        _zero_counts()
        t0 = time.perf_counter()
        imgs = [im.copy() for im in be.run_transition(fixed_seeds=SEEDS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _read_counts()
    _check_transition(be, imgs, counts, "per-level", K2_PER_EVAL[512], label)
    for kernel in ("K1_rows", "K2"):  # every launch seen, so every shape is checked
        seen = sum(c for (k, _, _), c in launched.items() if k == kernel)
        if seen != counts[kernel]:
            raise AssertionError(f"{label}: {kernel} launched {counts[kernel]} times, {seen} seen by shape")
    N = be.dh.num_inference_steps
    n_data, n_model = mesh.shape["data"], mesh.shape["model"]
    want: collections.Counter = collections.Counter()
    for rows, evals in [(2, N)] + [(k, N - int(idx)) for idx, n in zip(be.list_idx_injection, be.list_nmb_stems)
                                   for k in be._round_sizes(int(n))]:
        want[("K2", (_ceil(rows, n_data), 1024, 10 // n_model, 64), "bfloat16")] += evals * K2_PER_EVAL[512]
    k2_shapes = {key: c for key, c in launched.items() if key[0] == "K2"}
    if k2_shapes != want:
        raise AssertionError(f"{label}: K2 calls by shape {k2_shapes}, expected {dict(want)}")
    if not be.dh._params_placed:
        raise AssertionError(f"{label}: the holder never checked its replicated weights")
    out = {"imgs": imgs, "fracts": list(be.tree_fracts), "counts": counts, "wall_s": wall, "setup_s": setup_s,
           "launched": sorted([k, list(shape), dt, c] for (k, shape, dt), c in launched.items()),
           "collectives": {k: mesh.collectives[k] - before[k] for k in before}}
    print(f"{label}: per-level path, launches {json.dumps(counts)} (exactly the unsharded per-level run's), K1 "
          f"and K2 calls by local shape {json.dumps(out['launched'])}, collectives in the transition "
          f"{json.dumps(out['collectives'])}, replicated weights checked (one all-gather of checksums); "
          f"setup {setup_s:.3f} s, transition {wall:.3f} s (backend {mesh.backend}, one card: no multi-GPU time)",
          flush=True)
    del be
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _split_transition(torch, n_data: int) -> dict:
    """run_transition(fixed_seeds=SEEDS) of the SDXL-Turbo engine (random
    weights from seed 0) with no process group, each stem batch denoised
    as n_data slices one after another: the holder's own sharded denoise
    on n_data meshes (n_data, 1) without a group, one for each rank's rows,
    concatenated where the ranks all-gather. Mesh (n_data, 1) on the card
    must give these keyframes bit for bit: gloo only copies the rows."""
    from latentblending_tpu_torch.parallel.mesh import Mesh

    be = _run_engine(torch, "sdxl-turbo", "cuda", torch.bfloat16)
    dh = be.dh
    shards, sharded = [Mesh(n_data, 1, rank=r) for r in range(n_data)], dh._denoise_sharded

    def each_shard(plan, latents_start, *args):
        parts = []
        for mesh in shards:
            dh.mesh = mesh
            parts.append(sharded(plan, latents_start, *args))
        return torch.cat(parts, dim=1)[:, :latents_start.shape[0]]

    dh._denoise_sharded, dh.mesh = each_shard, shards[0]
    imgs = [im.copy() for im in be.run_transition(fixed_seeds=SEEDS)]
    if _report_path(be) != "per-level":
        raise AssertionError(f"split ({n_data},1): expected the per-level path, got {be.last_report.levels}")
    out = {"imgs": imgs, "fracts": list(be.tree_fracts)}
    del be, dh
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_child(argv: list) -> int:
    """One of the distributed phase's two ranks on the one card:
    `python3 chip_smoke.py --mesh-child RANK WORLD PORT DIR`. Joins the
    gloo group on cuda:0 (NCCL refuses two ranks on one device), runs
    _mesh_transition on each of MESHES_ON_ONE_CARD, saves its keyframes to
    DIR and prints its numbers on a line starting MESH_CHILD."""
    rank, world, port, outdir = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, ROOT)
    sys.modules["jax"] = None
    import numpy as np
    import torch
    import torch.distributed as dist

    from latentblending_tpu_torch.parallel.distributed import init_distributed
    from latentblending_tpu_torch.parallel.mesh import make_mesh
    from latentblending_tpu_torch.precision import disable_tf32

    disable_tf32()
    init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank, backend="gloo", device="cuda:0")
    report = {}
    for n_data, n_model in MESHES_ON_ONE_CARD:
        mesh = make_mesh(n_data, n_model)
        res = _mesh_transition(torch, mesh, f"mesh ({n_data},{n_model}) rank {rank}")
        np.save(os.path.join(outdir, f"kf_{n_data}x{n_model}_rank{rank}.npy"), np.stack(res.pop("imgs")))
        report[f"{n_data}x{n_model}"] = res
        mesh.barrier()
    dist.destroy_process_group()
    print("MESH_CHILD " + json.dumps(report), flush=True)
    return 0


def _wait_children(procs: list, timeout: float) -> list:
    """Every child's output; a child that fails or outlives `timeout` fails
    the phase, and the others are killed."""
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                raise AssertionError(f"mesh child {r} timed out after {timeout} s:\n{out[-6000:]}")
            for line in out.splitlines():
                if not line.startswith("MESH_CHILD "):
                    print(f"[rank {r}] {line}", flush=True)
            if p.returncode != 0:
                raise AssertionError(f"mesh child {r} exited {p.returncode}:\n{out[-6000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def distributed_phase(torch, ref: dict) -> tuple:
    """The multi-GPU layer on the one card, at SDXL-Turbo 512² full width
    (random weights from seed 0), against main_path's per-level keyframes
    `ref` (seeds 420, 421):
    (a) one NCCL rank in this process, mesh (1,1): per-level, exact
        launches, keyframes bit-equal to ref (the same batches on the same
        kernels), tree_fracts equal;
    (b) two ranks sharing the card over gloo (two child processes), mesh
        (2,1) then (1,2): per rank exact launches and K2 at the local
        shapes; both ranks' keyframes byte-equal, tree_fracts equal ref's,
        keyframes within MESH_LSB_BOUND (max) and MESH_LSB_MEAN_BOUND
        (mean) of ref; (2,1)'s keyframes bit-equal to _split_transition's
        (its halves run one after another in this process);
    (c) every (kernel, shape, dtype) that K1 slerp_rows and K2 launched at
        in (a) and (b), against its plain version (and K2 against SDPA).
    Returns ({label: rank 0's launches}, [(c)'s cases, each with rank 0's
    launches at its shape by mesh]). The walls printed are no multi-GPU
    speed: gloo stages every collective through host memory, on one card."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from latentblending_tpu_torch.parallel.distributed import init_distributed
    from latentblending_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    init_distributed(f"tcp://127.0.0.1:{_free_port()}", world_size=1, rank=0)
    backend = dist.get_backend()
    if backend != "nccl":
        raise AssertionError(f"mesh (1,1): backend {backend}, expected nccl")
    one = _mesh_transition(torch, make_mesh(1, 1), "mesh (1,1) nccl")
    dist.destroy_process_group()
    same = len(one["imgs"]) == len(ref["imgs"]) and all(np.array_equal(a, b) for a, b in zip(one["imgs"], ref["imgs"]))
    print(f"mesh (1,1) nccl: keyframes bit-equal to the unsharded per-level run: {same}; tree_fracts equal: "
          f"{one['fracts'] == ref['fracts']}", flush=True)
    if not same or one["fracts"] != ref["fracts"]:
        raise AssertionError("mesh (1,1): keyframes or tree_fracts differ from the unsharded per-level run")
    counts = {"mesh (1,1) nccl": one["counts"]}
    launched = {"mesh (1,1) nccl": one["launched"]}
    del one
    gc.collect()
    torch.cuda.empty_cache()
    split = {mesh: _split_transition(torch, mesh[0]) for mesh in MESHES_ON_ONE_CARD if mesh[1] == 1}

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lb_mesh_") as tmp:
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__), "--mesh-child", str(r), "2",
                                   str(port), tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        outs = _wait_children(procs, MESH_CHILD_TIMEOUT_S)
        reports = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("MESH_CHILD "))[11:])
                   for out in outs]
        for mesh in MESHES_ON_ONE_CARD:
            tag = f"{mesh[0]}x{mesh[1]}"
            kfs = [np.load(os.path.join(tmp, f"kf_{tag}_rank{r}.npy")) for r in range(2)]
            rep0 = reports[0][tag]
            ranks_equal = (np.array_equal(kfs[0], kfs[1]) and reports[1][tag]["counts"] == rep0["counts"]
                           and reports[1][tag]["launched"] == rep0["launched"])
            diff = np.abs(kfs[0].astype(np.int16) - np.stack(ref["imgs"]).astype(np.int16))
            lsb_max, lsb_mean = int(diff.max()), float(diff.mean())
            print(f"mesh {mesh} gloo, two ranks on one card: ranks' keyframes and launches equal {ranks_equal}, "
                  f"tree_fracts equal to the unsharded run's {rep0['fracts'] == ref['fracts']}, keyframes vs the "
                  f"unsharded per-level run: max {lsb_max} LSB, mean {lsb_mean:.6f} LSB (bounds {MESH_LSB_BOUND}, "
                  f"{MESH_LSB_MEAN_BOUND}); "
                  f"collectives per transition {json.dumps(rep0['collectives'])}", flush=True)
            if not ranks_equal or rep0["fracts"] != ref["fracts"]:
                raise AssertionError(f"mesh {mesh}: ranks disagree, or tree_fracts {rep0['fracts']} != {ref['fracts']}")
            if lsb_max > MESH_LSB_BOUND or lsb_mean > MESH_LSB_MEAN_BOUND:
                raise AssertionError(f"mesh {mesh}: keyframes max {lsb_max} / mean {lsb_mean} LSB from the unsharded "
                                     f"run, bounds {MESH_LSB_BOUND} / {MESH_LSB_MEAN_BOUND}")
            if mesh in split:
                alone = split[mesh]
                split_lsb = int(np.abs(kfs[0].astype(np.int16) - np.stack(alone["imgs"]).astype(np.int16)).max())
                print(f"mesh {mesh} gloo vs its halves denoised one after another in one process: max {split_lsb} "
                      f"LSB (bound 0), tree_fracts equal {rep0['fracts'] == alone['fracts']}", flush=True)
                if split_lsb or rep0["fracts"] != alone["fracts"]:
                    raise AssertionError(f"mesh {mesh}: keyframes differ from the same halves run in one process")
            counts[f"mesh {mesh} gloo rank 0"] = rep0["counts"]
            launched[f"mesh {mesh} gloo rank 0"] = rep0["launched"]
    print(f"distributed phase: {time.perf_counter() - t_phase:.1f} s in all, the two-rank part "
          f"{time.perf_counter() - t0:.1f} s with its process start-up (backends: nccl for (1,1), gloo for the two "
          f"ranks; walls on one card are no multi-GPU speed)", flush=True)

    # (c): each shape launched, against its plain version
    by_shape: dict = {}
    for label, rows in launched.items():
        for kernel, shape, dtype, c in rows:
            by_shape.setdefault((kernel, tuple(shape), dtype), {})[label] = c
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = []
    for (kernel, shape, dtype), by_path in sorted(by_shape.items()):
        dt = getattr(torch, dtype)
        case = _slerp_case(torch, g, shape, dt) if kernel == "K1_rows" else _attention_case(torch, g, shape, dt, 1.0)
        cases.append((kernel, case, by_path))
    print(f"distributed phase: {len(cases)} (kernel, shape, dtype) launched, each within its bound of its plain "
          f"version", flush=True)
    return counts, cases


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


def _kernels_line(kres: dict, counts: dict, local: list) -> list:
    """One entry per kernel entry point: its first case's numbers and its
    launches during the counted (first) run of each path, summed; then one
    for each (kernel, shape, dtype) that K1 slerp_rows and K2 launched at in
    the distributed phase (local: (kernel, case, {mesh: rank 0's launches
    at that shape})), with those launches."""
    replaces_k1 = "latentblending_tpu/ops/pallas_kernels.py:87"
    meta = {
        "K1_rows": ("slerp_rows (cluster-split rows)", "latentblending_tpu_torch/csrc/slerp.cu", replaces_k1),
        "K1_tree": ("slerp_tree_step (parental mix + crossfeed, cluster-split rows)",
                    "latentblending_tpu_torch/csrc/slerp.cu", replaces_k1),
        "K2": ("attention_d64_bf16 (wgmma, TMA)", "latentblending_tpu_torch/csrc/attention_d64_bf16.cu",
               "latentblending_tpu/models/layers.py:192"),
        "K2_f32": ("attention_d64_f32 (3xTF32 wgmma, TMA, operands split once per tile)", "latentblending_tpu_torch/csrc/attention_d64_f32.cu",
                   "latentblending_tpu/models/layers.py:192"),
        "K3": ("attention_d512_f32 (3xTF32 wgmma, TMA, 4-CTA cluster, operands split once per tile)",
               "latentblending_tpu_torch/csrc/attention_d512_f32.cu", "latentblending_tpu/models/layers.py:373"),
        "K3_bf16": ("attention_d512_bf16 (wgmma, TMA, 2-CTA cluster)",
                    "latentblending_tpu_torch/csrc/attention_d512_bf16.cu", "latentblending_tpu/models/layers.py:373"),
        # no TPU kernel: the JAX package's convolutions are XLA's
        "C1": ("conv3x3_f32 (3xTF32 wgmma implicit GEMM, TMA input boxes, weights split per tile, bias in "
               "the epilogue)", "latentblending_tpu_torch/csrc/conv3x3_f32.cu", "none (XLA's convolutions)"),
        # no TPU kernel: the JAX package has no SD3
        "M1": ("adaln_bf16 (adaLN-Zero modulation and gated residuals, a row in a CTA's registers, the norm's "
               "statistics reduced in the CTA)", "latentblending_tpu_torch/csrc/adaln_bf16.cu",
               "none (no SD3 in the JAX package)"),
        # no TPU kernel: the work the JAX package does on the host through libjpeg
        "J1": ("jpeg_fdct_quant (libjpeg's islow DCT and quantize, from I420 or RGB)",
               "latentblending_tpu_torch/csrc/jpeg.cu", "latentblending_tpu/video/_jpeg_lerp.py:66"),
        # the same entry on RGB frames (libjpeg's color conversion and 2x2
        # downsampling first): movie frames on the pixel path and
        # write_imgs_transition's keyframes, which the JAX package saves with PIL
        "J1_rgb": ("jpeg_fdct_quant, RGB route (color conversion, 2x2 downsampling, DCT, quantize)",
                   "latentblending_tpu_torch/csrc/jpeg.cu", "latentblending_tpu/engine/blending.py:1761"),
        "J2": ("jpeg_coef_lerp, batched (a gap's in-between frames' coefficients, F fractions a call)",
               "latentblending_tpu_torch/csrc/jpeg.cu", "latentblending_tpu/video/_jpeg_lerp.py:107"),
        "J3": ("jpeg_huffman, batched (Huffman coding, padding and byte stuffing of F frames a call: a warp "
               "per block, scans in the kernels, 8 launches, the card's copy to pinned memory)",
               "latentblending_tpu_torch/csrc/jpeg.cu", "latentblending_tpu/video/_jpeg_lerp.py:66"),
    }
    kernels = []
    for k, (name, source, replaces) in meta.items():
        first = kres[k][0]
        by_path = _C1_LAUNCHES if k == "C1" else {path: c[k] for path, c in counts.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(c["max_abs_err"] for c in kres[k]),
            "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": first["library_ms"], "shape": first["shape"],
        })
    for kernel, case, by_path in local:
        kernels.append({
            "name": f"{meta[kernel][0]} at a shape of the distributed phase", "route": "cuda",
            "source": meta[kernel][1], "replaces": meta[kernel][2], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"], "shape": case["shape"],
        })
    return kernels


def main() -> int:
    if sys.argv[1:2] == ["--mesh-child"]:
        return mesh_child(sys.argv[2:])
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
    for kernel in ("attention_d512_bf16", "attention_d512_f32", "attention_d64_f32", "conv3x3_f32"):
        _check_wgmma_sass(sass, kernel)
    fdct = {name: c for name, c in sass.items() if "fdct_quant_kernel" in name}
    if not fdct or any(c["local"] for c in fdct.values()):
        raise AssertionError(f"sass: J1's fdct_quant_kernel should use no local memory, got {fdct}")
    print("sass fdct_quant_kernel: no local memory", flush=True)
    adaln_sass = {name: c for name, c in sass.items() if "adaln_kernel" in name}
    if len(adaln_sass) != 9 or any(c["local"] for c in adaln_sass.values()):
        raise AssertionError(f"sass: M1's 9 adaln_kernel instantiations should use no local memory, got {adaln_sass}")
    print("sass adaln_kernel: 9 instantiations, no local memory", flush=True)

    j1_exact_cases(torch)
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
    counts, nlpd_walls, per_level_ref = main_path(torch, be)
    profile_paths(torch, be)
    movie = movie_phase(torch, be)
    counts.update(movie["counts"])
    kres.update(movie["kres"])
    ref = reference_api_phase(torch, be, nlpd_walls)
    counts.update(ref["counts"])
    for k, cases in ref["kres"].items():  # the reference phase's J1 RGB row first, the movie's after it
        kres[k] = cases + kres.get(k, [])
    counts.update(serving_phase(torch, be))
    be.tree_latents, be._imgs_dev, be.tree_final_imgs = [None, None], [], []
    torch.cuda.empty_cache()
    counts.update(image_phase(torch, be.dh))
    torch.cuda.empty_cache()
    counts.update(f32_unet_phase(torch, be.dh))
    counts.update(base_phase(torch, be.dh))
    del be
    gc.collect()
    torch.cuda.empty_cache()
    counts.update(sd3_phase(torch))
    gc.collect()
    torch.cuda.empty_cache()
    dist_counts, local = distributed_phase(torch, per_level_ref)
    counts.update(dist_counts)

    kernels = _kernels_line(kres, counts, local)
    print(f"chip_smoke.py ran for {time.perf_counter() - t_start:.1f} s", flush=True)
    print(_card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
