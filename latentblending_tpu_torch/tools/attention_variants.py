"""Build variants of an attention kernel side by side and measure them on
one card, in one process, against the plain version and
scaled_dot_product_attention.

    python3 -m latentblending_tpu_torch.tools.attention_variants --kernel k2_f32 \
        [--variant "name=-DMACRO=value ..." ...] [--source name=path/to/kernel.cu ...] \
        [--shapes 12x1024,2x1024] [--rounds 2]

--kernel picks the C entry: k2_f32 (csrc/attention_d64_f32.cu, 10 heads
of d = 64, f32), k3_f32 (csrc/attention_d512_f32.cu, one head of d = 512,
f32) or k3_bf16 (csrc/attention_d512_bf16.cu, one head of d = 512, bf16).
The default variant is the kernel as built. To weigh a design change,
put it in the source behind a macro and name one variant per setting;
--source gives a variant another source file (for example the
parent commit's, unpacked by `git archive` into git-ignored `_scratch/`),
built with that file's directory on the include path. Each variant is
compiled with its macro definitions into its own shared library under
latentblending_tpu_torch/_build/variants/ (git-ignored), with ptxas's
registers and spills printed, and bound with ctypes. Each variant is first
checked alone in a subprocess with a time limit (a variant that hangs the
card is killed there, and the run stops): every shape, plus q scaled by 4
and the shortest sequences the kernel takes, against attention_reference
within chip_smoke's bound for the kernel (--unchecked NAME: an ablation,
held to no bound, only run to its end). Then one process times all
variants in turns (a, b, ..., b, a, repeated --rounds times): device ms by
CUDA-graph replay (chip_smoke._device_ms) beside
scaled_dot_product_attention's and the bound. Prints one JSON line per
measurement, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "latentblending_tpu_torch" / "csrc"
OUT_DIR = ROOT / "latentblending_tpu_torch" / "_build" / "variants"
DEFAULT_VARIANTS = ["built="]

# kernel -> source, C entry, dtype name, heads, head dim, default shapes
# (BxL), the peaked case, the short sequences it is also checked at
KERNELS = {
    "k2_f32": {"source": "attention_d64_f32.cu", "entry": "lb_attention_fwd_d64_f32", "dtype": "float32",
               "heads": 10, "d": 64, "shapes": "12x1024,2x1024,4x4096,10x1024",
               "peaked": (10, 1024), "short": (128, 256, 384)},
    "k3_f32": {"source": "attention_d512_f32.cu", "entry": "lb_attention_fwd_d512_f32", "dtype": "float32",
               "heads": 1, "d": 512, "shapes": "4x4096,2x4096,1x16384",
               "peaked": (2, 4096), "short": (64, 128, 192)},
    "k3_bf16": {"source": "attention_d512_bf16.cu", "entry": "lb_attention_fwd_d512_bf16", "dtype": "bfloat16",
                "heads": 1, "d": 512, "shapes": "4x4096,8x4096,1x4096,1x16384,2x4096",
                "peaked": (2, 4096), "short": (64, 128, 192)},
}


def _parse_variant(text: str) -> tuple[str, list[str]]:
    name, _, flags = text.partition("=")
    return name, flags.split() if flags else []


def build(kernel: str, variants: list[tuple[str, list[str]]], sources: dict[str, Path]) -> dict[str, Path]:
    """One nvcc per variant, all started together; returns name -> .so."""
    from latentblending_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for name, flags in variants:
        src = sources.get(name, CSRC / KERNELS[kernel]["source"])
        lib = OUT_DIR / f"{kernel}_{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags, "-I", str(src.parent), "-shared", "-o", str(lib),
               str(src)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}\n{err}")
        for line in (out + err).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line or "arning" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        libs[name] = lib
    return libs


def _bind(kernel: str, path: Path):
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, KERNELS[kernel]["entry"])
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _call(torch, fn, q, k, v):
    out = torch.empty_like(q)
    B, L, H, D = q.shape
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, H, float(D ** -0.5),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc} at launch")
    return out


def _inputs(torch, g, kernel, shape, peak):
    dtype = getattr(torch, KERNELS[kernel]["dtype"])
    q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    return (q * peak).to(dtype), k.to(dtype), v.to(dtype)


def _shape(kernel: str, b: int, n: int) -> tuple:
    return (b, n, KERNELS[kernel]["heads"], KERNELS[kernel]["d"])


def _rel_bound(kernel: str) -> float:
    import chip_smoke

    return chip_smoke.K3_BF16_REL_BOUND if KERNELS[kernel]["dtype"] == "bfloat16" else chip_smoke.K3_REL_BOUND


def check(kernel: str, name: str, lib: Path, shapes: list[tuple], bound_held: bool = True) -> None:
    """Each shape (and the peaked and short cases) against the plain version;
    bound_held=False (an ablation) only runs each case to its end."""
    import torch

    from latentblending_tpu_torch.ops import attention

    fn = _bind(kernel, lib)
    g = torch.Generator(device="cuda").manual_seed(0)
    spec = KERNELS[kernel]
    cases = ([(s, 1.0) for s in shapes] + [(_shape(kernel, *spec["peaked"]), 4.0)]
             + [(_shape(kernel, 1, n), 1.0) for n in spec["short"]])
    bound = _rel_bound(kernel)
    for shape, peak in cases:
        q, k, v = _inputs(torch, g, kernel, shape, peak)
        got = _call(torch, fn, q, k, v).float()
        want = attention.attention_reference(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        ok = bool(torch.isfinite(got).all()) and rel <= bound
        again = torch.equal(_call(torch, fn, q, k, v).float(), got)
        print(json.dumps({"variant": name, "check": list(shape), "q_scale": peak, "max_rel_err": rel,
                          "bound": bound, "repeats_bit_for_bit": again, "ok": ok}), flush=True)
        if bound_held and not (ok and again):
            raise SystemExit(f"variant {name} outside its bound at {shape}")


def time_all(kernel: str, libs: dict[str, Path], shapes: list[tuple], rounds: int) -> None:
    """All variants at each shape, in turns, beside SDPA."""
    import torch

    import chip_smoke

    fns = {name: _bind(kernel, p) for name, p in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(1)
    names = list(fns)
    order = (names + names[::-1]) * rounds
    for shape in shapes:
        q, k, v = _inputs(torch, g, kernel, shape, 1.0)
        B, L, H, d = shape
        flops = 4 * B * H * L * L * d
        nbytes = 4 * B * L * H * d * q.element_size()
        # the f32 kernels run 3xTF32: three TF32 products per f32 one
        bound = (chip_smoke._bound(nbytes, flops, "bf16") if q.dtype == torch.bfloat16
                 else chip_smoke._bound(nbytes, 3 * flops, "tf32"))
        sdpa, backend = chip_smoke._sdpa(torch, q, k, v)
        times = {name: [] for name in names}
        lib_ms = []
        for i, name in enumerate(order):
            if i % len(names) == 0:
                lib_ms.append(chip_smoke._device_ms(torch, sdpa))
            times[name].append(chip_smoke._device_ms(torch, lambda fn=fns[name]: _call(torch, fn, q, k, v)))
        for name in names:
            best = min(times[name])
            print(json.dumps({"kernel": kernel, "variant": name, "shape": list(shape), "ms": times[name],
                              "library_ms": lib_ms, "library_backend": backend, "bound_ms": bound["bound_ms"],
                              "share_of_bound": bound["bound_ms"] / best}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="k2_f32")
    ap.add_argument("--variant", action="append", help="name=<nvcc flags>; repeatable")
    ap.add_argument("--source", action="append", default=[], help="name=<.cu path> for a variant; repeatable")
    ap.add_argument("--shapes", help="BxL, comma-separated (default: the kernel's path shapes)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0, help="seconds for each variant's check")
    ap.add_argument("--unchecked", action="append", default=[], metavar="NAME",
                    help="hold this variant to no bound, only run its cases to their end in the timed "
                         "subprocess (an ablation that computes something else); repeatable")
    ap.add_argument("--check-only", metavar="NAME", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.modules["jax"] = None
    kernel = args.kernel
    text = args.shapes or KERNELS[kernel]["shapes"]
    shapes = [_shape(kernel, int(b), int(n)) for b, n in (s.split("x") for s in text.split(","))]
    if args.check_only:
        check(kernel, args.check_only, OUT_DIR / f"{kernel}_{args.check_only}.so", shapes,
              args.check_only not in args.unchecked)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("attention_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    variants = [_parse_variant(v) for v in (args.variant or DEFAULT_VARIANTS)]
    sources = {name: Path(path).resolve() for name, _, path in (s.partition("=") for s in args.source)}
    print(f"card: {chip_smoke._card_line()}", flush=True)
    t0 = time.perf_counter()
    libs = build(kernel, variants, sources)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        cmd = [sys.executable, "-m", "latentblending_tpu_torch.tools.attention_variants", "--kernel", kernel,
               "--check-only", name, "--shapes", text, *(["--unchecked", name] if name in args.unchecked else [])]
        try:
            res = subprocess.run(cmd, cwd=ROOT, timeout=args.timeout, capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            print(f"variant {name}: check timed out after {args.timeout} s", flush=True)
            return 1
        print(res.stdout + res.stderr[-3000:], end="", flush=True)
        if res.returncode != 0:
            return 1
    time_all(kernel, libs, shapes, args.rounds)
    print(chip_smoke._card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
