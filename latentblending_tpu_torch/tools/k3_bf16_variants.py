"""Build variants of K3 in bf16 (csrc/attention_d512_bf16.cu) side by side
and measure them on one card, in one process, against the plain version
and scaled_dot_product_attention.

    python3 -m latentblending_tpu_torch.tools.k3_bf16_variants \
        [--variant "name=-DMACRO=value ..." ...] [--shapes 4x4096,1x4096] [--rounds 2]

The default is the kernel as built. To weigh a design change, put it in
the source behind a macro and name one variant per setting (the kernel's
overlap of the next S product and its st.async exchange were chosen so,
against the serial order and a fenced exchange; PERF.md). Each
variant is the source compiled with its macro definitions into its
own shared library under latentblending_tpu_torch/_build/variants/
(git-ignored), with ptxas's registers and spills printed, and bound with
ctypes. Each variant is first checked alone in a subprocess with a time
limit (a variant that hangs the card is killed there, and the run stops):
every shape, plus q scaled by 4 and L = 64, 128, 192 (1-3 key tiles), against
attention_reference within chip_smoke.K3_BF16_REL_BOUND. Then one process
times all variants in turns (a, b, ..., b, a, repeated --rounds times):
device ms by CUDA-graph replay (chip_smoke._device_ms) beside
scaled_dot_product_attention's and the bound. Prints one JSON line per
measurement, and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = ROOT / "latentblending_tpu_torch" / "csrc" / "attention_d512_bf16.cu"
OUT_DIR = ROOT / "latentblending_tpu_torch" / "_build" / "variants"
ENTRY = "lb_attention_fwd_d512_bf16"
DEFAULT_VARIANTS = ["built="]


def _parse_variant(text: str) -> tuple[str, list[str]]:
    name, _, flags = text.partition("=")
    return name, flags.split() if flags else []


def build(variants: list[tuple[str, list[str]]]) -> dict[str, Path]:
    """One nvcc per variant, all started together; returns name -> .so."""
    from latentblending_tpu_torch.ops import _build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    jobs = {}
    for name, flags in variants:
        lib = OUT_DIR / f"k3_bf16_{name}.so"
        cmd = [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags, "-I", str(SRC.parent), "-shared", "-o", str(lib),
               str(SRC)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name}: nvcc failed\n{out}\n{err}")
        for line in (out + err).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
        libs[name] = lib
    return libs


def _bind(path: Path):
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, ENTRY)
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
        raise RuntimeError(f"{ENTRY}: CUDA error {rc} at launch")
    return out


def _inputs(torch, g, shape, peak):
    q, k, v = (torch.randn(shape, generator=g, device="cuda") for _ in range(3))
    return (q * peak).bfloat16(), k.bfloat16(), v.bfloat16()


def check(name: str, lib: Path, shapes: list[tuple]) -> None:
    """Each shape (and the peaked and odd-tile cases) against the plain version."""
    import torch

    import chip_smoke
    from latentblending_tpu_torch.ops import attention

    fn = _bind(lib)
    g = torch.Generator(device="cuda").manual_seed(0)
    # + the peaked case and 1, 2 and 3 key tiles (the peeled last tile after 0, 1 or 2 loop steps)
    cases = [(s, 1.0) for s in shapes] + [((2, 4096, 1, 512), 4.0)] + [((1, n, 1, 512), 1.0) for n in (64, 128, 192)]
    for shape, peak in cases:
        q, k, v = _inputs(torch, g, shape, peak)
        got = _call(torch, fn, q, k, v).float()
        want = attention.attention_reference(q.float(), k.float(), v.float())
        torch.cuda.synchronize()
        rel = ((got - want).abs().max() / want.abs().max()).item()
        ok = bool(torch.isfinite(got).all()) and rel <= chip_smoke.K3_BF16_REL_BOUND
        again = torch.equal(_call(torch, fn, q, k, v).float(), got)
        print(json.dumps({"variant": name, "check": list(shape), "q_scale": peak, "max_rel_err": rel,
                          "repeats_bit_for_bit": again, "ok": ok}), flush=True)
        if not (ok and again):
            raise SystemExit(f"variant {name} outside its bound at {shape}")


def time_all(libs: dict[str, Path], shapes: list[tuple], rounds: int) -> None:
    """All variants at each shape, in turns, beside SDPA."""
    import torch

    import chip_smoke

    fns = {name: _bind(p) for name, p in libs.items()}
    g = torch.Generator(device="cuda").manual_seed(1)
    names = list(fns)
    order = (names + names[::-1]) * rounds
    for shape in shapes:
        q, k, v = _inputs(torch, g, shape, 1.0)
        B, L, H, d = shape
        bound = chip_smoke._bound(4 * B * L * H * d * 2, 4 * B * H * L * L * d, "bf16")
        sdpa, backend = chip_smoke._sdpa(torch, q, k, v)
        times = {name: [] for name in names}
        lib_ms = []
        for i, name in enumerate(order):
            if i % len(names) == 0:
                lib_ms.append(chip_smoke._device_ms(torch, sdpa))
            times[name].append(chip_smoke._device_ms(torch, lambda fn=fns[name]: _call(torch, fn, q, k, v)))
        for name in names:
            best = min(times[name])
            print(json.dumps({"variant": name, "shape": list(shape), "ms": times[name], "library_ms": lib_ms,
                              "library_backend": backend, "bound_ms": bound["bound_ms"],
                              "share_of_bound": bound["bound_ms"] / best}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", help="name=<nvcc flags>; repeatable")
    ap.add_argument("--shapes", default="4x4096,8x4096,1x4096,1x16384,2x4096", help="BxL, comma-separated")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0, help="seconds for each variant's check")
    ap.add_argument("--check-only", metavar="NAME", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.modules["jax"] = None
    variants = [_parse_variant(v) for v in (args.variant or DEFAULT_VARIANTS)]
    shapes = [(int(b), int(n), 1, 512) for b, n in (s.split("x") for s in args.shapes.split(","))]
    if args.check_only:
        check(args.check_only, OUT_DIR / f"k3_bf16_{args.check_only}.so", shapes)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("k3_bf16_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    print(f"card: {chip_smoke._card_line()}", flush=True)
    t0 = time.perf_counter()
    libs = build(variants)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        cmd = [sys.executable, "-m", "latentblending_tpu_torch.tools.k3_bf16_variants", "--check-only", name,
               "--shapes", args.shapes]
        res = subprocess.run(cmd, cwd=ROOT, timeout=args.timeout, capture_output=True, text=True)
        print(res.stdout + res.stderr[-3000:], end="", flush=True)
        if res.returncode != 0:
            return 1
    time_all(libs, shapes, args.rounds)
    print(chip_smoke._card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
