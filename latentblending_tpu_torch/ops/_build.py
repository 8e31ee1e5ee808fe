"""Build and bind the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by nvcc into ONE shared library with a
plain C interface, loaded with ctypes (no PyTorch headers: a build takes
seconds instead of minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<hash>/liblbkernels.so csrc/*.cu

The library is built at first use into `latentblending_tpu_torch/_build/`
(git-ignored), in a directory named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. Nothing here runs
at import time: CPU-only hosts import the wrappers and never build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p, never as int)
    "lb_slerp_rows_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int64, _P],
    "lb_slerp_rows_bf16": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int64, _P],
    "lb_attention_fwd_d64_bf16": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "lb_attention_fwd_d512_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
}


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(verbose: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed build directory; return the .so path."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / "liblbkernels.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"liblbkernels.{os.getpid()}.tmp.so"
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", str(tmp),
           *[str(p) for p in _sources() if p.suffix == ".cu"]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    if verbose:
        print(res.stdout + res.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call) with typed entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
