"""Build and bind the port's hand-written CUDA kernels.

Every `csrc/*.cu` file is compiled by its own nvcc, all started together,
and the objects are linked into ONE shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: a build takes seconds
instead of minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
         -c -o _build/<hash>/<name>.o csrc/<name>.cu          (one per source)
    nvcc <same flags> -shared -o _build/<hash>/liblbkernels.so _build/<hash>/*.o

The library is built at first use into `latentblending_tpu_torch/_build/`
(git-ignored), in a directory named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one is reused. Nothing here runs
at import time: CPU-only hosts import the wrappers and never build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: argtypes (pointers and the stream as c_void_p, never as int)
    "lb_slerp_rows_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int64, _P],
    "lb_slerp_rows_bf16": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int64, _P],
    "lb_slerp_tree_step_f32": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int64, _P],
    "lb_slerp_tree_step_bf16": [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int64, _P],
    "lb_attention_fwd_d64_bf16": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "lb_attention_fwd_d64_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "lb_attention_fwd_d512_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "lb_attention_fwd_d512_bf16": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _P],
    "lb_conv3x3_f32": [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    "lb_adaln_modulate_bf16": [_P, _P, ctypes.c_int64, _P, ctypes.c_int64, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               _P],
    "lb_gated_residual_bf16": [_P, _P, ctypes.c_int64, _P, _P, ctypes.c_int64, _P, ctypes.c_int64, _P, _P, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, _P],
    "lb_jpeg_fdct_quant": [_P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    "lb_jpeg_coef_lerp": [_P, _P, _P, ctypes.c_int64, _P, ctypes.c_int, _P],
    "lb_jpeg_huff_count": [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    "lb_jpeg_huff_code": [_P, _P, _P, _P, _P, ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          _P],
    "lb_jpeg_huff_copy": [_P, _P, ctypes.c_int, ctypes.c_int64, _P, _P, _P],
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
    """Compile csrc/*.cu into the hashed build directory; return the .so path.
    verbose: print ptxas's registers, shared memory and spills per kernel."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / "liblbkernels.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # process and thread in the temporary names: builders in other
    # processes or threads never write each other's files
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
        logs.append(out + err)
    tmp = out_dir / f"liblbkernels.{tag}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *[str(obj) for _, obj, _ in jobs]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    if verbose:
        print("".join(logs), flush=True)
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


_LIBRARY: ctypes.CDLL | None = None
_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call) with typed entry
    points. A process-wide lock makes concurrent first calls (a threaded
    server's first requests) build and load it once."""
    global _LIBRARY
    if _LIBRARY is None:
        with _LIBRARY_LOCK:
            if _LIBRARY is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                _LIBRARY = lib
    return _LIBRARY


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def launch(name: str, *args) -> None:
    """Call the C entry `name` on the current stream of the first argument's
    device (a tensor): tensors pass as their data pointers, other arguments
    as given; raise on a launch error."""
    import torch

    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        rc = getattr(library(), name)(*ptrs, stream)
    check(rc, name)
