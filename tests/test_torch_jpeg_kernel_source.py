"""J1's CUDA source (latentblending_tpu_torch/csrc/jpeg.cu, its J1 section)
compiled for the CPU with g++ and run, against J1's plain version.

A small header maps the CUDA names the section uses onto C++: every CUDA
thread of a CTA is a std::thread, `__syncthreads` a barrier of the CTA,
`__syncwarp` a barrier of the warp, `__shfl_sync` an exchange through a
slot array between two warp barriers, `__shared__` arrays are shared by
the CTA's threads, `__umulhi` the high word of a 64-bit product. CTAs run
one after another. So the kernel's own indexing (strips of MCUs, a warp's
four blocks, the transpose tile, the RGB route's Cb/Cr tile, the zigzag
staging, the 16-byte stores into the output) runs as written, and a
wrong offset, a missing barrier's data or a lane's wrong block shows as a
coefficient that differs from the plain version (or as the 0x3039 fill of
an output the kernel never wrote). The threads of a CTA are made once
and run the grid's CTAs in turn, a barrier between two. Cases: both
formats at sizes that are not multiples of 16 (dummy blocks, edge
expansion), with several MCU rows and a partial strip, on noise, all 0,
all 255 and 0/255 checkerboards of period 1 and 8 (the worst cases of
the transform's odd terms), two frames a launch, at q 1, 50, 90 and 100.
"""
import shutil
import subprocess

import numpy as np
import pytest
import torch

from latentblending_tpu_torch.ops import _build
from latentblending_tpu_torch.video import jpeg

SHIM = r"""
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
#define __align__(x) __attribute__((aligned(x)))
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
struct dim3 { unsigned x = 1, y = 1, z = 1; };
thread_local dim3 threadIdx, blockIdx;
dim3 blockDim;
std::barrier<>* cta_barrier;
std::vector<std::barrier<>*> warp_barriers;
int shfl_slots[64][32];
inline void __syncthreads() { cta_barrier->arrive_and_wait(); }
inline void __syncwarp() { warp_barriers[threadIdx.x >> 5]->arrive_and_wait(); }
inline int __shfl_sync(unsigned, int v, int src) {
  const int w = threadIdx.x >> 5;
  warp_barriers[w]->arrive_and_wait();
  shfl_slots[w][threadIdx.x & 31] = v;
  warp_barriers[w]->arrive_and_wait();
  const int r = shfl_slots[w][src];
  warp_barriers[w]->arrive_and_wait();
  return r;
}
inline unsigned __umulhi(unsigned a, unsigned b) { return (unsigned)(((unsigned long long)a * b) >> 32); }
"""

MAIN = r"""
// j1 frames out B H W rgb table...: the kernel over the grid lb_jpeg_fdct_quant launches, once for each
// quantization table, the outputs one after another
int main(int argc, char** argv) {
  const int B = atoi(argv[3]), H = atoi(argv[4]), W = atoi(argv[5]), rgb = atoi(argv[6]), nq = argc - 7;
  const size_t frame_bytes = rgb ? (size_t)3 * H * W : (size_t)H * W * 3 / 2;
  std::vector<uint8_t> frames(frame_bytes * B);
  std::vector<uint2> tables(128 * nq);
  FILE* f = fopen(argv[1], "rb");
  if (fread(frames.data(), 1, frames.size(), f) != frames.size()) return 3;
  fclose(f);
  for (int q = 0; q < nq; ++q) {
    f = fopen(argv[7 + q], "rb");
    if (fread(tables.data() + 128 * q, 8, 128, f) != 128) return 3;
    fclose(f);
  }
  const int my = (H + 15) / 16, mx = (W + 15) / 16, strips = (mx + kStripMcus - 1) / kStripMcus;
  const size_t per_q = (size_t)my * mx * 6 * 64 * B;
  std::vector<int16_t> out(per_q * nq, 12345);
  const int threads = kFdctWarps * 32;
  blockDim.x = threads;
  cta_barrier = new std::barrier<>(threads);
  for (int w = 0; w < kFdctWarps; ++w) warp_barriers.push_back(new std::barrier<>(32));
  std::vector<std::thread> cta;
  for (int t = 0; t < threads; ++t)
    cta.emplace_back([&, t] {
      threadIdx.x = t;
      for (int q = 0; q < nq; ++q)
        for (int by = 0; by < B; ++by)
          for (int bx = 0; bx < my * strips; ++bx) {
            blockIdx.x = bx;
            blockIdx.y = by;
            fdct_quant_kernel(frames.data(), tables.data() + 128 * q, out.data() + per_q * q, H, W, rgb);
            cta_barrier->arrive_and_wait();  // the CTA ends: its shared arrays go to the next one
          }
    });
  for (auto& t : cta) t.join();
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 2, out.size(), f);
  fclose(f);
  return 0;
}
"""


@pytest.fixture(scope="module")
def j1_binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernel's source for the CPU")
    src = (_build.CSRC_DIR / "jpeg.cu").read_text()
    start = src.index("// ---------------------------------------------------------------- J1")
    end = src.index("// ---------------------------------------------------------------- J2")
    d = tmp_path_factory.mktemp("j1_source")
    (d / "j1.cpp").write_text(SHIM + "namespace {\n" + src[start:end] + "}  // namespace\n" + MAIN)
    exe = d / "j1"
    res = subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-Wno-unknown-pragmas", "-o", str(exe),
                          str(d / "j1.cpp")], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    return exe


def _run(exe, tmp_path, frames: np.ndarray, qualities: tuple, fmt: str) -> np.ndarray:
    """The kernel's coefficients of `frames` at each quality: int16 [len(qualities), B, nblocks, 64]."""
    B = frames.shape[0]
    h, w = (frames.shape[1] * 2 // 3, frames.shape[2]) if fmt == "i420" else frames.shape[1:3]
    frames.tofile(tmp_path / "frames.bin")
    for q in qualities:
        jpeg._fdct_table(q).tofile(tmp_path / f"table{q}.bin")
    subprocess.run([str(exe), str(tmp_path / "frames.bin"), str(tmp_path / "out.bin"), str(B), str(h), str(w),
                    str(int(fmt == "rgb"))] + [str(tmp_path / f"table{q}.bin") for q in qualities],
                   check=True, timeout=120)
    return np.fromfile(tmp_path / "out.bin", np.int16).reshape(len(qualities), B, -1, 64)


def j1_frames(kind: str, fmt: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    """Two frames: noise, all 0, all 255, or 0/255 checkerboards of period 1
    and 8 (the worst cases of the transform's odd terms)."""
    shape = (2, h * 3 // 2, w) if fmt == "i420" else (2, h, w, 3)
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    if kind in ("zeros", "ones"):
        return np.full(shape, 0 if kind == "zeros" else 255, np.uint8)
    period = int(kind[len("checker"):])
    yy, xx = np.indices(shape[1:3])
    board = (((yy // period + xx // period) % 2) * 255).astype(np.uint8)
    return np.broadcast_to(board[None, ..., None] if fmt == "rgb" else board[None], shape).copy()


# I420 36x34, RGB 17x9 and 13x21 (several MCU rows, dummy blocks), I420 20x280
# and RGB 31x270 (three strips of MCUs, the last partial)
J1_SIZES = [("i420", (36, 34)), ("i420", (20, 280)), ("rgb", (17, 9)), ("rgb", (13, 21)), ("rgb", (31, 270))]
J1_KINDS = ["noise", "zeros", "ones", "checker1", "checker8"]
QUALITIES = (1, 50, 90, 100)


@pytest.mark.parametrize("kind", J1_KINDS)
@pytest.mark.parametrize("fmt_hw", J1_SIZES, ids=[f"{f}-{h}x{w}" for f, (h, w) in J1_SIZES])
def test_fdct_kernel_source_matches_reference(j1_binary, tmp_path, fmt_hw, kind):
    fmt, (h, w) = fmt_hw
    frames = j1_frames(kind, fmt, h, w)
    got = _run(j1_binary, tmp_path, frames, QUALITIES, fmt)
    for q, g in zip(QUALITIES, got):
        want = jpeg.fdct_quant_reference(torch.from_numpy(frames), q, fmt).numpy()
        np.testing.assert_array_equal(g, want, err_msg=f"q {q}")
