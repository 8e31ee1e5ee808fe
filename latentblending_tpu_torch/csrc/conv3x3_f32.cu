// C1: 3x3 convolution, stride 1, zero padding 1, with bias, float32 in and
// out, NCHW, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA
// (flax nn.Conv in latentblending_tpu/models/layers.py), and the port ran
// them on cuDNN, whose float32 path with TF32 off is an FFMA implicit GEMM
// on the CUDA cores (67 TFLOP/s peak). It was added for the f32 VAE
// decoder, whose 31 3x3 convolutions a decode call were the heaviest device
// work of every benchmark cell; any f32 3x3 stride-1 convolution whose
// channels it takes runs here (models/layers.py::Conv3x3 routes them).
//
// What bounds it on the H100: arithmetic at f32 accuracy. One TF32 pass
// keeps ~3 decimal digits; the decoder is held to float32. So every product
// runs in 3xTF32, as K2 and K3 in f32 do: each operand x splits into
// hi = x truncated to TF32 and lo = x - hi (exact in f32), and a.b is
// lo_a hi_b + hi_a lo_b + hi_a hi_b on TF32 wgmma. Its bound is three TF32
// products per f32 one over the 495 TFLOP/s TF32 peak.
//
// Design (an implicit GEMM on warpgroup MMA, warp-specialised):
//   - D[pixel, cout] = sum_k A[pixel, k] B[k, cout]: the output pixels are
//     the wgmma's M, the output channels its N and k runs over (input
//     channel, tap). A CTA owns 128 pixels (two runs of 64, one a consumer
//     warpgroup) by 128 output channels; K goes in blocks of 8 input
//     channels x 9 taps, one wgmma k8 step a tap (k = the channel);
//   - A comes from registers, where NCHW needs no transpose: each K block's
//     input box (8 channels x (rows + 2) x (columns + 2 rounded up), the
//     zero padding and the image's edges being TMA's out-of-bounds zeros)
//     is one 4-d TMA load a run, and each thread reads its fragment of
//     every tap from it, split into hi and lo in registers. A run is 64
//     pixels of one image row, or 2 x 32 or 4 x 16 where the image is that
//     narrow; the box's channel stride is 24 or 8 banks mod 32 at 64 and
//     16 columns (conflict-free fragment loads);
//   - B is the weights, OIHW as the module stores them: no copy of them is
//     kept. The producer warpgroup's thread n reads output channel n's 72
//     weights of the block (16-byte loads) and writes them, split, as two
//     [9 taps][128 rows][8 k] tiles (hi and lo) in the 32-byte swizzle,
//     K-major as TF32 wgmma wants B;
//   - two stages (the weights' hi and lo, 72 KB, and the two input boxes),
//     mbarriers "xfull" (TMA bytes), "wfull" (the producer's 128 threads,
//     each after a proxy fence) and "empty" (the 256 consumer threads);
//   - each tap is three wgmma m64n128k8 (lo*hi, hi*lo, hi*hi) in one commit
//     group; the tap's A registers are double-buffered (wait for the group
//     before the last);
//   - the tensor core rounds toward zero on every add into its
//     accumulator, so over K = 9 x Cin (up to 4608) the f32 result would
//     lose ~1e-4 of its size (K3 f32 measured the same growth over keys).
//     Each K block starts a fresh accumulator (27 adds), and its sum is
//     folded into a float32 total by round-to-nearest adds;
//   - the bias is added in the epilogue, which writes NCHW directly (each
//     store 8 consecutive pixels of 4 channels).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int kBN = 128;         // output channels per CTA (the wgmma N)
constexpr int kRun = 64;         // pixels per consumer warpgroup (the wgmma M)
constexpr int kCB = 8;           // input channels per K block (a tap's k8 step)
constexpr int kTaps = 9;
constexpr int kStages = 2;
constexpr int kConsumers = 256;  // two warpgroups, one run each
constexpr int kProducers = 128;  // one warpgroup, a thread per output channel of the tile
constexpr int kThreads = kConsumers + kProducers;
static_assert(kProducers == kBN, "a producer thread writes one row of B");
// registers a thread after setmaxnreg: 128 x 96 + 256 x 200 <= the 384 x
// 168 the CTA is launched with (at 64 and 80 the producer spilled: ptxas
// loads a block's second half of weights before the first is stored)
constexpr int kProducerRegs = 96;
constexpr int kConsumerRegs = 200;
constexpr int kTapBytes = kBN * 32;  // one tap of B: 128 rows x 8 f32 in the 32-byte swizzle
constexpr int kXSlotBytes = 6912;    // one run's input box, at most 72 x 3 x 8 f32
// the input box starts 4 columns left of its run: a TMA box's first column
// must lie on a 16-byte boundary (a box at column x0 - 1 faults with an
// illegal instruction), so the padding column x0 - 1 is the box's column 3
constexpr int kXLead = 4;

struct Smem {  // byte offsets from a 1024-byte aligned base; per stage: B hi, B lo, two input boxes
  static constexpr int kBhi = 0;
  static constexpr int kBlo = kTaps * kTapBytes;
  static constexpr int kX = 2 * kTaps * kTapBytes;
  static constexpr int kStageBytes = kX + 2 * kXSlotBytes;
  static constexpr int kBar = kStages * kStageBytes;
  static constexpr int kNumBars = 3 * kStages;  // xfull, wfull, empty
  static constexpr size_t kBytes = 1024 + kBar + 8 * kNumBars;  // + alignment slack
  static_assert(kStageBytes % 256 == 0 && kX % 128 == 0 && kXSlotBytes % 128 == 0, "tile alignment");
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

struct Params {
  int B, Cin, Cout, H, W;
  int tc_shift;  // log2 of a run's columns (64, 32 or 16)
  int tr;        // a run's rows (64 / columns)
  int twp;       // floats in a row of the input box (>= columns + 2, a multiple of 4)
  int nrx, nry;  // runs across the image and down it
  int ntn;       // tiles of kBN output channels
  int xbytes;    // bytes of one input box
};

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// lo = x - hi, exact in f32
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return __float_as_uint(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// (image, first row, first column) of run `run`
__device__ __forceinline__ void run_origin(const Params& p, int run, int& b, int& y0, int& x0) {
  x0 = (run % p.nrx) << p.tc_shift;
  const int t = run / p.nrx;
  y0 = (t % p.nry) * p.tr;
  b = t / p.nry;
}

// 36 weights of one output channel: 4 input channels x 9 taps, contiguous
// in OIHW (zeros for a row past Cout)
__device__ __forceinline__ void load_weights(float (&v)[36], const float* src, bool valid) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float4 x = valid ? __ldg(reinterpret_cast<const float4*>(src) + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    v[4 * i] = x.x;
    v[4 * i + 1] = x.y;
    v[4 * i + 2] = x.z;
    v[4 * i + 3] = x.w;
  }
}

// Row q of B's hi and lo tiles, k 4h..4h+3 (input channels 4h..4h+3 of the
// block) of every tap: one 16-byte chunk a tap and tile, at chunk h of the
// 32-byte row, swizzled
__device__ __forceinline__ void store_weights(const float (&v)[36], uint32_t row_addr, int h, uint32_t swz) {
  const uint32_t chunk = (uint32_t(h) << 4) ^ swz;
#pragma unroll
  for (int tap = 0; tap < kTaps; ++tap) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      hi[c] = lb::tf32_trunc(v[kTaps * c + tap]);
      lo[c] = tf32_lo(v[kTaps * c + tap], hi[c]);
    }
    const uint32_t a = row_addr + tap * kTapBytes + chunk;
    st_shared_v4(a + Smem::kBhi, hi[0], hi[1], hi[2], hi[3]);
    st_shared_v4(a + Smem::kBlo, lo[0], lo[1], lo[2], lo[3]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_f32_kernel(const __grid_constant__ CUtensorMap tx, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (lb::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem + Smem::kBar);
  uint64_t* wfull = xfull + kStages;
  uint64_t* empty = wfull + kStages;

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % p.ntn) * kBN;  // output-channel tiles of one pixel pair are neighbours
  const int pair = blockIdx.x / p.ntn;
  const int nkb = p.Cin / kCB;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      lb::mbar_init(&xfull[s], 1);
      lb::mbar_init(&wfull[s], kProducers);
      lb::mbar_init(&empty[s], kConsumers);
    }
    lb::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------------------ producer
    lb::setmaxnreg_dec<kProducerRegs>();
    const int q = tid - kConsumers;  // the output channel (row of B) this thread writes
    const bool valid = n0 + q < p.Cout;
    const float* wrow = w + (int64_t)(valid ? n0 + q : 0) * p.Cin * kTaps;
    const uint32_t row0 = lb::smem_u32(smem) + q * 32;
    const uint32_t swz = uint32_t((q >> 2) & 1) << 4;
#pragma unroll 1
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb & 1;
      float v[36];
      load_weights(v, wrow + kb * kCB * kTaps, valid);  // before the stage is free
      // empty[s]: the consumers' products of block kb - 2 (its last readers) completed
      if (kb >= kStages) lb::mbar_wait(&empty[s], ((kb >> 1) - 1) & 1);
      uint8_t* st = smem + s * Smem::kStageBytes;
      if (q == 0) {  // xfull[s]: the TMA's bytes of both runs' input boxes
        lb::mbar_expect_tx(&xfull[s], 2 * p.xbytes);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          int b, y0, x0;
          run_origin(p, 2 * pair + r, b, y0, x0);
          lb::tma_load_4d(st + Smem::kX + r * kXSlotBytes, &tx, &xfull[s], x0 - kXLead, y0 - 1, kb * kCB, b);
        }
      }
      const uint32_t row = row0 + s * Smem::kStageBytes;
      store_weights(v, row, 0, swz);
      load_weights(v, wrow + kb * kCB * kTaps + 4 * kTaps, valid);
      store_weights(v, row, 1, swz);
      // wfull[s]: each producer thread's stores, fenced for the async proxy
      lb::fence_proxy_async();
      lb::mbar_arrive(&wfull[s]);
    }
  } else {
    // ------------------------------------------------------------ consumers
    lb::setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group
    const int cs = (p.tr + 2) * p.twp;  // floats between channels of the input box

    // pixels g and g + 8 of this warp's 16 rows of the run: (row, column)
    int prow[2], pcol[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 16 * warp + g + 8 * h;
      prow[h] = m >> p.tc_shift;
      pcol[h] = m & ((1 << p.tc_shift) - 1);
    }
    // box offsets (floats) of the A fragment at tap (0, 0): (pixel g, k t),
    // (g + 8, t), (g, t + 4), (g + 8, t + 4), k being the input channel
    int off[4];
    off[0] = t * cs + prow[0] * p.twp + pcol[0] + kXLead - 1;
    off[1] = t * cs + prow[1] * p.twp + pcol[1] + kXLead - 1;
    off[2] = off[0] + 4 * cs;
    off[3] = off[1] + 4 * cs;

    float acc[64], total[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;
    uint32_t ah[2][4], al[2][4];
    const uint32_t b_base = lb::smem_u32(smem);

#pragma unroll 1
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb & 1;
      const uint32_t parity = (kb >> 1) & 1;
      lb::mbar_wait(&xfull[s], parity);
      lb::mbar_wait(&wfull[s], parity);
      const float* xs = reinterpret_cast<const float*>(smem + s * Smem::kStageBytes + Smem::kX + wg * kXSlotBytes);
      const uint32_t bb = lb::opaque(b_base + s * Smem::kStageBytes);
#pragma unroll
      for (int j = 0; j < kTaps; ++j) {
        const int buf = j & 1;
        const int tap_off = (j / 3) * p.twp + j % 3;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = xs[off[i] + tap_off];
          ah[buf][i] = lb::tf32_trunc(x);
          al[buf][i] = tf32_lo(x, ah[buf][i]);
        }
        const uint32_t bhi = bb + Smem::kBhi + j * kTapBytes;
        const uint32_t blo = bb + Smem::kBlo + j * kTapBytes;
        lb::wgmma_fence();
        lb::wgmma_m64n128k8_tf32_rs(acc, al[buf], lb::sw32_desc(bhi), j > 0);
        lb::wgmma_m64n128k8_tf32_rs(acc, ah[buf], lb::sw32_desc(blo), 1);
        lb::wgmma_m64n128k8_tf32_rs(acc, ah[buf], lb::sw32_desc(bhi), 1);
        lb::wgmma_commit();
        if (j > 0) {  // the previous tap's group is done: its A registers may be reused
          lb::wgmma_wait<1>();
          pin(ah[buf ^ 1]);
          pin(al[buf ^ 1]);
        }
      }
      lb::wgmma_wait<0>();
      pin(ah[0]);
      pin(al[0]);
      pin(ah[1]);
      pin(al[1]);
      lb::mbar_arrive(&empty[s]);  // empty[s]: this thread is done with block kb's stage
      lb::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
    }

    // epilogue: + bias, NCHW stores. Register 4i + 2h + e holds pixel
    // g + 8h, output channel 8i + 2t + e of the tile.
    int b, y0, x0;
    run_origin(p, 2 * pair + wg, b, y0, x0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int y = y0 + prow[h], x = x0 + pcol[h];
      if (b >= p.B || y >= p.H || x >= p.W) continue;
      float* dst = out + ((int64_t)b * p.Cout * p.H + y) * p.W + x;
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * i + 2 * t + e;
          if (n < p.Cout)
            dst[(int64_t)n * p.H * p.W] = total[4 * i + 2 * h + e] + (bias != nullptr ? __ldg(bias + n) : 0.f);
        }
    }
  }
}

int launch(const void* x, const void* w, const void* bias, void* out, int B, int Cin, int Cout, int H, int W,
           void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cout <= 0) return 0;
  if (Cin <= 0 || Cin % kCB != 0 || W % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv3x3_f32_kernel;
  // setmaxnreg only moves registers within the CTA's allocation, fixed at
  // launch by the kernel's register count: refuse a build whose count
  // would leave the consumers' setmaxnreg.inc waiting forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kThreads < kProducers * kProducerRegs + kConsumers * kConsumerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);

  // a run: 64 pixels of one row, or 2 x 32 or 4 x 16 of a narrow image. The
  // box's row (>= kXLead + columns + 1 floats, a multiple of 4) makes the
  // channel stride 24 or 8 banks mod 32 at 64 and 16 columns (conflict-free
  // fragment loads); at 32 no multiple of 4 does, and 16 banks costs a
  // two-way conflict
  Params p;
  p.B = B, p.Cin = Cin, p.Cout = Cout, p.H = H, p.W = W;
  p.tc_shift = W > 32 ? 6 : W > 16 ? 5 : 4;
  p.tr = kRun >> p.tc_shift;
  p.twp = p.tc_shift == 6 ? 72 : p.tc_shift == 5 ? 44 : 28;
  p.nrx = (W + (1 << p.tc_shift) - 1) >> p.tc_shift;
  p.nry = (H + p.tr - 1) / p.tr;
  p.ntn = (Cout + kBN - 1) / kBN;
  p.xbytes = p.twp * (p.tr + 2) * kCB * 4;
  const int64_t runs = (int64_t)B * p.nry * p.nrx;
  const int64_t blocks = (runs + 1) / 2 * p.ntn;
  if (p.xbytes > kXSlotBytes || blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);

  // x [B, Cin, H, W] read in boxes of (twp columns, tr + 2 rows, 8 channels, 1 image)
  lb::EncodeTiledFn fn = lb::encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)Cin, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4, (cuuint64_t)Cin * H * W * 4};
  const cuuint32_t box[4] = {(cuuint32_t)p.twp, (cuuint32_t)(p.tr + 2), (cuuint32_t)kCB, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  if (fn(&tx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  const int bytes = static_cast<int>(Smem::kBytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tx, static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C1: 3x3 stride-1 padding-1 convolution with bias (bias may be null),
// f32 NCHW in and out, 3xTF32 on wgmma.
extern "C" int lb_conv3x3_f32(const void* x, const void* w, const void* bias, void* out, int B, int Cin, int Cout,
                              int H, int W, void* stream) {
  return launch(x, w, bias, out, B, Cin, Cout, H, W, stream);
}
