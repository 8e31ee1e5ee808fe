// K3 in bf16: non-causal, unmasked attention forward, softmax(Q K^T /
// sqrt(512)) V, one head of d = 512, bf16 in and out, f32 accumulation,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash_attention call of
// latentblending_tpu/models/layers.py VAEAttention.__call__ (the VAE mid
// block, decoder and encoder) for a VAE that runs in bf16;
// csrc/attention_d512_f32.cu is the f32 one. q, k, v and out are
// [B, L, 1, 512] row-major.
//
// What bounds it on the H100: the tensor cores. At [4, 4096, 1, 512] it
// does 137 GFLOP on 67 MB, ~2000 flop per byte, far above the bf16 ridge
// (~295): the bound is flops over the 989 TFLOP/s bf16 peak.
//
// Design: the structure of the f32 kernel with one bf16 mma.sync pass in
// place of its three TF32 passes. A 64-row query tile at d = 512 keeps a
// 64 x 512 f32 O accumulator (128 KB), more than one CTA's registers, so d
// is split across a 2-CTA thread-block cluster; CTA r owns columns
// [256r, 256r + 256):
//   1. it keeps its half of the Q tile in shared memory (32 KB, rows
//      padded against bank conflicts) for the whole sweep;
//   2. K/V tiles of 64 rows stream by cp.async in 64 x 64 chunks (this
//      CTA's 4 K chunks, then its 4 V chunks) through a ring of NS = 4
//      stages, so the next chunks load while the current one is computed;
//   3. it computes its partial S = Q_r K_r^T (64 x 64) over its 256
//      columns with mma.sync m16n8k16 (bf16 in, f32 accumulate), operand
//      fragments loaded as 32-bit words;
//   4. each CTA writes its partial S into its own and its partner's shared
//      memory (st.shared::cluster), one cluster barrier per tile; both then
//      hold rank 0's + rank 1's partial, summed in that order, and run the
//      same online softmax (4 threads per row, exp2 with log2(e)/sqrt(d)
//      folded in). P is rounded to bf16 into its own buffer (the row sum
//      keeps the unrounded values, as in the d = 64 kernel), the row
//      rescale factor beside it;
//   5. each CTA does P V for its own 256 output columns: V's B fragments
//      come from its row-major chunk by ldmatrix.trans; O (64 x 256 f32)
//      lives in registers, 64 per thread over 256 threads.
// The exchange buffers are double-buffered by tile parity, so one cluster
// barrier per tile suffices. A chunk of 2 images gives 256 CTAs.
// Simple and right first: wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 512;
constexpr int kDH = kD / 2;       // columns per CTA of the cluster
constexpr int kBQ = 64;           // query rows per cluster
constexpr int kBK = 64;           // key rows per tile
// 8 warps: 4 row groups of 16 rows x 2 column groups of 32 columns of S
// and of each 64-column O chunk; the softmax runs 4 threads per row.
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kNT = 4;    // n8-tiles per warp (S and each O chunk)
constexpr int kTPR = 4;   // softmax threads per row
constexpr int kCPT = 16;  // softmax columns per thread
// padded row strides (bf16 elements): 132 and 36 words, 4 mod 32, keep a
// fragment's 32 lanes (word 4*row + col) and ldmatrix's 8 rows of 16 bytes
// on distinct banks
constexpr int kQS = kDH + 8;
constexpr int kCS = 64 + 8;
constexpr int kXS = kBK + 4;      // f32 exchange rows
constexpr int kSlot = 64 * kCS;   // one ring slot holds a 64 x 64 K or V chunk

template <int NS>
struct K3B16Smem {  // byte offsets, each a multiple of 16
  static constexpr size_t kQ = 0;
  static constexpr size_t kRing = kQ + sizeof(bf16) * kBQ * kQS;
  static constexpr size_t kP = kRing + sizeof(bf16) * NS * kSlot;
  static constexpr size_t kX = kP + sizeof(bf16) * kBQ * kCS;       // [tile parity][rank][kBQ][kXS]
  static constexpr size_t kAlpha = kX + sizeof(float) * 2 * 2 * kBQ * kXS;
  static constexpr size_t kInv = kAlpha + sizeof(float) * kBQ;
  static constexpr size_t kBytes = kInv + sizeof(float) * kBQ;
  static_assert(kRing % 16 == 0 && kP % 16 == 0 && kX % 16 == 0, "16-byte aligned regions");
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NS>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
attention_d512_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                           bf16* __restrict__ out, int L, float scale_log2) {
  using S = K3B16Smem<NS>;
  extern __shared__ __align__(16) uint8_t smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + S::kQ);
  bf16* ring = reinterpret_cast<bf16*>(smem + S::kRing);
  bf16* sP = reinterpret_cast<bf16*>(smem + S::kP);
  float* xbuf = reinterpret_cast<float*>(smem + S::kX);
  float* sAlpha = reinterpret_cast<float*>(smem + S::kAlpha);
  float* sInv = reinterpret_cast<float*>(smem + S::kInv);

  const uint32_t rank = lb::cluster_ctarank();
  const uint32_t peer = rank ^ 1u;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = (blockIdx.x >> 1) * kBQ;
  const int64_t base = (int64_t)blockIdx.y * L * kD;
  const int col0 = rank * kDH;
  const int ntiles = L / kBK;
  const int nchunks = 8 * ntiles;

  // this CTA's half of the Q tile (512 bytes a row): one cp.async group
  for (int x = tid; x < kBQ * kDH / 8; x += kThreads) {
    const int row = x / (kDH / 8), seg = x % (kDH / 8);
    lb::cp_async16(sQ + row * kQS + 8 * seg, q + base + (int64_t)(q0 + row) * kD + col0 + 8 * seg);
  }
  lb::cp_async_commit();
  // chunk n of the stream: tile n/8; K column chunk n%8 (< 4) or V column chunk n%8 - 4
  auto load_chunk = [&](int n) {
    if (n < nchunks) {
      const int tile = n / 8, i = n % 8;
      const bf16* src = (i < 4 ? k : v) + base + (int64_t)tile * kBK * kD + col0 + 64 * (i % 4);
      bf16* dst = ring + (n % NS) * kSlot;
      for (int x = tid; x < 64 * 8; x += kThreads) {
        const int row = x / 8, seg = x % 8;
        lb::cp_async16(dst + row * kCS + 8 * seg, src + (int64_t)row * kD + 8 * seg);
      }
    }
    lb::cp_async_commit();  // empty groups past the end keep the count uniform
  };
  for (int n = 0; n < NS - 1; ++n) load_chunk(n);
  lb::cluster_sync();  // the partner is running before any store into its shared memory

  const int wr = 16 * (warp % 4);       // this warp's 16 rows of the tile
  const int wc = 8 * kNT * (warp / 4);  // its 8*kNT columns of S, and of each 64-column O chunk
  const int srow = tid / kTPR;          // softmax: kTPR threads per row, kCPT columns each
  const int spart = tid % kTPR;
  float m_run = -INFINITY;  // running row max (log2 units), same in the threads of a row
  float l_run = 0.f;        // this thread's part of the running row sum
  // ldmatrix.trans row of this lane for a 16-key x 16-column block of V:
  // matrices (keys 0-7 | 8-15) x (columns 0-7 | 8-15)
  const int lm_key = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lm_col = 8 * (lane >> 4);

  float o[4][kNT][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[c][nt][r] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    float* xb = xbuf + (j & 1) * 2 * kBQ * kXS;  // [rank][kBQ][kXS]: the partial scores
    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = 0.f;

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = 8 * j + i;
      lb::cp_async_wait<NS - 2>();  // chunk n (and Q) have landed
      __syncthreads();              // ... for every thread; slot (n-1)%NS is free
      load_chunk(n + NS - 1);
      const bf16* ch = ring + (n % NS) * kSlot;

      if (i < 4) {
        // partial S += Q[:, 64i : 64i+64] K_chunk^T in 4 k16-steps
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const bf16* qa = sQ + (wr + g) * kQS + 64 * i + 16 * kk + 2 * t;
          const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * kQS), ld32(qa + 8), ld32(qa + 8 * kQS + 8)};
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const bf16* kb = ch + (wc + 8 * nt + g) * kCS + 16 * kk + 2 * t;
            lb::mma_bf16(s[nt], a, ld32(kb), ld32(kb + 8));
          }
        }
        if (i == 3) {
          // exchange the partial scores: into slot [rank] here and in the partner
          float* mine = xb + rank * kBQ * kXS;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float* p = mine + (wr + g + 8 * e) * kXS + wc + 8 * nt + 2 * t;
              *reinterpret_cast<float2*>(p) = make_float2(s[nt][2 * e], s[nt][2 * e + 1]);
              lb::st_cluster_v2(lb::map_shared_rank(lb::smem_u32(p), peer), s[nt][2 * e], s[nt][2 * e + 1]);
            }
          lb::cluster_sync();

          // online softmax on the full scores (rank 0 + rank 1, the same sum in both CTAs)
          const float* x0 = xb + srow * kXS + kCPT * spart;
          const float* x1 = x0 + kBQ * kXS;
          float sv[kCPT];
#pragma unroll
          for (int c4 = 0; c4 < kCPT / 4; ++c4) {
            const float4 a = *reinterpret_cast<const float4*>(x0 + 4 * c4);
            const float4 b = *reinterpret_cast<const float4*>(x1 + 4 * c4);
            sv[4 * c4 + 0] = a.x + b.x;
            sv[4 * c4 + 1] = a.y + b.y;
            sv[4 * c4 + 2] = a.z + b.z;
            sv[4 * c4 + 3] = a.w + b.w;
          }
          float mx = sv[0];
#pragma unroll
          for (int c = 1; c < kCPT; ++c) mx = fmaxf(mx, sv[c]);
#pragma unroll
          for (int w = 1; w < kTPR; w *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float m_new = fmaxf(m_run, mx * scale_log2);
          const float alpha = exp2f(m_run - m_new);  // 0 on the first tile
          m_run = m_new;
          float sum = 0.f;
          uint32_t pk[kCPT / 2];
#pragma unroll
          for (int c2 = 0; c2 < kCPT / 2; ++c2) {
            const float p0 = exp2f(fmaf(sv[2 * c2], scale_log2, -m_new));
            const float p1 = exp2f(fmaf(sv[2 * c2 + 1], scale_log2, -m_new));
            sum += p0 + p1;
            pk[c2] = pack_bf16(p0, p1);
          }
          uint4* pdst = reinterpret_cast<uint4*>(sP + srow * kCS + kCPT * spart);
          pdst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
          pdst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
          l_run = l_run * alpha + sum;
          if (spart == 0) sAlpha[srow] = alpha;
          // P and alpha are read after the next step's __syncthreads
        }
      } else {
        const int c = i - 4;  // this CTA's output columns [64c, 64c + 64)
        if (c == 0) {
          const float a0 = sAlpha[wr + g], a1 = sAlpha[wr + g + 8];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
#pragma unroll
            for (int nt = 0; nt < kNT; ++nt) {
              o[cc][nt][0] *= a0;
              o[cc][nt][1] *= a0;
              o[cc][nt][2] *= a1;
              o[cc][nt][3] *= a1;
            }
        }
        // O[:, chunk c] += P V_chunk in 4 k16-steps of 16 keys
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const bf16* pa = sP + (wr + g) * kCS + 16 * kk + 2 * t;
          const uint32_t a[4] = {ld32(pa), ld32(pa + 8 * kCS), ld32(pa + 8), ld32(pa + 8 * kCS + 8)};
#pragma unroll
          for (int np = 0; np < kNT / 2; ++np) {
            uint32_t b[4];  // B fragments of n8-tiles 2np (b[0], b[1]) and 2np + 1 (b[2], b[3])
            lb::ldmatrix_x4_trans(b, ch + (16 * kk + lm_key) * kCS + wc + 16 * np + lm_col);
            lb::mma_bf16(o[c][2 * np], a, b[0], b[1]);
            lb::mma_bf16(o[c][2 * np + 1], a, b[2], b[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int w = 1; w < kTPR; w *= 2) l_run += __shfl_xor_sync(0xffffffffu, l_run, w);
  if (spart == 0) sInv[srow] = 1.f / l_run;
  __syncthreads();
  const float inv0 = sInv[wr + g], inv1 = sInv[wr + g + 8];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float inv = e ? inv1 : inv0;
        bf16* dst = out + base + (int64_t)(q0 + wr + g + 8 * e) * kD + col0 + 64 * c + wc + 8 * nt + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(dst) =
            __floats2bfloat162_rn(o[c][nt][2 * e] * inv, o[c][nt][2 * e + 1] * inv);
      }
  lb::cluster_sync();  // no CTA leaves while its partner may still address its shared memory
}

template <int NS>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H, float scale,
           void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H != 1 || L % kBQ != 0 || L % kBK != 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_d512_bf16_kernel<NS>;
  const int bytes = static_cast<int>(K3B16Smem<NS>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(2 * (L / kBQ), B);  // the two CTAs of a cluster are neighbours in x
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), L, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 in bf16: VAE mid-block attention, one head of d = 512, bf16 in/out.
extern "C" int lb_attention_fwd_d512_bf16(const void* q, const void* k, const void* v, void* out, int B, int L,
                                          int H, float scale, void* stream) {
  return launch<4>(q, k, v, out, B, L, H, scale, stream);
}
