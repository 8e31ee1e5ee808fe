// K3: non-causal, unmasked attention forward, softmax(Q K^T / sqrt(512)) V,
// one head of d = 512, f32 in and out, for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash_attention call of
// latentblending_tpu/models/layers.py VAEAttention.__call__ (the VAE mid
// block). q, k, v and out are [B, L, 1, 512] row-major.
//
// What bounds it on the H100: arithmetic at f32 accuracy. At the main
// path's [4, 4096, 1, 512] it does 137 GFLOP. The f32 CUDA cores peak at
// ~67 TFLOP/s and the plain version (cuBLAS SGEMM, TF32 off) already runs
// at ~42 TFLOP/s, so no CUDA-core kernel beats it by much. One TF32 pass
// keeps ~3 decimal digits, outside the 1e-4 relative bound against the
// plain f32 result. So both products run on the tensor cores in 3xTF32:
// each operand x splits into hi = x rounded to TF32 and lo = x - hi, and
// each product is hi*hi + hi*lo + lo*hi, accumulated in f32 (mma.sync
// m16n8k8 TF32, fragments split in registers; the cross terms in their
// own accumulators). Measured on the H100, it runs TF32 mma.sync at ~124
// TFLOP/s (~41 TFLOP/s of f32 work, at par with the plain version), and
// its time did not move with the instruction mix, the warp count or the
// ring depth; what holds it there is at the end of the design notes.
//
// The CUDA-core kernel it replaces was bound by shared-memory bandwidth
// (two operand loads per FMA), re-streamed K and V from L2 once per 16
// query rows, and ran its softmax on 16 of 256 threads.
//
// Design. A 64-row query tile at d = 512 f32 is 128 KB, so Q, a K/V tile
// and O do not fit one CTA's 227 KB together. d is split across a
// 2-CTA thread-block cluster; CTA r owns columns [256r, 256r + 256):
//   1. it keeps its half of the Q tile in shared memory (64 KB, rows padded
//      against bank conflicts) for the whole sweep;
//   2. K/V tiles of 64 rows stream by cp.async in 64 x 64 chunks (this
//      CTA's 4 K chunks, then its 4 V chunks) through a ring of NS = 4
//      stages (3 measured the same), so the next chunks load while the
//      current one is computed;
//   3. it computes its partial S = Q_r K_r^T (64 x 64) over its 256 columns;
//   4. each CTA writes its partial S into its own and its partner's shared
//      memory (distributed shared memory, st.shared::cluster), one cluster
//      barrier per tile; both then hold rank 0's + rank 1's partial, summed
//      in that order, and run the same online softmax (4 threads per row,
//      exp2 with log2(e)/sqrt(d) folded in). P is written back split into
//      hi/lo TF32 in place, and the row rescale factor beside it;
//   5. each CTA does P V for its own 256 output columns: O (64 x 256 f32)
//      lives in registers, 64 per thread over 256 threads (8 warps; 16
//      measured slower), plus 64 for the cross terms' accumulators.
// The exchange buffers are double-buffered by tile parity, so one cluster
// barrier per tile suffices. Each 64 query rows stream K and V from L2
// once (the old kernel: once per 16 rows), and a chunk of 2 images gives
// 256 CTAs.
//
// Measured on the H100 (PERF.md), the kernel keeps the tensor pipe ~40%
// busy: its MMAs, operand loads and splits run in lockstep between the
// per-chunk barriers and overlap poorly; removing the MMAs alone cut its
// time by 2/3, though mma.sync TF32 itself reaches ~320 TFLOP/s here.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

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
// padded row strides (floats): each keeps an operand fragment's 32 lanes on
// 32 distinct banks (Q, K, P: 4*row + col; V: 8*row + col, mod 32)
constexpr int kQS = kDH + 4;
constexpr int kKS = 64 + 4;
constexpr int kVS = 64 + 8;
constexpr int kXS = kBK + 4;
constexpr int kSlot = 64 * kVS;   // one ring slot holds a 64 x 64 K or V chunk

template <int NS>
struct K3Smem {
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kBQ * kQS;
  static constexpr int kX = kRing + NS * kSlot;       // [tile parity][rank][kBQ][kXS]
  static constexpr int kAlpha = kX + 2 * 2 * kBQ * kXS;
  static constexpr int kInv = kAlpha + kBQ;
  static constexpr size_t kBytes = sizeof(float) * (kInv + kBQ);
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

template <int NS>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
attention_d512_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                          float* __restrict__ out, int L, float scale_log2) {
  using S = K3Smem<NS>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem + S::kQ;
  float* ring = smem + S::kRing;
  float* xbuf = smem + S::kX;
  float* sAlpha = smem + S::kAlpha;
  float* sInv = smem + S::kInv;

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

  // this CTA's half of the Q tile: one cp.async group
  for (int x = tid; x < kBQ * kDH / 4; x += kThreads) {
    const int row = x / (kDH / 4), seg = x % (kDH / 4);
    lb::cp_async16(sQ + row * kQS + 4 * seg, q + base + (int64_t)(q0 + row) * kD + col0 + 4 * seg);
  }
  lb::cp_async_commit();
  // chunk n of the stream: tile n/8; K column chunk n%8 (< 4) or V column chunk n%8 - 4
  auto load_chunk = [&](int n) {
    if (n < nchunks) {
      const int tile = n / 8, i = n % 8;
      const float* src = (i < 4 ? k : v) + base + (int64_t)tile * kBK * kD + col0 + 64 * (i % 4);
      float* dst = ring + (n % NS) * kSlot;
      const int stride = i < 4 ? kKS : kVS;
      for (int x = tid; x < 64 * 16; x += kThreads) {
        const int row = x / 16, seg = x % 16;
        lb::cp_async16(dst + row * stride + 4 * seg, src + (int64_t)row * kD + 4 * seg);
      }
    }
    lb::cp_async_commit();  // empty groups past the end keep the count uniform
  };
  for (int n = 0; n < NS - 1; ++n) load_chunk(n);
  lb::cluster_sync();  // the partner is running before any store into its shared memory

  const int wr = 16 * (warp % 4);  // this warp's 16 rows of the tile
  const int wc = 8 * kNT * (warp / 4);  // its 8*kNT columns of S, and of each 64-column O chunk
  const int srow = tid / kTPR;          // softmax: kTPR threads per row, kCPT columns each
  const int spart = tid % kTPR;
  float m_run = -INFINITY;  // running row max (log2 units), same in the threads of a row
  float l_run = 0.f;        // this thread's part of the running row sum

  float o[4][kNT][4], oc[4][kNT][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[c][nt][r] = oc[c][nt][r] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    float* xb = xbuf + (j & 1) * 2 * kBQ * kXS;  // [rank][kBQ][kXS]: partial S, then P hi/lo
    float s[kNT][4], sc[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nt][r] = sc[nt][r] = 0.f;

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = 8 * j + i;
      lb::cp_async_wait<NS - 2>();  // chunk n (and Q) have landed
      __syncthreads();              // ... for every thread; slot (n-1)%NS is free
      load_chunk(n + NS - 1);
      const float* ch = ring + (n % NS) * kSlot;

      if (i < 4) {
        // partial S += Q[:, 64i : 64i+64] K_chunk^T
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float* qa = sQ + (wr + g) * kQS + 64 * i + 8 * kk + t;
          const float a[4] = {qa[0], qa[8 * kQS], qa[4], qa[8 * kQS + 4]};
          uint32_t ahi[4], alo[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) lb::split_tf32(a[r], ahi[r], alo[r]);
          uint32_t bhi[kNT][2], blo[kNT][2];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const float* kb = ch + (wc + 8 * nt + g) * kKS + 8 * kk + t;
            lb::split_tf32(kb[0], bhi[nt][0], blo[nt][0]);
            lb::split_tf32(kb[4], bhi[nt][1], blo[nt][1]);
          }
          lb::mma_3xtf32(s, sc, ahi, alo, bhi, blo);
        }
        if (i == 3) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r) s[nt][r] += sc[nt][r];
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
          float* x0 = xb + srow * kXS + kCPT * spart;
          float* x1 = x0 + kBQ * kXS;
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
#pragma unroll
          for (int c4 = 0; c4 < kCPT / 4; ++c4) {
            float hi[4], lo[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const float p = exp2f(fmaf(sv[4 * c4 + u], scale_log2, -m_new));
              sum += p;
              uint32_t h, l;
              lb::split_tf32(p, h, l);
              hi[u] = __uint_as_float(h);
              lo[u] = __uint_as_float(l);
            }
            *reinterpret_cast<float4*>(x0 + 4 * c4) = make_float4(hi[0], hi[1], hi[2], hi[3]);
            *reinterpret_cast<float4*>(x1 + 4 * c4) = make_float4(lo[0], lo[1], lo[2], lo[3]);
          }
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
              oc[cc][nt][0] *= a0;
              oc[cc][nt][1] *= a0;
              oc[cc][nt][2] *= a1;
              oc[cc][nt][3] *= a1;
            }
        }
        // O[:, chunk c] += P V_chunk, P already split (hi in slot 0, lo in slot 1)
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float* ph = xb + (wr + g) * kXS + 8 * kk + t;
          const float* pl = ph + kBQ * kXS;
          const uint32_t ahi[4] = {__float_as_uint(ph[0]), __float_as_uint(ph[8 * kXS]), __float_as_uint(ph[4]),
                                   __float_as_uint(ph[8 * kXS + 4])};
          const uint32_t alo[4] = {__float_as_uint(pl[0]), __float_as_uint(pl[8 * kXS]), __float_as_uint(pl[4]),
                                   __float_as_uint(pl[8 * kXS + 4])};
          uint32_t bhi[kNT][2], blo[kNT][2];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const float* vb = ch + (8 * kk + t) * kVS + wc + 8 * nt + g;
            lb::split_tf32(vb[0], bhi[nt][0], blo[nt][0]);
            lb::split_tf32(vb[4 * kVS], bhi[nt][1], blo[nt][1]);
          }
          lb::mma_3xtf32(o[c], oc[c], ahi, alo, bhi, blo);
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
        float* dst = out + base + (int64_t)(q0 + wr + g + 8 * e) * kD + col0 + 64 * c + wc + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(dst) = make_float2((o[c][nt][2 * e] + oc[c][nt][2 * e]) * inv,
                                                      (o[c][nt][2 * e + 1] + oc[c][nt][2 * e + 1]) * inv);
      }
  lb::cluster_sync();  // no CTA leaves while its partner may still address its shared memory
}

template <int NS>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H, float scale,
           void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H != 1 || L % kBQ != 0 || L % kBK != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_d512_f32_kernel<NS>;
  const int bytes = static_cast<int>(K3Smem<NS>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(2 * (L / kBQ), B);  // the two CTAs of a cluster are neighbours in x
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), L, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: VAE mid-block attention, one head of d = 512, f32.
extern "C" int lb_attention_fwd_d512_f32(const void* q, const void* k, const void* v, void* out, int B, int L,
                                         int H, float scale, void* stream) {
  return launch<4>(q, k, v, out, B, L, H, scale, stream);
}
