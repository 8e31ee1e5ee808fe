// K2 in f32: non-causal, unmasked attention forward, softmax(Q K^T / sqrt(64))
// V, head dim 64, f32 in and out, for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash_attention call of
// latentblending_tpu/models/layers.py Attention.__call__ (the UNet's
// self-attention behind _use_flash_attention) for a UNet that runs in
// float32; csrc/attention_d64_bf16.cu is the bf16 one. q, k, v and out are
// [B, L, H, 64] row-major, the layout the q/k/v projections produce.
//
// What bounds it on the H100: arithmetic at f32 accuracy. At SDXL-Turbo
// 512²'s fused batch [12, 1024, 10, 64] it does 32 GFLOP on 201 MB. One
// TF32 pass keeps ~3 decimal digits, outside the 1e-4 relative bound
// against the plain f32 result, so both products run in 3xTF32 as K3 does
// (csrc/attention_d512_f32.cu): each operand splits into hi = x rounded to
// TF32 and lo = x - hi, each product is hi*hi + hi*lo + lo*hi on mma.sync
// m16n8k8, the cross terms in their own accumulators. Its bound is three
// TF32 products per f32 one over the 495 TFLOP/s TF32 peak.
//
// Design (a flash-attention forward on mma.sync; at d = 64 one CTA holds
// everything, so no cluster split is needed):
//   - one CTA owns one (batch, head, 64-row query tile): 4 warps of 16
//     query rows each;
//   - the Q tile (16 KB) is loaded once by cp.async; K and V tiles of 64
//     rows (16 KB each) stream through two stages, the next tile loading
//     while the current one is computed;
//   - each warp computes its 16 x 64 scores in registers and runs the
//     online softmax on them (exp2 with log2(e)/sqrt(d) folded in, row max
//     by quad shuffles, row sum per thread reduced once at the end);
//   - O += P V takes P straight from the score accumulators: the m16n8k8
//     A fragment wants keys t and t + 4 where the accumulator holds keys 2t
//     and 2t + 1, so the k order of each 8-key step is permuted (logical k
//     t <-> key 2t, t + 4 <-> key 2t + 1) and V's rows are read in the same
//     order. No shuffle, no shared-memory round trip for P;
//   - rows are padded to 68 floats, which keeps the Q, K and (permuted) V
//     fragment loads on 32 distinct banks;
//   - O (16 x 64 per warp) and its cross-term accumulator live in
//     registers, scaled by 1/l and written once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int kD = 64;
constexpr int kBQ = 64;                 // query rows per CTA
constexpr int kBK = 64;                 // key rows per tile
constexpr int kWarps = kBQ / 16;        // one warp per 16 query rows
constexpr int kThreads = 32 * kWarps;
constexpr int kNS = kBK / 8;            // n8-tiles of S per warp
constexpr int kNO = kD / 8;             // n8-tiles of O per warp
constexpr int kStages = 2;
constexpr int kRS = kD + 4;             // padded shared-memory row (floats)
constexpr int kTile = kBK * kRS;

struct K2F32Smem {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kRS;          // [stage][kBK][kRS]
  static constexpr int kV = kK + kStages * kTile;    // [stage][kBK][kRS]
  static constexpr size_t kBytes = sizeof(float) * (kV + kStages * kTile);
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

__global__ void __launch_bounds__(kThreads)
attention_d64_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         float* __restrict__ out, int L, int H, float scale_log2) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem + K2F32Smem::kQ;
  float* sK = smem + K2F32Smem::kK;
  float* sV = smem + K2F32Smem::kV;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int q0 = blockIdx.x * kBQ;
  const int64_t rs = (int64_t)H * kD;  // floats between consecutive sequence rows
  const int64_t head = (int64_t)blockIdx.z * L * rs + (int64_t)blockIdx.y * kD;
  const int ntiles = L / kBK;

  // 64 rows of one head (256 bytes each) from sequence row r0 into dst
  auto load_rows = [&](float* dst, const float* src, int r0) {
    for (int x = tid; x < 64 * (kD / 4); x += kThreads) {
      const int row = x / (kD / 4), seg = x % (kD / 4);
      lb::cp_async16(dst + row * kRS + 4 * seg, src + head + (int64_t)(r0 + row) * rs + 4 * seg);
    }
  };
  load_rows(sQ, q, q0);
  load_rows(sK, k, 0);
  load_rows(sV, v, 0);
  lb::cp_async_commit();

  float o[kNO][4], oc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[n][r] = oc[n][r] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8 (log2 units)
  float l[2] = {0.f, 0.f};              // this thread's part of their running sums
  const int wr = 16 * warp;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j % kStages;
    if (j + 1 < ntiles) {  // the other stage held tile j - 1, done at its closing barrier
      const int sn = (j + 1) % kStages;
      load_rows(sK + sn * kTile, k, (j + 1) * kBK);
      load_rows(sV + sn * kTile, v, (j + 1) * kBK);
    }
    lb::cp_async_commit();  // an empty group past the end keeps the count uniform
    lb::cp_async_wait<1>();  // tile j (and Q) have landed
    __syncthreads();
    const float* tk = sK + st * kTile;
    const float* tv = sV + st * kTile;

    // S = Q K^T over d in 8 k8-steps, 3xTF32
    float s[kNS][4], sc[kNS][4];
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = sc[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kD / 8; ++kk) {
      const float* qa = sQ + (wr + g) * kRS + 8 * kk + t;
      const float a[4] = {qa[0], qa[8 * kRS], qa[4], qa[8 * kRS + 4]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) lb::split_tf32(a[r], ahi[r], alo[r]);
      uint32_t bhi[kNS][2], blo[kNS][2];
#pragma unroll
      for (int n = 0; n < kNS; ++n) {
        const float* kb = tk + (8 * n + g) * kRS + 8 * kk + t;
        lb::split_tf32(kb[0], bhi[n][0], blo[n][0]);
        lb::split_tf32(kb[4], bhi[n][1], blo[n][1]);
      }
      lb::mma_3xtf32(s, sc, ahi, alo, bhi, blo);
    }

    // online softmax on the accumulators: registers 0-1 of an n8-tile hold
    // row g, keys 8n + 2t and 8n + 2t + 1; registers 2-3 row g + 8
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        s[n][r] += sc[n][r];
        mx[r >> 1] = fmaxf(mx[r >> 1], s[n][r]);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      const float m_new = fmaxf(m[e], mx[e] * scale_log2);
      alpha[e] = exp2f(m[e] - m_new);  // 0 on the first tile (m = -inf)
      m[e] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(fmaf(s[n][r], scale_log2, -m[r >> 1]));
        s[n][r] = p;
        sum[r >> 1] += p;
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
#pragma unroll
    for (int n = 0; n < kNO; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o[n][r] *= alpha[r >> 1];
        oc[n][r] *= alpha[r >> 1];
      }

    // O += P V in 8 k8-steps of 8 keys, 3xTF32. Step kk's A fragment is the
    // accumulator of S's n8-tile kk with the k order permuted: logical k t
    // is key 2t (registers 0, 2), logical k t + 4 is key 2t + 1 (1, 3);
    // the B fragment reads V's rows 2t and 2t + 1 to match.
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const float a[4] = {s[kk][0], s[kk][2], s[kk][1], s[kk][3]};
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) lb::split_tf32(a[r], ahi[r], alo[r]);
      uint32_t bhi[kNO][2], blo[kNO][2];
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        const float* vb = tv + (8 * kk + 2 * t) * kRS + 8 * n + g;
        lb::split_tf32(vb[0], bhi[n][0], blo[n][0]);
        lb::split_tf32(vb[kRS], bhi[n][1], blo[n][1]);
      }
      lb::mma_3xtf32(o, oc, ahi, alo, bhi, blo);
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    inv[e] = 1.f / l[e];
  }
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* dst = out + head + (int64_t)(q0 + wr + g + 8 * e) * rs + 8 * n + 2 * t;
      *reinterpret_cast<float2*>(dst) = make_float2((o[n][2 * e] + oc[n][2 * e]) * inv[e],
                                                    (o[n][2 * e + 1] + oc[n][2 * e + 1]) * inv[e]);
    }
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  if (L % kBQ != 0 || L % kBK != 0 || H > 65535 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(K2F32Smem::kBytes);
  cudaError_t err =
      cudaFuncSetAttribute(attention_d64_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(L / kBQ, H, B);
  attention_d64_f32_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), L, H, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2 in f32: UNet self-attention, head dim 64, f32 in/out, 3xTF32.
extern "C" int lb_attention_fwd_d64_f32(const void* q, const void* k, const void* v, void* out, int B, int L,
                                        int H, float scale, void* stream) {
  return launch(q, k, v, out, B, L, H, scale, stream);
}
