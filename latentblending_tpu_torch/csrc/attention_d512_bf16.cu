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
// (~295): the bound is flops over the 989 TFLOP/s bf16 peak, which only
// wgmma reaches.
//
// Design: a flash-attention forward on warpgroup MMA over a 2-CTA
// thread-block cluster that splits d. A 64-row query tile at d = 512 keeps
// a 64 x 512 f32 O accumulator (256 registers a thread for one
// warpgroup), so CTA r of the cluster owns output columns
// [256r, 256r + 256):
//   1. one producer warp issues every load by TMA in the 128-byte swizzle:
//      the tensor is read as [B*L, 8, 64] and each load is one 64-column
//      atom of 64 rows (8 KB); CTA r loads atoms 4r..4r+3. Its half of the
//      Q tile (32 KB) loads once; K and V tiles of 64 keys stream through
//      two rings of two stages, each with full (TMA bytes) and empty
//      (consumer release) mbarriers;
//   2. one consumer warpgroup computes its partial scores S_r = Q_r K_r^T
//      (64 x 64, f32) over its 256 columns: 4 atoms x 4 k16 steps of
//      wgmma m64n64k16, both operands K-major in shared memory;
//   3. the exchange needs no cluster-wide barrier. Each thread writes its
//      32 partial scores into the partner's receive buffer in its own
//      fragment order ([value][thread], 16 KB, double-buffered by tile
//      parity) with st.async, which counts the bytes on the partner's
//      mbarrier as a TMA load does (release at cluster scope, no fence);
//      one receiving thread posts the 16 KB it expects, and the receiver
//      waits on its own barrier with acquire at cluster scope. Thread t
//      holds the same (row, key) positions in both CTAs, and a + b == b + a
//      in f32, so both CTAs hold bit-equal scores and compute the same P,
//      row max and row sum;
//   4. the online softmax runs on the accumulator registers (exp2 with
//      log2(e)/sqrt(d) folded in, row max by quad shuffles); P is rounded
//      to bf16 as the A operand of P V, the row sum keeps the unrounded
//      values;
//   5. O += P V by wgmma, 4 output atoms x 4 k16 steps of keys, V read
//      MN-major with the transpose bit; O (64 x 256 f32) is 128 registers
//      a thread; it is scaled by 1/l and written once as bf16;
//   6. the next tile's S product is issued before this tile's exchange
//      wait and softmax, which run under it; its partial is sent as soon
//      as it completes, while P V runs. The last tile is peeled off, so no
//      wgmma group is issued under a run-time condition (ptxas serialized
//      every wgmma of the loop when one was).
// Measured against waiting on each product in turn, and against an
// exchange by plain DSMEM stores and one remote mbarrier arrive per thread
// (release at cluster scope), this measured faster at [4, 4096, 1, 512]
// and [1, 4096, 1, 512] (PERF.md, K3 bf16 findings).
//
// Why the double-buffered exchange is safe: a CTA writes slot j & 1 of its
// partner for tile j only after it has received the partner's tile j - 1,
// which the partner sent after reading its slot (j - 2) & 1 == j & 1 (each
// thread reads tile j's slot before it sends tile j + 1, and the release
// of its send orders that read before it). For the same reason a barrier
// phase is never completed into before its previous phase was waited for,
// and the tx bytes of tile j that land before the receiver posts them
// count into tile j's phase.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_ptx.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 512;
constexpr int kAtoms = 4;                         // 64-column atoms per CTA: its 256 columns
constexpr int kBQ = 64;                           // query rows per cluster
constexpr int kBK = 64;                           // keys per tile
constexpr int kStages = 2;                        // K and V ring stages
constexpr int kConsumers = 128;                   // one warpgroup
constexpr int kThreads = kConsumers + 32;         // + one producer warp
constexpr int kAtomBytes = 64 * 128;              // 64 rows x 64 bf16 columns
constexpr int kTileBytes = kAtoms * kAtomBytes;   // a CTA's half of a 64-row tile: 32 KB
constexpr int kXBytes = 32 * kConsumers * 4;      // one tile's partial scores: 16 KB

struct Smem {  // byte offsets from a 1024-byte aligned base
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kX = kV + kStages * kTileBytes;
  static constexpr int kBar = kX + 2 * kXBytes;
  // q, kfull[kStages], vfull[kStages], kempty[kStages], vempty[kStages], xfull[2]
  static constexpr int kNumBars = 1 + 4 * kStages + 2;
  static constexpr size_t kBytes = 1024 + kBar + 8 * kNumBars;  // + alignment slack
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
attention_d512_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int L,
                           float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // the same offset in both CTAs, so map_shared_rank finds the partner's buffers
  uint8_t* smem = smem_raw + ((1024 - (lb::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem + Smem::kQ;
  uint8_t* sK = smem + Smem::kK;
  uint8_t* sV = smem + Smem::kV;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + Smem::kBar);
  uint64_t* kfull = qbar + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* kempty = vfull + kStages;
  uint64_t* vempty = kempty + kStages;
  uint64_t* xfull = vempty + kStages;

  const uint32_t rank = lb::cluster_ctarank();
  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x >> 1) * kBQ;
  const int row0 = blockIdx.y * L;  // first row of this batch in the [B*L] sequence axis
  const int ntiles = L / kBK;

  if (tid == 0) {
    lb::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      lb::mbar_init(&kfull[s], 1);
      lb::mbar_init(&vfull[s], 1);
      lb::mbar_init(&kempty[s], kConsumers);
      lb::mbar_init(&vempty[s], kConsumers);
    }
    lb::mbar_init(&xfull[0], 1);  // the receiver's expect_tx; the partner's bytes complete it
    lb::mbar_init(&xfull[1], 1);
    lb::fence_mbar_init();
  }
  lb::cluster_sync();  // both CTAs' barriers are initialised before any load or remote arrive

  if (tid >= kConsumers) {
    // producer warp: one thread issues every TMA load
    if (tid == kConsumers) {
      lb::mbar_expect_tx(qbar, kTileBytes);
      for (int a = 0; a < kAtoms; ++a) lb::tma_load_3d(sQ + a * kAtomBytes, &tq, qbar, 0, kAtoms * rank + a, row0 + q0);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % kStages;
        const uint32_t parity = (j / kStages - 1) & 1;  // the release of tile j - kStages
        if (j >= kStages) lb::mbar_wait(&kempty[s], parity);
        lb::mbar_expect_tx(&kfull[s], kTileBytes);
        for (int a = 0; a < kAtoms; ++a)
          lb::tma_load_3d(sK + s * kTileBytes + a * kAtomBytes, &tk, &kfull[s], 0, kAtoms * rank + a, row0 + j * kBK);
        if (j >= kStages) lb::mbar_wait(&vempty[s], parity);
        lb::mbar_expect_tx(&vfull[s], kTileBytes);
        for (int a = 0; a < kAtoms; ++a)
          lb::tma_load_3d(sV + s * kTileBytes + a * kAtomBytes, &tv, &vfull[s], 0, kAtoms * rank + a, row0 + j * kBK);
      }
    }
    __syncwarp();
  } else {
    const int warp = tid / 32;
    const int lane = tid % 32;
    const uint32_t peer = rank ^ 1u;
    const uint32_t x_peer = lb::map_shared_rank(lb::smem_u32(smem + Smem::kX), peer);
    const uint32_t xbar_peer = lb::map_shared_rank(lb::smem_u32(xfull), peer);

    float o[kAtoms][32];
#pragma unroll
    for (int c = 0; c < kAtoms; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max, in log2 units
    float l[2] = {0.f, 0.f};              // this thread's part of the running row sum
    float sa[32], sb[32];                 // partial scores of two consecutive tiles

    // S_j partial = Q_r K_r^T over this CTA's 256 columns, one commit group
    auto issue_s = [&](int j, float (&acc)[32]) {
      const int s = j % kStages;
      const uint32_t q_addr = lb::opaque(lb::smem_u32(sQ));
      const uint32_t k_addr = lb::opaque(lb::smem_u32(sK) + s * kTileBytes);
      lb::mbar_wait(&kfull[s], (j / kStages) & 1);
      lb::wgmma_fence();
#pragma unroll
      for (int a = 0; a < kAtoms; ++a)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)  // +32 bytes along the swizzled row per k16 step
          lb::wgmma_m64n64k16_ss(acc, lb::sw128_desc(q_addr + a * kAtomBytes + 32 * kk),
                                 lb::sw128_desc(k_addr + a * kAtomBytes + 32 * kk), a | kk);
      lb::wgmma_commit();
    };
    // after tile j's S group completed: free its K stage, send the partial
    auto send = [&](int j, float (&acc)[32]) {
      lb::fence_regs(acc);
      lb::mbar_arrive(&kempty[j % kStages]);
      const uint32_t dst = x_peer + (j & 1) * kXBytes + tid * 16;
      const uint32_t bar = xbar_peer + 8 * (j & 1);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        lb::st_async_v4(dst + i * kConsumers * 16, acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3], bar);
    };

    lb::mbar_wait(qbar, 0);
    issue_s(0, sa);
    lb::wgmma_wait<0>();
    send(0, sa);

    // one key tile; has_next (std::true_type or std::false_type): a tile
    // follows, so this step also issues and sends the next S (a constant,
    // so no wgmma group is issued under a run-time condition)
    auto step = [&](auto has_next, int j, float (&cur)[32], float (&nxt)[32]) {
      constexpr bool more = decltype(has_next)::value;
      if constexpr (more) issue_s(j + 1, nxt);

      // the full scores: this CTA's partial + the partner's (one thread
      // posts the tile's bytes; the partner's may land first)
      if (tid == 0) lb::mbar_expect_tx(&xfull[j & 1], kXBytes);
      lb::mbar_wait_cluster(&xfull[j & 1], (j >> 1) & 1);
      const float4* recv = reinterpret_cast<const float4*>(smem + Smem::kX + (j & 1) * kXBytes) + tid;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 r = recv[i * kConsumers];
        cur[4 * i] += r.x;
        cur[4 * i + 1] += r.y;
        cur[4 * i + 2] += r.z;
        cur[4 * i + 3] += r.w;
      }

      // online softmax on the accumulators. Register i holds row
      // (lane/4 + 8*((i/2)%2)) of this warp's 16, key 8*(i/4) + 2*(lane%4) + i%2.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], cur[i]);
      float alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e] * scale_log2);
        alpha[e] = exp2f(m[e] - m_new);  // 0 on the first tile (m = -inf)
        m[e] = m_new;
      }
      float sum[2] = {0.f, 0.f};
      uint32_t pa[4][4];  // P in bf16: the A fragments of the 4 k16 steps
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int e = (i >> 1) & 1;
        const float p0 = exp2f(fmaf(cur[i], scale_log2, -m[e]));
        const float p1 = exp2f(fmaf(cur[i + 1], scale_log2, -m[e]));
        sum[e] += p0 + p1;
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
#pragma unroll
      for (int c = 0; c < kAtoms; ++c) {
        lb::fence_regs(o[c]);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
      }

      // O += P V: P from registers, V's atoms MN-major from shared memory
      const int s = j % kStages;
      const uint32_t v_addr = lb::opaque(lb::smem_u32(sV) + s * kTileBytes);
      lb::mbar_wait(&vfull[s], (j / kStages) & 1);
      lb::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < kAtoms; ++c)  // 16 keys of V per k16 step: 2048 bytes
          lb::wgmma_m64n64k16_rs_tb(o[c], pa[kk], lb::sw128_desc(v_addr + c * kAtomBytes + 2048 * kk));
      lb::wgmma_commit();

      if constexpr (more) {
        lb::wgmma_wait<1>();  // S_{j+1} done, P V may still run
        send(j + 1, nxt);
      }
      lb::wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // P's registers stay live until the products that read them are done
#pragma unroll
        for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(pa[kk][w])::"memory");
      lb::mbar_arrive(&vempty[s]);
    };
    constexpr std::true_type next{};
    constexpr std::false_type last{};
    int j = 0;
#pragma unroll 1
    for (; j + 2 < ntiles; j += 2) {
      step(next, j, sa, sb);
      step(next, j + 1, sb, sa);
    }
    if (j + 1 < ntiles) {
      step(next, j, sa, sb);
      step(last, j + 1, sb, sa);
    } else {
      step(last, j, sa, sb);
    }

    float inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
      inv[e] = 1.f / l[e];
    }
    const int r = q0 + warp * 16 + lane / 4;
#pragma unroll
    for (int c = 0; c < kAtoms; ++c) {
      lb::fence_regs(o[c]);
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t idx = (int64_t)(row0 + r + 8 * e) * kD + 256 * rank + 64 * c + 8 * n8 + 2 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(out + idx) =
              __floats2bfloat162_rn(o[c][4 * n8 + 2 * e] * inv[e], o[c][4 * n8 + 2 * e + 1] * inv[e]);
        }
    }
  }
  lb::cluster_sync();  // no CTA leaves while its partner may still address its shared memory
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H, float scale,
           void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H != 1 || L % kBQ != 0 || L % kBK != 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // [B*L, 512] read as [B*L, 8, 64]: boxes of one 64-column atom of 64 rows
  CUtensorMap tq, tk, tv;
  const int64_t rows = (int64_t)B * L;
  if (!lb::make_map_sw128(&tq, q, rows, kD / 64, kBQ) || !lb::make_map_sw128(&tk, k, rows, kD / 64, kBK) ||
      !lb::make_map_sw128(&tv, v, rows, kD / 64, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_d512_bf16_kernel;
  const int bytes = static_cast<int>(Smem::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(2 * (L / kBQ), B);  // the two CTAs of a cluster are neighbours in x
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, static_cast<bf16*>(out), L,
                                                                        scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3 in bf16: VAE mid-block attention, one head of d = 512, bf16 in/out.
extern "C" int lb_attention_fwd_d512_bf16(const void* q, const void* k, const void* v, void* out, int B, int L,
                                          int H, float scale, void* stream) {
  return launch(q, k, v, out, B, L, H, scale, stream);
}
