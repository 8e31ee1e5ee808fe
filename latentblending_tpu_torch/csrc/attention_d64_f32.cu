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
// against the plain f32 result, so both products run in 3xTF32: each
// operand x splits into hi = x truncated to TF32 and lo = x - hi (exact in
// f32; the tensor core reads its top 19 bits), and each product is
// lo*hi + hi*lo + hi*hi on TF32 wgmma into one f32 accumulator, the two
// small cross terms first. Its bound is three TF32 products per f32 one
// over the 495 TFLOP/s TF32 peak, which only wgmma reaches.
//
// Design (a flash-attention forward on warpgroup MMA, warp-specialised):
//   - one CTA owns one (batch, head, 128-row query tile): two consumer
//     warpgroups of 64 query rows and one producer warpgroup; setmaxnreg
//     moves registers from the producer to the consumers;
//   - every operand is split once per CTA and tile, not once per warp. The
//     producer's thread 0 loads Q (once) and each 64-key K tile by TMA in
//     the 128-byte swizzle, K-major as wgmma's B wants it; the raw K tile
//     is K's hi (the tensor core truncates it: the same error, to three
//     digits in every check, as writing the truncated tile back, for less
//     work), and the producer's 128 threads write lo beside it. They read
//     V straight from global memory into registers (two 8-key groups a
//     thread at a time; all four at once spilled) and write it TRANSPOSED (V^T, keys
//     contiguous) as hi and lo in the same swizzle: TF32 wgmma has no
//     transpose bit, so its B operand must be K-major, and for O = P V
//     that K is the key axis;
//   - K, K lo, V^T hi and V^T lo of a tile (64 KB) form one stage of a ring
//     of three, with one mbarrier "ready" (the producer's 128 threads, each
//     after a proxy fence that makes its stores visible to wgmma) and one
//     "empty" (the 256 consumer threads, each after the tile's P V
//     completed) per stage, plus "kfull" (TMA bytes of K) and "q";
//   - each consumer warpgroup splits its 64 x 64 Q block into registers
//     once (hi and lo A fragments: 64 registers), so S = Q K^T runs 24
//     wgmma m64n64k8 with A from registers and K from shared memory;
//   - the online softmax runs on S's accumulator registers (exp2 with
//     log2(e)/sqrt(d) folded in, row max by quad shuffles, the row sum
//     from the unsplit P, kept per thread and reduced once at the end);
//   - O += P V takes P straight from those registers as the A operand,
//     split there: the A fragment wants keys t and t + 4 of each 8-key
//     step where the accumulator holds keys 2t and 2t + 1, so the k order
//     of each step is permuted (logical k t <-> key 2t, t + 4 <-> key
//     2t + 1), and the producer writes V^T's keys in the same order;
//   - the next tile's S is issued before this tile's softmax, which runs
//     under it; the loop is unrolled by two with the last tile peeled, so
//     no wgmma group is issued under a run-time condition (ptxas
//     serialises every wgmma of a kernel where one is);
//   - O (64 x 64 f32 per warpgroup, 32 registers a thread) is scaled by
//     1/l and written once.
// Measured against the next S issued after P V, a rounded (not truncated)
// hi, and 72/216 registers for producer/consumers, this was as fast or
// faster at every path shape (PERF.md, K2 f32 findings).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_ptx.cuh"


namespace {

constexpr int kD = 64;
constexpr int kBQ = 128;                      // query rows per CTA
constexpr int kBK = 64;                       // keys per tile
constexpr int kStages = 3;
constexpr int kConsumers = 256;               // two warpgroups of 64 query rows
constexpr int kProducers = 128;               // one warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kVBatch = 2;                    // 8-key groups of V a producer thread loads at once
// registers a thread after setmaxnreg: 128 x 56 + 256 x 224 = the 384 x
// 168 the CTA is launched with
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
constexpr int kAtomRows = 64;                 // rows of a tile atom: 64 x 128 bytes (32 f32 columns)
constexpr int kAtomBytes = kAtomRows * 128;
constexpr int kTileBytes = 2 * kAtomBytes;    // 64 rows x 64 f32, two 32-column atoms

struct Smem {  // byte offsets from a 1024-byte aligned base
  static constexpr int kQ = 0;                               // [2 atoms][128 rows][128 B]
  static constexpr int kQAtomBytes = kBQ * 128;
  static constexpr int kStage0 = kQ + 2 * kQAtomBytes;
  // one stage: K (by TMA; read as hi), K lo, V^T hi, V^T lo
  static constexpr int kKlo = kTileBytes;
  static constexpr int kVThi = 2 * kTileBytes;
  static constexpr int kVTlo = 3 * kTileBytes;
  static constexpr int kStageBytes = 4 * kTileBytes;
  static constexpr int kBar = kStage0 + kStages * kStageBytes;
  // q, kfull[kStages], ready[kStages], empty[kStages]
  static constexpr int kNumBars = 1 + 3 * kStages;
  static constexpr size_t kBytes = 1024 + kBar + 8 * kNumBars;  // + alignment slack
  static_assert(kBytes <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// lo = x - hi, exact in f32
__device__ __forceinline__ uint32_t tf32_lo(float x, uint32_t hi) {
  return __float_as_uint(x - __uint_as_float(hi));
}

__global__ void __launch_bounds__(kThreads, 1)
attention_d64_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                         const float* __restrict__ v, float* __restrict__ out, int L, int H, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (lb::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + Smem::kBar);
  uint64_t* kfull = qbar + 1;
  uint64_t* ready = kfull + kStages;
  uint64_t* empty = ready + kStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int row0 = blockIdx.z * L;  // first row of this batch in the [B*L] sequence axis
  const int ntiles = L / kBK;       // even: L is a multiple of kBQ

  if (tid == 0) {
    lb::mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      lb::mbar_init(&kfull[s], 1);
      lb::mbar_init(&ready[s], kProducers);
      lb::mbar_init(&empty[s], kConsumers);
    }
    lb::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ------------------------------------------------------------ producer
    lb::setmaxnreg_dec<kProducerRegs>();
    const int p = tid - kConsumers;
    const int n = p & 63;     // the V column (row of V^T) this thread transposes
    const int half = p >> 6;  // its 8-key groups: half, half + 2, half + 4, half + 6
    const int64_t rs = (int64_t)H * kD;  // floats between consecutive sequence rows
    const float* vcol = v + (int64_t)row0 * rs + h * kD + n;
    if (p == 0) {
      lb::mbar_expect_tx(qbar, 2 * Smem::kQAtomBytes);
      for (int a = 0; a < 2; ++a)
        lb::tma_load_3d(smem + Smem::kQ + a * Smem::kQAtomBytes, &tq, qbar, 0, 2 * h + a, row0 + q0);
    }
#pragma unroll 1
    for (int j = 0; j < ntiles; ++j) {
      const int s = j % kStages;
      const int use = j / kStages;
      uint8_t* st = smem + Smem::kStage0 + s * Smem::kStageBytes;
      const uint32_t vt = lb::smem_u32(st + Smem::kVThi);
      // V's values for this thread in batches of kVBatch 8-key groups, the
      // first loaded before the stage is free
#pragma unroll
      for (int i0 = 0; i0 < 4; i0 += kVBatch) {
        float vr[kVBatch][8];
#pragma unroll
        for (int i = 0; i < kVBatch; ++i)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            vr[i][e] = __ldg(vcol + (int64_t)(j * kBK + 8 * (half + 2 * (i0 + i)) + e) * rs);
        if (i0 == 0) {
          // empty[s]: the consumers' P V of tile j - kStages (its last reader) completed
          if (j >= kStages) lb::mbar_wait(&empty[s], (use - 1) & 1);
          if (p == 0) {  // kfull[s]: the TMA's bytes of K tile j
            lb::mbar_expect_tx(&kfull[s], kTileBytes);
            for (int a = 0; a < 2; ++a)
              lb::tma_load_3d(st + a * kAtomBytes, &tk, &kfull[s], 0, 2 * h + a, row0 + j * kBK);
          }
        }
        // V^T, hi and lo: row n holds this tile's 64 keys, 32 per atom, in
        // 128-byte rows swizzled as a TMA load would (16-byte chunk c of
        // row n at chunk c ^ (n % 8)). The k order within each 8-key step
        // is P's: positions 0-3 hold keys 0, 2, 4, 6, positions 4-7 keys
        // 1, 3, 5, 7 (chunk 2m even keys, chunk 2m + 1 odd keys of step m).
#pragma unroll
        for (int i = 0; i < kVBatch; ++i) {
          const int g8 = half + 2 * (i0 + i);
#pragma unroll
          for (int par = 0; par < 2; ++par) {
            const int c = 2 * (g8 & 3) + par;
            const uint32_t addr = vt + (g8 >> 2) * kAtomBytes + n * 128 + ((c ^ (n & 7)) << 4);
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              hi[x] = lb::tf32_trunc(vr[i][par + 2 * x]);
              lo[x] = tf32_lo(vr[i][par + 2 * x], hi[x]);
            }
            st_shared_v4(addr, hi[0], hi[1], hi[2], hi[3]);
            st_shared_v4(addr + (Smem::kVTlo - Smem::kVThi), lo[0], lo[1], lo[2], lo[3]);
          }
        }
      }
      // K lo beside the raw K tile, which stays as hi (the tensor core
      // truncates it); elementwise, so the swizzled layout carries over
      lb::mbar_wait(&kfull[s], use & 1);
#pragma unroll
      for (int i = 0; i < kTileBytes / (16 * kProducers); ++i) {
        const int off = 16 * p + i * 16 * kProducers;
        const float4 x = *reinterpret_cast<const float4*>(st + off);
        st_shared_v4(lb::smem_u32(st + Smem::kKlo + off), tf32_lo(x.x, lb::tf32_trunc(x.x)),
                     tf32_lo(x.y, lb::tf32_trunc(x.y)), tf32_lo(x.z, lb::tf32_trunc(x.z)),
                     tf32_lo(x.w, lb::tf32_trunc(x.w)));
      }
      // ready[s]: each producer thread's stores, fenced for the async proxy
      lb::fence_proxy_async();
      lb::mbar_arrive(&ready[s]);
    }
  } else {
    // ------------------------------------------------------------ consumers
    lb::setmaxnreg_inc<kConsumerRegs>();
    const int wg = tid >> 7;
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group

    // Q's A fragments, split once: k step kk holds (row g, d 8kk + t),
    // (g + 8, 8kk + t), (g, 8kk + t + 4), (g + 8, 8kk + t + 4) of this
    // warp's 16 rows; rows are 128-byte swizzled (row % 8 == g)
    uint32_t qh[8][4], ql[8][4];
    lb::mbar_wait(qbar, 0);  // qbar: the TMA's bytes of Q
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 64 * wg + 16 * warp + g + 8 * (r & 1);
        const int chunk = 2 * (kk & 3) + (r >> 1);
        const float x = *reinterpret_cast<const float*>(smem + Smem::kQ + (kk >> 2) * Smem::kQAtomBytes +
                                                        row * 128 + ((chunk ^ g) << 4) + 4 * t);
        qh[kk][r] = lb::tf32_trunc(x);
        ql[kk][r] = tf32_lo(x, qh[kk][r]);
      }

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row max, in log2 units
    float l[2] = {0.f, 0.f};              // this thread's part of the running row sum
    float sa[32], sb[32];                 // scores of two consecutive tiles
    const uint32_t stage0 = lb::smem_u32(smem + Smem::kStage0);

    // S_j = Q K_j^T in 3xTF32, one commit group: lo*hi, hi*lo, then hi*hi
    auto issue_s = [&](int j, float (&acc)[32]) {
      const int s = j % kStages;
      const uint32_t k_addr = lb::opaque(stage0 + s * Smem::kStageBytes);
      lb::mbar_wait(&ready[s], (j / kStages) & 1);  // ready[s]: tile j split into stage s
      lb::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)  // +32 bytes along the swizzled row per k8 step
        lb::wgmma_m64n64k8_tf32_rs(acc, ql[kk], lb::sw128_desc(k_addr + (kk >> 2) * kAtomBytes + 32 * (kk & 3)),
                                   kk);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        lb::wgmma_m64n64k8_tf32_rs(
            acc, qh[kk], lb::sw128_desc(k_addr + Smem::kKlo + (kk >> 2) * kAtomBytes + 32 * (kk & 3)), 1);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        lb::wgmma_m64n64k8_tf32_rs(acc, qh[kk], lb::sw128_desc(k_addr + (kk >> 2) * kAtomBytes + 32 * (kk & 3)),
                                   1);
      lb::wgmma_commit();
    };

    issue_s(0, sa);
    lb::wgmma_wait<0>();
    lb::fence_regs(sa);

    // one key tile; has_next (std::true_type or std::false_type): a tile
    // follows, so this step also issues the next S (a constant, so no
    // wgmma group is issued under a run-time condition)
    auto step = [&](auto has_next, int j, float (&cur)[32], float (&nxt)[32]) {
      constexpr bool more = decltype(has_next)::value;
      if constexpr (more) issue_s(j + 1, nxt);

      // online softmax on the accumulators. Register i holds row
      // (g + 8*((i/2)%2)) of this warp's 16, key 8*(i/4) + 2*t + i%2.
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
      // P split in place: cur keeps hi (P truncated to TF32), pl holds lo
      float sum[2] = {0.f, 0.f};
      uint32_t pl[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i >> 1) & 1;
        const float pv = exp2f(fmaf(cur[i], scale_log2, -m[e]));
        sum[e] += pv;
        const uint32_t hi = lb::tf32_trunc(pv);
        pl[i] = tf32_lo(pv, hi);
        cur[i] = __uint_as_float(hi);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
      lb::fence_regs(o);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V: k step kk's A fragment is S's n8 block kk with the k
      // order permuted (logical k t <- key 2t: registers 0, 2; t + 4 <-
      // key 2t + 1: registers 1, 3), V^T's keys stored in the same order
      const int s = j % kStages;
      const uint32_t v_addr = lb::opaque(stage0 + s * Smem::kStageBytes + Smem::kVThi);
      constexpr int kLo = Smem::kVTlo - Smem::kVThi;
      lb::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t a[4] = {pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1], pl[4 * kk + 3]};
        lb::wgmma_m64n64k8_tf32_rs(o, a, lb::sw128_desc(v_addr + (kk >> 2) * kAtomBytes + 32 * (kk & 3)), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t a[4] = {__float_as_uint(cur[4 * kk]), __float_as_uint(cur[4 * kk + 2]),
                               __float_as_uint(cur[4 * kk + 1]), __float_as_uint(cur[4 * kk + 3])};
        lb::wgmma_m64n64k8_tf32_rs(o, a, lb::sw128_desc(v_addr + kLo + (kk >> 2) * kAtomBytes + 32 * (kk & 3)),
                                   1);
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t a[4] = {__float_as_uint(cur[4 * kk]), __float_as_uint(cur[4 * kk + 2]),
                               __float_as_uint(cur[4 * kk + 1]), __float_as_uint(cur[4 * kk + 3])};
        lb::wgmma_m64n64k8_tf32_rs(o, a, lb::sw128_desc(v_addr + (kk >> 2) * kAtomBytes + 32 * (kk & 3)), 1);
      }
      lb::wgmma_commit();

      if constexpr (more) {
        lb::wgmma_wait<1>();  // S_{j+1} done, P V may still run
        lb::fence_regs(nxt);
      }
      lb::wgmma_wait<0>();
      // P's registers stay live until the products that read them are done
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(pl[i]), "+f"(cur[i])::"memory");
      lb::mbar_arrive(&empty[s]);  // empty[s]: this thread is done with tile j's stage
    };
    constexpr std::true_type next{};
    constexpr std::false_type last{};
    int j = 0;
#pragma unroll 1
    for (; j + 2 < ntiles; j += 2) {
      step(next, j, sa, sb);
      step(next, j + 1, sb, sa);
    }
    step(next, j, sa, sb);
    step(last, j + 1, sb, sa);

    float inv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
      inv[e] = 1.f / l[e];
    }
    lb::fence_regs(o);
    const int64_t rs = (int64_t)H * kD;
    const int r = q0 + 64 * wg + 16 * warp + g;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* dst = out + (int64_t)(row0 + r + 8 * e) * rs + h * kD + 8 * n8 + 2 * t;
        *reinterpret_cast<float2*>(dst) = make_float2(o[4 * n8 + 2 * e] * inv[e], o[4 * n8 + 2 * e + 1] * inv[e]);
      }
  }
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H, float scale, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  if (L % kBQ != 0 || H > 32767 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_d64_f32_kernel;
  // setmaxnreg only moves registers within the CTA's allocation, fixed at
  // launch by the kernel's register count: refuse a build whose count
  // would leave the consumers' setmaxnreg.inc waiting forever
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kThreads < kProducers * kProducerRegs + kConsumers * kConsumerRegs)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  // [B*L, H, 64] f32 read as [B*L, 2H, 32]: boxes of one 32-column atom
  CUtensorMap tq, tk;
  const int64_t rows = (int64_t)B * L;
  if (!lb::make_map_sw128(&tq, q, rows, 2 * H, kBQ, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !lb::make_map_sw128(&tk, k, rows, 2 * H, kBK, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = static_cast<int>(Smem::kBytes);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(L / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, static_cast<const float*>(v), static_cast<float*>(out), L, H, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2 in f32: UNet self-attention, head dim 64, f32 in/out, 3xTF32 on wgmma.
extern "C" int lb_attention_fwd_d64_f32(const void* q, const void* k, const void* v, void* out, int B, int L,
                                        int H, float scale, void* stream) {
  return launch(q, k, v, out, B, L, H, scale, stream);
}
