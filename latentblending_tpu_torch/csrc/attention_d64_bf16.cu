// K2: non-causal, unmasked attention forward, softmax(Q K^T / sqrt(64)) V,
// head dim 64, bf16 in and out, f32 accumulation, for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash_attention call of
// latentblending_tpu/models/layers.py Attention.__call__ (the UNet's
// self-attention behind _use_flash_attention). q, k, v and out are
// [B, L, H, 64] row-major, the layout the q/k/v projections produce.
//
// What bounds it on the H100: the tensor cores. At the main path's
// [10, 1024, 10, 64] it does 26.8 GFLOP on 52 MB of q/k/v/out, ~512 flop
// per byte, above the card's bf16 ridge (~295), so the kernel has to keep
// the tensor cores fed; the 989 TFLOP/s ceiling is ~27 us. The CUDA-core
// kernel it replaces ran its products as scalar FMAs from shared memory
// (bound by shared-memory bandwidth), left 3/4 of its threads idle in the
// softmax step, and loaded K/V with synchronous 2-byte loads.
//
// Design (a flash-attention forward on warpgroup MMA):
//   - one CTA owns one (batch, head, BQ-row query tile); one consumer
//     warpgroup per 64 query rows;
//   - the Q tile is loaded once by TMA; K/V tiles of BK rows stream through
//     a ring of STAGES stages by TMA, completion counted on mbarriers, so
//     the next tiles load while the current one is computed. A row of d=64
//     bf16 is 128 bytes: the TMA writes the 128-byte-swizzled layout that
//     the wgmma descriptors read without bank conflicts;
//   - S = Q K^T by wgmma m64n64k16 (A = Q, B = K, both K-major in shared
//     memory), f32 accumulators in registers;
//   - the online softmax runs on those registers: exp2 with log2(e)/sqrt(d)
//     folded into one scale, row max by quad shuffles (a row's 64 columns
//     live in the 4 threads of a quad), the row sum kept per thread and
//     reduced once at the end. No shared-memory round trip, no idle thread;
//   - O += P V by wgmma with P converted to bf16 in registers as the A
//     operand (the accumulator layout of S is the A-fragment layout of P)
//     and V as the B operand in its natural [BK, 64] layout, which is
//     MN-major: the transpose bit reads it without a copy;
//   - O is scaled by 1/l and written once as bf16.
// The tiles, BQ = 64 (one warpgroup), BK = 128, 2 stages, were the fastest
// of six measured at the path's shapes (PERF.md): at B = 2 a 64-row tile
// gives 320 CTAs on 132 SMs where a 128-row tile gives 160 (1.2 waves).
//
// Any sequence length (TAIL = true, chosen by the launcher when L is not a
// multiple of BK; SD3's joint sequence at 1024^2 is 4096 + 333 = 4429):
// the tensor maps are 4-d, [B][L][H][64], so each batch's rows end at its
// box bounds and the TMA reads rows past L as zeros, never the next
// batch's; the grid covers ceil(L / BQ) query tiles and ceil(L / BK) key
// tiles, the last key tile's scores of keys >= L are set to -inf before
// the row max (P = 0 there, and a zero V row adds nothing), and no output
// row >= L is stored. With TAIL = false the kernel is the one above,
// instruction for instruction.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int kD = 64;
constexpr int kRowBytes = kD * 2;  // one bf16 row of d=64: one 128-byte swizzle row

template <int BQ, int BK, int STAGES>
struct K2Cfg {
  static constexpr int kThreads = BQ / 64 * 128;
  static constexpr int kQBytes = BQ * kRowBytes;
  static constexpr int kKVBytes = BK * kRowBytes;
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOffset = kQBytes + STAGES * kStageBytes;
  static constexpr size_t kSmemBytes = 1024 + kBarOffset + 8 * (1 + STAGES);  // + alignment slack
  static_assert(BQ % 64 == 0 && BK % 64 == 0 && BQ <= 256 && BK <= 256, "tile sizes");
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0, "swizzle atoms need 1024-byte aligned tiles");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// A K/V or Q tile: rows [row, row + box) of head h of batch b; the 3-d map
// addresses rows in the [B*L] axis, the 4-d one within batch b.
template <bool TAIL>
__device__ __forceinline__ void load_tile(void* dst, const CUtensorMap* map, uint64_t* bar, int h, int b, int L,
                                          int row) {
  if constexpr (TAIL)
    lb::tma_load_4d(dst, map, bar, 0, h, row, b);
  else
    lb::tma_load_3d(dst, map, bar, 0, h, b * L + row);
}

template <int BQ, int BK, int STAGES, bool TAIL>
__global__ void __launch_bounds__(K2Cfg<BQ, BK, STAGES>::kThreads)
attention_d64_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, int L, int H,
                          float scale_log2) {
  using C = K2Cfg<BQ, BK, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (lb::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);  // [0]: Q, [1 + s]: stage s

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row0 = b * L;  // first row of this batch in the [B*L] sequence axis
  const int ntiles = TAIL ? (L + BK - 1) / BK : L / BK;

  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) lb::mbar_init(&bars[i], 1);
    lb::fence_mbar_init();
    lb::mbar_expect_tx(&bars[0], C::kQBytes);
    load_tile<TAIL>(sQ, &tq, &bars[0], h, b, L, q0);
    for (int s = 0; s < STAGES && s < ntiles; ++s) {
      uint8_t* st = smem + C::kQBytes + s * C::kStageBytes;
      lb::mbar_expect_tx(&bars[1 + s], C::kStageBytes);
      load_tile<TAIL>(st, &tk, &bars[1 + s], h, b, L, s * BK);
      load_tile<TAIL>(st + C::kKVBytes, &tv, &bars[1 + s], h, b, L, s * BK);
    }
  }
  __syncthreads();

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running row max, in log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the running row sum

  const uint64_t dq = lb::sw128_desc(sQ + wg * 64 * kRowBytes);
  lb::mbar_wait(&bars[0], 0);

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % STAGES;
    const uint8_t* sK = smem + C::kQBytes + s * C::kStageBytes;
    const uint8_t* sV = sK + C::kKVBytes;
    lb::mbar_wait(&bars[1 + s], (j / STAGES) & 1);

    // S = Q K^T: BK/64 wgmma column blocks of 64 keys, 4 k16 steps over d
    float sc[BK / 64][32];
    lb::wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < BK / 64; ++nb) {
      const uint64_t dk = lb::sw128_desc(sK + nb * 64 * kRowBytes);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)  // +32 bytes along the swizzled row per k16 step
        lb::wgmma_m64n64k16_ss(sc[nb], dq + 2 * kk, dk + 2 * kk, kk > 0);
    }
    lb::wgmma_commit();
    lb::wgmma_wait<0>();

    if constexpr (TAIL) {
      // keys >= L in the last tile (zeros from the box bounds) take no weight
      const int valid = L - j * BK;
      if (valid < BK) {
#pragma unroll
        for (int nb = 0; nb < BK / 64; ++nb)
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (nb * 64 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2) >= valid) sc[nb][i] = -INFINITY;
      }
    }

    // online softmax on the accumulators. Register i of a 64-column block
    // holds row (lane/4 + 8*((i/2)%2)) of this warp's 16, column
    // 8*(i/4) + 2*(lane%4) + i%2.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < BK / 64; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[nb][i]);
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
#pragma unroll
    for (int nb = 0; nb < BK / 64; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int e = (i >> 1) & 1;
        const float p = exp2f(fmaf(sc[nb][i], scale_log2, -m[e]));
        sc[nb][i] = p;
        sum[e] += p;
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) l[e] = l[e] * alpha[e] + sum[e];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P V: P (bf16) from registers, V MN-major from shared memory
    lb::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const float* p = &sc[kk / 4][8 * (kk % 4)];
      const uint32_t a[4] = {pack_bf16(p[0], p[1]), pack_bf16(p[2], p[3]), pack_bf16(p[4], p[5]),
                             pack_bf16(p[6], p[7])};
      // 16 rows of V per k16 step: 16 * 128 bytes = 2048 bytes = 128 descriptor units
      lb::wgmma_m64n64k16_rs_tb(o, a, lb::sw128_desc(sV) + 128 * kk);
    }
    lb::wgmma_commit();
    lb::wgmma_wait<0>();

    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && j + STAGES < ntiles) {
      uint8_t* st = smem + C::kQBytes + s * C::kStageBytes;
      lb::mbar_expect_tx(&bars[1 + s], C::kStageBytes);
      load_tile<TAIL>(st, &tk, &bars[1 + s], h, b, L, (j + STAGES) * BK);
      load_tile<TAIL>(st + C::kKVBytes, &tv, &bars[1 + s], h, b, L, (j + STAGES) * BK);
    }
  }

  float inv[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    inv[e] = 1.f / l[e];
  }
  const int r = q0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (TAIL && r + 8 * e >= L) continue;
      const int64_t idx = ((int64_t)(row0 + r + 8 * e) * H + h) * kD + 8 * c + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(out + idx) =
          __floats2bfloat162_rn(o[4 * c + 2 * e] * inv[e], o[4 * c + 2 * e + 1] * inv[e]);
    }
}

// ------------------------------------------------------------------- host

// A row-major [B, L, H, 64] bf16 tensor as a 4-d map (64 columns, H, L, B)
// read in boxes of box_rows rows of one head of one batch, in the 128-byte
// swizzle: the same box in shared memory as make_map_sw128's, with the
// bounds of each batch's L rows (rows past them read as zeros).
bool make_map_sw128_4d(CUtensorMap* map, const void* ptr, int B, int L, int H, int box_rows) {
  lb::EncodeTiledFn fn = lb::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {128, (cuuint64_t)H * 128, (cuuint64_t)L * H * 128};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BQ, int BK, int STAGES, bool TAIL>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H, float scale,
           void* stream) {
  using C = K2Cfg<BQ, BK, STAGES>;
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  CUtensorMap tq, tk, tv;
  if constexpr (TAIL) {
    if (!make_map_sw128_4d(&tq, q, B, L, H, BQ) || !make_map_sw128_4d(&tk, k, B, L, H, BK) ||
        !make_map_sw128_4d(&tv, v, B, L, H, BK))
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (L % BQ != 0 || L % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t rows = (int64_t)B * L;
    if (!lb::make_map_sw128(&tq, q, rows, H, BQ) || !lb::make_map_sw128(&tk, k, rows, H, BK) ||
        !lb::make_map_sw128(&tv, v, rows, H, BK))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = attention_d64_bf16_kernel<BQ, BK, STAGES, TAIL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(C::kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((L + BQ - 1) / BQ, H, B);
  kernel<<<grid, C::kThreads, C::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), L, H, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: self-attention, head dim 64, bf16 in/out, f32 accumulation, any L
// (a multiple of 128 on the whole-tile kernel, any other on the tail one).
extern "C" int lb_attention_fwd_d64_bf16(const void* q, const void* k, const void* v, void* out, int B, int L,
                                         int H, float scale, void* stream) {
  if (L % 128 == 0) return launch<64, 128, 2, false>(q, k, v, out, B, L, H, scale, stream);
  return launch<64, 128, 2, true>(q, k, v, out, B, L, H, scale, stream);
}
