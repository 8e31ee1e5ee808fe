// K2/K3: non-causal, unmasked attention forward, softmax(Q K^T * scale) V,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash_attention calls behind the
// _use_flash_attention gate of latentblending_tpu/models/layers.py:
//   K2 Attention.__call__     (UNet self-attention, d = 64, bf16)
//   K3 VAEAttention.__call__  (VAE mid block, one head, d = 512, f32)
//
// q, k, v and out are [B, L, H, D] row-major, the layout the q/k/v
// projections produce, so no transposes are needed around the call.
//
// What bounds it on the H100: at the main path's shapes it is compute
// (4*B*H*L^2*D flops against 4*B*L*H*D elements moved; at L = 1024, d = 64
// that is ~256 flops per element, and the L x L logits never touch device
// memory). This first kernel is the plain online-softmax (flash) forward on
// the CUDA cores in f32, not yet on the tensor cores (mma/wgmma, TMA and
// tuning are later work): it is correct and keeps memory O(L * tile), which
// is what the Pallas kernel was for (the plain path materialises [B,H,L,L]).
//
// Design. One block owns one (batch, head, BQ-row query tile) and walks the
// K/V sequence in BK-row tiles staged in shared memory:
//   1. K tile -> smem (rows padded to D+1 floats: the score loop reads
//      K[j][d] with j varying across lanes, which would otherwise be a
//      2^k-strided, bank-conflicting access),
//   2. S = Q K^T * scale for the BQ x BK tile, spread over all threads,
//   3. per-row running max / sum update (one thread per query row) while
//      the V tile overwrites the K buffer,
//   4. O = O * alpha + P V, with O in registers: each thread owns D/CG
//      columns of BQ/RG rows (CG = min(D, threads) column lanes).
// At d = 512 the tiles come to ~100 KB of shared memory, above the 48 KB
// default, so the launcher raises cudaFuncAttributeMaxDynamicSharedMemorySize
// first (otherwise the launch is refused and never runs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int D, int BQ, int BK, int NT>
struct Tile {
  static constexpr int CG = D < NT ? D : NT;  // column lanes
  static constexpr int RG = NT / CG;          // row groups
  static constexpr int COLS = D / CG;         // columns per thread
  static constexpr int ROWS = BQ / RG;        // rows per thread
  static constexpr int KP = D + 1;            // padded K/V row stride (floats)
  static constexpr size_t smem_floats = (size_t)BQ * D + (size_t)BK * KP + (size_t)BQ * BK + 3 * BQ;
  static constexpr size_t smem_bytes = smem_floats * sizeof(float);
  static_assert(NT % CG == 0 && D % CG == 0 && BQ % RG == 0, "bad tiling");
  static_assert((BQ * BK) % NT == 0, "score tile must split evenly");
  static_assert(BQ <= NT, "one thread per query row in the softmax step");
};

template <int D, int BQ, int BK, int NT, typename T>
__global__ void __launch_bounds__(NT)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int L, int H, float scale) {
  using TL = Tile<D, BQ, BK, NT>;
  extern __shared__ float smem[];
  float* sQ = smem;                       // [BQ][D]
  float* sKV = sQ + BQ * D;               // [BK][KP]
  float* sS = sKV + BK * TL::KP;          // [BQ][BK]
  float* sM = sS + BQ * BK;               // [BQ] running max
  float* sL = sM + BQ;                    // [BQ] running sum
  float* sA = sL + BQ;                    // [BQ] rescale factor of this tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t row_stride = (int64_t)H * D;  // elements between sequence positions
  const int64_t base = ((int64_t)b * L) * row_stride + (int64_t)h * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int i = idx / D, d = idx % D;
    sQ[idx] = to_f(q[base + (int64_t)(q0 + i) * row_stride + d]);
  }
  for (int i = tid; i < BQ; i += NT) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  const int tc = tid % TL::CG;
  const int tr = tid / TL::CG;
  float acc[TL::ROWS][TL::COLS];
#pragma unroll
  for (int r = 0; r < TL::ROWS; ++r)
#pragma unroll
    for (int c = 0; c < TL::COLS; ++c) acc[r][c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // previous tile's P.V reads of sKV/sS are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      sKV[j * TL::KP + d] = to_f(k[base + (int64_t)(k0 + j) * row_stride + d]);
    }
    __syncthreads();

    for (int idx = tid; idx < BQ * BK; idx += NT) {
      const int i = idx / BK, j = idx % BK;
      const float* qi = sQ + i * D;
      const float* kj = sKV + j * TL::KP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qi[d], kj[d], s);
      sS[idx] = s * scale;
    }
    __syncthreads();

    // V overwrites the K buffer while the first BQ threads update the
    // softmax statistics (they touch only sS/sM/sL/sA)
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int j = idx / D, d = idx % D;
      sKV[j * TL::KP + d] = to_f(v[base + (int64_t)(k0 + j) * row_stride + d]);
    }
    if (tid < BQ) {
      float* srow = sS + tid * BK;
      float m_old = sM[tid];
      float m_new = m_old;
      for (int j = 0; j < BK; ++j) m_new = fmaxf(m_new, srow[j]);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float p = expf(srow[j] - m_new);
        srow[j] = p;
        sum += p;
      }
      const float alpha = expf(m_old - m_new);  // 0 on the first tile (m_old = -inf)
      sA[tid] = alpha;
      sL[tid] = sL[tid] * alpha + sum;
      sM[tid] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < TL::ROWS; ++r) {
      const int i = tr + r * TL::RG;
      const float alpha = sA[i];
      const float* prow = sS + i * BK;
#pragma unroll
      for (int c = 0; c < TL::COLS; ++c) {
        const int d = tc + c * TL::CG;
        float o = acc[r][c] * alpha;
        for (int j = 0; j < BK; ++j) o = fmaf(prow[j], sKV[j * TL::KP + d], o);
        acc[r][c] = o;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < TL::ROWS; ++r) {
    const int i = tr + r * TL::RG;
    const float inv = 1.f / sL[i];
#pragma unroll
    for (int c = 0; c < TL::COLS; ++c) {
      const int d = tc + c * TL::CG;
      out[base + (int64_t)(q0 + i) * row_stride + d] = from_f<T>(acc[r][c] * inv);
    }
  }
}

template <int D, int BQ, int BK, int NT, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
           float scale, void* stream) {
  using TL = Tile<D, BQ, BK, NT>;
  if (B <= 0 || L <= 0 || H <= 0) return 0;
  if (L % BQ != 0 || L % BK != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_fwd_kernel<D, BQ, BK, NT, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(TL::smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(L / BQ, H, B);
  kernel<<<grid, NT, TL::smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), L, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2: UNet self-attention, head dim 64, bf16 in/out, f32 accumulation.
extern "C" int lb_attention_fwd_d64_bf16(const void* q, const void* k, const void* v, void* out,
                                         int B, int L, int H, float scale, void* stream) {
  return launch<64, 64, 64, 256, __nv_bfloat16>(q, k, v, out, B, L, H, scale, stream);
}

// K3: VAE mid-block attention, one head of d = 512, f32.
extern "C" int lb_attention_fwd_d512_f32(const void* q, const void* k, const void* v, void* out,
                                         int B, int L, int H, float scale, void* stream) {
  return launch<512, 16, 32, 256, float>(q, k, v, out, B, L, H, scale, stream);
}
