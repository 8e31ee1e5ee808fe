// K1: per-row spherical interpolation (slerp) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel latentblending_tpu/ops/pallas_kernels.py
// (_slerp_kernel / slerp_pallas). For each row r of a, b [rows, n]:
//
//   na = sum a^2, nb = sum b^2, dot = sum a*b / max(sqrt(na*nb), 1e-20)
//   dot = clip(dot, -1 + 1e-7, 1 - 1e-7), theta = acos(dot)
//   out = a * sin(theta - f*theta) / sin(theta) + b * sin(f*theta) / sin(theta)
//
// with f32 math and the output cast back to the input type.
//
// What bounds it on the H100: memory. A row is 16 384 elements (SDXL-Turbo
// 512^2 latents) and the kernel does ~8 flops per element, far below the
// card's flop/byte balance. The Pallas kernel held a whole row in VMEM;
// here one block owns one row: the first pass streams a and b once and
// reduces the three sums in f32 registers + a block reduction, thread 0
// turns them into the two weights with real acosf/sinf (Mosaic lacked
// acos, hence the TPU kernel's Cephes polynomial), and the second pass
// re-reads the row, which at 64-128 KB per row pair still sits in L2.
// Device traffic is therefore ~read once + write once. Launch is one block
// per row: the main path has 2-40 rows, so the card is far from full; a
// later PR can split rows across a cluster.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-7f;

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slerp_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ fract, T* __restrict__ out, int64_t n) {
  const int64_t row = blockIdx.x;
  const T* ar = a + row * n;
  const T* br = b + row * n;
  T* orow = out + row * n;

  float saa = 0.f, sbb = 0.f, sab = 0.f;
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const float x = load_f(ar, i);
    const float y = load_f(br, i);
    saa = fmaf(x, x, saa);
    sbb = fmaf(y, y, sbb);
    sab = fmaf(x, y, sab);
  }
  saa = warp_sum(saa);
  sbb = warp_sum(sbb);
  sab = warp_sum(sab);

  __shared__ float red[3][kThreads / 32];
  __shared__ float weights[2];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = saa;
    red[1][warp] = sbb;
    red[2][warp] = sab;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float na = 0.f, nb = 0.f, ab = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) {
      na += red[0][w];
      nb += red[1][w];
      ab += red[2][w];
    }
    float dot = ab / fmaxf(sqrtf(na * nb), 1e-20f);
    dot = fminf(fmaxf(dot, -1.0f + kEps), 1.0f - kEps);
    const float theta0 = acosf(dot);
    const float sin0 = sinf(theta0);
    const float theta_t = theta0 * fract[row];
    weights[0] = sinf(theta0 - theta_t) / sin0;
    weights[1] = sinf(theta_t) / sin0;
  }
  __syncthreads();
  const float s0 = weights[0];
  const float s1 = weights[1];
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    store_f(orow, i, load_f(ar, i) * s0 + load_f(br, i) * s1);
  }
}

template <typename T>
int launch(const void* a, const void* b, const float* fract, void* out, int rows, int64_t n,
           void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  slerp_rows_kernel<T><<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), fract, static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lb_slerp_rows_f32(const void* a, const void* b, const void* fract, void* out,
                                 int rows, int64_t n, void* stream) {
  return launch<float>(a, b, static_cast<const float*>(fract), out, rows, n, stream);
}

extern "C" int lb_slerp_rows_bf16(const void* a, const void* b, const void* fract, void* out,
                                  int rows, int64_t n, void* stream) {
  return launch<__nv_bfloat16>(a, b, static_cast<const float*>(fract), out, rows, n, stream);
}
