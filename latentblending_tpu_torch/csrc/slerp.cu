// K1: per-row spherical interpolation (slerp) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel latentblending_tpu/ops/pallas_kernels.py
// (_slerp_kernel / slerp_pallas). For each row r of a, b [rows, n]:
//
//   na = sum a^2, nb = sum b^2, dot = sum a*b / max(sqrt(na*nb), 1e-20)
//   dot = clip(dot, -1 + 1e-7, 1 - 1e-7), theta = acos(dot)
//   out = a * sin(theta - f*theta) / sin(theta) + b * sin(f*theta) / sin(theta)
//
// with f32 math and the output cast back to the input type. Two entry
// points share one kernel body:
//   - slerp_rows: the slerp above (the per-level crossfeed and parental mix);
//   - slerp_tree_step: one step of the fused tree scan, two slerps in one
//     launch: m = slerp(p1 state, latents[p2[r]], parent_fract[r]) with the
//     p1 state latents[p1[r]] or, where win_mask[r], the window row; m is
//     rounded to the storage type in registers (as the two-call version
//     stores it); out[r] = slerp(latents[r], m, mix_coeff[r]). Out of place:
//     other rows read latents[r] as a parent in the same launch.
//
// What bounds it on the H100: memory, ~8 flops per element. But a row is
// only 32-256 KB and the main path has 2-40 rows, so moving the bytes takes
// 0.06-1.2 us at 3.35 TB/s, and the kernel is bound by latency: launch,
// the load round trip, and the reduction of three sums across the row
// (about 5 us per launch measured on an H100, 8 us for the tree step's two
// rounds). The design spends the card's parallelism on that latency:
//   - each row is split over a thread-block cluster of kCluster = 8 CTAs
//     (the portable size; 16 measured slower on an H100 at every path
//     shape), so rows x 8 CTAs fill the SMs;
//   - each thread holds its part of the slice in registers, loaded with
//     16-byte vector loads (8 bf16 or 4 f32), all issued before the first
//     FMA; the output is written from those registers, so device memory
//     sees one read of each input and one write of out (slices larger than
//     a register chunk loop over chunks and re-read the others from L2);
//   - the three partial sums are reduced with warp shuffles and shared
//     memory, published in shared memory, and after a cluster barrier every
//     CTA reads all 8 triples through distributed shared memory and sums
//     them in rank order 0..7: every CTA of a row computes the same
//     weights bit for bit, and a run repeats bit for bit (no atomics);
//   - a last cluster barrier (arrived after the reads, waited on after the
//     stores) keeps each CTA's shared memory alive while peers read it.
// Fractions 0 and 1 give weights exactly (1, 0) and (0, 1), so the output
// is a, resp. b, bit for bit. Rows whose length or pointers are not 16-byte
// aligned take the scalar path of the same body (one element per load).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_ptx.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnitsPerThread = 4;  // load units a thread holds per tensor (one register chunk)
constexpr int kCluster = 8;  // CTAs per row (one thread-block cluster)
constexpr float kEps = 1e-7f;

__host__ __device__ constexpr int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ constexpr int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ uint32_t word(const uint4& u, int w) {
  return w == 0 ? u.x : w == 1 ? u.y : w == 2 ? u.z : u.w;
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(v)));
}

// A load unit: 16 bytes (kVec) or one element. get(u, j) is element j as
// f32; pack(v) rounds E f32 values back to a unit of the storage type.
template <typename T, bool kVec>
struct Unit;

template <>
struct Unit<float, true> {
  using U = uint4;
  static constexpr int E = 4;
  __device__ static float get(const U& u, int j) { return __uint_as_float(word(u, j)); }
  __device__ static U pack(const float (&v)[E]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Unit<__nv_bfloat16, true> {
  using U = uint4;
  static constexpr int E = 8;
  __device__ static float get(const U& u, int j) {
    const uint32_t w = word(u, j >> 1);
    return __uint_as_float((j & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  __device__ static U pack(const float (&v)[E]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Unit<float, false> {
  using U = float;
  static constexpr int E = 1;
  __device__ static float get(const U& u, int) { return u; }
  __device__ static U pack(const float (&v)[E]) { return v[0]; }
};

template <>
struct Unit<__nv_bfloat16, false> {
  using U = unsigned short;
  static constexpr int E = 1;
  __device__ static float get(const U& u, int) { return __uint_as_float(static_cast<uint32_t>(u) << 16); }
  __device__ static U pack(const float (&v)[E]) { return __bfloat16_as_ushort(__float2bfloat16(v[0])); }
};

struct Args {
  const void* x;             // slerp_rows: a; slerp_tree_step: latents
  const void* y;             // slerp_rows: b
  const float* fract;        // slerp_rows: fract; slerp_tree_step: mix_coeff
  const int64_t* p1;         // slerp_tree_step: parent rows
  const int64_t* p2;
  const float* parent_fract;
  const void* window;        // slerp_tree_step: [n] or null
  const uint8_t* win_mask;   // slerp_tree_step: [rows] bool, or null
  void* out;
  int64_t n;                 // elements per row
};

// One register chunk of a slice: unit u = base + i * blockDim.x + tid;
// units past the slice's end read as zero (they add nothing to the sums).
template <typename U>
__device__ __forceinline__ void load_chunk(const U* __restrict__ src, int64_t len, int64_t base,
                                           U (&dst)[kUnitsPerThread]) {
#pragma unroll
  for (int i = 0; i < kUnitsPerThread; ++i) {
    const int64_t u = base + static_cast<int64_t>(i) * blockDim.x + threadIdx.x;
    dst[i] = u < len ? src[u] : U{};
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ typename Unit<T, kVec>::U combine(const typename Unit<T, kVec>::U& x,
                                                            const typename Unit<T, kVec>::U& y, float2 w) {
  using Un = Unit<T, kVec>;
  float v[Un::E];
#pragma unroll
  for (int j = 0; j < Un::E; ++j) v[j] = Un::get(x, j) * w.x + Un::get(y, j) * w.y;
  return Un::pack(v);
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_chunk(typename Unit<T, kVec>::U* __restrict__ dst, int64_t len, int64_t base,
                                            const typename Unit<T, kVec>::U (&x)[kUnitsPerThread],
                                            const typename Unit<T, kVec>::U (&y)[kUnitsPerThread], float2 w) {
#pragma unroll
  for (int i = 0; i < kUnitsPerThread; ++i) {
    const int64_t u = base + static_cast<int64_t>(i) * blockDim.x + threadIdx.x;
    if (u < len) dst[u] = combine<T, kVec>(x[i], y[i], w);
  }
}

// Adds sum x^2, sum y^2, sum x*y of a chunk to s.x, s.y, s.z.
template <typename T, bool kVec>
__device__ __forceinline__ void accumulate(const typename Unit<T, kVec>::U (&x)[kUnitsPerThread],
                                           const typename Unit<T, kVec>::U (&y)[kUnitsPerThread], float3& s) {
  using Un = Unit<T, kVec>;
#pragma unroll
  for (int i = 0; i < kUnitsPerThread; ++i) {
#pragma unroll
    for (int j = 0; j < Un::E; ++j) {
      const float a = Un::get(x[i], j);
      const float b = Un::get(y[i], j);
      s.x = fmaf(a, a, s.x);
      s.y = fmaf(b, b, s.y);
      s.z = fmaf(a, b, s.z);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The row's three sums from each thread's partials: warp shuffles, then
// the warps in order in shared memory, then this CTA's triple is published
// in `pub`; after the cluster barrier every warp reads the kCluster triples
// through distributed shared memory (lane k reads rank k) and sums them in
// rank order. The result is the same bits in every CTA of the cluster.
__device__ __forceinline__ float3 row_sums(float3 s, float4* red, float4* pub) {
  s.x = warp_sum(s.x);
  s.y = warp_sum(s.y);
  s.z = warp_sum(s.z);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float4(s.x, s.y, s.z, 0.f);
  __syncthreads();
  if (threadIdx.x == 0) {
    float4 t = red[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
      t.x += red[w].x;
      t.y += red[w].y;
      t.z += red[w].z;
    }
    *pub = t;
  }
  lb::cluster_sync();
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lane < kCluster) t = lb::ld_cluster_v4(lb::map_shared_rank(lb::smem_u32(pub), lane));
  float3 r = make_float3(__shfl_sync(0xffffffffu, t.x, 0), __shfl_sync(0xffffffffu, t.y, 0),
                         __shfl_sync(0xffffffffu, t.z, 0));
#pragma unroll
  for (int k = 1; k < kCluster; ++k) {
    r.x += __shfl_sync(0xffffffffu, t.x, k);
    r.y += __shfl_sync(0xffffffffu, t.y, k);
    r.z += __shfl_sync(0xffffffffu, t.z, k);
  }
  return r;
}

// (s0, s1) from the row's sums (na, nb, dot) and the fraction.
__device__ __forceinline__ float2 slerp_weights(float3 s, float f) {
  float dot = s.z / fmaxf(sqrtf(s.x * s.y), 1e-20f);
  dot = fminf(fmaxf(dot, -1.0f + kEps), 1.0f - kEps);
  const float theta0 = acosf(dot);
  const float sin0 = sinf(theta0);
  const float theta_t = theta0 * f;
  return make_float2(sinf(theta0 - theta_t) / sin0, sinf(theta_t) / sin0);
}

// Grid: rows x kCluster CTAs, clusters of kCluster along x; CTA rank k of
// row r owns units [k*per, (k+1)*per) of the row. kTree selects the entry.
template <typename T, bool kVec, bool kTree>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads) slerp_kernel(const Args args) {
  using Un = Unit<T, kVec>;
  using U = typename Un::U;
  __shared__ float4 red[kMaxThreads / 32];
  __shared__ float4 pub[2];

  const int64_t row = blockIdx.x / kCluster;
  const int64_t rank = lb::cluster_ctarank();
  const int64_t n = args.n;
  const int64_t n_units = n / Un::E;
  const int64_t per = (n_units + kCluster - 1) / kCluster;
  const int64_t begin = min64(n_units, rank * per);
  const int64_t len = min64(n_units, begin + per) - begin;
  const int64_t chunk = static_cast<int64_t>(blockDim.x) * kUnitsPerThread;
  const int nchunks = static_cast<int>(max64(1, (len + chunk - 1) / chunk));
  const int last = nchunks - 1;
  const T* x0 = static_cast<const T*>(args.x);
  U* out = reinterpret_cast<U*>(static_cast<T*>(args.out) + row * n) + begin;
  const float f = args.fract[row];

  if constexpr (!kTree) {
    const U* a = reinterpret_cast<const U*>(x0 + row * n) + begin;
    const U* b = reinterpret_cast<const U*>(static_cast<const T*>(args.y) + row * n) + begin;
    U xa[kUnitsPerThread], xb[kUnitsPerThread];
    float3 s = make_float3(0.f, 0.f, 0.f);
    for (int c = 0; c <= last; ++c) {
      load_chunk(a, len, c * chunk, xa);
      load_chunk(b, len, c * chunk, xb);
      accumulate<T, kVec>(xa, xb, s);
    }
    const float2 w = slerp_weights(row_sums(s, red, &pub[0]), f);
    lb::cluster_arrive();  // this CTA has read all peers' triples
    // the last chunk is still in registers
    for (int c = last; c >= 0; --c) {
      if (c != last) {
        load_chunk(a, len, c * chunk, xa);
        load_chunk(b, len, c * chunk, xb);
      }
      store_chunk<T, kVec>(out, len, c * chunk, xa, xb, w);
    }
  } else {
    const bool from_window = args.window != nullptr && args.win_mask[row] != 0;
    const T* p1_row = from_window ? static_cast<const T*>(args.window) : x0 + args.p1[row] * n;
    const U* p1 = reinterpret_cast<const U*>(p1_row) + begin;
    const U* p2 = reinterpret_cast<const U*>(x0 + args.p2[row] * n) + begin;
    const U* xs = reinterpret_cast<const U*>(x0 + row * n) + begin;
    const float pf = args.parent_fract[row];
    U q1[kUnitsPerThread], q2[kUnitsPerThread], xr[kUnitsPerThread];
    // round 1: the parental pair's sums (x of the last chunk loaded with it)
    float3 s = make_float3(0.f, 0.f, 0.f);
    for (int c = 0; c <= last; ++c) {
      load_chunk(p1, len, c * chunk, q1);
      load_chunk(p2, len, c * chunk, q2);
      if (c == last) load_chunk(xs, len, c * chunk, xr);
      accumulate<T, kVec>(q1, q2, s);
    }
    const float2 w1 = slerp_weights(row_sums(s, red, &pub[0]), pf);
    // round 2: m rounded to T in registers (q1 holds it), then the sums of
    // (x, m); walked last chunk first, so chunk 0 stays in registers
    s = make_float3(0.f, 0.f, 0.f);
    for (int c = last; c >= 0; --c) {
      if (c != last) {
        load_chunk(p1, len, c * chunk, q1);
        load_chunk(p2, len, c * chunk, q2);
        load_chunk(xs, len, c * chunk, xr);
      }
#pragma unroll
      for (int i = 0; i < kUnitsPerThread; ++i) q1[i] = combine<T, kVec>(q1[i], q2[i], w1);
      accumulate<T, kVec>(xr, q1, s);
    }
    const float2 w2 = slerp_weights(row_sums(s, red, &pub[1]), f);
    lb::cluster_arrive();
    for (int c = 0; c <= last; ++c) {
      if (c != 0) {
        load_chunk(p1, len, c * chunk, q1);
        load_chunk(p2, len, c * chunk, q2);
        load_chunk(xs, len, c * chunk, xr);
#pragma unroll
        for (int i = 0; i < kUnitsPerThread; ++i) q1[i] = combine<T, kVec>(q1[i], q2[i], w1);
      }
      store_chunk<T, kVec>(out, len, c * chunk, xr, q1, w2);
    }
  }
  lb::cluster_wait();  // no CTA exits while a peer may still read its triple
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T, bool kVec, bool kTree>
int launch_as(const Args& args, int rows, cudaStream_t stream) {
  constexpr int E = Unit<T, kVec>::E;
  const int64_t per = (args.n / E + kCluster - 1) / kCluster;
  const int threads = static_cast<int>(min64(kMaxThreads, max64(32, (per + 31) / 32 * 32)));
  slerp_kernel<T, kVec, kTree><<<static_cast<unsigned>(rows) * kCluster, threads, 0, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// The vector path needs 16-byte rows and 16-byte aligned base pointers.
template <typename T, bool kTree>
int launch(const Args& args, int rows, void* stream) {
  if (rows <= 0 || args.n <= 0) return 0;
  const bool vec = (args.n * static_cast<int64_t>(sizeof(T))) % 16 == 0 && aligned16(args.x) &&
                   aligned16(args.out) && (args.y == nullptr || aligned16(args.y)) &&
                   (args.window == nullptr || aligned16(args.window));
  const auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_as<T, true, kTree>(args, rows, s) : launch_as<T, false, kTree>(args, rows, s);
}

Args rows_args(const void* a, const void* b, const void* fract, void* out, int64_t n) {
  Args args = {};
  args.x = a;
  args.y = b;
  args.fract = static_cast<const float*>(fract);
  args.out = out;
  args.n = n;
  return args;
}

Args tree_args(const void* latents, const void* p1, const void* p2, const void* parent_fract,
               const void* mix_coeff, const void* window, const void* win_mask, void* out, int64_t n) {
  Args args = {};
  args.x = latents;
  args.fract = static_cast<const float*>(mix_coeff);
  args.p1 = static_cast<const int64_t*>(p1);
  args.p2 = static_cast<const int64_t*>(p2);
  args.parent_fract = static_cast<const float*>(parent_fract);
  args.window = window;
  args.win_mask = static_cast<const uint8_t*>(win_mask);
  args.out = out;
  args.n = n;
  return args;
}

}  // namespace

extern "C" int lb_slerp_rows_f32(const void* a, const void* b, const void* fract, void* out, int rows, int64_t n,
                                 void* stream) {
  return launch<float, false>(rows_args(a, b, fract, out, n), rows, stream);
}

extern "C" int lb_slerp_rows_bf16(const void* a, const void* b, const void* fract, void* out, int rows, int64_t n,
                                  void* stream) {
  return launch<__nv_bfloat16, false>(rows_args(a, b, fract, out, n), rows, stream);
}

extern "C" int lb_slerp_tree_step_f32(const void* latents, const void* p1, const void* p2, const void* parent_fract,
                                      const void* mix_coeff, const void* window, const void* win_mask, void* out,
                                      int rows, int64_t n, void* stream) {
  return launch<float, true>(tree_args(latents, p1, p2, parent_fract, mix_coeff, window, win_mask, out, n), rows,
                             stream);
}

extern "C" int lb_slerp_tree_step_bf16(const void* latents, const void* p1, const void* p2,
                                       const void* parent_fract, const void* mix_coeff, const void* window,
                                       const void* win_mask, void* out, int rows, int64_t n, void* stream) {
  return launch<__nv_bfloat16, true>(
      tree_args(latents, p1, p2, parent_fract, mix_coeff, window, win_mask, out, n), rows, stream);
}
