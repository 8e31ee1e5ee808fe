// M1: the MMDiT's adaLN-Zero modulation and gated residuals in one bf16
// pass over the token rows, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no SD3. In the port's MMDiT
// (models/mmdit.py, JointTransformerBlock and _NormOut) each norm of a
// stream was a chain of PyTorch elementwise passes through float32 temporaries
// (cast, LayerNorm, two broadcast passes, cast back), and so was each gated
// residual. Two entries, x and y [B, L, D] bf16 contiguous, each modulation
// vector [B, D] bf16 with a batch stride of its own (a chunk of the adaLN
// linear's output), D a multiple of 8:
//
//   ln_modulate:     out = bf16(LN(x) * (1 + scale) + shift)
//   gated_residual:  x'  = bf16(x + gate * y)
//                    and, given shift and scale, out = ln_modulate(x', ...)
//
// LN has no affine parameters and eps 1e-6; its mean and variance are taken
// in float32 over the row (two passes over the registers), the modulation in
// float32, one rounding to bf16 a result. The fused form normalises the
// ROUNDED x', as the unfused code did (it stored x' in bf16 and read it back).
// The products and sums are the unfused code's float32 operations in its
// order, with no contraction into FMAs (__fmul_rn, __fadd_rn), so x' is the
// unfused result bit for bit; the norm's statistics are summed in another
// order, which moves an output by at most a rounding step.
//
// What bounds it on the H100: memory. ~10 flops an element against 4 (norm),
// 6 (residual) or 8 (both) bytes; SD3.5-Large's rows are 2432 wide, 4096
// image and 333 text rows of up to 12 batch entries. The design:
//   - a CTA of 1-8 warps holds a whole row in registers, 8 bf16 a 16-byte
//     load, kVpt loads a thread, so device memory sees each input read once
//     and each output written once; no float32 intermediate leaves the SM;
//   - a CTA walks `rows` consecutive rows of one batch entry and keeps that
//     entry's modulation vectors in registers (read once a CTA, from L2);
//     it loads the next row before it reduces the current one;
//   - the row's sums: warp shuffles, then one slot a warp in shared memory,
//     summed in warp order by every thread (the same value in each thread;
//     two slots, so the next row's first sum cannot overwrite the second).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = __uint_as_float(w[k] << 16);  // the lower address's element
    f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even, as PyTorch's .to(bf16)
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// The CTA's sum of v, in every thread; slot holds one float a warp.
__device__ __forceinline__ float cta_sum(float v, float* slot, int warps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < warps; ++w) s += slot[w];
  return s;
}

struct Args {
  const uint4* x;
  const uint4* y;  // gated: the branch's output
  const uint4* gate;
  const uint4* shift;
  const uint4* scale;
  int64_t gate_stride, shift_stride, scale_stride;  // batch strides of the vectors, in 16-byte units
  uint4* x_out;  // gated: x'
  uint4* out;    // norm: the modulated norm
  int L, nvec, rows;  // rows of a batch entry, 16-byte units a row, rows a CTA
  float d;  // the row's width
};

template <int kVpt, bool kGated, bool kNorm>
__global__ void __launch_bounds__(kMaxWarps * 32) adaln_kernel(const Args a) {
  __shared__ float red[2][kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * a.rows;
  const int r1 = min(r0 + a.rows, a.L);
  bool live[kVpt];
  int col[kVpt];
  uint4 g[kVpt], sh[kVpt], sc[kVpt];
#pragma unroll
  for (int i = 0; i < kVpt; ++i) {
    col[i] = threadIdx.x + i * blockDim.x;
    live[i] = col[i] < a.nvec;
    if (live[i]) {
      if (kGated) g[i] = a.gate[b * a.gate_stride + col[i]];
      if (kNorm) {
        sh[i] = a.shift[b * a.shift_stride + col[i]];
        sc[i] = a.scale[b * a.scale_stride + col[i]];
      }
    }
  }
  uint4 xn[kVpt], yn[kVpt];  // the next row's loads
  if (r0 < r1) {
    const int64_t row = (static_cast<int64_t>(b) * a.L + r0) * a.nvec;
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
      if (!live[i]) continue;
      xn[i] = a.x[row + col[i]];
      if (kGated) yn[i] = a.y[row + col[i]];
    }
  }
  for (int r = r0; r < r1; ++r) {
    const int64_t row = (static_cast<int64_t>(b) * a.L + r) * a.nvec;
    uint4 xv[kVpt], yv[kVpt];
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
      xv[i] = xn[i];
      if (kGated) yv[i] = yn[i];
      if (live[i] && r + 1 < r1) {
        xn[i] = a.x[row + a.nvec + col[i]];
        if (kGated) yn[i] = a.y[row + a.nvec + col[i]];
      }
    }
    float f[kVpt][8];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
      if (!live[i]) continue;
      unpack(xv[i], f[i]);
      if (kGated) {
        float yf[8], gf[8];
        unpack(yv[i], yf);
        unpack(g[i], gf);
#pragma unroll
        for (int j = 0; j < 8; ++j) f[i][j] = __fadd_rn(f[i][j], __fmul_rn(gf[j], yf[j]));
        const uint4 xr = pack(f[i]);
        a.x_out[row + col[i]] = xr;
        if (kNorm) unpack(xr, f[i]);  // the norm reads x' as stored
      }
      if (kNorm) {
#pragma unroll
        for (int j = 0; j < 8; ++j) s += f[i][j];
      }
    }
    if (!kNorm) continue;
    const float mean = __fdiv_rn(cta_sum(s, red[0], warps), a.d);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
      if (!live[i]) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[i][j] - mean;
        q += d * d;
      }
    }
    const float rstd = rsqrtf(__fdiv_rn(cta_sum(q, red[1], warps), a.d) + kEps);
#pragma unroll
    for (int i = 0; i < kVpt; ++i) {
      if (!live[i]) continue;
      float shf[8], scf[8], o[8];
      unpack(sh[i], shf);
      unpack(sc[i], scf);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float n = __fmul_rn(__fsub_rn(f[i][j], mean), rstd);
        o[j] = __fadd_rn(__fmul_rn(n, __fadd_rn(1.f, scf[j])), shf[j]);
      }
      a.out[row + col[i]] = pack(o);
    }
  }
}

// Loads a thread and warps a CTA for a row of nvec 16-byte units: the
// fewest loads a thread (1, 2 or 4) that fit the row in kMaxWarps warps
// (rows up to 8192 wide).
void row_shape(int nvec, int* vpt, int* warps) {
  for (int v : {1, 2, 4}) {
    *vpt = v;
    *warps = (nvec + 32 * v - 1) / (32 * v);
    if (*warps <= kMaxWarps) return;
  }
}

template <bool kGated, bool kNorm>
int launch(Args a, int B, int D, void* stream) {
  if (B <= 0 || a.L <= 0) return 0;
  a.nvec = D / 8;
  a.d = static_cast<float>(D);
  int vpt, warps;
  row_shape(a.nvec, &vpt, &warps);
  if (warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  // rows a CTA: enough CTAs for ~24 a SM, at most 16 rows (the vectors' reads
  // spread over 16 rows)
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t per = static_cast<int64_t>(B) * a.L / (static_cast<int64_t>(sms) * 24);
  a.rows = static_cast<int>(per < 1 ? 1 : per > 16 ? 16 : per);
  const dim3 grid((a.L + a.rows - 1) / a.rows, B);
  const dim3 block(warps * 32);
  auto s = static_cast<cudaStream_t>(stream);
  if (vpt == 1) adaln_kernel<1, kGated, kNorm><<<grid, block, 0, s>>>(a);
  else if (vpt == 2) adaln_kernel<2, kGated, kNorm><<<grid, block, 0, s>>>(a);
  else adaln_kernel<4, kGated, kNorm><<<grid, block, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides are in elements; the wrapper (ops/adaln.py) checks that they and
// the pointers are multiples of 8 elements / 16 bytes.
extern "C" int lb_adaln_modulate_bf16(const void* x, const void* shift, int64_t shift_stride, const void* scale,
                                      int64_t scale_stride, void* out, int B, int L, int D, void* stream) {
  Args a{};
  a.x = static_cast<const uint4*>(x);
  a.shift = static_cast<const uint4*>(shift);
  a.scale = static_cast<const uint4*>(scale);
  a.shift_stride = shift_stride / 8;
  a.scale_stride = scale_stride / 8;
  a.out = static_cast<uint4*>(out);
  a.L = L;
  return launch<false, true>(a, B, D, stream);
}

// shift, scale and out null: x' alone.
extern "C" int lb_gated_residual_bf16(const void* x, const void* gate, int64_t gate_stride, const void* y,
                                      const void* shift, int64_t shift_stride, const void* scale,
                                      int64_t scale_stride, void* x_out, void* out, int B, int L, int D,
                                      void* stream) {
  Args a{};
  a.x = static_cast<const uint4*>(x);
  a.y = static_cast<const uint4*>(y);
  a.gate = static_cast<const uint4*>(gate);
  a.gate_stride = gate_stride / 8;
  a.shift = static_cast<const uint4*>(shift);
  a.scale = static_cast<const uint4*>(scale);
  a.shift_stride = shift_stride / 8;
  a.scale_stride = scale_stride / 8;
  a.x_out = static_cast<uint4*>(x_out);
  a.out = static_cast<uint4*>(out);
  a.L = L;
  if (out == nullptr) return launch<true, false>(a, B, D, stream);
  return launch<true, true>(a, B, D, stream);
}
