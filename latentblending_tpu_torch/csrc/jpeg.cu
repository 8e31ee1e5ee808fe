// J1-J3: baseline JPEG encoding on Hopper (sm_90a), the movie writer's
// encoder (latentblending_tpu_torch/video/jpeg.py).
//
// These kernels replace no Pallas kernel: they do on the card what the JAX
// package does on the host through libjpeg (latentblending_tpu/video/
// _jpeg_lerp.py:66 `encode_i420` and :107 `JpegPair.lerp`, both over
// native/jpeg_coef_lerp.cpp; mjpeg_mp4.py's cv2.imencode). Their output is
// libjpeg's, bit for bit:
//
//   J1 fdct_quant: one CTA per 16x16 MCU of a frame, 384 threads (6 blocks
//      of 64 samples: Y00 Y01 Y10 Y11 Cb Cr). Samples are read with libjpeg's
//      edge expansion (the last row or column again; a chroma row past the
//      downsampled height is the last one again); from RGB, each sample is
//      converted first with jccolor.c's fixed-point rgb_ycc_convert and, for
//      chroma, jcsample.c's h2v2_downsample (bias 1, 2, 1, 2, ...). Then
//      jfdctint.c's jpeg_fdct_islow (rows, then columns; 64-bit products, as
//      libjpeg's JLONG on this platform: an odd-part sum such as
//      tmp4 + z1 + z3 can pass 2^31 in the column pass) and jcdctmgr.c's
//      quantize, (|x| + 4q) / 8q with the sign put back. Dummy Y blocks past
//      the image's blocks get AC 0 and the DC of the block before them
//      (jccoefct.c). Output int16 [B, nblocks, 64], zigzag order.
//   J2 coef_lerp: round half away from zero of fmaf(1-t, a, t*b) per
//      coefficient, one launch an in-between frame: native/jpeg_coef_lerp.cpp
//      :142-157 as g++ -O3 -march=native builds it (the two products
//      contracted into one FMA).
//   J3 huff_count / huff_write / stuff_count / stuff_scatter: jchuff.c's
//      encode_one_block with the standard tables, in four launches around
//      two torch.cumsum scans: each block's bit count (DC difference to the
//      previous block of its component, run/size symbols, ZRL, EOB); each
//      block's bits written at its offset into a zeroed buffer of big-endian
//      32-bit words with atomicOr (blocks share the words at their ends), the
//      last block padding the last byte with 1-bits (flush_bits); the 0xFF
//      bytes counted per 64-byte chunk; then every byte scattered to its place
//      with a 0x00 after each 0xFF. No restart markers (libjpeg writes none).
//
// What bounds them on the H100: at 512x512 a frame is 0.39 MB of I420 in and
// 0.79 MB of coefficients out (J1), 1.6 MB in and 0.79 MB out (J2), and
// 0.79 MB in plus ~0.1-0.4 MB of scan out (J3): microseconds of memory time.
// They are bound by latency (J3 takes four launches, two scans and a read of
// the length by the host) and, in J3, by one thread coding a whole block
// serially. Simple and right first: nothing here is tuned.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// zigzag position of each natural (row-major) coefficient index
__constant__ int kZigzagPos[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42, 3,  8,  12, 17, 25, 30,
    41, 43, 9,  11, 18, 24, 31, 40, 44, 53, 10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38,
    46, 51, 55, 60, 21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

constexpr int kStuffChunk = 64;  // bytes per thread of the stuffing pass (video/jpeg.py _STUFF_CHUNK)

__device__ __forceinline__ int ycc_y(const uint8_t* p) {
  return (19595 * p[0] + 38470 * p[1] + 7471 * p[2] + 32768) >> 16;
}
__device__ __forceinline__ int ycc_c(const uint8_t* p, int comp) {
  // Cb (comp 0) or Cr (comp 1); FIX(0.5)*i + CBCR_OFFSET + ONE_HALF - 1 on the B or R term
  const int off = (128 << 16) + 32767;
  return comp == 0 ? (-11059 * p[0] - 21709 * p[1] + 32768 * p[2] + off) >> 16
                   : (32768 * p[0] - 27439 * p[1] - 5329 * p[2] + off) >> 16;
}

__device__ __forceinline__ long long descale(long long x, int n) { return (x + (1LL << (n - 1))) >> n; }

// one pass of jpeg_fdct_islow over 8 values d[0], d[stride], ... in place
template <bool kFirst>
__device__ void fdct_pass(int* d, int stride) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int kOdd = kFirst ? kConst - kPass1 : kConst + kPass1;
  long long s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = d[i * stride];
  long long tmp0 = s[0] + s[7], tmp7 = s[0] - s[7];
  long long tmp1 = s[1] + s[6], tmp6 = s[1] - s[6];
  long long tmp2 = s[2] + s[5], tmp5 = s[2] - s[5];
  long long tmp3 = s[3] + s[4], tmp4 = s[3] - s[4];
  long long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  long long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  if (kFirst) {
    d[0] = (int)((tmp10 + tmp11) << kPass1);
    d[4 * stride] = (int)((tmp10 - tmp11) << kPass1);
  } else {
    d[0] = (int)descale(tmp10 + tmp11, kPass1);
    d[4 * stride] = (int)descale(tmp10 - tmp11, kPass1);
  }
  long long z1 = (tmp12 + tmp13) * 4433;
  d[2 * stride] = (int)descale(z1 + tmp13 * 6270, kOdd);
  d[6 * stride] = (int)descale(z1 + tmp12 * -15137, kOdd);
  z1 = tmp4 + tmp7;
  long long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
  long long z5 = (z3 + z4) * 9633;
  tmp4 *= 2446;
  tmp5 *= 16819;
  tmp6 *= 25172;
  tmp7 *= 12299;
  z1 *= -7373;
  z2 *= -20995;
  z3 = z3 * -16069 + z5;
  z4 = z4 * -3196 + z5;
  d[7 * stride] = (int)descale(tmp4 + z1 + z3, kOdd);
  d[5 * stride] = (int)descale(tmp5 + z2 + z4, kOdd);
  d[3 * stride] = (int)descale(tmp6 + z2 + z3, kOdd);
  d[1 * stride] = (int)descale(tmp7 + z1 + z4, kOdd);
}

__global__ void __launch_bounds__(384) fdct_quant_kernel(const uint8_t* __restrict__ frames,
                                                         const int* __restrict__ quant, int16_t* __restrict__ out,
                                                         int H, int W, int rgb) {
  __shared__ int s[6][64];
  __shared__ int qs[6][64];
  const int t = threadIdx.x, blk = t >> 6, pos = t & 63, r = pos >> 3, c = pos & 7;
  const int mx = (W + 15) >> 4, mcu = blockIdx.x, mr = mcu / mx, mc = mcu % mx;
  const long long frame_bytes = rgb ? 3LL * H * W : (long long)H * W * 3 / 2;
  const uint8_t* f = frames + blockIdx.y * frame_bytes;

  int v;
  if (blk < 4) {
    const int y = min(mr * 16 + (blk >> 1) * 8 + r, H - 1), x = min(mc * 16 + (blk & 1) * 8 + c, W - 1);
    v = rgb ? ycc_y(f + 3LL * ((long long)y * W + x)) : f[(long long)y * W + x];
  } else {
    const int comp = blk - 4, cy = mr * 8 + r, cx = mc * 8 + c;
    if (rgb) {
      const int cye = min(cy, (H + 1) / 2 - 1);
      const int r0 = 2 * cye, r1 = min(2 * cye + 1, H - 1), c0 = min(2 * cx, W - 1), c1 = min(2 * cx + 1, W - 1);
      const uint8_t* row0 = f + 3LL * r0 * W;
      const uint8_t* row1 = f + 3LL * r1 * W;
      v = (ycc_c(row0 + 3 * c0, comp) + ycc_c(row0 + 3 * c1, comp) + ycc_c(row1 + 3 * c0, comp) +
           ycc_c(row1 + 3 * c1, comp) + 1 + (cx & 1)) >> 2;
    } else {
      const int ch = H / 2, cw = W / 2;
      const uint8_t* plane = f + (long long)H * W + (long long)comp * ch * cw;
      v = plane[(long long)min(cy, ch - 1) * cw + min(cx, cw - 1)];
    }
  }
  s[blk][pos] = v - 128;
  __syncthreads();
  if (t < 48) fdct_pass<true>(&s[t >> 3][(t & 7) * 8], 1);
  __syncthreads();
  if (t < 48) fdct_pass<false>(&s[t >> 3][t & 7], 8);
  __syncthreads();

  const int x = s[blk][pos], q = quant[(blk < 4 ? 0 : 64) + pos] * 8;
  const int mag = (abs(x) + (q >> 1)) / q;
  qs[blk][pos] = x < 0 ? -mag : mag;
  const int hb = (H + 7) >> 3, wb = (W + 7) >> 3;
  const bool dummy = blk < 4 && (mr * 2 + (blk >> 1) >= hb || mc * 2 + (blk & 1) >= wb);
  __syncthreads();
  if (t == 0) {
    for (int b = 1; b < 4; ++b)
      if (mr * 2 + (b >> 1) >= hb || mc * 2 + (b & 1) >= wb) qs[b][0] = qs[b - 1][0];
  }
  __syncthreads();
  const int res = (dummy && pos != 0) ? 0 : qs[blk][pos];
  const long long nblocks = (long long)((H + 15) >> 4) * mx * 6;
  out[((blockIdx.y * nblocks) + (long long)mcu * 6 + blk) * 64 + kZigzagPos[pos]] = (int16_t)res;
}

__global__ void coef_lerp_kernel(const int16_t* __restrict__ a, const int16_t* __restrict__ b,
                                 int16_t* __restrict__ out, long long n, float t) {
  const float wi = __fsub_rn(1.0f, t);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += (long long)gridDim.x * blockDim.x) {
    const float v = __fmaf_rn(wi, (float)a[i], __fmul_rn(t, (float)b[i]));
    const float r = v >= 0.0f ? __fadd_rn(v, 0.5f) : __fsub_rn(v, 0.5f);
    out[i] = (int16_t)(int)r;  // the cast truncates toward zero, as (JCOEF) does
  }
}

__device__ __forceinline__ int nbits_of(int x) { return x ? 32 - __clz(x) : 0; }

// the previous block of the same component in scan order, or -1
__device__ __forceinline__ int prev_block(int n) {
  const int p = n % 6;
  if (p > 0 && p < 4) return n - 1;
  if (p == 0) return n >= 6 ? n - 3 : -1;
  return n >= 6 ? n - 6 : -1;
}

__device__ void load_tables(const int2* __restrict__ g, int2* sh) {
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x) sh[i] = g[i];
  __syncthreads();
}

// Calls emit(code, size) for every code and value of block n, in order.
template <typename Emit>
__device__ void code_block(const int16_t* __restrict__ coef, const int2* tbl, int n, Emit emit) {
  const int16_t* blk = coef + (long long)n * 64;
  const int2* dc = tbl + (n % 6 < 4 ? 0 : 512);
  const int2* ac = dc + 256;
  const int pn = prev_block(n);
  const int diff = blk[0] - (pn >= 0 ? coef[(long long)pn * 64] : 0);
  int nb = nbits_of(abs(diff));
  emit(dc[nb].x, dc[nb].y);
  if (nb) emit((diff < 0 ? diff - 1 : diff) & ((1 << nb) - 1), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    const int v = blk[k];
    if (v == 0) {
      ++run;
      continue;
    }
    for (; run > 15; run -= 16) emit(ac[0xF0].x, ac[0xF0].y);
    nb = nbits_of(abs(v));
    emit(ac[(run << 4) + nb].x, ac[(run << 4) + nb].y);
    emit((v < 0 ? v - 1 : v) & ((1 << nb) - 1), nb);
    run = 0;
  }
  if (run > 0) emit(ac[0].x, ac[0].y);
}

__global__ void huff_count_kernel(const int16_t* __restrict__ coef, const int2* __restrict__ tables,
                                  int* __restrict__ counts, int nblocks) {
  __shared__ int2 tbl[4 * 256];
  load_tables(tables, tbl);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= nblocks) return;
  int bits = 0;
  code_block(coef, tbl, n, [&](int, int size) { bits += size; });
  counts[n] = bits;
}

// ORs `size` bits of `code` into the big-endian word stream at bit `pos`
__device__ __forceinline__ void put_bits(unsigned* words, long long pos, unsigned code, int size) {
  if (size == 0) return;
  const long long w = pos >> 5;
  const int room = 32 - (int)(pos & 31);
  if (size <= room) {
    atomicOr(words + w, code << (room - size));
  } else {
    atomicOr(words + w, code >> (size - room));
    atomicOr(words + w + 1, code << (32 - (size - room)));
  }
}

__global__ void huff_write_kernel(const int16_t* __restrict__ coef, const int2* __restrict__ tables,
                                  const long long* __restrict__ ends, unsigned* __restrict__ words, int nblocks) {
  __shared__ int2 tbl[4 * 256];
  load_tables(tables, tbl);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= nblocks) return;
  long long pos = n ? ends[n - 1] : 0;
  code_block(coef, tbl, n, [&](int code, int size) {
    put_bits(words, pos, (unsigned)code, size);
    pos += size;
  });
  if (n == nblocks - 1) {
    const int pad = (int)((8 - (pos & 7)) & 7);  // flush_bits: fill the last byte with 1s
    put_bits(words, pos, (1u << pad) - 1u, pad);
  }
}

__device__ __forceinline__ unsigned stream_byte(const unsigned* words, long long k) {
  return (words[k >> 2] >> (24 - 8 * (int)(k & 3))) & 0xFFu;
}

__global__ void stuff_count_kernel(const unsigned* __restrict__ words, const long long* __restrict__ ends,
                                   int* __restrict__ ffs, int nblocks, int chunks) {
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= chunks) return;
  const long long nbytes = (ends[nblocks - 1] + 7) >> 3;
  const long long k0 = (long long)ci * kStuffChunk, k1 = min(k0 + kStuffChunk, nbytes);
  int count = 0;
  for (long long k = k0; k < k1; ++k) count += stream_byte(words, k) == 0xFFu;
  ffs[ci] = count;
}

__global__ void stuff_scatter_kernel(const unsigned* __restrict__ words, const long long* __restrict__ ends,
                                     const long long* __restrict__ ff_ends, uint8_t* __restrict__ out,
                                     long long* __restrict__ length, int nblocks, int chunks) {
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= chunks) return;
  const long long nbytes = (ends[nblocks - 1] + 7) >> 3;
  if (ci == 0) *length = nbytes + ff_ends[chunks - 1];
  const long long k0 = (long long)ci * kStuffChunk, k1 = min(k0 + kStuffChunk, nbytes);
  long long dst = k0 + (ci ? ff_ends[ci - 1] : 0);
  for (long long k = k0; k < k1; ++k) {
    const unsigned byte = stream_byte(words, k);
    out[dst++] = (uint8_t)byte;
    if (byte == 0xFFu) out[dst++] = 0;
  }
}

int blocks_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

}  // namespace

extern "C" int lb_jpeg_fdct_quant(const void* frames, const void* quant, void* out, int B, int H, int W, int fmt,
                                  void* stream) {
  const dim3 grid(((H + 15) / 16) * ((W + 15) / 16), B);
  fdct_quant_kernel<<<grid, 384, 0, (cudaStream_t)stream>>>((const uint8_t*)frames, (const int*)quant,
                                                            (int16_t*)out, H, W, fmt);
  return (int)cudaGetLastError();
}

extern "C" int lb_jpeg_coef_lerp(const void* a, const void* b, void* out, int64_t n, float t, void* stream) {
  const int grid = blocks_for(n, 256) < 132 * 16 ? blocks_for(n, 256) : 132 * 16;
  coef_lerp_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const int16_t*)a, (const int16_t*)b, (int16_t*)out,
                                                           (long long)n, t);
  return (int)cudaGetLastError();
}

extern "C" int lb_jpeg_huff_count(const void* coef, const void* tables, void* counts, int n, void* stream) {
  huff_count_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>((const int16_t*)coef,
                                                                          (const int2*)tables, (int*)counts, n);
  return (int)cudaGetLastError();
}

extern "C" int lb_jpeg_huff_write(const void* coef, const void* tables, const void* ends, void* words, int n,
                                  void* stream) {
  huff_write_kernel<<<blocks_for(n, 128), 128, 0, (cudaStream_t)stream>>>(
      (const int16_t*)coef, (const int2*)tables, (const long long*)ends, (unsigned*)words, n);
  return (int)cudaGetLastError();
}

extern "C" int lb_jpeg_stuff_count(const void* words, const void* ends, void* ffs, int n, int chunks, void* stream) {
  stuff_count_kernel<<<blocks_for(chunks, 256), 256, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const long long*)ends, (int*)ffs, n, chunks);
  return (int)cudaGetLastError();
}

extern "C" int lb_jpeg_stuff_scatter(const void* words, const void* ends, const void* ff_ends, void* out,
                                     void* length, int n, int chunks, void* stream) {
  stuff_scatter_kernel<<<blocks_for(chunks, 256), 256, 0, (cudaStream_t)stream>>>(
      (const unsigned*)words, (const long long*)ends, (const long long*)ff_ends, (uint8_t*)out, (long long*)length,
      n, chunks);
  return (int)cudaGetLastError();
}
