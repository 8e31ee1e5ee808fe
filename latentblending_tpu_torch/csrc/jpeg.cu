// J1-J3: baseline JPEG encoding on Hopper (sm_90a), the movie writer's
// encoder (latentblending_tpu_torch/video/jpeg.py).
//
// These kernels replace no Pallas kernel: they do on the card what the JAX
// package does on the host through libjpeg (latentblending_tpu/video/
// _jpeg_lerp.py:66 `encode_i420` and :107 `JpegPair.lerp`, both over
// native/jpeg_coef_lerp.cpp; mjpeg_mp4.py's cv2.imencode). Their output is
// libjpeg's, bit for bit:
//
//   J1 fdct_quant: a CTA codes a strip of kStripMcus 16x16 MCUs of one MCU
//      row of one frame (grid: strips x frames, so one launch codes a batch).
//      A thread owns one 8-sample row of one 8x8 block, a warp four blocks:
//      the strip's four Y blocks of an MCU a warp, then Cb Cr Cb Cr of two
//      MCUs a warp. A row comes in with one 8-byte load where it is aligned
//      and inside the frame (24 bytes from RGB); libjpeg's edge expansion (the
//      last row or column again; a chroma row past the downsampled height is
//      the last one again) only at the right and bottom edges. From RGB, each
//      pixel is converted once, by the thread of its Y row, with jccolor.c's
//      fixed-point rgb_ycc_convert; its Cb and Cr go to a shared tile of the
//      strip, from which the chroma rows take jcsample.c's h2v2_downsample
//      (bias 1, 2, 1, 2, ...). Then jfdctint.c's jpeg_fdct_islow: the row pass
//      in registers, an 8x8 transpose through a padded shared tile of the
//      warp (__syncwarp only), the column pass, all in 32-bit integers (every
//      intermediate stays below 2^29 for samples in [-128, 127]:
//      tests/test_torch_jpeg.py bounds each one). jcdctmgr.c's quantize,
//      (|x| + 4q) / 8q with the sign put back, is an exact multiply-high by a
//      per-position reciprocal ceil(2^32 / 8q) (exact for numerators below
//      2^16; |x| + 4q < 9300). Dummy Y blocks past the image's blocks get AC 0
//      and the DC of the nearest earlier real block of their MCU (jccoefct.c),
//      taken by a shuffle. The block is staged in zigzag order in shared
//      memory and written as 16-byte stores: int16 [B, nblocks, 64].
//   J2 coef_lerp: round half away from zero of fmaf(1-t, a, t*b) per
//      coefficient for F fractions a call: native/jpeg_coef_lerp.cpp:142-157
//      as g++ -O3 -march=native builds it (the two products contracted into
//      one FMA). Each thread reads 8 coefficients of a and of b once, in
//      16-byte vectors, and writes them for every fraction of the launch
//      (kLerpFracs a launch, the fractions passed by value). Output
//      [F, n, 64].
//   J3 huff_count, huff_scan, huff_plan | huff_write, stuff_count,
//      stuff_scan, stuff_scatter | copy_out: jchuff.c's encode_one_block
//      with the standard tables over F frames [F, n, 64] a call, each frame
//      coded as libjpeg codes it alone (its DC prediction restarts, its last
//      byte is padded with 1-bits by flush_bits, its 0xFF bytes are stuffed
//      with a 0x00 within it; no restart markers). One warp codes one 8x8
//      block: lane l holds zigzag coefficients 2l and 2l+1, two ballots give
//      the nonzero mask, each nonzero coefficient's run comes from the
//      highest set bit below it (__clzll), runs over 15 emit ZRLs, an EOB
//      only when zeros trail. The count pass sums the lanes' bits per block;
//      one CTA a frame scans them into frame-local bit offsets (int64: a
//      1024x1024 batch of 60 frames passes 2^31 bits), and one CTA scans the
//      frames into the plan: each frame's bytes, its word region (16-byte
//      aligned) and its stuffing tiles. The host reads the plan once and
//      sizes the buffers from it, so a call's memory follows the bytes it
//      codes. The write pass puts each lane's symbols into the block's words
//      staged in shared memory at the lane's offset (a warp-shuffle scan),
//      then stores the words, the two at the block's ends with atomicOr
//      (its neighbours share them). Stuffing works on tiles of 4096 bytes
//      within a frame, 16 bytes a thread: the tiles' 0xFF counts, one CTA's
//      scan of them (which also gives each frame's offset in the packed
//      output), then every byte scattered to its place. Last, the card
//      copies exactly the packed bytes and the offsets into pinned host
//      memory, the length read on the card: one host read of the plan, one
//      wait for the copy.
//
// What bounds them on the H100: at 512x512 J1 reads 0.39 MB of I420 (0.79 MB
// of RGB) and writes 0.79 MB of coefficients a frame, and does libjpeg's 8.2 M
// integer operations (14.3 M from RGB), which take longer on the INT32 units
// than the bytes take on the memory: its bound is operations, and it needs
// many frames a launch to come near it, so the movie writer codes a fetch
// chunk's keyframes, or a pixel gap's frames, a call. J2 reads 1.6 MB and
// writes 0.79 MB a fraction; J3 reads 0.79 MB a frame and writes ~0.1-0.4 MB
// of scan. A frame's work is microseconds of memory time: one J3 call costs
// eight launches, a scan of its blocks on one CTA a frame and two waits of
// the host, so J3 is bound by latency unless a call codes many frames, which
// is why the movie writer codes a whole gap a call.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------- J1

constexpr int kStripMcus = 8;                      // MCUs a CTA of J1 codes, in one MCU row
constexpr int kFdctWarps = kStripMcus * 3 / 2;     // a Y warp an MCU, a chroma warp two MCUs
constexpr int kTileStride = kStripMcus * 16 + 16;  // bytes a row of the RGB route's Cb/Cr tile takes (padded)
constexpr int kChromaTable = 72;                   // the chroma entries' offset in the shared table (padded)

// libjpeg's rgb_ycc_convert (FIX(x) = round(x * 2^16); CBCR_OFFSET + ONE_HALF - 1 on Cb and Cr)
__device__ __forceinline__ int ycc_y(int r, int g, int b) { return (19595 * r + 38470 * g + 7471 * b + 32768) >> 16; }
__device__ __forceinline__ int ycc_cb(int r, int g, int b) {
  return (-11059 * r - 21709 * g + 32768 * b + (128 << 16) + 32767) >> 16;
}
__device__ __forceinline__ int ycc_cr(int r, int g, int b) {
  return (32768 * r - 27439 * g - 5329 * b + (128 << 16) + 32767) >> 16;
}

__device__ __forceinline__ int byte_of(unsigned w, int i) { return (w >> (8 * i)) & 0xFF; }

// the 8 samples of a row from x0 on (a plane of width W): one 8-byte load
// where it is aligned and inside the row, else each sample with the last
// column again past the edge
__device__ __forceinline__ void load_row(const uint8_t* __restrict__ row, int x0, int W, int (&s)[8]) {
  if (x0 + 8 <= W && ((uintptr_t)(row + x0) & 7) == 0) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + x0);
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = byte_of(k < 4 ? v.x : v.y, k & 3);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = row[min(x0 + k, W - 1)];
  }
}

// 8 RGB pixels of a row from x0 on, converted: Y into s, Cb and Cr packed
// into 8 bytes each
__device__ __forceinline__ void load_rgb_row(const uint8_t* __restrict__ row, int x0, int W, int (&s)[8],
                                             uint2* cb, uint2* cr) {
  int px[24];
  if (x0 + 8 <= W && ((uintptr_t)(row + 3 * x0) & 7) == 0) {
    const uint2* v = reinterpret_cast<const uint2*>(row + 3 * x0);
    const uint2 a = v[0], b = v[1], c = v[2];
    const unsigned w[6] = {a.x, a.y, b.x, b.y, c.x, c.y};
#pragma unroll
    for (int i = 0; i < 24; ++i) px[i] = byte_of(w[i >> 2], i & 3);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint8_t* p = row + 3 * min(x0 + k, W - 1);
      px[3 * k] = p[0];
      px[3 * k + 1] = p[1];
      px[3 * k + 2] = p[2];
    }
  }
  unsigned b0[2] = {0, 0}, r0[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int r = px[3 * k], g = px[3 * k + 1], b = px[3 * k + 2];
    s[k] = ycc_y(r, g, b);
    b0[k >> 2] |= (unsigned)ycc_cb(r, g, b) << (8 * (k & 3));
    r0[k >> 2] |= (unsigned)ycc_cr(r, g, b) << (8 * (k & 3));
  }
  *cb = make_uint2(b0[0], b0[1]);
  *cr = make_uint2(r0[0], r0[1]);
}

__device__ __forceinline__ int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

// one pass of jpeg_fdct_islow over d[0..7] in registers, 32-bit throughout
template <bool kFirst>
__device__ __forceinline__ void fdct8(int (&d)[8]) {
  constexpr int kConst = 13, kPass1 = 2;
  constexpr int kOdd = kFirst ? kConst - kPass1 : kConst + kPass1;
  const int tmp0 = d[0] + d[7], tmp7 = d[0] - d[7];
  const int tmp1 = d[1] + d[6], tmp6 = d[1] - d[6];
  const int tmp2 = d[2] + d[5], tmp5 = d[2] - d[5];
  const int tmp3 = d[3] + d[4], tmp4 = d[3] - d[4];
  const int tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const int tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  d[0] = kFirst ? (tmp10 + tmp11) * (1 << kPass1) : descale(tmp10 + tmp11, kPass1);
  d[4] = kFirst ? (tmp10 - tmp11) * (1 << kPass1) : descale(tmp10 - tmp11, kPass1);
  const int z1 = (tmp12 + tmp13) * 4433;
  d[2] = descale(z1 + tmp13 * 6270, kOdd);
  d[6] = descale(z1 + tmp12 * -15137, kOdd);
  const int z5 = (tmp4 + tmp5 + tmp6 + tmp7) * 9633;
  const int o1 = (tmp4 + tmp7) * -7373, o2 = (tmp5 + tmp6) * -20995;
  const int o3 = (tmp4 + tmp6) * -16069 + z5, o4 = (tmp5 + tmp7) * -3196 + z5;
  d[7] = descale(tmp4 * 2446 + o1 + o3, kOdd);
  d[5] = descale(tmp5 * 16819 + o2 + o4, kOdd);
  d[3] = descale(tmp6 * 25172 + o2 + o3, kOdd);
  d[1] = descale(tmp7 * 12299 + o1 + o4, kOdd);
}

// table: per component (luma, chroma) and natural position, {ceil(2^32 / 8q),
// 4q | zigzag position << 16} (video/jpeg.py _fdct_table)
__global__ void __launch_bounds__(kFdctWarps * 32) fdct_quant_kernel(const uint8_t* __restrict__ frames,
                                                                     const uint2* __restrict__ table,
                                                                     int16_t* __restrict__ out, int H, int W,
                                                                     int rgb) {
  __shared__ uint2 tbl[kChromaTable + 64];
  __shared__ __align__(16) uint8_t tile[2][16][kTileStride];  // the strip's Cb and Cr (RGB route)
  __shared__ int tr[kFdctWarps][4][8][9];                       // each warp's four blocks, transposed
  __shared__ __align__(16) int16_t stage[kFdctWarps][4][64];    // each warp's four blocks, zigzag order
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, b = lane >> 3, r = lane & 7;
  const int mx = (W + 15) >> 4, strips = (mx + kStripMcus - 1) / kStripMcus;
  const int mr = blockIdx.x / strips, m0 = (blockIdx.x % strips) * kStripMcus;
  const bool luma = warp < kStripMcus;
  const int lm = luma ? warp : (warp - kStripMcus) * 2 + (b >> 1);  // the MCU in the strip
  const int mc = m0 + lm, mcl = min(mc, mx - 1);                    // loads past the last MCU stay inside
  const int blk = luma ? b : 4 + (b & 1);                            // Y00 Y01 Y10 Y11 Cb Cr
  const uint8_t* f = frames + (size_t)blockIdx.y * (rgb ? (size_t)3 * H * W : (size_t)H * W * 3 / 2);
  for (int i = threadIdx.x; i < 128; i += blockDim.x) tbl[(i >> 6) * kChromaTable + (i & 63)] = table[i];

  int s[8];
  if (luma) {
    const int y = min(mr * 16 + (b >> 1) * 8 + r, H - 1), x0 = mcl * 16 + (b & 1) * 8;
    if (rgb) {
      uint2 cb, cr;
      load_rgb_row(f + (size_t)3 * y * W, x0, W, s, &cb, &cr);
      const int ty = (b >> 1) * 8 + r, tx = lm * 16 + (b & 1) * 8;
      *reinterpret_cast<uint2*>(&tile[0][ty][tx]) = cb;
      *reinterpret_cast<uint2*>(&tile[1][ty][tx]) = cr;
    } else {
      load_row(f + (size_t)y * W, x0, W, s);
    }
  }
  __syncthreads();  // the table, and the RGB route's tile
  if (!luma) {
    const int comp = blk - 4;
    if (rgb) {
      // chroma row cy of the MCU row from pixel rows 2cy and 2cy + 1 of the strip
      const int cy = min(mr * 8 + r, (H + 1) / 2 - 1) - mr * 8;
      const uint4 a = *reinterpret_cast<const uint4*>(&tile[comp][2 * cy][lm * 16]);
      const uint4 c = *reinterpret_cast<const uint4*>(&tile[comp][2 * cy + 1][lm * 16]);
      const unsigned wa[4] = {a.x, a.y, a.z, a.w}, wc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[j] = (byte_of(wa[j >> 1], 2 * (j & 1)) + byte_of(wa[j >> 1], 2 * (j & 1) + 1) +
                byte_of(wc[j >> 1], 2 * (j & 1)) + byte_of(wc[j >> 1], 2 * (j & 1) + 1) + 1 + (j & 1)) >> 2;
    } else {
      const int ch = H / 2, cw = W / 2;
      const uint8_t* plane = f + (size_t)H * W + (size_t)comp * ch * cw;
      load_row(plane + (size_t)min(mr * 8 + r, ch - 1) * cw, mcl * 8, cw, s);
    }
  }

#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] -= 128;
  fdct8<true>(s);
#pragma unroll
  for (int k = 0; k < 8; ++k) tr[warp][b][r][k] = s[k];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = tr[warp][b][k][r];  // column r of the block
  fdct8<false>(s);

  // s[u] is coefficient (u, r), natural position 8u + r
  const uint2* q = tbl + (luma ? 0 : kChromaTable) + r;
  int v[8], zz[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const uint2 e = q[8 * u];
    const int mag = (int)__umulhi((unsigned)abs(s[u]) + (e.y & 0xFFFFu), e.x);
    v[u] = s[u] < 0 ? -mag : mag;
    zz[u] = (int)(e.y >> 16);
  }
  if (luma) {
    // a dummy block takes the DC of the nearest earlier real block of its MCU
    const int hb = (H + 7) >> 3, wb = (W + 7) >> 3;
    int src = b;
    while (src > 0 && (mr * 2 + (src >> 1) >= hb || mc * 2 + (src & 1) >= wb)) --src;
    const int dc = __shfl_sync(0xFFFFFFFFu, v[0], src * 8);  // lane 8 src holds block src's column 0
    if (src != b) {
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = 0;
      if (r == 0) v[0] = dc;
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) stage[warp][b][zz[u]] = (int16_t)v[u];
  __syncwarp();
  if (mc < mx) {
    // a Y warp's four blocks are contiguous in the output; a chroma warp's
    // are two runs of two (Cb Cr of each MCU), lanes 0-15 and 16-31
    const size_t nblocks = (size_t)((H + 15) >> 4) * mx * 6;
    const size_t first = (size_t)blockIdx.y * nblocks + ((size_t)mr * mx + mc) * 6 + (luma ? 0 : 4);
    reinterpret_cast<uint4*>(out + first * 64)[luma ? lane : lane & 15] =
        reinterpret_cast<const uint4*>(stage[warp])[lane];
  }
}

// ---------------------------------------------------------------- J2

constexpr int kLerpFracs = 32;  // fractions a launch takes by value (lb_jpeg_coef_lerp launches as many as F needs)

struct Fracs {
  float t[kLerpFracs];
};

// round half away from zero of fmaf(1-t, a, t*b); the cast truncates toward zero, as (JCOEF) does
__device__ __forceinline__ int lerp_round(float wi, float t, float a, float b) {
  const float v = __fmaf_rn(wi, a, __fmul_rn(t, b));
  return (int)(v >= 0.0f ? __fadd_rn(v, 0.5f) : __fsub_rn(v, 0.5f));
}

__device__ __forceinline__ int lerp_pair(float wi, float t, int a, int b) {
  const int lo = lerp_round(wi, t, (float)(int16_t)(a & 0xFFFF), (float)(int16_t)(b & 0xFFFF));
  const int hi = lerp_round(wi, t, (float)(a >> 16), (float)(b >> 16));
  return (int)(((unsigned)lo & 0xFFFFu) | ((unsigned)hi << 16));
}

// out[f, i] for the launch's F fractions: a and b read once, in 16-byte vectors of
// 8 coefficients (n % 8 == 0 and 16-byte aligned pointers, which video/jpeg.py
// checks); the fraction loop is unrolled so that every fraction is read from the
// parameter space at a fixed offset
__global__ void __launch_bounds__(256) coef_lerp_kernel(const int4* __restrict__ a, const int4* __restrict__ b,
                                                        int4* __restrict__ out, long long items, int F, Fracs fr) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < items; i += stride) {
    const int4 va = a[i], vb = b[i];
#pragma unroll
    for (int f = 0; f < kLerpFracs; ++f) {
      if (f >= F) break;
      const float t = fr.t[f], wi = __fsub_rn(1.0f, t);
      out[f * items + i] = make_int4(lerp_pair(wi, t, va.x, vb.x), lerp_pair(wi, t, va.y, vb.y),
                                     lerp_pair(wi, t, va.z, vb.z), lerp_pair(wi, t, va.w, vb.w));
    }
  }
}

// ---------------------------------------------------------------- J3

constexpr int kCoderWarps = 8;    // 8x8 blocks a CTA of the coder codes at once, one a warp
constexpr int kStageWords = 72;   // one block's bits staged in shared memory: < 2064 + 31 + 7 bits
constexpr int kTileBytes = 4096;  // a frame's bytes a CTA of the stuffing passes takes (video/jpeg.py _TILE_BYTES)
constexpr int kTileThreads = kTileBytes / 16;
constexpr int kScanThreads = 1024;

// the plan of a call, int64 [3, F+1] (video/jpeg.py reads it): each row the
// frames' exclusive prefix, its total last. Row 0: scan bytes (the last byte
// padded); row 1: 32-bit words, each frame's region rounded up to 16 bytes;
// row 2: stuffing tiles of kTileBytes.
enum { kPlanBytes = 0, kPlanWords = 1, kPlanTiles = 2 };

__device__ __forceinline__ int nbits_of(int x) { return x ? 32 - __clz(x) : 0; }

// bit i of x to bit 2i
__device__ __forceinline__ unsigned long long spread_bits(unsigned x) {
  unsigned long long v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  return (v | (v << 1)) & 0x5555555555555555ull;
}

// the previous block of the same component in a frame's scan order, or -1;
// j is frame-local, so a frame's first blocks predict their DC from 0
__device__ __forceinline__ int prev_block(int j) {
  const int p = j % 6;
  if (p > 0 && p < 4) return j - 1;
  if (p == 0) return j >= 6 ? j - 3 : -1;
  return j >= 6 ? j - 6 : -1;
}

// exclusive prefix of v over the CTA (blockDim.x a multiple of 32); *total
// gets the CTA's sum. Every thread of the CTA must call it.
__device__ long long cta_exclusive_scan(long long v, long long* total) {
  __shared__ long long sums[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long s = lane < warps ? sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xFFFFFFFFu, s, d);
      if (lane >= d) s += y;
    }
    sums[lane] = s;
  }
  __syncthreads();
  const long long out = (warp ? sums[warp - 1] : 0) + x - v;
  *total = sums[warps - 1];
  __syncthreads();  // sums is reused by the next call
  return out;
}

// One lane's part of a block: lane l holds zigzag coefficients 2l and 2l+1
// and writes, in stream order, the DC difference (lane 0), then for each of
// its nonzero AC coefficients the ZRL symbols of its run and its run/size
// symbol with the value bits, then the EOB (lane 31, when zeros trail).
// Codes and value bits are packed (code << value bits | value), at most 32 bits.
struct LaneCode {
  unsigned dc, c0, c1, eob;
  int dc_n, c0_n, c1_n, eob_n;
  int z0, z1;  // ZRL symbols before coefficient 2l and 2l+1
  int bits;    // all of this lane's bits
};

__device__ __forceinline__ void symbol(const unsigned* tbl, int index_base, int v, unsigned* code, int* n) {
  const int nb = nbits_of(abs(v));
  const unsigned e = tbl[index_base + nb];  // (size << 16) | code
  *code = ((e & 0xFFFFu) << nb) | ((unsigned)(v < 0 ? v - 1 : v) & ((1u << nb) - 1u));
  *n = (int)(e >> 16) + nb;
}

// Every lane of the warp calls it (ballots). tbl: packed DC luma, AC luma,
// DC chroma, AC chroma (256 each) in shared memory.
__device__ __forceinline__ LaneCode lane_code(const int16_t* __restrict__ coef, long long block, int j,
                                              const unsigned* tbl, int lane, unsigned* zrl, int* zrl_n) {
  const unsigned pair = reinterpret_cast<const unsigned*>(coef + block * 64)[lane];
  const int v0 = (int16_t)(pair & 0xFFFFu), v1 = (int16_t)(pair >> 16);
  const unsigned* dc = tbl + (j % 6 < 4 ? 0 : 512);
  const unsigned* ac = dc + 256;
  // bit k: coefficient k != 0, for k >= 1
  const unsigned long long nz = (spread_bits(__ballot_sync(0xFFFFFFFFu, v0 != 0)) |
                                 (spread_bits(__ballot_sync(0xFFFFFFFFu, v1 != 0)) << 1)) & ~1ull;
  *zrl = ac[0xF0] & 0xFFFFu;
  *zrl_n = (int)(ac[0xF0] >> 16);
  LaneCode c = {};
  if (lane == 0) {
    const int pj = prev_block(j);
    const int pred = pj >= 0 ? coef[(block - j + pj) * 64] : 0;
    symbol(dc, 0, v0 - pred, &c.dc, &c.dc_n);
  }
  const int k0 = 2 * lane, k1 = k0 + 1;
  if (lane > 0 && v0 != 0) {
    const unsigned long long below = nz & ((1ull << k0) - 1);
    const int run = k0 - (below ? 63 - __clzll(below) : 0) - 1;
    c.z0 = run >> 4;
    symbol(ac, (run & 15) << 4, v0, &c.c0, &c.c0_n);
  }
  if (v1 != 0) {
    const unsigned long long below = nz & ((1ull << k1) - 1);
    const int run = k1 - (below ? 63 - __clzll(below) : 0) - 1;
    c.z1 = run >> 4;
    symbol(ac, (run & 15) << 4, v1, &c.c1, &c.c1_n);
  }
  if (lane == 31 && !(nz >> 63)) {
    c.eob = ac[0] & 0xFFFFu;
    c.eob_n = (int)(ac[0] >> 16);
  }
  c.bits = c.dc_n + (c.z0 + c.z1) * *zrl_n + c.c0_n + c.c1_n + c.eob_n;
  return c;
}

__device__ __forceinline__ void load_tables(const unsigned* __restrict__ g, unsigned* sh) {
  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x) sh[i] = g[i];
  __syncthreads();
}

// bits[b]: the bits of block b (one warp a block, the CTAs persistent)
__global__ void __launch_bounds__(kCoderWarps * 32) huff_count_kernel(const int16_t* __restrict__ coef,
                                                                      const unsigned* __restrict__ tables,
                                                                      int* __restrict__ bits, long long blocks, int n) {
  __shared__ unsigned tbl[4 * 256];
  load_tables(tables, tbl);
  const int lane = threadIdx.x & 31;
  for (long long b = (long long)blockIdx.x * kCoderWarps + (threadIdx.x >> 5); b < blocks;
       b += (long long)gridDim.x * kCoderWarps) {
    unsigned zrl;
    int zrl_n;
    const LaneCode c = lane_code(coef, b, (int)(b % n), tbl, lane, &zrl, &zrl_n);
    const int total = __reduce_add_sync(0xFFFFFFFFu, c.bits);
    if (lane == 0) bits[b] = total;
  }
}

// one CTA a frame: off[b], each block's first bit counted from its frame's
// first bit; frame_bits[f], the frame's bits
__global__ void __launch_bounds__(kScanThreads) huff_scan_kernel(const int* __restrict__ bits,
                                                                 long long* __restrict__ off,
                                                                 long long* __restrict__ frame_bits, int n) {
  const long long base = (long long)blockIdx.x * n;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int j0 = min((int)threadIdx.x * per, n), j1 = min(j0 + per, n);
  long long s = 0;
  for (int j = j0; j < j1; ++j) s += bits[base + j];
  long long total;
  long long run = cta_exclusive_scan(s, &total);
  for (int j = j0; j < j1; ++j) {
    off[base + j] = run;
    run += bits[base + j];
  }
  if (threadIdx.x == 0) frame_bits[blockIdx.x] = total;
}

// one CTA: the plan (kPlan* rows) from the frames' bits
__global__ void __launch_bounds__(kScanThreads) huff_plan_kernel(const long long* __restrict__ frame_bits,
                                                                 long long* __restrict__ plan, int F) {
  long long carry[3] = {0, 0, 0};
  for (int base = 0; base < F; base += blockDim.x) {
    const int f = base + threadIdx.x;
    long long v[3] = {0, 0, 0};
    if (f < F) {
      v[0] = (frame_bits[f] + 7) >> 3;
      v[1] = ((v[0] + 15) >> 4) << 2;
      v[2] = (v[0] + kTileBytes - 1) / kTileBytes;
    }
    for (int r = 0; r < 3; ++r) {
      long long total;
      const long long ex = cta_exclusive_scan(v[r], &total);
      if (f < F) plan[r * (F + 1) + f] = carry[r] + ex;
      carry[r] += total;
    }
  }
  if (threadIdx.x == 0)
    for (int r = 0; r < 3; ++r) plan[r * (F + 1) + F] = carry[r];
}

// ORs `size` (<= 32) bits of `code` into the big-endian staged words at bit `pos`
__device__ __forceinline__ void stage_put(unsigned* st, int pos, unsigned code, int size) {
  if (size == 0) return;
  const int w = pos >> 5, room = 32 - (pos & 31);
  if (size <= room) {
    atomicOr(st + w, code << (room - size));
  } else {
    atomicOr(st + w, code >> (size - room));
    atomicOr(st + w + 1, code << (32 - (size - room)));
  }
}

// Each block's bits at its place in its frame's word region: the warp's lanes
// put their symbols into the block's staged words (a warp-shuffle scan gives
// each lane's first bit); then the warp stores the words, the first and the
// last with atomicOr (neighbouring blocks share them), the rest plainly. The
// frame's last block pads the last byte with 1-bits (flush_bits).
__global__ void __launch_bounds__(kCoderWarps * 32) huff_write_kernel(const int16_t* __restrict__ coef,
                                                                      const unsigned* __restrict__ tables,
                                                                      const long long* __restrict__ off,
                                                                      const long long* __restrict__ plan,
                                                                      unsigned* __restrict__ words, long long blocks,
                                                                      int n, int F) {
  __shared__ unsigned tbl[4 * 256];
  __shared__ unsigned stage[kCoderWarps][kStageWords];
  load_tables(tables, tbl);
  const int lane = threadIdx.x & 31;
  unsigned* st = stage[threadIdx.x >> 5];
  for (long long b = (long long)blockIdx.x * kCoderWarps + (threadIdx.x >> 5); b < blocks;
       b += (long long)gridDim.x * kCoderWarps) {
    const long long f = b / n;
    const int j = (int)(b - f * n);
    unsigned zrl;
    int zrl_n;
    const LaneCode c = lane_code(coef, b, j, tbl, lane, &zrl, &zrl_n);
    int incl = c.bits;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    const long long local = off[b];
    const int pad = j == n - 1 ? (int)((8 - ((local + total) & 7)) & 7) : 0;
    const long long g = 32LL * plan[kPlanWords * (F + 1) + f] + local;
    const int sh = (int)(g & 31);
    for (int i = lane; i < kStageWords; i += 32) st[i] = 0;
    __syncwarp();
    int pos = sh + incl - c.bits;
    stage_put(st, pos, c.dc, c.dc_n);
    pos += c.dc_n;
    for (int z = 0; z < c.z0; ++z, pos += zrl_n) stage_put(st, pos, zrl, zrl_n);
    stage_put(st, pos, c.c0, c.c0_n);
    pos += c.c0_n;
    for (int z = 0; z < c.z1; ++z, pos += zrl_n) stage_put(st, pos, zrl, zrl_n);
    stage_put(st, pos, c.c1, c.c1_n);
    pos += c.c1_n;
    stage_put(st, pos, c.eob, c.eob_n);
    pos += c.eob_n;
    if (lane == 31) stage_put(st, pos, (1u << pad) - 1u, pad);
    __syncwarp();
    const int nw = (sh + total + pad + 31) >> 5;
    unsigned* gw = words + (g >> 5);
    for (int i = lane; i < nw; i += 32) {
      if (i == 0 || i == nw - 1)
        atomicOr(gw + i, st[i]);
      else
        gw[i] = st[i];
    }
    __syncwarp();  // the stage is cleared for the next block
  }
}

__device__ __forceinline__ int ff_bytes(unsigned w) { return __popc(__vcmpeq4(w, 0xFFFFFFFFu)) >> 3; }

// the frame of stuffing tile t: the last f with plan[tiles][f] <= t
__device__ __forceinline__ int frame_of_tile(const long long* __restrict__ tiles, int F, long long t) {
  int lo = 0, hi = F;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tiles[mid] <= t) lo = mid; else hi = mid;
  }
  return lo;
}

// Where thread threadIdx.x of stuffing tile blockIdx.x reads: its frame f,
// the frame-local byte k of its 16 bytes and the frame's bytes u; v holds the
// bytes (zeros past u, which are never 0xFF).
struct TileSpan {
  int f;
  long long k, u;
  uint4 v;
};

__device__ __forceinline__ TileSpan tile_span(const unsigned* __restrict__ words, const long long* __restrict__ plan,
                                              int F) {
  __shared__ int frame;
  if (threadIdx.x == 0) frame = frame_of_tile(plan + kPlanTiles * (F + 1), F, blockIdx.x);
  __syncthreads();
  TileSpan s;
  s.f = frame;
  s.u = plan[s.f + 1] - plan[s.f];
  s.k = (blockIdx.x - plan[kPlanTiles * (F + 1) + s.f]) * kTileBytes + 16LL * threadIdx.x;
  s.v = make_uint4(0, 0, 0, 0);
  if (s.k < s.u) s.v = *reinterpret_cast<const uint4*>(words + plan[kPlanWords * (F + 1) + s.f] + (s.k >> 2));
  return s;
}

// tile_ff[t]: the 0xFF bytes of stuffing tile t (tiles never cross frames)
__global__ void __launch_bounds__(kTileThreads) stuff_count_kernel(const unsigned* __restrict__ words,
                                                                   const long long* __restrict__ plan,
                                                                   int* __restrict__ tile_ff, int F) {
  const TileSpan s = tile_span(words, plan, F);
  long long total;
  cta_exclusive_scan(ff_bytes(s.v.x) + ff_bytes(s.v.y) + ff_bytes(s.v.z) + ff_bytes(s.v.w), &total);
  if (threadIdx.x == 0) tile_ff[blockIdx.x] = (int)total;
}

// one CTA: tile_pre[t], the 0xFF bytes before tile t; stuffed[f], frame f's
// first byte in the stuffed output, stuffed[F] its length
__global__ void __launch_bounds__(kScanThreads) stuff_scan_kernel(const int* __restrict__ tile_ff,
                                                                  const long long* __restrict__ plan,
                                                                  long long* __restrict__ tile_pre,
                                                                  long long* __restrict__ stuffed, int F, int tiles) {
  long long carry = 0;
  for (int base = 0; base < tiles; base += blockDim.x) {
    const int t = base + threadIdx.x;
    long long total;
    const long long ex = cta_exclusive_scan(t < tiles ? tile_ff[t] : 0, &total);
    if (t < tiles) tile_pre[t] = carry + ex;
    carry += total;
  }
  __syncthreads();
  for (int f = threadIdx.x; f <= F; f += blockDim.x) {
    const long long t = plan[kPlanTiles * (F + 1) + f];
    stuffed[f] = plan[f] + (t < tiles ? tile_pre[t] : carry);
  }
}

// every byte of every frame to its place in the packed output, a 0x00 after
// each 0xFF (a CTA scan of the threads' 0xFF counts gives each thread's shift)
__global__ void __launch_bounds__(kTileThreads) stuff_scatter_kernel(const unsigned* __restrict__ words,
                                                                     const long long* __restrict__ plan,
                                                                     const long long* __restrict__ tile_pre,
                                                                     uint8_t* __restrict__ out, int F) {
  const TileSpan s = tile_span(words, plan, F);
  long long total;
  const long long ex = cta_exclusive_scan(ff_bytes(s.v.x) + ff_bytes(s.v.y) + ff_bytes(s.v.z) + ff_bytes(s.v.w), &total);
  if (s.k >= s.u) return;
  long long dst = plan[s.f] + tile_pre[blockIdx.x] + s.k + ex;
  const unsigned w[4] = {s.v.x, s.v.y, s.v.z, s.v.w};
  const int nb = (int)min(16LL, s.u - s.k);
  for (int i = 0; i < nb; ++i) {
    const unsigned byte = (w[i >> 2] >> (24 - 8 * (i & 3))) & 0xFFu;
    out[dst++] = (uint8_t)byte;
    if (byte == 0xFFu) out[dst++] = 0;
  }
}

// the stuffed bytes (their length stuffed[F] read on the card) and the
// offsets into host memory the card can write (pinned), 16 bytes at a time
__global__ void __launch_bounds__(256) copy_out_kernel(const uint8_t* __restrict__ src,
                                                       const long long* __restrict__ stuffed, int F,
                                                       uint8_t* __restrict__ dst, long long* __restrict__ dst_off) {
  const long long total = stuffed[F], vecs = total >> 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = i0; i < vecs; i += stride) reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  for (long long i = (vecs << 4) + i0; i < total; i += stride) dst[i] = src[i];
  for (long long i = i0; i <= F; i += stride) dst_off[i] = stuffed[i];
}

int blocks_for(long long n, int threads) { return (int)((n + threads - 1) / threads); }

int coder_ctas(long long blocks) {
  const long long need = (blocks + kCoderWarps - 1) / kCoderWarps;
  return (int)(need < 132 * 16 ? need : 132 * 16);
}

}  // namespace

extern "C" int lb_jpeg_fdct_quant(const void* frames, const void* table, void* out, int B, int H, int W, int fmt,
                                  void* stream) {
  const int strips = ((W + 15) / 16 + kStripMcus - 1) / kStripMcus;
  const dim3 grid(((H + 15) / 16) * strips, B);
  fdct_quant_kernel<<<grid, kFdctWarps * 32, 0, (cudaStream_t)stream>>>((const uint8_t*)frames, (const uint2*)table,
                                                                        (int16_t*)out, H, W, fmt);
  return (int)cudaGetLastError();
}

// J2: out [F, n] = round((1 - ts[f]) * a + ts[f] * b); ts is host memory
// (F floats), passed to the kernels by value, kLerpFracs a launch; n % 8 == 0
// and a, b, out 16-byte aligned (video/jpeg.py coef_lerp_batch checks both)
extern "C" int lb_jpeg_coef_lerp(const void* a, const void* b, void* out, int64_t n, const float* ts, int F,
                                 void* stream) {
  const long long items = n / 8;
  const int grid = blocks_for(items, 256) < 132 * 16 ? blocks_for(items, 256) : 132 * 16;
  for (int f0 = 0; f0 < F; f0 += kLerpFracs) {
    Fracs fr;
    const int nf = F - f0 < kLerpFracs ? F - f0 : kLerpFracs;
    for (int i = 0; i < kLerpFracs; ++i) fr.t[i] = i < nf ? ts[f0 + i] : 0.0f;
    coef_lerp_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const int4*)a, (const int4*)b,
                                                             (int4*)out + f0 * items, items, nf, fr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

#define LB_LAUNCHED()                          \
  do {                                         \
    const cudaError_t e = cudaGetLastError();  \
    if (e != cudaSuccess) return (int)e;       \
  } while (0)

// J3, first half: the bits of every block of F frames of n blocks (coef
// [F, n, 64]), their frame-local offsets and the plan [3, F+1]
extern "C" int lb_jpeg_huff_count(const void* coef, const void* tables, void* bits, void* off, void* frame_bits,
                                  void* plan, int n, int F, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (long long)F * n;
  huff_count_kernel<<<coder_ctas(blocks), kCoderWarps * 32, 0, s>>>((const int16_t*)coef, (const unsigned*)tables,
                                                                    (int*)bits, blocks, n);
  LB_LAUNCHED();
  huff_scan_kernel<<<F, kScanThreads, 0, s>>>((const int*)bits, (long long*)off, (long long*)frame_bits, n);
  LB_LAUNCHED();
  huff_plan_kernel<<<1, kScanThreads, 0, s>>>((const long long*)frame_bits, (long long*)plan, F);
  LB_LAUNCHED();
  return 0;
}

// J3, second half, sized by the plan the host read: the words (words_n of
// them, zeroed here), the stuffing tiles' counts and prefixes, and the F
// stuffed scans packed into out with their offsets stuffed [F+1]
extern "C" int lb_jpeg_huff_code(const void* coef, const void* tables, const void* off, const void* plan,
                                 void* words, int64_t words_n, void* tile_ff, void* tile_pre, void* stuffed,
                                 void* out, int n, int F, int tiles, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long blocks = (long long)F * n;
  cudaError_t e = cudaMemsetAsync(words, 0, (size_t)words_n * 4, s);
  if (e != cudaSuccess) return (int)e;
  huff_write_kernel<<<coder_ctas(blocks), kCoderWarps * 32, 0, s>>>(
      (const int16_t*)coef, (const unsigned*)tables, (const long long*)off, (const long long*)plan, (unsigned*)words,
      blocks, n, F);
  LB_LAUNCHED();
  stuff_count_kernel<<<tiles, kTileThreads, 0, s>>>((const unsigned*)words, (const long long*)plan, (int*)tile_ff, F);
  LB_LAUNCHED();
  stuff_scan_kernel<<<1, kScanThreads, 0, s>>>((const int*)tile_ff, (const long long*)plan, (long long*)tile_pre,
                                               (long long*)stuffed, F, tiles);
  LB_LAUNCHED();
  stuff_scatter_kernel<<<tiles, kTileThreads, 0, s>>>((const unsigned*)words, (const long long*)plan,
                                                      (const long long*)tile_pre, (uint8_t*)out, F);
  LB_LAUNCHED();
  return 0;
}

// J3's read: the stuffed bytes (at most capacity) and their offsets copied by
// the card into pinned host memory, the length taken from stuffed[F] on the card
extern "C" int lb_jpeg_huff_copy(const void* out, const void* stuffed, int F, int64_t capacity, void* host_bytes,
                                 void* host_off, void* stream) {
  void* db = nullptr;
  void* doff = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&db, host_bytes, 0);
  if (e == cudaSuccess) e = cudaHostGetDevicePointer(&doff, host_off, 0);
  if (e != cudaSuccess) return (int)e;
  if (((uintptr_t)db | (uintptr_t)out) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const long long vecs = capacity / 16 + 1;
  const int grid = blocks_for(vecs, 256) < 264 ? blocks_for(vecs, 256) : 264;
  copy_out_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const uint8_t*)out, (const long long*)stuffed, F,
                                                          (uint8_t*)db, (long long*)doff);
  return (int)cudaGetLastError();
}
