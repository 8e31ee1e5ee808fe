// K3: non-causal, unmasked attention forward, softmax(Q K^T / sqrt(512)) V,
// one head of d = 512, f32 in and out, for Hopper (sm_90a).
//
// Replaces the Pallas TPU flash_attention call of
// latentblending_tpu/models/layers.py VAEAttention.__call__ (the VAE mid
// block, decoder and encoder) for a VAE that runs in f32;
// csrc/attention_d512_bf16.cu is the bf16 one. q, k, v and out are
// [B, L, 1, 512] row-major.
//
// What bounds it on the H100: arithmetic at f32 accuracy. At the main
// path's [4, 4096, 1, 512] it does 137 GFLOP on 134 MB. One TF32 pass
// keeps ~3 decimal digits, outside the 1e-4 relative bound against the
// plain f32 result, so both products run in 3xTF32 on TF32 wgmma, as K2 in
// f32 does (csrc/attention_d64_f32.cu): each operand x splits into hi = x
// truncated to TF32 (the raw f32 operand: the tensor core reads its top 19
// bits) and lo = x - hi (exact in f32), and each product is lo*hi + hi*lo
// + hi*hi into one f32 accumulator, per 8-wide k step, the two small cross
// terms first. Its bound is three TF32 products per f32 one over the
// 495 TFLOP/s TF32 peak, which only wgmma reaches.
//
// Design: a flash-attention forward on warpgroup MMA over a 4-CTA
// thread-block cluster that splits d. CTA r owns d columns
// [128r, 128r + 128): its partial scores over them, and its 128 columns
// of O. One CTA: a consumer warpgroup (64 query rows) and a producer
// warpgroup.
//   - Byte budget of one CTA (227 KB): Q lo 32 KB; two stages of a 32-key
//     K tile, raw (by TMA) and lo, 32 KB each; one stage of the V^T tile,
//     hi and lo, 32 KB; the exchange, 2 tile parities x 4 ranks x 8 KB =
//     64 KB; O's fold (below) 32 KB; 224 KB in all. The cluster is 4 CTAs
//     and the key tiles 32 keys because that is what fits: with 2 CTAs
//     (256 columns each) Q and one 64-key K stage alone are 256 KB, and
//     64-key tiles over 4 CTAs double every stage and the exchange.
//   - Q is loaded once by TMA in the 128-byte swizzle. The consumers read
//     their A fragments of the raw Q into registers (Q hi: 16 k steps x 4 =
//     64 registers) and write Q lo back in place, so Q lo is an A operand
//     in shared memory: lo*hi of S is wgmma m64n32k8 with both operands in
//     shared memory, hi*lo and hi*hi take A from registers.
//   - The producer warpgroup splits every operand once per tile: its thread
//     0 loads each K tile (this CTA's 128 columns of 32 keys) by TMA, and
//     its 128 threads write K lo beside the raw tile; each thread reads one
//     V column of the tile from global memory and writes it TRANSPOSED (V^T,
//     keys contiguous: TF32 wgmma has no transpose bit) as hi and lo, keys
//     in P's permuted order. K has a ring of two stages and V^T one, each
//     stage with a "ready" mbarrier (the producer's 128 threads, each after
//     a proxy fence) and an "empty" one (the 128 consumers: after S, after
//     P V). The producer splits K one tile ahead of V (K of tile j + 1 is
//     ready while V^T of tile j waits for P V of tile j - 1) and issues
//     K's loads two tiles ahead, as soon as S frees a stage.
//   - The partial scores (64 x 32 f32, 16 registers a thread) go into this
//     CTA's slot of the exchange (one slot a rank, double-buffered by tile
//     parity), and one thread copies the slot into the same place in the
//     3 peers by three bulk copies of the TMA engine, counted on each
//     peer's mbarrier as a TMA load is. Every CTA sums the four slots in
//     rank order, ((s0 + s1) + s2) + s3: all four hold the same bits, so
//     they compute the same P, row max and row sum, and scale their
//     columns of O alike.
//   - The online softmax runs on the accumulator registers (exp2 with
//     log2(e)/sqrt(d) folded in, row max by quad shuffles, the row sum
//     from the unsplit P); P is split in registers and is the A operand of
//     O += P V (wgmma m64n128k8, O 64 x 128: 64 registers a thread) in K2
//     f32's permuted k order.
//   - O is folded every kFold = 8 tiles: the accumulator is added by f32
//     FMAs (rounded to nearest) into its fold in shared memory, rescaled by
//     the product of the softmax rescales since the last fold, and
//     restarts from 0. The tensor core's adds into its accumulator drop
//     the low bits of each sum (~0.4 ulp an add on the H100: the error
//     grew with L, 3.9e-5 of max |O| at L = 4096 and 1.3e-4 at 16384 with
//     3 adds per 8 keys into one O); folded, an accumulator takes at most
//     96 adds.
//   - The next tile's S is issued before this tile's exchange wait, which
//     it hides; its partial is sent as soon as it completes, while P V
//     runs. The loop is unrolled by two with the last tile peeled, so no
//     wgmma group is issued under a run-time condition (ptxas serialises
//     every wgmma of a kernel where one is).
//   - 256 threads a CTA and one CTA an SM (shared memory): the register
//     file holds 255 a thread for both warpgroups, so no setmaxnreg.
// Each 64 query rows stream K and V from L2 once; [4, 4096] gives 256
// clusters, 1024 CTAs.
//
// Why the double-buffered exchange is safe: a CTA writes its slot of
// parity j & 1 (here, then by bulk copy into every peer) for tile j only
// after it has received every peer's tile j - 1. Each peer sent tile
// j - 1 after it had received and read all of tile j - 2 (the same
// parity), this CTA's copy included: so the peers' slots are read, and
// the copy out of this CTA's own slot has landed. For the same reason the
// bytes of tile j never reach a peer's barrier before that barrier's
// phase for tile j - 2 completed.
//
// Where it stands (PERF.md, K3 f32 findings): ~37% of the bound at
// [4, 4096], 1.45x the mma.sync kernel it replaced. What holds it there:
// S is 48 wgmma m64n32k8 a tile, each 16 clocks of work, and they run at
// a fraction of that rate whether A comes from registers or shared memory
// (all from shared memory measured no faster); a warpgroup's wgmma issue
// stalls once a few are queued, so the thread that issues S cannot run
// the softmax under it, and the tensor core idles through the softmax.
// The key tile cannot grow: shared memory is full. Measured and not kept
// (attention_variants): one st.async a float4 for the exchange (2.2x
// slower); S issued two tiles ahead in batches between the softmax's
// parts, with a remote "slot read" arrive to keep the two-slot exchange
// safe (1.6x slower with a cluster-scope release arrive; with a relaxed
// one, no faster); two accumulator chains for S (spilled, slower); one
// thread waiting on the exchange for all (slower).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_ptx.cuh"

namespace {

constexpr int kD = 512;
constexpr int kRanks = 4;                     // CTAs of a cluster, each owns kD / kRanks columns
constexpr int kAtoms = kD / kRanks / 32;      // 32-column (128-byte) atoms per CTA: 4
constexpr int kBQ = 64;                       // query rows per cluster
constexpr int kBK = 32;                       // keys per tile
constexpr int kKSteps = 4 * kAtoms;           // 8-column k steps of S per CTA: 16
constexpr int kConsumers = 128;               // one warpgroup
constexpr int kProducers = 128;               // one warpgroup
constexpr int kThreads = kConsumers + kProducers;
constexpr int kQAtomBytes = kBQ * 128;        // 64 rows x 32 f32
constexpr int kKAtomBytes = kBK * 128;        // 32 rows x 32 f32
constexpr int kKTileBytes = kAtoms * kKAtomBytes;   // a CTA's 128 columns of a K tile: 16 KB
constexpr int kVTileBytes = kAtoms * 32 * 128;      // V^T: 128 rows (columns of V) x 32 keys: 16 KB
constexpr int kXSlotBytes = 16 * kConsumers * 4;    // one CTA's partial scores: 8 KB
constexpr int kXBytes = (kRanks - 1) * kXSlotBytes; // received a tile: 24 KB
constexpr int kXParityBytes = kRanks * kXSlotBytes; // a tile's slots, one per rank: 32 KB
constexpr int kFold = 8;                            // key tiles between folds of O into shared memory

struct Smem {  // byte offsets from a 1024-byte aligned base
  static constexpr int kQ = 0;                                // raw, then lo in place
  static constexpr int kK = kQ + kAtoms * kQAtomBytes;        // [stage][raw | lo]
  static constexpr int kKlo = kKTileBytes;
  static constexpr int kKStage = 2 * kKTileBytes;
  static constexpr int kV = kK + 2 * kKStage;                 // [hi | lo], one stage
  static constexpr int kVlo = kVTileBytes;
  static constexpr int kX = kV + 2 * kVTileBytes;             // [tile parity][rank][i][thread] float4
  static constexpr int kO = kX + 2 * kXParityBytes;           // folded O: [i][thread] float4, 32 KB
  static constexpr int kBar = kO + 64 * kConsumers * 4;
  // q, kfull[2], kready[2], kempty[2], xfull[2], vready, vempty
  static constexpr int kNumBars = 1 + 4 * 2 + 2;
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

__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kThreads, 1)
attention_d512_f32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const float* __restrict__ v, float* __restrict__ out, int L, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // the same offset in every CTA, so map_shared_rank finds the peers' buffers
  uint8_t* smem = smem_raw + ((1024 - (lb::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + Smem::kBar);
  uint64_t* kfull = qbar + 1;
  uint64_t* kready = kfull + 2;
  uint64_t* kempty = kready + 2;
  uint64_t* xfull = kempty + 2;
  uint64_t* vready = xfull + 2;
  uint64_t* vempty = vready + 1;

  const uint32_t rank = lb::cluster_ctarank();
  const int tid = threadIdx.x;
  const int q0 = (blockIdx.x / kRanks) * kBQ;
  const int row0 = blockIdx.y * L;  // first row of this batch in the [B*L] sequence axis
  const int ntiles = L / kBK;       // even: L is a multiple of kBQ

  if (tid == 0) {
    lb::mbar_init(qbar, 1);
    for (int s = 0; s < 2; ++s) {
      lb::mbar_init(&kfull[s], 1);
      lb::mbar_init(&kready[s], kProducers);
      lb::mbar_init(&kempty[s], kConsumers);
      lb::mbar_init(&xfull[s], 1);  // the receiver's expect_tx; the peers' bytes complete it
    }
    lb::mbar_init(vready, kProducers);
    lb::mbar_init(vempty, kConsumers);
    lb::fence_mbar_init();
  }
  lb::cluster_sync();  // every CTA's barriers are initialised before any load or remote store

  if (tid >= kConsumers) {
    // ------------------------------------------------------------ producer
    const int p = tid - kConsumers;  // the V column (row of V^T) this thread transposes
    const float* vcol = v + (int64_t)row0 * kD + 128 * rank + p;
    if (p == 0) {
      lb::mbar_expect_tx(qbar, kAtoms * kQAtomBytes);
      for (int a = 0; a < kAtoms; ++a)
        lb::tma_load_3d(smem + Smem::kQ + a * kQAtomBytes, &tq, qbar, 0, kAtoms * rank + a, row0 + q0);
    }
    // K tile j into stage j & 1 by TMA (thread 0); the stage is free once
    // the consumers' S of tile j - 2, its last reader, completed (kempty)
    auto load_k = [&](int j) {
      const int s = j & 1;
      if (j >= 2) lb::mbar_wait(&kempty[s], ((j >> 1) - 1) & 1);
      lb::mbar_expect_tx(&kfull[s], kKTileBytes);  // kfull[s]: the TMA's bytes of K tile j
      for (int a = 0; a < kAtoms; ++a)
        lb::tma_load_3d(smem + Smem::kK + s * Smem::kKStage + a * kKAtomBytes, &tk, &kfull[s], 0,
                        kAtoms * rank + a, row0 + j * kBK);
    };
    // K lo beside the raw tile, which stays as hi (the tensor core
    // truncates it); elementwise, so the swizzled layout carries over
    auto split_k = [&](int j) {
      uint8_t* kst = smem + Smem::kK + (j & 1) * Smem::kKStage;
      lb::mbar_wait(&kfull[j & 1], (j >> 1) & 1);
#pragma unroll
      for (int i = 0; i < kKTileBytes / (16 * kProducers); ++i) {
        const int off = 16 * p + i * 16 * kProducers;
        const float4 x = *reinterpret_cast<const float4*>(kst + off);
        st_shared_v4(lb::smem_u32(kst + Smem::kKlo + off), tf32_lo(x.x, lb::tf32_trunc(x.x)),
                     tf32_lo(x.y, lb::tf32_trunc(x.y)), tf32_lo(x.z, lb::tf32_trunc(x.z)),
                     tf32_lo(x.w, lb::tf32_trunc(x.w)));
      }
      lb::fence_proxy_async();  // kready: each producer thread's stores, fenced for the async proxy
      lb::mbar_arrive(&kready[j & 1]);
    };
    // K runs one tile ahead of V (S of tile j + 1 is issued before P V of
    // tile j, and the one V^T stage frees only when P V of tile j - 1 is
    // done), and K's loads two tiles ahead: each is issued as soon as S
    // frees its stage
    if (p == 0) {
      load_k(0);
      load_k(1);
    }
    split_k(0);
#pragma unroll 1
    for (int j = 0; j < ntiles; ++j) {
      // this thread's V column of tile j, loaded while K lands
      float vr[kBK];
#pragma unroll
      for (int e = 0; e < kBK; ++e) vr[e] = __ldg(vcol + (int64_t)(j * kBK + e) * kD);
      if (j + 1 < ntiles) split_k(j + 1);
      if (p == 0 && j + 2 < ntiles) load_k(j + 2);
      // vempty: the consumers' P V of tile j - 1 completed
      if (j >= 1) lb::mbar_wait(vempty, (j - 1) & 1);
      // V^T, hi and lo: row p holds the tile's 32 keys in one 128-byte row,
      // swizzled as a TMA load would (16-byte chunk c of row p at chunk
      // c ^ (p % 8)), in P's k order within each 8-key step: chunk 2m holds
      // keys 8m + 0, 2, 4, 6, chunk 2m + 1 keys 8m + 1, 3, 5, 7
      const uint32_t vt = lb::smem_u32(smem + Smem::kV) + p * 128;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t addr = vt + ((c ^ (p & 7)) << 4);
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float val = vr[8 * (c >> 1) + (c & 1) + 2 * x];
          hi[x] = lb::tf32_trunc(val);
          lo[x] = tf32_lo(val, hi[x]);
        }
        st_shared_v4(addr, hi[0], hi[1], hi[2], hi[3]);
        st_shared_v4(addr + Smem::kVlo, lo[0], lo[1], lo[2], lo[3]);
      }
      lb::fence_proxy_async();
      lb::mbar_arrive(vready);
    }
  } else {
    // ------------------------------------------------------------ consumers
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;  // fragment row group
    const int t = lane & 3;   // thread in group

    // Q's A fragments (raw: hi), and Q lo written back in place: k step kk
    // holds (row g, column 8kk + t), (g + 8, 8kk + t), (g, 8kk + t + 4),
    // (g + 8, 8kk + t + 4) of this warp's 16 rows, each element in exactly
    // one thread; rows are 128-byte swizzled (row % 8 == g)
    uint32_t qh[kKSteps][4];
    lb::mbar_wait(qbar, 0);  // qbar: the TMA's bytes of Q
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = 16 * warp + g + 8 * (r & 1);
        const int chunk = 2 * (kk & 3) + (r >> 1);
        float* x = reinterpret_cast<float*>(smem + Smem::kQ + (kk >> 2) * kQAtomBytes + row * 128 +
                                            ((chunk ^ g) << 4) + 4 * t);
        qh[kk][r] = __float_as_uint(*x);
        *x = __uint_as_float(tf32_lo(*x, lb::tf32_trunc(*x)));
      }
    lb::fence_proxy_async();  // Q lo: read by wgmma, after every consumer wrote its part
    lb::bar_sync(1, kConsumers);

    // this CTA's slot (parity 0) here and in the three peers, and their barriers
    const uint32_t x_mine = lb::smem_u32(smem + Smem::kX + rank * kXSlotBytes);
    uint32_t x_peer[kRanks - 1], xbar_peer[kRanks - 1];
#pragma unroll
    for (int i = 0; i < kRanks - 1; ++i) {
      const uint32_t pr = i + (i >= (int)rank);
      x_peer[i] = lb::map_shared_rank(x_mine, pr);
      xbar_peer[i] = lb::map_shared_rank(lb::smem_u32(xfull), pr);
    }

    // O: the product's accumulator in registers, and the sum of its folds
    // in shared memory ([i][thread] float4, zero at first), which the
    // accumulator is added into every kFold tiles and then restarts from 0
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float4* ofold = reinterpret_cast<float4*>(smem + Smem::kO) + tid;
#pragma unroll
    for (int i = 0; i < 16; ++i) ofold[i * kConsumers] = make_float4(0.f, 0.f, 0.f, 0.f);
    float c[2] = {1.f, 1.f};              // the rescale of the folded O since its last fold
    float m[2] = {-INFINITY, -INFINITY};  // running row max, in log2 units
    float l[2] = {0.f, 0.f};              // this thread's part of the running row sum
    float sa[16], sb[16];                 // partial scores of two consecutive tiles
    const uint32_t q_addr = lb::smem_u32(smem + Smem::kQ);
    const uint32_t k_base = lb::smem_u32(smem + Smem::kK);
    const uint32_t v_addr = lb::smem_u32(smem + Smem::kV);

    // S_j partial = Q_r K_r^T over this CTA's 128 columns in 3xTF32, one
    // commit group: lo*hi (A = Q lo in shared memory), hi*lo, hi*hi
    auto issue_s = [&](int j, float (&acc)[16]) {
      const int s = j & 1;
      const uint32_t qa = lb::opaque(q_addr);
      const uint32_t ka = lb::opaque(k_base + s * Smem::kKStage);
      lb::mbar_wait(&kready[s], (j >> 1) & 1);  // kready[s]: tile j split into stage s
      lb::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)  // +32 bytes along the swizzled row per k8 step
        lb::wgmma_m64n32k8_tf32_ss(acc, lb::sw128_desc(qa + (kk >> 2) * kQAtomBytes + 32 * (kk & 3)),
                                   lb::sw128_desc(ka + (kk >> 2) * kKAtomBytes + 32 * (kk & 3)), kk);
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        lb::wgmma_m64n32k8_tf32_rs(acc, qh[kk],
                                   lb::sw128_desc(ka + Smem::kKlo + (kk >> 2) * kKAtomBytes + 32 * (kk & 3)), 1);
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        lb::wgmma_m64n32k8_tf32_rs(acc, qh[kk], lb::sw128_desc(ka + (kk >> 2) * kKAtomBytes + 32 * (kk & 3)), 1);
      lb::wgmma_commit();
    };
    // after tile j's S group completed: free its K stage; write the partial
    // into this CTA's slot (parity j & 1, [i][thread] float4) and copy the
    // slot into the same place in the three peers by the TMA engine, three
    // bulk copies counted on the peers' xfull (one remote store a float4
    // from every thread measured 2.2x slower at [4, 4096, 1, 512])
    auto send = [&](int j, float (&acc)[16]) {
      lb::fence_regs(acc);
      lb::mbar_arrive(&kempty[j & 1]);
      float4* mine =
          reinterpret_cast<float4*>(smem + Smem::kX + (j & 1) * kXParityBytes + rank * kXSlotBytes) + tid;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        mine[i * kConsumers] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      lb::fence_proxy_async();  // the slot is read by the async proxy, after every consumer wrote its part
      lb::bar_sync(1, kConsumers);
      if (tid == 0) {
#pragma unroll
        for (int pi = 0; pi < kRanks - 1; ++pi)
          lb::bulk_copy_to_peer(x_peer[pi] + (j & 1) * kXParityBytes, x_mine + (j & 1) * kXParityBytes,
                                kXSlotBytes, xbar_peer[pi] + 8 * (j & 1));
      }
    };

    issue_s(0, sa);
    lb::wgmma_wait<0>();
    send(0, sa);

    // one key tile; has_next (std::true_type or std::false_type): a tile
    // follows, so this step also issues and sends the next S (a constant,
    // so no wgmma group is issued under a run-time condition)
    auto step = [&](auto has_next, int j, float (&cur)[16], float (&nxt)[16]) {
      constexpr bool more = decltype(has_next)::value;
      if constexpr (more) issue_s(j + 1, nxt);

      // the full scores: the four slots (this CTA's own among them) summed
      // in rank order, the same bits in every CTA (one thread posts the
      // tile's bytes; the peers' may land first)
      if (tid == 0) lb::mbar_expect_tx(&xfull[j & 1], kXBytes);
      lb::mbar_wait_cluster(&xfull[j & 1], (j >> 1) & 1);
      const float4* recv = reinterpret_cast<const float4*>(smem + Smem::kX + (j & 1) * kXParityBytes) + tid;
      constexpr int kSlot = kXSlotBytes / 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 r0 = recv[i * kConsumers], r1 = recv[kSlot + i * kConsumers];
        const float4 r2 = recv[2 * kSlot + i * kConsumers], r3 = recv[3 * kSlot + i * kConsumers];
        cur[4 * i] = __fadd_rn(__fadd_rn(__fadd_rn(r0.x, r1.x), r2.x), r3.x);
        cur[4 * i + 1] = __fadd_rn(__fadd_rn(__fadd_rn(r0.y, r1.y), r2.y), r3.y);
        cur[4 * i + 2] = __fadd_rn(__fadd_rn(__fadd_rn(r0.z, r1.z), r2.z), r3.z);
        cur[4 * i + 3] = __fadd_rn(__fadd_rn(__fadd_rn(r0.w, r1.w), r2.w), r3.w);
      }

      // online softmax on the accumulators. Register i holds row
      // (g + 8*((i/2)%2)) of this warp's 16, key 8*(i/4) + 2*t + i%2.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 16; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], cur[i]);
      float alpha[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float m_new = fmaxf(m[e], mx[e] * scale_log2);
        alpha[e] = exp2f(m[e] - m_new);  // 0 on the first tile (m = -inf)
        m[e] = m_new;
      }
      // P split in place: cur keeps P (raw: its hi), pl holds lo
      float sum[2] = {0.f, 0.f};
      uint32_t pl[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int e = (i >> 1) & 1;
        const float pv = exp2f(fmaf(cur[i], scale_log2, -m[e]));
        sum[e] += pv;
        pl[i] = tf32_lo(pv, lb::tf32_trunc(pv));
        cur[i] = pv;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        l[e] = l[e] * alpha[e] + sum[e];
        c[e] *= alpha[e];
      }
      lb::fence_regs(o);
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
      // every kFold tiles, O into its fold (f32 FMAs, rounded to nearest):
      // the tensor core's adds into an accumulator drop the low bits of
      // each sum (~0.4 ulp lost an add, measured on the H100), which over
      // 3 products per 8 keys of a 16384-key sweep left the 1e-4 bound
      if (j > 0 && j % kFold == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float4 f = ofold[i * kConsumers];
          const float c0 = c[0], c1 = c[1];
          f.x = fmaf(f.x, c0, o[4 * i]);
          f.y = fmaf(f.y, c0, o[4 * i + 1]);
          f.z = fmaf(f.z, c1, o[4 * i + 2]);
          f.w = fmaf(f.w, c1, o[4 * i + 3]);
          ofold[i * kConsumers] = f;
          o[4 * i] = o[4 * i + 1] = o[4 * i + 2] = o[4 * i + 3] = 0.f;
        }
        c[0] = c[1] = 1.f;
      }

      // O += P V: k step kk's A fragment is S's n8 block kk with the k
      // order permuted (logical k t <- key 2t: registers 0, 2; t + 4 <-
      // key 2t + 1: registers 1, 3), V^T's keys stored in the same order
      const uint32_t va = lb::opaque(v_addr);
      lb::mbar_wait(vready, j & 1);  // vready: V^T of tile j
      lb::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint32_t a[4] = {pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1], pl[4 * kk + 3]};
        lb::wgmma_m64n128k8_tf32_rs(o, a, lb::sw128_desc(va + 32 * kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint32_t a[4] = {__float_as_uint(cur[4 * kk]), __float_as_uint(cur[4 * kk + 2]),
                               __float_as_uint(cur[4 * kk + 1]), __float_as_uint(cur[4 * kk + 3])};
        lb::wgmma_m64n128k8_tf32_rs(o, a, lb::sw128_desc(va + Smem::kVlo + 32 * kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk) {
        const uint32_t a[4] = {__float_as_uint(cur[4 * kk]), __float_as_uint(cur[4 * kk + 2]),
                               __float_as_uint(cur[4 * kk + 1]), __float_as_uint(cur[4 * kk + 3])};
        lb::wgmma_m64n128k8_tf32_rs(o, a, lb::sw128_desc(va + 32 * kk), 1);
      }
      lb::wgmma_commit();

      if constexpr (more) {
        lb::wgmma_wait<1>();  // S_{j+1} done, P V may still run
        send(j + 1, nxt);
      }
      lb::wgmma_wait<0>();
      // P's registers stay live until the products that read them are done
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(pl[i]), "+f"(cur[i])::"memory");
      lb::mbar_arrive(vempty);  // vempty: this thread is done with tile j's V^T
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
    const int r = q0 + 16 * warp + g;
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      const float4 f = ofold[n8 * kConsumers];  // O = its fold, rescaled, + the accumulator
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x0 = fmaf(e ? f.z : f.x, c[e], o[4 * n8 + 2 * e]);
        const float x1 = fmaf(e ? f.w : f.y, c[e], o[4 * n8 + 2 * e + 1]);
        float* dst = out + (int64_t)(row0 + r + 8 * e) * kD + 128 * rank + 8 * n8 + 2 * t;
        *reinterpret_cast<float2*>(dst) = make_float2(x0 * inv[e], x1 * inv[e]);
      }
    }
  }
  lb::cluster_sync();  // no CTA leaves while a peer may still address its shared memory
}

int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H, float scale,
           void* stream) {
  if (B <= 0 || L <= 0) return 0;
  if (H != 1 || L % kBQ != 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // [B*L, 512] f32 read as [B*L, 16, 32]: boxes of one 32-column atom
  CUtensorMap tq, tk;
  const int64_t rows = (int64_t)B * L;
  if (!lb::make_map_sw128(&tq, q, rows, kD / 32, kBQ, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !lb::make_map_sw128(&tk, k, rows, kD / 32, kBK, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = attention_d512_f32_kernel;
  const int bytes = static_cast<int>(Smem::kBytes);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(kRanks * (L / kBQ), B);  // the four CTAs of a cluster are neighbours in x
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, static_cast<const float*>(v), static_cast<float*>(out), L, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K3: VAE mid-block attention, one head of d = 512, f32 in/out, 3xTF32 on wgmma.
extern "C" int lb_attention_fwd_d512_f32(const void* q, const void* k, const void* v, void* out, int B, int L,
                                         int H, float scale, void* stream) {
  return launch(q, k, v, out, B, L, H, scale, stream);
}
