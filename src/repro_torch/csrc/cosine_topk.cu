// Fused cosine-distance probe: counts under thresholds + top-k, in two
// launches -- a scan that leaves per-block partials, then a merge.
//
// Replaces all nine Pallas entry points of
// src/repro/kernels/cosine_topk/kernel.py; the scalar probe is B = 1.
//   full scan   cosine_probe_blocks (:93), cosine_probe_batch_blocks (:153),
//               cosine_probe_batch_tiled_blocks (:193): n_valid = n_rows;
//   masked      cosine_probe_masked_blocks (:266),
//               cosine_probe_batch_masked_blocks (:328),
//               cosine_probe_batch_masked_tiled_blocks (:551): rows >= the
//               run-time n_valid are dead and never read, so nothing is
//               padded to a bucket;
//   rowmask     cosine_probe_rowmask_blocks (:398),
//               cosine_probe_batch_rowmask_blocks (:456),
//               cosine_probe_batch_rowmask_tiled_blocks (:503): a nullable
//               int32 mask; a row is live iff row < n_valid && mask[row] != 0,
//               and a dead row is never read.
// A compound mode (mode 1 = and, 2 = or) replaces the reference's jitted
// XLA compound scans (src/repro/index/clustered.py:83 _compound_masked_xla,
// src/repro/index/mutable.py:92 _tail_compound_xla) for any number of
// conjuncts: a block walks every predicate tile of the conjunction over its
// rows, keeping each row's running AND / OR in shared memory (a row already
// decided is not read again), and writes one match count per block.
//
// Two scans, one reduction order.
//
// The 8-wide scan (probe_kernel): B <= 8, compound mode, and the scalar-load
// path (d % 4 != 0 or an unaligned base). Grid (row blocks, predicate
// tiles of BT <= 8); 256 threads. A block stages its tile of predicates
// (and thresholds) in shared memory and streams its ROWS store rows, ROWS a
// power of two from 32 to 1024 chosen at launch: the largest block that
// still makes four blocks a SM, so a 16,384-row hot tail is 512 blocks of
// 32 rows and the 2^20 store keeps 1024-row blocks. Each warp scores kRows
// rows at a time with coalesced 16-byte loads. For B > 8 on the scalar-load
// path it reads the store once per tile of 8.
//
// The wide scan (probe_wide_kernel): every other launch with B > 8, one
// store pass for any B. Persistent CTAs, at most one a SM, each walk a
// contiguous range of staged blocks of kWRows = 32 rows; a producer warp
// brings each block's live rows into shared memory once, chunk by chunk
// (TMA; a dead row is never read), and streams the predicates from L2
// through a ring of stages of 256 floats of d for a pass of 24 predicates;
// eight consumer warps walk every pass over the staged rows with 8-row x
// 12-predicate register tiles. Details at the kernel.
//
// In both, every (row, predicate) dot product is reduced in one fixed order
// -- lane l owns the 4-element groups l, l + 32, ... of d in ascending
// order, explicit fmaf within each group from 0.0f, then the pairing of
// warp_sum (xor 16, 8, 4, 2, 1) across the 32 lanes; the scalar-load path
// reads the same groups one float at a time, and the wide scan's butterfly
// pairs the same two partial sums at every step -- so a row's distance does
// not depend on B, on the scan, on the tile, on the block, on the alignment
// or on where the row sits: a gathered subset, a masked buffer and the
// full store give a row the same bits, and a predicate alone is bitwise its
// row of any batch. dist = 1 - dot in f32; dead rows are never counted.
//
// Partials: counts of dist <= thr[t] for T thresholds, (nblk, B, T) int32,
// and each partial block's kb smallest distances, ascending, +inf past its
// live rows, (nblk, B, kb) f32: for the 8-wide scan a block of ROWS rows
// and kb = min(k, ROWS); for the wide scan an 8-row quarter of a CTA's
// rows (k <= 32, kb = k: a running list kept across the CTA's blocks) or of
// one staged block (k > 32, kb = 8). The merge kernel (one block a
// predicate) sums the counts and selects the k smallest of the nblk * kb
// candidates exactly: a radix select of the k-th value on order-preserving
// keys, then a sort of the values below it. Integer sums and an exact
// selection give the same bits in any order.
//
// Precision: plain fp32 FMAs on the CUDA cores -- no TF32 and no tensor
// cores, because counts must stay exact against f32 thresholds.
//
// Bound on the H100: at N = 2^20, d = 1152 the store is 4.83 GB, ~1.44 ms a
// read at 3.35 TB/s (SXM); the 2 N d B FLOPs reach the 67 TFLOP/s fp32 roof
// at B = 40 (7.22 ms at B = 200). The 8-wide scan is bound by the store
// read, once per tile of 8; the wide scan reads it once and is bound by
// its shared-memory traffic and the FMAs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;        // rows a warp scores together
constexpr int kMinRows = kWarps * kRows;   // rows per block, at least
constexpr int kMaxRows = 1024;  // rows per block, at most
constexpr int kMaxT = 32;       // thresholds per predicate (one lane each)
constexpr int kMergeThreads = 512;
constexpr int kSortCap = 4096;  // merge: sorted in shared memory up to this
constexpr int kKeyCache = 32768;  // merge: candidates kept in shared memory
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may take
constexpr int kMaxDevices = 64;   // devices whose kernel attributes are kept

// Let `kernel` take `bytes` of dynamic shared memory on the current device.
// The attribute belongs to the device that was current when it was set, so
// `done` keeps, per device, the largest limit set so far (0: none, the
// default of 48 KB less the kernel's static shared memory).
template <typename K>
cudaError_t allow_smem(K* kernel, int* done, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float dot4(float4 x, float4 p, float acc) {
  acc = fmaf(x.x, p.x, acc);
  acc = fmaf(x.y, p.y, acc);
  acc = fmaf(x.z, p.z, acc);
  acc = fmaf(x.w, p.w, acc);
  return acc;
}

// Ascending sort of n_arr arrays of n floats each (stride apart) by the
// bitonic network whose comparators all point up (the first step of each
// merge compares mirrored pairs). Slots at or past n act as +inf that never
// moves, so n need not be a power of two. Every thread of the block calls
// it; `a` may be shared or global memory.
__device__ void sort_asc(float* a, int n, int n_arr, int stride, int tid,
                         int nthreads) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  if (lg == 0) return;
  const unsigned half_p = 1u << (lg - 1);
  const unsigned pairs = (unsigned)n_arr << (lg - 1);
  for (unsigned size = 2; size <= (1u << lg); size <<= 1) {
    for (unsigned s = size >> 1; s > 0; s >>= 1) {
      const bool flip = s == (size >> 1);
      for (unsigned q = tid; q < pairs; q += nthreads) {
        const unsigned arr = q >> (lg - 1), p = q & (half_p - 1);
        const unsigned off = p & (s - 1);
        const unsigned lo = ((p & ~(s - 1)) << 1) | off;
        const unsigned hi = flip ? (lo - off) + 2 * s - 1 - off : lo + s;
        if (hi < (unsigned)n) {
          float* x = a + (size_t)arr * stride;
          const float u = x[lo], v = x[hi];
          if (u > v) { x[lo] = v; x[hi] = u; }
        }
      }
      __syncthreads();
    }
  }
}

struct ProbeArgs {
  const float* store;   // (n_rows, d)
  const float* preds;   // (B, d)
  const float* thr;     // (B, T)
  const int* mask;      // (n_rows,) or null
  int* cpart;           // (nblk, B, T) counts; compound: (nblk,)
  float* tpart;         // (nblk, B, kb)
  int n_scan;           // rows scanned: min(n_rows, n_valid)
  int d, B, T, kb, rows, mode;
  int n_rb;             // wide: staged blocks of kWRows rows
  int per_cta;          // wide: one partial a CTA (else one a staged block)
  int state_smem;       // wide: running counts and lists in shared memory
};

// The dot products of kRows rows (those with need[r]) with BT staged
// predicates, each lane over its own 4-element groups of d in ascending
// order. VEC reads 16-byte vectors; the scalar path reads the same groups
// one float at a time, so both give a row the same bits.
template <int BT, bool VEC>
__device__ __forceinline__ void dot_rows(const float* __restrict__ store,
                                         const float* spred, long long row,
                                         const bool (&need)[kRows], int d,
                                         int lane, float (&acc)[kRows][BT]) {
  if constexpr (VEC) {
    const int d4 = d >> 2;
    const float4* sp4 = reinterpret_cast<const float4*>(spred);
    for (int v = lane; v < d4; v += 32) {
      float4 x[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        x[r] = need[r] ? __ldg(reinterpret_cast<const float4*>(
                             store + (row + r) * d) + v)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        float4 p = sp4[t * d4 + v];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][t] = dot4(x[r], p, acc[r][t]);
      }
    }
  } else {
    for (int e0 = 4 * lane; e0 < d; e0 += 128) {
      float x[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          x[r][c] = (need[r] && e0 + c < d)
                        ? __ldg(store + (row + r) * d + e0 + c) : 0.f;
#pragma unroll
      for (int t = 0; t < BT; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (e0 + c >= d) break;
          const float p = spred[t * d + e0 + c];
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][t] = fmaf(x[r][c], p, acc[r][t]);
        }
    }
  }
}

// KIND: kScan (no mask: the full-scan and masked probes), kRowmask (probe
// with the mask), kCompound (mask optional); the plain scan compiles to
// code with no mask or compound branch in its row loop.
constexpr int kScan = 0, kRowmask = 1, kCompound = 2;

template <int BT, bool VEC, int KIND>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const ProbeArgs a) {
  extern __shared__ float4 smem4[];
  const int R = a.rows, d = a.d;
  float* spred = reinterpret_cast<float*>(smem4);          // [BT][d]
  float* sthr = spred + BT * d;                            // [BT][kMaxT]
  int* scount = reinterpret_cast<int*>(sthr + BT * kMaxT); // [BT][kMaxT]
  float* swmin = reinterpret_cast<float*>(scount + BT * kMaxT);  // [kWarps][BT]
  float* sdist = swmin + kWarps * BT;        // [BT][R] if kb > 1
  int* sflag = reinterpret_cast<int*>(sdist);  // compound: [R] row decisions

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x;
  const long long row0 = (long long)blk * R;
  const int n_tiles = KIND == kCompound ? (a.B + BT - 1) / BT : 1;

  int cnt[BT];          // lane j counts threshold j of each tile predicate
  float thr_l[BT];
  float vmin[BT];
  int b0 = blockIdx.y * BT, nb = 0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    if constexpr (KIND == kCompound) b0 = tile * BT;
    nb = min(BT, a.B - b0);
    if (tile) __syncthreads();      // every warp is done with the last tile
    for (int i = tid; i < BT * d; i += kThreads) {
      int t = i / d;
      spred[i] = t < nb ? a.preds[(long long)(b0 + t) * d + (i - t * d)] : 0.f;
    }
    for (int i = tid; i < BT * kMaxT; i += kThreads) {
      int t = i / kMaxT, j = i - t * kMaxT;
      sthr[i] = (t < nb && j < a.T) ? a.thr[(long long)(b0 + t) * a.T + j]
                                    : 0.f;
      if (tile == 0) scount[i] = 0;
    }
    __syncthreads();

    float thr0[BT];     // compound: each conjunct's threshold, every lane
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      thr0[t] = sthr[t * kMaxT];
      cnt[t] = 0;
      thr_l[t] = sthr[t * kMaxT + lane];
      vmin[t] = INFINITY;
    }

    for (int base = warp * kRows; base < R; base += kWarps * kRows) {
      bool need[kRows];
      bool any = false;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const long long row = row0 + base + r;
        bool live = row < a.n_scan;
        if constexpr (KIND != kScan)
          live = live && (a.mask == nullptr || __ldg(a.mask + row) != 0);
        need[r] = live;
        if constexpr (KIND == kCompound) {
          if (tile) {   // only rows the earlier tiles left undecided
            const int f = sflag[base + r];
            need[r] = live && (a.mode == 1 ? f != 0 : f == 0);
          }
        }
        any = any || need[r];
      }
      float acc[kRows][BT];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int t = 0; t < BT; ++t) acc[r][t] = 0.f;
      if (any)          // warp-uniform: a group of dead rows reads nothing
        dot_rows<BT, VEC>(a.store, spred, row0 + base, need, d, lane, acc);

#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        bool m_all = true, m_any = false;
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          float dot = warp_sum(acc[r][t]);   // identical on every lane
          float dist = need[r] ? 1.0f - dot : INFINITY;
          if constexpr (KIND == kCompound) {
            if (t < nb) {
              bool m = dist <= thr0[t];
              m_all = m_all && m;
              m_any = m_any || m;
            }
          } else {
            cnt[t] += (need[r] && dist <= thr_l[t]) ? 1 : 0;
            vmin[t] = fminf(vmin[t], dist);
            if (a.kb > 1 && lane == 0) sdist[t * R + base + r] = dist;
          }
        }
        if constexpr (KIND == kCompound) {
          if (lane == 0 && (tile == 0 || need[r]))
            sflag[base + r] = (need[r] && (a.mode == 1 ? m_all : m_any)) ? 1 : 0;
        }
      }
    }
  }

  if constexpr (KIND == kCompound) {  // one match count per block
    __syncthreads();
    int h = 0;
    for (int i = tid; i < R; i += kThreads) h += sflag[i];
    h = __reduce_add_sync(0xffffffffu, h);
    if (lane == 0 && h) atomicAdd(&scount[0], h);
    __syncthreads();
    if (tid == 0) a.cpart[blk] = scount[0];
  } else {
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      if (lane < a.T && cnt[t]) atomicAdd(&scount[t * kMaxT + lane], cnt[t]);
      if (lane == 0) swmin[warp * BT + t] = vmin[t];
    }
    __syncthreads();

    const long long pb = (long long)blk * a.B + b0;   // (blk, b0) in partials
    for (int i = tid; i < nb * a.T; i += kThreads) {
      int t = i / a.T, j = i - t * a.T;
      a.cpart[(pb + t) * a.T + j] = scount[t * kMaxT + j];
    }

    if (a.kb == 1) {
      if (tid < nb) {
        float m = INFINITY;
        for (int w = 0; w < kWarps; ++w) m = fminf(m, swmin[w * BT + tid]);
        a.tpart[pb + tid] = m;
      }
      return;
    }

    sort_asc(sdist, R, nb, R, tid, kThreads);   // the block's own R rows
    for (int i = tid; i < nb * a.kb; i += kThreads) {
      int t = i / a.kb, j = i - t * a.kb;
      a.tpart[(pb + t) * a.kb + j] = sdist[t * R + j];
    }
  }
}

// ------------------------------------------------------------------- wide
// B > 8: one store pass for any B. A persistent CTA walks a contiguous
// range of staged blocks of kWRows rows. Its producer warp (one thread of a
// warpgroup that hands its registers to the consumers with setmaxnreg)
// issues every copy by TMA: a block's rows into one buffer of 128-float
// chunks -- chunk c of the next block as soon as the consumers are done
// with chunk c in this block's last pass, so it lands a whole pass ahead --
// and the predicates from L2 into a ring of stages, each the same kSC
// chunks of d (a 4-element group a lane a chunk) of the kPass predicates
// of a pass; full and empty mbarriers pace the two sides, so no consumer
// waits for another inside a pass. The 8 consumer warps are 4 row subtiles of 8
// rows x 2 predicate subtiles: a warp holds an 8-row x kTileP-predicate
// register tile, lane l accumulating groups l, l + 32, ... in ascending
// order as dot_rows does, its predicates streamed past the rows 4 at a
// time (a whole last group may run past the warp's predicates; those sums
// are dropped). Each 32 floats of a row in shared memory thus feed kTileP
// predicates and each of a predicate's 8 rows. The tile's 8 x kTileP dot
// products are reduced by a butterfly that trades half its values at each
// step (xor 16, 8, 4, 2, 1), pairing the same two partial sums as warp_sum
// does, so every row keeps its bits; a predicate's 8 rows then sit in the 8
// lanes of one residue mod 4, where three more shuffles count them under
// each threshold and take their minimum. Each 8-row quarter keeps its own
// running counts and top-k (k <= kMaxListK: a sorted list a predicate,
// merged with the quarter's rows by a warp bitonic merge) in shared memory,
// or in its slice of the partials when they do not fit.

constexpr int kWRows = 32;      // store rows a staged block
constexpr int kRS = kWRows / 8;  // row subtiles of 8 rows
constexpr int kWarpsW = 8;      // consumer warps: kRS row x kPS predicate
constexpr int kPS = kWarpsW / kRS;  // predicate subtiles
constexpr int kChunk = 128;     // floats of d in a row chunk: a group a lane
constexpr int kMaxChunks = 16;  // 128-float chunks of d, at most
constexpr int kWideHead = 512;  // mbarriers and the live mask, then the rows
constexpr int kMaxListK = 32;   // k up to this: a running list a CTA

// The shape, by timing on an H100 (PERF.md): 8-row x 12-predicate warp
// tiles, passes of 24 predicates, 3 ring stages of 256 floats of d (as
// many as the rows of d = 1152 leave room for).
constexpr int kTileP = 12;          // predicates of a warp's register tile
constexpr int kPass = kPS * kTileP;  // predicates a pass
constexpr int kStages = 3;          // ring depth
constexpr int kSC = 2;              // row chunks a ring stage
constexpr int kStep = kSC * kChunk;  // floats of d a ring stage
static_assert(kPass <= 256 && kStep <= 256, "a TMA box side is <= 256");
// mbarriers in the head: row chunk full [kMaxChunks], ring full and empty
// [kStages], then the live mask
constexpr int kRowFull = 0, kRingFull = 8 * kMaxChunks,
              kRingEmpty = kRingFull + 8 * kStages,
              kLive = kRingEmpty + 8 * kStages;
static_assert(kLive + 8 <= kWideHead, "wide head");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// a (32, 128) box of the (B, d) predicates at (row b0, column e0) into
// shared `dst`, completing on `bar`; rows past B and columns past d read
// as zeros
__device__ __forceinline__ void tma_preds(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int e0, int b0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(e0),
         "r"(b0)
      : "memory");
}


// acc[r * kTileP + t] += x[r] . predicate t over one 4-element group, for
// the warp's first ng groups of 4 predicates: each group's predicate
// groups are loaded while the one before is multiplied. A group may run
// past the warp's predicates; those sums are never kept.
__device__ __forceinline__ void wide_fma(const float4 (&x)[8],
                                         const float4* __restrict__ p4,
                                         int ng, float (&acc)[8 * kTileP]) {
  float4 p[4], q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[j] = p4[j * (kStep / 4)];
    q[j] = p[j];
  }
#pragma unroll
  for (int gi = 0; gi < kTileP / 4; ++gi) {
    if (gi >= ng) break;                     // warp-uniform
    if (gi + 1 < ng) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q[j] = p4[((gi + 1) * 4 + j) * (kStep / 4)];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 8; ++r)
        acc[r * kTileP + gi * 4 + j] =
            dot4(x[r], p[j], acc[r * kTileP + gi * 4 + j]);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = q[j];
  }
}

// one butterfly step: lanes l and l ^ M each keep one half of v (the upper
// lane the upper half) and add the partner's copy of it
template <int M, int H, int N>
__device__ __forceinline__ void trade_half(float (&v)[N], int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = up ? v[j] : v[j + H];
    const float keep = up ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// warp_sum of each of N values, in its pairing: afterwards v[j] on lane l
// is the sum of value l * (N / 32) + j
template <int N>
__device__ __forceinline__ void warp_sum_n(float (&v)[N], int lane) {
  trade_half<16, N / 2>(v, lane);
  trade_half<8, N / 4>(v, lane);
  trade_half<4, N / 8>(v, lane);
  trade_half<2, N / 16>(v, lane);
  trade_half<1, N / 32>(v, lane);
}

// lanes 0..N-1 sorted ascending (N a power of two <= 32; each aligned run
// of N lanes is sorted on its own)
template <int N>
__device__ __forceinline__ float sort_lanes(float x, int lane) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, j);
      x = (((lane & j) == 0) == ((lane & k) == 0)) ? fminf(x, y) : fmaxf(x, y);
    }
  return x;
}

// lane l of a bitonic sequence of 32, sorted ascending
__device__ __forceinline__ float merge32(float x, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? fmaxf(x, y) : fminf(x, y);
  }
  return x;
}

size_t wide_smem_base(int d) {
  const size_t nc = (d + kChunk - 1) / kChunk;
  if (nc > kMaxChunks) return ~(size_t)0 >> 1;
  return kWideHead + 4 * (nc * kWRows * kChunk + kStages * kPass * kStep);
}

// the predicates a pass (or a warp subtile) takes: n spread over `parts`
// as evenly as they go, part i from *off
// the consumer warps' own barrier (the producer warpgroup is not in it)
__device__ __forceinline__ void bar_sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * kWarpsW) : "memory");
}

// a (kWRows, 128) box of the (n_scan, d) store at (row r0, column e0):
// rows at or past n_scan lie outside the map and are not read
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int e0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(e0),
         "r"(r0)
      : "memory");
}

__device__ __forceinline__ int share(int n, int parts, int i, int* off) {
  const int q = n / parts, rem = n % parts;
  *off = i * q + min(i, rem);
  return q + (i < rem);
}

template <bool MASK>
__global__ void __launch_bounds__(32 * kWarpsW + 128, 1)
probe_wide_kernel(const ProbeArgs a, const __grid_constant__ CUtensorMap tp,
                  const __grid_constant__ CUtensorMap ts) {
  constexpr int W = kWarpsW, NT = 32 * W, NV = 8 * kTileP, PER = NV / 32;
  static_assert(kTileP % 4 == 0 && PER * 4 == kTileP, "epilogue layout");
  static_assert(kWRows == 32, "a warp ballot covers a staged block");
  extern __shared__ __align__(128) unsigned char wsm[];
  const int d = a.d, d4 = d >> 2, B = a.B, T = a.T, kb = a.kb;
  const int nc = (d4 + 31) >> 5;           // row chunks of 128 floats
  const int ns = (nc + kSC - 1) / kSC;     // ring steps a pass
  const int np = (B + kPass - 1) / kPass;  // passes a staged block
  const uint32_t hb = smem_u32(wsm);
  unsigned* slive = reinterpret_cast<unsigned*>(wsm + kLive);
  float* srow = reinterpret_cast<float*>(wsm + kWideHead);  // [nc][32][128]
  float* sring = srow + nc * kWRows * kChunk;    // [kStages][kPass][kStep]
  // running state of the kRS 8-row quarters, [kRS][B][T] and [kRS][B][kb]
  int* scnt = reinterpret_cast<int*>(sring + kStages * kPass * kStep);
  float* slist = reinterpret_cast<float*>(scnt + kRS * B * T);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, g = blockIdx.x;   // the CTA's staged blocks
  const int rb0 = (int)((long long)g * a.n_rb / G);
  const int nmy = (int)((long long)(g + 1) * a.n_rb / G) - rb0;
  const int nsteps = np * ns;
  const long long total = (long long)nmy * nsteps;

  if (tid == 0) {
    for (int c = 0; c < nc; ++c) mbar_init(hb + kRowFull + 8 * c, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(hb + kRingFull + 8 * s, 1);
      mbar_init(hb + kRingEmpty + 8 * s, W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // each 8-row quarter of a staged block leaves its own partial: slots
  // kRS blk .. kRS blk + kRS - 1
  int* cst = nullptr;
  float* lst = nullptr;
  auto bind = [&](long long blk) {   // zero the running state of block blk
    cst = a.state_smem ? scnt : a.cpart + kRS * blk * B * T;
    lst = a.state_smem ? slist : a.tpart + kRS * blk * B * kb;
    for (int i = tid; i < kRS * B * T; i += NT) cst[i] = 0;
    for (int i = tid; i < kRS * B * kb; i += NT) lst[i] = INFINITY;
  };
  auto flush = [&](long long blk) {
    if (!a.state_smem) return;
    for (int i = tid; i < kRS * B * T; i += NT)
      a.cpart[kRS * blk * B * T + i] = scnt[i];
    for (int i = tid; i < kRS * B * kb; i += NT)
      a.tpart[kRS * blk * B * kb + i] = slist[i];
  };
  if (warp < W) bind(a.per_cta ? g : rb0);
  __syncthreads();

  if (warp >= W) {                 // the producer warpgroup: one warp
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp != W) return;
    // Rows: chunk c of the CTA's i-th staged block into the row buffer's
    // chunk c, once the consumers are done with it in block i - 1's last
    // pass; a dead row is never read (the map ends at n_scan; with a mask,
    // each live row is its own copy). The ring: step s (pass, kSC chunks of
    // d) into stage s % kStages, once the consumers are done with step
    // s - kStages.
    unsigned nlive = 0;
    auto issue_rows = [&](int i, int c) {
      const uint32_t full = hb + kRowFull + 8 * c;
      const int row0 = (rb0 + i) * kWRows;
      if (c == 0) {
        const long long row = (long long)row0 + lane;
        bool live = row < a.n_scan;
        if constexpr (MASK) live = live && __ldg(a.mask + row) != 0;
        nlive = __ballot_sync(0xffffffffu, live);
        if (lane == 0) slive[0] = nlive;
      }
      if constexpr (MASK) {
        const int len = min(kChunk, d - c * kChunk);
        if (lane == 0) mbar_expect_tx(full, __popc(nlive) * len * 4);
        __syncwarp();
        if ((nlive >> lane) & 1)
          bulk_g2s(smem_u32(srow + (c * kWRows + lane) * kChunk),
                   a.store + (long long)(row0 + lane) * d + c * kChunk,
                   len * 4, full);
      } else if (lane == 0) {
        mbar_expect_tx(full, kWRows * kChunk * 4);
        tma_rows(smem_u32(srow + c * kWRows * kChunk), &ts, full, c * kChunk,
                 row0);
      }
    };
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&tp)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n"
                   :: "l"(reinterpret_cast<uint64_t>(&ts)) : "memory");
    }
    if (nmy > 0)
      for (int c = 0; c < nc; ++c) issue_rows(0, c);
    int st = 0, ph = 0, p = 0, c = 0;      // the step to issue
    int ri = 0, rp = 0, rc = 0;            // the step released before it
    for (long long s = 0; s < total + kStages; ++s) {
      if (s >= kStages) {     // step s - kStages is released: (ri, rp, rc)
        if (lane == 0) mbar_wait(hb + kRingEmpty + 8 * st, ph ^ 1);
        __syncwarp();
        if (rp == np - 1 && ri + 1 < nmy)
          for (int h = 0; h < kSC && kSC * rc + h < nc; ++h)
            issue_rows(ri + 1, kSC * rc + h);
        if (++rc == ns) { rc = 0; if (++rp == np) { rp = 0; ++ri; } }
      }
      if (s < total && lane == 0) {
        const uint32_t full = hb + kRingFull + 8 * st;
        mbar_expect_tx(full, kPass * kStep * 4);
        tma_preds(smem_u32(sring + st * kPass * kStep), &tp, full,
                  c * kStep, p * kPass);
      }
      if (++st == kStages) { st = 0; ph ^= 1; }
      if (++c == ns) { c = 0; if (++p == np) p = 0; }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int rs = warp % kRS, ps = warp / kRS;   // row, predicate subtile
  int st = 0, ph = 0;
  for (int i = 0; i < nmy; ++i) {
    const uint32_t rph = i & 1;              // the row chunks' phase
    mbar_wait(hb + kRowFull, rph);
    const unsigned live = (slive[0] >> (8 * rs)) & 0xffu;   // this quarter's
    int* hcnt = cst + rs * B * T;            // this quarter's running state
    float* hlst = lst + rs * B * kb;
    // row r of the quarter, group lane of chunk c: x4[(c * kWRows + r) * 32]
    const float4* x4 = reinterpret_cast<const float4*>(srow) +
                       8 * rs * (kChunk / 4) + lane;
    for (int p = 0; p < np; ++p) {
      // full passes of kPass, then the rest; a warp takes whole groups of 4
      const int b0 = p * kPass, nb = min(kPass, B - b0);
      int off;
      const int ng = share((nb + 3) >> 2, kPS, ps, &off);
      off *= 4;
      const int n_t = max(0, min(4 * ng, nb - off));
      float th0[PER];   // the first threshold of the outputs the lane closes
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int t = (lane * PER + j) % kTileP;
        th0[j] = t < n_t ? __ldg(a.thr + (long long)(b0 + off + t) * T) : 0.f;
      }
      float acc[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j] = 0.f;
      for (int cs = 0; cs < ns; ++cs) {
        mbar_wait(hb + kRingFull + 8 * st, ph);
        const float4* p4 = reinterpret_cast<const float4*>(
                               sring + (st * kPass + off) * kStep) + lane;
#pragma unroll
        for (int h = 0; h < kSC; ++h) {        // the stage's chunks
          const int c = kSC * cs + h;
          if (c >= nc) break;
          if (p == 0 && c > 0) mbar_wait(hb + kRowFull + 8 * c, rph);
          if (live && n_t > 0 && c * 32 + lane < d4) {
            float4 x[8];
#pragma unroll
            for (int r = 0; r < 8; ++r)
              x[r] = x4[(c * kWRows + r) * (kChunk / 4)];
            wide_fma(x, p4 + h * (kChunk / 4), ng, acc);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(hb + kRingEmpty + 8 * st);
        if (++st == kStages) { st = 0; ph ^= 1; }
      }
      if (n_t == 0) continue;     // warp-uniform
      // lane l holds the sums of outputs PER l + j = kTileP r + t (row r of
      // the quarter, predicate t of the warp's tile): predicate t = PER c +
      // j lies in component j of the 8 lanes l = c (mod 4), one a row
      warp_sum_n<NV>(acc, lane);
      float dist[PER];
      bool ok[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int o = lane * PER + j, t = o % kTileP, r = o / kTileP;
        ok[j] = t < n_t && ((live >> r) & 1);
        dist[j] = ok[j] ? 1.0f - acc[j] : INFINITY;
      }
      const int c4 = lane & 3;    // lanes 0..3 close predicates PER l + j
      for (int tt = 0; tt < T; ++tt) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int t = (lane * PER + j) % kTileP;
          const float th = tt == 0 ? th0[j] : t < n_t
              ? __ldg(a.thr + (long long)(b0 + off + t) * T + tt) : 0.f;
          int n = ok[j] && dist[j] <= th;
          n += __shfl_xor_sync(0xffffffffu, n, 4);
          n += __shfl_xor_sync(0xffffffffu, n, 8);
          n += __shfl_xor_sync(0xffffffffu, n, 16);
          const int tc = PER * c4 + j;
          if (lane < 4 && tc < n_t && n)
            hcnt[(b0 + off + tc) * T + tt] += n;
        }
      }
      if (kb == 1) {
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          float m = dist[j];
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 4));
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 8));
          m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 16));
          const int tc = PER * c4 + j;
          if (lane < 4 && tc < n_t && m < hlst[b0 + off + tc])
            hlst[b0 + off + tc] = m;
        }
      } else {
        // the predicates with a candidate under their list's last entry
        unsigned need[PER];
#pragma unroll
        for (int j = 0; j < PER; ++j) {
          const int t = (lane * PER + j) % kTileP;
          need[j] = __ballot_sync(
              0xffffffffu,
              ok[j] && dist[j] < hlst[(long long)(b0 + off + t) * kb + kb - 1]);
        }
#pragma unroll
        for (int t = 0; t < kTileP; ++t) {
          const int j = t % PER, cc = t / PER;
          if (!(need[j] & (0x11111111u << cc))) continue;   // warp-uniform
          // its 8 rows from lanes cc, cc + 4, ..., sorted with the list
          const float v = __shfl_sync(0xffffffffu, dist[j], cc + 4 * (lane & 7));
          const float xs = sort_lanes<8>(lane < 8 ? v : INFINITY, lane);
          float* L = hlst + (long long)(b0 + off + t) * kb;
          const float cur = lane < kb ? L[lane] : INFINITY;
          const float z = merge32(
              fminf(cur, __shfl_sync(0xffffffffu, xs, 31 - lane)), lane);
          if (lane < kb) L[lane] = z;
        }
      }
    }
    if (!a.per_cta && i + 1 < nmy) {   // one partial a staged block
      bar_sync_consumers();
      flush(rb0 + i);
      bind(rb0 + i + 1);
      bar_sync_consumers();
    }
  }
  bar_sync_consumers();
  flush(a.per_cta ? g : rb0 + nmy - 1);
}

// Order-preserving unsigned keys of floats: key(x) < key(y) iff x < y.
__device__ __forceinline__ unsigned okey(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float okey_inv(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// One block a predicate b: counts (B, T) = the partial counts summed over
// the nblk blocks; topk (B, k) = the k smallest of the nblk * kb
// candidates, ascending, +inf past them. kb = 0 (compound) sums counts only.
//
// The top-k is a radix select on order-preserving keys, 8 bits a pass from
// the top: each pass histograms the candidates that share the prefix chosen
// so far (warp-aggregated shared-memory atomics) and picks the digit where
// the k-th falls. As soon as the candidates below that digit's bin and the
// bin itself number at most kSortCap, they are gathered and sorted in shared
// memory and the first k are the answer; else, after the last pass, the
// candidates below the k-th value are sorted (in the output row itself past
// kSortCap) and the k-th value fills the ties.
//
// Before the select, the candidates are cut to those at or below a bound on
// the k-th value: any ceil(k / kb) consecutive blocks hold at least k
// candidates, none above the largest of their lists' last entries, so the
// least such largest entry bounds the k-th. Each block's list is sorted, so
// its survivors are a prefix (a binary search); up to kKeyCache survivors'
// keys are kept in shared memory, else the select streams every candidate.
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const int* __restrict__ cpart, const float* __restrict__ tpart,
             int* __restrict__ counts, float* __restrict__ topk, int nblk,
             int B, int T, int kb, int k) {
  __shared__ int ssum[kMaxT];
  __shared__ unsigned hist[256];
  __shared__ float sred[kMergeThreads / 32];
  __shared__ unsigned sdig[3];
  __shared__ int sn;
  extern __shared__ unsigned skey[];   // [kSortCap] sort buffer, then keys
  float* sbuf = reinterpret_cast<float*>(skey);
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;

  if (tid < kMaxT) ssum[tid] = 0;
  __syncthreads();
  const int per = kMergeThreads / T;    // threads a threshold (T <= 32)
  if (tid < per * T) {
    const int t = tid % T;
    int s = 0;
    for (int i = tid / T; i < nblk; i += per)
      s += cpart[((long long)i * B + b) * T + t];
    if (s) atomicAdd(&ssum[t], s);
  }
  __syncthreads();
  if (tid < T) counts[(long long)b * T + tid] = ssum[tid];
  if (kb == 0) return;

  float* out = topk + (long long)b * k;
  if (k == 1) {             // kb = 1: the minimum over the blocks
    float m = INFINITY;
    for (int i = tid; i < nblk; i += kMergeThreads)
      m = fminf(m, tpart[(long long)i * B + b]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) sred[warp] = m;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kMergeThreads / 32; ++w) m = fminf(m, sred[w]);
      out[0] = m;
    }
    return;
  }

  // candidate e is entry e % kb of block e / kb (C < 2^32: n_rows < 2^31)
  const unsigned C = (unsigned)nblk * (unsigned)kb;
  const unsigned ksel = min((unsigned)k, C);
  auto cand = [&](unsigned e) {
    const unsigned i = e / kb;
    return tpart[((long long)i * B + b) * kb + (e - i * kb)];
  };
  auto list = [&](int i) { return tpart + ((long long)i * B + b) * kb; };
  const long long G = (k - 1) / kb + 1;
  float bnd = INFINITY;
  for (long long g = tid; (g + 1) * G <= nblk; g += kMergeThreads) {
    float mx = -INFINITY;
    for (long long i = g * G; i < (g + 1) * G; ++i)
      mx = fmaxf(mx, list((int)i)[kb - 1]);
    bnd = fminf(bnd, mx);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    bnd = fminf(bnd, __shfl_xor_sync(0xffffffffu, bnd, o));
  if (lane == 0) sred[warp] = bnd;
  if (tid == 0) sn = 0;
  __syncthreads();
  for (int w = 0; w < kMergeThreads / 32; ++w) bnd = fminf(bnd, sred[w]);
  unsigned* ckey = skey + kSortCap;
  for (int i = tid; i < nblk; i += kMergeThreads) {
    const float* l = list(i);
    int lo = 0, hi = kb;             // entries <= bnd: l[0 .. lo)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (l[mid] <= bnd) lo = mid + 1; else hi = mid;
    }
    const unsigned pos = atomicAdd(reinterpret_cast<unsigned*>(&sn), lo);
    for (int j = 0; j < lo && pos + j < (unsigned)kKeyCache; ++j)
      ckey[pos + j] = okey(l[j]);
  }
  __syncthreads();
  const unsigned S = (unsigned)sn;     // survivors: >= ksel, all <= bnd
  const bool cached = S <= (unsigned)kKeyCache;
  const unsigned C2 = cached ? S : C;
  auto key_of = [&](unsigned e) { return cached ? ckey[e] : okey(cand(e)); };
  const unsigned iters = (C2 + kMergeThreads - 1) / kMergeThreads;
  unsigned prefix = 0, pmask = 0, krem = ksel;
  bool early = false;
  for (int shift = 24; shift >= 0 && !early; shift -= 8) {
    for (int i = tid; i < 256; i += kMergeThreads) hist[i] = 0;
    __syncthreads();
    for (unsigned it = 0; it < iters; ++it) {   // every lane of a warp runs it
      const unsigned e = it * kMergeThreads + tid;
      const unsigned key = e < C2 ? key_of(e) : 0u;
      const bool in = e < C2 && (key & pmask) == prefix;
      const unsigned bin = (key >> shift) & 255u;
      const unsigned peers = __match_any_sync(0xffffffffu, in ? bin : 256u);
      if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (warp == 0) {        // lane l scans bins 8l .. 8l + 7
      unsigned h[8], s = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) { h[i] = hist[lane * 8 + i]; s += h[i]; }
      unsigned inc = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      unsigned cum = inc - s;
      if (cum < krem && inc >= krem) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (cum + h[i] >= krem) {
            sdig[0] = lane * 8 + i;
            sdig[1] = krem - cum;
            sdig[2] = h[i];
            break;
          }
          cum += h[i];
        }
      }
    }
    __syncthreads();
    prefix |= sdig[0] << shift;
    pmask |= 255u << shift;
    krem = sdig[1];
    // below the bin: ksel - krem candidates; in it: sdig[2]
    early = ksel - krem + sdig[2] <= (unsigned)kSortCap;
    __syncthreads();
  }

  if (tid == 0) sn = 0;
  __syncthreads();
  if (early) {              // the bin and everything below it, sorted
    for (unsigned e = tid; e < C2; e += kMergeThreads) {
      const unsigned key = key_of(e);
      if ((key & pmask) <= prefix) sbuf[atomicAdd(&sn, 1)] = okey_inv(key);
    }
    __syncthreads();
    const int n = sn;
    sort_asc(sbuf, n, 1, 0, tid, kMergeThreads);
    for (int j = tid; j < k; j += kMergeThreads)
      out[j] = j < (int)ksel ? sbuf[j] : INFINITY;
    return;
  }
  const float kth = okey_inv(prefix);
  const int n_lt = (int)(ksel - krem);     // candidates below the k-th
  float* buf = n_lt <= kSortCap ? sbuf : out;   // past the cap: sort in place
  for (unsigned e = tid; e < C2; e += kMergeThreads) {
    const unsigned key = key_of(e);
    if (key < prefix) buf[atomicAdd(&sn, 1)] = okey_inv(key);
  }
  __syncthreads();
  sort_asc(buf, n_lt, 1, 0, tid, kMergeThreads);
  for (int j = tid; j < k; j += kMergeThreads) {
    if (j < n_lt) {
      if (buf != out) out[j] = buf[j];
    } else {
      out[j] = j < (int)ksel ? kth : INFINITY;
    }
  }
}

size_t smem_bytes(int bt, int d, int kb, int rows, int mode) {
  size_t floats = (size_t)bt * d + 2 * bt * kMaxT + kWarps * bt;
  if (mode != 0) floats += rows;                 // row decisions
  else if (kb > 1) floats += (size_t)bt * rows;  // the block's distances
  return floats * 4;
}

template <int BT, bool VEC, int KIND>
cudaError_t launch_k(const ProbeArgs& a, dim3 grid, cudaStream_t stream) {
  static int done[kMaxDevices] = {};
  const size_t smem = smem_bytes(BT, a.d, a.kb, a.rows, a.mode);
  if (smem > (48 << 10)) {   // the scan has no static shared memory
    cudaError_t err = allow_smem(probe_kernel<BT, VEC, KIND>, done,
                                 (int)smem);
    if (err != cudaSuccess) return err;
  }
  probe_kernel<BT, VEC, KIND><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int BT, bool VEC>
cudaError_t launch_t(const ProbeArgs& a, dim3 grid, cudaStream_t s) {
  if (a.mode != 0) return launch_k<BT, VEC, kCompound>(a, grid, s);
  if (a.mask != nullptr) return launch_k<BT, VEC, kRowmask>(a, grid, s);
  return launch_k<BT, VEC, kScan>(a, grid, s);
}

template <bool VEC>
cudaError_t launch_v(int bt, const ProbeArgs& a, dim3 grid, cudaStream_t s) {
  switch (bt) {
    case 1: return launch_t<1, VEC>(a, grid, s);
    case 2: return launch_t<2, VEC>(a, grid, s);
    case 4: return launch_t<4, VEC>(a, grid, s);
    case 8: return launch_t<8, VEC>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the (B, d) f32 predicates in (kPass, kStep) boxes, unswizzled: a box is
// a ring stage as the consumers read it
bool pred_map(CUtensorMap* map, const void* preds, int B, int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)B};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kStep, (cuuint32_t)kPass};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(preds), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the (n_scan, d) f32 store in (kWRows, kChunk) boxes: rows past n_scan
// lie outside the map
bool row_map(CUtensorMap* map, const void* store, int n_scan, int d) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)max(n_scan, 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t box[2] = {(cuuint32_t)kChunk, (cuuint32_t)kWRows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(store), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool MASK>
cudaError_t launch_wide_k(const ProbeArgs& a, int grid, size_t smem,
                          cudaStream_t stream) {
  CUtensorMap tp, ts;
  if (!pred_map(&tp, a.preds, a.B, a.d) ||
      !row_map(&ts, a.store, a.n_scan, a.d))
    return cudaErrorInvalidValue;
  static int done[kMaxDevices] = {};
  if (smem > (48 << 10)) {   // no static shared memory either
    cudaError_t err = allow_smem(probe_wide_kernel<MASK>, done, (int)smem);
    if (err != cudaSuccess) return err;
  }
  probe_wide_kernel<MASK>
      <<<grid, 32 * kWarpsW + 128, smem, stream>>>(a, tp, ts);
  return cudaGetLastError();
}

// the wide launch's dynamic shared memory: the rows and the ring, plus the
// running state when it fits
size_t wide_smem(int d, int B, int T, int kb, bool* state_smem) {
  const size_t base = wide_smem_base(d);
  const size_t state = 4 * kRS * ((size_t)B * T + (size_t)B * kb);
  *state_smem = base + state <= (size_t)kMaxSmem;
  return base + (*state_smem ? state : 0);
}

}  // namespace

extern "C" {

// bt 0: the wide launch's shared memory without its running state
long long cosine_topk_smem_bytes(int bt, int d, int kb, int rows, int mode) {
  if (bt == 0) return (long long)wide_smem_base(d);
  return (long long)smem_bytes(bt, d, kb, rows, mode);
}

// store (n_rows, d), preds (B, d), thr (B, T): contiguous f32 on the device;
// mask (n_rows,) int32 or null; rows of store at or past n_scan
// (= min(n_rows, n_valid)) are dead. layout = {d, B, T, k, bt, rows, mode,
// grid}.
// grid 0, the 8-wide launch: rows a block, a power of two in [32, 1024];
// nblk = max(1, ceil(n_scan / rows)); kb = min(k, rows). mode 0: counts
// (B, T) int32 and topk (B, k) f32; part holds nblk * B * (T + kb) int32.
// mode 1 (and) / 2 (or): T = 1, k = 1, any B; counts (1,) the match count,
// topk unused, part holds nblk int32.
// grid > 0, the wide launch (mode 0, vec, preds 16-byte aligned): grid
// persistent CTAs of bt x 8 warp tiles (bt 8 or 16) over n_rb =
// ceil(n_scan / kWRows) staged blocks, grid <= max(1, n_rb). k <= kMaxListK
// (or n_rb = 0): one partial a CTA, nblk = grid, kb = k; else one a staged
// block, nblk = n_rb, kb = kWRows. device: the CUDA device of every pointer.
int cosine_topk_launch(const void* store, const void* preds, const void* thr,
                       const void* mask, void* counts, void* topk, void* part,
                       const int* layout, int n_scan, int vec, int device,
                       void* stream) {
  const int d = layout[0], B = layout[1], T = layout[2], k = layout[3],
            bt = layout[4], rows = layout[5], mode = layout[6],
            wgrid = layout[7];
  if (n_scan < 0 || d <= 0 || B <= 0 || T <= 0 || T > kMaxT || k <= 0 ||
      mode < 0 || mode > 2 || (mode != 0 && (T != 1 || k != 1)))
    return (int)cudaErrorInvalidValue;
  // make the device's primary context current on the calling thread: on a
  // thread whose first CUDA call this is, cuTensorMapEncodeTiled for
  // the wide launch would find none and fail
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto st = static_cast<cudaStream_t>(stream);
  ProbeArgs a{static_cast<const float*>(store), static_cast<const float*>(preds),
              static_cast<const float*>(thr), static_cast<const int*>(mask),
              static_cast<int*>(part), nullptr, n_scan, d, B, T, 0, rows,
              mode, 0, 0, 0};
  int nblk;
  if (wgrid > 0) {
    const int n_rb = (n_scan + kWRows - 1) / kWRows;
    if (mode != 0 || !vec || (d & 3) ||
        (reinterpret_cast<uintptr_t>(preds) & 15) ||
        wide_smem_base(d) > (size_t)kMaxSmem)
      return (int)cudaErrorInvalidValue;
    a.n_rb = n_rb;
    a.per_cta = k <= kMaxListK || n_rb == 0;
    a.kb = k <= kMaxListK ? k : 8;
    bool state_smem;
    const size_t smem = wide_smem(d, B, T, a.kb, &state_smem);
    a.state_smem = state_smem;
    const int grid = min(max(n_rb, 1), wgrid);
    nblk = kRS * (a.per_cta ? grid : n_rb);   // a partial a quarter
    a.tpart = reinterpret_cast<float*>(a.cpart + (long long)nblk * B * T);
    err = mask ? launch_wide_k<true>(a, grid, smem, st)
               : launch_wide_k<false>(a, grid, smem, st);
  } else {
    if (rows < kMinRows || rows > kMaxRows || (rows & (rows - 1)))
      return (int)cudaErrorInvalidValue;
    nblk = n_scan > 0 ? (n_scan + rows - 1) / rows : 1;
    a.kb = mode != 0 ? 0 : min(k, rows);
    a.tpart = reinterpret_cast<float*>(a.cpart + (long long)nblk * B * T);
    const dim3 grid(nblk, mode != 0 ? 1 : (B + bt - 1) / bt);
    err = vec ? launch_v<true>(bt, a, grid, st)
              : launch_v<false>(bt, a, grid, st);
  }
  if (err != cudaSuccess) return (int)err;
  const int kb = a.kb;
  const long long C = (long long)nblk * kb;
  const size_t msmem =
      kb > 0 && k > 1 ? 4 * (kSortCap + (C < kKeyCache ? C : kKeyCache)) : 0;
  // the merge has static shared memory too, so its default dynamic limit
  // is under 48 KB: raise it to the most it may take before any launch
  // that takes some
  static int merge_done[kMaxDevices] = {};
  if (msmem > 0) {
    err = allow_smem(merge_kernel, merge_done, 4 * (kSortCap + kKeyCache));
    if (err != cudaSuccess) return (int)err;
  }
  merge_kernel<<<mode != 0 ? 1 : B, kMergeThreads, msmem, st>>>(
      a.cpart, a.tpart, static_cast<int*>(counts), static_cast<float*>(topk),
      nblk, mode != 0 ? 1 : B, T, kb, k);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
