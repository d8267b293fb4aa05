// Fused cosine-distance probe: counts under thresholds + top-k, in two
// launches — a scan that leaves per-block partials, then a merge.
//
// Replaces all nine Pallas entry points of
// src/repro/kernels/cosine_topk/kernel.py with one scan kernel: the scalar
// probe is B = 1, and predicate tiles are a grid axis.
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
// Grid (row blocks, predicate tiles); 256 threads (8 warps). A block stages
// a tile of BT <= 8 predicate vectors (and their thresholds) in shared
// memory and streams its ROWS store rows, ROWS a power of two from 32 to
// 1024 chosen at launch from the rows scanned, the predicate tiles and the
// SM count: the largest block that still makes four blocks a SM, so a
// 16,384-row hot tail is 512 blocks of 32 rows, enough bytes in flight on
// every SM, and the 2^20 store keeps 1024-row blocks. Each warp scores
// kRows rows at a time with coalesced 16-byte loads. For every
// (row, predicate) the dot product is reduced in one fixed order — lane l
// owns the 4-element groups l, l + 32, ... of d in ascending order, explicit
// fmaf within each group, then a fixed xor-butterfly across the warp; the
// scalar-load path (d % 4 != 0 or an unaligned base) keeps the same
// assignment — so a row's distance does not depend on B, on the predicate
// tile, on the block size, on the alignment or on where the row sits: a
// gathered subset, a masked buffer and the full store give a row the same
// bits. dist = 1 - dot in f32; dead rows are +inf and never counted.
//
// Partials: counts of dist <= thr[t] for T thresholds, (nblk, B, T) int32,
// and each block's kb = min(k, ROWS) smallest distances, ascending,
// (nblk, B, kb) f32 (a warp min for k = 1, else a sort of the block's own
// ROWS distances, 32 on a small buffer). The merge
// kernel (one block a predicate) sums the counts and selects the k smallest
// of the nblk * kb candidates exactly: a radix select of the k-th value on
// order-preserving keys, then a sort of the values below it. Integer sums
// and an exact selection give the same bits in any order.
//
// Precision: plain fp32 FMAs on the CUDA cores — no TF32 and no tensor cores,
// because counts must stay exact against f32 thresholds.
//
// Bound on the H100: the store read. At N = 2^20, d = 1152 that is 4.83 GB,
// ~1.44 ms per pass at 3.35 TB/s (SXM); the 2·N·d·B FLOPs (7.2 GFLOP at B = 3)
// are far below the 67 TFLOP/s fp32 roof. The design reads each live store
// row from device memory once per predicate tile of up to 8 predicates, and
// keeps enough blocks resident on small buffers to have the bytes in flight
// that the memory rate needs.

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
  static int allowed = 48 << 10;    // dynamic shared memory the kernel may take
  const size_t smem = smem_bytes(BT, a.d, a.kb, a.rows, a.mode);
  if ((int)smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        probe_kernel<BT, VEC, KIND>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = (int)smem;
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

}  // namespace

extern "C" {

long long cosine_topk_smem_bytes(int bt, int d, int kb, int rows, int mode) {
  return (long long)smem_bytes(bt, d, kb, rows, mode);
}

// store (n_rows, d), preds (B, d), thr (B, T): contiguous f32 on the device;
// mask (n_rows,) int32 or null; rows of store at or past n_scan
// (= min(n_rows, n_valid)) are dead. rows: store rows a block, a power of
// two in [32, 1024]; nblk = max(1, ceil(n_scan / rows)).
// layout = {d, B, T, k, bt, rows, mode}. mode 0: counts (B, T) int32 and
// topk (B, k) f32; part holds nblk * B * (T + min(k, rows)) int32. mode 1
// (and) / 2 (or): T = 1, k = 1, any B; counts (1,) the match count, topk
// unused, part holds nblk int32.
int cosine_topk_launch(const void* store, const void* preds, const void* thr,
                       const void* mask, void* counts, void* topk, void* part,
                       const int* layout, int n_scan, int vec, void* stream) {
  const int d = layout[0], B = layout[1], T = layout[2], k = layout[3],
            bt = layout[4], rows = layout[5], mode = layout[6];
  if (n_scan < 0 || d <= 0 || B <= 0 || T <= 0 || T > kMaxT || k <= 0 ||
      rows < kMinRows || rows > kMaxRows || (rows & (rows - 1)) ||
      mode < 0 || mode > 2 || (mode != 0 && (T != 1 || k != 1)))
    return (int)cudaErrorInvalidValue;
  const int nblk = n_scan > 0 ? (n_scan + rows - 1) / rows : 1;
  const int kb = mode != 0 ? 0 : min(k, rows);
  ProbeArgs a{static_cast<const float*>(store), static_cast<const float*>(preds),
              static_cast<const float*>(thr), static_cast<const int*>(mask),
              static_cast<int*>(part), nullptr, n_scan, d, B, T, kb, rows,
              mode};
  a.tpart = reinterpret_cast<float*>(a.cpart + (long long)nblk * B * T);
  const dim3 grid(nblk, mode != 0 ? 1 : (B + bt - 1) / bt);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = vec ? launch_v<true>(bt, a, grid, st)
                        : launch_v<false>(bt, a, grid, st);
  if (err != cudaSuccess) return (int)err;
  const long long C = (long long)nblk * kb;
  const size_t msmem =
      kb > 0 && k > 1 ? 4 * (kSortCap + (C < kKeyCache ? C : kKeyCache)) : 0;
  static bool merge_attr = false;
  if (msmem > (48 << 10) && !merge_attr) {
    err = cudaFuncSetAttribute(merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * (kSortCap + kKeyCache));
    if (err != cudaSuccess) return (int)err;
    merge_attr = true;
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
