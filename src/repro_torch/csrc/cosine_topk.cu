// Fused cosine-distance probe: counts under thresholds + per-slab top-k.
//
// Replaces all nine Pallas entry points of
// src/repro/kernels/cosine_topk/kernel.py with one kernel: the scalar probe
// is B = 1, and predicate tiles are a grid axis.
//   full scan   cosine_probe_blocks (:93), cosine_probe_batch_blocks (:153),
//               cosine_probe_batch_tiled_blocks (:193): n_valid = n_rows;
//   masked      cosine_probe_masked_blocks (:266),
//               cosine_probe_batch_masked_blocks (:328),
//               cosine_probe_batch_masked_tiled_blocks (:551): rows >= the
//               run-time n_valid are dead, so nothing is padded to a bucket;
//   rowmask     cosine_probe_rowmask_blocks (:398),
//               cosine_probe_batch_rowmask_blocks (:456),
//               cosine_probe_batch_rowmask_tiled_blocks (:503): a nullable
//               int32 mask; a row is live iff row < n_valid && mask[row] != 0.
// A compound mode (mode 1 = and, 2 = or) replaces the reference's jitted
// XLA compound scans (src/repro/index/clustered.py:83 _compound_masked_xla,
// src/repro/index/mutable.py:92 _tail_compound_xla): the B <= 8 conjuncts
// of one predicate sit in one tile, each row is decided with the same
// distance the probe computes, and one match count per slab goes to counts.
//
// Grid (row slabs, predicate tiles); 256 threads (8 warps). A block stages a
// tile of BT predicate vectors (and their thresholds) in shared memory and
// streams its slab of SLAB store rows with coalesced 16-byte loads, each warp
// ROWS rows at a time. For every (row, predicate) the dot product is reduced
// in a fixed order — per-lane partials over d in ascending order with
// explicit fmaf, then a fixed xor-butterfly across the warp — so a row's
// distance does not depend on B, on the predicate tile, on the slab or on
// where the row sits: a gathered subset, a masked buffer and the full store
// give a row the same bits. dist = 1 - dot in f32; dead rows are +inf and
// never counted. Counts of dist <= thr[t] for T thresholds go to
// counts (nslab, B, T) int32; the slab's kk smallest distances, ascending, go
// to topk (nslab, B, kk) f32 (a warp min for kk = 1, otherwise a bitonic sort
// of the slab in shared memory). The wrapper sums the counts and merges the
// partials with torch.topk, which keeps every k <= N exact.
//
// Precision: plain fp32 FMAs on the CUDA cores — no TF32 and no tensor cores,
// because counts must stay exact against f32 thresholds.
//
// Bound on the H100: the store read. At N = 2^20, d = 1152 that is 4.83 GB,
// ~1.44 ms per pass at 3.35 TB/s (SXM); the 2·N·d·B FLOPs (7.2 GFLOP at B = 3)
// are far below the 67 TFLOP/s fp32 roof. The design reads each store row
// from device memory once per predicate tile of up to 8 predicates; keeping
// ROWS rows in flight per warp amortises the shared-memory predicate reads.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 1024;   // rows per block (a power of two, for the sort)
constexpr int kRows = 4;      // rows a warp scores together
constexpr int kMaxT = 32;     // thresholds per predicate (one lane each)

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

// VEC: 16-byte loads (d % 4 == 0 and 16-byte aligned rows), else scalar.
// KIND: kScan (no mask: the full-scan and masked probes), kRowmask (probe
// with the mask), kCompound (mask optional); the plain scan compiles to
// code with no mask or compound branch in its row loop.
constexpr int kScan = 0, kRowmask = 1, kCompound = 2;

template <int BT, bool VEC, int KIND>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ store, const float* __restrict__ preds,
             const float* __restrict__ thr, const int* __restrict__ mask,
             int* __restrict__ counts, float* __restrict__ topk, int n_rows,
             int n_valid, int d, int B, int T, int kk, int mode) {
  extern __shared__ float4 smem4[];
  float* spred = reinterpret_cast<float*>(smem4);          // [BT][d]
  float* sthr = spred + BT * d;                            // [BT][kMaxT]
  int* scount = reinterpret_cast<int*>(sthr + BT * kMaxT); // [BT][kMaxT]
  float* swmin = reinterpret_cast<float*>(scount + BT * kMaxT);  // [kWarps][BT]
  float* sdist = swmin + kWarps * BT;                      // [BT][kSlab] if kk>1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slab = blockIdx.x;
  const int b0 = blockIdx.y * BT;
  const int nb = min(BT, B - b0);
  const long long row0 = (long long)slab * kSlab;

  for (int i = tid; i < BT * d; i += kThreads) {
    int t = i / d;
    spred[i] = t < nb ? preds[(long long)(b0 + t) * d + (i - t * d)] : 0.f;
  }
  for (int i = tid; i < BT * kMaxT; i += kThreads) {
    int t = i / kMaxT, j = i - t * kMaxT;
    sthr[i] = (t < nb && j < T) ? thr[(long long)(b0 + t) * T + j] : 0.f;
    scount[i] = 0;
  }
  __syncthreads();

  int cnt[BT];          // lane j counts threshold j of each tile predicate
  float thr_l[BT];
  float thr0[BT];       // threshold 0 of each predicate, on every lane
  float vmin[BT];
  int hits = 0;         // compound: rows matching the whole predicate
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    cnt[t] = 0;
    thr_l[t] = sthr[t * kMaxT + lane];
    thr0[t] = sthr[t * kMaxT];
    vmin[t] = INFINITY;
  }

  for (int base = warp * kRows; base < kSlab; base += kWarps * kRows) {
    float acc[kRows][BT];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < BT; ++t) acc[r][t] = 0.f;

    if constexpr (VEC) {
      const int d4 = d >> 2;
      const float4* sp4 = reinterpret_cast<const float4*>(spred);
      for (int v = lane; v < d4; v += 32) {
        float4 x[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          long long row = row0 + base + r;
          x[r] = row < n_rows
                     ? __ldg(reinterpret_cast<const float4*>(store + row * d) + v)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          float4 p = sp4[t * d4 + v];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][t] = dot4(x[r], p, acc[r][t]);
        }
      }
    } else {
      for (int e = lane; e < d; e += 32) {
        float x[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          long long row = row0 + base + r;
          x[r] = row < n_rows ? __ldg(store + row * d + e) : 0.f;
        }
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          float p = spred[t * d + e];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][t] = fmaf(x[r], p, acc[r][t]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long row = row0 + base + r;
      bool live = row < n_valid;
      if constexpr (KIND != kScan)
        live = live && (mask == nullptr || mask[row] != 0);
      bool m_all = true, m_any = false;
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        float dot = warp_sum(acc[r][t]);   // identical on every lane
        float dist = live ? 1.0f - dot : INFINITY;
        if constexpr (KIND == kCompound) {
          if (t < nb) {
            bool m = dist <= thr0[t];      // dead rows: `live` below
            m_all = m_all && m;
            m_any = m_any || m;
          }
        } else {
          cnt[t] += (live && dist <= thr_l[t]) ? 1 : 0;
          vmin[t] = fminf(vmin[t], dist);
          if (kk > 1 && lane == 0) sdist[t * kSlab + base + r] = dist;
        }
      }
      if constexpr (KIND == kCompound)
        hits += (live && (mode == 1 ? m_all : m_any)) ? 1 : 0;
    }
  }

  if constexpr (KIND == kCompound) {  // one tile: one match count per slab
    if (lane == 0 && hits) atomicAdd(&scount[0], hits);
    __syncthreads();
    if (tid == 0) counts[slab] = scount[0];
    return;
  }

#pragma unroll
  for (int t = 0; t < BT; ++t) {
    if (lane < T && cnt[t]) atomicAdd(&scount[t * kMaxT + lane], cnt[t]);
    if (lane == 0) swmin[warp * BT + t] = vmin[t];
  }
  __syncthreads();

  for (int i = tid; i < nb * T; i += kThreads) {
    int t = i / T, j = i - t * T;
    counts[((long long)slab * B + b0 + t) * T + j] = scount[t * kMaxT + j];
  }

  if (kk == 1) {
    if (tid < nb) {
      float m = INFINITY;
      for (int w = 0; w < kWarps; ++w) m = fminf(m, swmin[w * BT + tid]);
      topk[(long long)slab * B + b0 + tid] = m;
    }
    return;
  }

  // bitonic sort of each predicate's slab distances, ascending
  for (int size = 2; size <= kSlab; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < nb * (kSlab / 2); i += kThreads) {
        int t = i / (kSlab / 2), p = i - t * (kSlab / 2);
        int lo = 2 * stride * (p / stride) + (p % stride);
        int hi = lo + stride;
        bool asc = (lo & size) == 0;
        float* s = sdist + t * kSlab;
        float a = s[lo], b = s[hi];
        if ((a > b) == asc) { s[lo] = b; s[hi] = a; }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < nb * kk; i += kThreads) {
    int t = i / kk, j = i - t * kk;
    topk[((long long)slab * B + b0 + t) * kk + j] = sdist[t * kSlab + j];
  }
}

size_t smem_bytes(int bt, int d, int kk) {
  size_t floats = (size_t)bt * d + 2 * bt * kMaxT + kWarps * bt;
  if (kk > 1) floats += (size_t)bt * kSlab;
  return floats * 4;
}

template <int BT, bool VEC, int KIND>
cudaError_t launch_k(const float* store, const float* preds, const float* thr,
                     const int* mask, int* counts, float* topk, int n_rows,
                     int n_valid, int d, int B, int T, int kk, int mode,
                     cudaStream_t stream) {
  size_t smem = smem_bytes(BT, d, kk);
  cudaError_t err = cudaFuncSetAttribute(
      probe_kernel<BT, VEC, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_rows + kSlab - 1) / kSlab, (B + BT - 1) / BT);
  probe_kernel<BT, VEC, KIND><<<grid, kThreads, smem, stream>>>(
      store, preds, thr, mask, counts, topk, n_rows, n_valid, d, B, T, kk,
      mode);
  return cudaGetLastError();
}

template <int BT, bool VEC>
cudaError_t launch_t(const float* store, const float* preds, const float* thr,
                     const int* mask, int* counts, float* topk, int n_rows,
                     int n_valid, int d, int B, int T, int kk, int mode,
                     cudaStream_t stream) {
  if (mode != 0)
    return launch_k<BT, VEC, kCompound>(store, preds, thr, mask, counts, topk,
                                        n_rows, n_valid, d, B, T, kk, mode,
                                        stream);
  if (mask != nullptr)
    return launch_k<BT, VEC, kRowmask>(store, preds, thr, mask, counts, topk,
                                       n_rows, n_valid, d, B, T, kk, mode,
                                       stream);
  return launch_k<BT, VEC, kScan>(store, preds, thr, mask, counts, topk,
                                  n_rows, n_valid, d, B, T, kk, mode, stream);
}

template <bool VEC>
cudaError_t launch_v(int bt, const float* store, const float* preds,
                     const float* thr, const int* mask, int* counts,
                     float* topk, int n_rows, int n_valid, int d, int B, int T,
                     int kk, int mode, cudaStream_t s) {
  switch (bt) {
    case 1: return launch_t<1, VEC>(store, preds, thr, mask, counts, topk, n_rows, n_valid, d, B, T, kk, mode, s);
    case 2: return launch_t<2, VEC>(store, preds, thr, mask, counts, topk, n_rows, n_valid, d, B, T, kk, mode, s);
    case 4: return launch_t<4, VEC>(store, preds, thr, mask, counts, topk, n_rows, n_valid, d, B, T, kk, mode, s);
    case 8: return launch_t<8, VEC>(store, preds, thr, mask, counts, topk, n_rows, n_valid, d, B, T, kk, mode, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

long long cosine_topk_smem_bytes(int bt, int d, int kk) {
  return (long long)smem_bytes(bt, d, kk);
}

// store (n_rows, d), preds (B, d), thr (B, T): contiguous f32 on the device;
// mask (n_rows,) int32 or null. mode 0: counts (ceil(n_rows / SLAB), B, T)
// int32 and topk (ceil(n_rows / SLAB), B, kk). mode 1 (and) / 2 (or): T = 1,
// B <= bt (one tile), counts (ceil(n_rows / SLAB),) and topk unused.
int cosine_topk_launch(const void* store, const void* preds, const void* thr,
                       const void* mask, void* counts, void* topk, int n_rows,
                       int n_valid, int d, int B, int T, int kk, int bt,
                       int vec, int mode, void* stream) {
  if (n_rows <= 0 || d <= 0 || B <= 0 || T <= 0 || T > kMaxT || kk <= 0 ||
      kk > kSlab || mode < 0 || mode > 2 ||
      (mode != 0 && (T != 1 || B > bt || kk != 1)))
    return (int)cudaErrorInvalidValue;
  auto* s = static_cast<const float*>(store);
  auto* p = static_cast<const float*>(preds);
  auto* t = static_cast<const float*>(thr);
  auto* m = static_cast<const int*>(mask);
  auto* c = static_cast<int*>(counts);
  auto* k = static_cast<float*>(topk);
  auto st = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_v<true>(bt, s, p, t, m, c, k, n_rows, n_valid, d, B, T, kk, mode, st)
                   : launch_v<false>(bt, s, p, t, m, c, k, n_rows, n_valid, d, B, T, kk, mode, st));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
