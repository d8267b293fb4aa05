// Flash-decode: one new token's GQA query heads against a KV cache, with a
// per-sequence number of valid cache slots. Split-KV: the cache slots of
// all (sequence, KV head, head group) triples are dealt to the blocks in
// equal runs, each run's stretch of a triple leaves a partial state, and a
// second kernel merges a triple's partials. Two launches per call.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py
// decode_fwd (:62, _decode_kernel). Its grid (B, Hkv, nk) streams the cache
// in (kc, D) tiles and carries (m, l, acc) for the rep heads in VMEM, in
// order. Blocks on the card run in no order, so each stretch keeps its own
// float32 (m, l, acc) and the merge combines them:
//   m = max_i m_i,  l = sum_i l_i 2^(m_i - m),
//   o = sum_i acc_i 2^(m_i - m) / max(l, 1e-30)
// (scores are kept in base 2, scaled by scale * log2 e). A stretch
// that lies wholly at or past kv_valid[b] writes l = 0 without reading
// the cache, and the merge skips it. K and V come in as float32, bfloat16
// or fp8 e4m3 and are upcast in registers; q and the output are float32
// or bfloat16. The cache is read in the reference's (B, L, Hkv, D) layout
// through its strides: nothing is padded or copied in device memory.
//
// Any GQA ratio: a KV head's rep query heads are taken in groups of at
// most kMaxRep = 8, each group a work item of its own (rep 16 is two
// groups, rep 7 one), so a KV head's slots are read once a group. Any head
// dim D <= 256 that is a multiple of 4: the kernels are built for a few
// widths (the template's D) and pad D with zero columns in shared memory
// (the copies' zero fill) and registers; the output's pad columns are
// never written. Rows whose starts are 16-byte aligned load as 16-byte
// cp.async copies; any other row of 4-byte-aligned starts (D = 20 bf16 at
// a 40-byte stride) as four 4-byte copies a vector, chosen by the launcher
// (vec).
//
// Bound on the H100 at the batched prompt decode (B 23 unique medoids,
// L 1168, valid 1153..1158, Hkv 8, rep 4, D 128, bf16): the valid K and V
// rows, ~109 MB a step, over 3.35 TB/s is 0.0326 ms, so bytes bound it.
// What the design does about it: the grid is exactly the blocks the card
// holds at once (from the kernel's occupancy), and the (triple, chunk)
// units are split evenly between them, so every block streams from the
// start to the end and none waits in a second wave, whatever B x Hkv is.
// Loads are cp.async copies into a ring in shared memory, several chunks
// in flight while one is used. Two split kernels, by type:
// * bfloat16 q and cache with D <= 128 (the main path): both products on
//   the tensor cores (mma.sync m16n8k16), a group's query heads as rows of
//   a 16-row A tile; each warp streams its own 16-key slices through its
//   own ring of four (32 KB in flight a warp) with its own online softmax,
//   so the loop has no block barrier; the four warps' states are combined
//   at the end of a stretch. On the CUDA cores the dot products, not the
//   bytes, set the pace at this occupancy (about 50 instructions per
//   16-byte vector).
// * float32 or fp8 cache, float32 q, or D > 128 (the tolerances need
//   float32 products): CUDA-core FMAs. A bf16 row of 128 is 16 lanes x 16
//   bytes, an fp8 row 8 lanes and a float32 row 32 (a float32 row of 256:
//   32 lanes x 32 bytes); the group's scaled queries sit in registers; a
//   row's dot products finish with a reduce-scatter butterfly (REP - 1
//   shuffles before the plain halvings); for P V each lane owns a run of
//   columns and reads V as 16-byte vectors, and the rows are summed by
//   shuffles and across warps once, at the end of a stretch.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxRep = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;       // chunks of K and V in shared memory
constexpr int kLoads = 4;        // 16-byte loads a lane per chunk and tensor
constexpr int kMmaStages = 4;    // 16-key slices a warp keeps in its ring
constexpr int kMmaChunk = 64;    // slots of a work unit of the mma kernel

struct Strides {                 // elements; the head-dim stride is 1
  long long qb, qh, kb, ks, kh, vb, vs, vh, ob, oh;
};

// 16 bytes of the cache as floats
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       __nv_fp8_e4m3) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      __nv_fp8_e4m3 x;
      x.__x = (__nv_fp8_storage_t)((w[i] >> (8 * j)) & 0xffu);
      f[4 * i + j] = static_cast<float>(x);
    }
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes from global to shared memory, zeros where `bytes` is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
// 16 bytes of shared memory from the first `bytes` (a multiple of 4) at
// src, the rest zeros: one 16-byte copy when src is 16-byte aligned (vec),
// else four 4-byte copies
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       int bytes, int vec) {
  if (vec) {
    cp_async16(dst, src, bytes);
    return;
  }
  const char* p = static_cast<const char*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool ok = 4 * i < bytes;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst + 4 * i), "l"(ok ? p + 4 * i : p), "r"(ok ? 4 : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ uint4 lds16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr));
  return v;
}

// 16-byte vectors a lane takes of a row: 1, or 2 where a row is wider than
// 32 of them (a float32 row of 256)
template <typename TKV, int D>
__host__ __device__ constexpr int vectors_per_lane() {
  return D * (int)sizeof(TKV) > 512 ? D * (int)sizeof(TKV) / 512 : 1;
}

// Cache rows one warp load covers: 32 lanes over a row
template <typename TKV, int D>
__host__ __device__ constexpr int rows_per_load() {
  return 32 * 16 * vectors_per_lane<TKV, D>() / (int)sizeof(TKV) / D;
}

// Cache slots a block takes at a time: kLoads 16-byte loads a lane for K
// and as many for V (more where a chunk would be under 32 slots), at most
// 128 slots.
template <typename TKV, int D>
__host__ __device__ constexpr int chunk_slots() {
  const int slots = kWarps * rows_per_load<TKV, D>() * kLoads;
  return slots < 32 ? 32 : slots > 128 ? 128 : slots;
}

// Bytes of a chunk of K (or V) in shared memory: each lane's vectors
template <typename TKV, int D>
__host__ __device__ constexpr int chunk_bytes() {
  return kThreads * 16 * vectors_per_lane<TKV, D>()
         * (chunk_slots<TKV, D>() / (kWarps * rows_per_load<TKV, D>()));
}

// Bytes of the ring: kStages chunks of K and of V (the warps' partial sums
// reuse it at the end of a segment)
template <typename TKV, int D>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * 2 * chunk_bytes<TKV, D>();
}

// The block that holds work unit u when T units are dealt to G blocks in
// contiguous runs, block j taking [j T / G, (j + 1) T / G)
__host__ __device__ __forceinline__ long long block_of(long long u,
                                                       long long T, int G) {
  return ((u + 1) * G + T - 1) / T - 1;
}

// A work item ("triple") p: sequence b, KV head hk and the group gi of
// its query heads h0 .. h0 + rg - 1 (at most kMaxRep of them)
struct Triple {
  int b, hk, h0, rg;
};

__device__ __forceinline__ Triple triple_of(long long p, int Hkv, int rep,
                                            int ng) {
  Triple x;
  const int gi = (int)(p % ng);
  x.b = (int)(p / ((long long)Hkv * ng));
  x.hk = (int)((p / ng) % Hkv);
  x.h0 = x.hk * rep + gi * kMaxRep;
  x.rg = min(kMaxRep, rep - gi * kMaxRep);
  return x;
}

// The work: every triple's slots cut into C chunks, P C units in all, dealt
// to the grid's G blocks in contiguous runs of equal length (G is what the
// card holds at once, so every block is resident from the start and all
// finish together). A run may cover the end of one triple and the start of
// the next: each such segment is walked in chunks with an online softmax
// and leaves one partial state, the k-th of its triple. Lane layout for K
// and V rows: LPR lanes cover a row (VEC columns each, NV 16-byte vectors),
// a warp covers RPW rows at once and owns a quarter of a chunk's rows.
// Each lane copies its own vectors of K and V into a ring of kStages
// chunks in shared memory (cp.async) and reads back only those, so the ring
// needs no barrier and kStages - 1 chunks are in flight while one is used.
// kv_valid may be null: every sequence then has valid_all slots. D is the
// padded width; d (<= D) the cache's own: columns past it are zeros.
template <typename TKV, int D, int REP>
__global__ void __launch_bounds__(kThreads)
decode_split(const void* __restrict__ q, int q_bf16,
             const TKV* __restrict__ k, const TKV* __restrict__ v,
             const int* __restrict__ kv_valid, int valid_all,
             float* __restrict__ part_acc, float* __restrict__ part_m,
             float* __restrict__ part_l, int L, int B, int H, int Hkv,
             int ng, int d, int vec, int C, int kmax, Strides st,
             float scale2) {
  constexpr int LV = 16 / sizeof(TKV);      // elements of a 16-byte vector
  constexpr int NV = vectors_per_lane<TKV, D>();
  constexpr int VEC = LV * NV;              // a lane's columns of a row
  constexpr int LPR = D / VEC;
  constexpr int RPW = rows_per_load<TKV, D>();
  constexpr int CH = chunk_slots<TKV, D>();
  constexpr int IT = CH / (kWarps * RPW);   // loads a lane, per chunk
  constexpr int S = REP < LPR ? REP : LPR;  // lane groups a row's sums split to
  constexpr int QW = (REP + kWarps - 1) / kWarps;   // queries a warp owns
  constexpr int TB = chunk_bytes<TKV, D>();  // a chunk of K (or V) in smem
  static_assert(TB == kThreads * IT * NV * 16, "ring");
  static_assert(LPR * RPW == 32 && CH % 32 == 0 && IT <= 8, "layout");
  static_assert(kWarps * REP * D * 4 <= kStages * 2 * TB, "red fits");
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float ps[2][REP][CH];          // scores, then weights
  __shared__ float cs[2][REP];              // a chunk's rescale of acc

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int c0 = (lane % LPR) * VEC;        // this lane's columns
  const int rl = lane / LPR;                // its row within a warp load
  const int first = w * (CH / kWarps) + rl;   // its first row of a chunk
  const int rep = H / Hkv, G = gridDim.x, j = blockIdx.x;
  const uint32_t ring0 = (uint32_t)__cvta_generic_to_shared(ring) + tid * 16;
  const long long T = (long long)B * Hkv * ng * C;
  const long long u0 = (long long)j * T / G, u1 = (long long)(j + 1) * T / G;
  // bytes of each of this lane's vectors that lie within the row's d
  int nbytes[NV];
#pragma unroll
  for (int n = 0; n < NV; ++n)
    nbytes[n] = max(0, min(LV, d - c0 - n * LV)) * (int)sizeof(TKV);

  for (long long p = u0 / C; p * C < u1; ++p) {   // this run's segments
    const Triple x = triple_of(p, Hkv, rep, ng);
    const int b = x.b, hk = x.hk, rg = x.rg;
    const int kth = j - (int)block_of(p * C, T, G);
    const long long part0 = ((long long)b * H + x.h0) * kmax
                            + kth;        // query r at part0 + r kmax
    float qr[REP][VEC];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const long long off =
          (long long)b * st.qb + (long long)(x.h0 + r) * st.qh;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float y = 0.f;
        if (r < rg && c0 + e < d)
          y = q_bf16 ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(q)[off + c0 + e])
                     : static_cast<const float*>(q)[off + c0 + e];
        qr[r][e] = y * scale2;
      }
    }
    const int valid = min(kv_valid ? kv_valid[b] : valid_all, L);
    const int s_begin = (int)(max(u0, p * C) - p * C) * CH;
    const int s_end = min(valid, (int)(min(u1, (p + 1) * C) - p * C) * CH);
    if (s_end <= s_begin) {     // wholly past kv_valid: an empty state
      if (tid < rg) {
        part_m[part0 + (long long)tid * kmax] = kNegInf;
        part_l[part0 + (long long)tid * kmax] = 0.f;
      }
      continue;
    }

    const TKV* kb = k + (long long)b * st.kb + (long long)hk * st.kh + c0;
    const TKV* vb = v + (long long)b * st.vb + (long long)hk * st.vh + c0;
    // chunk c of the segment into stage c % kStages: this lane's K vectors
    // at ring0 + stage 2 TB + (u NV + n) kThreads 16, its V vectors TB
    // further
    auto fetch = [&](int c) {
      const int cs0 = s_begin + c * CH;
      const uint32_t dst = ring0 + (c % kStages) * 2 * TB;
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        const int row = cs0 + first + u * RPW;
        const bool ok = row < s_end;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          const int nb = ok ? nbytes[n] : 0;
          const uint32_t at = dst + (u * NV + n) * kThreads * 16;
          copy16(at, nb ? kb + (long long)row * st.ks + n * LV : kb, nb, vec);
          copy16(at + TB, nb ? vb + (long long)row * st.vs + n * LV : vb, nb,
                 vec);
        }
      }
    };
    const int n_chunks = (s_end - s_begin + CH - 1) / CH;
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < n_chunks) fetch(c);
      cp_async_commit();        // empty groups keep the count uniform
    }

    float mrun[QW], lrun[QW];               // the owned queries' state
#pragma unroll
    for (int i = 0; i < QW; ++i) {
      mrun[i] = kNegInf;
      lrun[i] = 0.f;
    }
    float acc[REP][VEC];
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;

    for (int c = 0; c < n_chunks; ++c) {
      const int par = c & 1, n = min(CH, s_end - s_begin - c * CH);
      if (c + kStages - 1 < n_chunks) fetch(c + kStages - 1);  // its stage
      cp_async_commit();                                   // was c - 1's
      cp_async_wait<kStages - 1>();                        // chunk c is in
      const uint32_t kst = ring0 + (c % kStages) * 2 * TB;
      // scores of the chunk's rows, in base 2
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        float kf[VEC];
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
          unpack(lds16(kst + (u * NV + nv) * kThreads * 16), kf + nv * LV,
                 TKV());
        float part[REP];
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          float y = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) y = fmaf(qr[r][e], kf[e], y);
          part[r] = y;
        }
        // sum over the row's LPR lanes, scattering the REP sums: at offset
        // off the lanes with that bit set keep the upper half of the
        // values and send the lower half (REP - 1 shuffles, then plain
        // halvings)
        int r0 = 0;
#pragma unroll
        for (int off = LPR / 2, cnt = REP; off > 0; off >>= 1) {
          const bool upper = lane & off;
          if (cnt > 1) {
            cnt /= 2;
#pragma unroll
            for (int i = 0; i < cnt; ++i) {
              const float send = upper ? part[i] : part[i + cnt];
              const float keep = upper ? part[i + cnt] : part[i];
              part[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
            }
            r0 += upper ? cnt : 0;
          } else {
            part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
          }
        }
        const int row = first + u * RPW;
        if (lane % (LPR / S) == 0) {  // holds queries r0 .. r0 + REP / S
#pragma unroll
          for (int i = 0; i < REP / S; ++i)
            ps[par][r0 + i][row] = row < n ? part[i] : kNegInf;
        }
      }
      __syncthreads();

      // the online softmax, one warp per owned query
#pragma unroll
      for (int i = 0; i < QW; ++i) {
        const int r = w + kWarps * i;
        if (r < rg) {
          float y[CH / 32];
          float mx = kNegInf;
#pragma unroll
          for (int e = 0; e < CH / 32; ++e) {
            y[e] = ps[par][r][lane + 32 * e];
            mx = fmaxf(mx, y[e]);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mn = fmaxf(mrun[i], mx);
          const float corr = ex2(mrun[i] - mn);
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < CH / 32; ++e) {
            const float pe = lane + 32 * e < n ? ex2(y[e] - mn) : 0.f;
            ps[par][r][lane + 32 * e] = pe;
            sum += pe;
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          mrun[i] = mn;
          lrun[i] = fmaf(lrun[i], corr, sum);
          if (lane == 0) cs[par][r] = corr;
        }
      }
      __syncthreads();

      // P V: each lane sums its rows' V columns, weighted per query; the
      // other buffer of ps takes the next chunk's scores meanwhile
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float corr = r < rg ? cs[par][r] : 1.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] *= corr;
      }
#pragma unroll
      for (int u = 0; u < IT; ++u) {
        float vf[VEC];
#pragma unroll
        for (int nv = 0; nv < NV; ++nv)
          unpack(lds16(kst + TB + (u * NV + nv) * kThreads * 16),
                 vf + nv * LV, TKV());
        const int row = first + u * RPW;
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float pr = ps[par][r][row];   // 0 past n
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < QW; ++i) {
      const int r = w + kWarps * i;
      if (r < rg && lane == 0) {
        part_m[part0 + (long long)r * kmax] = mrun[i];
        part_l[part0 + (long long)r * kmax] = lrun[i];
      }
    }
    // sum the warp's RPW row groups, then the warps, in the drained ring
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    cp_async_wait<0>();
    __syncthreads();
    float (*red)[REP][D] = reinterpret_cast<float (*)[REP][D]>(ring);
    if (lane < LPR) {
#pragma unroll
      for (int r = 0; r < REP; ++r)
#pragma unroll
        for (int e = 0; e < VEC; ++e) red[w][r][c0 + e] = acc[r][e];
    }
    __syncthreads();
    for (int i = tid; i < rg * d; i += kThreads) {
      const int r = i / d, dd = i % d;
      float y = 0.f;
#pragma unroll
      for (int e = 0; e < kWarps; ++e) y += red[e][r][dd];
      part_acc[(part0 + (long long)r * kmax) * d + dd] = y;
    }
    __syncthreads();            // the next segment refills the ring
  }
}

// ------------------------------------------------ bf16 q and cache: mma

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 accumulate.
// Fragments (lane = 4 g + t): a0 (row g, cols 2t, 2t+1), a1 (row g + 8),
// a2 (row g, cols 8 + 2t, +1), a3 (row g + 8, cols 8 + 2t, +1); b0 (rows
// 2t, 2t+1, col g), b1 (rows 8 + 2t, +1); c0, c1 (row g, cols 2t, 2t+1),
// c2, c3 (row g + 8).
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// Shared memory of the mma kernel: a ring of kMmaStages slices a warp,
// each 16 keys of K then 16 of V at rows of 2 D + 16 bytes (the 16-byte
// pad puts ldmatrix's 8 rows on distinct banks)
template <int D>
__host__ __device__ constexpr int mma_slice_bytes() {
  return 2 * 16 * (2 * D + 16);
}
template <int D>
__host__ __device__ constexpr int mma_ring_bytes() {
  return kMmaStages * kWarps * mma_slice_bytes<D>();
}

// The same split and merge as decode_split, for bfloat16 q and cache, with
// both products on the tensor cores (mma.sync m16n8k16, float32
// accumulate): a group's query heads are rows 0 .. rg - 1 of a 16-row A
// tile (the rest zeros), a 16-key slice of K is B of S = Q K^T and, once
// P is rounded to bf16 in registers, V is B of O += P V (the C layout of
// S is the A layout of P). Products of bf16 values are exact in float32,
// so q is used unscaled and S scaled after. Within a block's segment warp
// w takes the slices w, w + 4, ... with its own online softmax and its own
// ring (cp.async, then __syncwarp: no block barrier in the loop); the four
// warps' states are combined into the segment's partial at its end. D is
// the padded width (a multiple of 16); columns past d are zeros. FULL: d
// is D and every row starts on a 16-byte boundary, so each copy is a whole
// 16-byte vector and the widths are constants (the main path's instance:
// no per-copy arithmetic in the loop).
template <int D, bool FULL>
__global__ void __launch_bounds__(kThreads)
decode_split_mma(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ kv_valid, int valid_all,
                 float* __restrict__ part_acc, float* __restrict__ part_m,
                 float* __restrict__ part_l, int L, int B, int H, int Hkv,
                 int ng, int d_in, int vec, int C, int kmax, Strides st,
                 float scale2) {
  const int d = FULL ? D : d_in;
  constexpr int LDB = 2 * D + 16;           // bytes of a smem row
  constexpr int SL = mma_slice_bytes<D>();
  constexpr int CPR = D / 8;                // 16-byte chunks of a row
  static_assert(D % 16 == 0 && kWarps * 8 * D * 4 + 2 * kWarps * 8 * 4
                <= mma_ring_bytes<D>(), "combine fits");
  extern __shared__ __align__(16) unsigned char ring[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rep = H / Hkv, G = gridDim.x, j = blockIdx.x;
  const uint32_t wring = (uint32_t)__cvta_generic_to_shared(ring)
                         + w * kMmaStages * SL;
  const long long T = (long long)B * Hkv * ng * C;
  const long long u0 = (long long)j * T / G, u1 = (long long)(j + 1) * T / G;
  // this lane's ldmatrix row and column offsets (bytes) in a slice
  const int k_ld = ((lane & 7) + ((lane >> 4) << 3)) * LDB
                   + ((lane >> 3) & 1) * 16;
  const int v_ld = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDB
                   + (lane >> 4) * 16;

  for (long long p = u0 / C; p * C < u1; ++p) {   // this run's segments
    const Triple x = triple_of(p, Hkv, rep, ng);
    const int b = x.b, hk = x.hk, rg = x.rg;
    const int kth = j - (int)block_of(p * C, T, G);
    const long long part0 = ((long long)b * H + x.h0) * kmax
                            + kth;        // query r at part0 + r kmax
    const int valid = min(kv_valid ? kv_valid[b] : valid_all, L);
    const int s_begin = (int)(max(u0, p * C) - p * C) * kMmaChunk;
    const int s_end =
        min(valid, (int)(min(u1, (p + 1) * C) - p * C) * kMmaChunk);
    if (s_end <= s_begin) {     // wholly past kv_valid: an empty state
      if (tid < rg) {
        part_m[part0 + (long long)tid * kmax] = kNegInf;
        part_l[part0 + (long long)tid * kmax] = 0.f;
      }
      continue;
    }

    // Q as A fragments: row g < rg is query head h0 + g; columns past d
    // are zeros (d even: a pair is whole or past it)
    uint32_t qa[D / 16][4];
    {
      const __nv_bfloat16* qg =
          q + (long long)b * st.qb + (long long)(x.h0 + g) * st.qh;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = ks * 16 + 2 * t;
        const bool live = g < rg;
        qa[ks][0] = live && c < d ? pack_bf16(__bfloat162float(qg[c]),
                                              __bfloat162float(qg[c + 1]))
                                  : 0u;
        qa[ks][2] = live && c + 8 < d
                        ? pack_bf16(__bfloat162float(qg[c + 8]),
                                    __bfloat162float(qg[c + 9]))
                        : 0u;
        qa[ks][1] = qa[ks][3] = 0u;
      }
    }

    const __nv_bfloat16* kb = k + (long long)b * st.kb + (long long)hk * st.kh;
    const __nv_bfloat16* vb = v + (long long)b * st.vb + (long long)hk * st.vh;
    const int n_slices = (s_end - s_begin + 15) / 16;
    const int mine = (n_slices - w + kWarps - 1) / kWarps;   // this warp's
    // this warp's i-th slice (segment slice w + 4 i) into stage i % stages
    auto fetch = [&](int i) {
      const int s0 = s_begin + (w + kWarps * i) * 16;
      const uint32_t dst = wring + (i % kMmaStages) * SL;
#pragma unroll
      for (int c = lane; c < 16 * CPR; c += 32) {
        const int row = c / CPR, col = (c % CPR) * 8;
        if constexpr (FULL) {
          const bool ok = s0 + row < s_end;
          const long long r = ok ? s0 + row : 0;
          cp_async16(dst + row * LDB + col * 2, kb + r * st.ks + col,
                     ok ? 16 : 0);
          cp_async16(dst + 16 * LDB + row * LDB + col * 2,
                     vb + r * st.vs + col, ok ? 16 : 0);
        } else {
          const int nb = s0 + row < s_end ? max(0, min(8, d - col)) * 2 : 0;
          const long long r = nb ? s0 + row : 0;
          copy16(dst + row * LDB + col * 2, kb + r * st.ks + (nb ? col : 0),
                 nb, vec);
          copy16(dst + 16 * LDB + row * LDB + col * 2,
                 vb + r * st.vs + (nb ? col : 0), nb, vec);
        }
      }
    };
#pragma unroll
    for (int i = 0; i < kMmaStages - 1; ++i) {
      if (i < mine) fetch(i);
      cp_async_commit();
    }

    float acc[D / 8][4];                    // O, rows g (and padding g+8)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    float m = kNegInf, l = 0.f;             // row g's state; l per lane
    for (int i = 0; i < mine; ++i) {
      __syncwarp();             // every lane is done with slice i - 1
      if (i + kMmaStages - 1 < mine) fetch(i + kMmaStages - 1);
      cp_async_commit();
      cp_async_wait<kMmaStages - 1>();
      __syncwarp();             // and sees the whole of slice i
      const uint32_t ks_base = wring + (i % kMmaStages) * SL;
      const uint32_t vs_base = ks_base + 16 * LDB;
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t kf[4];
        ldsm_x4(kf, ks_base + k_ld + ks * 32);
        mma_bf16(sc[0], qa[ks], kf[0], kf[1]);
        mma_bf16(sc[1], qa[ks], kf[2], kf[3]);
      }
      // row g's four scores: keys 8 n + 2 t + e of the slice
      const int left = s_end - (s_begin + (w + kWarps * i) * 16);
      float xs[4], mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = 8 * n + 2 * t + e < left ? sc[n][e] * scale2
                                                   : kNegInf;
          xs[2 * n + e] = y;
          mx = fmaxf(mx, y);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m, mx), corr = ex2(m - mn);
      m = mn;
      float pr[4], sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[e] = xs[e] > kNegInf ? ex2(xs[e] - mn) : 0.f;
        sum += pr[e];
      }
      l = fmaf(l, corr, sum);
      const uint32_t pa[4] = {pack_bf16(pr[0], pr[1]), 0u,
                              pack_bf16(pr[2], pr[3]), 0u};
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        acc[n][0] *= corr;
        acc[n][1] *= corr;
        acc[n + 1][0] *= corr;
        acc[n + 1][1] *= corr;
        uint32_t vf[4];
        ldsm_x4_trans(vf, vs_base + v_ld + n * 16);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }

    // the four warps' states, combined in the drained ring
    cp_async_wait<0>();
    __syncthreads();
    float* wacc = reinterpret_cast<float*>(ring);   // [kWarps][8][D]
    float* wm = wacc + kWarps * 8 * D;              // [kWarps][8]
    float* wl = wm + kWarps * 8;
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t == 0) {
      wm[w * 8 + g] = m;
      wl[w * 8 + g] = l;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      wacc[(w * 8 + g) * D + 8 * n + 2 * t] = acc[n][0];
      wacc[(w * 8 + g) * D + 8 * n + 2 * t + 1] = acc[n][1];
    }
    __syncthreads();
    for (int i = tid; i < rg * d; i += kThreads) {
      const int r = i / d, dd = i % d;
      float mm = kNegInf;
#pragma unroll
      for (int e = 0; e < kWarps; ++e) mm = fmaxf(mm, wm[e * 8 + r]);
      float ll = 0.f, y = 0.f;
#pragma unroll
      for (int e = 0; e < kWarps; ++e) {
        const float f = wl[e * 8 + r] > 0.f ? ex2(wm[e * 8 + r] - mm) : 0.f;
        ll = fmaf(wl[e * 8 + r], f, ll);
        y = fmaf(wacc[(e * 8 + r) * D + dd], f, y);
      }
      part_acc[(part0 + (long long)r * kmax) * d + dd] = y;
      if (dd == 0) {
        part_m[part0 + (long long)r * kmax] = mm;
        part_l[part0 + (long long)r * kmax] = ll;
      }
    }
    __syncthreads();            // the next segment refills the ring
  }
}

__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// One block per (head, sequence), one thread per column: the merge of the
// head's partial states, written by the blocks whose runs cover its
// triple's units.
// Lane i of every warp reads partial i's maximum and sum (in rounds of 32)
// and hands its weight to the warp by shuffles.
template <typename TQ>
__global__ void decode_merge(const float* __restrict__ part_acc,
                             const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             TQ* __restrict__ o, int B, int H, int Hkv, int D,
                             int ng, int C, int kmax, int G, long long ob,
                             long long oh) {
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x, lane = d & 31;
  const int rep = H / Hkv;
  const long long T = (long long)B * Hkv * ng * C;
  const long long p = ((long long)b * Hkv + h / rep) * ng
                      + (h % rep) / kMaxRep;
  const int first = (int)block_of(p * C, T, G);
  const int n_parts = (int)block_of(p * C + C - 1, T, G) - first + 1;
  const long long p0 = ((long long)b * H + h) * kmax;
  float m = kNegInf, l = 0.f, x = 0.f;
  for (int i0 = 0; i0 < n_parts; i0 += 32) {
    const bool mine = i0 + lane < n_parts;
    const float mi = mine ? part_m[p0 + i0 + lane] : kNegInf;
    const float li = mine ? part_l[p0 + i0 + lane] : 0.f;
    float mr = mi;              // this round's maximum
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, off));
    const float mn = fmaxf(m, mr), corr = ex2(m - mn);
    m = mn;
    // partial i0 + lane's weight; 0 if empty (its acc was never written)
    const float wl = li > 0.f ? ex2(mi - mn) : 0.f;
    l = fmaf(l, corr, li * wl);
    x *= corr;
    const int cnt = min(32, n_parts - i0);
#pragma unroll 8
    for (int i = 0; i < cnt; ++i) {
      const float wi = __shfl_sync(0xffffffffu, wl, i);
      const float a = wi != 0.f && d < D
                          ? part_acc[(p0 + i0 + i) * D + d] : 0.f;
      x = fmaf(a, wi, x);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l += __shfl_xor_sync(0xffffffffu, l, off);
  if (d < D)
    store(x / fmaxf(l, 1e-30f), o + (long long)b * ob + (long long)h * oh + d);
}

struct Args {
  const void* q;
  int q_bf16;
  const void *k, *v;
  const int* valid;             // (B,) or null: valid_all for every sequence
  int valid_all;
  void* o;
  float* scratch;
  int B, L, H, Hkv, D, rep;
  int vec;                      // k and v rows 16-byte aligned
  Strides st;
  float scale;
  cudaStream_t stream;
  long long* need;              // if set: only report the scratch floats
};

// Blocks of a kernel the card holds at once, with `smem` bytes of dynamic
// shared memory (found once a process for each kernel, after its shared
// memory is allowed)
int resident_blocks(const void* kernel, int smem) {
  static const void* kernels[64];
  static int blocks[64];
  static int known = 0;
  for (int i = 0; i < known; ++i)
    if (kernels[i] == kernel) return blocks[i];
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const int n = sms * per_sm > 0 ? sms * per_sm : 1;
  if (known < 64) {
    kernels[known] = kernel;
    blocks[known++] = n;
  }
  return n;
}

// (triple, chunk) units dealt to as many blocks as the card holds at once;
// ng groups of query heads a KV head; kmax bounds the partial states a
// triple can get
struct Plan {
  int C, G, kmax, ng;
  long long parts;              // B H kmax
};

Plan make_plan(const Args& a, int chunk, int resident) {
  Plan pl;
  pl.ng = (a.rep + kMaxRep - 1) / kMaxRep;
  pl.C = (a.L + chunk - 1) / chunk;
  const long long T = (long long)a.B * a.Hkv * pl.ng * pl.C;
  pl.G = (int)(T < resident ? T : resident);
  const long long run = T / pl.G;          // units a block, at least
  pl.kmax = (int)((pl.C + run - 1) / run) + 1;
  pl.parts = (long long)a.B * a.H * pl.kmax;
  return pl;
}

int merge(const Args& a, const Plan& pl, const float* acc, const float* pm,
          const float* pls) {
  cudaError_t err = cudaGetLastError();    // the split launch
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.H, a.B);
  const int threads = (a.D + 31) / 32 * 32;  // whole warps: it shuffles
  if (a.q_bf16)
    decode_merge<__nv_bfloat16><<<grid, threads, 0, a.stream>>>(
        acc, pm, pls, static_cast<__nv_bfloat16*>(a.o), a.B, a.H, a.Hkv, a.D,
        pl.ng, pl.C, pl.kmax, pl.G, a.st.ob, a.st.oh);
  else
    decode_merge<float><<<grid, threads, 0, a.stream>>>(
        acc, pm, pls, static_cast<float*>(a.o), a.B, a.H, a.Hkv, a.D, pl.ng,
        pl.C, pl.kmax, pl.G, a.st.ob, a.st.oh);
  return (int)cudaGetLastError();
}

// the scratch: (parts, d) partial sums, then parts maxima and parts sums
template <typename Kernel>
int run(const Args& a, const Plan& pl, Kernel kernel, int smem) {
  if (a.need) {
    *a.need = pl.parts * (a.D + 2);
    return 0;
  }
  float* acc = a.scratch;
  float* pm = acc + pl.parts * a.D;
  float* pls = pm + pl.parts;
  kernel(acc, pm, pls, smem);
  return merge(a, pl, acc, pm, pls);
}

template <typename TKV, int D, int REP>
int launch(const Args& a) {
  const Plan pl = make_plan(
      a, chunk_slots<TKV, D>(),
      resident_blocks((const void*)decode_split<TKV, D, REP>,
                      ring_bytes<TKV, D>()));
  return run(a, pl, [&](float* acc, float* pm, float* pls, int smem) {
    decode_split<TKV, D, REP><<<pl.G, kThreads, smem, a.stream>>>(
        a.q, a.q_bf16, static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v), a.valid, a.valid_all, acc, pm, pls,
        a.L, a.B, a.H, a.Hkv, pl.ng, a.D, a.vec, pl.C, pl.kmax, a.st,
        a.scale * kLog2e);
  }, ring_bytes<TKV, D>());
}

template <int D, bool FULL>
int launch_mma(const Args& a) {
  const Plan pl = make_plan(
      a, kMmaChunk,
      resident_blocks((const void*)decode_split_mma<D, FULL>,
                      mma_ring_bytes<D>()));
  return run(a, pl, [&](float* acc, float* pm, float* pls, int smem) {
    decode_split_mma<D, FULL><<<pl.G, kThreads, smem, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.k),
        static_cast<const __nv_bfloat16*>(a.v), a.valid, a.valid_all, acc, pm,
        pls, a.L, a.B, a.H, a.Hkv, pl.ng, a.D, a.vec, pl.C, pl.kmax, a.st,
        a.scale * kLog2e);
  }, mma_ring_bytes<D>());
}

// the query heads a block holds (a group: at most kMaxRep), rounded up to
// a power of two
template <typename TKV, int D>
int by_rep(const Args& a) {
  if (a.rep <= 1) return launch<TKV, D, 1>(a);
  if (a.rep <= 2) return launch<TKV, D, 2>(a);
  if (a.rep <= 4) return launch<TKV, D, 4>(a);
  return launch<TKV, D, 8>(a);
}

// bfloat16 q and cache up to D = 128 take the tensor cores, at the next
// multiple-of-16 width built; every other input the CUDA cores, at the
// next power of two
template <typename TKV>
int by_dim(const Args& a) {
  if constexpr (sizeof(TKV) == 2) {
    if (a.q_bf16 && a.D <= 128) {
#define REPRO_DECODE_MMA(W)                                   \
      if (a.D == W && a.vec) return launch_mma<W, true>(a);   \
      if (a.D <= W) return launch_mma<W, false>(a);
      REPRO_DECODE_MMA(16)
      REPRO_DECODE_MMA(32)
      REPRO_DECODE_MMA(48)
      REPRO_DECODE_MMA(64)
      REPRO_DECODE_MMA(80)
      REPRO_DECODE_MMA(96)
      REPRO_DECODE_MMA(128)
#undef REPRO_DECODE_MMA
    }
  }
  if (a.D <= 16) return by_rep<TKV, 16>(a);
  if (a.D <= 32) return by_rep<TKV, 32>(a);
  if (a.D <= 64) return by_rep<TKV, 64>(a);
  if (a.D <= 128) return by_rep<TKV, 128>(a);
  return by_rep<TKV, 256>(a);
}

int dispatch(int kv_dtype, const Args& a) {
  if (a.B <= 0 || a.L <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 ||
      a.D <= 0 || a.D % 4 != 0 || a.D > 256 || a.B > 65535 ||
      a.Hkv > 65535 || a.H > 65535 || (a.q_bf16 != 0 && a.q_bf16 != 1))
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 0) return by_dim<float>(a);
  if (kv_dtype == 1) return by_dim<__nv_bfloat16>(a);
  if (kv_dtype == 2) return by_dim<__nv_fp8_e4m3>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Float32 scratch a launch at these sizes needs: (B, H, kmax, D) partial
// sums, then (B, H, kmax) maxima and (B, H, kmax) sums, kmax the most
// partial states a triple can have; the larger of the two plans, rows on
// 16-byte boundaries or not (their kernels may hold other block counts).
long long decode_attention_scratch_floats(int B, int L, int H, int Hkv,
                                          int D, int q_dtype, int kv_dtype) {
  long long most = -1;
  for (int vec = 0; vec < 2; ++vec) {
    long long need = -1;
    const Args a{nullptr, q_dtype, nullptr, nullptr, nullptr, 0, nullptr,
                 nullptr, B, L, H, Hkv, D, Hkv > 0 ? H / Hkv : 0, vec,
                 Strides{}, 1.f, nullptr, &need};
    if (dispatch(kv_dtype, a) != 0) return -1;
    most = need > most ? need : most;
  }
  return most;
}

// q (B, 1, H, D) and o (B, 1, H, D) of q_dtype (0 float32, 1 bfloat16);
// k/v (B, L, Hkv, D) of kv_dtype (0 float32, 1 bfloat16, 2 fp8 e4m3);
// kv_valid (B,) int32 on the device, or null for valid_all slots in every
// sequence; scratch of decode_attention_scratch_floats floats. `layout`
// holds B, L, H, Hkv, D, q_dtype, kv_dtype and the strides in elements
// q (b, h), k (b, s, h), v (b, s, h), o (b, h) (last dims contiguous); D a
// multiple of 4 up to 256, any H / Hkv. vec: k and v rows start on 16-byte
// boundaries (else on 4-byte ones). Two launches: the stretches, then the
// merge.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_valid, int valid_all, void* o,
                            void* scratch, const long long* layout, int vec,
                            float scale, void* stream) {
  const long long* x = layout;
  const Args a{q, (int)x[5], k, v, static_cast<const int*>(kv_valid),
               valid_all, o, static_cast<float*>(scratch), (int)x[0],
               (int)x[1], (int)x[2], (int)x[3], (int)x[4],
               x[3] > 0 ? (int)(x[2] / x[3]) : 0, vec,
               Strides{x[7], x[8], x[9], x[10], x[11], x[12], x[13], x[14],
                       x[15], x[16]},
               scale, static_cast<cudaStream_t>(stream), nullptr};
  return dispatch((int)x[6], a);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
