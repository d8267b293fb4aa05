// Flash attention backward: dq, dk and dv of causal, windowed or full GQA
// attention from the forward's output and row log-sum-exp; the (Sq, Sk)
// score matrix is recomputed tile by tile and never stored.
//
// Replaces no Pallas kernel: the reference computes its backward in XLA
// (src/repro/models/flash_ref.py:110 flash_bwd, the custom_vjp's bwd), and
// the port ran that computation as plain torch over (1024 x 1024) float32
// chunk tensors (models/flash_ref.py flash_backward, which stays as the CPU
// path and the oracle). The same function, on this card:
//
//   delta = rowsum(dout * out)                     (float32, (B, H, Sq))
//   S = q k^T scale,  P = exp(S - lse)             (masked: P = 0)
//   dv = P^T dout,  dP = dout v^T,  dS = P (dP - delta) scale
//   dk = dS^T q,    dq = dS k
//
// (the tensor-core kernels take the scale out of dS and apply it to dk and
// dq once, at the end).
//
// Three launches, no atomics: a block owns every output row it writes and
// sums over the other axis in a fixed order, so the same inputs give
// bitwise the same gradients on every call.
//   1. bwd_delta: eight lanes a (b, h, query) row; it writes the row's
//      stats {lse log2 e, delta} as one float2, so a tile's rows come in by
//      one copy and P = 2^(S scale log2 e - lse log2 e) is one FMA and ex2.
//   2. dk / dv: one block a (key tile of 64, KV head, batch row), four
//      warps of 16 keys. It holds its K and V tile in shared memory and
//      walks the rep query heads of its KV head, and for each the query
//      tiles that see the tile, in ascending order, recomputing S, P, dP
//      and dS per tile; dk and dv sum in registers across the whole walk
//      (GQA's heads included) and are written once.
//   3. dq: one block a (query tile of 128, query head, batch row), eight
//      warps of 16 queries, walking the key tiles of 64 its rows see in
//      ascending order; dq sums in registers and is written once. It
//      recomputes S and dP (two of its three products) rather than share
//      P or dS with the dk / dv blocks through device memory or atomics.
// Tile pairs wholly outside the mask are never visited (the plain
// version's _pairs skip); under a causal mask the heaviest tiles start
// first (tile_of). The queries start at position 0; Sq != Sk is
// allowed. Inputs are read in the (B, S, H, D) layout through their
// strides (the last dim contiguous); nothing is padded in device memory:
// D is padded to the kernel's width DP with zeros in shared memory, and a
// ragged tile's rows past Sq or Sk load as zeros and are masked.
//
// Bound on the H100 at smollm-360m's training microbatch (B 4, S 4096, 15
// query / 5 KV heads, D 64, bf16, causal): the five products over the
// S (S + 1) / 2 visible pairs are 3.2e11 FLOP, 0.33 ms at 989 TFLOP/s
// bf16, against 40 MB read and written (0.012 ms): operations bound it.
// This design issues seven products (S and dP twice), 4.5e11 FLOP.
//
// * bfloat16, D <= 128: every product on the tensor cores
//   (mma.sync.m16n8k16 bf16 -> float32), operands from shared memory by
//   ldmatrix (.trans for the operands stored k-major: dout and q in the
//   dk / dv block, k in the dq block), rows padded by 16 bytes so
//   ldmatrix's eight rows fall on distinct banks. A warp owns 16 keys (dk /
//   dv) or 16 queries (dq). P and dS leave the float32 accumulators as
//   bf16 A fragments in registers (the C layout of S^T is the A layout of
//   P^T), so they are rounded to bf16 before their products, as the
//   forward rounds P. The streamed tiles (q, dout and the rows' stats in
//   the dk / dv block; k and v in the dq block) are double-buffered with
//   cp.async (16-byte copies where every row starts on a 16-byte
//   boundary, element copies otherwise). The dk / dv block streams 64
//   queries a tile at DP <= 64 and 32 above, which keeps its four
//   accumulators (S^T, dP^T, dk, dv) in registers. Block shapes chosen by
//   timing at smollm's microbatch (PERF.md): a dk / dv block of eight
//   warps (128 keys) fits one block an SM and ran 16% slower; 32-query
//   steps at DP 64 ran 12% slower; keeping P^T only as bf16 fragments ran
//   4% slower; the dq block gained 7% from eight warps (half the K and V
//   copies).
// * float32 (any D) and bfloat16 with D > 128: both products of each pass
//   as float32 FMAs on the CUDA cores, tiles of 32 keys and 32 queries held
//   in float32 in shared memory (16 x 8 threads, each 2 rows x 4 columns of
//   S and dP, then 2 rows x DP / 8 columns of the gradients), P^T and dS^T
//   (or dS) through shared memory. Exact to float32 up to summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // the CUDA-core kernels' blocks
constexpr int kKvWarps = 4;     // a tensor-core dk / dv block
constexpr int kQWarps = 8;      // a tensor-core dq block
constexpr int KB = 16 * kKvWarps;   // keys a dk / dv block (16 a warp)
constexpr int QT = 16 * kQWarps;    // queries a dq block (16 a warp)
constexpr int KT = 64;          // keys a dq step
constexpr int CT = 32;          // keys and queries a tile on the CUDA cores
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {                // elements; the head-dim stride is 1
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh, gb, gs, gh,
      dqb, dqs, dqh, dkb, dks, dkh, dvb, dvs, dvh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool visible(int row, int key, int sq, int sk,
                                        int causal, int window) {
  bool ok = key < sk && row < sq;
  if (causal) {
    ok = ok && key <= row;
    if (window > 0) ok = ok && key > row - window;
  }
  return ok;
}

// A block's (tile, head, batch row). The grid is one flat axis with the
// tile slowest, so under a causal mask the heaviest tiles of every (head,
// batch row) start first and the light ones fill the tail: key tiles
// ascending for dk / dv (key tile 0 is seen by every query), query tiles
// descending for dq (reversed). Heads vary fastest: neighbouring dq blocks
// share a KV head's K and V in L2.
struct Tile {
  int tile, h, b;
};
__device__ __forceinline__ Tile tile_of(int heads, int B, bool reversed) {
  const int per = heads * B;
  const int i = blockIdx.x / per, r = blockIdx.x % per;
  return Tile{reversed ? (int)gridDim.x / per - 1 - i : i, r % heads,
              r / heads};
}

// ------------------------------------------------ delta = rowsum(dout out)

// eight lanes a row of the (B, H, Sq) stats, 16 bytes a lane a step where
// every row starts on a 16-byte boundary (vec), elements otherwise
template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ g,
          const float* __restrict__ lse, float2* __restrict__ stats,
          long long rows, int sq, int H, int d, Strides st, int vec) {
  constexpr int E = 16 / sizeof(T);         // elements in 16 bytes
  const long long row = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int lane = threadIdx.x & 7;
  const bool live = row < rows;   // no early exit: the shuffles take all 32
  const int i = live ? (int)(row % sq) : 0;
  const long long bh = live ? row / sq : 0;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* op = o + b * st.ob + (long long)i * st.os + h * st.oh;
  const T* gp = g + b * st.gb + (long long)i * st.gs + h * st.gh;
  float s = 0.f;
  for (int c = lane * E; live && c < d; c += 8 * E) {
    if (vec && c + E <= d) {
      const uint4 a = *reinterpret_cast<const uint4*>(op + c);
      const uint4 z = *reinterpret_cast<const uint4*>(gp + c);
      const T* x = reinterpret_cast<const T*>(&a);
      const T* y = reinterpret_cast<const T*>(&z);
#pragma unroll
      for (int e = 0; e < E; ++e) s = fmaf(to_f(x[e]), to_f(y[e]), s);
    } else {
      for (int e = 0; e < E && c + e < d; ++e)
        s = fmaf(to_f(op[c + e]), to_f(gp[c + e]), s);
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off, 8);
  if (live && lane == 0) stats[row] = make_float2(lse[row] * kLog2e, s);
}

// ------------------------------------------------ bfloat16: mma.sync

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
// the A fragment of k-step kk from a 16 x (8 n) accumulator in C layout
// (n-tiles 2 kk and 2 kk + 1), rounded to bf16
template <int N>
__device__ __forceinline__ void a_frag(uint32_t* a, const float (&c)[N][4],
                                       int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

template <int DP>
struct Mma {
  static_assert(DP % 16 == 0 && DP <= 128, "DP: a multiple of 16 up to 128");
  static constexpr int LDB = 2 * DP + 16;       // bytes a shared row
  static constexpr int BQ = DP <= 64 ? 64 : 32;  // queries a dk / dv step
  static constexpr int KV_BYTES = 2 * KB * LDB;  // the dk / dv block's K, V
  // a dk / dv stage: q and dout tiles, then the rows' stats
  static constexpr int STAGE = 2 * BQ * LDB + BQ * 8;
  static constexpr int DKDV_BYTES = KV_BYTES + 2 * STAGE;
  // the dq block: its q and dout tiles, then two stages of K and V
  static constexpr int DQ_STAGE = 2 * KT * LDB;
  static constexpr int DQ_BYTES = 2 * QT * LDB + 2 * DQ_STAGE;
};

// rows [r0, r0 + R) of a (n, d) bf16 slice with row stride rs into shared
// rows of LDB bytes, DP columns: 16-byte cp.async copies when every row
// starts on a 16-byte boundary (vec), element copies otherwise; columns
// past d and rows past n are zeros
template <int DP, int R, int NT>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const __nv_bfloat16* g,
                                          long long rs, int r0, int n, int d,
                                          int vec) {
  constexpr int LDB = Mma<DP>::LDB, CPR = DP / 8;
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8, row = r0 + r;
    const int nb = row < n ? max(0, min(8, d - c)) * 2 : 0;
    unsigned char* at = dst + r * LDB + c * 2;
    const __nv_bfloat16* src = nb ? g + (long long)row * rs + c : g;
    if (vec) {
      cp_async16(smem_u32(at), src, nb);
    } else {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = (4 * e < nb ? (uint32_t)s[2 * e] : 0u)
               | ((4 * e + 2 < nb ? (uint32_t)s[2 * e + 1] : 0u) << 16);
      *reinterpret_cast<uint4*>(at) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// n rows' stats from src (entries past `valid` zeros) into shared memory
__device__ __forceinline__ void load_stats(float2* dst, const float2* src,
                                           int n, int valid) {
  for (int j = threadIdx.x; j < n; j += 32 * kKvWarps)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_u32(dst + j)), "l"(j < valid ? src + j : src),
                    "r"(j < valid ? 8 : 0) : "memory");
}

// ldmatrix lane offsets (bytes) into a tile of LDB-byte rows: an A operand
// (16 rows x 16 columns), a pair of B n-tiles stored n-major ([n][k]: no
// transpose) and a pair stored k-major ([k][n]: .trans)
struct LdOffsets {
  int a, b, bt;
  __device__ LdOffsets(int lane, int ldb)
      : a((lane & 15) * ldb + (lane >> 4) * 16),
        b(((lane & 7) + ((lane >> 4) << 3)) * ldb + ((lane >> 3) & 1) * 16),
        bt(((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + (lane >> 4) * 16) {}
};

// dk and dv of one (key tile, KV head, batch row). At DP <= 64 the
// registers are held to three blocks an SM (its 56 KB of shared memory
// would take four)
template <int DP>
__global__ void __launch_bounds__(32 * kKvWarps, DP <= 64 ? 3 : 1)
bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q,
             const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v,
             const __nv_bfloat16* __restrict__ g,
             const float2* __restrict__ stats,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             int B, int sq, int sk, int H, int Hkv, int rep, int d,
             Strides st, float scale, int causal, int window, int vec) {
  using M = Mma<DP>;
  constexpr int LDB = M::LDB, BQ = M::BQ, NQ = BQ / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + KB * LDB;
  unsigned char* stages = smem + M::KV_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const Tile x = tile_of(Hkv, B, false);
  const int k0 = x.tile * KB, hk = x.h, b = x.b;
  const int kmax = min(sk, k0 + KB) - 1;
  // the queries that see a key of this tile: [q_lo, q_hi)
  int q_lo = 0, q_hi = sq;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(sq, kmax + window);
  }
  const int t_first = q_lo / BQ;
  const int n_qt = q_hi > q_lo ? (q_hi + BQ - 1) / BQ - t_first : 0;
  const int items = rep * n_qt;     // (query head, query tile), in order

  auto fetch = [&](int i) {
    unsigned char* s = stages + (i & 1) * M::STAGE;
    const int h = hk * rep + i / n_qt, qt0 = (t_first + i % n_qt) * BQ;
    load_tile<DP, BQ, 32 * kKvWarps>(s, q + b * st.qb + h * st.qh, st.qs,
                                     qt0, sq, d, vec);
    load_tile<DP, BQ, 32 * kKvWarps>(s + BQ * LDB, g + b * st.gb + h * st.gh,
                                     st.gs, qt0, sq, d, vec);
    load_stats(reinterpret_cast<float2*>(s + 2 * BQ * LDB),
               stats + ((long long)b * H + h) * sq + qt0, BQ, sq - qt0);
  };
  load_tile<DP, KB, 32 * kKvWarps>(Ks, k + b * st.kb + hk * st.kh, st.ks,
                                   k0, sk, d, vec);
  load_tile<DP, KB, 32 * kKvWarps>(Vs, v + b * st.vb + hk * st.vh, st.vs,
                                   k0, sk, d, vec);
  if (items > 0) fetch(0);
  cp_async_commit();

  const LdOffsets off(lane, LDB);
  const uint32_t ks_u = smem_u32(Ks) + 16 * w * LDB + off.a;
  const uint32_t vs_u = smem_u32(Vs) + 16 * w * LDB + off.a;
  const float scale2 = scale * kLog2e;
  const int key0 = k0 + 16 * w + gr;          // this lane's keys: +0, +8
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int i = 0; i < items; ++i) {
    if (i + 1 < items) fetch(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                // tile i is in for every warp
    unsigned char* s = stages + (i & 1) * M::STAGE;
    const uint32_t qs_u = smem_u32(s), gs_u = qs_u + BQ * LDB;
    const float2* sts = reinterpret_cast<const float2*>(s + 2 * BQ * LDB);
    const int qt0 = (t_first + i % n_qt) * BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float sc[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks_u + kd * 32);
      ldsm_x4(va, vs_u + kd * 32);
#pragma unroll
      for (int nn = 0; nn < BQ / 16; ++nn) {
        uint32_t qf[4], gf[4];
        ldsm_x4(qf, qs_u + 16 * nn * LDB + off.b + kd * 32);
        ldsm_x4(gf, gs_u + 16 * nn * LDB + off.b + kd * 32);
        mma_bf16(sc[2 * nn], ka, qf[0], qf[1]);
        mma_bf16(sc[2 * nn + 1], ka, qf[2], qf[3]);
        mma_bf16(dp[2 * nn], va, gf[0], gf[1]);
        mma_bf16(dp[2 * nn + 1], va, gf[2], gf[3]);
      }
    }
    // P^T = exp(S^T - lse), dS^T / scale = P^T (dP^T - delta); a tile
    // every pair of which is visible needs no mask
    const bool whole = k0 + KB <= sk && qt0 + BQ <= sq &&
        (!causal || (k0 + KB - 1 <= qt0 &&
                     (window <= 0 || k0 > qt0 + BQ - 1 - window)));
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      // {lse log2 e, delta} of columns 8 n + 2 t and 8 n + 2 t + 1
      const float4 c2 = *reinterpret_cast<const float4*>(sts + 8 * n + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * t + (e & 1);
        const bool ok = whole || visible(qt0 + col, key0 + 8 * (e >> 1), sq,
                                         sk, causal, window);
        const float p = ok ? ex2(fmaf(sc[n][e], scale2,
                                      -((e & 1) ? c2.z : c2.x)))
                           : 0.f;
        sc[n][e] = p;
        dp[n][e] = p * (dp[n][e] - ((e & 1) ? c2.w : c2.y));
      }
    }
    // dV += P^T dO and dK += dS^T Q, P^T and dS^T as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      a_frag(pa, sc, kk);
      a_frag(da, dp, kk);
#pragma unroll
      for (int nd = 0; nd < DP / 16; ++nd) {
        uint32_t gf[4], qf[4];
        ldsm_x4_trans(gf, gs_u + 16 * kk * LDB + off.bt + nd * 32);
        ldsm_x4_trans(qf, qs_u + 16 * kk * LDB + off.bt + nd * 32);
        mma_bf16(dva[2 * nd], pa, gf[0], gf[1]);
        mma_bf16(dva[2 * nd + 1], pa, gf[2], gf[3]);
        mma_bf16(dka[2 * nd], da, qf[0], qf[1]);
        mma_bf16(dka[2 * nd + 1], da, qf[2], qf[3]);
      }
    }
    __syncthreads();                // every warp is done with tile i
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = key0 + 8 * hr;
    if (key >= sk) continue;
    __nv_bfloat16* kd = dk + b * st.dkb + (long long)key * st.dks
                        + hk * st.dkh;
    __nv_bfloat16* vd = dv + b * st.dvb + (long long)key * st.dvs
                        + hk * st.dvh;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < d) {                  // d even: both columns or none
        *reinterpret_cast<__nv_bfloat162*>(kd + col) = __floats2bfloat162_rn(
            dka[n][2 * hr] * scale, dka[n][2 * hr + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vd + col) =
            __floats2bfloat162_rn(dva[n][2 * hr], dva[n][2 * hr + 1]);
      }
    }
  }
}

// dq of one (query tile, query head, batch row). At DP <= 64 the registers
// are held to two blocks an SM, as many as its shared memory takes
template <int DP>
__global__ void __launch_bounds__(32 * kQWarps, DP <= 64 ? 2 : 1)
bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const __nv_bfloat16* __restrict__ g,
           const float2* __restrict__ stats,
           __nv_bfloat16* __restrict__ dq, int B, int sq, int sk, int H,
           int rep, int d, Strides st, float scale, int causal, int window,
           int vec) {
  using M = Mma<DP>;
  constexpr int LDB = M::LDB, NK = KT / 8, ND = DP / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* Gs = smem + QT * LDB;
  unsigned char* stages = smem + 2 * QT * LDB;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int gr = lane >> 2, t = lane & 3;
  const Tile x = tile_of(H, B, true);
  const int q0 = x.tile * QT, h = x.h, b = x.b, hk = h / rep;
  const int qmax = min(sq, q0 + QT) - 1;
  // the keys this tile's queries see: [k_lo, k_hi)
  int k_lo = 0, k_hi = sk;
  if (causal) {
    k_hi = min(sk, qmax + 1);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_first = k_lo / KT;
  const int n_kt = k_hi > k_lo ? (k_hi + KT - 1) / KT - t_first : 0;

  const __nv_bfloat16* kb = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + hk * st.vh;
  auto fetch = [&](int j) {
    unsigned char* s = stages + (j & 1) * M::DQ_STAGE;
    const int kt0 = (t_first + j) * KT;
    load_tile<DP, KT, 32 * kQWarps>(s, kb, st.ks, kt0, sk, d, vec);
    load_tile<DP, KT, 32 * kQWarps>(s + KT * LDB, vb, st.vs, kt0, sk, d,
                                    vec);
  };
  load_tile<DP, QT, 32 * kQWarps>(Qs, q + b * st.qb + h * st.qh, st.qs, q0,
                                  sq, d, vec);
  load_tile<DP, QT, 32 * kQWarps>(Gs, g + b * st.gb + h * st.gh, st.gs, q0,
                                  sq, d, vec);
  if (n_kt > 0) fetch(0);
  cp_async_commit();

  const int row0 = q0 + 16 * w + gr;          // this lane's rows: +0, +8
  float2 rs[2];                                // {lse log2 e, delta}
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    rs[hr] = row < sq ? stats[((long long)b * H + h) * sq + row]
                      : make_float2(0.f, 0.f);
  }
  const LdOffsets off(lane, LDB);
  const uint32_t qs_u = smem_u32(Qs) + 16 * w * LDB + off.a;
  const uint32_t gs_u = smem_u32(Gs) + 16 * w * LDB + off.a;
  const float scale2 = scale * kLog2e;
  float dqa[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) fetch(j + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t k_u = smem_u32(stages + (j & 1) * M::DQ_STAGE);
    const uint32_t v_u = k_u + KT * LDB;
    const int kt0 = (t_first + j) * KT;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      uint32_t qa[4], ga[4];
      ldsm_x4(qa, qs_u + kd * 32);
      ldsm_x4(ga, gs_u + kd * 32);
#pragma unroll
      for (int nn = 0; nn < KT / 16; ++nn) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, k_u + 16 * nn * LDB + off.b + kd * 32);
        ldsm_x4(vf, v_u + 16 * nn * LDB + off.b + kd * 32);
        mma_bf16(sc[2 * nn], qa, kf[0], kf[1]);
        mma_bf16(sc[2 * nn + 1], qa, kf[2], kf[3]);
        mma_bf16(dp[2 * nn], ga, vf[0], vf[1]);
        mma_bf16(dp[2 * nn + 1], ga, vf[2], vf[3]);
      }
    }
    const bool whole = kt0 + KT <= sk && q0 + QT <= sq &&
        (!causal || (kt0 + KT - 1 <= q0 &&
                     (window <= 0 || kt0 > q0 + QT - 1 - window)));
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const bool ok = whole || visible(row0 + 8 * hr,
                                         kt0 + 8 * n + 2 * t + (e & 1), sq,
                                         sk, causal, window);
        const float p = ok ? ex2(fmaf(sc[n][e], scale2, -rs[hr].x)) : 0.f;
        dp[n][e] = p * (dp[n][e] - rs[hr].y);      // dS / scale
      }
    // dQ += dS K, dS as bf16 A fragments, K read k-major (.trans)
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t da[4];
      a_frag(da, dp, kk);
#pragma unroll
      for (int nd = 0; nd < DP / 16; ++nd) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, k_u + 16 * kk * LDB + off.bt + nd * 32);
        mma_bf16(dqa[2 * nd], da, kf[0], kf[1]);
        mma_bf16(dqa[2 * nd + 1], da, kf[2], kf[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row >= sq) continue;
    __nv_bfloat16* dst = dq + b * st.dqb + (long long)row * st.dqs
                         + h * st.dqh;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(
            dqa[n][2 * hr] * scale, dqa[n][2 * hr + 1] * scale);
    }
  }
}

// ------------------------------------------------ CUDA cores

// rows [r0, r0 + CT) of a (n, d) slice with row stride rs into float32
// shared rows of DP + 4: 16-byte cp.async copies of four floats when T is
// float and every row start is 16-byte aligned (vec), element by element
// (converted to float32) otherwise; columns past d and rows >= n are zeros
template <typename T, int DP>
__device__ __forceinline__ void load_rows(float* s, const T* g, long long rs,
                                          int r0, int n, int d, int vec) {
  constexpr int LD = DP + 4, PER_ROW = DP / 4;
  for (int idx = threadIdx.x; idx < CT * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 4, row = r0 + r;
    float* dst = s + r * LD + c;
    if (row < n && c < d) {               // d is a multiple of 4
      const T* src = g + (long long)row * rs + c;
      if (sizeof(T) == 4 && vec) {
        cp_async16(smem_u32(dst), src, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = to_f(src[e]);
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int DP>
__host__ __device__ constexpr int core_bytes() {
  return (4 * CT * (DP + 4) + 2 * CT * (CT + 1) + 2 * CT) * 4;
}

// Two products of the same rows: X A^T and Y B^T over DP, thread (ty, tx)
// of 16 x 8 computing rows ty + 16 a of X / Y against rows tx + 8 j of A /
// B (each a CT x (DP + 4) float32 tile)
template <int DP>
__device__ __forceinline__ void two_products(
    const float* X, const float* A, const float* Y, const float* Bm, int ty,
    int tx, float (&s)[2][4], float (&p)[2][4]) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[a][j] = p[a][j] = 0.f;
  for (int d0 = 0; d0 < DP; d0 += 4) {
    float4 x[2], y[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      x[a] = *reinterpret_cast<const float4*>(X + (ty + 16 * a) * LD + d0);
      y[a] = *reinterpret_cast<const float4*>(Y + (ty + 16 * a) * LD + d0);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 av =
          *reinterpret_cast<const float4*>(A + (tx + 8 * j) * LD + d0);
      const float4 bv =
          *reinterpret_cast<const float4*>(Bm + (tx + 8 * j) * LD + d0);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        s[a][j] = dot4(x[a], av, s[a][j]);
        p[a][j] = dot4(y[a], bv, p[a][j]);
      }
    }
  }
}

// dk and dv of one (key tile of CT, KV head, batch row). Shared: K, V, Q,
// dO (float32 CT x (DP + 4)), P^T and dS^T (CT x (CT + 1)), the rows'
// stats.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_core(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ g,
              const float2* __restrict__ stats,
              T* __restrict__ dk, T* __restrict__ dv, int B, int sq, int sk,
              int H, int Hkv, int rep, int d, Strides st, float scale,
              int causal, int window, int vec) {
  constexpr int LD = DP + 4, CW = DP / 8, PS = CT + 1;
  extern __shared__ __align__(16) float smf[];
  float* Ks = smf;
  float* Vs = Ks + CT * LD;
  float* Qs = Vs + CT * LD;
  float* Gs = Qs + CT * LD;
  float* Ps = Gs + CT * LD;
  float2* sts = reinterpret_cast<float2*>(Ps + 2 * CT * PS);
  float* Ds = Ps + CT * PS;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const Tile x = tile_of(Hkv, B, false);
  const int k0 = x.tile * CT, hk = x.h, b = x.b;
  const int kmax = min(sk, k0 + CT) - 1;
  int q_lo = 0, q_hi = sq;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(sq, kmax + window);
  }
  const int t_first = q_lo / CT;
  const int n_qt = q_hi > q_lo ? (q_hi + CT - 1) / CT - t_first : 0;
  const float scale2 = scale * kLog2e;
  load_rows<T, DP>(Ks, k + b * st.kb + hk * st.kh, st.ks, k0, sk, d, vec);
  load_rows<T, DP>(Vs, v + b * st.vb + hk * st.vh, st.vs, k0, sk, d, vec);

  float dka[2][CW], dva[2][CW];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < CW; ++c) dka[a][c] = dva[a][c] = 0.f;

  for (int i = 0; i < rep * n_qt; ++i) {
    const int h = hk * rep + i / n_qt, qt0 = (t_first + i % n_qt) * CT;
    __syncthreads();              // the last tile's reads are done
    load_rows<T, DP>(Qs, q + b * st.qb + h * st.qh, st.qs, qt0, sq, d, vec);
    load_rows<T, DP>(Gs, g + b * st.gb + h * st.gh, st.gs, qt0, sq, d, vec);
    if (tid < CT)
      sts[tid] = qt0 + tid < sq ? stats[((long long)b * H + h) * sq + qt0
                                        + tid]
                                : make_float2(0.f, 0.f);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[2][4], dp[2][4];      // keys ty + 16 a, queries tx + 8 j
    two_products<DP>(Ks, Qs, Vs, Gs, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 8 * j;
        const float p = visible(qt0 + col, k0 + ty + 16 * a, sq, sk, causal,
                                window)
                            ? exp2f(fmaf(s[a][j], scale2, -sts[col].x)) : 0.f;
        Ps[(ty + 16 * a) * PS + col] = p;
        Ds[(ty + 16 * a) * PS + col] = p * (dp[a][j] - sts[col].y) * scale;
      }
    __syncthreads();
    for (int qq = 0; qq < CT; ++qq) {
      const float* gr = Gs + qq * LD + tx;
      const float* qr = Qs + qq * LD + tx;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float pv = Ps[(ty + 16 * a) * PS + qq];
        const float dv_ = Ds[(ty + 16 * a) * PS + qq];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          dva[a][c] = fmaf(pv, gr[8 * c], dva[a][c]);
          dka[a][c] = fmaf(dv_, qr[8 * c], dka[a][c]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= sk) continue;
    T* kd = dk + b * st.dkb + (long long)key * st.dks + hk * st.dkh;
    T* vd = dv + b * st.dvb + (long long)key * st.dvs + hk * st.dvh;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (tx + 8 * c < d) {
        from_f(dka[a][c], kd + tx + 8 * c);
        from_f(dva[a][c], vd + tx + 8 * c);
      }
  }
}

// dq of one (query tile of CT, query head, batch row). Shared: Q, dO, K, V
// (float32 CT x (DP + 4)) and dS (CT x (CT + 1)).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_core(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ g,
            const float2* __restrict__ stats,
            T* __restrict__ dq, int B, int sq, int sk, int H, int rep, int d,
            Strides st, float scale, int causal, int window, int vec) {
  constexpr int LD = DP + 4, CW = DP / 8, PS = CT + 1;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* Gs = Qs + CT * LD;
  float* Ks = Gs + CT * LD;
  float* Vs = Ks + CT * LD;
  float* Ds = Vs + CT * LD;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const Tile x = tile_of(H, B, true);
  const int q0 = x.tile * CT, h = x.h, b = x.b, hk = h / rep;
  const int qmax = min(sq, q0 + CT) - 1;
  int k_lo = 0, k_hi = sk;
  if (causal) {
    k_hi = min(sk, qmax + 1);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_first = k_lo / CT;
  const int n_kt = k_hi > k_lo ? (k_hi + CT - 1) / CT - t_first : 0;
  load_rows<T, DP>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, sq, d, vec);
  load_rows<T, DP>(Gs, g + b * st.gb + h * st.gh, st.gs, q0, sq, d, vec);
  float2 rs[2];                                // {lse log2 e, delta}
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = q0 + ty + 16 * a;
    rs[a] = row < sq ? stats[((long long)b * H + h) * sq + row]
                     : make_float2(0.f, 0.f);
  }
  const float scale2 = scale * kLog2e;
  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;

  float dqa[2][CW];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < CW; ++c) dqa[a][c] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int kt0 = (t_first + j) * CT;
    __syncthreads();
    load_rows<T, DP>(Ks, kb, st.ks, kt0, sk, d, vec);
    load_rows<T, DP>(Vs, vb, st.vs, kt0, sk, d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[2][4], dp[2][4];      // queries ty + 16 a, keys tx + 8 j
    two_products<DP>(Qs, Ks, Gs, Vs, ty, tx, s, dp);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int col = tx + 8 * jj;
        const float p = visible(q0 + ty + 16 * a, kt0 + col, sq, sk, causal,
                                window)
                            ? exp2f(fmaf(s[a][jj], scale2, -rs[a].x)) : 0.f;
        Ds[(ty + 16 * a) * PS + col] = p * (dp[a][jj] - rs[a].y) * scale;
      }
    __syncthreads();
    for (int kk = 0; kk < CT; ++kk) {
      const float* kr = Ks + kk * LD + tx;
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float ds = Ds[(ty + 16 * a) * PS + kk];
#pragma unroll
        for (int c = 0; c < CW; ++c)
          dqa[a][c] = fmaf(ds, kr[8 * c], dqa[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= sq) continue;
    T* dst = dq + b * st.dqb + (long long)row * st.dqs + h * st.dqh;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      if (tx + 8 * c < d) from_f(dqa[a][c], dst + tx + 8 * c);
  }
}

// ------------------------------------------------ launches

// the flat grid of tile_of: every (tile of `rows` / `size`, head, batch row)
unsigned tiles(int rows, int size, int heads, int B) {
  return (unsigned)(((long long)(rows + size - 1) / size) * heads * B);
}

struct Args {
  const void *q, *k, *v, *g;
  const float* lse;
  float2* stats;
  void *dq, *dk, *dv;
  int B, sq, sk, H, Hkv, d;
  Strides st;
  float scale;
  int causal, window, vec;
  cudaStream_t stream;
};

template <int DP>
int launch_mma(const Args& a) {
  using M = Mma<DP>;
  using bf = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_mma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      M::DKDV_BYTES);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_mma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             M::DQ_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int rep = a.H / a.Hkv;
  bwd_dkdv_mma<DP><<<tiles(a.sk, KB, a.Hkv, a.B), 32 * kKvWarps,
                     M::DKDV_BYTES, a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.g), a.stats,
      static_cast<bf*>(a.dk), static_cast<bf*>(a.dv), a.B, a.sq, a.sk, a.H,
      a.Hkv, rep, a.d, a.st, a.scale, a.causal, a.window, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_mma<DP><<<tiles(a.sq, QT, a.H, a.B), 32 * kQWarps, M::DQ_BYTES,
                   a.stream>>>(
      static_cast<const bf*>(a.q), static_cast<const bf*>(a.k),
      static_cast<const bf*>(a.v), static_cast<const bf*>(a.g), a.stats,
      static_cast<bf*>(a.dq), a.B, a.sq, a.sk, a.H, rep, a.d, a.st, a.scale,
      a.causal, a.window, a.vec);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_core(const Args& a) {
  constexpr int smem = core_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_core<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_core<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int rep = a.H / a.Hkv;
  bwd_dkdv_core<T, DP><<<tiles(a.sk, CT, a.Hkv, a.B), kThreads, smem,
                         a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.stats,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B, a.sq, a.sk, a.H,
      a.Hkv, rep, a.d, a.st, a.scale, a.causal, a.window, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_core<T, DP><<<tiles(a.sq, CT, a.H, a.B), kThreads, smem,
                       a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.stats,
      static_cast<T*>(a.dq), a.B, a.sq, a.sk, a.H, rep, a.d, a.st, a.scale,
      a.causal, a.window, a.vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const void* o, const Args& a) {
  const long long rows = (long long)a.B * a.H * a.sq;
  const long long blocks = (rows + 31) / 32;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  bwd_delta<T><<<(unsigned)blocks, 256, 0, a.stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(a.g), a.lse, a.stats,
      rows, a.sq, a.H, a.d, a.st, a.vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The path a launch takes: 1 for the tensor-core kernels (bfloat16,
// D <= 128), 0 for the CUDA-core kernels.
int flash_attention_bwd_path(int D, int dtype) {
  return dtype == 1 && D <= 128;
}

// q, out, dout (B, sq, H, D), k/v (B, sk, Hkv, D), all of one dtype (0
// float32, 1 bfloat16), strides in elements with a contiguous last dim;
// lse: contiguous float32 (B, H, sq), natural log; stats: contiguous
// float32 (B, H, sq, 2) scratch the launch fills; dq, dk, dv: outputs in the
// inputs' dtype. D a multiple of 4 up to 256, any H / Hkv. window <= 0
// means none. vec: every row start of q, k, v, out and dout is 16-byte
// aligned (16-byte copies; element copies otherwise). device: the CUDA
// device of every pointer.
int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const float* lse, float* stats, void* dq, void* dk,
    void* dv, int B, int sq, int sk, int H, int Hkv, int D, int dtype,
    long long qsb, long long qss, long long qsh, long long ksb, long long kss,
    long long ksh, long long vsb, long long vss, long long vsh, long long osb,
    long long oss, long long osh, long long gsb, long long gss, long long gsh,
    long long dqsb, long long dqss, long long dqsh, long long dksb,
    long long dkss, long long dksh, long long dvsb, long long dvss,
    long long dvsh, float scale, int causal, int window, int vec, int device,
    void* stream) {
  if (B <= 0 || sq <= 0 || sk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv <= 0 || B > 65535 || H > 65535 || D <= 0 || D % 4 != 0 ||
      D > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k, v, g, lse, reinterpret_cast<float2*>(stats), dq, dk,
               dv, B, sq, sk, H, Hkv, D,
               Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss,
                       osh, gsb, gss, gsh, dqsb, dqss, dqsh, dksb, dkss, dksh,
                       dvsb, dvss, dvsh},
               scale, causal, window > 0 ? window : 0, vec,
               static_cast<cudaStream_t>(stream)};
  int e = dtype == 0 ? launch_delta<float>(o, a)
                     : launch_delta<__nv_bfloat16>(o, a);
  if (e != 0) return e;
  if (flash_attention_bwd_path(D, dtype)) {
#define REPRO_BWD_MMA(DP) \
    if (D <= DP) return launch_mma<DP>(a);
    REPRO_BWD_MMA(32)
    REPRO_BWD_MMA(64)
    REPRO_BWD_MMA(80)
    REPRO_BWD_MMA(96)
    REPRO_BWD_MMA(128)
#undef REPRO_BWD_MMA
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 1) return launch_core<__nv_bfloat16, 256>(a);
#define REPRO_BWD_CORE(DP) \
  if (D <= DP) return launch_core<float, DP>(a);
  REPRO_BWD_CORE(32)
  REPRO_BWD_CORE(64)
  REPRO_BWD_CORE(128)
  REPRO_BWD_CORE(256)
#undef REPRO_BWD_CORE
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
