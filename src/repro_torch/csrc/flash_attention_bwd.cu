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
//      A (b, h)'s rows are padded to a multiple of 64 with zeros, so every
//      tile's stats start on a 16-byte boundary and fit in its (b, h).
//   2. dk / dv: one block a (key tile, KV head, batch row). It holds its
//      K and V tile and walks the rep query heads of its KV head, and for
//      each the query tiles that see the tile, in ascending order,
//      recomputing S, P, dP and dS per tile; dk and dv sum in registers
//      across the whole walk (GQA's heads included) and are written once.
//   3. dq: one block a (query tile, query head, batch row), walking the
//      key tiles its rows see in ascending order; dq sums in registers and
//      is written once. It recomputes S and dP (two of its three products)
//      rather than share P or dS with the dk / dv blocks through device
//      memory or atomics.
// Tile pairs wholly outside the mask are never visited (the plain
// version's _pairs skip); under a causal mask the heaviest tiles start
// first (tile_of). The queries start at position 0; Sq != Sk is
// allowed. Inputs are read in the (B, S, H, D) layout through their
// strides (the last dim contiguous); nothing is padded in device memory:
// D is padded to the kernel's width DP with zeros in shared memory, and a
// ragged tile's rows past Sq or Sk read as zeros and are masked.
//
// Bound on the H100 at smollm-360m's training microbatch (B 4, S 4096, 15
// query / 5 KV heads, D 64, bf16, causal): the five products over the
// S (S + 1) / 2 visible pairs are 3.2e11 FLOP, 0.33 ms at 989 TFLOP/s
// bf16, against 40 MB read and written (0.012 ms): operations bound it.
// This design issues seven products (S and dP twice), 4.5e11 FLOP. Only
// wgmma reaches the tensor cores' full rate on this card, so:
//
// * bfloat16 with 16-byte-aligned bases and strides and 16 <= D <= 128:
//   TMA, mbarrier rings, wgmma and warp specialisation, the forward's
//   machinery (hopper.cuh). A block is three warpgroups: a producer whose
//   one thread issues every load and which gives its registers to the two
//   consumers (setmaxnreg), and two consumer warpgroups.
//   - dk / dv: a block owns 128 keys, 64 a consumer. The producer loads K
//     and V once and streams the Q and dO tiles (64 queries at DP <= 64,
//     32 above, which keeps the four accumulators in registers) with their
//     rows' stats (a bulk copy) through a ring of three stages (full and
//     empty mbarriers). A consumer computes S^T = K Q^T and dP^T = V dO^T
//     as wgmma with Q and dO K-major in shared memory (no transpose; each
//     is read once for all 64 keys, not once a warp as by ldmatrix) and K
//     (and V, at DP <= 64) as A operands held in registers for the whole
//     walk (loaded once by ldmatrix; V from shared memory above, where it
//     does not fit beside the accumulators), P^T and dS^T in float32
//     registers, packs them to bf16 A operands in registers (the
//     accumulator layout is the A layout), and accumulates dV += P^T dO
//     and dK += dS^T Q as wgmma from registers, reading dO and Q MN-major
//     through the transpose flag.
//   - dq: the forward's shape with one more product: a block owns 128
//     queries, 64 a consumer; Q and dO are loaded once, K and V tiles (128
//     keys at DP <= 64, 64 above) stream through a three-stage ring. S =
//     Q K^T and dP = dO V^T with K and V from shared memory and Q and dO
//     from shared memory too at DP <= 64 (in registers above, loaded once),
//     dS in registers, dQ += dS K from registers with K read MN-major.
//   In both, step i issues tile i's first two products and then tile i -
//   1's gradient products, so the tensor cores run those while the
//   elementwise step of tile i runs on the CUDA cores, and the two
//   warpgroups take turns to issue (named barriers), so one's elementwise
//   step runs under the other's products. That step, not the products,
//   bounded the first build (dk / dv took 0.796 ms at smollm's shape, and
//   0.345 ms with the step left out; PERF.md), so only the tiles with a
//   pair outside the mask (the diagonal, a window's edge, a ragged edge)
//   compute the mask: a second instance of the loop (dk / dv 0.50 ms).
//   Every wgmma is issued unconditionally: one under a branch, even a
//   uniform one, makes ptxas serialize them all. TMA fills rows past Sq or
//   Sk, and columns past D, with zeros. P and dS are rounded to bf16 for
//   their products, as the forward rounds P.
// * float32 (any D), and bfloat16 that TMA cannot take (rows not on
//   16-byte boundaries, such as D = 20 at a 40-byte stride; D < 16 or
//   D > 128): both products of each pass as float32 FMAs on the CUDA
//   cores, tiles of 32 keys and 32 queries held in float32 in shared
//   memory (16 x 8 threads, each 2 rows x 4 columns of S and dP, then 2
//   rows x DP / 8 columns of the gradients), P^T and dS^T (or dS) through
//   shared memory. Exact to float32 up to summation order.

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;   // the CUDA-core kernels' blocks
constexpr int CT = 32;          // keys and queries a tile on the CUDA cores
constexpr int KB = 128;         // keys a dk / dv block, 64 a consumer
constexpr int QB = 128;         // queries a dq block, 64 a consumer
constexpr int kStages = 3;      // streamed tiles in flight
constexpr int kWsThreads = 384; // producer warpgroup + two consumers
constexpr int kStatsPad = 64;   // a (b, h)'s stats rows: a multiple of this

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

// eight lanes a row of the (B, H, sqp) stats, 16 bytes a lane a step where
// every row starts on a 16-byte boundary (vec), elements otherwise; the
// pad rows (sq <= i < sqp) get zeros
template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ g,
          const float* __restrict__ lse, float2* __restrict__ stats,
          long long rows, int sq, int sqp, int H, int d, Strides st,
          int vec) {
  constexpr int E = 16 / sizeof(T);         // elements in 16 bytes
  const long long row = (long long)blockIdx.x * 32 + (threadIdx.x >> 3);
  const int lane = threadIdx.x & 7;
  const bool live = row < rows;   // no early exit: the shuffles take all 32
  const int i = live ? (int)(row % sqp) : 0;
  const long long bh = live ? row / sqp : 0;
  const bool real = live && i < sq;
  const int h = (int)(bh % H), b = (int)(bh / H);
  const T* op = o + b * st.ob + (long long)i * st.os + h * st.oh;
  const T* gp = g + b * st.gb + (long long)i * st.gs + h * st.gh;
  float s = 0.f;
  for (int c = lane * E; real && c < d; c += 8 * E) {
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
  if (live && lane == 0)
    stats[row] = real ? make_float2(lse[bh * sq + i] * kLog2e, s)
                      : make_float2(0.f, 0.f);
}

// ------------------------------------------------ bfloat16: wgmma + TMA

// Shared memory of a block, in bytes from a 1024-byte-aligned base (tiles
// in hopper.cuh's swizzled column boxes). dk / dv: K and V (KB rows), then
// rings of Q and dO tiles (BQ rows) and of the rows' stats. dq: Q and dO
// (QB rows), then rings of K and V tiles (WK rows).
template <int D>
struct Bwd : Swizzle<D> {
  static constexpr int BQ = D <= 64 ? 64 : 32;    // queries a dk / dv step
  static constexpr int WK = D <= 64 ? 128 : 64;   // keys a dq step
  // V as the dk / dv block's register A operand of dP^T as K is of S^T
  // (loaded once by ldmatrix), not read from shared memory at every step:
  // wider rows of both do not fit beside the accumulators
  static constexpr bool V_REGS = D <= 64;
  // Q and dO as the dq block's register A operands of S and dP: at
  // DP > 64, where a dq step is 64 keys; beside the 128-key step's
  // accumulators they spill
  static constexpr bool QG_REGS = D > 64;
  static constexpr int KV_TILE = KB * D * 2;
  static constexpr int Q_TILE = BQ * D * 2;
  static constexpr int Q_OFF = 2 * KV_TILE;
  static constexpr int G_OFF = Q_OFF + kStages * Q_TILE;
  static constexpr int S_OFF = G_OFF + kStages * Q_TILE;
  static constexpr int DKDV_BYTES = S_OFF + kStages * BQ * 8;
  static constexpr int QD_TILE = QB * D * 2;
  static constexpr int T_TILE = WK * D * 2;
  static constexpr int K_RING = 2 * QD_TILE;
  static constexpr int V_RING = K_RING + kStages * T_TILE;
  static constexpr int DQ_BYTES = V_RING + kStages * T_TILE;
};

// The elementwise step of a dk / dv block, in place of the accumulators
// S^T (sc) and dP^T (dp) of a 64-key x BQ-query tile: P^T = 2^(S^T scale
// log2 e - lse log2 e) and dS^T / scale = P^T (dP^T - delta). This thread
// holds keys key0 and key0 + 8 against queries qt0 + 8 j + 2 t (+ 1),
// whose stats {lse log2 e, delta} it reads from shared memory. MASKED only
// for a tile with a pair outside the mask (the diagonal, a window's edge,
// a ragged edge); the other tiles compute no mask at all.
template <bool MASKED, int BQ>
__device__ __forceinline__ void dkdv_grads(float* sc, float* dp,
                                           const float2* sts, int t, int qt0,
                                           int key0, float scale2, int sq,
                                           int sk, int causal, int window) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float4 c2 = *reinterpret_cast<const float4*>(sts + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(sc[4 * j + e], scale2, -((e & 1) ? c2.z : c2.x)));
      if constexpr (MASKED)
        if (!visible(qt0 + 8 * j + 2 * t + (e & 1), key0 + 8 * (e >> 1), sq,
                     sk, causal, window))
          p = 0.f;
      sc[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - ((e & 1) ? c2.w : c2.y));
    }
  }
}

// The same for a dq block's 64-query x WK-key tile (S and dP; dS / scale
// into dp): this thread's rows row0 and row0 + 8, their stats in rs
template <bool MASKED, int WK>
__device__ __forceinline__ void dq_grads(float* sc, float* dp,
                                         const float2* rs, int t, int row0,
                                         int kt0, float scale2, int sq,
                                         int sk, int causal, int window) {
#pragma unroll
  for (int i = 0; i < WK / 2; ++i) {
    const int hr = (i >> 1) & 1;
    float p = ex2(fmaf(sc[i], scale2, -rs[hr].x));
    if constexpr (MASKED)
      if (!visible(row0 + 8 * hr, kt0 + 8 * (i >> 2) + 2 * t + (i & 1), sq,
                   sk, causal, window))
        p = 0.f;
    dp[i] = p * (dp[i] - rs[hr].y);
  }
}

// dk and dv of one (key tile of KB, KV head, batch row); D is the padded
// width DP, d the inputs' own
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               const __grid_constant__ CUtensorMap tg,
               const float2* __restrict__ stats,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int B, int sq, int sqp, int sk, int H, int Hkv, int rep,
               int d, long long dkb, long long dks, long long dkh,
               long long dvb, long long dvs, long long dvh, float scale,
               int causal, int window) {
  using T = Bwd<D>;
  constexpr int BQ = T::BQ;
  extern __shared__ unsigned char smem_raw[];
  // K and V full; per stage full and empty
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_full = smem_u32(&bars[0]), full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;
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
  const int n = rep * n_qt;         // (query head, query tile), in order

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {      // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    bar_arrive(1);              // the first consumer takes the first turn
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * T::KV_TILE);
      tma_tile<D, KB>(tiles, &tk, kv_full, hk, k0, b);
      tma_tile<D, KB>(tiles + T::KV_TILE, &tv, kv_full, hk, k0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        const int h = hk * rep + i / n_qt, qt0 = (t_first + i % n_qt) * BQ;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * T::Q_TILE + BQ * 8);
        tma_tile<D, BQ, BQ>(tiles + T::Q_OFF + s * T::Q_TILE, &tq,
                            full + 8 * s, h, qt0, b);
        tma_tile<D, BQ, BQ>(tiles + T::G_OFF + s * T::Q_TILE, &tg,
                            full + 8 * s, h, qt0, b);
        bulk_load(tiles + T::S_OFF + s * BQ * 8,
                  stats + ((long long)b * H + h) * sqp + qt0, BQ * 8,
                  full + 8 * s);
      }
    }
  } else {                      // two consumer warpgroups of 64 keys
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int lt = threadIdx.x % 128, warp = lt >> 5, lane = lt & 31;
    const int g = lane >> 2, t = lane & 3;
    const int mine = 1 + cw, other = 2 - cw;
    const uint32_t v_tile = tiles + T::KV_TILE + 64 * cw * T::SW;
    const unsigned char* sbase = smem_raw + (tiles - smem_u32(smem_raw))
                                 + T::S_OFF;
    const int kw0 = k0 + 64 * cw;             // the warpgroup's first key
    const int key0 = kw0 + 16 * warp + g;     // this thread's: key0, +8
    const float scale2 = scale * kLog2e;
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    float sc[BQ / 2], dp[BQ / 2];   // S^T then P^T; dP^T then dS^T / scale
    uint32_t pf[BQ / 16][4], df[BQ / 16][4];  // the last step's, as bf16
    uint32_t ka[D / 16][4];                  // this warp's 16 keys of K
    uint32_t va[T::V_REGS ? D / 16 : 1][4];  // and of V

    // S^T = K Q^T and dP^T = V dO^T of step i, from shared memory
    auto issue_s = [&](int i) {
      const int s = i % kStages;
      mbar_wait(full + 8 * s, (i / kStages) & 1);
      wgmma_fence();
      const uint32_t qt = tiles + T::Q_OFF + s * T::Q_TILE;
      const uint32_t gt = tiles + T::G_OFF + s * T::Q_TILE;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_rs<BQ, 0>(sc, ka[ks], kmajor<D, BQ>(qt, ks), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        if constexpr (T::V_REGS)
          wgmma_rs<BQ, 0>(dp, va[ks], kmajor<D, BQ>(gt, ks), ks > 0);
        else
          wgmma_ss<BQ>(dp, kmajor<D, KB>(v_tile, ks), kmajor<D, BQ>(gt, ks),
                       ks > 0);
      }
      wgmma_commit();
    };
    // dV += P^T dO and dK += dS^T Q of step i, P^T and dS^T from registers
    auto issue_dkv = [&](int i) {
      const int s = i % kStages;
      wgmma_fence();
      const uint32_t qt = tiles + T::Q_OFF + s * T::Q_TILE;
      const uint32_t gt = tiles + T::G_OFF + s * T::Q_TILE;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_pv<D, BQ>(dva, pf[kk], gt, kk);
        wgmma_pv<D, BQ>(dka, df[kk], qt, kk);
      }
      wgmma_commit();
    };
    // once S^T and dP^T of step i are in: P^T and dS^T / scale in place
    auto grads = [&](int i) {
      fence_regs<BQ / 2>(sc);
      fence_regs<BQ / 2>(dp);
      const float2* sts = reinterpret_cast<const float2*>(
          sbase + (i % kStages) * BQ * 8);
      const int qt0 = (t_first + i % n_qt) * BQ;
      // a tile every pair of which is visible needs no mask
      const bool whole = kw0 + 64 <= sk && qt0 + BQ <= sq &&
          (!causal || (kw0 + 63 <= qt0 &&
                       (window <= 0 || kw0 > qt0 + BQ - 1 - window)));
      if (whole)
        dkdv_grads<false, BQ>(sc, dp, sts, t, qt0, key0, scale2, sq, sk,
                              causal, window);
      else
        dkdv_grads<true, BQ>(sc, dp, sts, t, qt0, key0, scale2, sq, sk,
                             causal, window);
    };
    // once dV and dK of step i are done: release its stage
    auto dkv_done = [&](int i) {
      fence_regs<D / 2>(dka);
      fence_regs<D / 2>(dva);
      fence_regs<BQ / 4>(&pf[0][0]);        // may be rewritten now
      fence_regs<BQ / 4>(&df[0][0]);
      mbar_arrive(empty + 8 * (i % kStages));
    };
    // P^T and dS^T as bf16 A fragments: k-step kk is the accumulator's
    // column chunks 2 kk and 2 kk + 1
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pf[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
          df[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        }
    };

    mbar_wait(kv_full, 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      ldsm_a<D, KB>(ka[ks], tiles, 64 * cw + 16 * warp, ks, lane);
      if constexpr (T::V_REGS)
        ldsm_a<D, KB>(va[ks], tiles + T::KV_TILE, 64 * cw + 16 * warp, ks,
                      lane);
    }
    if (n > 0) {
      bar_sync(mine);
      issue_s(0);
      bar_arrive(other);
      wgmma_wait<0>();
      grads(0);
      pack();
    }
    for (int i = 1; i < n; ++i) {
      bar_sync(mine);
      issue_s(i);
      issue_dkv(i - 1);
      bar_arrive(other);
      wgmma_wait<1>();
      grads(i);
      wgmma_wait<0>();
      dkv_done(i - 1);
      pack();
    }
    if (n > 0) {
      bar_sync(mine);
      issue_dkv(n - 1);
      bar_arrive(other);
      wgmma_wait<0>();
      dkv_done(n - 1);
    }
    if (cw == 0) bar_sync(mine);    // the other warpgroup's last signal

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = key0 + 8 * hr;
      if (key >= sk) continue;
      __nv_bfloat16* kd = dk + b * dkb + (long long)key * dks + hk * dkh;
      __nv_bfloat16* vd = dv + b * dvb + (long long)key * dvs + hk * dvh;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        if (col < d) {                  // d even: both columns or none
          *reinterpret_cast<__nv_bfloat162*>(kd + col) =
              __floats2bfloat162_rn(dka[4 * jj + 2 * hr] * scale,
                                    dka[4 * jj + 2 * hr + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(vd + col) =
              __floats2bfloat162_rn(dva[4 * jj + 2 * hr],
                                    dva[4 * jj + 2 * hr + 1]);
        }
      }
    }
  }
}

// dq of one (query tile of QB, query head, batch row)
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             const __grid_constant__ CUtensorMap tg,
             const float2* __restrict__ stats,
             __nv_bfloat16* __restrict__ dq, int B, int sq, int sqp, int sk,
             int H, int rep, int d, long long dqb, long long dqs,
             long long dqh, float scale, int causal, int window) {
  using T = Bwd<D>;
  constexpr int WK = T::WK;
  extern __shared__ unsigned char smem_raw[];
  // Q and dO full; per stage K full, V full, K empty, V empty
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]), k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  const Tile x = tile_of(H, B, true);
  const int q0 = x.tile * QB, h = x.h, b = x.b, hk = h / rep;
  const int qmax = min(sq, q0 + QB) - 1;
  // the keys this tile's queries see: [k_lo, k_hi)
  int k_lo = 0, k_hi = sk;
  if (causal) {
    k_hi = min(sk, qmax + 1);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_first = k_lo / WK;
  const int n = k_hi > k_lo ? (k_hi + WK - 1) / WK - t_first : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {      // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    bar_arrive(1);
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * T::QD_TILE);
      tma_tile<D, QB>(tiles, &tq, q_full, h, q0, b);
      tma_tile<D, QB>(tiles + T::QD_TILE, &tg, q_full, h, q0, b);
      for (int j = 0; j < n; ++j) {
        const int s = j % kStages, kt0 = (t_first + j) * WK;
        const uint32_t free_ph = ((j / kStages) & 1) ^ 1;
        mbar_wait(k_empty + 8 * s, free_ph);
        mbar_expect_tx(k_full + 8 * s, T::T_TILE);
        tma_tile<D, WK>(tiles + T::K_RING + s * T::T_TILE, &tk,
                        k_full + 8 * s, hk, kt0, b);
        mbar_wait(v_empty + 8 * s, free_ph);
        mbar_expect_tx(v_full + 8 * s, T::T_TILE);
        tma_tile<D, WK>(tiles + T::V_RING + s * T::T_TILE, &tv,
                        v_full + 8 * s, hk, kt0, b);
      }
    }
  } else {                      // two consumer warpgroups of 64 queries
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int lt = threadIdx.x % 128, warp = lt >> 5, lane = lt & 31;
    const int g = lane >> 2, t = lane & 3;
    const int mine = 1 + cw, other = 2 - cw;
    const uint32_t q_tile = tiles + 64 * cw * T::SW;
    const uint32_t g_tile = q_tile + T::QD_TILE;
    const int r_lo = q0 + 64 * cw;            // the warpgroup's first row
    const int row0 = r_lo + 16 * warp + g;    // this thread's: row0, +8
    const float scale2 = scale * kLog2e;
    float2 rs[2];                             // {lse log2 e, delta}
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      rs[hr] = row < sq ? stats[((long long)b * H + h) * sqp + row]
                        : make_float2(0.f, 0.f);
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    float sc[WK / 2], dp[WK / 2];   // S then P; dP then dS / scale
    uint32_t df[WK / 16][4];        // the last step's dS, as bf16
    constexpr int NA = T::QG_REGS ? D / 16 : 1;
    uint32_t qa[NA][4], ga[NA][4];  // this warp's 16 rows of Q and dO

    // S = Q K^T and dP = dO V^T of key tile j, from shared memory
    auto issue_s = [&](int j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const uint32_t kt = tiles + T::K_RING + s * T::T_TILE;
      const uint32_t vt = tiles + T::V_RING + s * T::T_TILE;
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        if constexpr (T::QG_REGS)
          wgmma_rs<WK, 0>(sc, qa[ks], kmajor<D, WK>(kt, ks), ks > 0);
        else
          wgmma_ss<WK>(sc, kmajor<D, QB>(q_tile, ks), kmajor<D, WK>(kt, ks),
                       ks > 0);
      }
      mbar_wait(v_full + 8 * s, ph);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        if constexpr (T::QG_REGS)
          wgmma_rs<WK, 0>(dp, ga[ks], kmajor<D, WK>(vt, ks), ks > 0);
        else
          wgmma_ss<WK>(dp, kmajor<D, QB>(g_tile, ks), kmajor<D, WK>(vt, ks),
                       ks > 0);
      }
      wgmma_commit();
    };
    // dQ += dS K of key tile j, dS from registers, K read MN-major
    auto issue_dq = [&](int j) {
      wgmma_fence();
      const uint32_t kt = tiles + T::K_RING + (j % kStages) * T::T_TILE;
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) wgmma_pv<D, WK>(dqa, df[kk], kt,
                                                           kk);
      wgmma_commit();
    };
    // once S and dP of tile j are in: release V, then P and dS in place
    auto grads = [&](int j) {
      fence_regs<WK / 2>(sc);
      fence_regs<WK / 2>(dp);
      mbar_arrive(v_empty + 8 * (j % kStages));
      const int kt0 = (t_first + j) * WK;
      const bool whole = kt0 + WK <= sk && r_lo + 64 <= sq &&
          (!causal || (kt0 + WK - 1 <= r_lo &&
                       (window <= 0 || kt0 > r_lo + 63 - window)));
      if (whole)
        dq_grads<false, WK>(sc, dp, rs, t, row0, kt0, scale2, sq, sk, causal,
                            window);
      else
        dq_grads<true, WK>(sc, dp, rs, t, row0, kt0, scale2, sq, sk, causal,
                           window);
    };
    // once dQ of tile j is done: release K
    auto dq_done = [&](int j) {
      fence_regs<D / 2>(dqa);
      fence_regs<WK / 4>(&df[0][0]);
      mbar_arrive(k_empty + 8 * (j % kStages));
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          df[kk][r] = pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
    };

    mbar_wait(q_full, 0);
    if constexpr (T::QG_REGS) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        ldsm_a<D, QB>(qa[ks], tiles, 64 * cw + 16 * warp, ks, lane);
        ldsm_a<D, QB>(ga[ks], tiles + T::QD_TILE, 64 * cw + 16 * warp, ks,
                      lane);
      }
    }
    if (n > 0) {
      bar_sync(mine);
      issue_s(0);
      bar_arrive(other);
      wgmma_wait<0>();
      grads(0);
      pack();
    }
    for (int j = 1; j < n; ++j) {
      bar_sync(mine);
      issue_s(j);
      issue_dq(j - 1);
      bar_arrive(other);
      wgmma_wait<1>();
      grads(j);
      wgmma_wait<0>();
      dq_done(j - 1);
      pack();
    }
    if (n > 0) {
      bar_sync(mine);
      issue_dq(n - 1);
      bar_arrive(other);
      wgmma_wait<0>();
      dq_done(n - 1);
    }
    if (cw == 0) bar_sync(mine);

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      if (row >= sq) continue;
      __nv_bfloat16* dst = dq + b * dqb + (long long)row * dqs + h * dqh;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(dqa[4 * jj + 2 * hr] * scale,
                                    dqa[4 * jj + 2 * hr + 1] * scale);
      }
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
              T* __restrict__ dk, T* __restrict__ dv, int B, int sq, int sqp,
              int sk, int H, int Hkv, int rep, int d, Strides st,
              float scale, int causal, int window, int vec) {
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
      sts[tid] = qt0 + tid < sq ? stats[((long long)b * H + h) * sqp + qt0
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
            T* __restrict__ dq, int B, int sq, int sqp, int sk, int H,
            int rep, int d, Strides st, float scale, int causal, int window,
            int vec) {
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
    rs[a] = row < sq ? stats[((long long)b * H + h) * sqp + row]
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
unsigned grid_of(int rows, int size, int heads, int B) {
  return (unsigned)(((long long)(rows + size - 1) / size) * heads * B);
}

struct Args {
  const void *q, *k, *v, *g;
  const float* lse;
  float2* stats;
  void *dq, *dk, *dv;
  int B, sq, sqp, sk, H, Hkv, d;
  Strides st;
  float scale;
  int causal, window, vec;
  cudaStream_t stream;
};

template <int DP>
int launch_wgmma(const Args& a) {
  using T = Bwd<DP>;
  using bf = __nv_bfloat16;
  const Strides& st = a.st;
  // Q and dO in boxes of the dk / dv step's rows (BQ) and of 64 (dq); K
  // and V in boxes of 64
  CUtensorMap mq, mg, mq64, mg64, mk, mv;
  if (!tensor_map<DP, T::BQ>(&mq, a.q, a.B, a.sq, a.H, a.d, st.qb, st.qs,
                             st.qh) ||
      !tensor_map<DP, T::BQ>(&mg, a.g, a.B, a.sq, a.H, a.d, st.gb, st.gs,
                             st.gh) ||
      !tensor_map<DP>(&mq64, a.q, a.B, a.sq, a.H, a.d, st.qb, st.qs, st.qh) ||
      !tensor_map<DP>(&mg64, a.g, a.B, a.sq, a.H, a.d, st.gb, st.gs, st.gh) ||
      !tensor_map<DP>(&mk, a.k, a.B, a.sk, a.Hkv, a.d, st.kb, st.ks, st.kh) ||
      !tensor_map<DP>(&mv, a.v, a.B, a.sk, a.Hkv, a.d, st.vb, st.vs, st.vh))
    return (int)cudaErrorInvalidValue;
  const int kv_smem = T::DKDV_BYTES + 1024;  // + the 1024-byte alignment
  const int q_smem = T::DQ_BYTES + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kv_smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_dq_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
  if (err != cudaSuccess) return (int)err;
  const int rep = a.H / a.Hkv;
  bwd_dkdv_wgmma<DP><<<grid_of(a.sk, KB, a.Hkv, a.B), kWsThreads, kv_smem,
                       a.stream>>>(
      mq, mk, mv, mg, a.stats, static_cast<bf*>(a.dk), static_cast<bf*>(a.dv),
      a.B, a.sq, a.sqp, a.sk, a.H, a.Hkv, rep, a.d, st.dkb, st.dks, st.dkh,
      st.dvb, st.dvs, st.dvh, a.scale, a.causal, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_wgmma<DP><<<grid_of(a.sq, QB, a.H, a.B), kWsThreads, q_smem,
                     a.stream>>>(
      mq64, mk, mv, mg64, a.stats, static_cast<bf*>(a.dq), a.B, a.sq, a.sqp,
      a.sk, a.H, rep, a.d, st.dqb, st.dqs, st.dqh, a.scale, a.causal,
      a.window);
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
  bwd_dkdv_core<T, DP><<<grid_of(a.sk, CT, a.Hkv, a.B), kThreads, smem,
                         a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.stats,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B, a.sq, a.sqp, a.sk,
      a.H, a.Hkv, rep, a.d, a.st, a.scale, a.causal, a.window, a.vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dq_core<T, DP><<<grid_of(a.sq, CT, a.H, a.B), kThreads, smem,
                       a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.stats,
      static_cast<T*>(a.dq), a.B, a.sq, a.sqp, a.sk, a.H, rep, a.d, a.st,
      a.scale, a.causal, a.window, a.vec);
  return (int)cudaGetLastError();
}

template <typename T>
int by_width_core(const Args& a) {
#define REPRO_BWD_CORE(DP) \
  if (a.d <= DP) return launch_core<T, DP>(a);
  REPRO_BWD_CORE(32)
  REPRO_BWD_CORE(64)
  REPRO_BWD_CORE(128)
  REPRO_BWD_CORE(256)
#undef REPRO_BWD_CORE
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_delta(const void* o, const Args& a) {
  const long long rows = (long long)a.B * a.H * a.sqp;
  const long long blocks = (rows + 31) / 32;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  bwd_delta<T><<<(unsigned)blocks, 256, 0, a.stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(a.g), a.lse, a.stats,
      rows, a.sq, a.sqp, a.H, a.d, a.st, a.vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The path a launch takes: 1 for the wgmma + TMA kernels (bfloat16, every
// base and stride 16-byte aligned: vec, 16 <= D <= 128), 0 for the
// CUDA-core kernels.
int flash_attention_bwd_path(int D, int dtype, int vec) {
  return dtype == 1 && vec && D >= 16 && D <= 128;
}

// The rows of each (b, h) in the stats scratch: sq rounded up to 64.
int flash_attention_bwd_stats_rows(int sq) {
  return (sq + kStatsPad - 1) / kStatsPad * kStatsPad;
}

// q, out, dout (B, sq, H, D), k/v (B, sk, Hkv, D), all of one dtype (0
// float32, 1 bfloat16), strides in elements with a contiguous last dim;
// lse: contiguous float32 (B, H, sq), natural log; stats: contiguous,
// 16-byte-aligned float32 (B, H, flash_attention_bwd_stats_rows(sq), 2)
// scratch the launch fills; dq, dk, dv: outputs in the inputs' dtype. D a
// multiple of 4 up to 256, any H / Hkv. window <= 0 means none. vec: every
// row start of q, k, v, out and dout is 16-byte aligned (TMA for
// bfloat16, 16-byte copies for float32; element copies otherwise).
// device: the CUDA device of every pointer.
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
      D > 256 || (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(stats) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  // make the device's primary context current on the calling thread: on a
  // thread whose first CUDA call this is, cuTensorMapEncodeTiled would find
  // none and fail
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q, k, v, g, lse, reinterpret_cast<float2*>(stats), dq, dk,
               dv, B, sq, flash_attention_bwd_stats_rows(sq), sk, H, Hkv, D,
               Strides{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss,
                       osh, gsb, gss, gsh, dqsb, dqss, dqsh, dksb, dkss, dksh,
                       dvsb, dvss, dvsh},
               scale, causal, window > 0 ? window : 0, vec,
               static_cast<cudaStream_t>(stream)};
  int e = dtype == 0 ? launch_delta<float>(o, a)
                     : launch_delta<__nv_bfloat16>(o, a);
  if (e != 0) return e;
  if (flash_attention_bwd_path(D, dtype, vec)) {
#define REPRO_BWD_WGMMA(DP) \
    if (D <= DP) return launch_wgmma<DP>(a);
    REPRO_BWD_WGMMA(32)
    REPRO_BWD_WGMMA(64)
    REPRO_BWD_WGMMA(80)
    REPRO_BWD_WGMMA(96)
    REPRO_BWD_WGMMA(128)
#undef REPRO_BWD_WGMMA
    return (int)cudaErrorInvalidValue;
  }
  return dtype == 0 ? by_width_core<float>(a)
                    : by_width_core<__nv_bfloat16>(a);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
