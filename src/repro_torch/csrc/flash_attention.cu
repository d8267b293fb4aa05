// Flash attention forward: causal, windowed or full GQA attention with an
// online softmax; the (Sq, Sk) score matrix is never built.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// flash_fwd (:74, _flash_fwd_kernel). Its grid (B, H, nq, nk) walks the KV
// axis in order and carries (m, l, acc) in VMEM scratch; here a block owns
// one (q tile, head, batch) and a loop over KV tiles takes the place of the
// sequential nk axis, with (m, l, acc) in registers. The state is float32
// and masked scores are NEG_INF = -1e30, as there (:24). GQA reads KV head
// h / rep, for any rep. Inputs are read in the reference's (B, S, H, D)
// layout through their strides (the last dim contiguous); nothing is padded
// or transposed in device memory. Key tiles wholly above the causal
// diagonal (or wholly before the window) are skipped: they add exactly
// zero. q tiles run heaviest first.
//
// Head dims: any D <= 256 that is a multiple of 4. A kernel is built for a
// few widths DP (multiples of 16); D is padded up to the next one with zero
// columns in shared memory (TMA's out-of-bounds fill, or the loader's
// zeros), which add exactly zero to q.k and to P V, and the output's pad
// columns are never stored.
//
// Bound on the H100 at the KV-batch prefill (B 23 unique medoids, S 2880,
// H 32, Hkv 8, D 128, bf16): 1.56e12 causal FLOP per layer over 989
// TFLOP/s bf16 is 1.5807 ms, above the 1.36 GB read and written (0.41 ms),
// so operations bound it. Two kernels:
//
// * bfloat16 with 16-byte-aligned bases and strides and 16 <= D <= 128
//   (every prefill of the model zoo): reaching the tensor cores' full rate
//   takes wgmma, fed by TMA, with the copies, the softmax and the products
//   overlapped. The kernel is persistent, one block a SM: block j takes
//   work items (a 128-row q tile of one head) j, j + 132, ..., in windows
//   of a few (sequence, KV head) pairs whose K and V stay in L2, heaviest
//   q tiles first within a window. A block is three warpgroups: one
//   producer thread issues TMA loads of Q and of K and V tiles of 128 keys
//   into two-stage rings in shared memory (full and empty mbarriers per
//   ring; a 128-, 64- or 32-byte swizzle, the widest whose boxes tile DP,
//   which the wgmma descriptors match), loading the next item's Q and first
//   tiles while the consumers finish this one, and its warpgroup gives up
//   its registers (setmaxnreg); two consumer warpgroups own 64 q rows each.
//   A consumer runs S = Q K^T as wgmma m64n128k16 with both operands in
//   shared memory (K is K-major: no transpose), scales, masks (only on
//   diagonal, window and ragged tiles) and exponentiates S in base 2 in
//   float32 registers, and packs P to bf16 in registers as the A operand of
//   O += P V, which reads V from shared memory through wgmma's transpose
//   flag (DP columns as pieces of 128, 64, 32 or 16: 80 is 64 + 16). Step
//   i issues S of tile i and then P V of tile i - 1, so the tensor cores
//   run P V while the softmax of tile i runs on the CUDA cores, and the two
//   warpgroups take turns to issue (named barriers), so one's softmax runs
//   under the other's products. TMA fills rows past sq or sk, and columns
//   past D, with zeros, so the ragged tiles need no load masks; keys past
//   sk are masked in the scores.
// * any other input (float32; bfloat16 whose rows TMA cannot take, such as
//   D = 20 at a 40-byte row stride; D < 16 or D > 128): both products in
//   float32 FMAs on the CUDA cores (16 x 8 threads, each 4 query rows x 8
//   keys), the tiles held in float32 in shared memory. float32 rows that
//   start on 16-byte boundaries load as 16-byte cp.async copies, every
//   other row element by element (any row of whole elements), so the
//   launcher never copies an input to an aligned buffer. Exact to the
//   float32 tolerance.
//
// Both kernels can also write each query row's log-sum-exp, lse = m +
// log(max(l, 1e-30)) in natural log (the reference's flash_ref.py:91-92),
// as float32 (B, H, Sq), where they normalise the accumulator: the
// training forward saves it for the backward (models/flash_ref.py). A
// null lse pointer (the serve path) writes nothing.

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int kThreads = 128;

struct Strides {                // elements; the head-dim stride is 1
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

// rows [r0, r0 + ROWS) of a (n, d) slice with row stride rs into float32
// smem [ROWS][DP + 4]: 16-byte cp.async copies of four floats when T is
// float and every row start is 16-byte aligned (vec), element by element
// (converted to float32) otherwise; columns past d and rows >= n become
// zeros.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows(float* s, const T* g, long long rs,
                                          int r0, int n, int d, bool vec) {
  constexpr int LD = DP + 4;
  constexpr int PER_ROW = DP / 4;           // four columns a step
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * 4;
    float* dst = s + r * LD + c;
    const int row = r0 + r;
    if (row < n && c < d) {                 // d is a multiple of 4
      const T* src = g + (long long)row * rs + c;
      if (sizeof(T) == 4 && vec) {
        const uint32_t a = (uint32_t)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(a), "l"(src));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = to_f(src[e]);
      }
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
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

// ------------------------------------------------ bfloat16: wgmma + TMA

constexpr int WQ = 128;         // query rows per block, 64 per consumer
constexpr int WK = 128;         // keys per tile
constexpr int kStages = 2;      // K and V tiles in flight
constexpr int kWsThreads = 384; // producer warpgroup + two consumers
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of a block, in bytes from a 1024-byte-aligned base: Q,
// then the K ring, then the V ring, each tile in hopper.cuh's swizzled
// column boxes.
template <int D>
struct Tiles : Swizzle<D> {
  static constexpr int Q_BYTES = WQ * D * 2;
  static constexpr int T_BYTES = WK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * T_BYTES;
  static constexpr int BYTES = V_OFF + kStages * T_BYTES;
};

// One key tile's online softmax (in base 2) for the thread's rows row0 and
// row0 + 8: the raw scores in sc become P in place, m and l are updated and
// corr is what O must be scaled by. A row's 128 scores sit in the 4 lanes
// of a quad. Masked scores become -inf; m starts at the finite NEG_INF, so
// 2^(s scale2 - m) is 0 for them with no select.
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l,
                                             float* corr, bool whole,
                                             int row0, int k0, int t, int sq,
                                             int sk, int causal, int window,
                                             float scale2) {
  const float minus_inf = __int_as_float(0xff800000u);
  if (!whole) {
#pragma unroll
    for (int i = 0; i < WK / 2; ++i) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int key = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (!visible(row, key, sq, sk, causal, window)) sc[i] = minus_inf;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mt = minus_inf;
#pragma unroll
    for (int n = 0; n < WK / 8; ++n)
      mt = fmaxf(mt, fmaxf(sc[4 * n + 2 * hr], sc[4 * n + 2 * hr + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float mn = fmaxf(m[hr], mt * scale2);
    corr[hr] = ex2(m[hr] - mn);
    m[hr] = mn;
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < WK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * hr + e];
        x = ex2(fmaf(x, scale2, -mn));
        sum += x;
      }
    }
    l[hr] = fmaf(l[hr], corr[hr], sum);   // a per-lane partial sum
  }
}

// A work item: one 128-row q tile of one head of one sequence, and the key
// tiles it reads. Items come in windows of W (sequence, KV head) pairs,
// heaviest q tiles first within a window and a pair's rep heads side by
// side, so the blocks at work at one time read the K and V of a few pairs,
// which stay in L2 (a global heaviest-first order would stream every
// pair's K and V from device memory once per q tile level).
struct Item {
  int q0, h, b, k_begin, n_tiles;
};

__device__ __forceinline__ Item item_of(int it, int nq, int H, int B, int rep,
                                        int W, int sq, int sk, int causal,
                                        int window) {
  const int hkv = H / rep, per_w = W * nq * rep;
  const int w = it / per_w, i = it % per_w;
  const int wc = min(W, B * hkv - w * W);   // pairs in this window
  const int rem = i % (wc * rep), pair = w * W + rem / rep;
  Item x;
  x.q0 = (nq - 1 - i / (wc * rep)) * WQ;
  x.b = pair / hkv;
  x.h = (pair % hkv) * rep + rem % rep;
  int k_begin = 0, k_end = sk;
  if (causal) {                 // q_offset is 0: row r sees keys <= r
    k_end = min(sk, x.q0 + WQ);
    if (window > 0) k_begin = max(0, x.q0 - window + 1);
  }
  x.k_begin = (k_begin / WK) * WK;
  x.n_tiles = max(0, (k_end - x.k_begin + WK - 1) / WK);
  return x;
}

// Persistent: block j takes work items j, j + gridDim.x, ... in order, so
// the producer loads the next item's Q and first tiles while the
// consumers finish this one. D is the padded width DP; d the inputs' own.
template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int sq, int sk, int H, int B, int rep, int W, long long ob,
                long long os, long long oh, float scale2, int causal,
                int window, int d) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  // Q full and empty; per stage K full, V full, K empty, V empty
  __shared__ __align__(8) uint64_t bars[2 + 4 * kStages];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = smem_u32(&bars[0]), q_empty = q_full + 8;
  const uint32_t k_full = q_full + 16, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  const int nq = (sq + WQ - 1) / WQ, items = nq * H * B;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 2 * 128);            // every consumer thread
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    bar_arrive(1);              // the first consumer takes the first turn
    if (threadIdx.x == 0) {
      int tile = 0;             // K and V tiles issued: the rings' position
      for (int it = blockIdx.x, j = 0; it < items; it += gridDim.x, ++j) {
        const Item x = item_of(it, nq, H, B, rep, W, sq, sk, causal, window);
        const int hk = x.h / rep;
        mbar_wait(q_empty, (j & 1) ^ 1);
        mbar_expect_tx(q_full, T::Q_BYTES);
        tma_tile<D, WQ>(tiles, &tq, q_full, x.h, x.q0, x.b);
        for (int i = 0; i < x.n_tiles; ++i, ++tile) {
          const int s = tile % kStages, k0 = x.k_begin + i * WK;
          const uint32_t free_ph = ((tile / kStages) & 1) ^ 1;
          mbar_wait(k_empty + 8 * s, free_ph);
          mbar_expect_tx(k_full + 8 * s, T::T_BYTES);
          tma_tile<D, WK>(tiles + T::K_OFF + s * T::T_BYTES, &tk,
                          k_full + 8 * s, hk, k0, x.b);
          mbar_wait(v_empty + 8 * s, free_ph);
          mbar_expect_tx(v_full + 8 * s, T::T_BYTES);
          tma_tile<D, WK>(tiles + T::V_OFF + s * T::T_BYTES, &tv,
                          v_full + 8 * s, hk, k0, x.b);
        }
      }
    }
  } else {                      // two consumer warpgroups of 64 q rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1;
    const int lt = threadIdx.x % 128, warp = lt >> 5, lane = lt & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t q_tile = tiles + 64 * cw * T::SW;
    // The two warpgroups take turns to issue their products (named
    // barrier 1 + cw is this one's turn), so one's softmax runs while the
    // other's products do. The producer gave the first turn; the first
    // warpgroup takes the second's last signal at the end.
    const int mine = 1 + cw, other = 2 - cw;
    float acc[D / 2];
    float m[2], l[2], corr[2];
    float sc[WK / 2];           // S of the current tile, then its P
    uint32_t pf[WK / 16][4];    // the previous tile's P, bf16 A fragments
    int tile = 0;               // K and V tiles consumed
    for (int it = blockIdx.x, j = 0; it < items; it += gridDim.x, ++j) {
      const Item x = item_of(it, nq, H, B, rep, W, sq, sk, causal, window);
      const int r_lo = x.q0 + 64 * cw;         // the warpgroup's first row
      const int row0 = r_lo + 16 * warp + g;   // this thread's: row0, +8
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.f;

      // S = Q K^T of tile i into sc, as wgmma m64n128k16 from shared memory
      auto issue_s = [&](int i) {
        const int s = (tile + i) % kStages;
        mbar_wait(k_full + 8 * s, ((tile + i) / kStages) & 1);
        wgmma_fence();
        const uint32_t kt = tiles + T::K_OFF + s * T::T_BYTES;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n128(sc, kmajor<D, WQ>(q_tile, ks), kmajor<D, WK>(kt, ks),
                        ks > 0);
        wgmma_commit();
      };
      // O += P V of tile i, P from registers
      auto issue_pv = [&](int i) {
        const int s = (tile + i) % kStages;
        mbar_wait(v_full + 8 * s, ((tile + i) / kStages) & 1);
        wgmma_fence();
        const uint32_t vt = tiles + T::V_OFF + s * T::T_BYTES;
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk) wgmma_pv<D, WK>(acc, pf[kk], vt, kk);
        wgmma_commit();
      };
      // once S of tile i is in sc: release K, then the softmax
      auto softmax = [&](int i) {
        fence_regs<WK / 2>(sc);
        mbar_arrive(k_empty + 8 * ((tile + i) % kStages));
        const int k0 = x.k_begin + i * WK;
        // a tile every row of the warpgroup sees whole needs no mask
        const bool whole = k0 + WK <= sk &&
            (!causal || (k0 + WK - 1 <= r_lo &&
                         (window <= 0 || k0 > r_lo + 63 - window)));
        softmax_tile(sc, m, l, corr, whole, row0, k0, t, sq, sk, causal,
                     window, scale2);
      };
      // once P V of tile i is done: release V
      auto pv_done = [&](int i) {
        fence_regs<D / 2>(acc);
        fence_regs<WK / 4>(&pf[0][0]);       // P may be rewritten now
        mbar_arrive(v_empty + 8 * ((tile + i) % kStages));
      };
      // scale O to the new maxima and pack P as bf16 A fragments: P's
      // k-step kk is S's column chunks 2 kk and 2 kk + 1
      auto rescale_pack = [&]() {
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {
          acc[4 * jj] *= corr[0];
          acc[4 * jj + 1] *= corr[0];
          acc[4 * jj + 2] *= corr[1];
          acc[4 * jj + 3] *= corr[1];
        }
#pragma unroll
        for (int kk = 0; kk < WK / 16; ++kk) {
          pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
          pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      };

      // Step i issues S of tile i and then P V of tile i - 1, and runs
      // tile i's softmax while the tensor cores finish P V.
      mbar_wait(q_full, j & 1);
      const int n = x.n_tiles;
      if (n > 0) {
        bar_sync(mine);
        issue_s(0);
        bar_arrive(other);
        wgmma_wait<0>();
        softmax(0);
        rescale_pack();
      }
      for (int i = 1; i < n; ++i) {
        bar_sync(mine);
        issue_s(i);
        issue_pv(i - 1);
        bar_arrive(other);
        wgmma_wait<1>();
        softmax(i);
        wgmma_wait<0>();
        pv_done(i - 1);
        rescale_pack();
      }
      mbar_arrive(q_empty);                  // every S of this item is done
      if (n > 0) {
        bar_sync(mine);
        issue_pv(n - 1);
        bar_arrive(other);
        wgmma_wait<0>();
        pv_done(n - 1);
      }
      tile += n;

#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float lsum = l[hr];
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
        lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
        const int row = row0 + 8 * hr;
        if (row < sq) {
          const float inv = 1.f / fmaxf(lsum, 1e-30f);
          __nv_bfloat16* dst =
              o + x.b * ob + (long long)row * os + x.h * oh;
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj)
            if (8 * jj + 2 * t < d)           // d even: both columns or none
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj + 2 * t) =
                  __floats2bfloat162_rn(acc[4 * jj + 2 * hr] * inv,
                                        acc[4 * jj + 2 * hr + 1] * inv);
          // m is in base 2 (scores times scale log2 e): lse in natural log
          if (lse != nullptr && t == 0)
            lse[((long long)x.b * H + x.h) * sq + row] =
                (m[hr] + log2f(fmaxf(lsum, 1e-30f))) * kLn2;
        }
      }
    }
    if (cw == 0) bar_sync(mine);
  }
}

// ------------------------------------------------ CUDA cores

constexpr int TR = BQ / 16;     // rows per thread
constexpr int TC = BK / 8;      // keys per thread
constexpr int PS = BK + 8;      // P row stride in floats (conflict-free)

// Thread (ty, tx) of 16 x 8 owns query rows ty + 16 i (i < 4) and keys
// tx + 8 j (j < 8) of S = Q K^T; the row max and sum run over the 8 lanes
// that share a row (xor shuffles). P goes through shared memory for
// O += P V, where the thread owns rows ty + 16 i and DP/8 contiguous
// columns. T is the inputs' and the output's type (float or bfloat16); the
// tiles are float32 in shared memory, D padded to DP with zeros.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_core(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int sq, int sk, int rep, int d,
               Strides st, float scale, int causal, int window, int vec) {
  constexpr int LD = DP + 4;
  constexpr int CW = DP / 8;    // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;
  load_rows<T, DP, BQ>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, sq, d, vec);

  int k_begin = 0, k_end = sk;
  if (causal) {
    k_end = min(sk, q0 + BQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }

  float m[TR], l[TR], acc[TR][CW];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_begin / BK) * BK; k0 < k_end; k0 += BK) {
    __syncthreads();            // the last tile's K, V and P reads are done
    load_rows<T, DP, BK>(Ks, kb, st.ks, k0, sk, d, vec);
    load_rows<T, DP, BK>(Vs, vb, st.vs, k0, sk, d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < DP; d0 += 4) {
      float4 qv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d0);
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * LD + d0);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          s[i][j] = fmaf(qv[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv.w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int row = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int key = k0 + tx + 8 * j;
        s[i][j] = visible(row, key, sq, sk, causal, window) ? s[i][j] * scale
                                                            : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mn = fmaxf(m[i], mt);
      const float corr = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= corr;         // a per-thread partial: the 8 lanes share corr
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const float p = s[i][j] != kNegInf ? expf(s[i][j] - mn) : 0.f;
        l[i] += p;
        Ps[(ty + 16 * i) * PS + tx + 8 * j] = p;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BK; ++kk) {
      float pv[TR];
#pragma unroll
      for (int i = 0; i < TR; ++i) pv[i] = Ps[(ty + 16 * i) * PS + kk];
      const float* vr = Vs + kk * LD + tx * CW;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vv = vr[c];
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + ty + 16 * i;
    if (row < sq) {
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      T* dst = o + b * st.ob + (long long)row * st.os + h * st.oh;
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (tx * CW + c < d) from_f(acc[i][c] * inv, dst + tx * CW + c);
      if (lse != nullptr && tx == 0)
        lse[((long long)b * gridDim.y + h) * sq + row] =
            m[i] + logf(fmaxf(lt, 1e-30f));
    }
  }
}

template <int DP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int sq, int sk, int H, int Hkv, int d,
                const Strides& st, float scale, int causal, int window,
                cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tensor_map<DP>(&mq, q, B, sq, H, d, st.qb, st.qs, st.qh) ||
      !tensor_map<DP>(&mk, k, B, sk, Hkv, d, st.kb, st.ks, st.kh) ||
      !tensor_map<DP>(&mv, v, B, sk, Hkv, d, st.vb, st.vs, st.vh))
    return (int)cudaErrorInvalidValue;
  const int smem = Tiles<DP>::BYTES + 1024;    // + the 1024-byte alignment
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  static int sms = 0;           // one persistent block per SM
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const long long items = (long long)((sq + WQ - 1) / WQ) * H * B;
  if (items > 0x7fffffff || sms <= 0) return (int)cudaErrorInvalidValue;
  // pairs a window: their K and V within 16 MB of the 50 MB L2
  const long long pair_bytes = (long long)sk * DP * 2 * 2;
  const int pairs = B * Hkv;
  int W = (int)((16ll << 20) / pair_bytes);
  W = W < 1 ? 1 : W > pairs ? pairs : W;
  flash_fwd_wgmma<DP><<<(int)(items < sms ? items : sms), kWsThreads, smem,
                        stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, sq, sk, H, B,
      H / Hkv, W, st.ob, st.os, st.oh, scale * kLog2e, causal, window, d);
  return (int)cudaGetLastError();
}

template <typename T, int DP>
int launch_core(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int sq, int sk, int H, int rep, int d,
                const Strides& st, float scale, int causal, int window,
                int vec, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * BK) * (DP + 4) * sizeof(float)
                      + (size_t)BQ * PS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_core<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, H, B);
  flash_fwd_core<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, rep, d, st,
      scale, causal, window, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int by_width_core(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int sq, int sk, int H, int rep, int d,
                  const Strides& st, float scale, int causal, int window,
                  int vec, cudaStream_t s) {
#define REPRO_FLASH_CORE(DP)                                                 \
  if (d <= DP)                                                               \
    return launch_core<T, DP>(q, k, v, o, lse, B, sq, sk, H, rep, d, st,     \
                              scale, causal, window, vec, s);
  REPRO_FLASH_CORE(32)
  REPRO_FLASH_CORE(64)
  REPRO_FLASH_CORE(96)
  REPRO_FLASH_CORE(128)
  REPRO_FLASH_CORE(192)
  REPRO_FLASH_CORE(256)
#undef REPRO_FLASH_CORE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The path a launch takes: 1 for the bf16 wgmma + TMA kernel (bfloat16,
// every base and stride 16-byte aligned: vec, 16 <= D <= 128), 0 for the
// CUDA-core kernel.
int flash_attention_path(int D, int dtype, int vec) {
  return dtype == 1 && vec && D >= 16 && D <= 128;
}

// q (B, sq, H, D), k/v (B, sk, Hkv, D), o (B, sq, H, D): all of one dtype
// (0 float32, 1 bfloat16), strides in elements with a contiguous last dim;
// lse: null, or a contiguous float32 (B, H, sq) for each row's log-sum-exp;
// D a multiple of 4 up to 256, any H / Hkv. window <= 0 means none. vec:
// every row start is 16-byte aligned (TMA for bfloat16, 16-byte copies for
// float32); without it rows load element by element. device: the CUDA
// device of every pointer.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int sq, int sk, int H,
                           int Hkv, int D, int dtype, long long qsb,
                           long long qss, long long qsh, long long ksb,
                           long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh, long long osb,
                           long long oss, long long osh, float scale,
                           int causal, int window, int vec, int device,
                           void* stream) {
  if (B <= 0 || sq <= 0 || sk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv <= 0 || B > 65535 || H > 65535 || D <= 0 || D % 4 != 0 ||
      D > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  // make the device's primary context current on the calling thread: on a
  // thread whose first CUDA call this is, cuTensorMapEncodeTiled for
  // the bf16 launch would find none and fail
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flash_attention_path(D, dtype, vec)) {
#define REPRO_FLASH_BF16(DP)                                                 \
    if (D <= DP)                                                             \
      return launch_bf16<DP>(q, k, v, o, lse, B, sq, sk, H, Hkv, D, st,      \
                             scale, causal, window, s);
    REPRO_FLASH_BF16(16)
    REPRO_FLASH_BF16(32)
    REPRO_FLASH_BF16(48)
    REPRO_FLASH_BF16(64)
    REPRO_FLASH_BF16(80)
    REPRO_FLASH_BF16(96)
    REPRO_FLASH_BF16(128)
#undef REPRO_FLASH_BF16
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return by_width_core<float>(q, k, v, o, lse, B, sq, sk, H, H / Hkv, D,
                                st, scale, causal, window, vec, s);
  return by_width_core<__nv_bfloat16>(q, k, v, o, lse, B, sq, sk, H, H / Hkv,
                                      D, st, scale, causal, window, vec, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
