// Flash attention forward: causal, windowed or full GQA attention with an
// online softmax; the (Sq, Sk) score matrix is never built.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/kernel.py
// flash_fwd (:74, _flash_fwd_kernel). Its grid (B, H, nq, nk) walks the KV
// axis in order and carries (m, l, acc) in VMEM scratch; here a block owns
// one (q tile, head, batch) and a loop over KV tiles takes the place of the
// sequential nk axis, with (m, l, acc) in registers. The state is float32
// and masked scores are NEG_INF = -1e30, as there (:24). GQA reads KV head
// h / rep. Inputs are read in the reference's (B, S, H, D) layout through
// their strides (the last dim must be contiguous); the ragged last q and kv
// tiles are masked here, so nothing is padded or transposed on the way in.
// Key tiles wholly above the causal diagonal (or wholly before the window)
// are skipped: they add exactly zero. q tiles run heaviest first.
//
// Bound on the H100 at the KV-batch prefill (B 32, S 2880, H 32, Hkv 8,
// D 128, bf16): 2.18e12 causal FLOP per layer over 989 TFLOP/s bf16 is
// 2.20 ms, above the 1.89 GB read and written (0.56 ms), so operations
// bound it. Two kernels:
//
// * bfloat16 (the prefill): both products on the tensor cores with
//   mma.sync m16n8k16 (bf16 in, float32 accumulate). A block is 4 warps
//   over a 64-row q tile, each warp 16 rows; keys come in tiles of 64.
//   The warp keeps its Q fragments, its S = Q K^T tile and its O
//   accumulator in registers; S is scaled, masked and exponentiated in
//   float32 there, then P is rounded to bf16 and fed straight back as the
//   A operand of O += P V (the C-fragment layout of S is the A-fragment
//   layout of P). K and V tiles are double-buffered in shared memory with
//   cp.async, so the next tile loads while this one is multiplied; rows
//   are padded by 16 bytes so ldmatrix reads hit distinct banks.
// * float32: both products in float32 FMAs on the CUDA cores (16 x 8
//   threads, each 4 query rows x 8 keys), exact to the float32 tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int kThreads = 128;

struct Strides {                // elements; the head-dim stride is 1
  long long qb, qs, qh, kb, ks, kh, vb, vs, vh, ob, os, oh;
};

// rows [r0, r0 + ROWS) of a (n, D) slice with row stride rs into smem
// [ROWS][D + 16 / sizeof(T)] as 16-byte chunks: cp.async when every row
// start is 16-byte aligned (vec), element by element otherwise; rows >= n
// become zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const T* g, long long rs,
                                          int r0, int n, bool vec) {
  constexpr int N = 16 / sizeof(T);
  constexpr int LD = D + N;
  constexpr int PER_ROW = D / N;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += kThreads) {
    const int r = idx / PER_ROW, c = (idx % PER_ROW) * N;
    T* dst = s + r * LD + c;
    const int row = r0 + r;
    if (row < n) {
      const T* src = g + (long long)row * rs + c;
      if (vec) {
        const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(d), "l"(src));
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) dst[e] = src[e];
      }
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
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

// ------------------------------------------------ bfloat16: tensor cores

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t. A (16 x 16):
// a0 (row g, cols 2t, 2t+1), a1 (row g+8, same), a2 (row g, cols 8+2t..),
// a3 (row g+8, cols 8+2t..). B (16 x 8): b0 (rows 2t, 2t+1, col g), b1
// (rows 8+2t.., col g). C (16 x 8): c0, c1 (row g, cols 2t, 2t+1), c2, c3
// (row g+8, same cols).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int sq, int sk, int rep,
              Strides st, float scale, int causal, int window, int vec) {
  using T = __nv_bfloat16;
  constexpr int LD = D + 8;     // smem row stride in elements (16-byte pad)
  constexpr int KS = D / 16;    // k-steps of Q K^T
  constexpr int NT = BK / 8;    // key n-tiles of S
  constexpr int DT = D / 8;     // column n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + BQ * LD;         // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;     // [2][BK][LD]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  const T* kb = k + b * st.kb + hk * st.kh;
  const T* vb = v + b * st.vb + hk * st.vh;

  int k_begin = 0, k_end = sk;
  if (causal) {                 // q_offset is 0: row r sees keys <= r
    k_end = min(sk, q0 + BQ);
    if (window > 0) k_begin = max(0, q0 - window + 1);
  }
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  load_tile<T, D, BQ>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, sq, vec);
  load_tile<T, D, BK>(Ks, kb, st.ks, k_begin, sk, vec);
  load_tile<T, D, BK>(Vs, vb, st.vs, k_begin, sk, vec);
  cp_async_commit();

  uint32_t qf[KS][4];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int wr0 = q0 + warp * 16;        // the warp's first row
  const int row0 = wr0 + g;              // this thread's rows: row0, row0 + 8
  const float scale2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * BK, buf = it & 1;
    if (it + 1 < n_tiles) {     // the next tile loads while this one runs
      load_tile<T, D, BK>(Ks + (buf ^ 1) * BK * LD, kb, st.ks, k0 + BK, sk, vec);
      load_tile<T, D, BK>(Vs + (buf ^ 1) * BK * LD, vb, st.vs, k0 + BK, sk, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16
                                + (lane >> 4) * 8);
    }
    const T* Kt = Ks + buf * BK * LD;
    const T* Vt = Vs + buf * BK * LD;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n = 0; n < NT; n += 2) {   // two key n-tiles per ldmatrix
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[n], qf[ks], kf[0], kf[1]);
        mma_bf16(s[n + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale, mask and the online softmax (in base 2) for rows row0 (c0,
    // c1) and row0 + 8 (c2, c3); a row's 64 scores sit in the 4 lanes of a
    // quad. A tile that every row of the warp sees whole needs no mask.
    const bool whole = k0 + BK <= sk && wr0 + 16 <= sq &&
        (!causal || (k0 + BK - 1 <= wr0 &&
                     (window <= 0 || k0 > wr0 + 15 - window)));
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + 8 * hr;
      float mt = kNegInf;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + n * 8 + 2 * t + e;
          float& x = s[n][2 * hr + e];
          x = whole || visible(row, key, sq, sk, causal, window) ? x * scale2
                                                                 : kNegInf;
          mt = fmaxf(mt, x);
        }
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float mn = fmaxf(m[hr], mt);
      const float corr = exp2f(m[hr] - mn);
      m[hr] = mn;
      l[hr] *= corr;            // a per-lane partial: the quad shares corr
#pragma unroll
      for (int j = 0; j < DT; ++j) {
        acc[j][2 * hr] *= corr;
        acc[j][2 * hr + 1] *= corr;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[n][2 * hr + e];
          x = x != kNegInf ? exp2f(x - mn) : 0.f;
          l[hr] += x;
        }
      }
    }

    // O += P V: P's k-step kk is key n-tiles 2kk and 2kk + 1
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pf[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < DT; j += 2) {   // two column n-tiles per ldmatrix
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + (lane & 7)
                                    + ((lane >> 3) & 1) * 8) * LD
                                  + j * 8 + (lane >> 4) * 8);
        mma_bf16(acc[j], pf, vf[0], vf[1]);
        mma_bf16(acc[j + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();            // buf is refilled two tiles from now
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row0 + 8 * hr;
    if (row < sq) {
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      T* dst = o + b * st.ob + (long long)row * st.os + h * st.oh;
#pragma unroll
      for (int j = 0; j < DT; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[j][2 * hr] * inv,
                                  acc[j][2 * hr + 1] * inv);
    }
  }
}

// ------------------------------------------------ float32: CUDA cores

constexpr int TR = BQ / 16;     // rows per thread
constexpr int TC = BK / 8;      // keys per thread
constexpr int PS = BK + 8;      // P row stride in floats (conflict-free)

// Thread (ty, tx) of 16 x 8 owns query rows ty + 16 i (i < 4) and keys
// tx + 8 j (j < 8) of S = Q K^T; the row max and sum run over the 8 lanes
// that share a row (xor shuffles). P goes through shared memory for
// O += P V, where the thread owns rows ty + 16 i and D/8 contiguous columns.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int sq,
              int sk, int rep, Strides st, float scale, int causal,
              int window, int vec) {
  constexpr int LD = D + 4;
  constexpr int CW = D / 8;     // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / rep;
  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;

  const float* kb = k + b * st.kb + hk * st.kh;
  const float* vb = v + b * st.vb + hk * st.vh;
  load_tile<float, D, BQ>(Qs, q + b * st.qb + h * st.qh, st.qs, q0, sq, vec);

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
    load_tile<float, D, BK>(Ks, kb, st.ks, k0, sk, vec);
    load_tile<float, D, BK>(Vs, vb, st.vs, k0, sk, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[TR][TC];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 4) {
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
      float* dst = o + b * st.ob + (long long)row * st.os + h * st.oh + tx * CW;
#pragma unroll
      for (int c = 0; c < CW; ++c) dst[c] = acc[i][c] * inv;
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int sq, int sk, int H, int rep, const Strides& st, float scale,
                int causal, int window, int vec, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 4 * BK) * (D + 8) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, H, B);
  flash_fwd_mma<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      sk, rep, st, scale, causal, window, vec);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int sq, int sk, int H, int rep, const Strides& st, float scale,
               int causal, int window, int vec, cudaStream_t stream) {
  const size_t smem = (size_t)(BQ + 2 * BK) * (D + 4) * sizeof(float)
                      + (size_t)BQ * PS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, rep, st,
      scale, causal, window, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, sq, H, D), k/v (B, sk, Hkv, D), o (B, sq, H, D): all of one dtype
// (0 float32, 1 bfloat16), strides in elements with a contiguous last dim;
// D in {16, 32, 64, 128}. window <= 0 means none. vec: every row start is
// 16-byte aligned, so tiles load as 16-byte copies.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int sq, int sk, int H, int Hkv,
                           int D, int dtype, long long qsb, long long qss,
                           long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss,
                           long long vsh, long long osb, long long oss,
                           long long osh, float scale, int causal, int window,
                           int vec, void* stream) {
  if (B <= 0 || sq <= 0 || sk <= 0 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh};
  const int rep = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(CODE, FN, DIM)                                      \
  if (dtype == CODE && D == DIM)                                             \
    return FN<DIM>(q, k, v, o, B, sq, sk, H, rep, st, scale, causal, window, \
                   vec, s);
  REPRO_FLASH_CASE(0, launch_f32, 16)
  REPRO_FLASH_CASE(0, launch_f32, 32)
  REPRO_FLASH_CASE(0, launch_f32, 64)
  REPRO_FLASH_CASE(0, launch_f32, 128)
  REPRO_FLASH_CASE(1, launch_bf16, 16)
  REPRO_FLASH_CASE(1, launch_bf16, 32)
  REPRO_FLASH_CASE(1, launch_bf16, 64)
  REPRO_FLASH_CASE(1, launch_bf16, 128)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
