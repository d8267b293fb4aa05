// Expected-Attention scores for KV-cache compression (paper §3.2):
//
//   score(b, s, h) = ||v|| * sum_r exp(clip(mu_r.k * scale
//                                          + var_r.k^2 * scale^2 / 2, ±30))
//
// with scale = 1/sqrt(D), mu and var the (Hkv, rep, D) rope'd query
// statistics of the layer, K and V read in the reference's (B, S, Hkv, D)
// layout through their strides; only the (B, S, Hkv) float32 scores leave.
// The quadratic term is scaled as 0.5 * scale^2 = 1/(2D), as in the Pallas
// kernel (:37).
//
// Replaces the Pallas kernel src/repro/kernels/expected_attention/kernel.py
// ea_scores (:41, _ea_kernel), which streams (kc, D) K/V tiles per
// (b, h) and runs the two (kc, D) x (D, rep) moment products on the MXU.
//
// What bounds it on the H100: one pass over K and V. At the KV-batch build
// (B = 23 unique medoids, S 2880, Hkv 8, rep 4, D 128, bf16) that is 271 MB
// a layer, 0.0816 ms at 3.35 TB/s, against 1.4 GFLOP; bytes bound it.
//
// The vector path (ea_vector_kernel, bf16 on 16-byte boundaries):
// - Each block works on one head h (grid.y), so a lane keeps its 8 columns
//   of mu_h and var_h (pre-scaled) in registers, and its warp's rows are
//   strided over (b, s). A lane reads 16 bytes (8 bf16) of a K row and of a
//   V row: D / 8 lanes cover a row, a warp pass covers 256 / D rows, and the
//   loads of kU = 4 passes are in flight before any arithmetic.
// - A lane forms, per row, the rep moments sum_c (k mu' + k^2 var') and
//   ||v||^2 over its 8 columns; a transposing butterfly over the row's
//   lanes (each step trades half of the rows held, as the probe's wide scan
//   does) leaves each lane with whole sums for 1 row (2 at D = 16), shared
//   by G = D / 32 lanes (1 below D = 64), which split the exps between them;
//   one shuffle step per halving of G adds them. At D 128 and rep 4 a warp
//   step (8 rows) costs 25 shuffles for the sums and 2 for the exps, and
//   every lane runs one exp (the first design: 45 shuffles a row, then
//   lane 0 alone ran the exps).
// - rep is taken in groups of at most 8 query heads, each rounded up to a
//   power of two (1, 2, 4, 8); moments past the group are zero and left
//   out of the sum. A group is one pass over the head's rows (rep 16: two
//   passes, each reading K and V once), the second adding to the first's
//   scores, which the same lane wrote.
// - Any D <= 256 that is a multiple of 8: a kernel is built for D' in
//   {16, 32, 64, 128, 256}, and the lanes past D load nothing and hold
//   zero mu and var.
// - A persistent grid: as many blocks of 4 warps as fit on the card, over
//   Hkv heads.
//
// The scalar-load path (ea_scores_kernel) is the first design, kept for
// inputs the 16-byte loads cannot take (float32 or an fp8 e4m3 serve
// cache, a base or a stride not a multiple of 8 elements, D not a multiple
// of 8): one warp a row, lane +
// 32 e columns a lane (any D up to 256), mu and var read through the
// read-only cache, groups of 8 query heads in turn, a warp butterfly,
// lane 0 finishes.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRep = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Strides {                 // elements; the head-dim stride is 1
  long long kb, ks, kh, vb, vs, vh;
};

// ------------------------------------------------------- scalar-load path

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

// E: columns a lane holds (lane + 32 e < d), so d <= 32 E
template <typename T, int E>
__global__ void __launch_bounds__(kThreads)
ea_scores_kernel(const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ mu, const float* __restrict__ var,
                 float* __restrict__ out, long long nrows, int S, int Hkv,
                 int rep, int d, Strides st, float scale) {
  const float qscale = 0.5f * scale * scale;
  const int lane = threadIdx.x & 31;
  const long long nwarps = (long long)gridDim.x * (kThreads / 32);
  for (long long row = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       row < nrows; row += nwarps) {
    const int h = (int)(row % Hkv);
    const long long bs = row / Hkv;
    const long long s = bs % S, b = bs / S;
    const T* kr = k + b * st.kb + s * st.ks + h * st.kh;
    const T* vr = v + b * st.vb + s * st.vs + h * st.vh;
    float kv[E], vv = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const bool in = lane + 32 * e < d;
      kv[e] = in ? to_f(kr[lane + 32 * e]) : 0.f;
      const float y = in ? to_f(vr[lane + 32 * e]) : 0.f;
      vv = fmaf(y, y, vv);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      vv += __shfl_xor_sync(0xffffffffu, vv, off);
    float per = 0.f;
    for (int g0 = 0; g0 < rep; g0 += kMaxRep) {   // groups of 8 query heads
      const int rg = min(kMaxRep, rep - g0);
      float lin[kMaxRep], quad[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        lin[r] = quad[r] = 0.f;
        if (r < rg) {
          const float* m = mu + ((long long)h * rep + g0 + r) * d;
          const float* va = var + ((long long)h * rep + g0 + r) * d;
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const int c = lane + 32 * e;
            if (c < d) {
              lin[r] = fmaf(kv[e], __ldg(m + c), lin[r]);
              quad[r] = fmaf(kv[e] * kv[e], __ldg(va + c), quad[r]);
            }
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r < rg) {
            lin[r] += __shfl_xor_sync(0xffffffffu, lin[r], off);
            quad[r] += __shfl_xor_sync(0xffffffffu, quad[r], off);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rg)
          per += expf(fminf(fmaxf(lin[r] * scale + quad[r] * qscale, -30.f),
                            30.f));
    }
    if (lane == 0) out[row] = per * sqrtf(vv);
  }
}

template <typename T, int E>
int launch(const void* k, const void* v, const void* mu, const void* var,
           void* out, int B, int S, int Hkv, int rep, int d,
           const Strides& st, float scale, cudaStream_t stream) {
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess)
    return (int)err;
  const long long nrows = (long long)B * S * Hkv;
  const long long need = (nrows + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = (int)(need < (long long)sms * kBlocksPerSm
                             ? need : (long long)sms * kBlocksPerSm);
  ea_scores_kernel<T, E><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mu), static_cast<const float*>(var),
      static_cast<float*>(out), nrows, S, Hkv, rep, d, st, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scalar(const void* k, const void* v, const void* mu,
                  const void* var, void* out, int B, int S, int Hkv, int rep,
                  int d, const Strides& st, float scale, cudaStream_t s) {
  if (d <= 32) return launch<T, 1>(k, v, mu, var, out, B, S, Hkv, rep, d, st, scale, s);
  if (d <= 64) return launch<T, 2>(k, v, mu, var, out, B, S, Hkv, rep, d, st, scale, s);
  if (d <= 128) return launch<T, 4>(k, v, mu, var, out, B, S, Hkv, rep, d, st, scale, s);
  return launch<T, 8>(k, v, mu, var, out, B, S, Hkv, rep, d, st, scale, s);
}


// ------------------------------------------------------------ vector path

constexpr int kVecThreads = 128;   // 4 warps a block, all on one head
constexpr int kU = 4;              // warp passes a step, their loads in flight

__device__ __forceinline__ void unpack_bf16x8(const uint4 r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {    // the lower half is the first element
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x / 2);
}

// RP: a group's query heads rounded up to a power of two (moments past the
// group are zero and left out of the sum); D the width built, d (<= D, a
// multiple of 8) the cache's own. Block (x, h) scores head h at positions
// strided over (b, s); a lane reads 16 bytes (8 columns) of a K row and a
// V row. The groups of 8 query heads run one after another, each a pass
// over the block's positions; a pass adds its exps to the scores the
// earlier passes wrote (the same lane writes a position every pass).
template <int D, int RP>
__global__ void __launch_bounds__(kVecThreads)
ea_vector_kernel(const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const float* __restrict__ mu, const float* __restrict__ var,
                 float* __restrict__ out, unsigned npos, unsigned S, int Hkv,
                 int rep, int d, Strides st, float scale) {
  constexpr int LPR = D / 8;                  // lanes a row
  constexpr int RPW = 32 / LPR;               // rows a warp pass
  constexpr int V = RP + 1;                   // sums a row: RP moments, ||v||^2
  constexpr int LB = log2i(LPR);
  constexpr int TS = LB < 2 ? LB : 2;         // transposing steps (kU = 4)
  constexpr int UR = kU >> TS;                // rows a lane holds after them
  constexpr int G = LPR >> TS;                // lanes that then share a row
  static_assert(LPR * 8 == D && RPW * LPR == 32, "head dim");

  const int h = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q = lane % LPR, sub = lane / LPR;
  const bool cols = q * 8 < d;                // this lane's columns are real
  const float qscale = 0.5f * scale * scale;
  const unsigned step = kU * RPW;
  const unsigned warps = gridDim.x * (kVecThreads / 32);
  const unsigned start = (blockIdx.x * (kVecThreads / 32) + (threadIdx.x >> 5))
                         * step;

  for (int g0 = 0; g0 < rep; g0 += kMaxRep) {  // groups of 8 query heads
    const int rg = min(kMaxRep, rep - g0);
    // this lane's 8 columns of the group's mu and var, scaled, in registers
    float m[RP][8], w[RP][8];
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const long long i = ((long long)h * rep + g0 + r) * d + q * 8 + e;
        const bool ok = r < rg && cols;
        m[r][e] = ok ? __ldg(mu + i) * scale : 0.f;
        w[r][e] = ok ? __ldg(var + i) * qscale : 0.f;
      }

    for (unsigned base = start; base < npos; base += warps * step) {
      uint4 kr[kU], vr[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const unsigned p = base + u * RPW + sub;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (p < npos && cols) {
          const long long b = p / S, s = p - (unsigned)b * S;
          kr[u] = __ldg(reinterpret_cast<const uint4*>(
              k + b * st.kb + s * st.ks + h * st.kh + q * 8));
          vr[u] = __ldg(reinterpret_cast<const uint4*>(
              v + b * st.vb + s * st.vs + h * st.vh + q * 8));
        }
      }
      float acc[kU][V];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        float kf[8], vf[8];
        unpack_bf16x8(kr[u], kf);
        unpack_bf16x8(vr[u], vf);
        float vv = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) vv = fmaf(vf[e], vf[e], vv);
        acc[u][RP] = vv;
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            a = fmaf(kf[e], m[r][e], fmaf(kf[e] * kf[e], w[r][e], a));
          acc[u][r] = a;
        }
      }
      // transposing butterfly over the row's lanes: each step trades half
      // of the rows held, so a lane ends with UR rows' sums and G lanes
      // share one
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        const int o = LPR >> (i + 1);
        const int half = (kU >> i) / 2;
        const bool upper = lane & o;
#pragma unroll
        for (int u = 0; u < half; ++u)
#pragma unroll
          for (int c = 0; c < V; ++c) {
            const float keep = upper ? acc[u + half][c] : acc[u][c];
            const float send = upper ? acc[u][c] : acc[u + half][c];
            acc[u][c] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < UR; ++u)
#pragma unroll
          for (int c = 0; c < V; ++c)
            acc[u][c] += __shfl_xor_sync(0xffffffffu, acc[u][c], o);
      // the exps: the G lanes of a row take moments gq, gq + G, ...
      const int gq = lane & (G - 1);
#pragma unroll
      for (int j = 0; j < UR; ++j) {
        float e = 0.f;
#pragma unroll
        for (int r0 = 0; r0 < RP; r0 += G) {
          float t = acc[j][r0];
#pragma unroll
          for (int x = 1; x < G; ++x)
            if (r0 + x < RP && gq == x) t = acc[j][r0 + x];
          if (r0 + gq < rg) e += expf(fminf(fmaxf(t, -30.f), 30.f));
        }
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          e += __shfl_xor_sync(0xffffffffu, e, o);
        int u = j;                    // the pass this lane's row j came from
#pragma unroll
        for (int i = 0; i < TS; ++i)
          if (lane & (LPR >> (i + 1))) u += kU >> (i + 1);
        const unsigned p = base + u * RPW + sub;
        if (gq == 0 && p < npos) {
          float* dst = out + (size_t)p * Hkv + h;
          const float sc = e * sqrtf(acc[j][RP]);
          *dst = g0 == 0 ? sc : *dst + sc;
        }
      }
    }
  }
}

template <int D, int RP>
int launch_vector(const void* k, const void* v, const void* mu,
                  const void* var, void* out, int B, int S, int Hkv, int rep,
                  int d, const Strides& st, float scale, cudaStream_t stream) {
  auto kern = ea_vector_kernel<D, RP>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kVecThreads, 0)) != cudaSuccess)
    return (int)err;
  const unsigned npos = (unsigned)B * (unsigned)S;
  const long long rows = 4LL * kU * (256 / D);   // positions a block step
  const long long need = ((long long)npos + rows - 1) / rows;
  const long long fit = ((long long)sms * (per_sm > 0 ? per_sm : 1) + Hkv - 1)
                        / Hkv;
  const dim3 grid((unsigned)(need < fit ? need : fit), (unsigned)Hkv);
  kern<<<grid, kVecThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const float*>(mu), static_cast<const float*>(var),
      static_cast<float*>(out), npos, (unsigned)S, Hkv, rep, d, st, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_vector_rep(const void* k, const void* v, const void* mu,
                      const void* var, void* out, int B, int S, int Hkv,
                      int rep, int d, const Strides& st, float scale,
                      cudaStream_t s) {
  if (rep <= 1) return launch_vector<D, 1>(k, v, mu, var, out, B, S, Hkv, rep, d, st, scale, s);
  if (rep <= 2) return launch_vector<D, 2>(k, v, mu, var, out, B, S, Hkv, rep, d, st, scale, s);
  if (rep <= 4) return launch_vector<D, 4>(k, v, mu, var, out, B, S, Hkv, rep, d, st, scale, s);
  return launch_vector<D, 8>(k, v, mu, var, out, B, S, Hkv, rep, d, st, scale, s);
}

}  // namespace

extern "C" {

// The scalar-load path: k/v (B, S, Hkv, D) of dtype (0 float32, 1
// bfloat16, 2 fp8 e4m3), strides in elements with a contiguous last dim; mu/var
// (Hkv, rep, D) contiguous float32; out (B, S, Hkv) contiguous float32.
// D a multiple of 4 up to 256, any rep.
int ea_scores_scalar_launch(const void* k, const void* v, const void* mu,
                     const void* var, void* out, int B, int S, int Hkv,
                     int rep, int D, int dtype, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || rep <= 0 || D <= 0 || D % 4 != 0
      || D > 256)
    return (int)cudaErrorInvalidValue;
  const Strides st{ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scalar<float>(k, v, mu, var, out, B, S, Hkv, rep, D, st,
                                scale, s);
  if (dtype == 1)
    return launch_scalar<__nv_bfloat16>(k, v, mu, var, out, B, S, Hkv, rep,
                                        D, st, scale, s);
  if (dtype == 2)
    return launch_scalar<__nv_fp8_e4m3>(k, v, mu, var, out, B, S, Hkv, rep,
                                        D, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The vector path: k/v (B, S, Hkv, D) bfloat16, bases and strides (in
// elements, last dim contiguous) multiples of 8 elements; mu/var
// (Hkv, rep, D) contiguous float32; out (B, S, Hkv) contiguous float32.
// D a multiple of 8 up to 256, any rep, B * S < 2^32.
int ea_scores_vector_launch(const void* k, const void* v, const void* mu,
                            const void* var, void* out, int B, int S, int Hkv,
                            int rep, int D, long long ksb, long long kss,
                            long long ksh, long long vsb, long long vss,
                            long long vsh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hkv > 65535 || rep <= 0 || D <= 0
      || D % 8 != 0 || D > 256 || (long long)B * S >= (1LL << 32))
    return (int)cudaErrorInvalidValue;
  const long long strides[6] = {ksb, kss, ksh, vsb, vss, vsh};
  for (long long x : strides)
    if (x % 8 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  const Strides st{ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_vector_rep<16>(k, v, mu, var, out, B, S, Hkv, rep, D, st, scale, s);
  if (D <= 32) return launch_vector_rep<32>(k, v, mu, var, out, B, S, Hkv, rep, D, st, scale, s);
  if (D <= 64) return launch_vector_rep<64>(k, v, mu, var, out, B, S, Hkv, rep, D, st, scale, s);
  if (D <= 128) return launch_vector_rep<128>(k, v, mu, var, out, B, S, Hkv, rep, D, st, scale, s);
  return launch_vector_rep<256>(k, v, mu, var, out, B, S, Hkv, rep, D, st, scale, s);
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
