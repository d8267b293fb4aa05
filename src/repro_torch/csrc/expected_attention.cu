// Expected-Attention scores for KV-cache compression (paper §3.2):
//
//   score(b, s, h) = ||v|| * sum_r exp(clip(mu_r.k * scale
//                                          + var_r.k^2 * scale^2 / 2, ±30))
//
// with scale = 1/sqrt(D), mu and var the (Hkv, rep, D) rope'd query
// statistics of the layer.
//
// Replaces the Pallas kernel src/repro/kernels/expected_attention/kernel.py
// ea_scores (:41, _ea_kernel), which streams (kc, D) K/V tiles per
// (b, h) and runs the two (kc, D) x (D, rep) moment products on the MXU.
// The work is one bandwidth-bound pass, so here one warp scores one cached
// position (one K row and one V row, each read once, in the reference's
// (B, S, Hkv, D) layout through its strides): each lane takes the columns
// lane + 32 e < D, forms the rep linear and quadratic moments and ||v||^2 in
// float32, and a warp butterfly sums them; lane 0 applies the clip, the
// exp and the norm and writes one float. mu and var for every head sit in
// shared memory; only the (B, S, Hkv) float32 scores leave. The quadratic
// term is scaled as 0.5 * scale^2 = 1/(2D), as in the Pallas kernel (:37).
// Warps stride over the rows in the tensor's (b, s, h) order, so
// neighbouring warps read neighbouring rows.
//
// Bound on the H100 at the KV-batch build (B 32, S 2880, Hkv 8, rep 4,
// D 128, bf16): 377.5 MB of K and V per layer over 3.35 TB/s, 0.113 ms;
// bytes bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRep = 8;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

struct Strides {                 // elements; the head-dim stride is 1
  long long kb, ks, kh, vb, vs, vh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ea_scores_kernel(const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ mu, const float* __restrict__ var,
                 float* __restrict__ out, long long nrows, int S, int Hkv,
                 int rep, Strides st, float scale) {
  constexpr int E = (D + 31) / 32;   // columns per lane: lane + 32 e < D
  extern __shared__ float sm[];  // mu then var, (Hkv, rep, D) each
  const int nm = Hkv * rep * D;
  float* mus = sm;
  float* vas = sm + nm;
  for (int i = threadIdx.x; i < nm; i += kThreads) {
    mus[i] = mu[i];
    vas[i] = var[i];
  }
  __syncthreads();

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
      const bool in = lane + 32 * e < D;
      kv[e] = in ? to_f(kr[lane + 32 * e]) : 0.f;
      const float y = in ? to_f(vr[lane + 32 * e]) : 0.f;
      vv = fmaf(y, y, vv);
    }
    float lin[kMaxRep], quad[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      lin[r] = quad[r] = 0.f;
      if (r < rep) {
        const float* m = mus + (h * rep + r) * D;
        const float* va = vas + (h * rep + r) * D;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d >= D) break;
          lin[r] = fmaf(kv[e], m[d], lin[r]);
          quad[r] = fmaf(kv[e] * kv[e], va[d], quad[r]);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      vv += __shfl_xor_sync(0xffffffffu, vv, off);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          lin[r] += __shfl_xor_sync(0xffffffffu, lin[r], off);
          quad[r] += __shfl_xor_sync(0xffffffffu, quad[r], off);
        }
      }
    }
    if (lane == 0) {
      float per = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep)
          per += expf(fminf(fmaxf(lin[r] * scale + quad[r] * qscale, -30.f), 30.f));
      out[row] = per * sqrtf(vv);
    }
  }
}

template <typename T, int D>
int launch(const void* k, const void* v, const void* mu, const void* var,
           void* out, int B, int S, int Hkv, int rep, const Strides& st,
           float scale, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)Hkv * rep * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ea_scores_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
      != cudaSuccess)
    return (int)err;
  const long long nrows = (long long)B * S * Hkv;
  const long long need = (nrows + kThreads / 32 - 1) / (kThreads / 32);
  const int grid = (int)(need < (long long)sms * kBlocksPerSm
                             ? need : (long long)sms * kBlocksPerSm);
  ea_scores_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(mu), static_cast<const float*>(var),
      static_cast<float*>(out), nrows, S, Hkv, rep, st, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// k/v (B, S, Hkv, D) of dtype (0 float32, 1 bfloat16), strides in elements
// with a contiguous last dim; mu/var (Hkv, rep, D) contiguous float32;
// out (B, S, Hkv) contiguous float32. D in {16, 32, 64, 128}, rep <= 8.
int ea_scores_launch(const void* k, const void* v, const void* mu,
                     const void* var, void* out, int B, int S, int Hkv,
                     int rep, int D, int dtype, long long ksb, long long kss,
                     long long ksh, long long vsb, long long vss,
                     long long vsh, float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || rep <= 0 || rep > kMaxRep)
    return (int)cudaErrorInvalidValue;
  const Strides st{ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 16) return launch<float, 16>(k, v, mu, var, out, B, S, Hkv, rep, st, scale, s);
  if (dtype == 0 && D == 32) return launch<float, 32>(k, v, mu, var, out, B, S, Hkv, rep, st, scale, s);
  if (dtype == 0 && D == 64) return launch<float, 64>(k, v, mu, var, out, B, S, Hkv, rep, st, scale, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(k, v, mu, var, out, B, S, Hkv, rep, st, scale, s);
  if (dtype == 1 && D == 16) return launch<__nv_bfloat16, 16>(k, v, mu, var, out, B, S, Hkv, rep, st, scale, s);
  if (dtype == 1 && D == 32) return launch<__nv_bfloat16, 32>(k, v, mu, var, out, B, S, Hkv, rep, st, scale, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(k, v, mu, var, out, B, S, Hkv, rep, st, scale, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(k, v, mu, var, out, B, S, Hkv, rep, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
