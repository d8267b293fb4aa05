// Flash-decode: one new token's `rep` GQA query heads against a KV cache,
// with a per-sequence number of valid cache slots.
//
// Replaces the Pallas kernel src/repro/kernels/decode_attention/kernel.py
// decode_fwd (:62, _decode_kernel). Its grid (B, Hkv, nk) streams the cache
// in (kc, D) tiles and carries (m, l, acc) for the rep heads in VMEM. Here
// one block owns one (kv head, batch) pair and loops over the valid slots
// in chunks of 64, keeping an online softmax: the rep queries share every
// K and V row the block reads, and slots at or past kv_valid[b] are never
// read. K and V come in as float32, bfloat16 or fp8 e4m3 and are upcast in
// registers; q and the output are float32 or bfloat16. The cache is read in
// the reference's (B, L, Hkv, D) layout through its strides (last dim
// contiguous): nothing is padded or transposed.
//
// The block has max(D, 32) threads (one warp per 32 columns). Per chunk:
// each warp takes slots in turn, each lane multiplies its columns
// (lane + 32 e < D)
// of the K row with the rep queries held in shared memory, and a warp
// butterfly finishes the rep dot products; then one warp per query takes
// the chunk's max and exponentials; then thread d accumulates column d of
// P V for every query, reading each V row once, coalesced.
//
// Bound on the H100 at the KV-batch decode (B 32, L 1168, Hkv 8, rep 4,
// D 128, bf16): the valid K and V rows, ~152 MB per layer, over 3.35 TB/s
// is ~45 us, so bytes bound it.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxRep = 8;
constexpr int CH = 64;           // cache slots per chunk

struct Strides {                 // elements; the head-dim stride is 1
  long long qb, qh, kb, ks, kh, vb, vs, vh, ob, oh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }
__device__ __forceinline__ void store(float x, float* p) { *p = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16(x);
}

template <int D>
__host__ __device__ constexpr int threads_for() { return D < 32 ? 32 : D; }

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(threads_for<D>())
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, const int* __restrict__ kv_valid,
              TQ* __restrict__ o, int L, int rep, Strides st, float scale) {
  constexpr int NT = threads_for<D>();
  constexpr int NW = NT / 32;          // warps
  constexpr int E = (D + 31) / 32;     // columns per lane
  __shared__ float qs[kMaxRep][D];
  __shared__ float ps[kMaxRep][CH];
  __shared__ float ms[kMaxRep];  // running max per query
  __shared__ float cs[kMaxRep];  // this chunk's correction per query

  const int hk = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int valid = min(kv_valid[b], L);
  const TQ* qb = q + b * st.qb + (long long)hk * rep * st.qh;
  for (int i = tid; i < rep * D; i += NT)
    qs[i / D][i % D] = to_f(qb[(i / D) * st.qh + i % D]) * scale;
  if (tid < rep) ms[tid] = kNegInf;
  __syncthreads();

  const TKV* kb = k + b * st.kb + hk * st.kh;
  const TKV* vb = v + b * st.vb + hk * st.vh;
  float acc[kMaxRep], lsum[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = lsum[r] = 0.f;

  for (int c0 = 0; c0 < valid; c0 += CH) {
    const int n = min(CH, valid - c0);
    for (int p = w; p < CH; p += NW) {
      float part[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) part[r] = 0.f;
      if (p < n) {
        const TKV* kr = kb + (long long)(c0 + p) * st.ks;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int d = lane + 32 * e;
          if (d >= D) break;
          const float kv = to_f(kr[d]);
#pragma unroll
          for (int r = 0; r < kMaxRep; ++r)
            if (r < rep) part[r] = fmaf(qs[r][d], kv, part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) ps[r][p] = p < n ? part[r] : kNegInf;
      }
    }
    __syncthreads();

    for (int r = w; r < rep; r += NW) {
      const float s0 = ps[r][lane], s1 = ps[r][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mo = ms[r];
      const float mn = fmaxf(mo, mx);
      ps[r][lane] = lane < n ? expf(s0 - mn) : 0.f;
      ps[r][lane + 32] = lane + 32 < n ? expf(s1 - mn) : 0.f;
      __syncwarp();
      if (lane == 0) {
        ms[r] = mn;
        cs[r] = expf(mo - mn);
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        acc[r] *= cs[r];
        lsum[r] *= cs[r];
      }
    }
    for (int p = 0; p < n && tid < D; ++p) {
      const float vv = to_f(vb[(long long)(c0 + p) * st.vs + tid]);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < rep) {
          const float pr = ps[r][p];
          acc[r] = fmaf(pr, vv, acc[r]);
          lsum[r] += pr;
        }
      }
    }
    __syncthreads();             // the next chunk overwrites ps and cs
  }

  TQ* ob = o + b * st.ob + (long long)hk * rep * st.oh;
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
    if (r < rep && tid < D)
      store(acc[r] / fmaxf(lsum[r], 1e-30f), ob + r * st.oh + tid);
}

template <typename TQ, typename TKV, int D>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* o, int B, int L, int Hkv, int rep, const Strides& st,
           float scale, cudaStream_t stream) {
  decode_kernel<TQ, TKV, D><<<dim3(Hkv, B), threads_for<D>(), 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const int*>(valid),
      static_cast<TQ*>(o), L, rep, st, scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int by_dim(int D, const void* q, const void* k, const void* v,
           const void* valid, void* o, int B, int L, int Hkv, int rep,
           const Strides& st, float scale, cudaStream_t s) {
  if (D == 16) return launch<TQ, TKV, 16>(q, k, v, valid, o, B, L, Hkv, rep, st, scale, s);
  if (D == 32) return launch<TQ, TKV, 32>(q, k, v, valid, o, B, L, Hkv, rep, st, scale, s);
  if (D == 64) return launch<TQ, TKV, 64>(q, k, v, valid, o, B, L, Hkv, rep, st, scale, s);
  if (D == 128) return launch<TQ, TKV, 128>(q, k, v, valid, o, B, L, Hkv, rep, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ>
int by_kv(int kv_dtype, int D, const void* q, const void* k, const void* v,
          const void* valid, void* o, int B, int L, int Hkv, int rep,
          const Strides& st, float scale, cudaStream_t s) {
  if (kv_dtype == 0) return by_dim<TQ, float>(D, q, k, v, valid, o, B, L, Hkv, rep, st, scale, s);
  if (kv_dtype == 1) return by_dim<TQ, __nv_bfloat16>(D, q, k, v, valid, o, B, L, Hkv, rep, st, scale, s);
  if (kv_dtype == 2) return by_dim<TQ, __nv_fp8_e4m3>(D, q, k, v, valid, o, B, L, Hkv, rep, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q (B, 1, H, D) and o (B, 1, H, D) of q_dtype (0 float32, 1 bfloat16);
// k/v (B, L, Hkv, D) of kv_dtype (0 float32, 1 bfloat16, 2 fp8 e4m3);
// kv_valid (B,) int32 on the device. Strides in elements (the q/o seq
// stride is unused), last dim contiguous; D in {16, 32, 64, 128};
// H / Hkv <= 8.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_valid, void* o, int B, int L,
                            int H, int Hkv, int D, int q_dtype, int kv_dtype,
                            long long qsb, long long qsh, long long ksb,
                            long long kss, long long ksh, long long vsb,
                            long long vss, long long vsh, long long osb,
                            long long osh, float scale, void* stream) {
  if (B <= 0 || L <= 0 || Hkv <= 0 || H % Hkv != 0 || H / Hkv > kMaxRep ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides st{qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh};
  const int rep = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return by_kv<float>(kv_dtype, D, q, k, v, kv_valid, o, B, L, Hkv, rep, st, scale, s);
  if (q_dtype == 1)
    return by_kv<__nv_bfloat16>(kv_dtype, D, q, k, v, kv_valid, o, B, L, Hkv, rep, st, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
