// K-means assignment step: argmin_c(-2·x·c + ||c||^2), first index on ties.
//
// Replaces the Pallas kernel src/repro/kernels/kmeans/kernel.py
// assign_blocks (:31, _assign_kernel). As there, ||x||^2 is left out (it is
// constant per row) and the wrapper computes c2 = ||c||^2 in torch.
//
// A block owns BM = 128 rows and walks the centroids in tiles of BN = 32
// (C goes up to 512, the TPU kernel's limit). For each tile it runs a plain
// fp32 register-tiled product over d in chunks of DK = 32: the chunk of its
// rows and the chunk of the centroid tile are staged in shared memory
// (transposed, so the inner loop reads them as float4/float2; the next
// chunk's global loads are in flight while this one is multiplied), and each of
// the 16 x 16 threads keeps an 8-row x 2-centroid tile of dot products in
// registers. After a tile, each thread folds its scores into a running
// (best score, index) per row with a strict <, over centroids in ascending
// order; a butterfly across the 16 threads that share a row then keeps the
// smaller score and, on a tie, the smaller index — the lowest index wins, as
// jnp.argmin does. One int32 assignment per row is written.
//
// Bound on the H100: at N = 2^20, d = 1152, C = 32 the store read (4.83 GB,
// ~1.44 ms at 3.35 TB/s SXM) is larger than the 77 GFLOP at 67 TFLOP/s
// fp32 (~1.15 ms), so bytes bound it. With C <= 32 each row is read from
// device memory once; larger C re-reads the block's rows once per tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int TM = 8, TN = 2;            // per-thread rows x centroids
constexpr int BM = 16 * TM;              // 128 rows per block
constexpr int BN = 16 * TN;              // 32 centroids per tile
constexpr int DK = 32;                   // d chunk
constexpr int XS = BM + 4;               // padded strides (16-byte aligned)
constexpr int CS = BN + 4;
constexpr int RS = kThreads / DK;        // rows staged per pass
constexpr int XL = BM / RS, CL = BN / RS; // staged values per thread

__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ x, const float* __restrict__ cent,
              const float* __restrict__ c2, int* __restrict__ out, int n,
              int d, int C) {
  __shared__ __align__(16) float xs[DK * XS];   // [DK][BM] (transposed)
  __shared__ __align__(16) float cs[DK * CS];   // [DK][BN] (transposed)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int col = tid % DK, r0 = tid / DK;   // this thread's staging slot
  const long long row0 = (long long)blockIdx.x * BM;

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) { best[i] = INFINITY; bidx[i] = 0; }

  for (int cb = 0; cb < C; cb += BN) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    // chunk k0 + DK is fetched into registers while chunk k0 is multiplied
    float xr[XL], cr[CL];
    auto fetch = [&](int k0) {
      const bool in_d = k0 + col < d;
#pragma unroll
      for (int i = 0; i < XL; ++i) {
        long long row = row0 + r0 + i * RS;
        xr[i] = (in_d && row < n) ? __ldg(x + row * d + k0 + col) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < CL; ++i) {
        int c = cb + r0 + i * RS;
        cr[i] = (in_d && c < C) ? __ldg(cent + (long long)c * d + k0 + col)
                                : 0.f;
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < d; k0 += DK) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < XL; ++i) xs[col * XS + r0 + i * RS] = xr[i];
#pragma unroll
      for (int i = 0; i < CL; ++i) cs[col * CS + r0 + i * RS] = cr[i];
      __syncthreads();
      if (k0 + DK < d) fetch(k0 + DK);
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) {
        const float4* xv = reinterpret_cast<const float4*>(xs + kk * XS + ty * TM);
        float4 a0 = xv[0], a1 = xv[1];
        float2 b = *reinterpret_cast<const float2*>(cs + kk * CS + tx * TN);
        float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = cb + tx * TN + j;
      if (c < C) {
        float cc = __ldg(c2 + c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float s = fmaf(-2.f, acc[i][j], cc);
          if (s < best[i]) { best[i] = s; bidx[i] = c; }
        }
      }
    }
  }

  // the 16 threads of a row are 16 adjacent lanes of one warp
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float s = best[i];
    int c = bidx[i];
#pragma unroll
    for (int m = 8; m > 0; m >>= 1) {
      float s2 = __shfl_xor_sync(0xffffffffu, s, m);
      int c2i = __shfl_xor_sync(0xffffffffu, c, m);
      if (s2 < s || (s2 == s && c2i < c)) { s = s2; c = c2i; }
    }
    long long row = row0 + ty * TM + i;
    if (tx == 0 && row < n) out[row] = c;
  }
}

}  // namespace

extern "C" {

// x (n, d), cent (C, d), c2 (C,): contiguous f32 on the device; out (n,) i32.
int kmeans_assign_launch(const void* x, const void* cent, const void* c2,
                         void* out, int n, int d, int C, void* stream) {
  if (n <= 0 || d <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n + BM - 1) / BM);
  assign_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cent),
      static_cast<const float*>(c2), static_cast<int*>(out), n, d, C);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
