// K-means assignment step: argmin_c(-2·x·c + ||c||^2), first index on ties.
//
// Replaces the Pallas kernel src/repro/kernels/kmeans/kernel.py
// assign_blocks (:31, _assign_kernel): one MXU product per (block_n, d) tile
// of the store against the resident centroids, then an argmin. As there,
// ||x||^2 is left out (it is constant per row) and the wrapper computes
// c2 = ||c||^2 in torch.
//
// What bounds it on the H100: at the main path's N = 2^20, d = 1152, C = 32
// the store read (4.83 GB, 1.44 ms at 3.35 TB/s) against 77 GFLOP, which
// the fp32 CUDA cores alone would need 1.15 ms for; at the index's C = 512
// the 1.24 TFLOP, 18.5 ms at the 67 TFLOP/s fp32 peak.
//
// The tensor-core path (assign_tc_kernel) takes the product off the CUDA
// cores and reads each row from device memory once, for any C <= 512:
//
// - Precision: a bf16x2 split. Each operand is split a = hi + lo, hi the
//   bf16 nearest a and lo the bf16 nearest a - hi (16 bits of significand
//   together, |a - hi - lo| <= 2^-16 |a|), and hi·hi + hi·lo + lo·hi is
//   summed in fp32 accumulators by mma.sync.m16n8k16 (every product of two
//   bf16 values is exact in fp32; lo·lo, about 2^-16 of the sum, is
//   dropped). Scores move by about 1e-6 on unit rows at d = 1152, so the
//   argmin agrees with the fp32 reference but for near-ties (held at a
//   score gap of 1e-4). A 3xTF32 split (hi·hi + hi·lo + lo·hi with m16n8k8
//   TF32) was as exact but ran at about half the rate: mma.sync on this
//   card issues bf16 at twice TF32's FLOP rate. The three products cost 3x
//   the tensor-core work, under the store read at C = 32.
// - One block owns BM rows and every centroid (BN >= C, the tile chosen in
//   the wrapper, kernel.py ``tile``): each row lives in one block and is
//   read from device memory once, whatever C. The centroids are re-read
//   from L2 by every block (C·d·4 bytes a block; at C = 512 and BM = 64
//   that is 8x the store's bytes, from L2). The accumulators cap BM·BN at
//   32,768 (128 a thread of 256), so BM shrinks as C grows.
// - Rows and centroids stream through a ring of STAGES shared-memory stages
//   of DK = 32 floats of d by cp.async (16-byte copies; rows past n,
//   centroids past C and columns past d are zero-filled), with STAGES - 1
//   stages in flight across the products and one block barrier a stage.
//   Each staged row's eight 16-byte chunks are XOR-swizzled by row parity,
//   so the fragment loads (one 16-byte load a row per 16 floats of d) are
//   free of bank conflicts.
// - A fragment load brings 4 consecutive floats of d; they are taken as the
//   k16 fragment's columns (2t, 2t + 1, 2t + 8, 2t + 9), the same way for
//   rows and centroids (a dot product does not care in which order its
//   terms come).
// - Epilogue: each thread folds its scores into (best, index) with a strict
//   < over its centroids in ascending order, a quad butterfly keeps the
//   smaller score and on a tie the smaller index, and the warps that split
//   the centroids combine in shared memory in ascending centroid order with
//   a strict <: the lowest index wins, as jnp.argmin does. Equal centroids
//   give equal products, so an exact tie goes to the lower index.
//
// The scalar-load path (assign_scalar_kernel) is the first design, kept for
// buffers the 16-byte copies cannot take (a base or a row not on a 16-byte
// boundary: d not a multiple of 4): fp32 FMAs on the CUDA cores over
// 128-row x 32-centroid register tiles, d in chunks of 32 through shared
// memory; C > 32 re-reads the block's rows once per centroid tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------- tensor-core path

constexpr int kThreads = 256;      // 8 warps
constexpr int DK = 32;             // floats of d a ring stage holds a row
constexpr int kChunks = DK / 4;    // 16-byte chunks a staged row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// float offset of 16-byte chunk c of staged row r (rows of DK floats)
__device__ __forceinline__ int swz(int r, int c) {
  return r * DK + ((c ^ ((r & 1) << 2)) << 2);
}

// (a, b) = hi + lo, hi the bf16 pair nearest (a, b) and lo the bf16 pair
// nearest the rest; each packed as bf16x2, the lower half holding a
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Warp tile WM rows x WN centroids; WARPS_M x (8 / WARPS_M) warps; a block
// covers BM = WM·WARPS_M rows and BN = WN·(8 / WARPS_M) centroids.
template <int WM, int WN, int WARPS_M, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
assign_tc_kernel(const float* __restrict__ x, const float* __restrict__ cent,
                 const float* __restrict__ c2, int* __restrict__ out, int n,
                 int d, int C) {
  constexpr int WARPS_N = 8 / WARPS_M;
  constexpr int BM = WM * WARPS_M, BN = WN * WARPS_N;
  constexpr int MT = WM / 16, NT = WN / 8;
  constexpr int STAGE = (BM + BN) * DK;     // floats: BM rows, then BN
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * BM;
  const int nk = (d + DK - 1) / DK;

  static_assert((BM + BN) * kChunks % kThreads == 0, "copies a thread");
  static_assert(BM % 32 == 0, "a copy pass is all rows or all centroids");
  auto load = [&](int kc, int slot) {
    float* st = smem + slot * STAGE;
    const int k0 = kc * DK;
#pragma unroll
    for (int it = 0; it < (BM + BN) * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kChunks, c = i % kChunks;
      const int col = k0 + 4 * c;
      const float* src;
      bool ok;
      if (r < BM) {
        const long long row = row0 + r;
        ok = row < n && col < d;
        src = ok ? x + row * d + col : x;
      } else {
        const int cr = r - BM;
        ok = cr < C && col < d;
        src = ok ? cent + (long long)cr * d + col : cent;
      }
      cp_async16(smem_u32(st + swz(r, c)), src, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage kc landed; stage kc - 1 is free for reuse
    if (kc + STAGES - 1 < nk) load(kc + STAGES - 1, (kc + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* xs = smem + (kc % STAGES) * STAGE;
    const float* cs = xs + BM * DK;
#pragma unroll
    for (int j = 0; j < 2; ++j) {     // the stage's two halves of 16 floats
      // a 16-byte load of row r, chunk 4j + t: floats k = 16j + 4t + 0..3,
      // taken as the k16 fragment's columns 2t, 2t + 1, 2t + 8, 2t + 9
      // (rows and centroids alike)
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // fragment rows g and g + 8
          const int r = wm * WM + mt * 16 + g + 8 * h;
          const float4 v =
              *reinterpret_cast<const float4*>(xs + swz(r, 4 * j + t));
          split_bf16x2(v.x, v.y, ah[mt][h], al[mt][h]);
          split_bf16x2(v.z, v.w, ah[mt][2 + h], al[mt][2 + h]);
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = wn * WN + nt * 8 + g;
        const float4 v =
            *reinterpret_cast<const float4*>(cs + swz(r, 4 * j + t));
        uint32_t bh[2], bl[2];
        split_bf16x2(v.x, v.y, bh[0], bl[0]);
        split_bf16x2(v.z, v.w, bh[1], bl[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {   // small terms first
          mma_bf16(acc[mt][nt], al[mt], bh[0], bh[1]);
          mma_bf16(acc[mt][nt], ah[mt], bl[0], bl[1]);
          mma_bf16(acc[mt][nt], ah[mt], bh[0], bh[1]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it holds the per-warp minima now

  float* best_s = smem;                                       // [WARPS_N][BM]
  int* best_i = reinterpret_cast<int*>(smem + WARPS_N * BM);  // [WARPS_N][BM]
  float cc[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = wn * WN + nt * 8 + 2 * t + e;
      cc[nt][e] = col < C ? __ldg(c2 + col) : 0.f;
    }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {     // accumulator rows g and g + 8
      float s = INFINITY;
      int c = 0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = wn * WN + nt * 8 + 2 * t + e;
          const float sc = fmaf(-2.f, acc[mt][nt][2 * h + e], cc[nt][e]);
          if (col < C && sc < s) { s = sc; c = col; }
        }
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {   // the quad that shares the row
        const float s2 = __shfl_xor_sync(0xffffffffu, s, m);
        const int c2i = __shfl_xor_sync(0xffffffffu, c, m);
        if (s2 < s || (s2 == s && c2i < c)) { s = s2; c = c2i; }
      }
      if (t == 0) {
        const int r = wm * WM + mt * 16 + g + 8 * h;
        best_s[wn * BM + r] = s;
        best_i[wn * BM + r] = c;
      }
    }
  __syncthreads();
  for (int r = tid; r < BM; r += kThreads) {
    float s = best_s[r];
    int c = best_i[r];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w)   // ascending centroid ranges
      if (best_s[w * BM + r] < s) { s = best_s[w * BM + r]; c = best_i[w * BM + r]; }
    if (row0 + r < n) out[row0 + r] = c;
  }
}

template <int WM, int WN, int WARPS_M, int STAGES, int MIN_BLOCKS>
int launch_tc(const float* x, const float* cent, const float* c2, int* out,
              int n, int d, int C, cudaStream_t stream) {
  constexpr int BM = WM * WARPS_M, BN = WN * (8 / WARPS_M);
  constexpr int smem = STAGES * (BM + BN) * DK * (int)sizeof(float);
  static_assert(smem <= 232448, "ring larger than a block's shared memory");
  static_assert(2 * (8 / WARPS_M) * BM * 4 <= smem, "epilogue buffer");
  auto kern = assign_tc_kernel<WM, WN, WARPS_M, STAGES, MIN_BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)n + BM - 1) / BM;
  kern<<<(unsigned)blocks, kThreads, smem, stream>>>(x, cent, c2, out, n, d,
                                                      C);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- scalar-load path

constexpr int TM = 8, TN = 2;            // per-thread rows x centroids
constexpr int SBM = 16 * TM;             // 128 rows per block
constexpr int SBN = 16 * TN;             // 32 centroids per tile
constexpr int XS = SBM + 4;              // padded strides (16-byte aligned)
constexpr int CS = SBN + 4;
constexpr int RS = kThreads / DK;        // rows staged per pass
constexpr int XL = SBM / RS, CL = SBN / RS; // staged values per thread

__global__ void __launch_bounds__(kThreads)
assign_scalar_kernel(const float* __restrict__ x,
                     const float* __restrict__ cent,
                     const float* __restrict__ c2, int* __restrict__ out,
                     int n, int d, int C) {
  __shared__ __align__(16) float xs[DK * XS];   // [DK][SBM] (transposed)
  __shared__ __align__(16) float cs[DK * CS];   // [DK][SBN] (transposed)

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int col = tid % DK, r0 = tid / DK;   // this thread's staging slot
  const long long row0 = (long long)blockIdx.x * SBM;

  float best[TM];
  int bidx[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) { best[i] = INFINITY; bidx[i] = 0; }

  for (int cb = 0; cb < C; cb += SBN) {
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

// x (n, d), cent (C, d), c2 (C,): contiguous f32 on the device, x and cent
// on 16-byte boundaries with d a multiple of 4; out (n,) i32. block_c is
// the centroids a block covers (kernel.py ``tile``): 32, 64, 128, 256 or
// 512, at least C.
int kmeans_assign_tc_launch(const void* x, const void* cent, const void* c2,
                            void* out, int n, int d, int C, int block_c,
                            void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || C <= 0 || C > block_c)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cent);
  const float* c2p = static_cast<const float*>(c2);
  int* op = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_c) {   // <WM, WN, WARPS_M, STAGES, MIN_BLOCKS>
    case 32: return launch_tc<32, 32, 8, 3, 2>(xp, cp, c2p, op, n, d, C, s);
    case 64: return launch_tc<32, 64, 8, 4, 1>(xp, cp, c2p, op, n, d, C, s);
    case 128: return launch_tc<64, 64, 4, 4, 1>(xp, cp, c2p, op, n, d, C, s);
    case 256: return launch_tc<64, 64, 2, 4, 1>(xp, cp, c2p, op, n, d, C, s);
    case 512: return launch_tc<64, 64, 1, 3, 1>(xp, cp, c2p, op, n, d, C, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x (n, d), cent (C, d), c2 (C,): contiguous f32 on the device; out (n,) i32.
int kmeans_assign_scalar_launch(const void* x, const void* cent,
                                const void* c2, void* out, int n, int d,
                                int C, void* stream) {
  if (n <= 0 || d <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((n + SBM - 1) / SBM);
  assign_scalar_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(cent),
      static_cast<const float*>(c2), static_cast<int*>(out), n, d, C);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
