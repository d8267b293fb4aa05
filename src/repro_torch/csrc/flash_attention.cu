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

#include <cuda.h>
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
constexpr int kBoxRows = 64;    // rows per TMA box
constexpr int kWsThreads = 384; // producer warpgroup + two consumers
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory of a block, in bytes from a 1024-byte-aligned base: Q,
// then the K ring, then the V ring. A tile of R rows and D (padded to DP)
// columns is stored as DP / BOX column boxes of R rows x SW bytes (box c at
// c R SW), swizzled by TMA in atoms of 8 rows x SW bytes; SW is the widest
// swizzle (128, 64 or 32 bytes) whose boxes tile DP.
template <int D>
struct Tiles {
  static_assert(D % 16 == 0 && D <= 128, "DP: a multiple of 16, at most 128");
  static constexpr int SW = (2 * D) % 128 == 0 ? 128
                            : (2 * D) % 64 == 0 ? 64 : 32;  // bytes a row
  static constexpr int BOX = SW / 2;                 // columns of a box
  static constexpr int NB = D / BOX;
  static constexpr int MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;  // wgmma
  static constexpr int Q_BYTES = WQ * D * 2;
  static constexpr int T_BYTES = WK * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * T_BYTES;
  static constexpr int BYTES = V_OFF + kStages * T_BYTES;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one (BOX, 1, 64, 1) box of a (D, heads, S, B) tensor map into smem
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d),
         "r"(h), "r"(s), "r"(b)
      : "memory");
}

// R rows of a tile (the q tile's rows, or a key tile's keys) from row s0,
// in boxes of 64 rows at SW bytes a row
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int h, int s0, int b) {
  using T = Tiles<D>;
#pragma unroll
  for (int c = 0; c < T::NB; ++c)
#pragma unroll
    for (int rb = 0; rb < R / kBoxRows; ++rb)
      tma_load(dst + (c * R + rb * kBoxRows) * T::SW, map, bar, c * T::BOX, h,
               s0 + rb * kBoxRows, b);
}

// wgmma shared-memory matrix descriptor: start, leading and stride byte
// offsets (16-byte units) and the swizzle mode
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int mode) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4)
         | (uint64_t)((lbo >> 4) & 0x3FFFu) << 16
         | (uint64_t)((sbo >> 4) & 0x3FFFu) << 32
         | (uint64_t)mode << 62;
}

// K-major operand (Q or K): 8-row groups at 8 SW bytes; k-step ks (16
// columns, 32 bytes) lies in box ks / (BOX / 16) at byte (32 ks) % SW of a
// row, which the swizzle resolves from the address
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  using T = Tiles<D>;
  return make_desc(tile + (ks * 16 / T::BOX) * R * T::SW + (ks * 32) % T::SW,
                   16, 8 * T::SW, T::MODE);
}

// MN-major operand (V as B of P V): 16 keys per k-step at SW bytes a key,
// column boxes at WK SW bytes (the leading offset), 8-key groups at 8 SW
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  using T = Tiles<D>;
  return make_desc(tile + kk * 16 * T::SW, WK * T::SW, 8 * T::SW, T::MODE);
}

// named barriers 1 and 2 order the two consumer warpgroups' turns
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// after a wait: the compiler must neither read an accumulator nor reuse an
// A-operand register before it
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// wgmma m64nNk16, bf16 in, float32 accumulate. Accumulator layout: warp w
// of the warpgroup holds rows 16 w .. 16 w + 15; lane 4 g + t holds, for
// each 8-column chunk j, d[4j], d[4j+1] (row g, columns 8j + 2t, +1) and
// d[4j+2], d[4j+3] (row g + 8). A from registers has the mma.m16n8k16 A
// layout: a0 (row g, k 2t, +1), a1 (row g + 8), a2 (row g, k 8 + 2t),
// a3 (row g + 8, k 8 + 2t).
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b);
  if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  if constexpr (N == 128) wgmma_rs_n128(d, a, b);
}

// The widest wgmma N (128, 64, 32, 16) for output columns [N0, D)
template <int D, int N0>
__host__ __device__ constexpr int piece() {
  return D - N0 >= 128 ? 128 : D - N0 >= 64 ? 64 : D - N0 >= 32 ? 32 : 16;
}

// O += P V for one 16-key step kk, O's DP columns as pieces of N = 128, 64,
// 32 or 16 (each starts on a box of V's tile; the accumulator of column
// chunk j is acc[4 j .. 4 j + 3])
template <int D, int N0 = 0>
__device__ __forceinline__ void wgmma_pv(float* acc, const uint32_t* a,
                                         uint32_t vt, int kk) {
  if constexpr (N0 < D) {
    using T = Tiles<D>;
    constexpr int N = piece<D, N0>();
    static_assert(N0 % T::BOX == 0, "a piece starts on a box");
    wgmma_rs<N>(acc + N0 / 2, a, mnmajor<D>(vt + (N0 / T::BOX) * WK * T::SW,
                                            kk));
    wgmma_pv<D, N0 + N>(acc, a, vt, kk);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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
        for (int kk = 0; kk < WK / 16; ++kk) wgmma_pv<D>(acc, pf[kk], vt, kk);
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

// cuTensorMapEncodeTiled from the driver, found at run time: the library
// needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, heads, d) bf16 tensor seen as (d, heads, S, B), in boxes of
// (BOX, 1, 64, 1) with the swizzle of Tiles<DP>; rows past S and columns
// past d read as zeros
template <int DP>
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                int d, long long sb, long long ss, long long sh) {
  using T = Tiles<DP>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)T::BOX, 1, (cuuint32_t)kBoxRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
