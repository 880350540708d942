// K1 and K3 on Hopper: window-batched Gram-triangle butterfly partials on
// the int8 tensor cores (wgmma, u8 operands, s32 accumulators), fed by TMA
// through a shared-memory ring, on a persistent triangle schedule, with an
// exact integer epilogue.
//
// Replaces the TPU kernels `_windows_kernel` (K1), launched by
// `butterfly_pairs_windows_kernel_call` in
// src/repro/kernels/butterfly/butterfly_kernel.py:112 (pallas_call :182),
// and `_kernel` (K3), launched by `butterfly_pairs_kernel_call` in the same
// file (:43, pallas_call :103).  K3 is this kernel at B = 1.
//
// What it computes.  For a stack of 0/1 biadjacencies A[b] of shape
// [n_rows, row_bytes] in uint8 (rows = the Gram side, already oriented by
// the caller; bytes past the matrix's own columns are zero) and the square
// tiling of W[b] = A[b] A[b]^T into block_i x block_i tiles, it writes one
// partial per window b and upper-triangle tile pair t = (u <= v),
// enumerated row-major:
//
//     partials[b, t] = fp32( sum over rows r of tile u, cols c of tile v,
//                            r < c, of  p(w) ),   w = W[b][r][c]
//     p(w) = fp32(fp32(w) * (fp32(w) - 1)) * 0.5                  (fp32)
//
// p(w) is the reference epilogue's own per-entry value (`w * (w - 1.0) *
// 0.5` in float32).  Any block_i >= 1 works; rows past n_rows are masked.
//
// Exact summation.  Every p(w) is an integer: below 2**24 w(w - 1) is an
// exact even integer, above it every float32 is an even integer.  So the
// kernel converts each p(w) to a 64-bit integer and adds it into a [B, T]
// workspace with integer atomics, which are exact and commutative; one
// last pass rounds each sum to float32 once (round to nearest even).  The
// partials are therefore the same bits whatever the CTA tile, the order of
// the tiles or the number of windows in the launch.  Nothing wraps: every
// w <= row_bytes, and with n_rows * row_bytes <= 2**32 (the wrapper's limit)
// a window's whole sum is below (n_rows * row_bytes)**2 / 4 <= 2**62.
// Below 2**24 the result is the reference's float32 sum exactly (every
// partial sum of integers is exact there); above it, the correctly rounded
// sum of the reference's own per-entry values.
// `butterfly_kernel.butterfly_pairs_windows_plain` sums the same values in
// int64, so the kernel equals it at every size.
//
// What bounds it on an H100.  Operations.  The largest stack of the smoke
// replay is [21, 3776, 5120]: the strict upper triangle is 1.53e12 int8
// operations, 0.77 ms at the 1,979 TOP/s int8 tensor-core peak, against
// 406 MB of uint8 input (0.12 ms at 3.35 TB/s).  0/1 operands are exact in
// u8 and their dot products exact in s32, so int8 tensor cores give the
// reference's W exactly.  Each CTA tile of 128 x 256 reads 48 KB of panels
// per 128-deep slice of the contraction for 8.4e6 multiply-adds: at the
// int8 peak that is about 11 TB/s out of L2, above what L2 serves, so the
// panels' traffic out of L2, not the tensor cores, is the likely limit.  A
// 2-CTA cluster that multicasts the shared panel is the lever, later.
//
// Design.  A persistent grid of one 384-thread CTA per SM walks a work list
// of (window, row tile tm, column tile tn) in window-major order, so a
// window's panels stay in L2 (19.3 MB as uint8 at the largest bucket) while
// its tiles run.  A CTA tile is 128 rows x 256 columns of W; only tiles
// that hold some r < c are listed (tn >= tm / 2), so tiles wholly below the
// diagonal are never loaded, and only the diagonal ones are masked.
// Warpgroup 2 is the producer: one thread keeps kStages slices in flight
// with TMA (a 3-d tensor map over the stack's own strides (byte, row,
// window), 128-byte swizzle, zero fill past the rows and columns), each
// slice = the 128-row A panel and the 256-row B panel, 128 bytes deep,
// guarded by a full and an empty mbarrier.  Warpgroups 0 and 1 each own 64
// rows and run wgmma.m64n256k32.s32.u8.u8 from shared memory (both operands
// K-major, as the stack lies: A A^T reads rows of A on both sides), four per
// slice, keeping one slice's group in flight while the next one's issues.
// setmaxnreg moves the producer's registers to the consumers' 128 s32
// accumulators.  The epilogue applies p(w) with the global r < c and
// ragged-edge masks; where the CTA tile lies in one (u, v) tile pair (every
// tile at block_i = 256, the main path) a warp sums its entries and issues
// one atomic, elsewhere each thread issues one atomic per run of entries in
// one tile pair.  TMA needs a 16-byte-aligned base and a row stride of a
// multiple of 16 bytes; the wrapper hands this kernel a zero-padded uint8
// copy of anything else (butterfly_kernel._launch_k1), and the launcher
// refuses it.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                     // rows of a CTA tile of W
constexpr int kBN = 256;                     // columns of a CTA tile of W
constexpr int kBK = 128;                     // contraction bytes per slice: one swizzle atom
constexpr int kBoxRows = 128;                // rows per TMA box
constexpr int kStages = 4;                   // slices in flight
constexpr int kThreads = 384;                // consumer warpgroups 0, 1; producer 2
constexpr int kABytes = kBM * kBK;           // 16 KB
constexpr int kBBytes = kBN * kBK;           // 32 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBars = kStages * kStageBytes;
constexpr int kSmemBytes = kBars + 2 * kStages * 8 + 1024;   // 1024: slack to align

struct Params {
  unsigned long long* sums;                  // [B, T] exact tile-pair sums
  long long n_pairs;                         // T
  long long per_window;                      // CTA tiles listed per window
  long long n_work;                          // B * per_window
  int n_rows, k_slices, block_i, n_tiles, col_tiles;
};

#include "wgmma_u8.cuh"

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

#define K1_R8(d, i)                                                             \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),   \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define K1_D128(d)                                                              \
  K1_R8(d, 0), K1_R8(d, 8), K1_R8(d, 16), K1_R8(d, 24), K1_R8(d, 32),           \
      K1_R8(d, 40), K1_R8(d, 48), K1_R8(d, 56), K1_R8(d, 64), K1_R8(d, 72),     \
      K1_R8(d, 80), K1_R8(d, 88), K1_R8(d, 96), K1_R8(d, 104), K1_R8(d, 112),   \
      K1_R8(d, 120)

// d += A B^T, m64 n256 k32, A and B K-major u8 in shared memory, s32
// accumulators
__device__ __forceinline__ void wgmma_u8(int32_t (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "
      "%123, %124, %125, %126, %127}, %128, %129, p;\n"
      "}\n"
      : K1_D128(d)
      : "l"(a), "l"(b), "r"(1));
}

// the reference's per-entry value w (w - 1) / 2 in float32, as the integer
// it is
__device__ __forceinline__ unsigned long long pair_value(int32_t w_int) {
  const float w = __int2float_rn(w_int);
  return __float2ull_rn(__fmul_rn(__fmul_rn(w, __fsub_rn(w, 1.f)), 0.5f));
}

// work item idx -> (window, row tile, column tile); row tile m lists column
// tiles m / 2 .. col_tiles - 1 (the others hold no r < c)
__device__ __forceinline__ void decode(long long idx, const Params& p, int& b, int& tm,
                                       int& tn) {
  b = static_cast<int>(idx / p.per_window);
  long long rem = idx - static_cast<long long>(b) * p.per_window;
  int m = 0;
  while (rem >= p.col_tiles - m / 2) {
    rem -= p.col_tiles - m / 2;
    ++m;
  }
  tm = m;
  tn = m / 2 + static_cast<int>(rem);
}

// the accumulators of warpgroup wg of the CTA tile (tm, tn) of window b ->
// the exact sums.  acc[4 j + 2 i + e] is row 64 wg + 16 warp + lane / 4 +
// 8 i and column 8 j + 2 (lane % 4) + e of the tile.
__device__ __forceinline__ void epilogue(const int32_t (&acc)[128], const Params& p,
                                         int b, int tm, int tn, int wg, int tid) {
  const int lane = tid % 32;
  const int n = p.n_rows;
  const int bi = p.block_i;
  const int r0 = kBM * tm + 64 * wg + 16 * (tid / 32) + lane / 4;
  const int c0 = kBN * tn + 2 * (lane % 4);
  unsigned long long* sums = p.sums + static_cast<long long>(b) * p.n_pairs;
  const int u = kBM * tm / bi;
  const int v = kBN * tn / bi;
  if (u == (min(kBM * tm + kBM, n) - 1) / bi && v == (min(kBN * tn + kBN, n) - 1) / bi) {
    // the CTA tile lies in one tile pair: one atomic per warp
    unsigned long long s = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * i;
          const int c = c0 + 8 * j + e;
          if (c < n && r < c) s += pair_value(acc[4 * j + 2 * i + e]);
        }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0 && s != 0) atomicAdd(sums + pair_index(u, v, p.n_tiles), s);
    return;
  }
  // several tile pairs: one atomic per run of a thread's entries in one
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= n) continue;
    const int ur = r / bi;
    unsigned long long* row = sums + pair_index(ur, ur, p.n_tiles) - ur;   // + v: (ur, v)
    int run_v = -1;
    unsigned long long run = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        if (c < n && r < c) {
          const int vc = c / bi;
          if (vc != run_v) {
            if (run != 0) atomicAdd(row + run_v, run);
            run = 0;
            run_v = vc;
          }
          run += pair_value(acc[4 * j + 2 * i + e]);
        }
      }
    if (run != 0) atomicAdd(row + run_v, run);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
butterfly_windows_wgmma_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle: 1024-aligned
  const uint32_t full0 = base + kBars;             // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;     // empty[s] = empty0 + 8 s

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full0 + 8 * s, 1);
      bar_init(empty0 + 8 * s, 8);                 // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      uint32_t it = 0;
      for (long long idx = blockIdx.x; idx < p.n_work; idx += gridDim.x) {
        int b, tm, tn;
        decode(idx, p, b, tm, tn);
        const int rb = kBN * tn;
        // a B box wholly past the last row is not loaded: the columns it
        // would feed are masked, so what its smem holds does not matter
        const bool two = rb + kBoxRows < p.n_rows;
        const uint32_t bytes = kABytes + (two ? kBBytes : kBBytes / 2);
        for (int kt = 0; kt < p.k_slices; ++kt, ++it) {
          const uint32_t s = it % kStages;
          if (it >= kStages) bar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
          const uint32_t full = full0 + 8 * s;
          const uint32_t dst = base + s * kStageBytes;
          bar_expect_tx(full, bytes);
          tma_load(dst, &map, full, kt * kBK, kBM * tm, b);
          tma_load(dst + kABytes, &map, full, kt * kBK, rb, b);
          if (two)
            tma_load(dst + kABytes + kBBytes / 2, &map, full, kt * kBK, rb + kBoxRows, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    int32_t acc[128];
    uint32_t it = 0;
    for (long long idx = blockIdx.x; idx < p.n_work; idx += gridDim.x) {
      int b, tm, tn;
      decode(idx, p, b, tm, tn);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0;
      for (int kt = 0; kt < p.k_slices; ++kt, ++it) {
        const uint32_t s = it % kStages;
        bar_wait(full0 + 8 * s, (it / kStages) & 1);
        const uint32_t sa = base + s * kStageBytes + wg * 64 * kBK;
        const uint32_t sb = base + s * kStageBytes + kABytes;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 32; ++kk) wgmma_u8(acc, desc(sa + 32 * kk), desc(sb + 32 * kk));
        wg_commit();
        // the previous slice's products are done: release its stage
        wg_wait<1>();
        if (kt > 0) {
          __syncwarp();
          if (lane == 0) bar_arrive(empty0 + 8 * ((it - 1) % kStages));
        }
      }
      wg_wait<0>();
      __syncwarp();
      if (lane == 0) bar_arrive(empty0 + 8 * ((it - 1) % kStages));
#pragma unroll
      for (int i = 0; i < 128; ++i) keep(acc[i]);
      epilogue(acc, p, b, tm, tn, wg, tid);
    }
  }
}

// sums -> partials, each rounded to float32 once (to nearest even)
__global__ void round_sums_kernel(const unsigned long long* __restrict__ sums,
                                  float* __restrict__ partials, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    partials[i] = __ull2float_rn(sums[i]);
}

// A 3-d map over a contiguous [n_windows, n_rows, row_bytes] uint8 stack,
// innermost first as (byte, row, window); a box of one 128-byte atom of 128
// rows of one window, 128-byte swizzle, zero fill out of bounds (past the
// row's bytes and past the window's last row, never into the next window).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int row_bytes, int n_rows,
                     int n_windows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(n_rows),
                              static_cast<cuuint64_t>(n_windows)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(row_bytes) * n_rows};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(kBoxRows),
                             1u};
  const cuuint32_t estride[3] = {1u, 1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr),
                            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  adj: uint8 [n_windows, n_rows,
// row_bytes] contiguous on the device, 16-byte aligned, row_bytes a
// multiple of 16 (zero past the matrix's columns); sums: uint64 scratch of
// n_windows * n_pairs; partials: float32 [n_windows, n_pairs] with n_pairs =
// n_tiles (n_tiles + 1) / 2, n_tiles = ceil(n_rows / block_i).  Zeroes the
// scratch, runs the Gram kernel (not when row_bytes is 0: every w is 0) and
// the rounding pass on `stream`, and returns cudaGetLastError() (0 on
// success); it neither synchronizes nor allocates.
extern "C" int butterfly_windows_wgmma_launch(const void* adj, void* sums, void* partials,
                                              int n_windows, int n_rows, int row_bytes,
                                              int block_i, void* stream_ptr) {
  if (n_windows < 0 || n_rows < 0 || row_bytes < 0 || block_i <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_bytes % 16 || reinterpret_cast<uintptr_t>(adj) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_windows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (n_rows + block_i - 1) / block_i;
  const long long n_pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
  const long long total = n_pairs * n_windows;
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(sums, 0, static_cast<size_t>(total) * 8, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (row_bytes > 0) {
    Params p;
    p.sums = static_cast<unsigned long long*>(sums);
    p.n_pairs = n_pairs;
    p.n_rows = n_rows;
    p.k_slices = (row_bytes + kBK - 1) / kBK;
    p.block_i = block_i;
    p.n_tiles = n_tiles;
    p.col_tiles = (n_rows + kBN - 1) / kBN;
    const int row_tiles = (n_rows + kBM - 1) / kBM;
    p.per_window = 0;
    for (int m = 0; m < row_tiles; ++m) p.per_window += p.col_tiles - m / 2;
    p.n_work = p.per_window * n_windows;
    CUtensorMap map;
    err = make_map(&map, adj, row_bytes, n_rows, n_windows);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(butterfly_windows_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = p.n_work < sms ? p.n_work : sms;
    butterfly_windows_wgmma_kernel<<<static_cast<unsigned>(grid), kThreads, kSmemBytes,
                                     stream>>>(map, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (total + 255) / 256;
  round_sums_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const unsigned long long*>(sums), static_cast<float*>(partials), total);
  return static_cast<int>(cudaGetLastError());
}

// the Gram kernel's dynamic shared memory in bytes
extern "C" int butterfly_windows_wgmma_smem_bytes() { return kSmemBytes; }
