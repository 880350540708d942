// K2 on Hopper: window-batched multiset Gram-triangle butterfly partials.
//
// Replaces the TPU kernel `_windows_kernel_multiset` launched by
// `butterfly_pairs_windows_kernel_multiset_call` in
// src/repro/kernels/butterfly/butterfly_kernel.py:191 (pallas_call :270).
//
// What it computes.  For a stack of weighted biadjacencies A[b] of shape
// [n_rows, n_cols] (entries = net edge multiplicities, rows = the Gram side,
// already oriented by the caller) and the square tiling of the Gram matrices
// into block_i x block_i tiles, the kernel writes one partial per window b
// and upper-triangle tile pair t = (u <= v), enumerated row-major:
//
//     partials[b, t] = sum over rows r of tile u, cols c of tile v, r < c,
//                      of  (w * w - s) / 2,
//     w = (A A^T)[r][c],   s = ((A∘A)(A∘A)^T)[r][c]                  (fp32)
//
// the reference's multiset epilogue; the caller sums a window's partials
// into its count.  With every multiplicity 1 it equals K1's w (w - 1) / 2.
// Ragged rows (>= n_rows) are masked and contraction indices past n_cols
// are never read, so callers need not pad to tile multiples.
//
// Design.  K1's structure with a second accumulator.  One thread block per
// (window b, tile pair t): blockIdx.x = t, blockIdx.y = b; the block derives
// (u, v) from t itself.  The block walks its block_i x block_i tile in
// 128 x 64 sub-tiles (half K1's 128 x 128, because two accumulators double
// the registers), skipping sub-tiles that hold no r < c entry or lie past
// the ragged edge.  For each sub-tile an in-block loop over the whole
// contraction stages 16-deep slices of A_u and A_v in shared memory; each
// thread squares its operands in registers and accumulates an 8 x 4
// micro-tile of W and one of S with fp32 fmaf (256 threads).  The epilogue
// rounds w * w, w * w - s and the halving separately (__fmul_rn /
// __fsub_rn: no fused multiply-add), as the reference's float32 arithmetic
// does, applies the global r < c mask, and a fixed-order block reduction
// writes partials[b, t].  Nothing carries between blocks, and each partial
// depends only on its own window, never on how many windows share the
// launch.
//
// Exactness.  Operands stay fp32: multiplicities and their squares are
// integers (up to 1,352 and 1.8e6 on the smoke stream), which bf16, fp16,
// TF32 and int8 would round.  Sums are exact integers below 2**24; above
// it w * w - s cancels and the partial carries fp32 rounding, like the
// reference's.
//
// What bounds it on an H100.  Compute: two Gram triangles, 4 operations
// per (r < c, k) entry.  The W Gram could run on tensor cores only where
// every multiplicity is exact in the input type (int8 up to 127, fp16 up to
// 2,048); A∘A passes 2,048 on the smoke stream, so the S Gram is bounded by
// the fp32 SIMT peak (67 TFLOP/s), which is what this kernel runs on for
// both.  chip_smoke.py computes the bound from the data it runs.  This
// first version is plain SIMT: splitting A∘A into exact tensor-core limbs,
// TMA and a persistent schedule are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kSubR = 128;                  // sub-tile rows of W / S per pass
constexpr int kSubC = 64;                   // sub-tile columns per pass
constexpr int kBK = 16;                     // contraction slice in shared memory
constexpr int kTR = 8;                      // per-thread micro-tile rows
constexpr int kTC = 4;                      // per-thread micro-tile columns
constexpr int kRowLanes = kSubR / kTR;      // 16
constexpr int kColLanes = kSubC / kTC;      // 16
constexpr int kThreads = kRowLanes * kColLanes;  // 256
constexpr int kPad = 4;                     // keeps rows 16-byte aligned, spreads banks

__global__ void __launch_bounds__(kThreads, 2)
butterfly_windows_multiset_kernel(const float* __restrict__ adj,
                                  float* __restrict__ partials,
                                  int n_rows, int n_cols, int block_i,
                                  int n_tiles, int n_pairs) {
  __shared__ __align__(16) float a_s[kBK][kSubR + kPad];
  __shared__ __align__(16) float b_s[kBK][kSubC + kPad];
  __shared__ float warp_sums[kThreads / 32];

  const int t = blockIdx.x;
  const int b = blockIdx.y;
  // row-major enumeration of u <= v: row u holds n_tiles - u pairs
  int u = 0;
  int rem = t;
  while (rem >= n_tiles - u) {
    rem -= n_tiles - u;
    ++u;
  }
  const int v = u + rem;

  const float* a = adj + static_cast<size_t>(b) * n_rows * n_cols;
  const int tid = threadIdx.x;
  const int tx = tid % kColLanes;  // column micro-tile
  const int ty = tid / kColLanes;  // row micro-tile
  const int row_end = min(u * block_i + block_i, n_rows);
  const int col_end = min(v * block_i + block_i, n_rows);
  const int n_sub_r = (block_i + kSubR - 1) / kSubR;
  const int n_sub_c = (block_i + kSubC - 1) / kSubC;

  float total = 0.f;
  for (int su = 0; su < n_sub_r; ++su) {
    const int r0 = u * block_i + su * kSubR;
    if (r0 >= row_end) break;
    for (int sv = 0; sv < n_sub_c; ++sv) {
      const int c0 = v * block_i + sv * kSubC;
      if (c0 >= col_end) break;
      // no entry with r < c when the last column is <= the first row
      if (min(c0 + kSubC, col_end) - 1 <= r0) continue;

      float acc_w[kTR][kTC];
      float acc_s[kTR][kTC];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          acc_w[i][j] = 0.f;
          acc_s[i][j] = 0.f;
        }

      for (int k0 = 0; k0 < n_cols; k0 += kBK) {
        // stage A[r0:r0+128, k0:k0+16] and A[c0:c0+64, k0:k0+16], k-major
        for (int e = tid; e < kSubR * kBK; e += kThreads) {
          const int kk = e % kBK;
          const int rr = e / kBK;
          const int k = k0 + kk;
          const int ra = r0 + rr;
          a_s[kk][rr] = (ra < row_end && k < n_cols)
                            ? a[static_cast<size_t>(ra) * n_cols + k] : 0.f;
        }
        for (int e = tid; e < kSubC * kBK; e += kThreads) {
          const int kk = e % kBK;
          const int rr = e / kBK;
          const int k = k0 + kk;
          const int rb = c0 + rr;
          b_s[kk][rr] = (rb < col_end && k < n_cols)
                            ? a[static_cast<size_t>(rb) * n_cols + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          float x[kTR];
          float y[kTC];
          const float4* xa = reinterpret_cast<const float4*>(&a_s[kk][ty * kTR]);
          const float4 x0 = xa[0], x1 = xa[1];
          const float4 y0 = *reinterpret_cast<const float4*>(&b_s[kk][tx * kTC]);
          x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
          x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
          y[0] = y0.x; y[1] = y0.y; y[2] = y0.z; y[3] = y0.w;
          float x2[kTR];
          float y2[kTC];
#pragma unroll
          for (int i = 0; i < kTR; ++i) x2[i] = __fmul_rn(x[i], x[i]);
#pragma unroll
          for (int j = 0; j < kTC; ++j) y2[j] = __fmul_rn(y[j], y[j]);
#pragma unroll
          for (int i = 0; i < kTR; ++i)
#pragma unroll
            for (int j = 0; j < kTC; ++j) {
              acc_w[i][j] = fmaf(x[i], y[j], acc_w[i][j]);
              acc_s[i][j] = fmaf(x2[i], y2[j], acc_s[i][j]);
            }
        }
        __syncthreads();
      }

      // fused epilogue: (w * w - s) / 2 over the strict upper triangle in
      // global indices, ragged rows and columns masked; each step rounds
      // on its own, as the reference's float32 arithmetic does
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int r = r0 + ty * kTR + i;
#pragma unroll
        for (int j = 0; j < kTC; ++j) {
          const int c = c0 + tx * kTC + j;
          if (r < row_end && c < col_end && r < c) {
            const float w = acc_w[i][j];
            const float d = __fsub_rn(__fmul_rn(w, w), acc_s[i][j]);
            total = __fadd_rn(total, __fmul_rn(d, 0.5f));
          }
        }
      }
    }
  }

  // block reduction in a fixed order: warp shuffles, then one warp over the
  // warp sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_down_sync(0xffffffffu, total, off);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = total;
  __syncthreads();
  if (tid < 32) {
    float s = tid < kThreads / 32 ? warp_sums[tid] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (tid == 0) partials[static_cast<size_t>(b) * n_pairs + t] = s;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes.  adj: float32 [n_windows, n_rows,
// n_cols] contiguous on the device (net multiplicities); partials: float32
// [n_windows, n_pairs] with n_pairs = n_tiles (n_tiles + 1) / 2, n_tiles =
// ceil(n_rows / block_i).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it neither synchronizes nor allocates.
extern "C" int butterfly_windows_multiset_launch(const void* adj,
                                                 void* partials,
                                                 int n_windows, int n_rows,
                                                 int n_cols, int block_i,
                                                 void* stream) {
  if (n_windows < 0 || n_rows < 0 || n_cols < 0 || block_i <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_rows + block_i - 1) / block_i;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  if (n_windows == 0 || n_pairs == 0) return 0;
  if (n_windows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(n_pairs), static_cast<unsigned>(n_windows));
  butterfly_windows_multiset_kernel<<<grid, kThreads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<float*>(partials), n_rows,
      n_cols, block_i, n_tiles, n_pairs);
  return static_cast<int>(cudaGetLastError());
}
