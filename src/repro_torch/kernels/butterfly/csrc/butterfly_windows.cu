// K1 on Hopper: window-batched Gram-triangle butterfly partials.
//
// Replaces the TPU kernel `_windows_kernel` launched by
// `butterfly_pairs_windows_kernel_call` in
// src/repro/kernels/butterfly/butterfly_kernel.py:112 (pallas_call :182).
//
// What it computes.  For a stack of 0/1 biadjacencies A[b] of shape
// [n_rows, n_cols] (rows = the Gram side, already oriented by the caller),
// and the square tiling of the Gram matrix W[b] = A[b] A[b]^T into
// block_i x block_i tiles, the kernel writes one partial per window b and
// upper-triangle tile pair t = (u <= v), enumerated row-major:
//
//     partials[b, t] = sum over rows r of tile u, cols c of tile v, r < c,
//                      of  w (w - 1) / 2,   w = W[b][r][c]   (fp32)
//
// which is exactly what the Pallas kernel's epilogue stores; the caller sums
// a window's partials into its butterfly count.  Rows and columns past the
// ragged edge (>= n_rows) are masked here and contraction indices past
// n_cols are never read, so callers need not pad to tile multiples.
//
// Design.  One thread block per (window b, tile pair t): blockIdx.x = t,
// blockIdx.y = b; the block derives (u, v) from t itself (no index table).
// The block walks the block_i x block_i tile in 128 x 128 sub-tiles, skipping
// sub-tiles that hold no r < c entry or lie past the ragged edge.  For each
// sub-tile an in-block loop over the contraction stages 16-deep slices of
// A_u and A_v in shared memory and accumulates W in fp32 registers (an 8 x 8
// micro-tile per thread, 256 threads).  Products of 0/1 values and their sums
// are exact integers in fp32 below 2**24.  The fused epilogue applies
// w (w - 1) / 2 with the global r < c mask, and a block reduction writes
// partials[b, t].  Nothing carries between blocks, so blocks run in any
// order on any SM.
//
// What bounds it on an H100.  Compute.  The largest window of the smoke
// stream (bipartite_pa_stream(2_000_000, n_unique=400_000, seed=3), nt_w =
// 1600) has a Gram side of about 4,066 and a contraction of about 5,389: the
// full Gram is about 8.9e10 multiply-adds (the upper triangle the kernel
// needs, about half of that), over an input of about 88 MB as fp32 (26 us at
// 3.35 TB/s).  Stated against the int8 tensor-core peak (1,979 TOP/s; 0/1
// operands with int32 accumulation are exact, so that is the least time the
// card could take) the upper triangle needs about 45 us; the fp32 SIMT peak
// (67 TFLOP/s), which is what this kernel uses, puts the same work at about
// 1.3 ms.  This first version is a plain SIMT kernel: tensor cores (int8 or
// bf16 mma/wgmma), TMA and a persistent schedule are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kSub = 128;                 // sub-tile edge of W per pass
constexpr int kBK = 16;                   // contraction slice in shared memory
constexpr int kTM = 8;                    // per-thread micro-tile edge
constexpr int kLanes = kSub / kTM;        // 16 threads along each side
constexpr int kThreads = kLanes * kLanes; // 256
constexpr int kPad = 4;                   // keeps rows 16-byte aligned, spreads banks

__global__ void __launch_bounds__(kThreads, 2)
butterfly_windows_kernel(const float* __restrict__ adj,
                         float* __restrict__ partials,
                         int n_rows, int n_cols, int block_i, int n_tiles,
                         int n_pairs) {
  __shared__ __align__(16) float a_s[kBK][kSub + kPad];
  __shared__ __align__(16) float b_s[kBK][kSub + kPad];
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
  const int tx = tid % kLanes;  // column micro-tile
  const int ty = tid / kLanes;  // row micro-tile
  const int row_end = min(u * block_i + block_i, n_rows);
  const int col_end = min(v * block_i + block_i, n_rows);
  const int n_sub = (block_i + kSub - 1) / kSub;

  float total = 0.f;
  for (int su = 0; su < n_sub; ++su) {
    const int r0 = u * block_i + su * kSub;
    if (r0 >= row_end) break;
    for (int sv = 0; sv < n_sub; ++sv) {
      const int c0 = v * block_i + sv * kSub;
      if (c0 >= col_end) break;
      // no entry with r < c when the last column is <= the first row
      if (min(c0 + kSub, col_end) - 1 <= r0) continue;

      float acc[kTM][kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTM; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < n_cols; k0 += kBK) {
        // stage A[r0:r0+128, k0:k0+16] and A[c0:c0+128, k0:k0+16], k-major
        for (int e = tid; e < kSub * kBK; e += kThreads) {
          const int kk = e % kBK;
          const int rr = e / kBK;
          const int k = k0 + kk;
          const int ra = r0 + rr;
          const int rb = c0 + rr;
          a_s[kk][rr] = (ra < row_end && k < n_cols)
                            ? a[static_cast<size_t>(ra) * n_cols + k] : 0.f;
          b_s[kk][rr] = (rb < col_end && k < n_cols)
                            ? a[static_cast<size_t>(rb) * n_cols + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBK; ++kk) {
          float x[kTM];
          float y[kTM];
          const float4* xa = reinterpret_cast<const float4*>(&a_s[kk][ty * kTM]);
          const float4* yb = reinterpret_cast<const float4*>(&b_s[kk][tx * kTM]);
          const float4 x0 = xa[0], x1 = xa[1], y0 = yb[0], y1 = yb[1];
          x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
          x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
          y[0] = y0.x; y[1] = y0.y; y[2] = y0.z; y[3] = y0.w;
          y[4] = y1.x; y[5] = y1.y; y[6] = y1.z; y[7] = y1.w;
#pragma unroll
          for (int i = 0; i < kTM; ++i)
#pragma unroll
            for (int j = 0; j < kTM; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
        }
        __syncthreads();
      }

      // fused epilogue: w (w - 1) / 2 over the strict upper triangle in
      // global indices, ragged rows and columns masked
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const int r = r0 + ty * kTM + i;
#pragma unroll
        for (int j = 0; j < kTM; ++j) {
          const int c = c0 + tx * kTM + j;
          if (r < row_end && c < col_end && r < c) {
            const float w = acc[i][j];
            total += w * (w - 1.f) * 0.5f;
          }
        }
      }
    }
  }

  // block reduction: warp shuffles, then one warp over the warp sums
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
// n_cols] contiguous on the device; partials: float32 [n_windows, n_pairs]
// with n_pairs = n_tiles (n_tiles + 1) / 2, n_tiles = ceil(n_rows / block_i).
// Launches on `stream` and returns cudaGetLastError() (0 on success); it
// neither synchronizes nor allocates.
extern "C" int butterfly_windows_launch(const void* adj, void* partials,
                                        int n_windows, int n_rows, int n_cols,
                                        int block_i, void* stream) {
  if (n_windows < 0 || n_rows < 0 || n_cols < 0 || block_i <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (n_rows + block_i - 1) / block_i;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  if (n_windows == 0 || n_pairs == 0) return 0;
  if (n_windows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(n_pairs), static_cast<unsigned>(n_windows));
  butterfly_windows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(adj), static_cast<float*>(partials), n_rows,
      n_cols, block_i, n_tiles, n_pairs);
  return static_cast<int>(cudaGetLastError());
}
