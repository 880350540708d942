// K4 on Hopper: the FlashAttention-2 forward pass (online softmax over
// key/value tiles) for prefill attention.
//
// Replaces the TPU kernel `_kernel` launched by `flash_attention_call` in
// src/repro/kernels/flash_attention/flash_kernel.py:29 (pallas_call :83),
// with its wrapper `flash_attention` (ops.py), and serves the port's
// `gqa_attention_chunked` (the XLA twin of the same schedule in
// src/repro/models/transformer/attention.py:33).
//
// What it computes.  For q [B, Sq, H, hd] and k, v [B, Skv, Hkv, hd] read
// through their strides (no transpose, no GQA repeat: query head h reads
// key/value head h / groups), the output o [B, Sq, H, hd] is
//
//     s   = (q . k) * scale                       (fp32)
//     s   = -1e30 where col >= Skv, or causal and col > q_offset + row
//     m'  = max(m, rowmax(s));  p = exp(s - m');  corr = exp(m - m')
//     l   = l * corr + rowsum(p);  acc = acc * corr + p v;  m = m'
//     o   = acc / max(l, 1e-30)                   (written in q's type)
//
// with (acc, m, l) in fp32, as the reference kernel computes them.  Tiles
// wholly above the causal diagonal are skipped: there the reference's p is
// exp(-1e30 - m) = 0 and corr = 1, so skipping them changes nothing.  Tile
// order is ascending, so a row's first tile holds its column 0 and m is
// finite after it.  Ragged lengths (Sq or Skv not a multiple of a tile) are
// masked here; callers pad nothing.  expf, never __expf (no fast math).
//
// Design.  One block of 256 threads per (64 query rows, head, batch).  The
// Q tile is widened to fp32 in shared memory once; each 64-key K and V tile
// is staged in shared memory in the input type (bf16 widens to fp32
// exactly when it is read).  A thread owns 4 query rows and, for them, 4
// score columns and hd_pad / 16 output columns: the 16 threads of a row
// group are lanes of one warp, so the row max and sum are warp shuffles
// and the P tile needs only a warp barrier between its write and its read.
// The whole block is fp32 SIMT.  Query tiles launch heaviest first (the
// last causal tiles walk the most keys).
//
// What bounds it on an H100.  Operations.  At the serve path's shape (q
// [4, 4096, 24, 128], k and v [4, 4096, 8, 128], bf16, causal) QK^T and PV
// are 206.2 GFLOP each over 268 MB of input and output (80 us at
// 3.35 TB/s).  QK^T on bf16 operands is exact on bf16 tensor cores with
// fp32 accumulation (989 TFLOP/s); PV takes the reference's fp32 P, which
// three bf16 limbs hold exactly, so three bf16 products: together about
// 0.83 ms.  This kernel runs both products on the fp32 SIMT units (67
// TFLOP/s: 6.2 ms at best).  wgmma, TMA and a bf16 P (which changes the
// result against the reference's fp32 P) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBQ = 64;                   // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr int kThreads = 256;             // 16 row groups x 16 lanes
constexpr int kRows = kBQ / 16;           // query rows per thread
constexpr int kCols = kBK / 16;           // score columns per thread
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;             // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int groups, sq, skv, hd, causal, q_offset, n_qtiles;
  float scale;
};

template <typename D>
__device__ __forceinline__ D from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// stores x in a shared tile of type D: fp32 widens, the input type copies
__device__ __forceinline__ void put(float* d, float x) { *d = x; }
__device__ __forceinline__ void put(float* d, __nv_bfloat16 x) {
  *d = __bfloat162float(x);
}
__device__ __forceinline__ void put(__nv_bfloat16* d, __nv_bfloat16 x) { *d = x; }

// two neighbouring elements of a shared row as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int HDP>
struct Smem {
  static constexpr int kQS = HDP + 4;     // fp32 Q row stride: float4 rows
  static constexpr int kKS = HDP + 2;     // K row stride: 16 rows, 16 banks
  static constexpr int kVS = HDP;         // V rows are read along hd
  static constexpr int kPS = kBK + 4;
  static constexpr size_t kQBytes = size_t(kBQ) * kQS * sizeof(float);
  static constexpr size_t kKBytes = size_t(kBK) * kKS * sizeof(T);
  static constexpr size_t kVBytes = size_t(kBK) * kVS * sizeof(T);
  static constexpr size_t kPBytes = size_t(kBQ) * kPS * sizeof(float);
  static constexpr size_t kBytes = kQBytes + kKBytes + kVBytes + kPBytes;
};

// dst[r][d] = src[r * row_stride + d] for r < rows, d < hd; 0 elsewhere in
// the [64][HDP] tile.  With vec, 16-byte loads (the host checked alignment,
// strides and hd).
template <typename T, typename D, int HDP>
__device__ __forceinline__ void load_tile(D* dst, int dst_stride, const T* src,
                                          long long row_stride, int rows, int hd,
                                          bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kPerRow = HDP / kVec;
    for (int idx = threadIdx.x; idx < kBK * kPerRow; idx += kThreads) {
      const int r = idx / kPerRow;
      const int c = (idx % kPerRow) * kVec;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows && c < hd)
        u = __ldg(reinterpret_cast<const uint4*>(src + r * row_stride + c));
      const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int e = 0; e < kVec; ++e) put(dst + r * dst_stride + c + e, t[e]);
    }
  } else {
    const T zero = from_float<T>(0.f);
    for (int idx = threadIdx.x; idx < kBK * HDP; idx += kThreads) {
      const int r = idx / HDP;
      const int c = idx % HDP;
      put(dst + r * dst_stride + c,
          (r < rows && c < hd) ? src[r * row_stride + c] : zero);
    }
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const Params p, const bool vec) {
  using S = Smem<T, HDP>;
  constexpr int kOut = HDP / 16;          // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* ks = reinterpret_cast<T*>(smem + S::kQBytes);
  T* vs = reinterpret_cast<T*>(smem + S::kQBytes + S::kKBytes);
  float* ps = reinterpret_cast<float*>(smem + S::kQBytes + S::kKBytes + S::kVBytes);

  const int q0 = (p.n_qtiles - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.groups;
  const int ty = threadIdx.x / 16;        // row group: rows ty * kRows + i
  const int tx = threadIdx.x % 16;        // columns tx + 16 * j
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, float, HDP>(qs, S::kQS, qg, p.q_ss, min(kBQ, p.sq - q0), p.hd, vec);

  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, p.q_offset + min(q0 + kBQ, p.sq));
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    const int rows = min(kBK, p.skv - k0);
    __syncthreads();                      // the last tile's readers are done
    load_tile<T, T, HDP>(ks, S::kKS, kg + k0 * p.k_ss, p.k_ss, rows, p.hd, vec);
    load_tile<T, T, HDP>(vs, S::kVS, vg + k0 * p.v_ss, p.v_ss, rows, p.hd, vec);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; d += 2) {
      float2 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = load2(qs + (ty * kRows + i) * S::kQS + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = load2(ks + (tx + 16 * j) * S::kKS + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = ty * kRows + i;
      const int pos = p.q_offset + q0 + row;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (col >= p.skv || (p.causal && col > pos)) x = kNeg;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = expf(s[i][j] - m_new);
        ps[row * S::kPS + tx + 16 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncwarp();                         // a row group's P rows are its warp's

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows], vv[kOut];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty * kRows + i) * S::kPS + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) vv[c] = to_float(vs[j * S::kVS + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < kOut; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= p.sq) continue;
    T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd) og[d] = from_float<T>(acc[i][c] / denom);
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  bool vec = p.hd % kVec == 0;
  for (const void* ptr : {p.q, p.k, p.v})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long s : {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh, p.v_sb,
                      p.v_ss, p.v_sh})
    vec = vec && s % kVec == 0;
  const size_t smem = Smem<T, HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.n_qtiles), static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  flash_attention_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const Params& p, int batch, int heads, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, 32>(p, batch, heads, stream);
  if (p.hd <= 64) return launch<T, 64>(p, batch, heads, stream);
  return launch<T, 128>(p, batch, heads, stream);
}

}  // namespace

// q, k, v, o: device pointers; dtype 0 = float32, 1 = bfloat16 (all four
// alike); strides: 12 element strides (batch, seq, head) of q, k, v, o.
// Returns a cudaError_t; 0 when the launch was taken.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int batch, int heads,
                                      int groups, int sq, int skv, int hd,
                                      const long long* strides, int causal,
                                      int q_offset, float scale, void* stream) {
  if (batch < 0 || heads < 1 || groups < 1 || heads % groups || sq < 0 ||
      skv < 0 || hd < 1 || hd > 128 || q_offset < 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0) return 0;
  if (batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.groups = groups;
  p.sq = sq;
  p.skv = skv;
  p.hd = hd;
  p.causal = causal;
  p.q_offset = q_offset;
  p.n_qtiles = (sq + kBQ - 1) / kBQ;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 1 ? dispatch_hd<__nv_bfloat16>(p, batch, heads, s)
                                     : dispatch_hd<float>(p, batch, heads, s);
  return static_cast<int>(err);
}
