// K4 on Hopper, float32 inputs: the FlashAttention-2 forward pass (online
// softmax over key/value tiles) on the fp32 SIMT units, and the C entry
// point of both K4 variants (bf16 inputs go to flash_attention_wgmma.cu).
//
// Replaces the TPU kernel `_kernel` launched by `flash_attention_call` in
// src/repro/kernels/flash_attention/flash_kernel.py:29 (pallas_call :83),
// with its wrapper `flash_attention` (ops.py), and serves the port's
// `gqa_attention_chunked` (the XLA twin of the same schedule in
// src/repro/models/transformer/attention.py:33).
//
// What it computes.  For q [B, Sq, H, hd], k [B, Skv, Hkv, hd] and v [B,
// Skv, Hkv, hd_v] read through their strides (no transpose, no GQA repeat:
// query head h reads key/value head h / groups; hd_v may differ from hd, as
// in MLA), the output o [B, Sq, H, hd_v] is
//
//     s   = (q . k) * scale                       (fp32)
//     s   = -1e30 where col >= Skv, or causal and col > q_offset + row
//     m'  = max(m, rowmax(s));  p = exp(s - m');  corr = exp(m - m')
//     l   = l * corr + rowsum(p);  acc = acc * corr + p v;  m = m'
//     o   = acc / max(l, 1e-30)
//
// with (acc, m, l) in fp32, as the reference kernel computes them.  Tiles
// wholly above the causal diagonal are skipped: there the reference's p is
// exp(-1e30 - m) = 0 and corr = 1, so skipping them changes nothing.  Tile
// order is ascending, so a row's first tile holds its column 0 and m is
// finite after it.  Ragged lengths (Sq or Skv not a multiple of a tile) are
// masked here; callers pad nothing.  expf, never __expf (no fast math).
//
// Design.  One block of 256 threads per (64 query rows, head, batch).  The
// Q tile and each 64-key K and V tile are staged in shared memory at a
// padded head dim HDP >= max(hd, hd_v), zero past each tensor's own (zero
// columns add nothing to q . k, and only d < hd_v is written).  A thread
// owns 4 query rows and, for them, 4 score columns and HDP / 16 output
// columns: the 16 threads of a row group are lanes of one warp, so
// the row max and sum are warp shuffles and the P tile needs only a warp
// barrier between its write and its read.  Query tiles launch heaviest
// first (the last causal tiles walk the most keys).
//
// What bounds it on an H100.  Operations: float32 operands have no exact
// tensor-core product (TF32 keeps 10 bits), so both products run on the
// fp32 SIMT units (67 TFLOP/s).  float32 inputs are off the serve path
// (the LM serves bf16); they keep this kernel.

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
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_ss, q_sh;             // strides in elements
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int groups, sq, skv, hd, hd_v, causal, q_offset, n_qtiles;
  float scale;
};

template <int HDP>
struct Smem {
  static constexpr int kQS = HDP + 4;     // Q row stride: float4 rows
  static constexpr int kKS = HDP + 2;     // K row stride: 16 rows, 16 banks
  static constexpr int kVS = HDP;         // V rows are read along hd
  static constexpr int kPS = kBK + 4;
  static constexpr size_t kQBytes = size_t(kBQ) * kQS * sizeof(float);
  static constexpr size_t kKBytes = size_t(kBK) * kKS * sizeof(float);
  static constexpr size_t kVBytes = size_t(kBK) * kVS * sizeof(float);
  static constexpr size_t kPBytes = size_t(kBQ) * kPS * sizeof(float);
  static constexpr size_t kBytes = kQBytes + kKBytes + kVBytes + kPBytes;
};

// dst[r][d] = src[r * row_stride + d] for r < rows, d < hd; 0 elsewhere in
// the [64][HDP] tile.  With vec, 16-byte loads (the host checked alignment,
// strides and hd).
template <int HDP>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride, const float* src,
                                          long long row_stride, int rows, int hd,
                                          bool vec) {
  if (vec) {
    constexpr int kPerRow = HDP / 4;
    for (int idx = threadIdx.x; idx < kBK * kPerRow; idx += kThreads) {
      const int r = idx / kPerRow;
      const int c = (idx % kPerRow) * 4;
      float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < hd)
        u = __ldg(reinterpret_cast<const float4*>(src + r * row_stride + c));
      float* d = dst + r * dst_stride + c;  // K rows are not 16-byte aligned
      d[0] = u.x;
      d[1] = u.y;
      d[2] = u.z;
      d[3] = u.w;
    }
  } else {
    for (int idx = threadIdx.x; idx < kBK * HDP; idx += kThreads) {
      const int r = idx / HDP;
      const int c = idx % HDP;
      dst[r * dst_stride + c] = (r < rows && c < hd) ? src[r * row_stride + c] : 0.f;
    }
  }
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const Params p, const bool vec) {
  using S = Smem<HDP>;
  constexpr int kOut = HDP / 16;          // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = reinterpret_cast<float*>(smem + S::kQBytes);
  float* vs = reinterpret_cast<float*>(smem + S::kQBytes + S::kKBytes);
  float* ps = reinterpret_cast<float*>(smem + S::kQBytes + S::kKBytes + S::kVBytes);

  const int q0 = (p.n_qtiles - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.groups;
  const int ty = threadIdx.x / 16;        // row group: rows ty * kRows + i
  const int tx = threadIdx.x % 16;        // columns tx + 16 * j
  const float* qg = p.q + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kg = p.k + b * p.k_sb + hk * p.k_sh;
  const float* vg = p.v + b * p.v_sb + hk * p.v_sh;

  load_tile<HDP>(qs, S::kQS, qg, p.q_ss, min(kBQ, p.sq - q0), p.hd, vec);

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
    load_tile<HDP>(ks, S::kKS, kg + k0 * p.k_ss, p.k_ss, rows, p.hd, vec);
    load_tile<HDP>(vs, S::kVS, vg + k0 * p.v_ss, p.v_ss, rows, p.hd_v, vec);
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
      for (int i = 0; i < kRows; ++i) qv[i] = *reinterpret_cast<const float2*>(qs + (ty * kRows + i) * S::kQS + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = *reinterpret_cast<const float2*>(ks + (tx + 16 * j) * S::kKS + d);
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
      for (int c = 0; c < kOut; ++c) vv[c] = vs[j * S::kVS + tx + 16 * c];
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
    float* og = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c) {
      const int d = tx + 16 * c;
      if (d < p.hd_v) og[d] = acc[i][c] / denom;
    }
  }
}

template <int HDP>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  bool vec = p.hd % 4 == 0 && p.hd_v % 4 == 0;
  for (const void* ptr : {p.q, p.k, p.v})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long s : {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss, p.k_sh, p.v_sb,
                      p.v_ss, p.v_sh})
    vec = vec && s % 4 == 0;
  const size_t smem = Smem<HDP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.n_qtiles), static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  flash_attention_kernel<HDP><<<grid, kThreads, smem, stream>>>(p, vec);
  return cudaGetLastError();
}

cudaError_t launch_f32(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int hd = p.hd > p.hd_v ? p.hd : p.hd_v;
  if (hd <= 32) return launch<32>(p, batch, heads, stream);
  if (hd <= 64) return launch<64>(p, batch, heads, stream);
  return launch<128>(p, batch, heads, stream);
}

}  // namespace

// flash_attention_wgmma.cu: the bf16 variant
cudaError_t k4_bf16_launch(const void* q, const void* k, const void* v, void* o,
                           int batch, int heads, int groups, int sq, int skv, int hd,
                           int hd_v, const long long* strides, int causal, int q_offset,
                           float scale, cudaStream_t stream);
int k4_bf16_smem_bytes(int hd, int hd_v);

// q, k, v, o: device pointers; dtype 0 = float32 (this file's SIMT kernel),
// 1 = bfloat16 (the wgmma kernel, which takes only TMA-ready q, k, v: a
// 16-byte-aligned base and strides of 16 bytes); all four alike; hd: the
// head dim of q and k, hd_v: of v and o; strides: 12 element strides
// (batch, seq, head) of q, k, v, o.  Returns a cudaError_t; 0 when the
// launch was taken.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, int dtype, int batch, int heads,
                                      int groups, int sq, int skv, int hd, int hd_v,
                                      const long long* strides, int causal,
                                      int q_offset, float scale, void* stream) {
  if (batch < 0 || heads < 1 || groups < 1 || heads % groups || sq < 0 ||
      skv < 0 || hd < 1 || hd > 128 || hd_v < 1 || hd_v > 128 || q_offset < 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0) return 0;
  if (batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return static_cast<int>(k4_bf16_launch(q, k, v, o, batch, heads, groups, sq, skv,
                                           hd, hd_v, strides, causal, q_offset, scale,
                                           s));
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.groups = groups;
  p.sq = sq;
  p.skv = skv;
  p.hd = hd;
  p.hd_v = hd_v;
  p.causal = causal;
  p.q_offset = q_offset;
  p.n_qtiles = (sq + kBQ - 1) / kBQ;
  p.scale = scale;
  return static_cast<int>(launch_f32(p, batch, heads, s));
}

// The dynamic shared memory of the variant that `flash_attention_launch`
// runs for dtype (0 float32, 1 bfloat16) and head dims hd (q, k) and hd_v.
extern "C" int flash_attention_smem_bytes(int dtype, int hd, int hd_v) {
  if (dtype == 1) return k4_bf16_smem_bytes(hd, hd_v);
  if (hd_v > hd) hd = hd_v;
  if (hd <= 32) return static_cast<int>(Smem<32>::kBytes);
  if (hd <= 64) return static_cast<int>(Smem<64>::kBytes);
  return static_cast<int>(Smem<128>::kBytes);
}
