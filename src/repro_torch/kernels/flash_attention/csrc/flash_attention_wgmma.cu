// K4 on Hopper, bf16 inputs: the FlashAttention forward pass on the tensor
// cores (wgmma), fed by TMA, with the reference's fp32 P carried into the PV
// product exactly as three bf16 limbs.
//
// Replaces the TPU kernel `_kernel` launched by `flash_attention_call` in
// src/repro/kernels/flash_attention/flash_kernel.py:29 (pallas_call :83) for
// bf16 inputs; float32 inputs keep the fp32 SIMT kernel of
// flash_attention.cu, whose C entry point `flash_attention_launch` sends
// bf16 here.  It computes what the reference computes, with (acc, m, l) in
// fp32:
//
//     s   = (q . k) * scale                       (fp32)
//     s   = -1e30 where col >= Skv, or causal and col > q_offset + row
//     m'  = max(m, rowmax(s));  p = exp(s - m');  corr = exp(m - m')
//     l   = l * corr + rowsum(p);  acc = acc * corr + p v;  m = m'
//     o   = acc / max(l, 1e-30)                   (written in bf16)
//
// What bounds it on an H100.  Operations.  At the serve path's shape (q
// [4, 4096, 24, 128], k and v [4, 4096, 8, 128], causal) QK^T and PV are
// 206.2 GFLOP each; q, k, v and o are 268 MB (80 us at 3.35 TB/s).  QK^T on
// bf16 operands is exact on the bf16 tensor cores (products of two 8-bit
// significands, fp32 accumulation).  PV takes the reference's fp32 P, so
// three bf16 products (below): 4 x 206.2 GFLOP at 989 TFLOP/s = 0.834 ms.
// At MiniCPM3's MLA prefill (q, k [4, 4096, 40, 96], v [4, 4096, 40, 64])
// QK^T is 257.7 GFLOP and PV 171.8 GFLOP, three limbs of it 515.4: 0.782
// ms at 989 TFLOP/s.
//
// The three limbs.  Each p is split in registers as hi = bf16_rn(p),
// p -= hi, mid = bf16_rn(p), p -= mid, lo = bf16_rn(p).  Every subtraction
// is exact (p - bf16_rn(p) is a multiple of p's last fp32 bit and below
// half of hi's last bf16 bit), mid and hi each take 8 significant bits, so
// the second remainder has at most 8 bits left and lo holds it exactly:
// hi + mid + lo == p wherever no limb falls below fp32's normal range,
// that is for p above about 2^-100, far under every tolerance (smaller p
// lose at most 2^-126 each, next to l >= 1).  Each limb times a bf16 v is
// exact in fp32, so the three register-A wgmmas into one fp32 accumulator
// differ from the reference's fp32 p v only in the order of summation.
// `flash_kernel.split_bf16_limbs` is the same split in torch, for tests.
//
// Design.  One block of 384 threads per (128 query rows, head, batch):
// warpgroups 0 and 1 each own 64 query rows, warpgroup 2 produces.  One
// producer thread loads the Q tile once and keeps kStages (K, V) tiles of
// 64 keys in flight with TMA (cp.async.bulk.tensor, 4-d maps over
// (hd, head, seq, batch) built on the host from the tensors' strides, so
// GQA reads key/value head h / groups with no repeat and no copy), each
// stage guarded by a full and an empty mbarrier.  Tiles land in shared
// memory in the 128-byte swizzle that the wgmma descriptors name: a row of
// hd = 128 bf16 is two 64-column atoms of 128 bytes.  A consumer
// warpgroup computes S = Q K^T with wgmma.m64n64k16 (Q and K K-major in
// shared memory, fp32 accumulation in registers), the online softmax on S's
// registers (expf and IEEE division, no fast math, as the reference), peels
// the three limbs in place and issues one register-A wgmma per limb and
// 16 keys against V (MN-major: the transpose bit) into the fp32 O
// accumulator.  setmaxnreg gives the producer's registers to the consumers.
// Tiles wholly above the causal diagonal are never loaded (exact: there
// p = 0 and corr = 1); only tiles that cross the diagonal or the ragged end
// of the keys are masked; rows past Sq are computed on TMA's zero fill and
// never written.  Query tiles launch heaviest first across the whole grid.
//
// The value head dim hd_v may differ from the query/key head dim hd (MLA:
// MiniCPM3's prefill has hd = 96, hd_v = 64).  The kernel is a template on
// two atom counts, NQK for Q and K (ceil(hd / 64)) and NV for V and the O
// accumulator (ceil(hd_v / 64)), and each tensor map is built at its own
// head dim.  A head dim that is not a multiple of 64 leaves part of its last
// atom to TMA's zero fill (at hd = 96 the second Q/K atom is half zeros, a
// 192-byte row): zero columns add nothing to q . k, and the epilogue writes
// only d < hd_v.  The same fill zeroes K and V rows past Skv in the last
// key tile, whose scores are masked.
// TMA needs a 16-byte-aligned base and strides that are multiples of 16
// bytes; the wrapper hands this kernel a padded copy of any input that
// does not meet that (flash_kernel._launch), and the launcher refuses one.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBQ = 128;                  // query rows per block
constexpr int kBK = 64;                   // keys per tile
constexpr int kStages = 3;                // (K, V) tiles in flight
constexpr int kThreads = 384;             // consumer warpgroups 0, 1; producer 2
constexpr int kAtomCols = 64;             // bf16 columns of one 128-byte atom
constexpr int kQAtom = kBQ * 128;         // bytes of one Q atom
constexpr int kKVAtom = kBK * 128;        // bytes of one K or V atom
constexpr float kNeg = -1e30f;

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_ss, o_sh;             // strides in elements
  int groups, sq, skv, hd_v, causal, q_offset, n_qtiles, pairs;
  float scale;
};

// shared memory of a block: NQK Q atoms, then per stage NQK K atoms and NV
// V atoms, then the barriers (q, full[kStages], empty[kStages]); 1024 bytes
// of slack align the swizzled tiles
template <int NQK, int NV>
struct Smem {
  static constexpr int kQ = NQK * kQAtom;
  static constexpr int kStage = (NQK + NV) * kKVAtom;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// waits until the phase of parity `parity` has completed; traps (an error
// the launch reports, not a hang) after about 2^34 cycles without it
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1ll << 34))
      __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// a wgmma shared-memory descriptor for a 128-byte-swizzled tile: start
// address, 1024 bytes (8 rows of 128 bytes) between 8-row groups; the
// leading offset is unused by both operands (K-major, or MN-major within
// one 64-column atom) and is given the same 1024
__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving a register's reads or writes across an
// asynchronous wgmma that still uses it
__device__ __forceinline__ void keep(float& x) { asm volatile("" : "+f"(x)::"memory"); }
__device__ __forceinline__ void keep(uint32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

#define K4_D32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),           \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),     \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31])

#define K4_R32                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31}"

// d (+)= A B, m64 n64 k16, A and B K-major bf16 in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K4_R32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : K4_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64 n64 k16, A bf16 in registers, B MN-major bf16 in shared
// memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " K4_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : K4_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the next limb of (x0, x1): their bf16 roundings packed as one register
// (x0 in the low half), subtracted from x0 and x1 exactly
__device__ __forceinline__ uint32_t peel(float& x0, float& x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  x0 = __fsub_rn(x0, f.x);
  x1 = __fsub_rn(x1, f.y);
  uint32_t u;
  memcpy(&u, &h, sizeof(u));
  return u;
}

template <int NQK, int NV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Params p) {
  using S = Smem<NQK, NV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle: 1024-aligned
  const uint32_t qbar = base + S::kBars;
  const uint32_t full0 = qbar + 8;                // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * kStages;    // empty[s] = empty0 + 8 s

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (p.n_qtiles - 1 - static_cast<int>(blockIdx.z)) * kBQ;
  const int hk = h / p.groups;
  int kv_end = p.skv;
  if (p.causal) kv_end = min(kv_end, p.q_offset + min(q0 + kBQ, p.sq));
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    bar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full0 + 8 * s, 1);
      bar_init(empty0 + 8 * s, 8);                // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      bar_expect_tx(qbar, NQK * kQAtom);
      for (int a = 0; a < NQK; ++a)
        tma_load(base + a * kQAtom, &tq, qbar, a * kAtomCols, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) bar_wait(empty0 + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        const uint32_t kb = base + S::kQ + s * S::kStage;
        bar_expect_tx(full, (NQK + NV) * kKVAtom);
        for (int a = 0; a < NQK; ++a)
          tma_load(kb + a * kKVAtom, &tk, full, a * kAtomCols, hk, t * kBK, b);
        for (int a = 0; a < NV; ++a)
          tma_load(kb + (NQK + a) * kKVAtom, &tv, full, a * kAtomCols, hk, t * kBK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int r0 = 16 * (tid / 32) + lane / 4;    // rows r0 and r0 + 8 of the 64
    const int cq = 2 * (lane % 4);                // columns cq, cq + 1 of each 8
    const int w0 = q0 + 64 * wg;
    int my_tiles = 0;                             // this warpgroup's key tiles
    if (w0 < p.sq) {
      int end = p.skv;
      if (p.causal) end = min(end, p.q_offset + min(w0 + 64, p.sq));
      my_tiles = (end + kBK - 1) / kBK;
    }
    const int pos0 = p.q_offset + w0 + r0;        // row r0's global position

    float o[NV][32];
#pragma unroll
    for (int a = 0; a < NV; ++a)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[a][i] = 0.f;
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.f, 0.f};

    bar_wait(qbar, 0);
    const uint32_t qb = base + wg * 64 * 128;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      bar_wait(full0 + 8 * s, (t / kStages) & 1);
      if (t < my_tiles) {
        const uint32_t kb = base + S::kQ + s * S::kStage;
        const uint32_t vb = kb + NQK * kKVAtom;

        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        wg_fence();
#pragma unroll
        for (int a = 0; a < NQK; ++a)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(sc, desc(qb + a * kQAtom + kk * 32), desc(kb + a * kKVAtom + kk * 32),
                     (a | kk) != 0);
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int i = 0; i < 32; ++i) keep(sc[i]);

        // online softmax; sc[4 j + 2 i + e] is row r0 + 8 i, column
        // k0 + 8 j + cq + e
        const int k0 = t * kBK;
        const bool edge = k0 + kBK > p.skv || (p.causal && k0 + kBK - 1 > p.q_offset + w0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int pos = pos0 + 8 * i;
          float mx = kNeg;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float x = sc[4 * j + 2 * i + e] * p.scale;
              if (edge) {
                const int col = k0 + 8 * j + cq + e;
                if (col >= p.skv || (p.causal && col > pos)) x = kNeg;
              }
              sc[4 * j + 2 * i + e] = x;
              mx = fmaxf(mx, x);
            }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[i], mx);
          const float corr = expf(m[i] - m_new);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pe = expf(sc[4 * j + 2 * i + e] - m_new);
              sc[4 * j + 2 * i + e] = pe;
              sum += pe;
            }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          l[i] = l[i] * corr + sum;
#pragma unroll
          for (int a = 0; a < NV; ++a)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              o[a][4 * j + 2 * i] *= corr;
              o[a][4 * j + 2 * i + 1] *= corr;
            }
          m[i] = m_new;
        }

        // P's three limbs as wgmma A fragments: keys 16 kk .. 16 kk + 15
        // are sc[8 kk .. 8 kk + 7], register r of the fragment the pair
        // sc[8 kk + 2 r], sc[8 kk + 2 r + 1]
        uint32_t hi[4][4], mid[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) hi[kk][r] = peel(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) mid[kk][r] = peel(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) lo[kk][r] = peel(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int a = 0; a < NV; ++a)
            wgmma_rs(o[a], hi[kk], desc(vb + a * kKVAtom + kk * 16 * 128));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int a = 0; a < NV; ++a)
            wgmma_rs(o[a], mid[kk], desc(vb + a * kKVAtom + kk * 16 * 128));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int a = 0; a < NV; ++a)
            wgmma_rs(o[a], lo[kk], desc(vb + a * kKVAtom + kk * 16 * 128));
        wg_commit();
        wg_wait_all();
#pragma unroll
        for (int a = 0; a < NV; ++a)
#pragma unroll
          for (int i = 0; i < 32; ++i) keep(o[a][i]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            keep(hi[kk][r]);
            keep(mid[kk][r]);
            keep(lo[kk][r]);
          }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty0 + 8 * s);  // this warp is done with stage s
    }

    // o[a][4 j + 2 i + e] is row r0 + 8 i, column 64 a + 8 j + cq + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = w0 + r0 + 8 * i;
      if (row >= p.sq) continue;
      const float denom = fmaxf(l[i], 1e-30f);
      __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
      for (int a = 0; a < NV; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = kAtomCols * a + 8 * j + cq;
          if (d >= p.hd_v) continue;
          const float x0 = o[a][4 * j + 2 * i] / denom;
          const float x1 = o[a][4 * j + 2 * i + 1] / denom;
          if (p.pairs) {
            *reinterpret_cast<__nv_bfloat162*>(og + d) = __floats2bfloat162_rn(x0, x1);
          } else {
            og[d] = __float2bfloat16_rn(x0);
            if (d + 1 < p.hd_v) og[d + 1] = __float2bfloat16_rn(x1);
          }
        }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library links only the runtime
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A 4-d map over a [batch, seq, heads, hd] bf16 tensor with element strides
// (sb, ss, sh, 1), innermost first as (hd, heads, seq, batch); a box of one
// 64-column atom of `rows` rows of one head, 128-byte swizzle, zero fill out
// of bounds.  TMA needs a 16-byte-aligned base and strides that are
// multiples of 16 bytes; a dimension of extent 1 is never stepped and gets
// a stride that TMA takes.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int seq,
                     int batch, long long sh, long long ss, long long sb, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq > 0 ? seq : 1),
                              static_cast<cuuint64_t>(batch)};
  const long long elem[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  cuuint64_t span = (static_cast<cuuint64_t>(hd) * 2 + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) {
      strides[i] = span;
    } else {
      if (elem[i] <= 0 || (elem[i] * 2) % 16) return cudaErrorInvalidValue;
      strides[i] = static_cast<cuuint64_t>(elem[i]) * 2;
    }
    if (strides[i] * dims[i + 1] > span) span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kAtomCols), 1u,
                             static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t estride[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NQK, int NV>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = Smem<NQK, NV>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma_kernel<NQK, NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(batch),
                  static_cast<unsigned>(p.n_qtiles));
  flash_attention_wgmma_kernel<NQK, NV><<<grid, kThreads, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// The bf16 launch behind `flash_attention_launch` (flash_attention.cu), with
// the arguments that entry point checked.
cudaError_t k4_bf16_launch(const void* q, const void* k, const void* v, void* o,
                           int batch, int heads, int groups, int sq, int skv, int hd,
                           int hd_v, const long long* strides, int causal, int q_offset,
                           float scale, cudaStream_t stream) {
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  if (n_qtiles > 65535 || batch > 65535) return cudaErrorInvalidConfiguration;
  const int hkv = heads / groups;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map(&tq, q, hd, heads, sq, batch, strides[2], strides[1],
                             strides[0], kBQ);
  if (err == cudaSuccess)
    err = make_map(&tk, k, hd, hkv, skv, batch, strides[5], strides[4], strides[3], kBK);
  if (err == cudaSuccess)
    err = make_map(&tv, v, hd_v, hkv, skv, batch, strides[8], strides[7], strides[6], kBK);
  if (err != cudaSuccess) return err;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.groups = groups;
  p.sq = sq;
  p.skv = skv;
  p.hd_v = hd_v;
  p.causal = causal;
  p.q_offset = q_offset;
  p.n_qtiles = n_qtiles;
  p.pairs = hd_v % 2 == 0 && p.o_sb % 2 == 0 && p.o_ss % 2 == 0 && p.o_sh % 2 == 0 &&
            reinterpret_cast<uintptr_t>(o) % 4 == 0;
  p.scale = scale;
  if (hd <= kAtomCols)
    return hd_v <= kAtomCols ? launch<1, 1>(tq, tk, tv, p, batch, heads, stream)
                             : launch<1, 2>(tq, tk, tv, p, batch, heads, stream);
  return hd_v <= kAtomCols ? launch<2, 1>(tq, tk, tv, p, batch, heads, stream)
                           : launch<2, 2>(tq, tk, tv, p, batch, heads, stream);
}

// dynamic shared memory of the bf16 kernel at head dims hd (q, k) and hd_v
int k4_bf16_smem_bytes(int hd, int hd_v) {
  if (hd <= kAtomCols) return hd_v <= kAtomCols ? Smem<1, 1>::kBytes : Smem<1, 2>::kBytes;
  return hd_v <= kAtomCols ? Smem<2, 1>::kBytes : Smem<2, 2>::kBytes;
}
