// K2 on Hopper: window-batched multiset Gram-triangle butterfly partials on
// the int8 tensor cores (wgmma, u8 limb operands, s32 accumulators folded
// into exact 64-bit totals), fed by TMA through a shared-memory ring, on a
// persistent triangle schedule, with the reference's float32 epilogue per
// entry and an exact integer sum.
//
// Replaces the TPU kernel `_windows_kernel_multiset`, launched by
// `butterfly_pairs_windows_kernel_multiset_call` in
// src/repro/kernels/butterfly/butterfly_kernel.py:191 (pallas_call :270).
//
// What it computes.  For a stack of weighted biadjacencies A[b] (entries =
// net edge multiplicities, non-negative integers; rows = the Gram side,
// already oriented by the caller) given as uint8 limb planes, and the square
// tiling of the Grams into block_i x block_i tiles, it writes one partial
// per window b and upper-triangle tile pair t = (u <= v), row-major:
//
//     partials[b, t] = fp32( sum over rows r of tile u, cols c of tile v,
//                            r < c, of  v(r, c) )
//     v = fp32(fp32(fp32(W)^2) - fp32(S)) * 0.5                    (fp32)
//     W = A A^T,  S = (A∘A)(A∘A)^T  exactly,  fp32(.) = round to nearest
//
// the reference's per-entry float32 arithmetic `(w * w - s) * 0.5` on the
// correctly rounded Grams.  Below 2**24 (every W^2, S and partial sum) the
// reference's float32 Grams are exact too, and the partial is the
// reference's exactly; past it the reference's Grams carry the rounding of
// the MXU's accumulation order, which no other order reproduces, and this
// kernel gives the correctly rounded Grams and the exactly summed epilogue.
//
// Limbs.  Write A = sum_p 2^(8p) a_p and A∘A = sum_p 2^(8p) x_p with uint8
// planes a_p (p < lw) and x_p (p < ls).  Then
//
//     W = sum_{p,q} 2^(8(p+q)) a_p a_q^T,   S = sum_{p,q} 2^(8(p+q)) x_p x_q^T.
//
// The stack is [n_windows, lw + ls, n_rows, row_bytes] uint8: planes a_0 ..
// a_{lw-1}, then x_0 .. x_{ls-1}.  Each limb product is a u8 x u8 Gram with
// s32 accumulators.  The products of one shift g = p + q share one s32
// accumulator (at most min(g, 2L - 2 - g) + 1 <= L <= 4 products), and after
// every kFold slices of 128 bytes of the contraction it is folded into a
// 64-bit total per entry, shifted by 8g.  So no accumulator wraps:
// 4 * 255^2 * 128 * kFold < 2^31 with kFold = 64, whatever n_k.  A tile
// runs only the limb products its rows need: masks[b, blk] has bit P set
// when plane P of window b holds a nonzero byte in rows 64 blk .. 64 blk +
// 63, and product (p, q) runs on a CTA tile only where plane p is nonzero
// in its A rows and plane q in its B rows (a zero plane adds nothing, so
// skipping it is exact).  High limbs are rare (a multiplicity of 256 or
// more, or 16 or more for A∘A), so most tiles run one product for W and
// one for S, and a tile with no nonzero row on either side runs none.
//
// Exact summation, and why nothing wraps.  Every per-entry value is a
// multiple of 0.5: fp32(W) and fp32(S) are integers, and so are fp32(W)^2
// and their difference in float32 at any magnitude.  The kernel adds 2v,
// an integer (negative past 2**24 where fp32(W)^2 rounds below fp32(S)),
// into a [B, T, 2] workspace with integer atomics, which are exact and
// commutative: its low 32 bits into an unsigned sum, the rest (2v >> 32)
// into a signed one.  A tile pair holds fewer than 2^32 entries, so neither
// sum wraps, and together they hold the exact sum, 2^32 hi + lo, whatever
// its size.  One last pass rounds it to float32 once (to nearest even: a
// sum of 64 bits or fewer directly, a larger one through its high word with
// the low word as a sticky bit, i.e. round to odd, which rounds the same)
// and halves it (exact).  The partials are therefore the same bits
// whatever the CTA tile, the order of the tiles or the number of windows
// in the launch.  Per entry: W_rc <= sqrt(W_rr W_cc) and W_rr = sum_k
// A_rk^2, the squared multiplicities at one vertex; the wrapper refuses any
// stack in which one vertex of either side has sum mult^2 > 2^31 (one edge
// of multiplicity 46,341).  Then W < 2^31, fp32(W)^2 <= 2^62, S_rc <=
// sqrt(S_rr S_cc) <= 2^62, every 2v fits a signed 64-bit integer, lw <= 2
// and ls <= 4.
//
// What bounds it on an H100.  Operations.  At the largest stack the
// multiset engine hands it on the smoke stream, [11, 3776, 5056] uint8
// planes with multiplicities up to 321 (lw = 2, ls = 3), one limb product
// over the strict upper triangle is 7.9e11 int8 operations, 0.40 ms at the
// 1,979 TOP/s int8 peak; all 13 products in every tile would take 5.2 ms,
// and the products each pair of 64-row blocks needs are far fewer
// (chip_smoke.py counts them from the masks).  The planes are 1.05 GB (0.31
// ms at 3.35 TB/s).  A CTA tile of 128 x 64
// reads 24 KB of panels per 128-deep slice of one limb product for 1.05e6
// multiply-adds: at the int8 peak about 23 TB/s out of L2, twice K1's
// demand, so L2, not the tensor cores, is the likely limit.  The tile is
// set by registers: a consumer thread holds 32 entries, each an s32
// accumulator, a 64-bit total and the float32 S of the first phase (4
// registers an entry); a wider tile would spill.
//
// Design.  K1's schedule (butterfly_windows_wgmma.cu): a persistent grid of
// one 384-thread CTA per SM walks a window-major list of the CTA tiles (tm,
// tn) that hold some r < c (tn >= 2 tm for 128 x 64 tiles), so a window's
// planes stay in L2 while its tiles run.  Warpgroup 2 is the producer: one
// thread keeps kStages steps in flight with TMA through a 4-d tensor map
// (byte, row, plane, window) over the stack's own strides, 128-byte swizzle,
// zero fill past each plane's rows and bytes; a step is one limb product on
// one 128-byte slice: the 128-row A panel of plane p (two 64-row boxes; the
// second is not loaded when it lies wholly past the last row, its rows are
// masked) and the 64-row B panel of plane q.  Warpgroups 0 and 1 each own
// 64 rows and run wgmma.m64n64k32.s32.u8.u8 (both operands K-major, as the
// stack lies), four per step, keeping one step's group in flight while the
// next one's issues.  Per tile the consumers run S's shift groups first and
// keep fp32(S) per entry, then W's groups into the 64-bit total, then the
// epilogue: 2v with the global r < c and ragged-edge masks, one
// warp-reduced pair of atomics where the CTA tile lies in one tile pair
// (every tile at block_i = 256, the main path), elsewhere one pair per run
// of a thread's entries in one tile pair.  Producer and consumers walk the same
// (phase, shift, fold, slice, product) order from the masks.  TMA needs a
// 16-byte-aligned base and rows of a multiple of 16 bytes; the wrapper's
// limb scatter and limb split build such stacks, and the launcher refuses
// anything else.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                     // rows of a CTA tile of W and S
constexpr int kBN = 64;                      // columns of a CTA tile
constexpr int kBK = 128;                     // contraction bytes per slice: one swizzle atom
constexpr int kBoxRows = 64;                 // rows per TMA box and per mask block (MASK_ROWS)
constexpr int kStages = 8;                   // steps in flight
constexpr int kThreads = 384;                // consumer warpgroups 0, 1; producer 2
constexpr int kMaxLimbs = 4;                 // planes per Gram (lw <= 2, ls <= 4)
constexpr int kFold = 64;                    // slices between folds: 4 * 255^2 * 128 * 64 < 2^31
constexpr int kBoxBytes = kBoxRows * kBK;    // 8 KB
constexpr int kABytes = kBM * kBK;           // 16 KB
constexpr int kBBytes = kBN * kBK;           // 8 KB
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kBars = kStages * kStageBytes;
constexpr int kSmemBytes = kBars + 2 * kStages * 8 + 1024;   // 1024: slack to align

static_assert(static_cast<long long>(kMaxLimbs) * 255 * 255 * kBK * kFold < (1ll << 31),
              "a shift group's s32 accumulator could wrap between folds");

struct Params {
  unsigned long long* sums;                  // [B, T, 2] exact sums of 2v: {lo, hi}
  const int* masks;                          // [B, n_blocks] planes nonzero per 64 rows
  long long n_pairs;                         // T
  long long per_window;                      // CTA tiles listed per window
  long long n_work;                          // B * per_window
  int n_rows, k_slices, block_i, n_tiles, col_tiles, lw, ls, n_blocks;
};

#include "wgmma_u8.cuh"

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

#define K2_R8(d, i)                                                             \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),   \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d += A B^T, m64 n64 k32, A and B K-major u8 in shared memory, s32
// accumulators
__device__ __forceinline__ void wgmma_u8(int32_t (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : K2_R8(d, 0), K2_R8(d, 8), K2_R8(d, 16), K2_R8(d, 24)
      : "l"(a), "l"(b), "r"(1));
}

// work item idx -> (window, row tile, column tile); row tile m lists column
// tiles 2 m .. col_tiles - 1 (the others hold no r < c)
__device__ __forceinline__ void decode(long long idx, const Params& p, int& b, int& tm,
                                       int& tn) {
  b = static_cast<int>(idx / p.per_window);
  long long rem = idx - static_cast<long long>(b) * p.per_window;
  int m = 0;
  while (rem >= p.col_tiles - 2 * m) {
    rem -= p.col_tiles - 2 * m;
    ++m;
  }
  tm = m;
  tn = 2 * m + static_cast<int>(rem);
}

// the planes with a nonzero byte in the A rows (bits_a) and the B rows
// (bits_b) of CTA tile (tm, tn) of window b
__device__ __forceinline__ void tile_planes(const Params& p, int b, int tm, int tn,
                                            uint32_t& bits_a, uint32_t& bits_b) {
  const int* m = p.masks + static_cast<long long>(b) * p.n_blocks;
  bits_a = static_cast<uint32_t>(m[2 * tm]) |
           (2 * tm + 1 < p.n_blocks ? static_cast<uint32_t>(m[2 * tm + 1]) : 0u);
  bits_b = static_cast<uint32_t>(m[tn]);
}

// the limb products of shift group g (nl limbs a side, planes plane0 ..)
// that the tile needs: bit pa for product (pa, g - pa)
__device__ __forceinline__ uint32_t group_products(uint32_t bits_a, uint32_t bits_b,
                                                   int plane0, int nl, int g) {
  uint32_t need = 0;
  for (int pa = max(0, g - nl + 1); pa <= min(g, nl - 1); ++pa)
    need |= ((bits_a >> (plane0 + pa)) & (bits_b >> (plane0 + g - pa)) & 1u) << pa;
  return need;
}

// 2v of one entry: the reference's float32 (w * w - s) * 0.5, doubled, as
// the integer it is (|2v| <= 2^62)
__device__ __forceinline__ long long twice_pair_value(unsigned long long w, float sf) {
  const float wf = __ull2float_rn(w);
  return __float2ll_rn(__fsub_rn(__fmul_rn(wf, wf), sf));
}

// a tile pair's exact sum of 2v as 2^32 hi + lo: lo sums the low 32 bits of
// each 2v, hi the rest (two's complement)
struct SplitSum {
  unsigned long long lo = 0;
  long long hi = 0;
  __device__ __forceinline__ void add(long long x) {
    lo += static_cast<unsigned long long>(x) & 0xffffffffull;
    hi += x >> 32;
  }
  // adds this sum into the workspace's pair {lo, hi}
  __device__ __forceinline__ void flush(unsigned long long* pair) const {
    if (lo != 0) atomicAdd(pair, lo);
    if (hi != 0) atomicAdd(pair + 1, static_cast<unsigned long long>(hi));
  }
};

// the totals of warpgroup wg of the CTA tile (tm, tn) of window b -> the
// exact sums.  Entry 4 j + 2 i + e is row 64 wg + 16 warp + lane / 4 + 8 i
// and column 8 j + 2 (lane % 4) + e of the tile.
__device__ __forceinline__ void epilogue(const unsigned long long (&w)[32],
                                         const float (&sf)[32], const Params& p, int b,
                                         int tm, int tn, int wg, int tid) {
  const int lane = tid % 32;
  const int n = p.n_rows;
  const int bi = p.block_i;
  const int r0 = kBM * tm + 64 * wg + 16 * (tid / 32) + lane / 4;
  const int c0 = kBN * tn + 2 * (lane % 4);
  unsigned long long* sums = p.sums + 2 * static_cast<long long>(b) * p.n_pairs;
  const int u = kBM * tm / bi;
  const int v = kBN * tn / bi;
  if (u == (min(kBM * tm + kBM, n) - 1) / bi && v == (min(kBN * tn + kBN, n) - 1) / bi) {
    // the CTA tile lies in one tile pair: one pair of atomics per warp
    SplitSum s;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * i;
          const int c = c0 + 8 * j + e;
          const int x = 4 * j + 2 * i + e;
          if (c < n && r < c) s.add(twice_pair_value(w[x], sf[x]));
        }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s.lo += __shfl_xor_sync(0xffffffffu, s.lo, off);
      s.hi += __shfl_xor_sync(0xffffffffu, s.hi, off);
    }
    if (lane == 0) s.flush(sums + 2 * pair_index(u, v, p.n_tiles));
    return;
  }
  // several tile pairs: one flush per run of a thread's entries in one
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= n) continue;
    const int ur = r / bi;
    // + 2 v: the pair (ur, v)
    unsigned long long* row = sums + 2 * (pair_index(ur, ur, p.n_tiles) - ur);
    int run_v = -1;
    SplitSum run;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + e;
        const int x = 4 * j + 2 * i + e;
        if (c < n && r < c) {
          const int vc = c / bi;
          if (vc != run_v) {
            if (run_v >= 0) run.flush(row + 2 * run_v);
            run = SplitSum();
            run_v = vc;
          }
          run.add(twice_pair_value(w[x], sf[x]));
        }
      }
    if (run_v >= 0) run.flush(row + 2 * run_v);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
butterfly_windows_multiset_wgmma_kernel(const __grid_constant__ CUtensorMap map,
                                        const Params p) {
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
        uint32_t bits_a, bits_b;
        tile_planes(p, b, tm, tn, bits_a, bits_b);
        if (bits_a == 0 || bits_b == 0) continue;  // no nonzero row: W = S = 0
        const int ra = kBM * tm;
        const int rb = kBN * tn;
        // an A box wholly past the last row is not loaded: the rows it
        // would feed are masked, so what its smem holds does not matter
        const bool two = ra + kBoxRows < p.n_rows;
        const uint32_t bytes = kBBytes + (two ? kABytes : kABytes / 2);
        for (int phase = 0; phase < 2; ++phase) {
          const int nl = phase == 0 ? p.ls : p.lw;
          const int plane0 = phase == 0 ? p.lw : 0;
          for (int g = 0; g <= 2 * nl - 2; ++g) {
            const uint32_t need = group_products(bits_a, bits_b, plane0, nl, g);
            if (need == 0) continue;
            for (int k0 = 0; k0 < p.k_slices; k0 += kFold) {
              const int k1 = min(k0 + kFold, p.k_slices);
              for (int kt = k0; kt < k1; ++kt)
                for (uint32_t left = need; left != 0; left &= left - 1, ++it) {
                  const int pa = __ffs(left) - 1;
                  const uint32_t s = it % kStages;
                  if (it >= kStages) bar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
                  const uint32_t full = full0 + 8 * s;
                  const uint32_t dst = base + s * kStageBytes;
                  bar_expect_tx(full, bytes);
                  tma_load(dst, &map, full, kt * kBK, ra, plane0 + pa, b);
                  if (two)
                    tma_load(dst + kBoxBytes, &map, full, kt * kBK, ra + kBoxRows,
                             plane0 + pa, b);
                  tma_load(dst + kABytes, &map, full, kt * kBK, rb, plane0 + g - pa, b);
                }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of a tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    int32_t acc[32];
    unsigned long long tot[32];
    float sf[32];
    uint32_t it = 0;
    for (long long idx = blockIdx.x; idx < p.n_work; idx += gridDim.x) {
      int b, tm, tn;
      decode(idx, p, b, tm, tn);
      uint32_t bits_a, bits_b;
      tile_planes(p, b, tm, tn, bits_a, bits_b);
      if (bits_a == 0 || bits_b == 0) continue;    // no nonzero row: nothing to add
      for (int phase = 0; phase < 2; ++phase) {
        const int nl = phase == 0 ? p.ls : p.lw;
        const int plane0 = phase == 0 ? p.lw : 0;
#pragma unroll
        for (int i = 0; i < 32; ++i) tot[i] = 0;
        for (int g = 0; g <= 2 * nl - 2; ++g) {
          const uint32_t need = group_products(bits_a, bits_b, plane0, nl, g);
          if (need == 0) continue;
          for (int k0 = 0; k0 < p.k_slices; k0 += kFold) {
            const int k1 = min(k0 + kFold, p.k_slices);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[i] = 0;
            bool held = false;                     // a finished step still holds its stage
            for (int kt = k0; kt < k1; ++kt)
              for (uint32_t left = need; left != 0; left &= left - 1, ++it) {
                const uint32_t s = it % kStages;
                bar_wait(full0 + 8 * s, (it / kStages) & 1);
                const uint32_t sa = base + s * kStageBytes + wg * kBoxBytes;
                const uint32_t sb = base + s * kStageBytes + kABytes;
                wg_fence();
#pragma unroll
                for (int kk = 0; kk < kBK / 32; ++kk)
                  wgmma_u8(acc, desc(sa + 32 * kk), desc(sb + 32 * kk));
                wg_commit();
                // the previous step's products are done: release its stage
                wg_wait<1>();
                if (held) {
                  __syncwarp();
                  if (lane == 0) bar_arrive(empty0 + 8 * ((it - 1) % kStages));
                }
                held = true;
              }
            wg_wait<0>();
            __syncwarp();
            if (lane == 0) bar_arrive(empty0 + 8 * ((it - 1) % kStages));
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              keep(acc[i]);
              tot[i] += static_cast<unsigned long long>(static_cast<uint32_t>(acc[i]))
                        << (8 * g);
            }
          }
        }
        if (phase == 0) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sf[i] = __ull2float_rn(tot[i]);
        }
      }
      epilogue(tot, sf, p, b, tm, tn, wg, tid);
    }
  }
}

// exact sums of 2v -> partials, each rounded to float32 once (to nearest
// even) and halved (exact)
__global__ void round_half_sums_kernel(const unsigned long long* __restrict__ sums,
                                       float* __restrict__ partials, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned long long lo = sums[2 * i];
    // the sum is 2^32 hi + lo with 0 <= lo < 2^32
    const long long hi = static_cast<long long>(sums[2 * i + 1]) + static_cast<long long>(lo >> 32);
    const long long low = static_cast<long long>(lo & 0xffffffffull);
    float t;
    if (hi >= -(1ll << 31) && hi < (1ll << 31))
      t = __ll2float_rn(hi * 4294967296ll + low);   // the sum fits 64 bits
    else                                          // round to odd at 2^32, then to nearest
      t = __fmul_rn(__ll2float_rn(hi | (low != 0 ? 1ll : 0ll)), 4294967296.f);
    partials[i] = __fmul_rn(t, 0.5f);
  }
}

// A 4-d map over a contiguous [n_windows, n_planes, n_rows, row_bytes] uint8
// stack, innermost first as (byte, row, plane, window); a box of one
// 128-byte atom of 64 rows of one plane of one window, 128-byte swizzle,
// zero fill out of bounds (past the row's bytes and past the plane's last
// row, never into the next plane).
cudaError_t make_map(CUtensorMap* map, const void* ptr, int row_bytes, int n_rows,
                     int n_planes, int n_windows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t plane = static_cast<cuuint64_t>(row_bytes) * n_rows;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(n_rows),
                              static_cast<cuuint64_t>(n_planes),
                              static_cast<cuuint64_t>(n_windows)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row_bytes), plane,
                                 plane * n_planes};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBK), static_cast<cuuint32_t>(kBoxRows),
                             1u, 1u};
  const cuuint32_t estride[4] = {1u, 1u, 1u, 1u};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr),
                            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point, bound with ctypes.  planes: uint8 [n_windows, lw +
// ls, n_rows, row_bytes] contiguous on the device, 16-byte aligned,
// row_bytes a multiple of 16 (zero past the matrix's columns): a_0 ..
// a_{lw-1}, x_0 .. x_{ls-1}; masks: int32 [n_windows, ceil(n_rows / 64)],
// bit P set where plane P has a nonzero byte in those 64 rows (a set bit
// that is not needed costs time, a missing one loses products); sums:
// 64-bit scratch of 2 n_windows n_pairs; partials: float32 [n_windows,
// n_pairs] with n_pairs = n_tiles (n_tiles + 1) / 2, n_tiles = ceil(n_rows /
// block_i).  1 <= lw, ls <= 4.  Zeroes the scratch, runs the Gram kernel
// (not when row_bytes is 0: every W and S is 0) and the rounding pass on
// `stream`, and returns cudaGetLastError() (0 on success); it neither
// synchronizes nor allocates.
extern "C" int butterfly_windows_multiset_wgmma_launch(const void* planes, const void* masks,
                                                       void* sums, void* partials,
                                                       int n_windows, int lw, int ls,
                                                       int n_rows, int row_bytes,
                                                       int block_i, void* stream_ptr) {
  if (n_windows < 0 || n_rows < 0 || row_bytes < 0 || block_i <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (lw < 1 || lw > kMaxLimbs || ls < 1 || ls > kMaxLimbs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (row_bytes % 16 || reinterpret_cast<uintptr_t>(planes) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_windows > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (n_rows + block_i - 1) / block_i;
  const long long n_pairs = static_cast<long long>(n_tiles) * (n_tiles + 1) / 2;
  const long long total = n_pairs * n_windows;
  if (total == 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = cudaMemsetAsync(sums, 0, static_cast<size_t>(total) * 16, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (row_bytes > 0) {
    Params p;
    p.sums = static_cast<unsigned long long*>(sums);
    p.masks = static_cast<const int*>(masks);
    p.n_blocks = (n_rows + kBoxRows - 1) / kBoxRows;
    p.n_pairs = n_pairs;
    p.n_rows = n_rows;
    p.k_slices = (row_bytes + kBK - 1) / kBK;
    p.block_i = block_i;
    p.n_tiles = n_tiles;
    p.col_tiles = (n_rows + kBN - 1) / kBN;
    p.lw = lw;
    p.ls = ls;
    const int row_tiles = (n_rows + kBM - 1) / kBM;
    p.per_window = 0;
    for (int m = 0; m < row_tiles; ++m)
      p.per_window += p.col_tiles - 2 * m > 0 ? p.col_tiles - 2 * m : 0;
    p.n_work = p.per_window * n_windows;
    CUtensorMap map;
    err = make_map(&map, planes, row_bytes, n_rows, lw + ls, n_windows);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(butterfly_windows_multiset_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = p.n_work < sms ? p.n_work : sms;
    butterfly_windows_multiset_wgmma_kernel<<<static_cast<unsigned>(grid), kThreads,
                                              kSmemBytes, stream>>>(map, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (total + 255) / 256;
  round_half_sums_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
                           stream>>>(static_cast<const unsigned long long*>(sums),
                                     static_cast<float*>(partials), total);
  return static_cast<int>(cudaGetLastError());
}

// the Gram kernel's dynamic shared memory in bytes
extern "C" int butterfly_windows_multiset_wgmma_smem_bytes() { return kSmemBytes; }
