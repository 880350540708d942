// Building blocks shared by the butterfly kernels on Hopper (K1/K3 in
// butterfly_windows_wgmma.cu, K2 in butterfly_windows_multiset_wgmma.cu):
// mbarriers, wgmma shared-memory descriptors for K-major 128-byte-swizzled
// u8 tiles, the wgmma fence / commit / wait, the upper-triangle tile-pair
// index and the lookup of cuTensorMapEncodeTiled.  Included inside each source's
// anonymous namespace, so each kernel library links its own copy.

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

// a wgmma shared-memory descriptor for a K-major 128-byte-swizzled tile:
// start address, 1024 bytes (8 rows of 128 bytes) between 8-row groups; the
// leading offset is unused for K-major swizzled operands and is given the
// same 1024.  A k32 step of 8-bit operands is +32 bytes inside the atom.
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
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving a register's reads or writes across an
// asynchronous wgmma that still uses it
__device__ __forceinline__ void keep(int32_t& x) { asm volatile("" : "+r"(x)::"memory"); }

// row-major index of upper-triangle tile pair (u, v), u <= v, of nu tiles
__device__ __forceinline__ long long pair_index(int u, int v, int nu) {
  return static_cast<long long>(u) * nu - static_cast<long long>(u) * (u - 1) / 2 + (v - u);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query,
// so the library links only the runtime
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
