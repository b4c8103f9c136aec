// 16-byte shared-memory accesses and TMA bulk copies on mbarriers (sm_90),
// shared by the sweep (sweep.cu) and linear-rollout (linroll.cu) kernels.
//
// A bulk copy moves a multiple of 16 bytes between 16-byte aligned
// addresses; the kernels' wrappers refuse rows that are not a multiple of
// 16 bytes and copy an operand that does not start 16-byte aligned.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace tma {

// 16 bytes between registers and 16-byte aligned shared memory
__device__ __forceinline__ void ld16(float* o, const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void ld16(double* o, const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  o[0] = v.x;
  o[1] = v.y;
}
__device__ __forceinline__ void st16(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st16(double* p, const double* o) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
}

// Bulk copies (TMA, sm_90) that complete on an mbarrier in shared memory.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
#ifdef __CUDA_ARCH__
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
#else
  return 0;
#endif
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

// one arrival that also expects `bytes` of bulk copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
#endif
}

template <typename T>
__device__ __forceinline__ void bulk_copy(T* dst, const T* src, int n,
                                          uint64_t* bar) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src),
      "r"((unsigned)(n * sizeof(T))), "r"(smem_u32(bar)) : "memory");
#else
  memcpy(dst, src, n * sizeof(T));
#endif
}

// Wait for the phase of the given parity; a copy that never lands traps
// (after ~2^32 cycles) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
#ifdef __CUDA_ARCH__
  const long long t0 = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
#endif
}

}  // namespace tma
