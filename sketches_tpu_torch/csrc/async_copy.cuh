// mbarrier and bulk-copy primitives (inline PTX, sm_90), shared by the
// kernels that stream rows or tiles through a shared-memory ring
// (overlap.cu, quantile.cu).
//
// A ring slot has a *full* barrier (the producer's arrive.expect_tx plus
// the bytes of its cp.async.bulk copies) and an *empty* barrier (the
// consumers' arrivals).  Waits take the parity of the phase to wait for;
// a fresh barrier counts as having completed the phase of parity 1.
#pragma once

namespace sk {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Make the barriers' initialisation visible to the other threads and to
// the async proxy (then a block-wide barrier).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Arrive and expect `bytes` more of asynchronous copies in this phase.
__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Global -> shared bulk copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned), completing as transaction bytes on `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Order this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (a bulk copy that refills a slot the thread wrote).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace sk
