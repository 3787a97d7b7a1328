// Asynchronous global -> shared copies (cp.async, sm_80+) and the one-time
// dynamic shared-memory opt-in of a kernel, shared by the scan and the
// projection kernels.
#pragma once

#include <cuda_runtime.h>

// Copies 4 bytes, or writes 4 zero bytes when !ok (src is then not read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 4 : 0));
}

// Copies 16 bytes (both addresses 16-byte aligned), or writes 16 zero bytes
// when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Lets KERNEL launch with `bytes` of dynamic shared memory. The attribute is
// set once per kernel and device, and again only when a launch needs more
// than was allowed before.
template <auto KERNEL>
cudaError_t allow_dynamic_smem(size_t bytes) {
  constexpr int MAX_DEVICES = 64;
  static int allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && (int)bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = (int)bytes;
  return err;
}
