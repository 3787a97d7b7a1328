// The quantized-storage fused probe tail: gather rows in their STORED dtype
// (bf16 or int8, or f32 with scales), decode in registers, exact
// weighted-L1 re-rank, top-k.
//
// Replaces the TPU kernel src/repro/kernels/gather_rerank.py
// (gather_rerank_topk_pallas_blocked -> _make_blocked_kernel, single
// segment, and with delta= two_seg=True, two segments). The TPU version
// gathers CBLK = 8 candidate rows per grid step as parallel scalar-prefetch
// DMA streams of the encoded rows (twice as many streams with two segments)
// and decodes in-register (``row.astype(f32) * scales``, scales = 1 when
// there are none). Here the same per-query warp kernel as the f32 tail runs,
// templated on the stored type (gather_rerank.cuh): a warp load moves one
// 128-byte int8 row or one 256-byte bf16 row at d = 128, so a quantized
// table is read at its compressed width, and U = 8 rows per lane stay in
// flight.
//
// What bounds it: the bytes of the unique candidate rows at the stored
// width (a quarter of the f32 tail's for int8) and the latency of the
// dependent row loads. With one warp per query the int8 kernel is latency-
// bound well above that byte bound; more rows per warp load would change
// the summation order and lose the bitwise match with the f32 kernel over
// the decoded table, so it stays as it is for now.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gather_rerank.cuh"

namespace {

template <typename T, bool TWO_SEG>
cudaError_t launch_typed(const void* data, const void* delta, const float* scales, const int* ids,
                         const float* queries, const float* weights, float* out_d, int* out_i,
                         int n_main, int n_tot, int d, int b, int P, int k, cudaStream_t s) {
  const T* rows = static_cast<const T*>(data);
  const T* drows = static_cast<const T*>(delta);
  if (scales != nullptr)
    return gather_rerank::launch<T, true, TWO_SEG>(rows, drows, scales, ids, queries, weights,
                                                   out_d, out_i, n_main, n_tot, d, b, P, k, s);
  return gather_rerank::launch<T, false, TWO_SEG>(rows, drows, nullptr, ids, queries, weights,
                                                  out_d, out_i, n_main, n_tot, d, b, P, k, s);
}

template <bool TWO_SEG>
int launch_dtype(const void* data, const void* delta, int dtype, const float* scales,
                 const int* ids, const float* queries, const float* weights, float* out_d,
                 int* out_i, int n_main, int n_tot, int d, int b, int P, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_typed<float, TWO_SEG>(data, delta, scales, ids, queries, weights, out_d,
                                               out_i, n_main, n_tot, d, b, P, k, s);
    case 1:
      return (int)launch_typed<__nv_bfloat16, TWO_SEG>(data, delta, scales, ids, queries,
                                                       weights, out_d, out_i, n_main, n_tot, d,
                                                       b, P, k, s);
    case 2:
      return (int)launch_typed<int8_t, TWO_SEG>(data, delta, scales, ids, queries, weights,
                                                out_d, out_i, n_main, n_tot, d, b, P, k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// data (n, d) of the stored dtype (0: f32, 1: bf16, 2: int8), scales (d,)
// f32 or NULL, ids (b, P) int32 (>= n or < 0: invalid), queries/weights
// (b, d) f32 -> out_d (b, k) f32, out_i (b, k) int32; all contiguous on the
// current device. Returns the CUDA error code of the launch (0 on success).
extern "C" int gather_rerank_blocked_launch(const void* data, int dtype, const float* scales,
                                            const int* ids, const float* queries,
                                            const float* weights, float* out_d, int* out_i,
                                            int n, int d, int b, int P, int k, void* stream) {
  return launch_dtype<false>(data, nullptr, dtype, scales, ids, queries, weights, out_d, out_i,
                             n, n, d, b, P, k, stream);
}

// The two-segment form: data (n_main, d) and delta (cap, d), both of the
// stored dtype; ids address [data; delta] (>= n_main + cap or < 0:
// invalid); one scales vector decodes both. The rest as above.
extern "C" int gather_rerank_blocked2_launch(const void* data, const void* delta, int dtype,
                                             const float* scales, const int* ids,
                                             const float* queries, const float* weights,
                                             float* out_d, int* out_i, int n_main, int cap, int d,
                                             int b, int P, int k, void* stream) {
  return launch_dtype<true>(data, delta, dtype, scales, ids, queries, weights, out_d, out_i,
                            n_main, n_main + cap, d, b, P, k, stream);
}

// Message of a CUDA error code returned by the launch function above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
