// The f32 fused probe tail: gather, exact weighted-L1 re-rank, top-k.
//
// Replaces the TPU kernels src/repro/kernels/gather_rerank.py
// (gather_rerank_topk_pallas -> _gather_rerank_kernel, single segment, and
// with delta= -> _gather_rerank2_kernel, two segments), f32 rows. The TPU
// version DMAs one (1, 128) row per grid step through scalar prefetch (the
// two-segment one runs both tables as prefetch streams and keeps the owning
// segment's partial sum) and keeps a 128-lane replace-max buffer that the
// wrapper sorts afterwards. The kernel body, what bounds it and its design
// are in gather_rerank.cuh; this file instantiates it for f32 rows without
// scales, once per segment count.

#include <cuda_runtime.h>

#include "gather_rerank.cuh"

// data (n, d) f32, ids (b, P) int32, queries/weights (b, d) f32 ->
// out_d (b, k) f32, out_i (b, k) int32; all contiguous on the current
// device. Returns the CUDA error code of the launch (0 on success).
extern "C" int gather_rerank_launch(const float* data, const int* ids, const float* queries,
                                    const float* weights, float* out_d, int* out_i, int n, int d,
                                    int b, int P, int k, void* stream) {
  return (int)gather_rerank::launch<float, false, false>(
      data, nullptr, nullptr, ids, queries, weights, out_d, out_i, n, n, d, b, P, k,
      static_cast<cudaStream_t>(stream));
}

// The two-segment form: data (n_main, d) and delta (cap, d) f32; ids
// address [data; delta] (>= n_main + cap or < 0: invalid). The rest as above.
extern "C" int gather_rerank2_launch(const float* data, const float* delta, const int* ids,
                                     const float* queries, const float* weights, float* out_d,
                                     int* out_i, int n_main, int cap, int d, int b, int P, int k,
                                     void* stream) {
  return (int)gather_rerank::launch<float, false, true>(
      data, delta, nullptr, ids, queries, weights, out_d, out_i, n_main, n_main + cap, d, b, P,
      k, static_cast<cudaStream_t>(stream));
}

// Message of a CUDA error code returned by the launch function above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
