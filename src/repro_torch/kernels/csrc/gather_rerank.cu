// The f32 fused probe tail: gather, exact weighted-L1 re-rank, top-k.
//
// Replaces the TPU kernel src/repro/kernels/gather_rerank.py
// (gather_rerank_topk_pallas -> _gather_rerank_kernel), single segment,
// f32 rows. The TPU version DMAs one (1, 128) row per grid step through
// scalar prefetch and keeps a 128-lane replace-max buffer that the wrapper
// sorts afterwards. The kernel body, what bounds it and its design are in
// gather_rerank.cuh; this file instantiates it for f32 rows without scales.

#include <cuda_runtime.h>

#include "gather_rerank.cuh"

// data (n, d) f32, ids (b, P) int32, queries/weights (b, d) f32 ->
// out_d (b, k) f32, out_i (b, k) int32; all contiguous on the current
// device. Returns the CUDA error code of the launch (0 on success).
extern "C" int gather_rerank_launch(const float* data, const int* ids, const float* queries,
                                    const float* weights, float* out_d, int* out_i, int n, int d,
                                    int b, int P, int k, void* stream) {
  return (int)gather_rerank::launch<float, false>(data, nullptr, ids, queries, weights, out_d,
                                                   out_i, n, d, b, P, k,
                                                   static_cast<cudaStream_t>(stream));
}

// Message of a CUDA error code returned by the launch function above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
