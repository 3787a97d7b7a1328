// The f32 fused probe tail: gather, exact weighted-L1 re-rank, top-k, on a
// schedule of many warps per query with a split-and-merge top-k.
//
// Replaces the TPU kernels src/repro/kernels/gather_rerank.py
// (gather_rerank_topk_pallas -> _gather_rerank_kernel, :303/:365, single
// segment, and with delta= -> _gather_rerank2_kernel, :111, two segments),
// f32 rows. The TPU version DMAs one (1, 128) row per grid step through
// scalar prefetch (the two-segment one runs both tables as prefetch streams
// and keeps the owning segment's partial sum) and keeps a 128-lane
// replace-max buffer that the wrapper sorts afterwards.
//
// What bounds it on this card: by the bound, the HBM bytes of the distinct
// candidate rows (and the ids); in practice, the rows every query gathers
// on its own — b x (valid ids) x 512 bytes at d = 128, served by the L2
// where queries share rows (8.7 GB for 64 queries over every row of a
// mutable index) — and the latency of those dependent loads. Rows in
// flight on the card are what hides that latency: one warp per query
// leaves 16 of 132 SMs busy at b = 64 and ~8 warps per SM at b = 1024, each
// walking its rows one group after another. So these entries always run
// the split schedule of gather_rerank.cuh (8 warps per (query, slot
// split), the splits' (dist, slot) lists merged), whose body and schedule
// the stored-type kernels (gather_rerank_blocked.cu) share. The output is
// the k smallest (dist, slot) pairs as (dist, id): bit for bit what the
// one-warp-per-query schedule returns.

#include <cuda_runtime.h>

#include "gather_rerank.cuh"

// data (n, d) f32, ids (b, P) int32, queries/weights (b, d) f32 ->
// out_d (b, k) f32, out_i (b, k) int32, in S slot splits (part_d/part_s:
// (b, S, k) f32/int32 scratch, NULL when S == 1); all contiguous on the
// current device. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int gather_rerank_launch(const float* data, const int* ids, const float* queries,
                                    const float* weights, float* out_d, int* out_i,
                                    float* part_d, int* part_s, int n, int d, int b, int P, int k,
                                    int S, void* stream) {
  return (int)gather_rerank::launch_split<float, false, false>(
      data, nullptr, nullptr, ids, queries, weights, out_d, out_i, part_d, part_s, n, n, d, b, P,
      k, S, static_cast<cudaStream_t>(stream));
}

// The two-segment form: data (n_main, d) and delta (cap, d) f32; ids
// address [data; delta] (>= n_main + cap or < 0: invalid). The rest as above.
extern "C" int gather_rerank2_launch(const float* data, const float* delta, const int* ids,
                                     const float* queries, const float* weights, float* out_d,
                                     int* out_i, float* part_d, int* part_s, int n_main, int cap,
                                     int d, int b, int P, int k, int S, void* stream) {
  return (int)gather_rerank::launch_split<float, false, true>(
      data, delta, nullptr, ids, queries, weights, out_d, out_i, part_d, part_s, n_main,
      n_main + cap, d, b, P, k, S, static_cast<cudaStream_t>(stream));
}

// Blocks per SM of the split kernel that the launch above would run with
// these tables (delta NULL: single segment) — its __launch_bounds__ minimum,
// from which the host sizes the splits.
extern "C" int gather_rerank_split_blocks(const float* data, const float* delta, int d) {
  if (delta == nullptr) return gather_rerank::split_blocks<float, false, false>(data, nullptr, d);
  return gather_rerank::split_blocks<float, false, true>(data, delta, d);
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
