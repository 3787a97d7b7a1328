// The stored-type fused probe tail: gather rows in their STORED dtype (bf16
// or int8, or f32 with scales), decode in registers, exact weighted-L1
// re-rank, top-k.
//
// Replaces the TPU kernel src/repro/kernels/gather_rerank.py
// (gather_rerank_topk_pallas_blocked -> _make_blocked_kernel, single
// segment, and with delta= two_seg=True, two segments). The TPU version
// gathers CBLK = 8 candidate rows per grid step as parallel scalar-prefetch
// DMA streams of the encoded rows (twice as many streams with two segments)
// and decodes in-register (``row.astype(f32) * scales``, scales = 1 when
// there are none). Here the f32 kernels' body and schedules run templated
// on the stored type (gather_rerank.cuh), so a stored table is read at its
// compressed width.
//
// What bounds it: by the bound, the bytes of the distinct candidate rows at
// the stored width (a quarter of the f32 tail's for int8); in practice, the
// cost of each gathered row, not its bytes — which is why bf16 and int8
// rows are PACKED two to a warp load (a lane loads 16 bytes of bf16 or 8 of
// int8 at d = 128), the int8 decode is a byte permute and a subtraction (no
// int-to-float convert), and the warp reduces several rows at once. The
// host picks the schedule per call (gather_schedule in
// kernels/gather_rerank.py): the split schedule, 8 warps per (query, slot
// split), or, for lists of fewer 32-slot groups than a split block has
// warps (the screen's survivors), one warp per query. Both return bit for
// bit what the f32 kernels return over the decoded table.
// gather_rerank_warp_launch runs the one-warp schedule on its own, for
// every stored type: the bit reference of the split schedule, reached by
// no query path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gather_rerank.cuh"

namespace {

constexpr int WARP_SCHEDULE = 0;  // S = 0: one warp per query; S >= 1: S slot splits

template <typename T, bool SCALED, bool TWO_SEG>
cudaError_t launch_schedule(const T* rows, const T* drows, const float* scales, const int* ids,
                            const float* queries, const float* weights, float* out_d, int* out_i,
                            float* part_d, int* part_s, int n_main, int n_tot, int d, int b,
                            int P, int k, int S, cudaStream_t s) {
  if (S == WARP_SCHEDULE)
    return gather_rerank::launch_warp<T, SCALED, TWO_SEG>(rows, drows, scales, ids, queries,
                                                          weights, out_d, out_i, n_main, n_tot,
                                                          d, b, P, k, s);
  return gather_rerank::launch_split<T, SCALED, TWO_SEG>(rows, drows, scales, ids, queries,
                                                         weights, out_d, out_i, part_d, part_s,
                                                         n_main, n_tot, d, b, P, k, S, s);
}

template <typename T, bool TWO_SEG>
cudaError_t launch_typed(const void* data, const void* delta, const float* scales, const int* ids,
                         const float* queries, const float* weights, float* out_d, int* out_i,
                         float* part_d, int* part_s, int n_main, int n_tot, int d, int b, int P,
                         int k, int S, cudaStream_t s) {
  const T* rows = static_cast<const T*>(data);
  const T* drows = static_cast<const T*>(delta);
  if (scales != nullptr)
    return launch_schedule<T, true, TWO_SEG>(rows, drows, scales, ids, queries, weights, out_d,
                                             out_i, part_d, part_s, n_main, n_tot, d, b, P, k, S,
                                             s);
  return launch_schedule<T, false, TWO_SEG>(rows, drows, nullptr, ids, queries, weights, out_d,
                                            out_i, part_d, part_s, n_main, n_tot, d, b, P, k, S,
                                            s);
}

template <bool TWO_SEG>
int launch_dtype(const void* data, const void* delta, int dtype, const float* scales,
                 const int* ids, const float* queries, const float* weights, float* out_d,
                 int* out_i, float* part_d, int* part_s, int n_main, int n_tot, int d, int b,
                 int P, int k, int S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_typed<float, TWO_SEG>(data, delta, scales, ids, queries, weights, out_d,
                                               out_i, part_d, part_s, n_main, n_tot, d, b, P, k,
                                               S, s);
    case 1:
      return (int)launch_typed<__nv_bfloat16, TWO_SEG>(data, delta, scales, ids, queries,
                                                       weights, out_d, out_i, part_d, part_s,
                                                       n_main, n_tot, d, b, P, k, S, s);
    case 2:
      return (int)launch_typed<int8_t, TWO_SEG>(data, delta, scales, ids, queries, weights,
                                                out_d, out_i, part_d, part_s, n_main, n_tot, d,
                                                b, P, k, S, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int blocks_of(const void* data, const void* delta, int scaled, int d) {
  const T* rows = static_cast<const T*>(data);
  const T* drows = static_cast<const T*>(delta);
  if (delta == nullptr)
    return scaled ? gather_rerank::split_blocks<T, true, false>(rows, nullptr, d)
                  : gather_rerank::split_blocks<T, false, false>(rows, nullptr, d);
  return scaled ? gather_rerank::split_blocks<T, true, true>(rows, drows, d)
                : gather_rerank::split_blocks<T, false, true>(rows, drows, d);
}

}  // namespace

// data (n, d) of the stored dtype (0: f32, 1: bf16, 2: int8), scales (d,)
// f32 or NULL, ids (b, P) int32 (>= n or < 0: invalid), queries/weights
// (b, d) f32 -> out_d (b, k) f32, out_i (b, k) int32. S = 0 runs one warp
// per query; S >= 1 the split schedule in S slot splits (part_d/part_s:
// (b, S, k) f32/int32 scratch, NULL when S <= 1). All contiguous on the
// current device. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int gather_rerank_blocked_launch(const void* data, int dtype, const float* scales,
                                            const int* ids, const float* queries,
                                            const float* weights, float* out_d, int* out_i,
                                            float* part_d, int* part_s, int n, int d, int b,
                                            int P, int k, int S, void* stream) {
  return launch_dtype<false>(data, nullptr, dtype, scales, ids, queries, weights, out_d, out_i,
                             part_d, part_s, n, n, d, b, P, k, S, stream);
}

// The two-segment form: data (n_main, d) and delta (cap, d), both of the
// stored dtype; ids address [data; delta] (>= n_main + cap or < 0:
// invalid); one scales vector decodes both. The rest as above.
extern "C" int gather_rerank_blocked2_launch(const void* data, const void* delta, int dtype,
                                             const float* scales, const int* ids,
                                             const float* queries, const float* weights,
                                             float* out_d, int* out_i, float* part_d,
                                             int* part_s, int n_main, int cap, int d, int b,
                                             int P, int k, int S, void* stream) {
  return launch_dtype<true>(data, delta, dtype, scales, ids, queries, weights, out_d, out_i,
                            part_d, part_s, n_main, n_main + cap, d, b, P, k, S, stream);
}

// The one-warp-per-query schedule alone, for every stored type, single
// segment (delta NULL, cap ignored) or two: the bit reference of the split
// schedule. The arguments as above.
extern "C" int gather_rerank_warp_launch(const void* data, const void* delta, int dtype,
                                         const float* scales, const int* ids,
                                         const float* queries, const float* weights, float* out_d,
                                         int* out_i, int n_main, int cap, int d, int b, int P,
                                         int k, void* stream) {
  if (delta == nullptr)
    return launch_dtype<false>(data, nullptr, dtype, scales, ids, queries, weights, out_d, out_i,
                               nullptr, nullptr, n_main, n_main, d, b, P, k, WARP_SCHEDULE,
                               stream);
  return launch_dtype<true>(data, delta, dtype, scales, ids, queries, weights, out_d, out_i,
                            nullptr, nullptr, n_main, n_main + cap, d, b, P, k, WARP_SCHEDULE,
                            stream);
}

// Blocks per SM of the split kernel that the launches above would run with
// these tables, dtype and decode (delta NULL: single segment) — its
// __launch_bounds__ minimum, from which the host sizes the splits; -1 for an
// unknown dtype.
extern "C" int gather_rerank_blocked_split_blocks(const void* data, const void* delta, int dtype,
                                                  int scaled, int d) {
  switch (dtype) {
    case 0:
      return blocks_of<float>(data, delta, scaled, d);
    case 1:
      return blocks_of<__nv_bfloat16>(data, delta, scaled, d);
    case 2:
      return blocks_of<int8_t>(data, delta, scaled, d);
    default:
      return -1;
  }
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
