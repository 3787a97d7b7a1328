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
// flight on the card are what hides that latency: one warp per query (the
// quantized kernels' schedule) leaves 16 of 132 SMs busy at b = 64 and ~8
// warps per SM at b = 1024, each walking its rows one group after another.
// The schedule here:
//   * a block owns one query and one contiguous range of slots (a split)
//     and runs SPLIT_WARPS = 8 warps over it; warp w takes the range's
//     32-slot groups w, w+8, w+16, ..., so the dedupe stage's packing
//     (valid ids first, sentinels last) spreads evenly over the warps;
//     each warp keeps U rows in flight (rerank_group, gather_rerank.cuh)
//     and its own sorted (dist, slot) list of k in shared memory; q and w
//     are staged once per block;
//   * at the end warp 0 merges the 8 lists by (dist, slot)
//     (warp_merge_lists); the slot makes the merge exact whatever the
//     interleave, and the result is the k smallest (dist, slot) pairs of
//     the range — what one warp walking the slots in order keeps;
//   * where b blocks cannot fill the card the host splits each query's
//     slots S ways (gather_splits in kernels/gather_rerank.py, from b, P
//     and the SM count). The grid is (b, S) with the query fastest-varying,
//     so the blocks that walk one slot range for neighbouring queries run
//     together and a row that many queries gather (every row, in a mutable
//     index's exact mode) comes from HBM about once and from the L2 after
//     that. With S = 1 the block writes the (b, k) answer; with S > 1 it
//     writes its (dist, slot) list to a (b, S, k) scratch and a second
//     launch (gather_rerank_merge_kernel) merges the S lists of a query the
//     same way, one warp per query, and looks up the ids of the winners.
// Each row's distance is the per-group body's, and the output is the k
// smallest (dist, slot) pairs as (dist, id): bit for bit what the
// one-warp-per-query schedule returns.

#include <cuda_runtime.h>

#include "gather_rerank.cuh"

namespace gather_rerank {

constexpr int SPLIT_WARPS = 8;       // warps per block: one query, one slot range
constexpr int SPLIT_MIN_BLOCKS = 3;  // blocks per SM the registers must allow
constexpr int MERGE_WARPS = 4;       // queries per block of the split merge

// Grid (b, S). With S == 1 writes out_d/out_i (b, k) as (dist, id); with
// S > 1 writes out_d/out_i (b, S, k) as (dist, slot) for the merge launch.
template <bool VEC4, bool TWO_SEG>
__global__ void __launch_bounds__(SPLIT_WARPS * 32, SPLIT_MIN_BLOCKS)
    gather_rerank_split_kernel(const float* __restrict__ data, const float* __restrict__ delta,
                               const int* __restrict__ ids, const float* __restrict__ queries,
                               const float* __restrict__ weights, float* __restrict__ out_d,
                               int* __restrict__ out_i, int n_main, int n_tot, int d, int P,
                               int k, int slots_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int dpad = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ws = qs + dpad;
  float* ld = ws + dpad;                                   // SPLIT_WARPS lists: k dists
  int* ls = reinterpret_cast<int*>(ld + SPLIT_WARPS * k);  // ... and k slots each
  int* head = ls + SPLIT_WARPS * k;                        // the merge's list heads
  float* td = ld + warp * k;
  int* ts = ls + warp * k;
  const long long delta_shift =
      TWO_SEG ? (long long)(reinterpret_cast<uintptr_t>(delta) -
                            reinterpret_cast<uintptr_t>(data)) -
                    (long long)n_main * d * (long long)sizeof(float)
              : 0;

  for (int j = threadIdx.x; j < d; j += SPLIT_WARPS * 32) {
    qs[j] = queries[(size_t)qi * d + j];
    ws[j] = weights[(size_t)qi * d + j];
  }
  warp_topk_init(td, ts, k, lane);
  __syncthreads();

  const int* idrow = ids + (size_t)qi * P;
  const int s0 = split * slots_per_split;  // a multiple of 32
  const int s1 = min(P, s0 + slots_per_split);
  float worst = CUDART_INF_F;
  for (int c = s0 + warp * 32; c < s1; c += SPLIT_WARPS * 32) {
    const int my = (c + lane < s1) ? idrow[c + lane] : -1;
    const unsigned mask = __ballot_sync(FULL_MASK, my >= 0 && my < n_tot);
    if (mask == 0) continue;
    worst = rerank_group<float, false, VEC4, TWO_SEG, true>(data, delta_shift, qs, ws, ws, my,
                                                            mask, c, n_main, d, td, ts, k, worst,
                                                            lane);
  }
  __syncthreads();
  if (warp != 0) return;
  if (S == 1) {
    float* od = out_d + (size_t)qi * k;
    int* oi = out_i + (size_t)qi * k;
    warp_merge_lists(ld, ls, SPLIT_WARPS, k, head, lane, [&](int j, float dv, int slot) {
      od[j] = dv;
      oi[j] = slot >= 0 ? idrow[slot] : -1;
    });
  } else {
    float* od = out_d + ((size_t)qi * S + split) * k;
    int* os = out_i + ((size_t)qi * S + split) * k;
    warp_merge_lists(ld, ls, SPLIT_WARPS, k, head, lane, [&](int j, float dv, int slot) {
      od[j] = dv;
      os[j] = slot;
    });
  }
}

// One warp per query merges its S (dist, slot) lists of the split launch
// into the (b, k) answer, (dist, id).
__global__ void __launch_bounds__(MERGE_WARPS * 32)
    gather_rerank_merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_s,
                               const int* __restrict__ ids, float* __restrict__ out_d,
                               int* __restrict__ out_i, int b, int P, int k, int S) {
  extern __shared__ int heads[];  // MERGE_WARPS x S
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * MERGE_WARPS + warp;
  if (qi >= b) return;  // only warp-level synchronisation below
  const int* idrow = ids + (size_t)qi * P;
  float* od = out_d + (size_t)qi * k;
  int* oi = out_i + (size_t)qi * k;
  warp_merge_lists(part_d + (size_t)qi * S * k, part_s + (size_t)qi * S * k, S, k,
                   heads + warp * S, lane, [&](int j, float dv, int slot) {
                     od[j] = dv;
                     oi[j] = slot >= 0 ? idrow[slot] : -1;
                   });
}

// Dynamic shared memory of one split block: q, w, SPLIT_WARPS lists of k
// (dist, slot), and the merge's SPLIT_WARPS list heads.
inline size_t split_smem_bytes(int d, int k) {
  const int dpad = (d + 3) & ~3;
  return sizeof(float) * ((size_t)2 * dpad + (size_t)2 * SPLIT_WARPS * k + SPLIT_WARPS);
}

// Launches the split kernel over (b, S) and, with S > 1, the merge; part_d
// and part_s are the (b, S, k) scratch (unused with S == 1). The 4-wide path
// needs d % 4 == 0 and every segment base aligned to 4 floats, as the
// one-warp-per-query launch decides. Returns the CUDA error.
template <bool TWO_SEG>
cudaError_t launch_split(const float* data, const float* delta, const int* ids,
                         const float* queries, const float* weights, float* out_d, int* out_i,
                         float* part_d, int* part_s, int n_main, int n_tot, int d, int b, int P,
                         int k, int S, cudaStream_t s) {
  if (S < 1 || S > 65535 || (S > 1 && (part_d == nullptr || part_s == nullptr)))
    return cudaErrorInvalidValue;
  const int groups = (P + 31) / 32;
  const int slots_per_split = ((groups + S - 1) / S) * 32;
  const size_t smem = split_smem_bytes(d, k);
  const dim3 grid(b, S);
  float* dst_d = S == 1 ? out_d : part_d;
  int* dst_i = S == 1 ? out_i : part_s;
  cudaError_t err;
  if (d % 4 == 0 && aligned4(data) && (!TWO_SEG || aligned4(delta))) {
    err = cudaFuncSetAttribute(gather_rerank_split_kernel<true, TWO_SEG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gather_rerank_split_kernel<true, TWO_SEG><<<grid, SPLIT_WARPS * 32, smem, s>>>(
        data, delta, ids, queries, weights, dst_d, dst_i, n_main, n_tot, d, P, k,
        slots_per_split);
  } else {
    err = cudaFuncSetAttribute(gather_rerank_split_kernel<false, TWO_SEG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gather_rerank_split_kernel<false, TWO_SEG><<<grid, SPLIT_WARPS * 32, smem, s>>>(
        data, delta, ids, queries, weights, dst_d, dst_i, n_main, n_tot, d, P, k,
        slots_per_split);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  const size_t msmem = sizeof(int) * (size_t)MERGE_WARPS * S;
  err = cudaFuncSetAttribute(gather_rerank_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)msmem);
  if (err != cudaSuccess) return err;
  gather_rerank_merge_kernel<<<(b + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, msmem, s>>>(
      part_d, part_s, ids, out_d, out_i, b, P, k, S);
  return cudaGetLastError();
}

}  // namespace gather_rerank

// data (n, d) f32, ids (b, P) int32, queries/weights (b, d) f32 ->
// out_d (b, k) f32, out_i (b, k) int32, in S slot splits (part_d/part_s:
// (b, S, k) f32/int32 scratch, NULL when S == 1); all contiguous on the
// current device. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int gather_rerank_launch(const float* data, const int* ids, const float* queries,
                                    const float* weights, float* out_d, int* out_i,
                                    float* part_d, int* part_s, int n, int d, int b, int P, int k,
                                    int S, void* stream) {
  return (int)gather_rerank::launch_split<false>(data, nullptr, ids, queries, weights, out_d,
                                                 out_i, part_d, part_s, n, n, d, b, P, k, S,
                                                 static_cast<cudaStream_t>(stream));
}

// The two-segment form: data (n_main, d) and delta (cap, d) f32; ids
// address [data; delta] (>= n_main + cap or < 0: invalid). The rest as above.
extern "C" int gather_rerank2_launch(const float* data, const float* delta, const int* ids,
                                     const float* queries, const float* weights, float* out_d,
                                     int* out_i, float* part_d, int* part_s, int n_main, int cap,
                                     int d, int b, int P, int k, int S, void* stream) {
  return (int)gather_rerank::launch_split<true>(data, delta, ids, queries, weights, out_d, out_i,
                                                part_d, part_s, n_main, n_main + cap, d, b, P, k,
                                                S, static_cast<cudaStream_t>(stream));
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
