// Fused probe tail for Hopper: gather each candidate row by id, exact
// weighted-L1 re-rank against the query, running top-k — without ever
// materializing the (b, P, d) candidate tensor.
//
// Replaces the TPU kernel src/repro/kernels/gather_rerank.py
// (gather_rerank_topk_pallas -> _gather_rerank_kernel), single segment,
// f32 rows. The TPU version DMAs one (1, 128) row per grid step through
// scalar prefetch and keeps a 128-lane replace-max buffer that the wrapper
// sorts afterwards.
//
// What bounds it on this card: HBM bytes of the gathered rows (d*4 bytes
// per valid candidate, random rows) and the latency of those dependent
// loads; the arithmetic (3 flops per coordinate) is far below the rate.
// Design:
//   * one warp per query; q and w sit in shared memory;
//   * lanes read a row as float4 (d = 128: one 16-byte load per lane, one
//     512-byte coalesced row per warp), and each lane keeps U = 8 candidate
//     rows in flight before reducing, to cover the gather latency;
//   * the warp reduces by xor-butterfly, so every lane holds the identical
//     distance and the admission test is warp-uniform;
//   * the running top-k is a sorted list in shared memory (warp_topk.cuh):
//     candidates are offered in slot order and inserted stably, so the
//     output is already ascending by (dist, slot) — no sort afterwards;
//   * ids are read 32 at a time; groups with no valid id (>= n or < 0) are
//     skipped, so with the dedupe stage's packing (unique ids first,
//     sentinels last) the row traffic is that of the unique candidates.

#include <cuda_runtime.h>

#include "warp_topk.cuh"

namespace {

constexpr int WARPS = 4;  // queries per block
constexpr int U = 8;      // candidate rows in flight per lane

template <bool VEC4>
__global__ void __launch_bounds__(WARPS * 32)
    gather_rerank_kernel(const float* __restrict__ data, const int* __restrict__ ids,
                         const float* __restrict__ queries, const float* __restrict__ weights,
                         float* __restrict__ out_d, int* __restrict__ out_i, int n, int d, int b,
                         int P, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * WARPS + warp;
  const int dpad = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem_raw) + warp * 2 * dpad;
  float* ws = qs + dpad;
  float* td = reinterpret_cast<float*>(smem_raw) + WARPS * 2 * dpad + warp * k;
  int* ti = reinterpret_cast<int*>(reinterpret_cast<float*>(smem_raw) + WARPS * (2 * dpad + k)) +
            warp * k;
  if (qi >= b) return;  // only warp-level synchronisation below

  for (int j = lane; j < d; j += 32) {
    qs[j] = queries[(size_t)qi * d + j];
    ws[j] = weights[(size_t)qi * d + j];
  }
  warp_topk_init(td, ti, k, lane);  // ends with __syncwarp

  float worst = CUDART_INF_F;
  const int* idrow = ids + (size_t)qi * P;
  for (int c = 0; c < P; c += 32) {
    const int my = (c + lane < P) ? idrow[c + lane] : -1;
    const unsigned mask = __ballot_sync(FULL_MASK, my >= 0 && my < n);
    if (mask == 0) continue;
    const int nv = 32 - __clz(mask);  // one past the last valid slot
    for (int u0 = 0; u0 < nv; u0 += U) {
      int cid[U];
      float part[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = u0 + u;  // < 32: U divides 32
        const int v = __shfl_sync(FULL_MASK, my, src);
        cid[u] = (src < nv && ((mask >> src) & 1u)) ? v : -1;
        part[u] = 0.f;
      }
      if (VEC4) {
        const int d4 = d >> 2;
        const float4* data4 = reinterpret_cast<const float4*>(data);
        const float4* qs4 = reinterpret_cast<const float4*>(qs);
        const float4* ws4 = reinterpret_cast<const float4*>(ws);
        for (int j = lane; j < d4; j += 32) {
          float4 rv[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            rv[u] = cid[u] >= 0 ? __ldg(data4 + (size_t)cid[u] * d4 + j)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 qv = qs4[j];
          const float4 wv = ws4[j];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            float p = part[u];
            p = fmaf(wv.x, fabsf(rv[u].x - qv.x), p);
            p = fmaf(wv.y, fabsf(rv[u].y - qv.y), p);
            p = fmaf(wv.z, fabsf(rv[u].z - qv.z), p);
            p = fmaf(wv.w, fabsf(rv[u].w - qv.w), p);
            part[u] = p;
          }
        }
      } else {
        for (int j = lane; j < d; j += 32) {
          float rv[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            rv[u] = cid[u] >= 0 ? __ldg(data + (size_t)cid[u] * d + j) : 0.f;
          const float qv = qs[j];
          const float wv = ws[j];
#pragma unroll
          for (int u = 0; u < U; ++u) part[u] = fmaf(wv, fabsf(rv[u] - qv), part[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part[u] += __shfl_xor_sync(FULL_MASK, part[u], off);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (cid[u] >= 0 && part[u] < worst)
          worst = warp_topk_insert(td, ti, k, part[u], cid[u], lane);
      }
    }
  }

  for (int j = lane; j < k; j += 32) {
    out_d[(size_t)qi * k + j] = td[j];
    out_i[(size_t)qi * k + j] = ti[j];
  }
}

}  // namespace

// data (n, d) f32, ids (b, P) int32, queries/weights (b, d) f32 ->
// out_d (b, k) f32, out_i (b, k) int32; all contiguous on the current
// device. Returns the CUDA error code of the launch (0 on success).
extern "C" int gather_rerank_launch(const float* data, const int* ids, const float* queries,
                                    const float* weights, float* out_d, int* out_i, int n, int d,
                                    int b, int P, int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int dpad = (d + 3) & ~3;
  const size_t smem = sizeof(float) * (size_t)WARPS * (2 * dpad + 2 * k);
  const dim3 grid((b + WARPS - 1) / WARPS);
  cudaError_t err;
  if (d % 4 == 0 && reinterpret_cast<size_t>(data) % 16 == 0) {
    err = cudaFuncSetAttribute(gather_rerank_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gather_rerank_kernel<true>
        <<<grid, WARPS * 32, smem, s>>>(data, ids, queries, weights, out_d, out_i, n, d, b, P, k);
  } else {
    err = cudaFuncSetAttribute(gather_rerank_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gather_rerank_kernel<false>
        <<<grid, WARPS * 32, smem, s>>>(data, ids, queries, weights, out_d, out_i, n, d, b, P, k);
  }
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
