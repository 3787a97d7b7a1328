// The row arithmetic of the fused probe tail for Hopper, and the schedule
// of the quantized-storage kernels (gather_rerank_blocked.cu): gather each
// candidate row by id, decode it in registers, exact weighted-L1 re-rank
// against the query, running top-k — without ever materializing the
// (b, P, d) candidate tensor. The f32 kernels (gather_rerank.cu) run the
// same per-group body (rerank_group) on a schedule of their own.
//
// What bounds it on this card: HBM bytes of the gathered rows (d values of
// the stored width per valid candidate, random rows) and the latency of
// those dependent loads; the arithmetic (3 flops per coordinate) is far
// below the rate. The per-group body:
//   * each lane loads 4 consecutive coordinates of a row at once — a float4
//     for f32 (one 512-byte row per warp load at d = 128), 8 bytes of four
//     bf16 (256-byte rows), a 4-byte char4 of int8 (128-byte rows) — and
//     keeps U = 8 candidate rows in flight before reducing, to cover the
//     gather latency;
//   * decode happens in registers: the stored value is widened to f32
//     exactly (bf16: the bits shifted left by 16; int8: an int-to-float
//     convert) and, with scales, multiplied by the scale with __fmul_rn so
//     the compiler cannot contract it into the following subtraction. The
//     decoded value is therefore the one ``payload.float() * scales`` gives,
//     and the sum that follows runs in the same lane->coordinate mapping and
//     order for every stored type: over a quantized payload the kernel
//     returns bit for bit what the f32 kernels return over the decoded
//     table;
//   * the warp reduces by xor-butterfly, so every lane holds the identical
//     distance and the admission test is warp-uniform. A row's distance
//     depends on the row, the query and the weights only — not on the
//     warp, block or schedule that computes it;
//   * the running top-k is a sorted list in shared memory (warp_topk.cuh):
//     candidates are offered in slot order and inserted stably, so the
//     list is ascending by (dist, slot) — no sort afterwards;
//   * ids are read 32 at a time; groups with no valid id (>= n or < 0) are
//     skipped, so with the dedupe stage's packing (unique ids first,
//     sentinels last) the row traffic is that of the unique candidates.
// The quantized schedule here (gather_rerank_kernel) is one warp per
// query, 4 queries per block, with q, w and the decode scales in shared
// memory. Nothing in the kernels assumes a range of q: the proxy screen
// feeds integer levels (|q| <= 127) as f32 queries.
//
// Two segments (TWO_SEG, a mutable index): ids address the virtual
// [data; delta] table of n_tot = n_main + cap rows, which is never
// concatenated. A candidate's row is data + cid*d when cid < n_main, else
// delta + (cid - n_main)*d; it is valid iff 0 <= cid < n_tot. Everything
// else — the group skip, the rows in flight, the lane->coordinate mapping,
// the decode and the insertion order — is the single-segment body's, so a
// two-segment launch returns bit for bit what the single-segment kernel
// returns over cat([data, delta]). With TWO_SEG false the delta pointer is
// never read and n_main == n_tot.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "warp_topk.cuh"

namespace gather_rerank {

constexpr int WARPS = 4;  // queries per block of the one-warp-per-query schedule
constexpr int U = 8;      // candidate rows in flight per lane

// Loads of stored values, widened to f32 exactly. load4 reads coordinates
// 4j..4j+3 of a row whose base is aligned to 4 values; load1 one value.
template <typename T>
struct Stored;

template <>
struct Stored<float> {
  static __device__ __forceinline__ float4 load4(const float* row, int j) {
    return __ldg(reinterpret_cast<const float4*>(row) + j);
  }
  static __device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
};

template <>
struct Stored<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int j) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + j);  // little-endian pairs
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned>(bits) << 16);
  }
};

template <>
struct Stored<int8_t> {
  static __device__ __forceinline__ float4 load4(const int8_t* row, int j) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(row) + j);
    return make_float4(static_cast<float>(c.x), static_cast<float>(c.y),
                       static_cast<float>(c.z), static_cast<float>(c.w));
  }
  static __device__ __forceinline__ float load1(const int8_t* p) {
    return static_cast<float>(__ldg(reinterpret_cast<const signed char*>(p)));
  }
};

// The row of candidate cid. A delta row is addressed from the main base
// plus a per-launch byte shift, (delta - data) - n_main*d*sizeof(T), so
// choosing the segment is an integer select on the offset, not a choice
// between two pointers. With two segments an empty slot (cid < 0) reads
// main row 0 and its sum is dropped: the row loads are then unconditional
// and all U stay in flight (conditional loads behind the segment select
// compiled to a schedule that kept fewer in flight).
template <typename T, bool TWO_SEG>
__device__ __forceinline__ const T* row_of(const T* data, long long delta_shift, int cid,
                                           int n_main, int d) {
  if (!TWO_SEG) return data + (size_t)cid * d;
  const long long c = cid < 0 ? 0 : cid;
  const long long off = c * d * (long long)sizeof(T) + (c >= n_main ? delta_shift : 0);
  return reinterpret_cast<const T*>(reinterpret_cast<const char*>(data) + off);
}

// Re-ranks one 32-slot group of a query's candidates — slots c..c+31,
// lane l holding the id `my` of slot c+l, `mask` the lanes whose id is
// valid — into the warp's running top-k list (td, ti) and returns the new
// admission threshold. A list entry names the row by its id, or with SLOTS
// by its slot. q, w (and with SCALED the decode scales) are qs, ws, ss.
template <typename T, bool SCALED, bool VEC4, bool TWO_SEG, bool SLOTS>
__device__ __forceinline__ float rerank_group(const T* __restrict__ data, long long delta_shift,
                                              const float* qs, const float* ws, const float* ss,
                                              int my, unsigned mask, int c, int n_main, int d,
                                              float* td, int* ti, int k, float worst, int lane) {
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
      const float4* qs4 = reinterpret_cast<const float4*>(qs);
      const float4* ws4 = reinterpret_cast<const float4*>(ws);
      const float4* ss4 = reinterpret_cast<const float4*>(ss);
      for (int j = lane; j < d4; j += 32) {
        float4 rv[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          rv[u] = (TWO_SEG || cid[u] >= 0)
                      ? Stored<T>::load4(row_of<T, TWO_SEG>(data, delta_shift, cid[u], n_main, d), j)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 qv = qs4[j];
        const float4 wv = ws4[j];
        if (SCALED) {
          const float4 sv = ss4[j];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            rv[u].x = __fmul_rn(rv[u].x, sv.x);
            rv[u].y = __fmul_rn(rv[u].y, sv.y);
            rv[u].z = __fmul_rn(rv[u].z, sv.z);
            rv[u].w = __fmul_rn(rv[u].w, sv.w);
          }
        }
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
          rv[u] = (TWO_SEG || cid[u] >= 0)
                      ? Stored<T>::load1(row_of<T, TWO_SEG>(data, delta_shift, cid[u], n_main, d) + j)
                      : 0.f;
        const float qv = qs[j];
        const float wv = ws[j];
        if (SCALED) {
          const float sv = ss[j];
#pragma unroll
          for (int u = 0; u < U; ++u) rv[u] = __fmul_rn(rv[u], sv);
        }
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
        worst = warp_topk_insert(td, ti, k, part[u], SLOTS ? c + u0 + u : cid[u], lane);
    }
  }
  return worst;
}

template <typename T, bool SCALED, bool VEC4, bool TWO_SEG>
__global__ void __launch_bounds__(WARPS * 32)
    gather_rerank_kernel(const T* __restrict__ data, const T* __restrict__ delta,
                         const float* __restrict__ scales, const int* __restrict__ ids,
                         const float* __restrict__ queries, const float* __restrict__ weights,
                         float* __restrict__ out_d, int* __restrict__ out_i, int n_main,
                         int n_tot, int d, int b, int P, int k) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NV = SCALED ? 3 : 2;  // per-warp vectors: q, w[, scales]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * WARPS + warp;
  const int dpad = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem_raw) + warp * NV * dpad;
  float* ws = qs + dpad;
  float* ss = ws + dpad;  // read only when SCALED
  float* td = reinterpret_cast<float*>(smem_raw) + WARPS * NV * dpad + warp * k;
  int* ti = reinterpret_cast<int*>(reinterpret_cast<float*>(smem_raw) + WARPS * (NV * dpad + k)) +
            warp * k;
  if (qi >= b) return;  // only warp-level synchronisation below
  const long long delta_shift =
      TWO_SEG ? (long long)(reinterpret_cast<uintptr_t>(delta) -
                            reinterpret_cast<uintptr_t>(data)) -
                    (long long)n_main * d * (long long)sizeof(T)
              : 0;

  for (int j = lane; j < d; j += 32) {
    qs[j] = queries[(size_t)qi * d + j];
    ws[j] = weights[(size_t)qi * d + j];
    if (SCALED) ss[j] = scales[j];
  }
  warp_topk_init(td, ti, k, lane);  // ends with __syncwarp

  float worst = CUDART_INF_F;
  const int* idrow = ids + (size_t)qi * P;
  for (int c = 0; c < P; c += 32) {
    const int my = (c + lane < P) ? idrow[c + lane] : -1;
    const unsigned mask = __ballot_sync(FULL_MASK, my >= 0 && my < n_tot);
    if (mask == 0) continue;
    worst = rerank_group<T, SCALED, VEC4, TWO_SEG, false>(data, delta_shift, qs, ws, ss, my, mask,
                                                          c, n_main, d, td, ti, k, worst, lane);
  }

  for (int j = lane; j < k; j += 32) {
    out_d[(size_t)qi * k + j] = td[j];
    out_i[(size_t)qi * k + j] = ti[j];
  }
}

// Dynamic shared memory of one block: WARPS x (NV vectors of dpad + k dists + k ids).
template <bool SCALED>
inline size_t smem_bytes(int d, int k) {
  const int dpad = (d + 3) & ~3;
  return sizeof(float) * (size_t)WARPS * ((SCALED ? 3 : 2) * dpad + 2 * k);
}

template <typename T>
inline bool aligned4(const T* p) {
  return reinterpret_cast<size_t>(p) % (4 * sizeof(T)) == 0;
}

// Launches one instantiation; the 4-wide path needs d % 4 == 0 and every
// segment base aligned to 4 stored values (every row then is). With
// TWO_SEG false, delta is ignored and n_main == n_tot. Returns the CUDA error.
template <typename T, bool SCALED, bool TWO_SEG>
cudaError_t launch(const T* data, const T* delta, const float* scales, const int* ids,
                   const float* queries, const float* weights, float* out_d, int* out_i,
                   int n_main, int n_tot, int d, int b, int P, int k, cudaStream_t s) {
  const size_t smem = smem_bytes<SCALED>(d, k);
  const dim3 grid((b + WARPS - 1) / WARPS);
  cudaError_t err;
  if (d % 4 == 0 && aligned4(data) && (!TWO_SEG || aligned4(delta))) {
    err = cudaFuncSetAttribute(gather_rerank_kernel<T, SCALED, true, TWO_SEG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gather_rerank_kernel<T, SCALED, true, TWO_SEG><<<grid, WARPS * 32, smem, s>>>(
        data, delta, scales, ids, queries, weights, out_d, out_i, n_main, n_tot, d, b, P, k);
  } else {
    err = cudaFuncSetAttribute(gather_rerank_kernel<T, SCALED, false, TWO_SEG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    gather_rerank_kernel<T, SCALED, false, TWO_SEG><<<grid, WARPS * 32, smem, s>>>(
        data, delta, scales, ids, queries, weights, out_d, out_i, n_main, n_tot, d, b, P, k);
  }
  return cudaGetLastError();
}

}  // namespace gather_rerank
