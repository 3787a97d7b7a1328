// Exact streaming k-NN scan for Hopper: the k smallest d_w^l1 distances of
// every query over all n rows, without writing the (b, n) distance matrix.
//
// Replaces the TPU kernel src/repro/kernels/wl1_topk.py
// (wl1_scan_topk_pallas -> _scan_topk_kernel + _merge_topk). On the TPU the
// grid runs in order and carries each query block's top-k across data
// blocks in VMEM. Blocks on this card run in parallel and in no order, so
// the scan is two hand-written launches:
//   1. wl1_scan_partial: the grid is (query tiles of 64) x (S row splits);
//      S is chosen so that about four blocks per SM exist even for b = 64.
//      A block streams its split's rows through shared memory in tiles of
//      256 rows x 32 coordinates and writes a sorted partial top-k per
//      query and split;
//   2. wl1_scan_merge: one warp per query merges its S partial lists into
//      the final k. Ties go to the lower id: splits are visited in row
//      order, each list is ordered by (dist, id), and insertion is stable.
//
// What bounds it on this card: the arithmetic. Each (query, row,
// coordinate) term is a subtract and an |.|-multiply-add (3 flops, two
// FP32 instructions), b*n*d terms in all, against n*d*4 bytes of rows that
// are read once per query tile. Design against that:
//   * a register tile of 8 queries x 8 rows per thread (64 accumulators),
//     so each coordinate step loads 8 + 8 + 8 values from shared memory for
//     128 FP32 instructions;
//   * a warp shares its 8 queries (q and w are float4 broadcasts, the
//     query tile is stored with a padded stride of 68 words) and lane l owns
//     rows l, l+32, ..., l+224 of the row-major staged tile (stride 33
//     words), which makes both the row reads and the staging stores free
//     of bank conflicts;
//   * after the tile's last coordinate each warp holds all 256 distances of
//     its 8 queries in registers and offers them, in row order, to the
//     query's running top-k in shared memory (warp_topk.cuh); a candidate
//     above the current k-th distance costs one ballot.
// Each distance is a sequential f32 sum over the coordinates.

#include <cuda_runtime.h>

#include "warp_topk.cuh"

namespace {

constexpr int BQ = 64;       // queries per block (8 per warp)
constexpr int BR = 256;      // rows per tile (8 per lane)
constexpr int DK = 32;       // coordinates per staged chunk
constexpr int THREADS = 256;
constexpr int QS = BQ + 4;   // padded stride of the transposed q/w tiles
constexpr int RS = DK + 1;   // padded stride of the row-major row tile

__global__ void __launch_bounds__(THREADS, 2)
    wl1_scan_partial(const float* __restrict__ data, const float* __restrict__ queries,
                     const float* __restrict__ weights, float* __restrict__ part_d,
                     int* __restrict__ part_i, int n, int d, int b, int k, int rows_per_split,
                     int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // DK * QS
  float* ws = qs + DK * QS;                        // DK * QS
  float* rs = ws + DK * QS;                        // BR * RS
  float* td = rs + BR * RS;                        // BQ * k
  int* ti = reinterpret_cast<int*>(td + BQ * k);   // BQ * k

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int rb = split * rows_per_split;
  const int re = min(n, rb + rows_per_split);

  for (int i = 0; i < 8; ++i) warp_topk_init(td + (warp * 8 + i) * k, ti + (warp * 8 + i) * k, k, lane);
  float worst[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) worst[i] = CUDART_INF_F;

  for (int row0 = rb; row0 < re; row0 += BR) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < d; c0 += DK) {
      __syncthreads();
      for (int idx = tid; idx < BQ * DK; idx += THREADS) {
        const int qq = idx / DK;
        const int kk = idx - qq * DK;
        const int qrow = q0 + qq;
        const int col = c0 + kk;
        const bool ok = qrow < b && col < d;  // padding: w = 0 adds exactly 0
        qs[kk * QS + qq] = ok ? queries[(size_t)qrow * d + col] : 0.f;
        ws[kk * QS + qq] = ok ? weights[(size_t)qrow * d + col] : 0.f;
      }
      for (int idx = tid; idx < BR * DK; idx += THREADS) {
        const int r = idx / DK;
        const int kk = idx - r * DK;
        const int row = row0 + r;
        const int col = c0 + kk;
        rs[r * RS + kk] = (row < re && col < d) ? data[(size_t)row * d + col] : 0.f;
      }
      __syncthreads();

      const int kmax = min(DK, d - c0);
      for (int kk = 0; kk < kmax; ++kk) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + kk * QS + warp * 8);
        const float4* w4 = reinterpret_cast<const float4*>(ws + kk * QS + warp * 8);
        const float4 qa = q4[0], qb = q4[1], wa = w4[0], wb = w4[1];
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
        const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        float xv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) xv[j] = rs[(lane + 32 * j) * RS + kk];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], fabsf(xv[j] - qv[i]), acc[i][j]);
      }
    }

    // offer the tile's distances to each of the warp's 8 queries, row order
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qq = warp * 8 + i;
      if (q0 + qq >= b) continue;  // warp-uniform
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = row0 + lane + 32 * j;
        worst[i] = warp_topk_offer(td + qq * k, ti + qq * k, k, worst[i], acc[i][j], row,
                                   row < re, lane);
      }
    }
  }

  for (int i = 0; i < 8; ++i) {
    const int qq = warp * 8 + i;
    if (q0 + qq >= b) continue;
    const size_t base = ((size_t)(q0 + qq) * S + split) * k;
    for (int j = lane; j < k; j += 32) {
      part_d[base + j] = td[qq * k + j];
      part_i[base + j] = ti[qq * k + j];
    }
  }
}

constexpr int MWARPS = 4;

__global__ void __launch_bounds__(MWARPS * 32)
    wl1_scan_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
                   float* __restrict__ out_d, int* __restrict__ out_i, int b, int k, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * MWARPS + warp;
  float* td = reinterpret_cast<float*>(smem_raw) + warp * k;
  int* ti = reinterpret_cast<int*>(reinterpret_cast<float*>(smem_raw) + MWARPS * k) + warp * k;
  if (qi >= b) return;
  warp_topk_init(td, ti, k, lane);
  float worst = CUDART_INF_F;
  const int m = S * k;
  const float* pd = part_d + (size_t)qi * m;
  const int* pi = part_i + (size_t)qi * m;
  for (int c = 0; c < m; c += 32) {
    const bool ok = c + lane < m;
    const float dv = ok ? pd[c + lane] : CUDART_INF_F;
    const int id = ok ? pi[c + lane] : -1;
    worst = warp_topk_offer(td, ti, k, worst, dv, id, ok && id >= 0, lane);
  }
  for (int j = lane; j < k; j += 32) {
    out_d[(size_t)qi * k + j] = td[j];
    out_i[(size_t)qi * k + j] = ti[j];
  }
}

}  // namespace

// Number of row splits the scan uses for (n, b): about four blocks per SM
// of a 132-SM card, and never more splits than 256-row tiles.
extern "C" int wl1_scan_splits(int n, int b) {
  const int qtiles = (b + BQ - 1) / BQ;
  const int tiles = (n + BR - 1) / BR;
  int S = (4 * 132 + qtiles - 1) / qtiles;
  if (S > tiles) S = tiles;
  return S < 1 ? 1 : S;
}

// data (n, d), queries/weights (b, d) f32 -> out_d (b, k) f32, out_i (b, k)
// int32, with part_d/part_i (b, S, k) scratch from wl1_scan_splits; all
// contiguous on the current device. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int wl1_scan_topk_launch(const float* data, const float* queries, const float* weights,
                                    float* part_d, int* part_i, float* out_d, int* out_i, int n,
                                    int d, int b, int k, int S, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + BR - 1) / BR;
  const int rows_per_split = ((tiles + S - 1) / S) * BR;
  const size_t smem1 = sizeof(float) * ((size_t)2 * DK * QS + (size_t)BR * RS + (size_t)2 * BQ * k);
  cudaError_t err =
      cudaFuncSetAttribute(wl1_scan_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  wl1_scan_partial<<<dim3((b + BQ - 1) / BQ, S), THREADS, smem1, s>>>(
      data, queries, weights, part_d, part_i, n, d, b, k, rows_per_split, S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem2 = sizeof(float) * (size_t)2 * MWARPS * k;
  err = cudaFuncSetAttribute(wl1_scan_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  wl1_scan_merge<<<(b + MWARPS - 1) / MWARPS, MWARPS * 32, smem2, s>>>(part_d, part_i, out_d, out_i,
                                                                       b, k, S);
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
