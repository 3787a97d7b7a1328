// Exact weighted-Manhattan distances for Hopper, materialized: the
// brute-force scan (b, n) and the candidate re-rank (b, C).
//
// Replaces the TPU kernels src/repro/kernels/wl1_distance.py:
//   * wl1_scan_pallas -> _scan_kernel: data (n, d) x queries/weights (b, d)
//     -> (b, n). The TPU grid is (8-query blocks, 128-row blocks, 256-coord
//     steps) and sums the coordinate steps into the output block in order;
//     the wrapper pads n to 128, b to 8 and d to 256 and slices afterwards.
//   * wl1_rerank_pallas -> _rerank_kernel: pts (b, C, d) x queries/weights
//     (b, d) -> (b, C), one query and 128 candidates per grid step, C padded
//     to 128 and d to 256.
// Nothing is padded on the host here: ragged n, b, C and d are masked in
// the kernels. Each distance is sum_i w_i |x_i - q_i| with f32 fused
// multiply-adds; weights may be negative.
//
// What bounds them on this card:
//   * the scan does 3 flops per (query, row, coordinate) term against
//     n*d*4 bytes of rows and b*n*4 bytes of output, so at b = 64 the
//     FP32 rate bounds it (b*n*d*3 flops over 67 TFLOP/s). It is the tiling
//     of wl1_topk.cu's partial kernel with the top-k replaced by a store: a
//     block owns 64 queries x 256 rows, stages q/w (transposed, padded
//     stride 68) and the row tile (row-major, padded stride 33) in shared
//     memory 32 coordinates at a time, and each thread keeps an 8 x 8
//     register tile (8 queries of its warp x rows lane, lane+32, ...,
//     lane+224), so a coordinate step costs 24 shared loads for 128 FP32
//     instructions and both the staging stores and the row reads are free
//     of bank conflicts. The output tile is written with one coalesced
//     128-byte store per (query, row group).
//   * the re-rank reads every point once (b*C*d*4 bytes) for 3 flops per
//     coordinate, so memory bounds it. A block serves one query and 64
//     candidates, 8 per warp; each warp walks its candidates' rows 32
//     coordinates at a time (one coalesced 128-byte load per candidate per
//     step, 8 in flight per lane), keeps 8 per-lane partial sums, and
//     reduces them with shuffles. q and w are read through the L1, where
//     every warp of the block finds them.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;       // scan: queries per block (8 per warp)
constexpr int BR = 256;      // scan: rows per block (8 per lane)
constexpr int DK = 32;       // scan: coordinates per staged chunk
constexpr int THREADS = 256;
constexpr int QS = BQ + 4;   // padded stride of the transposed q/w tiles
constexpr int RS = DK + 1;   // padded stride of the row-major row tile

__global__ void __launch_bounds__(THREADS, 2)
    wl1_scan_kernel(const float* __restrict__ data, const float* __restrict__ queries,
                    const float* __restrict__ weights, float* __restrict__ out, int n, int d,
                    int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // DK * QS
  float* ws = qs + DK * QS;                        // DK * QS
  float* rs = ws + DK * QS;                        // BR * RS

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int row0 = blockIdx.y * BR;

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
      const bool ok = qrow < b && col < d;
      qs[kk * QS + qq] = ok ? queries[(size_t)qrow * d + col] : 0.f;
      ws[kk * QS + qq] = ok ? weights[(size_t)qrow * d + col] : 0.f;
    }
    for (int idx = tid; idx < BR * DK; idx += THREADS) {
      const int r = idx / DK;
      const int kk = idx - r * DK;
      const int row = row0 + r;
      const int col = c0 + kk;
      rs[r * RS + kk] = (row < n && col < d) ? data[(size_t)row * d + col] : 0.f;
    }
    __syncthreads();

    const int kmax = min(DK, d - c0);  // ragged d: the padded coordinates are never summed
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qrow = q0 + warp * 8 + i;
    if (qrow >= b) continue;  // warp-uniform
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = row0 + lane + 32 * j;
      if (row < n) out[(size_t)qrow * n + row] = acc[i][j];
    }
  }
}

constexpr int CPW = 8;                        // re-rank: candidates per warp
constexpr int CPB = CPW * (THREADS / 32);     // re-rank: candidates per block

__global__ void __launch_bounds__(THREADS)
    wl1_rerank_kernel(const float* __restrict__ pts, const float* __restrict__ queries,
                      const float* __restrict__ weights, float* __restrict__ out, int C, int d) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.y;
  const int c0 = blockIdx.x * CPB + warp * CPW;
  if (c0 >= C) return;  // warp-uniform
  const float* q = queries + (size_t)qi * d;
  const float* w = weights + (size_t)qi * d;
  const float* p = pts + ((size_t)qi * C + c0) * d;
  const int nc = min(CPW, C - c0);

  float acc[CPW];
#pragma unroll
  for (int j = 0; j < CPW; ++j) acc[j] = 0.f;
  for (int col = lane; col < d; col += 32) {
    const float qv = __ldg(q + col);
    const float wv = __ldg(w + col);
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      if (j < nc) acc[j] = fmaf(wv, fabsf(__ldg(p + (size_t)j * d + col) - qv), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < CPW; ++j) {
    float v = acc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == j && j < nc) out[(size_t)qi * C + c0 + j] = v;
  }
}

}  // namespace

// data (n, d), queries/weights (b, d) f32 -> out (b, n) f32; all contiguous
// on the current device. Returns the CUDA error code of the launch.
extern "C" int wl1_scan_launch(const float* data, const float* queries, const float* weights,
                               float* out, int n, int d, int b, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * DK * QS + (size_t)BR * RS);
  cudaError_t err =
      cudaFuncSetAttribute(wl1_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + BQ - 1) / BQ, (n + BR - 1) / BR);
  wl1_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(data, queries,
                                                                             weights, out, n, d, b);
  return (int)cudaGetLastError();
}

// pts (b, C, d), queries/weights (b, d) f32 -> out (b, C) f32; all
// contiguous on the current device. Returns the CUDA error code of the launch.
extern "C" int wl1_rerank_launch(const float* pts, const float* queries, const float* weights,
                                 float* out, int b, int C, int d, void* stream) {
  const dim3 grid((C + CPB - 1) / CPB, b);
  wl1_rerank_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(pts, queries,
                                                                            weights, out, C, d);
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
