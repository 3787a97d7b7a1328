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
//     FP32 rate bounds it (b*n*d*3 flops over 67 TFLOP/s), and its floor is
//     the issue of two FP32 instructions a term (a subtract and an
//     |.|-multiply-add). It runs the tiling and staging of wl1_topk.cu's
//     partial kernel: the chunk staging from wl1_tile.cuh, and copies of
//     its ring walk and coordinate step (sharing either made the fused
//     scan slower, PERF.md §6). A block owns 64 queries and a run
//     of whole 256-row tiles (S row splits from the host,
//     wl1_distance.scan_row_splits); each thread keeps an 8 x 8 register
//     tile (8 queries of its warp x rows lane, lane+32, ..., lane+224), so a
//     coordinate step loads 8 + 8 + 8 values from shared memory for 128
//     FP32 instructions (q and w float4 broadcasts from a transposed tile of
//     padded stride 68, rows from a row-major tile of stride 17: no bank
//     conflicts); 16-coordinate chunks are staged by a ring of three filled
//     with cp.async, two in flight while one is computed, one barrier a
//     chunk, across tile boundaries; a full chunk runs unrolled by 8 and
//     only a ragged last one keeps a counted loop. A finished tile is
//     written with one coalesced 128-byte store per (query, row group).
//     Each distance is one sequential fmaf(w, |x - q|, acc) over the
//     coordinates 0..d-1, as in the fused scan: the same bits.
//   * the re-rank reads every point once (b*C*d*4 bytes) for 3 flops per
//     coordinate, so memory bounds it. It is the gathers' row body
//     (gather_rerank.cuh) over contiguous rows: a warp takes 8 rows of one
//     query at a time, lane l holding the 4-coordinate chunks l, l+32, ... of
//     every row (one 16-byte load per row per lane, 8 rows in flight), q and
//     w of its chunks read once into registers, one fmaf chain per row, and
//     reduce_rows sums the 8 rows over the warp with 9 shuffles. A block is
//     8 warps, 64 rows of one query (4 and 16 warps measured no faster).
//     With that VEC4 layout (d % 4 == 0 and a 16-byte aligned base, the
//     gathers' own test) each distance is gather_rerank_topk's over the same
//     row bit for bit; otherwise the SCALAR layout (one coordinate per lane
//     and load) sums in the gathers' SCALAR order.

#include <climits>
#include <type_traits>

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "gather_rerank.cuh"
#include "wl1_tile.cuh"

namespace {

namespace gr = gather_rerank;

constexpr size_t RING_BYTES = sizeof(float) * STAGES * STAGE_FLOATS;

// One coordinate kk of a staged chunk into the thread's register tile (the
// step of wl1_topk.cu's partial kernel).
__device__ __forceinline__ void tile_step(float (&acc)[8][8], const float* qs, const float* ws,
                                          const float* rs, int kk, int warp, int lane) {
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

// Grid (ceil(b / BQ), S): block (x, y) computes queries BQ x .. + 63 against
// rows [y rows_per_split, + rows_per_split) of a whole number of tiles.
__global__ void __launch_bounds__(THREADS, 2)
    wl1_scan_kernel(const float* __restrict__ data, const float* __restrict__ queries,
                    const float* __restrict__ weights, float* __restrict__ out, int n, int d, int b,
                    int rows_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // STAGES * STAGE_FLOATS
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int rb = blockIdx.y * rows_per_split;
  const int re = min(n, rb + rows_per_split);
  const int nch = max(1, (d + DK - 1) / DK);  // chunks per tile (d == 0: one empty chunk)
  const int total = max(0, (re - rb + BR - 1) / BR) * nch;
  // the next chunk to stage: its chunk in the tile, its tile's first row,
  // its ring slot (no divisions in the loop)
  int sc = 0, srow = rb, sslot = 0;
  auto stage_next = [&]() {
    const int col = sc * DK + tid % DK;
    const size_t qoff = (size_t)(q0 + tid / DK) * d + col;
    stage_chunk(ring + sslot * STAGE_FLOATS, queries + qoff, weights + qoff,
                data + (size_t)(srow + tid / DK) * d + col, data, b - q0 - tid / DK,
                re - srow - tid / DK, col < d, d, tid);
    if (++sc == nch) {
      sc = 0;
      srow += BR;
    }
    if (++sslot == STAGES) sslot = 0;
  };
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < total) stage_next();
    cp_async_commit();
  }

  float acc[8][8];
  int c = 0, row0 = rb, slot = 0;  // chunk t: its chunk in the tile, its tile, its slot
  for (int t = 0; t < total; ++t) {
    cp_async_wait<STAGES - 2>();  // chunk t has landed (this thread's copies)
    __syncthreads();              // ... everyone's; and chunk t-1's stage is free
    if (t + STAGES - 1 < total) stage_next();
    cp_async_commit();
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* qs = ring + slot * STAGE_FLOATS;
    const float* ws = qs + DK * QS;
    const float* rs = ws + DK * QS;
    const int kmax = min(DK, d - c * DK);
    if (kmax == DK) {
#pragma unroll 8
      for (int kk = 0; kk < DK; ++kk) tile_step(acc, qs, ws, rs, kk, warp, lane);
    } else {  // ragged d: the padded coordinates are never summed
#pragma unroll 1
      for (int kk = 0; kk < kmax; ++kk) tile_step(acc, qs, ws, rs, kk, warp, lane);
    }
    if (++slot == STAGES) slot = 0;
    if (++c < nch) continue;
    c = 0;
    // the tile is done: one coalesced 128-byte store per (query, row group)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qrow = q0 + warp * 8 + i;
      if (qrow >= b) continue;  // warp-uniform
      float* o = out + (size_t)qrow * n;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = row0 + lane + 32 * j;
        if (row < re) o[row] = acc[i][j];
      }
    }
    row0 += BR;
  }
  cp_async_wait<0>();
}

constexpr int RR_WARPS = 8;                     // re-rank: warps per block
constexpr int RR_ROWS = RR_WARPS * gr::U;       // re-rank: rows per block (8 per warp)

// One coordinate vector of a row: 4 coordinates (VEC4) or 1 (SCALAR).
template <int LAYOUT>
using Vec = std::conditional_t<LAYOUT == gr::VEC4, float4, float>;

template <int LAYOUT>
__device__ __forceinline__ Vec<LAYOUT> load_vec(const float* row, int j) {
  if constexpr (LAYOUT == gr::VEC4) return gr::Stored<float>::load4(row, j);
  else return gr::Stored<float>::load1(row + j);
}

// q or w at vector j, with no alignment needed.
template <int LAYOUT>
__device__ __forceinline__ Vec<LAYOUT> load_coefs(const float* v, int j) {
  if constexpr (LAYOUT == gr::VEC4)
    return make_float4(__ldg(v + 4 * j), __ldg(v + 4 * j + 1), __ldg(v + 4 * j + 2),
                       __ldg(v + 4 * j + 3));
  else return __ldg(v + j);
}

// The gathers' chain step (rerank_group): coordinates in ascending order.
__device__ __forceinline__ float chain(float p, float4 x, float4 q, float4 w) {
  p = fmaf(w.x, fabsf(x.x - q.x), p);
  p = fmaf(w.y, fabsf(x.y - q.y), p);
  p = fmaf(w.z, fabsf(x.z - q.z), p);
  p = fmaf(w.w, fabsf(x.w - q.w), p);
  return p;
}
__device__ __forceinline__ float chain(float p, float x, float q, float w) {
  return fmaf(w, fabsf(x - q), p);
}

// Grid (ceil(C / RR_ROWS), b): warp w of block x re-ranks rows
// RR_ROWS x + 8 w .. + 7 of query blockIdx.y, as rerank_group re-ranks a
// batch of 8 gathered rows. A lane reads q and w of its vectors once.
template <int LAYOUT>
__global__ void __launch_bounds__(RR_WARPS * 32)
    wl1_rerank_kernel(const float* __restrict__ pts, const float* __restrict__ queries,
                      const float* __restrict__ weights, float* __restrict__ out, int C, int d) {
  constexpr int U = gr::U;
  using V = Vec<LAYOUT>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.y;
  const int u0 = blockIdx.x * RR_ROWS + warp * U;
  if (u0 >= C) return;  // warp-uniform; only warp-level synchronisation below
  const int nr = min(U, C - u0);
  const int dv = LAYOUT == gr::VEC4 ? d >> 2 : d;  // vectors per row
  const float* q = queries + (size_t)qi * d;
  const float* w = weights + (size_t)qi * d;
  const float* rows = pts + ((size_t)qi * C + u0) * d;

  float part[U];
#pragma unroll
  for (int u = 0; u < U; ++u) part[u] = 0.f;
  for (int j = lane; j < dv; j += 32) {
    V rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) rv[u] = u < nr ? load_vec<LAYOUT>(rows + (size_t)u * d, j) : V{};
    const V qv = load_coefs<LAYOUT>(q, j);
    const V wv = load_coefs<LAYOUT>(w, j);
#pragma unroll
    for (int u = 0; u < U; ++u) part[u] = chain(part[u], rv[u], qv, wv);
  }
  // lane 4u holds row u's distance (reduce_rows: the butterfly's pairs)
  const float dist = gr::reduce_rows(part, lane);
  const int row = (lane >> 2) & 7;
  if ((lane & 3) == 0 && row < nr) out[(size_t)qi * C + u0 + row] = dist;
}

template <int LAYOUT>
cudaError_t launch_rerank(const float* pts, const float* queries, const float* weights,
                          float* out, int b, int C, int d, cudaStream_t s) {
  const dim3 grid((C + RR_ROWS - 1) / RR_ROWS, b);
  wl1_rerank_kernel<LAYOUT><<<grid, RR_WARPS * 32, 0, s>>>(pts, queries, weights, out, C, d);
  return cudaGetLastError();
}

}  // namespace

// data (n, d), queries/weights (b, d) f32 -> out (b, n) f32, in S row splits
// of whole 256-row tiles (repro_torch.kernels.wl1_distance.scan_row_splits);
// all contiguous on the current device. Returns the CUDA error code of the
// launch.
extern "C" int wl1_scan_launch(const float* data, const float* queries, const float* weights,
                               float* out, int n, int d, int b, int S, void* stream) {
  // the kernel's row arithmetic (a split's end, a tile's last row) stays
  // within int for n up to INT_MAX - 65535 * BR
  if (S < 1 || S > 65535 || n < 0 || n > INT_MAX - 65535 * BR) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_dynamic_smem<wl1_scan_kernel>(RING_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (n + BR - 1) / BR;
  const int rows_per_split = ((tiles + S - 1) / S) * BR;
  const dim3 grid((b + BQ - 1) / BQ, S);
  wl1_scan_kernel<<<grid, THREADS, RING_BYTES, static_cast<cudaStream_t>(stream)>>>(
      data, queries, weights, out, n, d, b, rows_per_split);
  return (int)cudaGetLastError();
}

// pts (b, C, d), queries/weights (b, d) f32 -> out (b, C) f32; all
// contiguous on the current device. VEC4 when d % 4 == 0 and pts is 16-byte
// aligned, else SCALAR. Returns the CUDA error code of the launch.
extern "C" int wl1_rerank_launch(const float* pts, const float* queries, const float* weights,
                                 float* out, int b, int C, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && gr::aligned4(pts))
    return (int)launch_rerank<gr::VEC4>(pts, queries, weights, out, b, C, d, s);
  return (int)launch_rerank<gr::SCALAR>(pts, queries, weights, out, b, C, d, s);
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
