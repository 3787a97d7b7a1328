// The chunk staging of the two scans, shared by wl1_topk.cu
// (wl1_scan_partial) and wl1_distance.cu (wl1_scan_kernel), and the tile
// geometry it stages for.
//
// A block of THREADS threads owns BQ queries and walks BR-row tiles; each
// thread keeps an 8 x 8 register tile (8 queries of its warp x rows lane,
// lane+32, ..., lane+224). A tile's coordinates are staged DK at a time into
// one slot of a ring of STAGES: q and w transposed with padded stride QS (so
// a warp's 8 queries are two float4 broadcasts), the rows row-major with
// padded stride RS (so lanes read distinct banks). The ring walk and the
// coordinate step stay in each kernel: sharing the walk, or calling one
// step function from both, made wl1_scan_partial slower (PERF.md §6). Both
// steps are one sequential fmaf(w, |x - q|, acc) per coordinate, so the two
// scans' distances are equal bit for bit.
//
// Everything here is in the unnamed namespace (internal linkage), so the
// two libraries never share a definition (ROADMAP Queue C item 4); each
// source's own unnamed namespace is the same one.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int BQ = 64;       // queries per block (8 per warp)
constexpr int BR = 256;      // rows per tile (8 per lane)
constexpr int DK = 16;       // coordinates per staged chunk
constexpr int THREADS = 256;
constexpr int STAGES = 3;    // ring of staged chunks
constexpr int QS = BQ + 4;   // padded stride of the transposed q/w tiles
constexpr int RS = DK + 1;   // padded stride of the row-major row tile
constexpr int STAGE_FLOATS = 2 * DK * QS + BR * RS;

// Issues the cp.async copies of one chunk: this thread's coordinate
// (tid % DK) of 4 queries (q and w, stored transposed) and of 16 rows of
// the tile, 16 apart from its first (tid / DK). q, w and x point at its
// first query's and row's element of the chunk; nq and nr count the valid
// queries and rows from there on; out-of-range elements are zero-filled
// (w = 0 adds exactly 0) and read nothing (src is then `any`).
__device__ __forceinline__ void stage_chunk(float* st, const float* q, const float* w,
                                            const float* x, const float* any, int nq, int nr,
                                            bool col_ok, int d, int tid) {
  constexpr int SPAN = THREADS / DK;  // rows (or queries) between a thread's copies
  float* qs = st;
  float* ws = qs + DK * QS;
  float* rs = ws + DK * QS;
  const int kk = tid % DK;
  const int r = tid / DK;
  const size_t step = (size_t)SPAN * d;
#pragma unroll
  for (int u = 0; u < BQ / SPAN; ++u) {
    const bool ok = col_ok && u * SPAN < nq;
    cp_async4(qs + kk * QS + r + u * SPAN, ok ? q + u * step : any, ok);
    cp_async4(ws + kk * QS + r + u * SPAN, ok ? w + u * step : any, ok);
  }
#pragma unroll
  for (int u = 0; u < BR / SPAN; ++u) {
    const bool ok = col_ok && u * SPAN < nr;
    cp_async4(rs + (r + u * SPAN) * RS + kk, ok ? x + u * step : any, ok);
  }
}

}  // namespace
