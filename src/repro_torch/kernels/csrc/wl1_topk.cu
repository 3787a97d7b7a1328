// Exact streaming k-NN scan for Hopper: the k smallest d_w^l1 distances of
// every query over all n rows, without writing the (b, n) distance matrix.
//
// Replaces the TPU kernel src/repro/kernels/wl1_topk.py
// (wl1_scan_topk_pallas -> _scan_topk_kernel + _merge_topk). On the TPU the
// grid runs in order and carries each query block's top-k across data
// blocks in VMEM. Blocks on this card run in parallel and in no order, so
// the scan is two hand-written launches:
//   1. wl1_scan_partial: the grid is (query tiles of 64) x (S row splits),
//      S from the host (repro_torch.kernels.wl1_topk.scan_splits): one wave
//      of two blocks per SM, each split a run of whole 256-row tiles. A
//      block streams its split's rows and keeps, per query, the k smallest
//      (dist, id) of the split, sorted;
//   2. wl1_scan_merge (only when S > 1): one block per query copies its S
//      sorted lists to shared memory and one warp merges them
//      (warp_merge_lists) into the final k.
// The key (dist, id) is a total order, so the answer is the k smallest
// (dist, id) over all rows: the first k of wl1_scan's distances under a
// stable sort, ties to the lower id. NaN distances never enter; (+inf, -1)
// fills the slots past the last real entry.
//
// What bounds it on this card: the arithmetic. Each (query, row,
// coordinate) term is a subtract and an |.|-multiply-add (3 flops, two
// FP32 instructions), b*n*d terms in all, against n*d*4 bytes of rows that
// are read once per query tile. Design against that:
//   * a register tile of 8 queries x 8 rows per thread (64 accumulators),
//     so each coordinate step loads 8 + 8 + 8 values from shared memory for
//     128 FP32 instructions (the tiling of wl1_distance.cu's scan, with
//     the chunk staging of wl1_tile.cuh, so the distances are bit for bit
//     wl1_scan's: each a sequential fmaf over the coordinates 0..d-1);
//   * a warp shares its 8 queries (q and w are float4 broadcasts, the
//     query tile is stored with a padded stride of 68 words) and lane l owns
//     rows l, l+32, ..., l+224 of the row-major staged tile (stride 17
//     words), which keeps the row reads free of bank conflicts;
//   * staging is a ring of three 16-coordinate chunks filled with cp.async:
//     two chunks are in flight while one is computed, one barrier a chunk;
//   * selection is a threshold filter, not an insertion per candidate. Each
//     query keeps its list and tau, the list's k-th distance. After a tile,
//     one vote per query finds the queries with a distance under tau (few,
//     past a split's first tile); for those, the rows with dist < tau are
//     appended to the query's 32-entry buffer (a ballot and a popc prefix:
//     one store per survivor). When they do not fit, the k-th smallest of
//     the 32 lanes' minima bounds the tile's own top-k and filters them
//     again; what still does not fit is walked 32 rows at a time. A full
//     buffer, or the end of the split, is folded into the list by one warp:
//     a bitonic sort of the buffer over shuffles, then each entry's rank in
//     buffer + list by binary search, and tau is reset. A row with dist ==
//     tau is dropped rightly: every list entry has a lower id.

#include <climits>

#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "warp_topk.cuh"
#include "wl1_tile.cuh"

namespace {

constexpr int WARPS = THREADS / 32;
constexpr int CAP = 32;          // candidate buffer per query: one entry per lane at a fold
constexpr int EMPTY = INT_MAX;   // id of an empty list entry: after every real (dist, id)
constexpr int MERGE_THREADS = 128;

__device__ __forceinline__ bool key_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

// Bitonic sort of one value per lane, ascending over the warp.
__device__ __forceinline__ void warp_sort32(float& x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(FULL_MASK, x, stride);
      const bool keep_min = ((lane & size) == 0) == ((lane & stride) == 0);
      x = keep_min ? fminf(x, o) : fmaxf(x, o);
    }
  }
}

// Bitonic sort of one (x, xi) per lane, ascending by (x, xi) over the warp.
__device__ __forceinline__ void warp_sort32(float& x, int& xi, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float od = __shfl_xor_sync(FULL_MASK, x, stride);
      const int oi = __shfl_xor_sync(FULL_MASK, xi, stride);
      const bool up = (lane & size) == 0;
      const bool low = (lane & stride) == 0;
      // an ascending pair's lower lane keeps the smaller key
      const bool take = (low == up) ? key_less(od, oi, x, xi) : key_less(x, xi, od, oi);
      if (take) {
        x = od;
        xi = oi;
      }
    }
  }
}

// Folds a query's buffer (bd, bi)[0, cnt) into its sorted list (ld, li)[0, k)
// and returns the list's new k-th distance. Keys are distinct (every row
// enters once), so each entry's rank in buffer + list is its rank within its
// own sorted run plus the count of the other run's smaller keys. (sd, si)
// is the warp's k-entry scratch. Called by every lane of the warp.
__device__ __forceinline__ float fold_buffer(float* ld, int* li, float* bd, int* bi, int cnt,
                                             int k, float* sd, int* si, int lane) {
  float x = CUDART_INF_F;
  int xi = EMPTY;
  if (lane < cnt) {
    x = bd[lane];
    xi = bi[lane];
  }
  warp_sort32(x, xi, lane);
  bd[lane] = x;
  bi[lane] = xi;
  __syncwarp();
  if (lane < cnt) {
    int lo = 0, hi = k;  // list entries below (x, xi)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_less(ld[mid], li[mid], x, xi)) lo = mid + 1;
      else hi = mid;
    }
    if (lane + lo < k) {
      sd[lane + lo] = x;
      si[lane + lo] = xi;
    }
  }
  for (int j = lane; j < k; j += 32) {
    const float e = ld[j];
    const int ei = li[j];
    int lo = 0, hi = cnt;  // buffer entries below (e, ei)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (key_less(bd[mid], bi[mid], e, ei)) lo = mid + 1;
      else hi = mid;
    }
    if (j + lo < k) {
      sd[j + lo] = e;
      si[j + lo] = ei;
    }
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    ld[j] = sd[j];
    li[j] = si[j];
  }
  __syncwarp();
  return sd[k - 1];
}

__global__ void __launch_bounds__(THREADS, 2)
    wl1_scan_partial(const float* __restrict__ data, const float* __restrict__ queries,
                     const float* __restrict__ weights, float* __restrict__ dst_d,
                     int* __restrict__ dst_i, int n, int d, int b, int k, int rows_per_split,
                     int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);  // STAGES * STAGE_FLOATS
  float* ld = ring + STAGES * STAGE_FLOATS;          // BQ * k  sorted lists
  int* li = reinterpret_cast<int*>(ld + BQ * k);     // BQ * k
  float* bd = reinterpret_cast<float*>(li + BQ * k);  // BQ * CAP  candidate buffers
  int* bi = reinterpret_cast<int*>(bd + BQ * CAP);   // BQ * CAP
  float* tq = reinterpret_cast<float*>(bi + BQ * CAP);  // BQ  tau per query
  int* cq = reinterpret_cast<int*>(tq + BQ);         // BQ  buffer fill per query
  float* sd = reinterpret_cast<float*>(cq + BQ);     // WARPS * k  fold scratch
  int* si = reinterpret_cast<int*>(sd + WARPS * k);  // WARPS * k

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * BQ;
  const int split = blockIdx.y;
  const int rb = split * rows_per_split;
  const int re = min(n, rb + rows_per_split);

  for (int e = tid; e < BQ * k; e += THREADS) {
    ld[e] = CUDART_INF_F;
    li[e] = EMPTY;
  }
  if (tid < BQ) {
    tq[tid] = CUDART_INF_F;
    cq[tid] = 0;
  }
  __syncthreads();

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
    if (++slot == STAGES) slot = 0;
    if (++c < nch) continue;
    c = 0;

    // the tile is done: which of the warp's queries have a distance under
    // their tau? (after the first tile of a split, few)
    bool valid[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) valid[j] = row0 + lane + 32 * j < re;
    unsigned pending = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mn = CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (valid[j]) mn = fminf(mn, acc[i][j]);
      if (__any_sync(FULL_MASK, mn < tq[warp * 8 + i]) && q0 + warp * 8 + i < b)
        pending |= 1u << i;
    }
    const unsigned below = (1u << lane) - 1;
    while (pending) {
      const int i = __ffs(pending) - 1;
      pending &= pending - 1;
      const int qq = warp * 8 + i;
      float v[8];  // the query's row of the register tile
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = acc[0][j];
#pragma unroll
      for (int ii = 1; ii < 8; ++ii)
        if (ii == i)
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = acc[ii][j];
      float tau = tq[qq];
      int cnt = cq[qq];
      unsigned m[8];
      int tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m[j] = __ballot_sync(FULL_MASK, valid[j] && v[j] < tau);
        tot += __popc(m[j]);
      }
      if (cnt + tot > CAP && k <= 32) {
        // too many survivors (a split's first tile): the tile's own k
        // smallest are at most the k-th smallest of the 32 lane minima,
        // so filter with that bound too (d <= it, as d < its successor)
        float mn = CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (valid[j] && v[j] < mn) mn = v[j];
        warp_sort32(mn, lane);
        const float tight =
            fminf(tau, nextafterf(__shfl_sync(FULL_MASK, mn, k - 1), CUDART_INF_F));
        tot = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          m[j] = __ballot_sync(FULL_MASK, valid[j] && v[j] < tight);
          tot += __popc(m[j]);
        }
      }
      if (cnt + tot <= CAP) {  // append every survivor: one store each
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (m[j] >> lane & 1u) {
            const int pos = qq * CAP + cnt + __popc(m[j] & below);
            bd[pos] = v[j];
            bi[pos] = row0 + lane + 32 * j;
          }
          cnt += __popc(m[j]);
        }
      } else {  // rare: walk the 32-row groups, folding when the next does not fit
        for (int j = 0; j < 8; ++j) {
          float vj = v[0];
          bool ok = valid[0];
#pragma unroll
          for (int jj = 1; jj < 8; ++jj)
            if (jj == j) {
              vj = v[jj];
              ok = valid[jj];
            }
          unsigned mj = __ballot_sync(FULL_MASK, ok && vj < tau);
          if (cnt + __popc(mj) > CAP) {
            __syncwarp();
            tau = fold_buffer(ld + qq * k, li + qq * k, bd + qq * CAP, bi + qq * CAP, cnt, k,
                              sd + warp * k, si + warp * k, lane);
            cnt = 0;
            mj = __ballot_sync(FULL_MASK, ok && vj < tau);
          }
          if (mj >> lane & 1u) {
            const int pos = qq * CAP + cnt + __popc(mj & below);
            bd[pos] = vj;
            bi[pos] = row0 + lane + 32 * j;
          }
          cnt += __popc(mj);
        }
      }
      __syncwarp();
      if (lane == 0) {
        tq[qq] = tau;
        cq[qq] = cnt;
      }
    }
    __syncwarp();
    row0 += BR;
  }
  cp_async_wait<0>();

  // fold what is left and write each query's list of this split
  for (int i = 0; i < 8; ++i) {
    const int qq = warp * 8 + i;
    if (q0 + qq >= b) continue;  // warp-uniform
    __syncwarp();
    const int cnt = cq[qq];
    if (cnt > 0)
      fold_buffer(ld + qq * k, li + qq * k, bd + qq * CAP, bi + qq * CAP, cnt, k, sd + warp * k,
                  si + warp * k, lane);
    const size_t base = ((size_t)(q0 + qq) * S + split) * k;
    for (int j = lane; j < k; j += 32) {
      const int id = li[qq * k + j];
      dst_d[base + j] = ld[qq * k + j];
      dst_i[base + j] = id == EMPTY ? -1 : id;
    }
  }
}

// One block per query: its S sorted lists are copied to shared memory by
// the whole block and merged by the first warp.
__global__ void __launch_bounds__(MERGE_THREADS)
    wl1_scan_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
                   float* __restrict__ out_d, int* __restrict__ out_i, int k, int S) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = S * k;
  float* md = reinterpret_cast<float*>(smem_raw);  // S * k
  int* mi = reinterpret_cast<int*>(md + m);        // S * k
  int* head = mi + m;                              // S
  const int qi = blockIdx.x;
  const size_t base = (size_t)qi * m;
  for (int e = threadIdx.x; e < m; e += MERGE_THREADS) {
    md[e] = part_d[base + e];
    mi[e] = part_i[base + e];
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  float* od = out_d + (size_t)qi * k;
  int* oi = out_i + (size_t)qi * k;
  warp_merge_lists(md, mi, S, k, head, threadIdx.x, [&](int j, float dv, int id) {
    od[j] = dv;
    oi[j] = id;
  });
}

}  // namespace

// data (n, d), queries/weights (b, d) f32 -> out_d (b, k) f32, out_i (b, k)
// int32, in S row splits (repro_torch.kernels.wl1_topk.scan_splits); with
// S > 1, part_d/part_i are the (b, S, k) scratch of the split lists (NULL
// when S == 1). All contiguous on the current device. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int wl1_scan_topk_launch(const float* data, const float* queries, const float* weights,
                                    float* part_d, int* part_i, float* out_d, int* out_i, int n,
                                    int d, int b, int k, int S, void* stream) {
  if (S < 1 || S > 65535 || (S > 1 && (part_d == nullptr || part_i == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + BR - 1) / BR;
  const int rows_per_split = ((tiles + S - 1) / S) * BR;
  const size_t smem1 = sizeof(float) * ((size_t)STAGES * STAGE_FLOATS + (size_t)2 * BQ * k +
                                        (size_t)2 * BQ * CAP + (size_t)2 * BQ +
                                        (size_t)2 * WARPS * k);
  cudaError_t err = allow_dynamic_smem<wl1_scan_partial>(smem1);
  if (err != cudaSuccess) return (int)err;
  wl1_scan_partial<<<dim3((b + BQ - 1) / BQ, S), THREADS, smem1, s>>>(
      data, queries, weights, S == 1 ? out_d : part_d, S == 1 ? out_i : part_i, n, d, b, k,
      rows_per_split, S);
  err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t smem2 = sizeof(float) * (size_t)2 * S * k + sizeof(int) * (size_t)S;
  err = allow_dynamic_smem<wl1_scan_merge>(smem2);
  if (err != cudaSuccess) return (int)err;
  wl1_scan_merge<<<b, MERGE_THREADS, smem2, s>>>(part_d, part_i, out_d, out_i, k, S);
  return (int)cudaGetLastError();
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
