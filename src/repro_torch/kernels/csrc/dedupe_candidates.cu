// Candidate dedupe for Hopper: (b, P) int32 candidate ids -> each row's
// distinct ids below n in ascending order, then the sentinel n up to width
// P, and the (b,) int32 count of those distinct ids.
//
// Replaces no Pallas kernel. The TPU package dedupes in jnp
// (src/repro/core/index.py _dedupe_candidates): a sort, a first-copy flag
// and a second sort that packs the unique ids ahead of the sentinels, all
// left to XLA. The port's plain version (repro_torch.kernels.ref.
// dedupe_candidates) runs the same two torch.sort passes; on the card each
// reads and writes the whole block and returns an int64 index tensor
// besides. This kernel gives the same output bit for bit: the gather's group
// skip relies on the packing, and its tie break on the slot order.
//
// What bounds it on this card: it reads the b*P ids once and writes the
// b*P packed ids and the b counts once, 8*b*P + 4*b bytes: 262 MB at the
// multiprobe cell's 1,000 x 32,768 slots (78 us at 3.35 TB/s), 328 MB at
// the probe cell's 10,000 x 4,096 (98 us). It does no arithmetic worth
// counting.
//
// The design. One block owns one row at a time, in a persistent loop over
// rows, and sets one bit per valid id in a bitmap of the id range in shared
// memory. Reading the bitmap's words in order gives the distinct ids
// ascending, with no sort, and duplicates cost nothing. A million ids take
// 125,000 bytes, within a block's 227 KB; a larger range (a mutable index's
// n + cap, a larger table) is cut into tiles of up to MAX_SUMMARY * 1,024
// ids, and each tile reads the row again (from L2 at these row sizes).
//
// The marking reads the row as 4-id groups (16-byte loads where the row is
// aligned), neighbouring lanes on neighbouring groups, two groups a thread
// in flight and the next row's first groups loaded during the walk. A table
// window's ids ascend (the build's argsort is stable), so a thread's
// consecutive ids often share a bitmap word: it ORs their bits in registers
// and issues one shared-memory atomic per word, not one per id. The first
// setter of a word (the atomicOr returns 0) sets the word's bit in a summary
// bitmap of one bit per bitmap word.
//
// The walk costs per id and not per bit of the range. Measured at the
// sift1m cells, a probe row holds 3,382 ids in 288 nonzero words under 88
// summary words, a multiprobe row 19,646 ids in 1,509 words under 359: the
// ids crowd into dense runs (a cluster's near-duplicate rows have
// neighbouring ids). So the walk, for each round of up to THREADS summary
// words: a thread per summary word lists its nonzero words in order (a
// block scan of the summary words' popcounts gives each its first slot in
// the list); a thread per run of consecutive listed words counts their ids,
// and a block scan turns the counts into output slots; each thread writes
// its words' ids into a stage of STAGE slots in shared memory, which the
// block copies out in 16-byte stores, and zeroes its words, so the bitmaps
// are clean for the next row with no pass of their own. The tail [count, P)
// is filled with n the same way.
//
// What the chip showed against simpler walks (SM cycles of a row's walk,
// probe / multiprobe): a thread per summary word writing its own ids
// straight to device memory, 35,500 / 63,500 (a thread's ids are many, and
// its 4-byte stores are scattered); a warp per summary word, a lane per
// bitmap word, 19,000 / 77,000 (most summary words hold 3 or 4 nonzero
// words, so most lanes idle); this walk, 10,900 / 33,300. The marking takes
// 1,900 / 12,300, the latter the row's read at the card's bandwidth. With
// one such block an SM the walk's chain of block-wide steps sets the pace
// of short rows: 525 us a probe-b10k block, 18.6% of its bound, against
// 200 us (39%) a multiprobe block.
//
// Bank conflicts: bitmap word w is stored at w ^ ((w >> 5) & 31), so the
// lanes of a warp, which list the words of 32 consecutive summary words,
// read 32 banks.
//
// Ids are read as unsigned: a negative id, like one >= n, is invalid and
// dropped (no path of the port emits a negative id).

#include <cstdint>

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = 2;          // 4-id groups a thread has in flight while marking
constexpr int IDS = 4 * GROUPS;    // ids a thread marks a step
constexpr int IDS_PER_SUMMARY = 1024;  // ids under one summary word (32 bitmap words)
constexpr int MAX_SUMMARY = 1384;  // summary words of a tile: 1,417,216 ids
constexpr int SCRATCH = 64;        // ints of the block scan (33)
constexpr int LIST = 4096;         // nonzero bitmap words a walk lists at a time
constexpr int STAGE = 8192;        // output slots staged in shared memory
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;  // no bitmap word

static_assert(WARPS <= 32, "the block scan folds one total per warp in one warp");

constexpr size_t smem_bytes(int summary) {
  return sizeof(int) * (SCRATCH + LIST + STAGE + static_cast<size_t>(summary) * 33);
}

// The cut of the id range [0, n) into tiles of equal width, each at most
// MAX_SUMMARY summary words; no tile for n = 0.
struct Plan {
  int tiles, summary_words;
};

Plan plan_tiles(int n) {
  const long long words = (static_cast<long long>(n) + IDS_PER_SUMMARY - 1) / IDS_PER_SUMMARY;
  const long long tiles = (words + MAX_SUMMARY - 1) / MAX_SUMMARY;
  return {static_cast<int>(tiles), tiles ? static_cast<int>((words + tiles - 1) / tiles) : 0};
}

__device__ __forceinline__ int swizzle(int w) { return w ^ ((w >> 5) & 31); }

// The ids of 4-id group g of a row of P slots (-1 past the end).
template <bool VEC>
__device__ __forceinline__ void load_group(const int* __restrict__ row, int P, int g, int* v) {
  if (VEC) {
    int4 q = make_int4(-1, -1, -1, -1);
    if (4 * g < P) q = __ldg(reinterpret_cast<const int4*>(row) + g);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = 4 * g + j < P ? __ldg(row + 4 * g + j) : -1;
  }
}

// The step of this thread whose first group is g0 + threadIdx.x.
template <bool VEC>
__device__ __forceinline__ void load_step(const int* __restrict__ row, int P, int g0, int* v) {
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) load_group<VEC>(row, P, g0 + threadIdx.x + k * THREADS, v + 4 * k);
}

// Sets the bits of word w in the bitmap, and w's summary bit when the word
// was empty.
__device__ __forceinline__ void set_word(unsigned* bm, unsigned* summary, unsigned w,
                                         unsigned bits) {
  const unsigned old = atomicOr(bm + swizzle(static_cast<int>(w)), bits);
  if (old == 0u) atomicOr(summary + (w >> 5), 1u << (w & 31));
}

// Marks a step's ids that fall in the tile [lo, lo + span) and below n.
__device__ __forceinline__ void mark(const int* v, unsigned n, unsigned lo, unsigned span,
                                     unsigned* bm, unsigned* summary) {
  unsigned word = NONE, bits = 0u;
#pragma unroll
  for (int j = 0; j < IDS; ++j) {
    const unsigned id = static_cast<unsigned>(v[j]);
    const unsigned r = id - lo;
    if (id < n && r < span) {
      if ((r >> 5) != word) {
        if (word != NONE) set_word(bm, summary, word, bits);
        word = r >> 5;
        bits = 0u;
      }
      bits |= 1u << (r & 31);
    }
  }
  if (word != NONE) set_word(bm, summary, word, bits);
}

// Exclusive prefix sum of x over the block, where only the first ``active``
// threads may hold a nonzero x (the warps past them skip the warp scan);
// ``total`` gets the block's sum. Leaves ``scratch`` to be read: the caller
// syncs before its next use.
__device__ __forceinline__ int block_exclusive_scan(int x, int active, int& total, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  if (32 * warp < active) {
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += y;
    }
  }
  if (lane == 31) scratch[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < WARPS ? scratch[lane] : 0;
    int sum = t;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, sum, off);
      if (lane >= off) sum += y;
    }
    scratch[lane] = sum - t;
    if (lane == 31) scratch[32] = sum;
  }
  __syncthreads();
  total = scratch[32];
  return scratch[warp] + inc - x;
}

// Copies output slots [a0, a1) of a row from the stage, which holds the
// slots from c0 on (c0 a multiple of 4), in 16-byte stores where VEC.
template <bool VEC>
__device__ __forceinline__ void copy_out(int* __restrict__ out, const int* stage, int c0, int a0,
                                         int a1) {
  int v0 = a0, v1 = a0;
  if (VEC) {
    v0 = min((a0 + 3) & ~3, a1);
    v1 = max(a1 & ~3, v0);
    for (int i = threadIdx.x; i < (v1 - v0) / 4; i += THREADS)
      reinterpret_cast<int4*>(out + v0)[i] = reinterpret_cast<const int4*>(stage + (v0 - c0))[i];
  }
  const int head = v0 - a0;
  for (int i = threadIdx.x; i < head + (a1 - v1); i += THREADS) {
    const int p = i < head ? a0 + i : v1 + (i - head);
    out[p] = stage[p - c0];
  }
}

// Fills output slots [a0, a1) of a row with x, in 16-byte stores where VEC.
template <bool VEC>
__device__ __forceinline__ void fill(int* __restrict__ out, int a0, int a1, int x) {
  int v0 = a0, v1 = a0;
  if (VEC) {
    v0 = min((a0 + 3) & ~3, a1);
    v1 = max(a1 & ~3, v0);
    for (int i = threadIdx.x; i < (v1 - v0) / 4; i += THREADS)
      reinterpret_cast<int4*>(out + v0)[i] = make_int4(x, x, x, x);
  }
  const int head = v0 - a0;
  for (int i = threadIdx.x; i < head + (a1 - v1); i += THREADS)
    out[i < head ? a0 + i : v1 + (i - head)] = x;
}

// Writes the tile's ids (ids lo + 32 * w + bit) to out from slot ``base``
// on, ascending; zeroes the bitmaps, and returns base plus their count.
template <bool VEC>
__device__ __forceinline__ int walk(int* __restrict__ out, int base, unsigned lo, int summary_words,
                                    unsigned* bm, unsigned* summary, int* scratch, int* list,
                                    int* stage) {
  for (int s0 = 0; s0 < summary_words; s0 += THREADS) {
    // a thread per summary word: the slots of its nonzero words in the list
    const int sw = s0 + static_cast<int>(threadIdx.x);
    const unsigned sm = sw < summary_words ? summary[sw] : 0u;
    if (sm) summary[sw] = 0u;  // read once; zeroed before the syncs that end the walk
    int words;
    int slot = block_exclusive_scan(__popc(sm), THREADS, words, scratch);
    unsigned m = sm;
    for (int c0 = 0; c0 < words; c0 += LIST) {
      for (; m && slot < c0 + LIST; m &= m - 1, ++slot) list[slot - c0] = 32 * sw + __ffs(m) - 1;
      __syncthreads();
      // a thread per run of listed words: their ids, then their first slot
      const int len = min(LIST, words - c0);
      const int per = (len + THREADS - 1) / THREADS;
      const int e0 = min(static_cast<int>(threadIdx.x) * per, len), e1 = min(e0 + per, len);
      int ids = 0;
      for (int e = e0; e < e1; ++e) ids += __popc(bm[swizzle(list[e])]);
      int total;
      const int first =
          base + block_exclusive_scan(ids, (len + per - 1) / per, total, scratch);
      const int end = base + total;
      // the ids into the stage, STAGE slots at a time, copied out in order
      for (int a = base - base % STAGE; a < end; a += STAGE) {
        int pos = first;
        for (int e = e0; e < e1 && pos < a + STAGE; ++e) {
          unsigned bits = bm[swizzle(list[e])];
          const int c = __popc(bits);
          if (pos + c > a) {
            const int id0 = static_cast<int>(lo) + 32 * list[e];
            for (int q = pos; bits; bits &= bits - 1, ++q)
              if (q >= a && q < a + STAGE) stage[q - a] = id0 + __ffs(bits) - 1;
          }
          pos += c;
        }
        __syncthreads();
        copy_out<VEC>(out, stage, a, max(a, base), min(a + STAGE, end));
        __syncthreads();
      }
      for (int e = e0; e < e1; ++e) bm[swizzle(list[e])] = 0u;
      base = end;
      __syncthreads();  // the list, before the next window's
    }
  }
  return base;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
dedupe_candidates_kernel(const int* __restrict__ cand, int* __restrict__ out,
                         int* __restrict__ counts, int b, int P, int n, int tiles,
                         int summary_words) {
  extern __shared__ unsigned smem[];
  int* scratch = reinterpret_cast<int*>(smem);
  int* list = scratch + SCRATCH;
  int* stage = list + LIST;
  unsigned* summary = smem + SCRATCH + LIST + STAGE;
  unsigned* bm = summary + summary_words;
  const unsigned span = static_cast<unsigned>(summary_words) * IDS_PER_SUMMARY;
  const int groups = (P + 3) / 4;
  const int stride = GROUPS * THREADS;
  for (int i = threadIdx.x; i < summary_words * 33; i += THREADS) summary[i] = 0u;
  __syncthreads();

  int row = blockIdx.x;
  int next[IDS];  // the first step of the row (and tile) marked next
  if (row < b) load_step<VEC>(cand + static_cast<size_t>(row) * P, P, 0, next);
  for (; row < b; row += gridDim.x) {
    const int* in = cand + static_cast<size_t>(row) * P;
    int* o = out + static_cast<size_t>(row) * P;
    int count = 0;
    for (int t = 0; t < tiles; ++t) {
      const unsigned lo = static_cast<unsigned>(t) * span;
      int cur[IDS];
#pragma unroll
      for (int j = 0; j < IDS; ++j) cur[j] = next[j];
      for (int g0 = 0; g0 < groups; g0 += stride) {
        int ahead[IDS];
        const bool more = g0 + stride < groups;
        if (more) load_step<VEC>(in, P, g0 + stride, ahead);
        mark(cur, static_cast<unsigned>(n), lo, span, bm, summary);
        if (more) {
#pragma unroll
          for (int j = 0; j < IDS; ++j) cur[j] = ahead[j];
        }
      }
      // the next tile's or row's first step, in flight during the walk
      const int next_row = t + 1 < tiles ? row : row + gridDim.x;
      if (next_row < b) load_step<VEC>(cand + static_cast<size_t>(next_row) * P, P, 0, next);
      __syncthreads();
      count = walk<VEC>(o, count, lo, summary_words, bm, summary, scratch, list, stage);
    }
    fill<VEC>(o, count, P, n);
    if (threadIdx.x == 0) counts[row] = count;
  }
}

template <bool VEC>
cudaError_t launch(const int* cand, int* out, int* counts, int b, int P, int n,
                   cudaStream_t stream) {
  const Plan plan = plan_tiles(n);
  const size_t smem = smem_bytes(plan.summary_words);
  cudaError_t err = allow_dynamic_smem<dedupe_candidates_kernel<VEC>>(smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dedupe_candidates_kernel<VEC>,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = b < per_sm * sms ? b : per_sm * sms;
  dedupe_candidates_kernel<VEC><<<grid, THREADS, smem, stream>>>(cand, out, counts, b, P, n,
                                                                 plan.tiles, plan.summary_words);
  return cudaGetLastError();
}

}  // namespace

// cand (b, P) int32 -> out (b, P) int32 packed ids, counts (b,) int32.
// ``vec`` reads the rows as 16-byte groups (P % 4 == 0 and cand 16-byte
// aligned). Returns the CUDA error code of the launch.
extern "C" int dedupe_candidates_launch(const int* cand, int* out, int* counts, int b, int P,
                                        int n, int vec, void* stream) {
  if (b < 0 || P < 0 || n < 0 || P > (1 << 30) ||
      (vec && (P % 4 != 0 || reinterpret_cast<uintptr_t>(cand) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return static_cast<int>(launch<true>(cand, out, counts, b, P, n, s));
  return static_cast<int>(launch<false>(cand, out, counts, b, P, n, s));
}

// The launch's plan for an id range of n: plan[0] tiles, plan[1] summary
// words a tile, plan[2] bytes of dynamic shared memory a block.
extern "C" int dedupe_candidates_plan(int n, int* plan) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = plan_tiles(n);
  plan[0] = p.tiles;
  plan[1] = p.summary_words;
  plan[2] = static_cast<int>(smem_bytes(p.summary_words));
  return static_cast<int>(cudaSuccess);
}

// Message of a CUDA error code returned by the functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
