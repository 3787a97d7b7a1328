// The fused probe tail for Hopper, shared by the f32 kernels
// (gather_rerank.cu) and the stored-type kernels (gather_rerank_blocked.cu):
// gather each candidate row by id, decode it in registers, exact weighted-L1
// re-rank against the query, running top-k — without ever materializing the
// (b, P, d) candidate tensor. Both sources instantiate the same per-group
// body (rerank_group) and the same two schedules, templated on the stored
// type T (f32, bf16, int8) and on SCALED (a (d,) decode scale).
//
// What bounds it on this card: by the bound, the HBM bytes of the distinct
// candidate rows at their stored width; in practice, the rows every query
// gathers on its own (served by the L2 where queries share rows) and, for
// narrow rows, the cost of each gathered row rather than its bytes: a
// dependent warp load, its decode and its share of the warp reduction. At
// the service shape one warp load per row held int8, bf16 and f32 rows to
// the same time whatever their width. The per-group body:
//   * the lanes share out a row as the layout says (Layout below): one row
//     per warp load for f32 (a float4 a lane, 512 bytes at d = 128), two
//     rows per warp load for bf16 and int8 (PACKED: 16 or 8 bytes a lane);
//     rows stay in flight before the reduction to cover the gather latency;
//   * decode happens in registers: the stored value is widened to f32
//     exactly (bf16: the bits shifted left by 16; int8: a byte permute and a
//     subtraction, no int-to-float convert) and, with scales, multiplied by
//     the scale with __fmul_rn so the compiler cannot contract it into the
//     following subtraction. The decoded value is therefore the one
//     ``payload.float() * scales`` gives, and every layout sums it in the
//     VEC4 chains and the butterfly's tree: over a stored payload the
//     kernels return bit for bit what the f32 kernels return over the
//     decoded table;
//   * the warp reduces several rows together (reduce_rows, reduce_packed):
//     at the first offsets each lane sends half of its partial sums and
//     keeps the other half — 9 shuffles for 8 VEC4 rows where a butterfly
//     per row takes 40. Every row sees the same pairs added in the same tree
//     as the butterfly, so its distance has the same bits; it depends on the
//     row, the query and the weights only — not on the warp, block, schedule
//     or layout that computes it. A ballot of the rows under the admission
//     threshold picks the few that are broadcast and inserted;
//   * the running top-k is a sorted list in shared memory (warp_topk.cuh):
//     candidates are offered in slot order and inserted stably, so the
//     list is ascending by (dist, slot) — no sort afterwards;
//   * ids are read 32 at a time; groups with no valid id (>= n or < 0) are
//     skipped, so with the dedupe stage's packing (unique ids first,
//     sentinels last) the row traffic is that of the unique candidates.
// Nothing in the kernels assumes a range of q: the proxy screen feeds
// integer levels (|q| <= 127) as f32 queries.
//
// The two schedules:
//   * split (gather_rerank_split_kernel): a block owns one query and one
//     contiguous range of slots (a split) and runs SPLIT_WARPS = 8 warps over
//     it; warp w takes the range's 32-slot groups w, w+8, w+16, ..., so the
//     dedupe stage's packing spreads evenly over the warps; each warp keeps
//     its own sorted (dist, slot) list of k in shared memory; q, w and the
//     scales are staged once per block. At the end warp 0 merges the 8 lists
//     by (dist, slot) (warp_merge_lists); the slot makes the merge exact
//     whatever the interleave. Where b blocks cannot fill the card the host
//     cuts each query's slots S ways (gather_splits in
//     kernels/gather_rerank.py, from b, P, the SM count and the
//     instantiation's blocks per SM). The grid is (b, S) with the query
//     fastest-varying, so the blocks that walk one slot range for
//     neighbouring queries run together and a row that many queries gather
//     comes from HBM about once and from the L2 after that. With S = 1 the
//     block writes the (b, k) answer; with S > 1 it writes its (dist, slot)
//     list to a (b, S, k) scratch and a second launch
//     (gather_rerank_merge_kernel) merges a query's S lists the same way;
//   * one warp per query (gather_rerank_warp_kernel), WARPS = 4 queries per
//     block: for short candidate lists (fewer 32-slot groups than a split
//     block has warps, such as the screen's survivors), where a split
//     block's warps would sit idle. It is also the bit reference of the
//     split schedule (gather_rerank_warp_launch).
// Both return the k smallest (dist, slot) pairs as (dist, id): the same
// bits.
//
// Two segments (TWO_SEG, a mutable index): ids address the virtual
// [data; delta] table of n_tot = n_main + cap rows, which is never
// concatenated. A candidate's row is data + cid*d when cid < n_main, else
// delta + (cid - n_main)*d; it is valid iff 0 <= cid < n_tot. Everything
// else — the group skip, the rows in flight, the layout, the decode and
// the insertion order — is the single-segment body's, so a
// two-segment launch returns bit for bit what the single-segment kernel
// returns over cat([data, delta]). With TWO_SEG false the delta pointer is
// never read and n_main == n_tot.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "warp_topk.cuh"

// Everything here has internal linkage (an unnamed namespace): both sources
// instantiate the same kernels under the same names, and a template's
// function-local static (allow_dynamic_smem's record of the shared-memory
// attribute it set) would otherwise be one object for both libraries, so
// one library could skip setting the attribute of its own kernel.
namespace gather_rerank {
namespace {

constexpr int WARPS = 4;            // queries per block of the one-warp-per-query schedule
constexpr int WARP_MIN_BLOCKS = 4;  // its blocks per SM: up to 128 registers a thread
constexpr int U = 8;                // VEC4/SCALAR rows in flight per lane (reduce_rows takes 8)
constexpr int SPLIT_WARPS = 8;      // warps per block of the split schedule
constexpr int MERGE_WARPS = 4;      // queries per block of the split merge

// How a row's coordinates are dealt to the lanes (chosen per launch from
// the dtype, d and the alignment of the tables):
//   * VEC4: lane l holds the 4-coordinate chunks j = l, l + 32, ... of a row
//     and sums them with one fmaf chain; one warp load moves one row. This
//     is the reference arrangement: a row's distance is, bit for bit, the
//     xor-butterfly over the 32 lanes' chains;
//   * PACKED (bf16 and int8 rows of whole pieces, d <= 128): a lane loads
//     one piece of a row, the C chunks of C consecutive VEC4 lanes ("virtual
//     lanes"; Packing), and keeps one chain per virtual lane; one warp load
//     moves C rows, each over 32 / C lanes. reduce_packed adds the chains in
//     the butterfly's pairs, so the distance has the VEC4 bits;
//   * SCALAR: one coordinate per lane and load, for any d and alignment (it
//     sums in another order than VEC4).
enum Layout { SCALAR = 0, VEC4 = 1, PACKED = 2 };

// Blocks per SM that the split kernel's registers must allow at
// SPLIT_WARPS * 32 threads — its __launch_bounds__ minimum — per stored
// type, decode and layout: 4 (64 registers a thread) where the kernel fits
// them without spilling, 3 (80) for the VEC4 body of a narrow or scaled row,
// whose 8 rows in flight are widened float4s. The host sizes the splits with
// it, asking the library for the launch it would make
// (gather_rerank_split_blocks, gather_rerank_blocked_split_blocks).
template <typename T, bool SCALED, int LAYOUT>
struct SplitBlocks {
  static constexpr int value = LAYOUT == VEC4 && (sizeof(T) < 4 || SCALED) ? 3 : 4;
};

// PACKED: a lane's piece of a row and the rows of a batch. Two chunks a lane
// (not four: 16-byte int8 pieces need 48 registers of q, w and scales) and
// four loads in flight (eight, in every form tried, ran slower) keep the
// kernels within 64 registers.
template <typename T>
struct Packing {
  static constexpr int C = sizeof(T) == 4 ? 1 : 2;  // chunks a lane loads (int8: 8 B, bf16: 16 B)
  static constexpr int WORDS = C * (int)sizeof(T);  // 32-bit words a lane loads
  static constexpr int LOADS = 4;                   // loads in flight per lane
  static constexpr int ROWS = C * LOADS;            // rows of a batch
};

// Loads of stored values, widened to f32 exactly. load4 reads coordinates
// 4j..4j+3 of a row whose base is aligned to 4 values; load1 one value;
// chunk(words, t) widens chunk t of a lane's PACKED piece.
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
  static __device__ __forceinline__ float4 widen(unsigned lo, unsigned hi) {  // little-endian pairs
    return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                       __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u));
  }
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* row, int j) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(row) + j);
    return widen(u.x, u.y);
  }
  static __device__ __forceinline__ float4 chunk(const unsigned* words, int t) {
    return widen(words[2 * t], words[2 * t + 1]);
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p) {
    const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
    return __uint_as_float(static_cast<unsigned>(bits) << 16);
  }
};

// int8 widened without an int-to-float convert (16 a clock per SM on this
// card, an eighth of the FP32 rate): the sign bits flipped make each byte
// v + 128 unsigned; placed under the exponent of 2^23 it is the float
// 2^23 + 128 + v, and subtracting 2^23 + 128 leaves v. Every step is exact,
// so the result has the bits of (float)v for all 256 values.
template <>
struct Stored<int8_t> {
  static __device__ __forceinline__ float byte_at(unsigned biased, unsigned sel) {
    return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
  }
  static __device__ __forceinline__ float4 widen(unsigned word) {
    const unsigned u = word ^ 0x80808080u;
    return make_float4(byte_at(u, 0x7440), byte_at(u, 0x7441), byte_at(u, 0x7442),
                       byte_at(u, 0x7443));
  }
  static __device__ __forceinline__ float4 load4(const int8_t* row, int j) {
    return widen(__ldg(reinterpret_cast<const unsigned*>(row) + j));
  }
  static __device__ __forceinline__ float4 chunk(const unsigned* words, int t) {
    return widen(words[t]);
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

// One exchange of the transposed reduction: the lanes whose `bit` is clear
// keep the first half of x and receive their partner's first half; the
// others keep the second half. y[i] = mine + partner's, for the kept row i.
template <int N>
__device__ __forceinline__ void reduce_half(const float (&x)[2 * N], float (&y)[N], int lane,
                                            int bit) {
  const bool upper = (lane & bit) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = upper ? x[i + N] : x[i];
    const float send = upper ? x[i] : x[i + N];
    y[i] = keep + __shfl_xor_sync(FULL_MASK, send, bit);
  }
}

// The warp sums of U = 8 per-lane partial rows; lane l returns row
// (l >> 2) & 7. The pairs (lane, lane ^ offset) are the butterfly's at every
// offset 16, 8, 4, 2, 1, so each row's sum is the butterfly's bit for bit.
__device__ __forceinline__ float reduce_rows(const float (&part)[U], int lane) {
  float a[4], b[2], c[1];
  reduce_half<4>(part, a, lane, 16);
  reduce_half<2>(a, b, lane, 8);
  reduce_half<1>(b, c, lane, 4);
  float s = c[0];
  s += __shfl_xor_sync(FULL_MASK, s, 2);
  s += __shfl_xor_sync(FULL_MASK, s, 1);
  return s;
}

// PACKED: the distance of the row of one load, from the C = 2 chains p[t]
// of this lane's virtual lanes v = 2m + t (m the lane within its row's 16
// lanes). The butterfly's offsets 16, 8, 4, 2 over v are the lane offsets 8,
// 4, 2, 1 and its offset 1 is t. The first exchange keeps one chain and
// sends the other (the lane keeps t = m >> 3); from then on the lanes hold
// different t, so the t offset is the lane offset 8 again. Every lane of
// the row ends with its distance.
__device__ __forceinline__ float reduce_packed(const float (&p)[2], int lane) {
  float a[1];
  reduce_half<1>(p, a, lane, 8);  // v offset 16
  float s = a[0];
  s += __shfl_xor_sync(FULL_MASK, s, 4);  // v offset 8
  s += __shfl_xor_sync(FULL_MASK, s, 2);  // v offset 4
  s += __shfl_xor_sync(FULL_MASK, s, 1);  // v offset 2
  s += __shfl_xor_sync(FULL_MASK, s, 8);  // v offset 1: t
  return s;
}

// PACKED: q, w (and the scales) of the 4C coordinates a lane loads, in
// registers for the whole kernel (a lane always covers the same bytes of a
// row); a lane past the row's end (d < 128) loads nothing and keeps zeros.
// Empty for the other layouts.
template <typename T, bool SCALED, bool ON>
struct LaneCoefs {
  __device__ __forceinline__ LaneCoefs(const float*, const float*, const float*, int, int) {}
};

template <typename T, bool SCALED>
struct LaneCoefs<T, SCALED, true> {
  static constexpr int N = 4 * Packing<T>::C;
  float q[N], w[N], s[SCALED ? N : 1];
  int piece;  // the lane's piece of a row
  bool live;
  __device__ __forceinline__ LaneCoefs(const float* qs, const float* ws, const float* ss, int d,
                                       int lane) {
    piece = lane % (32 / Packing<T>::C);
    live = piece * N < d;  // d is a multiple of N
#pragma unroll
    for (int e = 0; e < N; ++e) {
      q[e] = live ? qs[piece * N + e] : 0.f;
      w[e] = live ? ws[piece * N + e] : 0.f;
      if (SCALED) s[e] = live ? ss[piece * N + e] : 0.f;
    }
  }
};

// PACKED: the body of rerank_group. Lane l serves row g = l / (32 / C) of
// each load; load i of a batch holds slots u0 + C i + g. Each lane computes
// the row address of its own slot once (row 0 for an invalid one) and the
// loads take it by shuffle, so the segment select of a two-segment table
// costs once per slot, not once per load.
template <typename T, bool SCALED, bool TWO_SEG, bool SLOTS>
__device__ __forceinline__ float rerank_group_packed(const T* __restrict__ data,
                                                     long long delta_shift,
                                                     const LaneCoefs<T, SCALED, true>& cf, int my,
                                                     unsigned mask, int c, int n_main, int d,
                                                     float* td, int* ti, int k, float worst,
                                                     int lane) {
  constexpr int C = Packing<T>::C, L = 32 / C, NL = Packing<T>::LOADS, W = Packing<T>::WORDS;
  const int g = lane / L;
  const int nv = 32 - __clz(mask);
  const unsigned long long own = reinterpret_cast<unsigned long long>(
      row_of<T, TWO_SEG>(data, delta_shift, ((mask >> lane) & 1u) ? my : 0, n_main, d));
  for (int u0 = 0; u0 < nv; u0 += Packing<T>::ROWS) {
    unsigned raw[NL][W];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int src = u0 + C * i + g;  // < 32: ROWS divides 32
      const T* row = reinterpret_cast<const T*>(__shfl_sync(FULL_MASK, own, src));
      const bool load = cf.live && (TWO_SEG || ((mask >> src) & 1u));
      if constexpr (W == 4) {
        const uint4 v = load ? __ldg(reinterpret_cast<const uint4*>(row) + cf.piece)
                             : make_uint4(0u, 0u, 0u, 0u);
        raw[i][0] = v.x, raw[i][1] = v.y, raw[i][2] = v.z, raw[i][3] = v.w;
      } else {
        const uint2 v = load ? __ldg(reinterpret_cast<const uint2*>(row) + cf.piece)
                             : make_uint2(0u, 0u);
        raw[i][0] = v.x, raw[i][1] = v.y;
      }
    }
    float dist[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float p[C];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        float4 x = Stored<T>::chunk(raw[i], t);
        if (SCALED) {
          x.x = __fmul_rn(x.x, cf.s[4 * t]);
          x.y = __fmul_rn(x.y, cf.s[4 * t + 1]);
          x.z = __fmul_rn(x.z, cf.s[4 * t + 2]);
          x.w = __fmul_rn(x.w, cf.s[4 * t + 3]);
        }
        float a = 0.f;
        a = fmaf(cf.w[4 * t], fabsf(x.x - cf.q[4 * t]), a);
        a = fmaf(cf.w[4 * t + 1], fabsf(x.y - cf.q[4 * t + 1]), a);
        a = fmaf(cf.w[4 * t + 2], fabsf(x.z - cf.q[4 * t + 2]), a);
        a = fmaf(cf.w[4 * t + 3], fabsf(x.w - cf.q[4 * t + 3]), a);
        p[t] = a;
      }
      dist[i] = reduce_packed(p, lane);
    }
    // the first lane of each row offers it; slots in order within a load
    // (ballot bits ascend with g) and across loads
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int slot0 = u0 + C * i;
      unsigned admit = __ballot_sync(
          FULL_MASK, lane % L == 0 && ((mask >> (slot0 + g)) & 1u) && dist[i] < worst);
      while (admit) {
        const int src = __ffs(admit) - 1;
        admit &= admit - 1;
        const float dv = __shfl_sync(FULL_MASK, dist[i], src);
        if (dv < worst) {
          const int slot = slot0 + src / L;
          const int id = SLOTS ? c + slot : __shfl_sync(FULL_MASK, my, slot);
          worst = warp_topk_insert(td, ti, k, dv, id, lane);
        }
      }
    }
  }
  return worst;
}

// Re-ranks one 32-slot group of a query's candidates — slots c..c+31,
// lane l holding the id `my` of slot c+l, `mask` the lanes whose id is
// valid — into the warp's running top-k list (td, ti) and returns the new
// admission threshold. A list entry names the row by its id, or with SLOTS
// by its slot. q, w (and with SCALED the decode scales) are qs, ws, ss.
template <typename T, bool SCALED, int LAYOUT, bool TWO_SEG, bool SLOTS>
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
    if (LAYOUT == VEC4) {
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
    // Lane 4u holds row u's distance. Rows under the threshold at the start
    // of the batch are offered in slot order; the threshold only falls, so
    // the test is repeated with the current one (warp-uniform after the
    // broadcast).
    const float dist = reduce_rows(part, lane);
    const int row = (lane >> 2) & 7;
    unsigned admit = __ballot_sync(
        FULL_MASK, (lane & 3) == 0 && ((mask >> (u0 + row)) & 1u) && dist < worst);
    while (admit) {
      const int src = __ffs(admit) - 1;
      admit &= admit - 1;
      const float dv = __shfl_sync(FULL_MASK, dist, src);
      if (dv < worst) {
        const int slot = u0 + (src >> 2);
        const int id = SLOTS ? c + slot : __shfl_sync(FULL_MASK, my, slot);
        worst = warp_topk_insert(td, ti, k, dv, id, lane);
      }
    }
  }
  return worst;
}

template <typename T>
inline bool aligned4(const T* p) {
  return reinterpret_cast<size_t>(p) % (4 * sizeof(T)) == 0;
}

// The layout the inputs allow: PACKED needs a type narrower than f32, d <=
// 128, rows of whole pieces and segment bases aligned to a piece; VEC4
// needs d % 4 == 0 and every segment base aligned to 4 stored values (every
// row then is).
template <typename T, bool TWO_SEG>
inline int layout_of(const T* data, const T* delta, int d) {
  constexpr size_t piece = 4 * Packing<T>::WORDS;
  if (Packing<T>::C > 1 && d <= 128 && (d * sizeof(T)) % piece == 0 &&
      reinterpret_cast<size_t>(data) % piece == 0 &&
      (!TWO_SEG || reinterpret_cast<size_t>(delta) % piece == 0))
    return PACKED;
  if (d % 4 == 0 && aligned4(data) && (!TWO_SEG || aligned4(delta))) return VEC4;
  return SCALAR;
}

// Returns f(std::integral_constant<int, LAYOUT>()) for the layout of the
// inputs (no PACKED instantiation for f32).
template <typename T, bool TWO_SEG, typename F>
inline auto with_layout(const T* data, const T* delta, int d, F f) {
  const int layout = layout_of<T, TWO_SEG>(data, delta, d);
  if constexpr (Packing<T>::C > 1) {
    if (layout == PACKED) return f(std::integral_constant<int, PACKED>());
  }
  if (layout == VEC4) return f(std::integral_constant<int, VEC4>());
  return f(std::integral_constant<int, SCALAR>());
}

template <typename T, bool TWO_SEG>
inline long long delta_shift_of(const T* data, const T* delta, int n_main, int d) {
  if (!TWO_SEG) return 0;
  return (long long)(reinterpret_cast<uintptr_t>(delta) - reinterpret_cast<uintptr_t>(data)) -
         (long long)n_main * d * (long long)sizeof(T);
}

// The split kernel's blocks per SM for the launch these inputs make.
template <typename T, bool SCALED, bool TWO_SEG>
inline int split_blocks(const T* data, const T* delta, int d) {
  return with_layout<T, TWO_SEG>(data, delta, d, [](auto layout) {
    return SplitBlocks<T, SCALED, decltype(layout)::value>::value;
  });
}

// ---------------------------------------------------------------------------
// One warp per query, WARPS queries per block; q, w (and the scales) per warp
// in shared memory.
template <typename T, bool SCALED, int LAYOUT, bool TWO_SEG>
__global__ void __launch_bounds__(WARPS * 32, WARP_MIN_BLOCKS)
    gather_rerank_warp_kernel(const T* __restrict__ data, long long delta_shift,
                              const float* __restrict__ scales, const int* __restrict__ ids,
                              const float* __restrict__ queries,
                              const float* __restrict__ weights, float* __restrict__ out_d,
                              int* __restrict__ out_i, int n_main, int n_tot, int d, int b, int P,
                              int k) {
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

  for (int j = lane; j < d; j += 32) {
    qs[j] = queries[(size_t)qi * d + j];
    ws[j] = weights[(size_t)qi * d + j];
    if (SCALED) ss[j] = scales[j];
  }
  warp_topk_init(td, ti, k, lane);  // ends with __syncwarp
  const LaneCoefs<T, SCALED, LAYOUT == PACKED> cf(qs, ws, ss, d, lane);

  float worst = CUDART_INF_F;
  const int* idrow = ids + (size_t)qi * P;
  for (int c = 0; c < P; c += 32) {
    const int my = (c + lane < P) ? idrow[c + lane] : -1;
    const unsigned mask = __ballot_sync(FULL_MASK, my >= 0 && my < n_tot);
    if (mask == 0) continue;
    if constexpr (LAYOUT == PACKED)
      worst = rerank_group_packed<T, SCALED, TWO_SEG, false>(data, delta_shift, cf, my, mask, c,
                                                             n_main, d, td, ti, k, worst, lane);
    else
      worst = rerank_group<T, SCALED, LAYOUT, TWO_SEG, false>(
          data, delta_shift, qs, ws, ss, my, mask, c, n_main, d, td, ti, k, worst, lane);
  }

  for (int j = lane; j < k; j += 32) {
    out_d[(size_t)qi * k + j] = td[j];
    out_i[(size_t)qi * k + j] = ti[j];
  }
}

// Dynamic shared memory of one one-warp block: WARPS x (NV vectors of dpad
// + k dists + k ids).
template <bool SCALED>
inline size_t warp_smem_bytes(int d, int k) {
  const int dpad = (d + 3) & ~3;
  return sizeof(float) * (size_t)WARPS * ((SCALED ? 3 : 2) * dpad + 2 * k);
}

// Launches the one-warp schedule. With TWO_SEG false, delta is ignored and
// n_main == n_tot. Returns the CUDA error.
template <typename T, bool SCALED, bool TWO_SEG>
cudaError_t launch_warp(const T* data, const T* delta, const float* scales, const int* ids,
                        const float* queries, const float* weights, float* out_d, int* out_i,
                        int n_main, int n_tot, int d, int b, int P, int k, cudaStream_t s) {
  const size_t smem = warp_smem_bytes<SCALED>(d, k);
  const dim3 grid((b + WARPS - 1) / WARPS);
  const long long shift = delta_shift_of<T, TWO_SEG>(data, delta, n_main, d);
  return with_layout<T, TWO_SEG>(data, delta, d, [&](auto layout) {
    constexpr int LAYOUT = decltype(layout)::value;
    const cudaError_t err =
        allow_dynamic_smem<gather_rerank_warp_kernel<T, SCALED, LAYOUT, TWO_SEG>>(smem);
    if (err != cudaSuccess) return err;
    gather_rerank_warp_kernel<T, SCALED, LAYOUT, TWO_SEG><<<grid, WARPS * 32, smem, s>>>(
        data, shift, scales, ids, queries, weights, out_d, out_i, n_main, n_tot, d, b, P, k);
    return cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// The split schedule. Grid (b, S). With S == 1 writes out_d/out_i (b, k) as
// (dist, id); with S > 1 writes out_d/out_i (b, S, k) as (dist, slot) for
// the merge launch.
template <typename T, bool SCALED, int LAYOUT, bool TWO_SEG>
__global__ void __launch_bounds__(SPLIT_WARPS * 32, SplitBlocks<T, SCALED, LAYOUT>::value)
    gather_rerank_split_kernel(const T* __restrict__ data, long long delta_shift,
                               const float* __restrict__ scales, const int* __restrict__ ids,
                               const float* __restrict__ queries,
                               const float* __restrict__ weights, float* __restrict__ out_d,
                               int* __restrict__ out_i, int n_main, int n_tot, int d, int P,
                               int k, int slots_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int NV = SCALED ? 3 : 2;  // block vectors: q, w[, scales]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int dpad = (d + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ws = qs + dpad;
  float* ss = ws + dpad;                                   // read only when SCALED
  float* ld = qs + NV * dpad;                              // SPLIT_WARPS lists: k dists
  int* ls = reinterpret_cast<int*>(ld + SPLIT_WARPS * k);  // ... and k slots each
  int* head = ls + SPLIT_WARPS * k;                        // the merge's list heads
  float* td = ld + warp * k;
  int* ts = ls + warp * k;

  for (int j = threadIdx.x; j < d; j += SPLIT_WARPS * 32) {
    qs[j] = queries[(size_t)qi * d + j];
    ws[j] = weights[(size_t)qi * d + j];
    if (SCALED) ss[j] = scales[j];
  }
  warp_topk_init(td, ts, k, lane);
  __syncthreads();
  const LaneCoefs<T, SCALED, LAYOUT == PACKED> cf(qs, ws, ss, d, lane);

  const int* idrow = ids + (size_t)qi * P;
  const int s0 = split * slots_per_split;  // a multiple of 32
  const int s1 = min(P, s0 + slots_per_split);
  float worst = CUDART_INF_F;
  for (int c = s0 + warp * 32; c < s1; c += SPLIT_WARPS * 32) {
    const int my = (c + lane < s1) ? idrow[c + lane] : -1;
    const unsigned mask = __ballot_sync(FULL_MASK, my >= 0 && my < n_tot);
    if (mask == 0) continue;
    if constexpr (LAYOUT == PACKED)
      worst = rerank_group_packed<T, SCALED, TWO_SEG, true>(data, delta_shift, cf, my, mask, c,
                                                            n_main, d, td, ts, k, worst, lane);
    else
      worst = rerank_group<T, SCALED, LAYOUT, TWO_SEG, true>(
          data, delta_shift, qs, ws, ss, my, mask, c, n_main, d, td, ts, k, worst, lane);
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

// Dynamic shared memory of one split block: q, w (and the scales),
// SPLIT_WARPS lists of k (dist, slot), and the merge's SPLIT_WARPS list heads.
template <bool SCALED>
inline size_t split_smem_bytes(int d, int k) {
  const int dpad = (d + 3) & ~3;
  return sizeof(float) *
         ((size_t)(SCALED ? 3 : 2) * dpad + (size_t)2 * SPLIT_WARPS * k + SPLIT_WARPS);
}

// Launches the split kernel over (b, S) and, with S > 1, the merge; part_d
// and part_s are the (b, S, k) scratch (unused with S == 1). With TWO_SEG
// false, delta is ignored and n_main == n_tot. Returns the CUDA error.
template <typename T, bool SCALED, bool TWO_SEG>
cudaError_t launch_split(const T* data, const T* delta, const float* scales, const int* ids,
                         const float* queries, const float* weights, float* out_d, int* out_i,
                         float* part_d, int* part_s, int n_main, int n_tot, int d, int b, int P,
                         int k, int S, cudaStream_t s) {
  if (S < 1 || S > 65535 || (S > 1 && (part_d == nullptr || part_s == nullptr)))
    return cudaErrorInvalidValue;
  const int groups = (P + 31) / 32;
  const int slots_per_split = ((groups + S - 1) / S) * 32;
  const size_t smem = split_smem_bytes<SCALED>(d, k);
  const dim3 grid(b, S);
  const long long shift = delta_shift_of<T, TWO_SEG>(data, delta, n_main, d);
  float* dst_d = S == 1 ? out_d : part_d;
  int* dst_i = S == 1 ? out_i : part_s;
  cudaError_t err = with_layout<T, TWO_SEG>(data, delta, d, [&](auto layout) {
    constexpr int LAYOUT = decltype(layout)::value;
    const cudaError_t e =
        allow_dynamic_smem<gather_rerank_split_kernel<T, SCALED, LAYOUT, TWO_SEG>>(smem);
    if (e != cudaSuccess) return e;
    gather_rerank_split_kernel<T, SCALED, LAYOUT, TWO_SEG><<<grid, SPLIT_WARPS * 32, smem, s>>>(
        data, shift, scales, ids, queries, weights, dst_d, dst_i, n_main, n_tot, d, P, k,
        slots_per_split);
    return cudaGetLastError();
  });
  if (err != cudaSuccess || S == 1) return err;
  const size_t msmem = sizeof(int) * (size_t)MERGE_WARPS * S;
  err = allow_dynamic_smem<gather_rerank_merge_kernel>(msmem);
  if (err != cudaSuccess) return err;
  gather_rerank_merge_kernel<<<(b + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, msmem, s>>>(
      part_d, part_s, ids, out_d, out_i, b, P, k, S);
  return cudaGetLastError();
}

}  // namespace
}  // namespace gather_rerank
