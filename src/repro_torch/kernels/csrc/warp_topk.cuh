// A warp's running top-k list in shared memory (the gather/rerank kernels),
// and the k-way merge of several sorted lists (the gathers and the scan).
//
// The list holds k (dist, id) entries in ascending dist order; empty slots
// are (+inf, -1). Every lane of the warp calls the helpers with the same
// arguments. An insertion goes AFTER every entry of equal distance, so when
// candidates arrive in position order the list is ordered by (dist,
// position): a stable sort, the tie rule of the plain versions (and of
// lax.top_k over id-ascending candidates).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ void warp_topk_init(float* td, int* ti, int k, int lane) {
  for (int j = lane; j < k; j += 32) {
    td[j] = CUDART_INF_F;
    ti[j] = -1;
  }
  __syncwarp();
}

// Inserts (dv, id) if it ranks within the k best; returns the new k-th
// distance (the admission threshold for the next candidate).
__device__ __forceinline__ float warp_topk_insert(float* td, int* ti, int k, float dv, int id,
                                                  int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) cnt += (td[j] <= dv) ? 1 : 0;
  cnt = __reduce_add_sync(FULL_MASK, cnt);
  if (cnt < k) {
    // shift [cnt, k-1) right by one slot; walk 32-slot chunks from the top
    // so no chunk overwrites a slot a later chunk still has to read
    for (int j0 = ((k - 1) / 32) * 32; j0 >= 0; j0 -= 32) {
      const int j = j0 + lane;
      const bool mv = (j > cnt) && (j < k);
      float a = 0.f;
      int b = 0;
      if (mv) {
        a = td[j - 1];
        b = ti[j - 1];
      }
      __syncwarp();
      if (mv) {
        td[j] = a;
        ti[j] = b;
      }
      __syncwarp();
    }
    if (lane == 0) {
      td[cnt] = dv;
      ti[cnt] = id;
    }
    __syncwarp();
  }
  return td[k - 1];
}

// One warp merges nl lists of k entries each — list l is (ld, ls)[l*k, l*k+k),
// ascending by (dist, slot) with its empty entries (slot < 0) last — into the
// k smallest (dist, slot) pairs over all of them, in that order. Real entries
// carry distinct slots, so the order is total and the result does not depend
// on how the slots were dealt to the lists. put(j, dist, slot) is called by
// lane 0 for j = 0.. in order, then by the lanes for every position past the
// last real entry with (+inf, -1). head (nl ints of shared memory) is
// scratch. ld/ls may lie in shared or global memory.
template <typename Put>
__device__ __forceinline__ void warp_merge_lists(const float* ld, const int* ls, int nl, int k,
                                                 int* head, int lane, Put put) {
  for (int l = lane; l < nl; l += 32) head[l] = 0;
  __syncwarp();
  int j = 0;
  for (; j < k; ++j) {
    float bd = CUDART_INF_F;
    int bs = 0x7fffffff;
    int bl = -1;
    for (int l = lane; l < nl; l += 32) {
      const int h = head[l];
      const int s = h < k ? ls[(size_t)l * k + h] : -1;
      if (s >= 0) {
        const float dv = ld[(size_t)l * k + h];
        if (dv < bd || (dv == bd && s < bs)) {
          bd = dv;
          bs = s;
          bl = l;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL_MASK, bd, off);
      const int os = __shfl_xor_sync(FULL_MASK, bs, off);
      const int ol = __shfl_xor_sync(FULL_MASK, bl, off);
      if (od < bd || (od == bd && os < bs)) {
        bd = od;
        bs = os;
        bl = ol;
      }
    }
    if (bl < 0) break;  // warp-uniform: every list is spent
    if (lane == 0) {
      put(j, bd, bs);
      head[bl] += 1;
    }
    __syncwarp();
  }
  for (int jj = j + lane; jj < k; jj += 32) put(jj, CUDART_INF_F, -1);
}
