// Query-directed multiprobe key enumeration for Hopper: (pairs, K) f32
// projections -> (pairs, P) int32 probe keys, most likely first, where a
// pair is one (query, table) of a (b, L, K) batch.
//
// Replaces no Pallas kernel. The TPU package computes this in jnp
// (src/repro/core/families.py ThetaFamily.multiprobe_keys), which XLA fuses
// and whose static subset table (flip_subsets) exists only while tracing.
// The port's plain version (repro_torch.kernels.ref.multiprobe_keys) builds
// that table on the host every call, copies it to the card, scores every
// subset into a (b, L, S) tensor and sorts it; this kernel does the same
// function with no table, no host work and no intermediate.
//
// The function: key = base ^ flip for the P lowest-scored flip subsets,
// where base packs the sign bits (proj >= 0) and a subset's score is the
// sum of its |proj| over its bits, added left to right in increasing bit
// index. Subsets are ordered as flip_subsets orders them: by size r = 0, 1,
// ..., min(max_flips, K), then lexicographically (itertools.combinations);
// a tie in score keeps the earlier subset (the plain version's stable sort).
//
// What bounds it on this card: it reads pairs*K*4 bytes and writes
// pairs*P*4 (2.56 MB at b=1000, L=32, K=12, P=8: 0.76 us at 3.35 TB/s) for
// about pairs * sum_r r*C(K, r) adds (25.7 M there), so the bound is under a
// microsecond and latency and the launch set its floor: each thread walks
// all 299 subsets of its pair in sequence, and 32,000 threads fill an
// eighth of the card's thread slots.
//
// The design answer: one thread owns one pair and keeps nothing but
// registers and a row of shared memory. A block stages its rows with
// coalesced loads into shared memory at an odd row stride, where each
// thread turns its row into |margins| and packs its base key. Every thread
// of the block walks the same subset sequence, so each step's margin read
// is one bit of 32 rows: 32 banks, no conflict, and no divergence outside
// the top-P insertion. An r-subset is its (r-1)-bit prefix, stepped in
// lexicographic order with no index array (combination c_0 < ... < c_q maps
// to the integer R with bits n-1-c_i set, lexicographic order is decreasing
// R, and the previous integer of the same popcount is the complement of
// Gosper's next one over the complement), then each last bit above the
// prefix: one shared-memory read and one add a subset. The P best are kept
// in a list sorted by score, inserted from the top with strict comparisons
// (a tie goes after the entries already there, which came earlier in the
// sequence). For P up to 32 the list is a register array of P's
// power-of-two ceiling PC (template), its prefix the top P; above that the
// P best are a heap in a scratch buffer in device memory that the wrapper
// allocates, which takes any P the plain version takes.
//
// Projections are finite (Index.query refuses non-finite queries and
// weights): the register list's empty slots hold +inf.

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;  // pairs a block
constexpr int MAX_K = 31;     // sign bits packed into one int32 key
constexpr int MAX_STRIDE = MAX_K | 1;

// The lexicographically next r-subset of K bits, in the reversed
// representation R (element i at bit K-1-i): the largest integer below R
// with R's popcount, i.e. the complement of Gosper's next larger integer
// of the complement's popcount. ``full`` holds the K low bits; R is never
// the last subset, so the complement is nonzero and below bit 31.
__device__ __forceinline__ unsigned prev_same_popcount(unsigned R, unsigned full) {
  const unsigned v = ~R & full;
  const unsigned t = v | (v - 1);
  const unsigned next = (t + 1) | (((~t & (t + 1)) - 1) >> __ffs(v));
  return ~next & full;
}

// The P best subsets in a register array of PC >= P slots, sorted by score.
template <int PC>
struct RegisterList {
  float score[PC];
  unsigned flip[PC];

  __device__ __forceinline__ RegisterList() {
#pragma unroll
    for (int j = 0; j < PC; ++j) {
      score[j] = INFINITY;
      flip[j] = 0u;
    }
  }

  __device__ __forceinline__ void insert(float s, unsigned f) {
    if (!(s < score[PC - 1])) return;
    // from the top: slots above the new entry's place shift up, the slot
    // at its place (the first whose old score exceeds s) takes it
#pragma unroll
    for (int j = PC - 1; j > 0; --j) {
      if (s < score[j - 1]) {
        score[j] = score[j - 1];
        flip[j] = flip[j - 1];
      } else if (s < score[j]) {
        score[j] = s;
        flip[j] = f;
      }
    }
    if (s < score[0]) {
      score[0] = s;
      flip[0] = f;
    }
  }

  __device__ __forceinline__ void write(int* out, unsigned base, int P) const {
#pragma unroll
    for (int j = 0; j < PC; ++j)
      if (j < P) out[j] = static_cast<int>(base ^ flip[j]);
  }
};

// The P best subsets in device memory: a max-heap on (score, sequence
// number), so a tie ranks the earlier subset first, as the list in
// registers does. An offer costs one read when it does not enter and
// log2(P) steps when it does; the heap is sorted in place at the end. Its
// scores, sequence numbers and flip masks lie slot-major in the scratch
// buffer (slot j of the pair at [j * stride]), so the lanes of a warp at
// one slot, as at the root, which every offer reads, share cache lines.
struct HeapList {
  float* score;
  unsigned* seq;
  unsigned* flip;
  size_t stride;
  int P;
  int filled = 0;
  unsigned next = 0u;

  __device__ __forceinline__ float& s_at(int j) const { return score[j * stride]; }
  __device__ __forceinline__ unsigned& q_at(int j) const { return seq[j * stride]; }
  __device__ __forceinline__ unsigned& f_at(int j) const { return flip[j * stride]; }

  __device__ __forceinline__ bool less(int a, int b) const {
    const float sa = s_at(a), sb = s_at(b);
    return sa < sb || (sa == sb && q_at(a) < q_at(b));
  }
  __device__ __forceinline__ void set(int j, float s, unsigned q, unsigned f) const {
    s_at(j) = s;
    q_at(j) = q;
    f_at(j) = f;
  }
  __device__ __forceinline__ void swap(int a, int b) const {
    const float s = s_at(a);
    const unsigned q = q_at(a), f = f_at(a);
    set(a, s_at(b), q_at(b), f_at(b));
    set(b, s, q, f);
  }
  __device__ void sift_down(int i, int n) const {
    for (int c = 2 * i + 1; c < n; i = c, c = 2 * i + 1) {
      if (c + 1 < n && less(c, c + 1)) ++c;
      if (!less(i, c)) return;
      swap(i, c);
    }
  }

  __device__ void insert(float s, unsigned f) {
    const unsigned q = next++;
    if (filled < P) {
      int i = filled++;
      set(i, s, q, f);
      for (int p = (i - 1) / 2; i > 0 && less(p, i); i = p, p = (i - 1) / 2) swap(p, i);
      return;
    }
    // a later subset enters only below the worst score (a tie ranks it last)
    if (!(s < s_at(0))) return;
    set(0, s, q, f);
    sift_down(0, P);
  }

  __device__ void write(int* out, unsigned base, int) const {
    for (int n = P - 1; n > 0; --n) {
      swap(0, n);
      sift_down(0, n);
    }
    for (int j = 0; j < P; ++j) out[j] = static_cast<int>(base ^ f_at(j));
  }
};

// Offer every flip subset of up to rmax of K bits to ``list``, in
// flip_subsets order; ``m`` holds the pair's K |margins| in shared memory.
// The r-subsets in lexicographic order are the (r-1)-subsets of bits
// 0..K-2 (prefixes) in lexicographic order, each followed by every last bit
// above its highest one: the prefix's sum is made once, and each subset
// costs one read and one add (the same left-to-right sum).
template <class List>
__device__ __forceinline__ void enumerate(List& list, const float* m, int K, int rmax) {
  list.insert(0.f, 0u);  // the empty subset: the query's own bucket
  const int n = K - 1;   // prefix bits
  for (int r = 1; r <= rmax; ++r) {
    const int q = r - 1;  // prefix size, q <= n
    const unsigned full = (1u << n) - 1u;
    const unsigned last = (1u << q) - 1u;  // prefix of bits n-q .. n-1
    for (unsigned R = last << (n - q);; R = prev_same_popcount(R, full)) {
      const unsigned fp = q ? __brev(R) >> (32 - n) : 0u;  // element i at bit i
      float p = 0.f;
      for (unsigned g = fp; g; g &= g - 1u) p += m[__ffs(g) - 1];
      for (int c = 32 - __clz(fp); c < K; ++c) list.insert(p + m[c], fp | (1u << c));
      if (R == last) break;
    }
  }
}

// PC > 0: the list in registers; PC == 0: the heap in ``scratch``.
template <int PC>
__global__ void __launch_bounds__(THREADS)
    multiprobe_keys_kernel(const float* __restrict__ proj, int* __restrict__ out,
                           float* __restrict__ scratch, int pairs, int K, int rmax, int P) {
  __shared__ float marg[THREADS * MAX_STRIDE];
  const int stride = K | 1;  // odd: one bit of 32 rows lies in 32 banks
  const int first = blockIdx.x * THREADS;
  const int rows = min(THREADS, pairs - first);
  const float* src = proj + (size_t)first * K;
  for (int i = threadIdx.x; i < rows * K; i += THREADS) marg[(i / K) * stride + i % K] = src[i];
  __syncthreads();
  if ((int)threadIdx.x >= rows) return;  // no barrier below

  float* m = marg + threadIdx.x * stride;
  unsigned base = 0u;
  for (int k = 0; k < K; ++k) {
    const float v = m[k];
    base |= static_cast<unsigned>(v >= 0.f) << k;
    m[k] = fabsf(v);
  }
  const size_t row = (size_t)(first + threadIdx.x) * P;
  if constexpr (PC > 0) {
    RegisterList<PC> list;
    enumerate(list, m, K, rmax);
    list.write(out + row, base, P);
  } else {
    const size_t slot = pairs;  // words between a pair's adjacent slots
    float* score = scratch + first + threadIdx.x;
    unsigned* words = reinterpret_cast<unsigned*>(score);
    HeapList list{score, words + P * slot, words + 2 * P * slot, slot, P};
    enumerate(list, m, K, rmax);
    list.write(out + row, base, P);
  }
}

template <int PC>
cudaError_t launch(const float* proj, int* out, float* scratch, int pairs, int K, int rmax, int P,
                   cudaStream_t s) {
  const int blocks = (pairs + THREADS - 1) / THREADS;
  multiprobe_keys_kernel<PC><<<blocks, THREADS, 0, s>>>(proj, out, scratch, pairs, K, rmax, P);
  return cudaGetLastError();
}

}  // namespace

// proj (pairs, K) f32 -> out (pairs, P) int32, all contiguous on the current
// device; rmax = min(max_flips, K) and P = min(n_probes, subsets of at most
// rmax bits), both from the host (repro_torch.kernels.multiprobe_keys).
// ``list`` is the register list's size, P's power-of-two ceiling up to 32,
// or 0 for the heap in device memory over ``scratch`` (3 * P * pairs words).
// Returns the CUDA error code of the launch.
extern "C" int multiprobe_keys_launch(const float* proj, int* out, float* scratch, int pairs,
                                      int K, int rmax, int P, int list, void* stream) {
  if (pairs < 0 || K < 0 || K > MAX_K || rmax < 0 || rmax > K || P < 1 ||
      (list > 0 && P > list) || (list == 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (pairs == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (list) {
    case 1: return (int)launch<1>(proj, out, scratch, pairs, K, rmax, P, s);
    case 2: return (int)launch<2>(proj, out, scratch, pairs, K, rmax, P, s);
    case 4: return (int)launch<4>(proj, out, scratch, pairs, K, rmax, P, s);
    case 8: return (int)launch<8>(proj, out, scratch, pairs, K, rmax, P, s);
    case 16: return (int)launch<16>(proj, out, scratch, pairs, K, rmax, P, s);
    case 32: return (int)launch<32>(proj, out, scratch, pairs, K, rmax, P, s);
    case 0: return (int)launch<0>(proj, out, scratch, pairs, K, rmax, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Message of a CUDA error code returned by the launch function above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
