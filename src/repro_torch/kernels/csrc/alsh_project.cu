// ALSH projection (paper §4.2.3) for Hopper:
//
//     out[n, h] = sum_i  w[n, i] * folded[h, i, levels[n, i]]      (w == 1 unweighted)
//
// Replaces the TPU kernel src/repro/kernels/alsh_project.py
// (alsh_project_pallas -> _project_kernel), which rewrites the lookup as a
// one-hot (n, d*(M+1)) x (d*(M+1), H) contraction on the MXU.
//
// What bounds it on this card: not HBM (levels, weights and the (n, H)
// output are ~0.5 GB at the build width, ~0.16 ms at 3.35 TB/s) and not the
// adds (n*H*d = 12.9 G at the build width, ~0.2 ms at 67 TFLOP/s), but
// shared memory: every term reads one staged table value (4 bytes) at a
// row-dependent address, and an SM reads 128 bytes of shared memory a
// clock, ~1.5-1.7 ms for the build width's 12.9 G terms. A one-hot product
// would spend M+1 = 33 multiply-adds per term, so the kernel gathers
// directly, and keeps the instructions around each read few:
//   * a block owns 64 hashes (two per lane, read together with one 8-byte
//     shared load) x TN rows (RPW per warp, 2 * RPW register accumulators
//     per thread);
//   * the table is read from `tiled`, a relayout of folded built once per
//     PrefixTables (kernels/alsh_project.py::tile_folded): [hash group of
//     64][i][m][h] with h innermost, so a chunk of DC coordinates of one
//     group is one contiguous run, copied with 16-byte cp.async and read
//     without bank conflicts (32 lanes x 8 bytes of one (i, m) row);
//   * staging is a ring of STAGES chunks: chunk c+STAGES-1 is copied while
//     chunk c is computed, one barrier a chunk. The levels of the row tile
//     are loaded a chunk ahead into registers, clamped to {0..M} and stored
//     as byte offsets into the staged table, so a term costs its share of a
//     broadcast offset load, one address add, half an 8-byte load and an
//     add (or fma);
//   * build width: 256-row tiles (RPW = 32) and two stages, two blocks per
//     SM, so each staged table serves 256 rows; query width (too few
//     256-row tiles for two blocks per SM): 64-row tiles (RPW = 8) and four
//     stages, one block per SM with three chunks in flight. Grid order runs
//     a row tile's hash groups together, so its levels stay in L2;
//   * a large M shrinks the chunk (DC = 4, 2, 1 coordinates) to fit the
//     ring in shared memory.
// Each output is a sequential f32 sum over i in one thread (a += f, or
// fmaf(w, f, a)), the order of the earlier design, so the projections are
// bit for bit the same.

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

constexpr int HB = 64;  // hashes per block, two per lane
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr size_t SMEM_MAX = 227 * 1024;

template <int DC>
struct Vec;
template <>
struct Vec<4> {
  using I = int4;
  using F = float4;
};
template <>
struct Vec<2> {
  using I = int2;
  using F = float2;
};
template <>
struct Vec<1> {
  using I = int;
  using F = float;
};

template <typename V>
__device__ __forceinline__ auto lane_of(const V& v, int j) {
  if constexpr (sizeof(V) == 4) {
    return v;
  } else if constexpr (sizeof(V) == 8) {
    return j == 0 ? v.x : v.y;
  } else {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
}

template <bool WEIGHTED, int RPW, int DC, int STAGES>
constexpr size_t smem_bytes(int M1) {
  constexpr int TN = WARPS * RPW;
  return (size_t)STAGES * (sizeof(float) * DC * M1 * HB +
                           (WEIGHTED ? 2 : 1) * sizeof(int) * TN * DC);
}

template <bool WEIGHTED, int RPW, int DC, int STAGES>
__global__ void __launch_bounds__(THREADS, RPW >= 32 ? 2 : 1)
    alsh_project_kernel(const int* __restrict__ levels, const float* __restrict__ weights,
                        const float* __restrict__ tiled, float* __restrict__ out, int n, int d,
                        int H, int M1) {
  constexpr int TN = WARPS * RPW;                           // rows per block
  constexpr int PER = (TN * DC + THREADS - 1) / THREADS;    // (row, coordinate) pairs a thread stages
  using VI = typename Vec<DC>::I;
  using VF = typename Vec<DC>::F;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tab = DC * M1 * HB;                             // floats of one staged table chunk
  float* ring = reinterpret_cast<float*>(smem_raw);         // STAGES * tab
  int* offs = reinterpret_cast<int*>(ring + STAGES * tab);  // STAGES * TN * DC byte offsets
  float* wts = reinterpret_cast<float*>(offs + STAGES * TN * DC);  // STAGES * TN * DC

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int groups = (H + HB - 1) / HB;
  const int g = blockIdx.x % groups;  // hash group: a row tile's groups run together
  const int r0 = (blockIdx.x / groups) * TN;
  const int nc = (d + DC - 1) / DC;
  const float* gtab = tiled + (size_t)g * d * M1 * HB;

  // the table chunk c (coordinates c*DC ..) into stage s; coordinates past d
  // are zero-filled, so their (clamped-to-0) lookups add 0
  auto stage_table = [&](int s, int c) {
    const float* src = gtab + (size_t)c * tab;
    const int valid4 = min(DC, d - c * DC) * M1 * HB / 4;
    float* dst = ring + s * tab;
    for (int e = tid; e < tab / 4; e += THREADS)
      cp_async16(dst + 4 * e, src + 4 * (e < valid4 ? e : 0), e < valid4);
  };
  int lv[PER];
  float wv[PER];
  auto load_levels = [&](int c) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * THREADS;
      const int row = r0 + e / DC;
      const int col = c * DC + e % DC;
      const bool ok = e < TN * DC && row < n && col < d;
      lv[u] = ok ? levels[(size_t)row * d + col] : 0;
      if (WEIGHTED) wv[u] = ok ? weights[(size_t)row * d + col] : 0.f;
    }
  };
  auto store_offsets = [&](int s) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int e = tid + u * THREADS;
      if (e < TN * DC) {
        const int m = min(max(lv[u], 0), M1 - 1);
        offs[s * TN * DC + e] = (int)sizeof(float) * ((e % DC) * M1 + m) * HB;
        if (WEIGHTED) wts[s * TN * DC + e] = wv[u];
      }
    }
  };

  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nc) {
      stage_table(c, c);
      load_levels(c);
      store_offsets(c);
    }
    cp_async_commit();
  }

  float a0[RPW], a1[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) a0[r] = a1[r] = 0.f;

  for (int c = 0; c < nc; ++c) {
    cp_async_wait<STAGES - 2>();  // chunk c's table has landed (this thread's copies)
    __syncthreads();              // ... everyone's, with its offsets; chunk c-1's stage is free
    const int cn = c + STAGES - 1;
    if (cn < nc) {
      stage_table(cn % STAGES, cn);
      load_levels(cn);  // in flight while chunk c is computed
    }
    cp_async_commit();

    const int s = c % STAGES;
    const unsigned char* tb = reinterpret_cast<const unsigned char*>(ring + s * tab) + 8 * lane;
    const VI* os = reinterpret_cast<const VI*>(offs + s * TN * DC) + warp * RPW;
    const VF* ws = reinterpret_cast<const VF*>(wts + s * TN * DC) + warp * RPW;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const VI o = os[r];  // broadcast: DC offsets of one row
      VF w{};
      if (WEIGHTED) w = ws[r];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float2 f = *reinterpret_cast<const float2*>(tb + lane_of(o, j));
        if (WEIGHTED) {
          a0[r] = fmaf(lane_of(w, j), f.x, a0[r]);
          a1[r] = fmaf(lane_of(w, j), f.y, a1[r]);
        } else {
          a0[r] += f.x;
          a1[r] += f.y;
        }
      }
    }
    if (cn < nc) store_offsets(cn % STAGES);  // read after the barrier of chunk cn
  }
  cp_async_wait<0>();

  const int h = g * HB + 2 * lane;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = r0 + warp * RPW + r;
    if (row >= n) break;
    float* o = out + (size_t)row * H + h;
    if (h + 1 < H && H % 2 == 0) {
      *reinterpret_cast<float2*>(o) = make_float2(a0[r], a1[r]);
    } else {
      if (h < H) o[0] = a0[r];
      if (h + 1 < H) o[1] = a1[r];
    }
  }
}

template <bool WEIGHTED, int RPW, int DC, int STAGES>
int launch(const int* levels, const float* weights, const float* tiled, float* out, int n, int d,
           int H, int M1, cudaStream_t stream) {
  constexpr int TN = WARPS * RPW;
  const size_t smem = smem_bytes<WEIGHTED, RPW, DC, STAGES>(M1);
  cudaError_t err = allow_dynamic_smem<alsh_project_kernel<WEIGHTED, RPW, DC, STAGES>>(smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)((H + HB - 1) / HB) * ((n + TN - 1) / TN);
  alsh_project_kernel<WEIGHTED, RPW, DC, STAGES>
      <<<(unsigned)blocks, THREADS, smem, stream>>>(levels, weights, tiled, out, n, d, H, M1);
  return (int)cudaGetLastError();
}

// The widest chunk whose ring fits `budget` bytes (the narrowest fits the
// whole 227 KB at least), else an error.
template <bool WEIGHTED, int RPW, int STAGES>
int launch_dc(const int* levels, const float* weights, const float* tiled, float* out, int n,
              int d, int H, int M1, size_t budget, cudaStream_t stream) {
  if (smem_bytes<WEIGHTED, RPW, 4, STAGES>(M1) <= budget)
    return launch<WEIGHTED, RPW, 4, STAGES>(levels, weights, tiled, out, n, d, H, M1, stream);
  if (smem_bytes<WEIGHTED, RPW, 2, STAGES>(M1) <= budget)
    return launch<WEIGHTED, RPW, 2, STAGES>(levels, weights, tiled, out, n, d, H, M1, stream);
  if (smem_bytes<WEIGHTED, RPW, 1, STAGES>(M1) <= SMEM_MAX)
    return launch<WEIGHTED, RPW, 1, STAGES>(levels, weights, tiled, out, n, d, H, M1, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool WEIGHTED>
int launch_rows(const int* levels, const float* weights, const float* tiled, float* out, int n,
                int d, int H, int M1, cudaStream_t stream) {
  // 256-row tiles when they make two blocks per SM of a 132-SM card
  const long big_blocks = (long)((n + WARPS * 32 - 1) / (WARPS * 32)) * ((H + HB - 1) / HB);
  if (big_blocks >= 2 * 132)
    return launch_dc<WEIGHTED, 32, 2>(levels, weights, tiled, out, n, d, H, M1, SMEM_MAX / 2 - 1024,
                                      stream);
  if (smem_bytes<WEIGHTED, 8, 1, 4>(M1) <= SMEM_MAX)
    return launch_dc<WEIGHTED, 8, 4>(levels, weights, tiled, out, n, d, H, M1, SMEM_MAX, stream);
  return launch<WEIGHTED, 8, 1, 2>(levels, weights, tiled, out, n, d, H, M1, stream);
}

}  // namespace

// levels (n, d) int32, weights (n, d) f32 or NULL, tiled (ceil(H/64), d, M1,
// 64) f32 (the relayout of folded (H, d, M1); hashes past H are zero), out
// (n, H) f32; all contiguous on the current device, tiled 16-byte aligned.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int alsh_project_launch(const int* levels, const float* weights, const float* tiled,
                                   float* out, int n, int d, int H, int M1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weights != nullptr) return launch_rows<true>(levels, weights, tiled, out, n, d, H, M1, s);
  return launch_rows<false>(levels, weights, tiled, out, n, d, H, M1, s);
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
