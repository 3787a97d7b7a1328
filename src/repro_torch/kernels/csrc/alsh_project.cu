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
// adds (n*H*d = 12.9 G at the build width, ~0.2 ms at 67 TFLOP/s), but the
// instructions around each term: one shared-memory load of a staged table
// value, its address, and the add. A one-hot product would spend M+1 = 33
// multiply-adds per term, so the kernel gathers directly instead:
//   * a block owns 32 hashes (one per lane) x TN rows (RPW per warp, kept
//     as RPW register accumulators per thread);
//   * it walks d in chunks of DC coordinates, staging folded[h, i, :] for
//     its 32 hashes as fs[i][m][h] with the hash index innermost, so the 32
//     lanes of a warp read 32 consecutive words (conflict-free) at the
//     level of one row, which every lane shares;
//   * the hash stride is padded to 33 words, so a warp staging one hash
//     reads a contiguous run of folded[h, c0:c0+DC, :] and stores it
//     without bank conflicts (and with no index division);
//   * levels (and weights) of the row tile are staged once per chunk and
//     read as int4/float4 broadcasts, four coordinates per load;
//   * the staged table is amortised over TN rows: 256 rows (RPW = 32) when
//     that still gives two blocks per SM, else 64 rows (RPW = 8), so a
//     query batch of 1024 still spreads over the SMs.
// Each output is a sequential f32 sum over i, so results differ from the
// reference's reduction order only by rounding.

#include <cuda_runtime.h>

namespace {

constexpr int TH = 32;        // hashes per block, one per lane
constexpr int WARPS = 8;
constexpr int PADH = TH + 1;  // padded hash stride of the staged table

template <bool WEIGHTED, int DC, int RPW>
__global__ void __launch_bounds__(WARPS * 32)
    alsh_project_kernel(const int* __restrict__ levels, const float* __restrict__ weights,
                        const float* __restrict__ folded, float* __restrict__ out, int n, int d,
                        int H, int M1) {
  constexpr int TN = WARPS * RPW;  // rows per block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fs = reinterpret_cast<float*>(smem_raw);   // DC * M1 * PADH
  int* ls = reinterpret_cast<int*>(fs + DC * M1 * PADH);  // TN * DC
  float* ws = reinterpret_cast<float*>(ls + TN * DC);     // TN * DC (weighted)

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * TN;
  const int h0 = blockIdx.y * TH;

  float acc[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) acc[r] = 0.f;

  const int per_h = DC * M1;
  for (int c0 = 0; c0 < d; c0 += DC) {
    __syncthreads();
    // folded[h0 + h, c0 + i, m] -> fs[(i*M1 + m)*PADH + h]: a warp stages one
    // hash at a time; e = i*M1 + m runs over a contiguous stretch of folded
    const int lim = min(DC, d - c0) * M1;  // padded coordinates contribute 0
    for (int h = warp; h < TH; h += WARPS) {
      const bool live = h0 + h < H;  // warp-uniform
      const float* src = folded + ((size_t)(h0 + h) * d + c0) * M1;
      for (int e = lane; e < per_h; e += 32) fs[e * PADH + h] = (live && e < lim) ? src[e] : 0.f;
    }
    for (int idx = tid; idx < TN * DC; idx += WARPS * 32) {
      const int r = idx / DC;
      const int i = idx - r * DC;
      const int row = r0 + r;
      const int col = c0 + i;
      const bool ok = row < n && col < d;
      int lv = ok ? levels[(size_t)row * d + col] : 0;
      ls[idx] = min(max(lv, 0), M1 - 1);
      if (WEIGHTED) ws[idx] = ok ? weights[(size_t)row * d + col] : 0.f;
    }
    __syncthreads();

    const int4* ls4 = reinterpret_cast<const int4*>(ls);
    const float4* ws4 = reinterpret_cast<const float4*>(ws);
    const float* fl = fs + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int rr = warp * RPW + r;
      float a = acc[r];
#pragma unroll
      for (int i4 = 0; i4 < DC / 4; ++i4) {
        const int4 l = ls4[rr * (DC / 4) + i4];
        const float* f = fl + (i4 * 4) * M1 * PADH;
        const float f0 = f[(0 * M1 + l.x) * PADH];
        const float f1 = f[(1 * M1 + l.y) * PADH];
        const float f2 = f[(2 * M1 + l.z) * PADH];
        const float f3 = f[(3 * M1 + l.w) * PADH];
        if (WEIGHTED) {
          const float4 wv = ws4[rr * (DC / 4) + i4];
          a = fmaf(wv.x, f0, a);
          a = fmaf(wv.y, f1, a);
          a = fmaf(wv.z, f2, a);
          a = fmaf(wv.w, f3, a);
        } else {
          a += f0;
          a += f1;
          a += f2;
          a += f3;
        }
      }
      acc[r] = a;
    }
  }

  const int h = h0 + lane;
  if (h < H) {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int row = r0 + warp * RPW + r;
      if (row < n) out[(size_t)row * H + h] = acc[r];
    }
  }
}

template <int DC, int RPW>
constexpr size_t smem_bytes(bool weighted, int M1) {
  return sizeof(float) * (size_t)DC * M1 * PADH +
         sizeof(int) * (size_t)WARPS * RPW * DC * (weighted ? 2 : 1);
}

template <bool WEIGHTED, int DC, int RPW>
int launch(const int* levels, const float* weights, const float* folded, float* out, int n, int d,
           int H, int M1, cudaStream_t stream) {
  constexpr int TN = WARPS * RPW;
  const size_t smem = smem_bytes<DC, RPW>(WEIGHTED, M1);
  cudaError_t err = cudaFuncSetAttribute(alsh_project_kernel<WEIGHTED, DC, RPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + TN - 1) / TN, (H + TH - 1) / TH);
  alsh_project_kernel<WEIGHTED, DC, RPW>
      <<<grid, WARPS * 32, smem, stream>>>(levels, weights, folded, out, n, d, H, M1);
  return (int)cudaGetLastError();
}

template <bool WEIGHTED, int RPW>
int launch_dc(const int* levels, const float* weights, const float* folded, float* out, int n,
              int d, int H, int M1, cudaStream_t stream) {
  // widest coordinate chunk whose staged table fits one block's 227 KB
  const size_t budget = 200 * 1024;
  if (smem_bytes<16, RPW>(WEIGHTED, M1) <= budget)
    return launch<WEIGHTED, 16, RPW>(levels, weights, folded, out, n, d, H, M1, stream);
  if (smem_bytes<8, RPW>(WEIGHTED, M1) <= budget)
    return launch<WEIGHTED, 8, RPW>(levels, weights, folded, out, n, d, H, M1, stream);
  return launch<WEIGHTED, 4, RPW>(levels, weights, folded, out, n, d, H, M1, stream);
}

template <bool WEIGHTED>
int launch_rows(const int* levels, const float* weights, const float* folded, float* out, int n,
                int d, int H, int M1, cudaStream_t stream) {
  // 256-row tiles when they still make two blocks per SM of a 132-SM card
  const long big_blocks = (long)((n + WARPS * 32 - 1) / (WARPS * 32)) * ((H + TH - 1) / TH);
  if (big_blocks >= 2 * 132)
    return launch_dc<WEIGHTED, 32>(levels, weights, folded, out, n, d, H, M1, stream);
  return launch_dc<WEIGHTED, 8>(levels, weights, folded, out, n, d, H, M1, stream);
}

}  // namespace

// levels (n, d) int32, weights (n, d) f32 or NULL, folded (H, d, M1) f32,
// out (n, H) f32; all contiguous on the current device. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int alsh_project_launch(const int* levels, const float* weights, const float* folded,
                                   float* out, int n, int d, int H, int M1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weights != nullptr) return launch_rows<true>(levels, weights, folded, out, n, d, H, M1, s);
  return launch_rows<false>(levels, weights, folded, out, n, d, H, M1, s);
}

// Message of a CUDA error code returned by the launch functions above.
extern "C" const char* cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
