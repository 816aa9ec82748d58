// GLCM (horizontal co-occurrence) and histogram counts for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/glcm.py::glcm_pallas, which forms each object
// tile's one-hot matrices in VMEM and contracts them on the MXU.
//
// What it computes, for each tile b of a (B, H, W) int32 bin batch:
//   glcm[b, l, r] = #{(y, x): bins[b,y,x] = l, bins[b,y,x+1] = r}
//   hist[b, v]    = #{(y, x): bins[b,y,x] = v}
// as float32 counts; a bin outside [0, NB) counts nowhere (a zero one-hot row).
//
// Bound on the H100: bytes. The least traffic is the bins in and the counts
// out, 4*B*(H*W + NB^2 + NB) bytes (10.5 MB, about 3 us, at 512 x 64^2 and
// NB = 32); the one-hot matmul's work is not needed. What limits a plain
// per-pixel design is the serialisation of shared-memory atomics: quantised
// nuclei crops fall into a few bins, so the lanes of a warp hit one counter.
//
// Design: the paper's per-nucleus thread block. One block of 256 threads per
// tile counts into int32 counters in shared memory ((NB*NB + NB) ints,
// dynamic shared memory, opted in above 48 KB), then writes float32 counts.
//   loads: where W % 4 == 0 and the tile is 16-byte aligned, a thread reads 4
//          consecutive bins with one 16-byte load; the right neighbour of its
//          4th bin is the next lane's first (__shfl_down_sync), or one scalar
//          load at the warp's last lane. Other widths take one bin a thread.
//   counts: each warp counts into its own copy of the counters with
//          shared-memory atomics, where 8 copies fit (NB <= 84: 33.8 KB at
//          NB = 32), and the copies are summed before the store: lanes of a
//          warp still collide on a popular bin, warps never do. Above NB = 84
//          the block keeps one copy.
//
// Row bands: a batch of fewer tiles than the card has room for (the kernel
// chains send one whole window, B = 1, up to 4096^2) would leave all but B of
// the 132 SMs idle. Pairs are horizontal, so rows are independent: the grid's
// second axis then cuts each tile into bands of whole rows, each block counts
// its band in shared memory as above, and adds its non-zero counters into the
// outputs (zeroed first) with float32 atomics. Every partial sum is an integer
// no larger than its final count, at most H*W <= 2^24 (the wrapper bands only
// then), so every float32 sum is exact.
//
// Above NB = 240 the (NB*NB + NB) counters no longer fit one block's 227 KB
// of shared memory. rt_glcm_global then zeroes the outputs and counts
// straight into them with float32 atomics in device memory: an integer-valued
// float32 sum is exact while it stays at or below 2^24, which a tile of at
// most 2^24 pixels guarantees (the wrapper checks). Several blocks share a tile, so
// a tile's pixels spread over the SMs; the counts scatter over NB^2 addresses
// and rarely collide.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kMaxSharedBytes = 232448;  // the opt-in shared memory of an sm_90 block

__device__ __forceinline__ void count(int* counts, int key) {
  if (key >= 0) atomicAdd(counts + key, 1);
}

__device__ __forceinline__ int pair_key(int a, int b, bool has_right, int nb) {
  return (a >= 0 && a < nb && has_right && b >= 0 && b < nb) ? a * nb + b : -1;
}

__device__ __forceinline__ int hist_key(int a, int nb) { return (a >= 0 && a < nb) ? a : -1; }

// grid (b, bands): blockIdx.x is the tile, blockIdx.y its band of `rows` rows
// (one band, rows = h, writes the counts; several add them into zeroed
// outputs); copies: 1 or kWarps copies of the counters.
// Every lane of a warp runs the same number of loop trips (the loops step by
// whole warps), as __shfl_down_sync needs.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) glcm_kernel(const int* __restrict__ bins,
                                                        float* __restrict__ glcm,
                                                        float* __restrict__ hist, int h, int w,
                                                        int nb, int copies, int rows) {
  extern __shared__ int counts[];
  const int ncounts = nb * nb + nb;
  for (int k = threadIdx.x; k < ncounts * copies; k += blockDim.x) counts[k] = 0;
  __syncthreads();
  int* g = counts + ((threadIdx.x / 32) % copies) * ncounts;  // (nb, nb)
  int* hs = g + nb * nb;                                        // (nb,)

  const int hw = h * w;
  const int* tile = bins + (size_t)blockIdx.x * hw;
  const int lane = threadIdx.x & 31;
  const int y0 = (int)blockIdx.y * rows;  // the band's first row
  const int p0 = y0 * w, p1 = min(y0 + rows, h) * w;  // its pixels [p0, p1)
  if (kVec) {
    // w % 4 == 0; a group of 4 bins never crosses a row end, nor a band's
    const int g0 = p0 / 4, ngroups = p1 / 4;
    const int trips = (ngroups - g0 + kThreads - 1) / kThreads;
    for (int t = 0; t < trips; ++t) {
      const int q = g0 + t * kThreads + threadIdx.x;
      const bool live = q < ngroups;
      int4 v = make_int4(-1, -1, -1, -1);
      if (live) v = __ldg(reinterpret_cast<const int4*>(tile) + q);
      // the right neighbour of the 4th bin starts the next lane's group
      const bool has_next = live && (4 * q) % w + 4 < w;
      int next = __shfl_down_sync(kFull, v.x, 1);
      if (lane == 31) next = has_next ? __ldg(tile + 4 * q + 4) : -1;
      count(hs, hist_key(v.x, nb));
      count(hs, hist_key(v.y, nb));
      count(hs, hist_key(v.z, nb));
      count(hs, hist_key(v.w, nb));
      count(g, pair_key(v.x, v.y, true, nb));
      count(g, pair_key(v.y, v.z, true, nb));
      count(g, pair_key(v.z, v.w, true, nb));
      count(g, pair_key(v.w, next, has_next, nb));
    }
  } else {
    for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
      const bool has_right = (p % w) != w - 1;
      const int a = __ldg(tile + p);
      const int b = has_right ? __ldg(tile + p + 1) : -1;
      count(hs, hist_key(a, nb));
      count(g, pair_key(a, b, has_right, nb));
    }
  }
  __syncthreads();

  float* gout = glcm + (size_t)blockIdx.x * nb * nb;
  float* hout = hist + (size_t)blockIdx.x * nb;
  const bool banded = gridDim.y > 1;
  for (int k = threadIdx.x; k < ncounts; k += blockDim.x) {
    int c = counts[k];
    for (int r = 1; r < copies; ++r) c += counts[r * ncounts + k];
    float* out = k < nb * nb ? gout + k : hout + (k - nb * nb);
    if (!banded) {
      *out = (float)c;
    } else if (c != 0) {
      atomicAdd(out, (float)c);
    }
  }
}

template <bool kVec>
int launch_glcm(const int* bins, float* glcm, float* hist, int b, int h, int w, int nb, int rows,
                cudaStream_t stream) {
  const size_t one = (size_t)(nb * nb + nb) * sizeof(int);
  const int copies = kWarps * one <= kMaxSharedBytes ? kWarps : 1;
  const size_t smem = copies * one;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(glcm_kernel<kVec>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int bands = max(1, (h + rows - 1) / rows);
  if (bands > 1) {  // the blocks add their bands' counts into zeroed outputs
    cudaError_t err = cudaMemsetAsync(glcm, 0, (size_t)b * nb * nb * sizeof(float), stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(hist, 0, (size_t)b * nb * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
  }
  glcm_kernel<kVec><<<dim3(b, bands), kThreads, smem, stream>>>(bins, glcm, hist, h, w, nb,
                                                                copies, rows);
  return (int)cudaGetLastError();
}

// grid (ceil(h*w / (blocks' pixels)), b): blockIdx.y is the tile.
__global__ void glcm_global_kernel(const int* __restrict__ bins, float* __restrict__ glcm,
                                   float* __restrict__ hist, int h, int w, int nb) {
  const int hw = h * w;
  const int* tile = bins + (size_t)blockIdx.y * hw;
  float* g = glcm + (size_t)blockIdx.y * nb * nb;
  float* hs = hist + (size_t)blockIdx.y * nb;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < hw; p += gridDim.x * blockDim.x) {
    const int a = tile[p];
    if (a < 0 || a >= nb) continue;
    atomicAdd(hs + a, 1.0f);
    if ((p % w) == w - 1) continue;
    const int b = tile[p + 1];
    if (b >= 0 && b < nb) atomicAdd(g + (size_t)a * nb + b, 1.0f);
  }
}

}  // namespace

// (b, h, w) int32 bins -> glcm (b, nb, nb), hist (b, nb) float32; a block
// counts `rows` rows of a tile (rows >= h: the whole tile). The caller checks
// that one copy of the counters fits in one block's shared memory,
// (nb*nb + nb) * 4 bytes, that ceil(h / rows) fits the grid's y axis, and
// that h*w <= 2^24 where rows < h.
extern "C" int rt_glcm(const int* bins, float* glcm, float* hist, int b, int h, int w, int nb,
                       int rows, cudaStream_t stream) {
  if (b <= 0) return (int)cudaGetLastError();
  rows = rows < 1 || rows > h ? max(h, 1) : rows;
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(bins) % 16 == 0;
  return vec ? launch_glcm<true>(bins, glcm, hist, b, h, w, nb, rows, stream)
             : launch_glcm<false>(bins, glcm, hist, b, h, w, nb, rows, stream);
}

// The same counts for any nb, in device memory; the caller checks h*w <= 2^24:
// no count exceeds h*w, and float32 holds every integer up to 2^24 exactly.
extern "C" int rt_glcm_global(const int* bins, float* glcm, float* hist, int b, int h, int w,
                              int nb, cudaStream_t stream) {
  if (b <= 0) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(glcm, 0, (size_t)b * nb * nb * sizeof(float), stream);
  if (err == cudaSuccess) err = cudaMemsetAsync(hist, 0, (size_t)b * nb * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kThreads * 8;  // pixels a block counts
  const dim3 grid((h * w + per_block - 1) / per_block, b);
  glcm_global_kernel<<<grid, kThreads, 0, stream>>>(bins, glcm, hist, h, w, nb);
  return (int)cudaGetLastError();
}
