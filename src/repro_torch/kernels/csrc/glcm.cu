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
// NB = 32); the one-hot matmul's work is not needed. What limits this design
// is the serialisation of shared-memory atomics on popular bins.
//
// Design: the paper's per-nucleus thread block. One block per tile counts into
// int arrays in shared memory with atomicAdd ((NB*NB + NB) ints, dynamic
// shared memory, opted in above 48 KB), then writes float32 counts. The tile
// is read once, coalesced; the right neighbour comes from the same line.
//
// Above NB = 240 the (NB*NB + NB) counters no longer fit one block's 227 KB
// of shared memory. rt_glcm_global then zeroes the outputs and counts
// straight into them with float32 atomics in device memory: an integer-valued
// float32 sum is exact while it stays below 2^24, which a tile of fewer than
// 2^24 pixels guarantees (the wrapper checks). Several blocks share a tile, so
// a tile's pixels spread over the SMs; the counts scatter over NB^2 addresses
// and rarely collide.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void glcm_kernel(const int* __restrict__ bins, float* __restrict__ glcm,
                            float* __restrict__ hist, int h, int w, int nb) {
  extern __shared__ int counts[];
  int* g = counts;            // (nb, nb)
  int* hs = counts + nb * nb;  // (nb,)
  const int ncounts = nb * nb + nb;
  for (int k = threadIdx.x; k < ncounts; k += blockDim.x) counts[k] = 0;
  __syncthreads();

  const int hw = h * w;
  const int* tile = bins + (size_t)blockIdx.x * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const int a = tile[p];
    if (a < 0 || a >= nb) continue;
    atomicAdd(hs + a, 1);
    if ((p % w) == w - 1) continue;
    const int b = tile[p + 1];
    if (b >= 0 && b < nb) atomicAdd(g + a * nb + b, 1);
  }
  __syncthreads();

  float* gout = glcm + (size_t)blockIdx.x * nb * nb;
  for (int k = threadIdx.x; k < nb * nb; k += blockDim.x) gout[k] = (float)g[k];
  float* hout = hist + (size_t)blockIdx.x * nb;
  for (int k = threadIdx.x; k < nb; k += blockDim.x) hout[k] = (float)hs[k];
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

// (b, h, w) int32 bins -> glcm (b, nb, nb), hist (b, nb) float32. The caller
// checks that (nb*nb + nb) * 4 bytes fit in one block's shared memory.
extern "C" int rt_glcm(const int* bins, float* glcm, float* hist, int b, int h, int w, int nb,
                       cudaStream_t stream) {
  if (b <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)(nb * nb + nb) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        glcm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  glcm_kernel<<<b, kThreads, smem, stream>>>(bins, glcm, hist, h, w, nb);
  return (int)cudaGetLastError();
}

// The same counts for any nb, in device memory; the caller checks h*w < 2^24
// so that every float32 count is exact.
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
