// Color deconvolution (Ruifrok-Johnston stain unmixing) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/color_deconv.py::color_deconv_pallas, the
// Pallas kernel that computes, per pixel of a planar (3, H, W) float32 tile,
//   od[c]  = -log10(clip(rgb[c], eps, 1))
//   out[s] = minv[0,s]*od[0] + minv[1,s]*od[1] + minv[2,s]*od[2].
//
// Bound on the H100: bytes. Each pixel reads 12 bytes and writes 12 for about
// 30 operations, far below the card's operations-per-byte balance, so the
// floor is 24*H*W bytes at 3.35 TB/s (0.12 ms at 4096^2).
//
// Design: one thread per pixel over a grid-stride loop; each thread reads the
// three planes and writes the three planes at the same flat index, so a warp
// touches three (read) and three (written) contiguous 128-byte lines. The 3x3
// inverse is read from device memory once per thread through the read-only
// cache (no host synchronisation to fetch it), and kept in registers.
#include <cuda_runtime.h>

namespace {

__global__ void color_deconv_kernel(const float* __restrict__ rgb,
                                    const float* __restrict__ minv,
                                    float* __restrict__ out, long long hw,
                                    float eps) {
  float m[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) m[k] = __ldg(minv + k);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < hw;
       i += stride) {
    const float od0 = -log10f(fminf(fmaxf(rgb[i], eps), 1.0f));
    const float od1 = -log10f(fminf(fmaxf(rgb[hw + i], eps), 1.0f));
    const float od2 = -log10f(fminf(fmaxf(rgb[2 * hw + i], eps), 1.0f));
    // minv is row-major (c, s): out[s] = sum_c minv[c*3 + s] * od[c]
    out[i] = m[0] * od0 + m[3] * od1 + m[6] * od2;
    out[hw + i] = m[1] * od0 + m[4] * od1 + m[7] * od2;
    out[2 * hw + i] = m[2] * od0 + m[5] * od1 + m[8] * od2;
  }
}

}  // namespace

extern "C" int rt_color_deconv(const float* rgb, const float* minv, float* out,
                               long long hw, float eps, cudaStream_t stream) {
  if (hw <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long blocks = (hw + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // grid-stride beyond ~32 blocks/SM
  color_deconv_kernel<<<(unsigned)blocks, threads, 0, stream>>>(rgb, minv, out, hw, eps);
  return (int)cudaGetLastError();
}
