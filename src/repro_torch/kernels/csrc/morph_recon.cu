// Grayscale morphological reconstruction by dilation (4-connectivity) for
// Hopper (sm_90a): one 4-direction sweep per call.
//
// Replaces: src/repro/kernels/morph_recon.py::morph_recon_sweep_pallas and the
// fixed-point loop morph_recon_pallas, which relax 256^2 VMEM tiles with
// clamp-composition associative scans plus a 1-pixel halo exchange.
//
// What it computes: the sweep of repro.kernels.ref.morph_recon_sweep_ref.
// Each directional pass (down, up, right, left) walks the recurrence
//   m_i = min(mask_i, max(j_i, m_{i-1})),  m_{-1} = -inf
// which is exactly what the reference's associative scan evaluates (min and
// max select and never round), so every sweep equals the reference's sweep
// bit for bit and the host loop's sweep count means what max_iters means.
//
// Bound on the H100: bytes. The least traffic for the whole reconstruction is
// marker + mask in and the result out, 12 bytes a pixel (60 us at 4096^2 at
// 3.35 TB/s); a sweep does 8 min/max per pixel, so operations never bound it.
// This design moves far more than that: every pass reads j and mask and writes
// j (4 passes a sweep, several sweeps), and it is bound by the latency of the
// sequential walk, since each thread carries one scan line.
//
// Design: one launch per direction. Down and up use one thread per column, so
// a warp reads 32 neighbouring floats of a row at each step (coalesced). Right
// and left use one thread per row and are uncoalesced: a warp touches 32 rows
// at each step, and L1 keeps each row's 128-byte line for the next 31 steps.
// Every pass compares its output with its input at each pixel and raises a
// device flag on any change; the flag is cleared at the start of the sweep and
// read by the host once per sweep. Values only grow within a sweep, so the
// flag is set exactly when the sweep's output differs from its input, the
// reference's stopping test. The first pass reads the marker and applies
// min(marker, mask) itself; later passes work in place on the output.
// The paper's IWPP queue-driven wavefront is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 32;

// One thread per column; rows walked top-down (kReverse=false) or bottom-up.
// src may alias dst: each thread reads and writes only its own column.
template <bool kReverse>
__global__ void recon_cols(const float* src, const float* __restrict__ mask, float* dst,
                           int* changed, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  float prev = -INFINITY;
  bool any = false;
#pragma unroll 8
  for (int k = 0; k < h; ++k) {
    const int y = kReverse ? h - 1 - k : k;
    const size_t i = (size_t)y * w + x;
    const float j = src[i];
    const float c = mask[i];
    const float m = fminf(c, fmaxf(j, prev));
    any |= (m != fminf(j, c));
    dst[i] = m;
    prev = m;
  }
  if (any) atomicOr(changed, 1);
}

// One thread per row; columns walked left-to-right (kReverse=false) or back.
template <bool kReverse>
__global__ void recon_rows(const float* src, const float* __restrict__ mask, float* dst,
                           int* changed, int h, int w) {
  const int y = blockIdx.x * blockDim.x + threadIdx.x;
  if (y >= h) return;
  const size_t row = (size_t)y * w;
  float prev = -INFINITY;
  bool any = false;
#pragma unroll 8
  for (int k = 0; k < w; ++k) {
    const size_t i = row + (kReverse ? w - 1 - k : k);
    const float j = src[i];
    const float c = mask[i];
    const float m = fminf(c, fmaxf(j, prev));
    any |= (m != fminf(j, c));
    dst[i] = m;
    prev = m;
  }
  if (any) atomicOr(changed, 1);
}

}  // namespace

// One sweep: out = sweep(min(marker, mask)); *changed = (out != min(marker, mask)).
// marker may be out itself (every sweep after the first).
extern "C" int rt_morph_recon_sweep(const float* marker, const float* mask, float* out,
                                    int* changed, int h, int w, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(changed, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  const int col_blocks = (w + kThreads - 1) / kThreads;
  const int row_blocks = (h + kThreads - 1) / kThreads;
  recon_cols<false><<<col_blocks, kThreads, 0, stream>>>(marker, mask, out, changed, h, w);
  recon_cols<true><<<col_blocks, kThreads, 0, stream>>>(out, mask, out, changed, h, w);
  recon_rows<false><<<row_blocks, kThreads, 0, stream>>>(out, mask, out, changed, h, w);
  recon_rows<true><<<row_blocks, kThreads, 0, stream>>>(out, mask, out, changed, h, w);
  return (int)cudaGetLastError();
}
