// Mamba2 SSD (state-space duality) chunked scan with D skip for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas, one program per
// (batch*head) that walks the chunks in order with the (N, P) state carried in
// VMEM and the intra-chunk work as MXU matmuls.
//
// What it computes, for x (B,T,H,P), dt (B,T,H), a (H,), B and C (B,T,G,N) and
// D (H,), with head h reading group g(h) = h / (H/G):
//   h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T,  y_t = C_t . h_t + D x_t
// from h_{-1} = 0, returning y (B,T,H,P) in x's dtype and the final state
// h (B,H,N,P) in float32 (ref.ssd_scan_ref's recurrence). Per chunk of length L
// it evaluates the chunked form (Dao & Gu 2024) of ssd_scan.py:46-81:
//   cum   = inclusive cumsum of dt*a over the chunk
//   y_i   = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//         + exp(cum_i) (C_i . h)  + D x_i                         (inter, skip)
//   h     = exp(cum_L) h + sum_j exp(cum_L - cum_j) dt_j B_j x_j^T  (carry)
// exp(cum_i - cum_j) is evaluated only for i >= j: the exponent of the upper
// triangle is positive and may overflow, which the reference avoids only by
// masking after the exp. Any T is taken: the last chunk may be shorter.
//
// Bound on the H100: bytes at the main path's shapes (x (2,2048,50,64) bf16,
// N = 16): x in and y out dominate, about 54 MB and 16 us at 3.35 TB/s; the
// chunked arithmetic is about 3 GFLOP, 3 us at the 989 TFLOP/s bf16 rate.
// This design does that arithmetic in float32 on the CUDA cores, one block per
// (batch, head), so only B*H blocks run (100 at the main path's shape, on 132
// SMs); it is far from the bound, and the redesign is later work.
//
// Design: one block of 256 threads per (batch, head) walks the chunks in order.
// A chunk's x, B, C and dt are staged in shared memory as float32, with the N
// axis of B and C padded to N+1 so that threads reading different rows hit
// different banks. Thread 0 takes the chunk's cumulative sum (L adds, in
// order); then the threads build the lower triangle of the (L, L) matrix
// G = (C B^T) . exp(cum_i - cum_j) . dt_j, compute y for the (L, P) outputs
// against G, the state and the skip, and only then update the (N, P) state
// in shared memory, which stays there across chunks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dskip, T* __restrict__ y,
                float* __restrict__ hout, int t, int h, int p, int g, int n, int chunk) {
  extern __shared__ float sm[];
  const int np = n + 1;  // padded row of B and C
  float* xs = sm;                    // (chunk, p)
  float* bs = xs + chunk * p;        // (chunk, np)
  float* cs = bs + chunk * np;       // (chunk, np)
  float* gs = cs + chunk * np;       // (chunk, chunk), lower triangle
  float* hs = gs + chunk * chunk;    // (n, p) state
  float* dts = hs + n * p;           // (chunk,)
  float* cum = dts + chunk;          // (chunk,)
  float* ecum = cum + chunk;         // exp(cum_i)
  float* wts = ecum + chunk;         // exp(cum_L - cum_j) dt_j

  const int b = blockIdx.x / h, hd = blockIdx.x % h;
  const int grp = hd / (h / g);
  const int tid = threadIdx.x;
  const float av = a[hd], dv = dskip[hd];
  for (int e = tid; e < n * p; e += kThreads) hs[e] = 0.f;

  for (int t0 = 0; t0 < t; t0 += chunk) {
    const int len = min(chunk, t - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < len * p; e += kThreads) {
      const int i = e / p, c = e % p;
      xs[e] = to_f32(x[(((size_t)b * t + t0 + i) * h + hd) * p + c]);
    }
    for (int e = tid; e < len * n; e += kThreads) {
      const int i = e / n, c = e % n;
      const size_t src = (((size_t)b * t + t0 + i) * g + grp) * n + c;
      bs[i * np + c] = to_f32(bm[src]);
      cs[i * np + c] = to_f32(cm[src]);
    }
    for (int i = tid; i < len; i += kThreads) dts[i] = dt[((size_t)b * t + t0 + i) * h + hd];
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < len; ++i) {
        run += dts[i] * av;
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[len - 1];
    for (int i = tid; i < len; i += kThreads) {
      ecum[i] = expf(cum[i]);
      wts[i] = expf(total - cum[i]) * dts[i];
    }
    for (int e = tid; e < len * len; e += kThreads) {
      const int i = e / len, j = e % len;
      if (j > i) continue;
      float dot = 0.f;
      for (int c = 0; c < n; ++c) dot = fmaf(cs[i * np + c], bs[j * np + c], dot);
      gs[i * chunk + j] = dot * expf(cum[i] - cum[j]) * dts[j];
    }
    __syncthreads();

    // y = intra + inter + skip, against the state carried into this chunk
    for (int e = tid; e < len * p; e += kThreads) {
      const int i = e / p, c = e % p;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(gs[i * chunk + j], xs[j * p + c], intra);
      float inter = 0.f;
      for (int s = 0; s < n; ++s) inter = fmaf(cs[i * np + s], hs[s * p + c], inter);
      store(y + (((size_t)b * t + t0 + i) * h + hd) * p + c,
            intra + ecum[i] * inter + dv * xs[e]);
    }
    __syncthreads();

    // carry: h = exp(total) h + sum_j w_j B_j x_j^T
    const float decay = expf(total);
    for (int e = tid; e < n * p; e += kThreads) {
      const int s = e / p, c = e % p;
      float acc = 0.f;
      for (int j = 0; j < len; ++j) acc = fmaf(wts[j] * bs[j * np + s], xs[j * p + c], acc);
      hs[e] = decay * hs[e] + acc;
    }
  }
  __syncthreads();
  float* ho = hout + (size_t)blockIdx.x * n * p;
  for (int e = tid; e < n * p; e += kThreads) ho[e] = hs[e];
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* bm, const void* cm,
           const float* dskip, void* y, float* hout, int b, int t, int h, int p, int g, int n,
           int chunk, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ssd_scan_kernel<T><<<b * h, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), static_cast<const T*>(cm),
      dskip, static_cast<T*>(y), hout, t, h, p, g, n, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// x (b,t,h,p), B and C (b,t,g,n) and y (b,t,h,p) in float32 (bf16 = 0) or
// bfloat16 (bf16 = 1); dt (b,t,h), a (h,), dskip (h,) and hout (b,h,n,p) in
// float32; all contiguous. smem is the dynamic shared memory the wrapper sized
// for this chunk (ssd_scan.py::smem_bytes); the caller checks h % g == 0.
extern "C" int rt_ssd_scan(const void* x, const float* dt, const float* a, const void* bm,
                           const void* cm, const float* dskip, void* y, float* hout, int b,
                           int t, int h, int p, int g, int n, int chunk, int bf16,
                           long long smem, cudaStream_t stream) {
  if (b <= 0 || h <= 0) return (int)cudaGetLastError();
  if (t <= 0) return (int)cudaMemsetAsync(hout, 0, (size_t)b * h * n * p * sizeof(float), stream);
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, dskip, y, hout, b, t, h, p, g, n, chunk,
                                 (size_t)smem, stream);
  return launch<float>(x, dt, a, bm, cm, dskip, y, hout, b, t, h, p, g, n, chunk, (size_t)smem,
                       stream);
}
