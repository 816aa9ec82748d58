// Online-softmax (flash) attention for Hopper (sm_90a): GQA, causal mask,
// sliding window, query offset and ragged key length.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas, which
// walks a (batch*heads, q blocks, k blocks) grid with the k axis sequential and
// keeps the (bq, D) accumulator and the running max and sum in VMEM scratch.
//
// What it computes, for q (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D):
//   out[b,h,i] = softmax_j(q[b,h,i] . k[b,g(h),j] * scale  over the live j) v[b,g(h),j]
// with g(h) = h / (Hq/Hkv) (no repeated KV in memory) and key j live for query
// position qpos = q_offset + i when j < Tk, j <= qpos (causal) and
// qpos - j < window (sliding window). A row with no live key gives 0, as
// ref.attention_ref's NaN -> 0 does: the finalisation divides by l only where
// l > 0, and a masked score contributes exp(-inf) = 0, never exp(0).
//
// Bound on the H100: operations at the main path's shapes (q (2,25,2048,64),
// k/v (2,5,2048,64)): 4*D multiply-adds' worth of flops per live (query, key)
// pair against the 989 TFLOP/s bf16 tensor-core rate, about 20-27 us a call,
// above the ~9 us that the 31 MB of q, k, v and out take at 3.35 TB/s.
// This first design runs on the CUDA cores in float32, so it cannot reach
// that bound; the tensor-core (mma/wgmma) redesign is later work.
//
// Design: grid (B*Hq, ceil(Tq/64)); a block owns 64 queries of one head.
// Each query is held by kLanes neighbouring threads (1 for D <= 32, D/32
// above), each with a kSlice-wide slice of q (pre-scaled) and of the float32
// accumulator in registers. The block stages 32-key tiles of K and V, converted
// to float32, in shared memory; every thread of a query reads the same key row
// (a broadcast), and the kLanes slices of a row are padded apart so that they
// fall in different banks. Per tile a thread computes its 32 scores (partial
// dots summed across the query's lanes with shuffles), then updates the running
// max m, the sum l and the accumulator once. Tiles that no query of the block
// may see (wholly in the future under the causal mask, or wholly before the
// window) are never loaded: the loop runs only over the live tile range, the
// Pallas kernel's block skip.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;  // queries per block
constexpr int kBlockK = 32;  // keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// How a head_dim D is split over the threads of one query.
template <int D>
struct Split {
  static constexpr int kLanes = D >= 64 ? D / 32 : 1;  // threads per query
  static constexpr int kSlice = D / kLanes;            // dims per thread
  static constexpr int kPad = kLanes > 1 ? 4 : 0;      // floats between slices
  static constexpr int kRow = kLanes * (kSlice + kPad);  // floats per staged key row
  static_assert(D % kLanes == 0 && 32 % kLanes == 0, "unsupported head_dim");
};

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ * Split<D>::kLanes)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq, int hkv, int tq,
                       int tk, float scale, int causal, int window, int q_offset) {
  using S = Split<D>;
  constexpr int kLanes = S::kLanes, kSlice = S::kSlice, kRow = S::kRow;
  constexpr int kThreads = kBlockQ * kLanes;
  __shared__ __align__(16) float ks[kBlockK * kRow];
  __shared__ __align__(16) float vs[kBlockK * kRow];

  const int bh = blockIdx.x;  // batch * Hq + query head
  const int kv_row = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int tid = threadIdx.x;
  const int slice = tid % kLanes;
  const int q0 = blockIdx.y * kBlockQ;
  const int qrow = q0 + tid / kLanes;
  const bool q_in = qrow < tq;
  const int qpos = q_offset + qrow;

  float qr[kSlice], acc[kSlice];
  const T* qp = q + ((size_t)bh * tq + (q_in ? qrow : 0)) * D + slice * kSlice;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    qr[i] = q_in ? to_f32(qp[i]) * scale : 0.f;
    acc[i] = 0.f;
  }

  // The live tile range of the whole block (the Pallas kernel's block skip).
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBlockQ, tq) - 1;
  const int nk = (tk + kBlockK - 1) / kBlockK;
  int kt_end = nk;
  if (causal) kt_end = q_hi < 0 ? 0 : min(nk, q_hi / kBlockK + 1);
  int kt_begin = 0;
  if (window >= 0) kt_begin = max(0, q_lo - window + 1) / kBlockK;

  const T* kb = k + (size_t)kv_row * tk * D;
  const T* vb = v + (size_t)kv_row * tk * D;
  float m = -INFINITY, l = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBlockK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int dst = r * kRow + (c / kSlice) * (kSlice + S::kPad) + c % kSlice;
      const bool in = k0 + r < tk;
      ks[dst] = in ? to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      vs[dst] = in ? to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float* kr = ks + j * kRow + slice * (kSlice + S::kPad);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kSlice; ++i) dot = fmaf(qr[i], kr[i], dot);
#pragma unroll
      for (int o = kLanes / 2; o > 0; o /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      const int kpos = k0 + j;
      bool live = kpos < tk;
      if (causal) live = live && qpos >= kpos;
      if (window >= 0) live = live && qpos - kpos < window;
      s[j] = live ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no live key yet: keep 0s
    const float alpha = expf(m - m_use);
#pragma unroll
    for (int i = 0; i < kSlice; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_use);
      psum += p;
      const float* vr = vs + j * kRow + slice * (kSlice + S::kPad);
#pragma unroll
      for (int i = 0; i < kSlice; ++i) acc[i] = fmaf(p, vr[i], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!q_in) return;
  const float inv = 1.f / (l > 0.f ? l : 1.f);
  T* op = out + ((size_t)bh * tq + qrow) * D + slice * kSlice;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) store(op + i, acc[i] * inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int tq, int tk, float scale, int causal, int window, int q_offset,
           cudaStream_t stream) {
  const dim3 grid(b * hq, (tq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, D><<<grid, kBlockQ * Split<D>::kLanes, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, tq, tk, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out, int b, int hq,
               int hkv, int tq, int tk, float scale, int causal, int window, int q_offset,
               cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    case 24: return launch<T, 24>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    case 32: return launch<T, 32>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    case 64: return launch<T, 64>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    case 128: return launch<T, 128>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, hq, tq, d), k and v (b, hkv, tk, d), out like q; all contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1). window < 0 means no window. The caller
// checks d in {16, 24, 32, 64, 128} and hq % hkv == 0.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* out, int b,
                                  int hq, int hkv, int tq, int tk, int d, int bf16, float scale,
                                  int causal, int window, int q_offset, cudaStream_t stream) {
  if (b <= 0 || tq <= 0) return (int)cudaGetLastError();
  if (bf16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window,
                                     q_offset, stream);
  return dispatch_d<float>(d, q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset,
                           stream);
}
