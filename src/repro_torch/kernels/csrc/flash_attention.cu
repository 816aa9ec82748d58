// Online-softmax (flash) attention for Hopper (sm_90a): GQA, causal mask,
// sliding window, query offset and ragged key length. Three kernels:
//   * the tensor-core instance (bf16 at D = 64, 128, 192 and 256), in the
//     FlashAttention-2 layout on mma.sync m16n8k16 bf16 (namespace tc below);
//   * the CUDA-core instance, f32 arithmetic throughout, which holds the
//     float32 tolerance of 3e-4 (TF32 would not): float32 at D = 64, 128, 192
//     and 256 in register-tiled products (namespace simt), float32 and bf16
//     at D in {16, 24, 32} one thread a query (flash_attention_kernel).
// The wrapper (kernels/flash_attention.py::instance) names the instance by
// dtype and D; rt_flash_attention picks the CUDA-core kernel by D.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas, which
// walks a (batch*heads, q blocks, k blocks) grid with the k axis sequential and
// keeps the (bq, D) accumulator and the running max and sum in VMEM scratch.
//
// What all compute, for q (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D):
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
// above the ~9 us that the 31 MB of q, k, v and out take at 3.35 TB/s. In
// float32 the same work meets the 67 TFLOP/s of the CUDA cores: gemma-2b's
// (2, 8 over 1, 2048, 256) is 0.51 ms of multiply-adds against 0.05 ms of
// bytes, so the float32 kernel is a pair of SIMT matrix products.
//
// Small-D design (D <= 32): grid (B*Hq, ceil(Tq/64)); a block of 64 threads
// owns 64 queries of one head, one thread a query with q (pre-scaled) and the
// float32 accumulator in registers. The block stages 32-key tiles of K and V,
// converted to float32, in shared memory; every thread reads the same key row
// (a broadcast). Per tile a thread computes its 32 scores, then updates the
// running max m, the sum l and the accumulator once. Tiles that no query of
// the block may see (wholly in the future under the causal mask, or wholly
// before the window) are never loaded: the loop runs only over the live tile
// range, the Pallas kernel's block skip.
#include <math.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockQ = 64;  // queries per block
constexpr int kBlockK = 32;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(kBlockQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int hq, int hkv, int tq,
                       int tk, float scale, int causal, int window, int q_offset) {
  static_assert(D <= 32, "one thread a query holds at most 32 dims");
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const int bh = blockIdx.x;  // batch * Hq + query head
  const int kv_row = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int qrow = q0 + tid;
  const bool q_in = qrow < tq;
  const int qpos = q_offset + qrow;

  float qr[D], acc[D];
  const T* qp = q + ((size_t)bh * tq + (q_in ? qrow : 0)) * D;
#pragma unroll
  for (int i = 0; i < D; ++i) {
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
    for (int e = tid; e < kBlockK * D; e += kBlockQ) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < tk;
      ks[r][c] = in ? to_f32(kb[(size_t)(k0 + r) * D + c]) : 0.f;
      vs[r][c] = in ? to_f32(vb[(size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D; ++i) dot = fmaf(qr[i], ks[j][i], dot);
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
    for (int i = 0; i < D; ++i) acc[i] *= alpha;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_use);
      psum += p;
#pragma unroll
      for (int i = 0; i < D; ++i) acc[i] = fmaf(p, vs[j][i], acc[i]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (!q_in) return;
  const float inv = 1.f / (l > 0.f ? l : 1.f);
  T* op = out + ((size_t)bh * tq + qrow) * D;
#pragma unroll
  for (int i = 0; i < D; ++i) store(op + i, acc[i] * inv);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int tq, int tk, float scale, int causal, int window, int q_offset,
           cudaStream_t stream) {
  const dim3 grid(b * hq, (tq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, D><<<grid, kBlockQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, hkv, tq, tk, scale, causal, window, q_offset);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// CUDA-core instance at D = 64, 128, 192 and 256 (float32): register-tiled
// SIMT products, in the manner of CUTLASS's SIMT GEMM.
//
// What bounds it: the multiply-adds, 2*D a live (query, key) pair, 0.51 ms
// at gemma-2b's shape at the CUDA cores' 67 TFLOP/s. A query split over
// lanes reads one float from shared memory a multiply-add and pays shuffles
// a score, so shared-memory loads and shuffles bound it, not the FMA units.
// Here every product is an outer product over a register tile: a thread's
// 16-byte vectors from shared memory each feed 8 to 16 multiply-adds. On
// the H100 this runs at about half the FMA rate: an 8 x 8 tile of S (D split
// over four thread groups, their partial sums added through shared memory)
// was no faster at 255 registers a thread with spills, while unrolling both
// products 8 deep, so that the scheduler finds independent loads and
// multiply-adds across iterations, was (PERF.md, PR 22).
//
// Design: grid (B*Hq, ceil(Tq/64)), q-blocks launched last row first (under
// the causal mask the blocks with the most live tiles start first); a block
// of 256 threads owns 64 queries of one head and walks the live 64-key tiles.
// Q (64 x D), one K tile and one V tile sit in shared memory as float32, rows
// of Q and K padded by 4 floats; they arrive by 16-byte cp.async, zero-filled
// past Tq and Tk, and each copy overlaps compute: V(t) lands while S(t) is
// computed, K(t+1) while P(t) V(t) is. Per tile:
//   * S = Q K^T: a thread holds a 4 x 4 tile of S, rows srg + 16i and keys
//     skg + 16j: a warp's 2 rows' and 16 keys' 16-byte loads of 4 dims feed
//     16 multiply-adds a thread.
//   * Softmax in the log2 domain (scale*log2(e) folded in): a row's 64 keys
//     lie with the 16 lanes of a half-warp, so its running max and sum take
//     4 shuffles each, once a tile, and no barrier. P goes to shared memory
//     transposed, P^T (64 keys x 64 rows), with the rescale factor alpha of
//     each row.
//   * O = alpha O + P V: a thread owns 4 or 8 rows by 4 to 12 columns of O
//     (16 to 64 registers) and per key loads one or two 16-byte vectors of
//     P^T and one to three of V, 16 to 64 multiply-adds.
// Shared memory at D = 256: 216,576 bytes, one block an SM (8 warps); the
// register tiles' independent multiply-adds keep the FMA pipes busy with two
// warps a scheduler. A block stages its KV head's tiles itself: gemma's 8
// query heads over one KV head read it 8 times, from the 50 MB L2.
// ---------------------------------------------------------------------------
namespace simt {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;  // queries per block
constexpr int kBlockK = 64;  // keys per staged tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kNR = D == 256 ? 2 : 1;       // row quads of O a thread
  static constexpr int kNV = D == 256 ? 2 : D / 64;  // column quads of O a thread
  static constexpr int kRG = 16 / kNR;               // row groups of O
  static constexpr int kCG = D / (4 * kNV);          // column groups of O
  static constexpr int kRow = D + 4;                 // floats per staged Q or K row
  static constexpr int kPRow = kBlockQ + 4;          // floats per row of P^T
  static constexpr int kSmemBytes =
      4 * (kBlockQ * kRow + kBlockK * kRow + kBlockK * D + kBlockK * kPRow + 2 * kBlockQ);
  static_assert(D == 64 || D == 128 || D == 192 || D == 256, "SIMT head_dim");
  static_assert(kRG * kCG == kThreads && kCG % 8 == 0, "O's tiles cover the block");
  static_assert(kSmemBytes <= 232448, "one block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_simt(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int hq, int hkv,
                     int tq, int tk, float scale_log2, int causal, int window, int q_offset) {
  using T = Tile<D>;
  constexpr int kRow = T::kRow, kPRow = T::kPRow, kNR = T::kNR, kNV = T::kNV;
  extern __shared__ __align__(16) float fs[];
  float* qs = fs;                           // [kBlockQ][kRow]
  float* ks = qs + kBlockQ * kRow;          // [kBlockK][kRow]
  float* vs = ks + kBlockK * kRow;          // [kBlockK][D]
  float* ps = vs + kBlockK * D;             // [kBlockK][kPRow]: P^T
  float* alpha_s = ps + kBlockK * kPRow;   // [kBlockQ]: the tile's rescale of O
  float* l_s = alpha_s + kBlockQ;           // [kBlockQ]: the final sums

  const int bh = blockIdx.x;  // batch * Hq + query head
  const int kv_row = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last q-block first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // S: rows srg + 16i, keys skg + 16j; a row's 64 keys lie with the 16
  // lanes of one half-warp
  const int srg = warp * 2 + lane / 16, skg = lane % 16;
  // O: rows u * 64/kNR + prg*4 + e, columns w * D/kNV + pcg*4 + f
  constexpr int kWarpCols = T::kCG / 8;
  const int prg = (warp / kWarpCols) * 4 + lane / 8, pcg = (warp % kWarpCols) * 8 + lane % 8;

  // The live tile range of the whole block (the Pallas kernel's block skip).
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBlockQ, tq) - 1;
  const int nk = (tk + kBlockK - 1) / kBlockK;
  int kt_end = nk;
  if (causal) kt_end = q_hi < 0 ? 0 : min(nk, q_hi / kBlockK + 1);
  int kt_begin = 0;
  if (window >= 0) kt_begin = max(0, q_lo - window + 1) / kBlockK;

  const float* qb = q + (size_t)bh * tq * D;
  const float* kb = k + (size_t)kv_row * tk * D;
  const float* vb = v + (size_t)kv_row * tk * D;
  // 64 rows from row r0 of a (len, D) slab into dst (stride floats a row),
  // zero-filled from len on.
  auto stage = [&](float* dst, int stride, const float* src, int r0, int len) {
    constexpr int kChunks = D / 4;  // 16-byte chunks a row
#pragma unroll 4
    for (int e = tid; e < 64 * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 4;
      const bool in = r0 + r < len;
      cp_async16(smem_addr(dst + r * stride + c), src + (size_t)(in ? r0 + r : 0) * D + c,
                 in ? 16 : 0);
    }
  };

  float o[4 * kNR][4 * kNV];
#pragma unroll
  for (int r = 0; r < 4 * kNR; ++r)
#pragma unroll
    for (int c = 0; c < 4 * kNV; ++c) o[r][c] = 0.f;
  float m[4], l[4];  // running max and sum of rows srg + 16i (log2 domain)
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  if (kt_begin < kt_end) {
    stage(qs, kRow, qb, q0, tq);
    stage(ks, kRow, kb, kt_begin * kBlockK, tk);
  }
  cp_async_commit();
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    cp_async_wait_all();
    __syncthreads();  // K (and Q) landed; every thread is done with the last tile's V and P
    stage(vs, D, vb, k0, tk);
    cp_async_commit();

    // S = Q K^T in a 4 x 4 register tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    const float* qr = qs + srg * kRow;
    const float* kr = ks + skg * kRow;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(qr + 16 * i * kRow + d);
        kv[i] = *reinterpret_cast<const float4*>(kr + 16 * i * kRow + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // Mask, scale into the log2 domain; the online softmax of each row over
    // its half-warp (4 shuffles reduce the maximum, 4 the sum).
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = srg + 16 * i, qpos = q_offset + q0 + row;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + skg + 16 * j;
        bool live = kpos < tk;
        if (causal) live = live && qpos >= kpos;
        if (window >= 0) live = live && qpos - kpos < window;
        s[i][j] = live ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o_ = 1; o_ < 16; o_ *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no live key yet: keep 0s
      const float alpha = exp2f(m[i] - m_use);
      m[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        psum += p;
        ps[(skg + 16 * j) * kPRow + row] = p;
      }
#pragma unroll
      for (int o_ = 1; o_ < 16; o_ *= 2) psum += __shfl_xor_sync(0xffffffffu, psum, o_);
      l[i] = l[i] * alpha + psum;
      if (skg == 0) alpha_s[row] = alpha;
    }
    cp_async_wait_all();  // V has landed
    __syncthreads();      // P and alpha are in place; every thread is done with K
    if (kt + 1 < kt_end) stage(ks, kRow, kb, k0 + kBlockK, tk);
    cp_async_commit();

    // O = alpha O + P V in a (4 kNR) x (4 kNV) register tile
#pragma unroll
    for (int u = 0; u < kNR; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = alpha_s[u * (kBlockQ / kNR) + prg * 4 + e];
#pragma unroll
        for (int c = 0; c < 4 * kNV; ++c) o[4 * u + e][c] *= a;
      }
    const float* pr = ps + prg * 4;
    const float* vr = vs + pcg * 4;
#pragma unroll 8
    for (int j = 0; j < kBlockK; ++j) {
      float4 pv[kNR], vv[kNV];
#pragma unroll
      for (int u = 0; u < kNR; ++u)
        pv[u] = *reinterpret_cast<const float4*>(pr + j * kPRow + u * (kBlockQ / kNR));
#pragma unroll
      for (int w = 0; w < kNV; ++w)
        vv[w] = *reinterpret_cast<const float4*>(vr + j * D + w * (D / kNV));
#pragma unroll
      for (int u = 0; u < kNR; ++u) {
        const float pa[4] = {pv[u].x, pv[u].y, pv[u].z, pv[u].w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int w = 0; w < kNV; ++w) {
            o[4 * u + e][4 * w + 0] = fmaf(pa[e], vv[w].x, o[4 * u + e][4 * w + 0]);
            o[4 * u + e][4 * w + 1] = fmaf(pa[e], vv[w].y, o[4 * u + e][4 * w + 1]);
            o[4 * u + e][4 * w + 2] = fmaf(pa[e], vv[w].z, o[4 * u + e][4 * w + 2]);
            o[4 * u + e][4 * w + 3] = fmaf(pa[e], vv[w].w, o[4 * u + e][4 * w + 3]);
          }
      }
    }
  }

  // Finalise: the sums to O's owners, then divide only where l > 0.
  if (skg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) l_s[srg + 16 * i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kNR; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = u * (kBlockQ / kNR) + prg * 4 + e;
      if (q0 + row >= tq) continue;
      const float lr = l_s[row];
      const float inv = 1.f / (lr > 0.f ? lr : 1.f);
      float* op = out + ((size_t)bh * tq + q0 + row) * D + pcg * 4;
#pragma unroll
      for (int w = 0; w < kNV; ++w)
        *reinterpret_cast<float4*>(op + w * (D / kNV)) =
            make_float4(o[4 * u + e][4 * w] * inv, o[4 * u + e][4 * w + 1] * inv,
                        o[4 * u + e][4 * w + 2] * inv, o[4 * u + e][4 * w + 3] * inv);
    }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int tq, int tk, float scale, int causal, int window, int q_offset,
           cudaStream_t stream) {
  constexpr int kSmem = Tile<D>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * hq, (tq + kBlockQ - 1) / kBlockQ);
  flash_attention_simt<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), hq, hkv, tq, tk, scale * kLog2e, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace simt

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out, int b, int hq,
               int hkv, int tq, int tk, float scale, int causal, int window, int q_offset,
               cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    case 24: return launch<T, 24>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    case 32: return launch<T, 32>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {  // bf16 from 64 up: the tensor cores
    switch (d) {
      case 64: return simt::launch<64>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
      case 128: return simt::launch<128>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
      case 192: return simt::launch<192>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
      case 256: return simt::launch<256>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (b, hq, tq, d), k and v (b, hkv, tk, d), out like q; all contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1). window < 0 means no window. The caller
// checks d in {16, 24, 32, 64, 128, 192, 256} (bf16: {16, 24, 32}; bf16 from
// D = 64 up is the tensor-core instance's), hq % hkv == 0 and, from D = 64
// up, 16-byte aligned q, k, v.
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

// ---------------------------------------------------------------------------
// Tensor-core instance: bf16 at D = 64, 128, 192 and 256, FlashAttention-2
// layout.
//
// Design: grid (B*Hq, ceil(Tq/64)); a block of 4 warps owns 64 queries of one
// head, 16 rows a warp. At D <= 128 each warp keeps its Q rows in registers as
// m16n8k16 A fragments for the whole block. K and V tiles of kBlockK keys stay
// bf16 in shared memory, double-buffered with cp.async (zero-filled past Tk),
// each row padded by 16 bytes so that the 8 rows an ldmatrix phase reads fall
// in 8 different bank groups. Per tile a warp computes S = Q K^T (16 x kBlockK,
// f32 accumulators)
// with ldmatrix + mma.sync, masks S only where the tile straddles an edge (the
// causal diagonal, the window's lower edge, or a ragged Tk) for one of its
// rows, and updates the online softmax in the log2 domain: the running max and
// sum of a row live in the 4 threads of a quad (two shuffles reduce the max;
// the sum is reduced once at the end), and scale*log2(e) is folded into the
// exponent of exp2f. P goes from the S accumulators straight into bf16 A
// fragments (no trip through shared memory) and meets V through
// ldmatrix.trans; O accumulates in f32 registers. P is rounded to bf16 for the
// product, as SDPA's kernels do; the softmax sum l is taken over the f32 P.
//
// The live tile range and the masking rules are those of the CUDA-core
// instance above; the q-blocks are launched last row first, so that under the
// causal mask the blocks with the most live tiles start first.
//
// D = 192 and 256 (MLA's scoring on V padded to 192, gemma's heads): what
// bounds them is registers. At D = 256 a warp's 16 x 256 f32 O accumulators
// take 128 registers a thread; Q's A fragments would take 64 more and a 16 x
// 64 score tile 32. So there Q moves to shared memory (64 x (D + 8) bf16,
// 25.6 KB at 192, 33.8 KB at 256, loaded with the first K/V tile by cp.async
// and zero-filled past Tq), and each k-step reads its A fragments with one
// ldmatrix.x4; and a staged tile holds 32 keys, not 64, which halves S to 16
// registers. Shared memory is then 76.8 KB a block at D = 192 and 101.4 KB at
// D = 256 (K and V, two stages, and Q): two blocks an SM, 8 warps, with up to
// 255 registers a thread (2 x 128 x 255 <= 65,536). At 64 keys a tile D = 256
// would take 169 KB and one block an SM. V is used as it comes: MLA's zero
// columns 128..191 are multiplied like any other.
//
// A block could serve all Hq/Hkv query heads of one KV head and use each
// staged K/V tile 5 times at Hymba's 25/5, but 5 heads' O accumulators, Q
// fragments and scores do not fit one thread's 255 registers at 4 warps; the
// 5 readers of a KV head find its tiles in the 50 MB L2 instead.
namespace {
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // queries per block
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr bool kQShared = D > 128;          // Q in shared memory, not registers
  static constexpr int kBlockK = D > 128 ? 32 : 64;  // keys per staged tile
  static constexpr int kRow = D + 8;                 // bf16 per staged row (16 bytes of padding)
  static constexpr int kElems = kBlockK * kRow;      // bf16 per staged tile
  static constexpr int kQElems = kQShared ? kBlockQ * kRow : 0;
  static constexpr int kSmemBytes = (2 * 2 * kElems + kQElems) * 2;  // K, V two stages; Q
  // blocks an SM: at D = 64 four fit once a thread keeps to 128 registers
  static constexpr int kMinBlocks = D == 64 ? 4 : 2;
  static_assert(D == 64 || D == 128 || D == 192 || D == 256,
                "tensor-core head_dim must be 64, 128, 192 or 256");
  static_assert(kMinBlocks * kSmemBytes <= 228 * 1024, "shared memory of the blocks an SM");
};

template <int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
flash_attention_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int hq,
                   int hkv, int tq, int tk, float scale_log2, int causal, int window,
                   int q_offset) {
  using T = Tile<D>;
  constexpr int kBlockK = T::kBlockK;
  constexpr int kSteps = D / 16;       // k-steps of Q K^T
  constexpr int kDTiles = D / 8;       // n-tiles of P V
  constexpr int kNTiles = kBlockK / 8;  // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBlockK][kRow]
  __nv_bfloat16* vs = ks + 2 * T::kElems;
  __nv_bfloat16* qs = vs + 2 * T::kElems;  // [kBlockQ][kRow] where kQShared

  const int bh = blockIdx.x;  // batch * Hq + query head
  const int kv_row = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last q-block first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group, thread in group
  const int qw = q0 + warp * 16;          // the warp's first query row

  // Q rows qw+g and qw+g+8 as A fragments: {row g, row g+8} x {cols 2t4, 2t4+8}.
  const __nv_bfloat16* qb = q + (size_t)bh * tq * D;
  unsigned qf[T::kQShared ? 1 : kSteps][4];
  if constexpr (!T::kQShared) {
    const bool in0 = qw + g < tq, in1 = qw + g + 8 < tq;
    const unsigned* r0 = reinterpret_cast<const unsigned*>(qb + (size_t)(in0 ? qw + g : 0) * D);
    const unsigned* r1 = reinterpret_cast<const unsigned*>(qb + (size_t)(in1 ? qw + g + 8 : 0) * D);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = (s * 16 + 2 * t4) / 2;  // in pairs of bf16
      qf[s][0] = in0 ? r0[c] : 0u;
      qf[s][1] = in1 ? r1[c] : 0u;
      qf[s][2] = in0 ? r0[c + 4] : 0u;
      qf[s][3] = in1 ? r1[c + 4] : 0u;
    }
  }

  // The live tile range of the whole block (the Pallas kernel's block skip).
  const int q_lo = q_offset + q0;
  const int q_hi = q_offset + min(q0 + kBlockQ, tq) - 1;
  const int nk = (tk + kBlockK - 1) / kBlockK;
  int kt_end = nk;
  if (causal) kt_end = q_hi < 0 ? 0 : min(nk, q_hi / kBlockK + 1);
  int kt_begin = 0;
  if (window >= 0) kt_begin = max(0, q_lo - window + 1) / kBlockK;
  // The warp's own rows decide which tiles need the mask.
  const int w_lo = q_offset + qw;
  const int w_hi = q_offset + min(qw + 16, tq) - 1;

  const __nv_bfloat16* kb = k + (size_t)kv_row * tk * D;
  const __nv_bfloat16* vb = v + (size_t)kv_row * tk * D;
  // The block's 64 Q rows into shared memory (zero-filled past Tq).
  auto load_q = [&]() {
    constexpr int kChunks = D / 8;
#pragma unroll
    for (int e = tid; e < kBlockQ * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      const bool in = q0 + r < tq;
      cp_async16(smem_addr(qs + r * T::kRow + c), qb + (size_t)(in ? q0 + r : 0) * D + c,
                 in ? 16 : 0);
    }
  };
  auto load_tile = [&](int kt, int stage) {
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    const int k0 = kt * kBlockK;
    __nv_bfloat16* kd = ks + stage * T::kElems;
    __nv_bfloat16* vd = vs + stage * T::kElems;
#pragma unroll
    for (int e = tid; e < kBlockK * kChunks; e += kThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      const bool in = k0 + r < tk;
      const size_t off = (size_t)(in ? k0 + r : 0) * D + c;
      cp_async16(smem_addr(kd + r * T::kRow + c), kb + off, in ? 16 : 0);
      cp_async16(smem_addr(vd + r * T::kRow + c), vb + off, in ? 16 : 0);
    }
  };

  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g, g+8 (log2 domain)
  float l[2] = {0.f, 0.f};              // this thread's part of the running sum

  if (kt_begin < kt_end) {
    if constexpr (T::kQShared) load_q();  // lands with the first tile
    load_tile(kt_begin, 0);
  }
  cp_async_commit();
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_tile(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this tile has landed; the next may be in flight
    __syncthreads();

    // S = Q K^T: n-tiles of 8 keys; one ldmatrix.x4 gives two k-steps' B (and,
    // with Q in shared memory, one k-step's A: lanes 0-15 address rows 0-15 at
    // the step's column 0, lanes 16-31 the same rows at column 8).
    const __nv_bfloat16* kt_s = ks + stage * T::kElems;
    float s[kNTiles][4];
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; st += 2) {
      unsigned qa[2][4];  // the A fragments of k-steps st and st + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (T::kQShared) {
          ldsm_x4(smem_addr(qs + (warp * 16 + (lane & 15)) * T::kRow + (st + h) * 16 +
                            (lane >> 4) * 8),
                  qa[h][0], qa[h][1], qa[h][2], qa[h][3]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[h][i] = qf[st + h][i];
        }
      }
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        unsigned b0, b1, b2, b3;
        ldsm_x4(smem_addr(kt_s + (8 * j + (lane & 7)) * T::kRow + st * 16 + (lane >> 3) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[j], qa[0], b0, b1);
        mma_bf16(s[j], qa[1], b2, b3);
      }
    }

    // Scale into the log2 domain; mask only a tile that straddles an edge.
    const int k0 = kt * kBlockK;
    const bool edge = k0 + kBlockK > tk || (causal && k0 + kBlockK - 1 > w_lo) ||
                      (window >= 0 && w_hi - k0 >= window);
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = w_lo + g + (e >= 2 ? 8 : 0);
          bool live = kpos < tk;
          if (causal) live = live && qpos >= kpos;
          if (window >= 0) live = live && qpos - kpos < window;
          x = live ? x : -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // Online softmax: rows g (e = 0, 1) and g+8 (e = 2, 3).
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet: keep 0s
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kNTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e >> 1]);
        psum[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P's accumulators are already laid out as A fragments.
    const __nv_bfloat16* vt_s = vs + stage * T::kElems;
#pragma unroll
    for (int st = 0; st < kBlockK / 16; ++st) {
      const unsigned a[4] = {pack_bf16(s[2 * st][0], s[2 * st][1]),
                             pack_bf16(s[2 * st][2], s[2 * st][3]),
                             pack_bf16(s[2 * st + 1][0], s[2 * st + 1][1]),
                             pack_bf16(s[2 * st + 1][2], s[2 * st + 1][3])};
#pragma unroll
      for (int n = 0; n < kDTiles; n += 2) {
        unsigned b0, b1, b2, b3;
        const int row = 16 * st + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(smem_addr(vt_s + row * T::kRow + 8 * n + (lane >> 4) * 8), b0, b1, b2, b3);
        mma_bf16(o[n], a, b0, b1);
        mma_bf16(o[n + 1], a, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // Finalise: the quad's parts of l, then divide only where l > 0.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] > 0.f ? l[r] : 1.f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw + g + 8 * r;
    if (row >= tq) continue;
    unsigned* op = reinterpret_cast<unsigned*>(out + ((size_t)bh * tq + row) * D);
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      op[(8 * n + 2 * t4) / 2] = pack_bf16(o[n][2 * r] * inv[r], o[n][2 * r + 1] * inv[r]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int b, int hq, int hkv,
           int tq, int tk, float scale, int causal, int window, int q_offset,
           cudaStream_t stream) {
  constexpr int kSmem = Tile<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b * hq, (tq + kBlockQ - 1) / kBlockQ);
  flash_attention_tc<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), hq, hkv, tq, tk,
      scale * kLog2e, causal, window, q_offset);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace

// The tensor-core instance: q (b, hq, tq, d), k and v (b, hkv, tk, d), out
// like q; all contiguous bfloat16 and 16-byte aligned. The caller checks d in
// {64, 128, 192, 256}, hq % hkv == 0 and ceil(tq / 64) < 65536.
extern "C" int rt_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                     int b, int hq, int hkv, int tq, int tk, int d, float scale,
                                     int causal, int window, int q_offset, cudaStream_t stream) {
  if (b <= 0 || tq <= 0) return (int)cudaGetLastError();
  switch (d) {
    case 64:
      return tc::launch<64>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset,
                            stream);
    case 128:
      return tc::launch<128>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset,
                             stream);
    case 192:
      return tc::launch<192>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset,
                             stream);
    case 256:
      return tc::launch<256>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset,
                             stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
