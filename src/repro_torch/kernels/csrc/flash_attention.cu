// Online-softmax (flash) attention for Hopper (sm_90a): GQA, causal mask,
// sliding window, query offset and ragged key length. Two instances:
//   * the tensor-core instance (bf16 at D = 64 and 128), in the
//     FlashAttention-2 layout on mma.sync m16n8k16 bf16 (namespace tc below);
//   * the CUDA-core instance (float32 at any D, bf16 at D in {16, 24, 32, 192,
//     256}), f32 arithmetic throughout, which holds the float32 tolerance of
//     3e-4.
// The wrapper (kernels/flash_attention.py::instance) picks one by dtype and D.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas, which
// walks a (batch*heads, q blocks, k blocks) grid with the k axis sequential and
// keeps the (bq, D) accumulator and the running max and sum in VMEM scratch.
//
// What both compute, for q (B, Hq, Tq, D) and k, v (B, Hkv, Tk, D):
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
//
// CUDA-core design: grid (B*Hq, ceil(Tq/64)); a block owns 64 queries of one head.
// Each query is held by kLanes neighbouring threads (1 for D <= 32, D/32 to
// D = 128, 8 above: 24 dims a thread at D = 192, 32 at D = 256), each with a
// kSlice-wide slice of q (pre-scaled) and of the float32 accumulator in
// registers. The block stages 32-key tiles of K and V, converted to float32, in
// dynamic shared memory (73,728 bytes at D = 256, above the 48 KB a block gets
// without asking); every thread of a query reads the same key row
// (a broadcast), and the kLanes slices of a row are padded apart so that they
// fall in different banks. Per tile a thread computes its 32 scores (partial
// dots summed across the query's lanes with shuffles), then updates the running
// max m, the sum l and the accumulator once. Tiles that no query of the block
// may see (wholly in the future under the causal mask, or wholly before the
// window) are never loaded: the loop runs only over the live tile range, the
// Pallas kernel's block skip.
#include <math.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBlockQ = 64;  // queries per block
constexpr int kBlockK = 32;  // keys per shared-memory tile

// How a head_dim D is split over the threads of one query. At most 8 lanes a
// query (512 threads a block, 128 registers a thread): D/32 would give 6 lanes
// at D = 192, which a warp's shuffles cannot group.
template <int D>
struct Split {
  static constexpr int kLanes = D < 64 ? 1 : (D <= 128 ? D / 32 : 8);  // threads per query
  static constexpr int kSlice = D / kLanes;            // dims per thread
  static constexpr int kPad = kLanes > 1 ? 4 : 0;      // floats between slices
  static constexpr int kRow = kLanes * (kSlice + kPad);  // floats per staged key row
  static constexpr int kSmemBytes = 2 * kBlockK * kRow * (int)sizeof(float);  // K and V tiles
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
  extern __shared__ __align__(16) float fa_smem[];
  float* ks = fa_smem;             // [kBlockK][kRow]
  float* vs = ks + kBlockK * kRow;  // [kBlockK][kRow]

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
  constexpr int kSmem = Split<D>::kSmemBytes;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(b * hq, (tq + kBlockQ - 1) / kBlockQ);
  flash_attention_kernel<T, D><<<grid, kBlockQ * Split<D>::kLanes, kSmem, stream>>>(
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
    case 192: return launch<T, 192>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    case 256: return launch<T, 256>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, window, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (b, hq, tq, d), k and v (b, hkv, tk, d), out like q; all contiguous, float32
// (bf16 = 0) or bfloat16 (bf16 = 1). window < 0 means no window. The caller
// checks d in {16, 24, 32, 64, 128, 192, 256} and hq % hkv == 0.
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
// Tensor-core instance: bf16 at D = 64 and 128, FlashAttention-2 layout.
//
// Design: grid (B*Hq, ceil(Tq/64)); a block of 4 warps owns 64 queries of one
// head, 16 rows a warp. Each warp keeps its Q rows in registers as m16n8k16 A
// fragments for the whole block. K and V tiles of 64 keys stay bf16 in shared
// memory, double-buffered with cp.async (zero-filled past Tk), each row padded
// by 16 bytes so that the 8 rows an ldmatrix phase reads fall in 8 different
// bank groups. Per tile a warp computes S = Q K^T (16 x 64, f32 accumulators)
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
// A block could serve all Hq/Hkv query heads of one KV head and use each
// staged K/V tile 5 times at Hymba's 25/5, but 5 heads' O accumulators, Q
// fragments and scores do not fit one thread's 255 registers at 4 warps; the
// 5 readers of a KV head find its tiles in the 50 MB L2 instead.
namespace {
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // queries per block
constexpr int kBlockK = 64;           // keys per staged tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int kRow = D + 8;              // bf16 per staged row (16 bytes of padding)
  static constexpr int kElems = kBlockK * kRow;   // bf16 per staged tile
  static constexpr int kSmemBytes = 2 * 2 * kElems * 2;  // K and V, two stages
  static_assert(D % 16 == 0 && (D / 16) % 2 == 0, "tensor-core head_dim must be 64 or 128");
};

// At D = 64 four blocks fit an SM once a thread keeps to 128 registers.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 4 : 2)
flash_attention_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int hq,
                   int hkv, int tq, int tk, float scale_log2, int causal, int window,
                   int q_offset) {
  using T = Tile<D>;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T
  constexpr int kDTiles = D / 8;  // n-tiles of P V
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBlockK][kRow]
  __nv_bfloat16* vs = ks + 2 * T::kElems;

  const int bh = blockIdx.x;  // batch * Hq + query head
  const int kv_row = (bh / hq) * hkv + (bh % hq) / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // last q-block first
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group, thread in group
  const int qw = q0 + warp * 16;          // the warp's first query row

  // Q rows qw+g and qw+g+8 as A fragments: {row g, row g+8} x {cols 2t4, 2t4+8}.
  unsigned qf[kSteps][4];
  {
    const __nv_bfloat16* qb = q + (size_t)bh * tq * D;
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

  if (kt_begin < kt_end) load_tile(kt_begin, 0);
  cp_async_commit();
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_tile(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this tile has landed; the next may be in flight
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys; one ldmatrix.x4 gives two k-steps' B.
    const __nv_bfloat16* kt_s = ks + stage * T::kElems;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int st = 0; st < kSteps; st += 2) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        unsigned b0, b1, b2, b3;
        ldsm_x4(smem_addr(kt_s + (8 * j + (lane & 7)) * T::kRow + st * 16 + (lane >> 3) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[j], qf[st], b0, b1);
        mma_bf16(s[j], qf[st + 1], b2, b3);
      }
    }

    // Scale into the log2 domain; mask only a tile that straddles an edge.
    const int k0 = kt * kBlockK;
    const bool edge = k0 + kBlockK > tk || (causal && k0 + kBlockK - 1 > w_lo) ||
                      (window >= 0 && w_hi - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;  // no live key yet: keep 0s
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
// {64, 128}, hq % hkv == 0 and ceil(tq / 64) < 65536.
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
    default: return (int)cudaErrorInvalidValue;
  }
}
