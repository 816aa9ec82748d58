// Mamba2 SSD (state-space duality) chunked scan with D skip for Hopper (sm_90a),
// as three launches over (batch*head, chunk), the split of Mamba2's own GPU
// kernels (Dao & Gu 2024).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan_pallas, one program per
// (batch*head) that walks the chunks in order with the (N, P) state carried in
// VMEM and the intra-chunk work as MXU matmuls. On a TPU the grid runs in order
// on one core, so that walk cost nothing; on the H100 it left 100 blocks of
// work for 132 SMs, 16 chunks in series inside each.
//
// What it computes, for x (B,T,H,P), dt (B,T,H), a (H,), B and C (B,T,G,N) and
// D (H,), with head h reading group g(h) = h / (H/G):
//   h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T,  y_t = C_t . h_t + D x_t
// from h_{-1} = 0, returning y (B,T,H,P) in x's dtype and the final state
// h (B,H,N,P) in float32 (ref.ssd_scan_ref's recurrence). Per chunk c of
// length L (the last may be shorter), with cum the inclusive cumsum of dt*a
// over the chunk and total its last value:
//   1. chunk state:   S_c = sum_j exp(total - cum_j) dt_j B_j x_j^T     (N, P)
//   2. state passing: H_c = exp(total_{c-1}) H_{c-1} + S_{c-1}, H_0 = 0,
//                     the state entering chunk c; the final state is H_nc
//   3. chunk scan:    y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
//                         + exp(cum_i) (C_i . H_c) + D x_i
// exp(cum_i - cum_j) is evaluated only for j <= i: above the diagonal the
// exponent is positive and may overflow. Every other exponent is <= 0.
//
// Scratch, allocated by the wrapper (kernels/ssd_scan.py): cd (B*H, nc, 2, Lp)
// float32, each chunk's cum and dt padded to Lp = L rounded up to 16 (the pad
// repeats total in cum and holds 0 in dt, so a padded key adds nothing), and
// states (B, H, nc, N, P) float32, S_c from phase 1 overwritten in place by
// H_c in phase 2.
//
// Bound on the H100 at the main path's shape (x (2,2048,50,64) bf16, N = 16,
// L = 128): bytes. x in and y out dominate, about 52 MB, 16 us at 3.35 TB/s;
// the arithmetic (about 3 GFLOP) is 3 us at the bf16 tensor-core rate. This
// design adds the scratch round trips (S_c written and read, H_c written and
// read: 26 MB) and reads x twice (phases 1 and 3; up to 26 MB more where L2
// does not keep it), a floor of some 23-31 us.
//
// What each phase does about the faults of the one-block-per-head design:
//   * too few blocks: phases 1 and 3 run B*H*nc blocks (1,600 at the path's
//     shape), phase 2 one thread per state element (102,400);
//   * chunks in series: only phase 2 walks the chunks, 16 dependent
//     multiply-adds a thread whose loads do not depend on the carry;
//   * a serial cumsum in one thread: phase 1 scans with warp shuffles;
//   * float32 products with both operands in shared memory: in bf16 phase 3
//     runs C B^T and the intra-chunk product on mma.sync m16n8k16, the scaled
//     S going from the accumulators straight into A fragments (the P V step of
//     flash_attention.cu's tensor-core instance); the float32 instance keeps
//     CUDA-core products but gives each thread a 4x4 register tile, so one
//     pair of 16-byte shared loads feeds 16 multiply-adds.
// Phase 1's S_c stays float32 on the CUDA cores in both instances: the weight
// exp(total - cum_j) dt_j, folded into a bf16 operand, would round the state,
// which is held at 3e-4 in bf16 too.
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kStateThreads = 128;  // phase 1
constexpr int kPassThreads = 256;   // phase 2
constexpr int kScanThreads = 256;   // phase 3, CUDA cores

__host__ __device__ __forceinline__ int round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float4 load4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// Stages rows [0, rows) of a (rows, width) slab of T, row r at src + r*src_stride,
// into shared memory at dst + r*dst_stride, zero-filling rows from len on.
// With vec (width and both strides whole 16-byte units, 16-byte aligned
// addresses) every thread issues 16-byte cp.async copies that the caller
// waits for; otherwise plain loads, zero-filling the columns from width to
// dst_stride too.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dst_stride, const T* src,
                                           size_t src_stride, int width, int len, int rows,
                                           bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const int units = width / kPer;
    // thread k copies unit k % units of rows k / units, k / units + step, ...
    const int step = max(1, (int)blockDim.x / units);
    for (int k = threadIdx.x; k < step * units; k += blockDim.x) {
      const int col = (k % units) * kPer;
      for (int r = k / units; r < rows; r += step) {
        const bool in = r < len;
        cp_async16(smem_addr(dst + r * dst_stride + col), src + (in ? r : 0) * src_stride + col,
                   in ? 16 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * dst_stride; e += blockDim.x) {
      const int r = e / dst_stride, col = e % dst_stride;
      if (r < len && col < width)
        dst[e] = src[r * src_stride + col];
      else
        store(dst + e, 0.f);
    }
  }
}

// Whether rows of width elements of T at base can be staged with cp.async.
template <typename T>
bool vec_rows(const void* base, int width, size_t stride) {
  return (width * sizeof(T)) % 16 == 0 && (stride * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

constexpr int kMaxSplit = 4;  // phase 1: thread groups splitting a chunk's j

// Floats of phase 1's w_j B_j region, which later holds the groups' partial
// sums too.
__host__ __device__ __forceinline__ int state_wbs_floats(int lp, int n4) {
  return max(lp * n4, 16 * kStateThreads);
}

// Stores a 4 x 4 tile of S_c at rows s0.., columns c0.. of the (n, p) slab so.
__device__ __forceinline__ void store_state_tile(float* so, const float (&acc)[4][4], int s0,
                                                 int c0, int n, int p) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (s0 + r >= n) continue;
    float* row = so + (s0 + r) * p;
    if (p % 4 == 0) {  // whole 16-byte units: the slab starts 16-byte aligned
      *reinterpret_cast<float4*>(row + c0) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c0 + q < p) row[c0 + q] = acc[r][q];
    }
  }
}

// Phase 1: one block per (batch*head, chunk).
template <typename T>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm, float* __restrict__ cd,
                float* __restrict__ states, int t, int h, int p, int g, int n, int chunk,
                int vec_x, int vec_b) {
  const int lp = round_up(chunk, 16), p4 = round_up(p, 4), n4 = round_up(n, 4);
  extern __shared__ __align__(16) float sm1[];
  float* wbs = sm1;  // (lp, n4) w_j B_j in float32, zero-padded; then the partial sums
  float* dts = wbs + state_wbs_floats(lp, n4);  // (lp,) dt, then w
  float* cum = dts + lp;                         // (lp,)
  float* wsum = cum + lp;                        // (32,) per-warp totals of the scan
  T* xs = reinterpret_cast<T*>(wsum + 32);       // (lp, p4) x, zero-padded
  T* bs = xs + lp * p4;                          // (lp, n4) B, zero-padded

  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / h, hd = bh % h, grp = hd / (h / g);
  const int t0 = c * chunk, len = min(chunk, t - t0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float av = a[hd];

  stage_rows(xs, p4, x + (((size_t)b * t + t0) * h + hd) * p, (size_t)h * p, p, len, lp,
             vec_x);
  stage_rows(bs, n4, bm + (((size_t)b * t + t0) * g + grp) * n, (size_t)g * n, n, len, lp,
             vec_b);
  cp_async_commit();
  for (int j = tid; j < lp; j += kStateThreads)
    dts[j] = j < len ? dt[((size_t)b * t + t0 + j) * h + hd] : 0.f;
  __syncthreads();

  // Inclusive cumsum of dt*a: warp shuffles, then the warps' totals. Padded
  // entries add 0, so cum past len repeats total.
  float carry = 0.f;
  for (int base = 0; base < lp; base += kStateThreads) {
    const int j = base + tid;
    float v = j < lp ? dts[j] * av : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    float pre = carry, round_total = 0.f;
    for (int w = 0; w < kStateThreads / 32; ++w) {
      pre += w < warp ? wsum[w] : 0.f;
      round_total += wsum[w];
    }
    if (j < lp) cum[j] = v + pre;
    carry += round_total;
    __syncthreads();
  }
  const float total = cum[lp - 1];

  float* cdo = cd + ((size_t)bh * nc + c) * 2 * lp;
  for (int j = tid; j < lp; j += kStateThreads) {  // the same thread reads and rewrites dts[j]
    cdo[j] = cum[j];
    cdo[lp + j] = dts[j];
    dts[j] = expf(total - cum[j]) * dts[j];  // w_j; 0 past len
  }
  cp_async_wait_all();
  __syncthreads();
  const int wstep = max(1, kStateThreads / n4);  // thread k takes column k % n4, every wstep-th row
  for (int k = tid; k < wstep * n4; k += kStateThreads)
    for (int j = k / n4; j < lp; j += wstep) wbs[j * n4 + k % n4] = dts[j] * to_f32(bs[j * n4 + k % n4]);
  __syncthreads();

  // S_c = sum_j (w_j B_j) x_j^T in 4 x 4 register tiles (two 16-byte shared
  // loads a 16 multiply-adds). Where the tiles are fewer than the threads,
  // `groups` thread groups take interleaved j and sum through shared memory.
  float* so = states + ((size_t)bh * nc + c) * n * p;
  const int pq = p4 / 4, tiles = (n4 / 4) * pq;
  const int groups = tiles >= kStateThreads ? 1 : min(kMaxSplit, kStateThreads / tiles);
  const int jg = tid / tiles;  // 0 where groups == 1
  float acc[4][4] = {};
  int tile = tid % tiles;
  for (int e = tid; e < tiles * groups; e += kStateThreads) {  // once a thread if groups > 1
    tile = e % tiles;
    const int s0 = (tile / pq) * 4, c0 = (tile % pq) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    for (int j = jg; j < len; j += groups) {
      const float4 wv = *reinterpret_cast<const float4*>(wbs + j * n4 + s0);
      const float4 xv = load4(xs + j * p4 + c0);
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w}, xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wa[r], xa[q], acc[r][q]);
    }
    if (groups == 1) store_state_tile(so, acc, s0, c0, n, p);
  }
  if (groups == 1) return;
  __syncthreads();  // every thread is done with wbs
  float* part = wbs;  // (groups, tiles, 16)
  if (tid < tiles * groups) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[(jg * tiles + tile) * 16 + 4 * r + q] = acc[r][q];
  }
  __syncthreads();
  if (tid < tiles) {
    const int s0 = (tid / pq) * 4, c0 = (tid % pq) * 4;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = part[tid * 16 + 4 * r + q];
        for (int k = 1; k < groups; ++k) v += part[(k * tiles + tid) * 16 + 4 * r + q];
        acc[r][q] = v;
      }
    store_state_tile(so, acc, s0, c0, n, p);
  }
}

// Phase 2: one thread per (batch*head, state element) walks the chunks.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_passing(const float* __restrict__ cd, float* __restrict__ states,
                  float* __restrict__ hout, int bh_count, int nc, int np, int lp) {
  const size_t e = (size_t)blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= (size_t)bh_count * np) return;
  const size_t bh = e / np, el = e % np;
  float* sp = states + bh * nc * np + el;
  const float* tot = cd + bh * nc * 2 * lp + (lp - 1);  // cum's last entry is total
  // Loads kBatch chunks ahead of the carry: they do not depend on it, and
  // the stores in between would otherwise keep them in order.
  constexpr int kBatch = 8;
  float hcur = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float sv[kBatch], dv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const bool in = c0 + k < nc;
      sv[k] = in ? sp[(size_t)(c0 + k) * np] : 0.f;
      dv[k] = in ? tot[(size_t)(c0 + k) * 2 * lp] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k >= nc) break;
      sp[(size_t)(c0 + k) * np] = hcur;  // the state entering chunk c0 + k
      hcur = fmaf(expf(dv[k]), hcur, sv[k]);
    }
  }
  hout[e] = hcur;
}

// Phase 3, CUDA-core instance: float32 products in 4x4 register tiles. C, B
// are staged transposed (N, Lp) and G = (C B^T . decay . dt) transposed
// (Lp, Lp), so that four consecutive rows are one 16-byte load.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ cd, const T* __restrict__ cm,
               const T* __restrict__ bm, const float* __restrict__ dskip,
               const float* __restrict__ states, T* __restrict__ y, int t, int h, int p, int g,
               int n, int chunk, int vec_x) {
  const int lp = round_up(chunk, 16), p4 = round_up(p, 4);
  extern __shared__ __align__(16) float sm3[];
  float* ct = sm3;             // (n, lp)
  float* bt = ct + n * lp;     // (n, lp)
  float* gt = bt + n * lp;     // (lp, lp): gt[j][i] = G[i][j], zero above the diagonal
  float* hs = gt + lp * lp;    // (n, p4) state entering the chunk
  float* cum = hs + n * p4;    // (lp,)
  float* dts = cum + lp;       // (lp,)
  T* xs = reinterpret_cast<T*>(dts + lp);  // (lp, p4)

  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / h, hd = bh % h, grp = hd / (h / g);
  const int t0 = c * chunk, len = min(chunk, t - t0);
  const int tid = threadIdx.x;
  const float dv = dskip[hd];

  stage_rows(xs, p4, x + (((size_t)b * t + t0) * h + hd) * p, (size_t)h * p, p, len, lp,
             vec_x);
  cp_async_commit();
  const float* cdi = cd + ((size_t)bh * nc + c) * 2 * lp;
  for (int j = tid; j < 2 * lp; j += kScanThreads) cum[j] = cdi[j];  // cum, then dts
#pragma unroll 4
  for (int e = tid; e < n * lp; e += kScanThreads) {
    const int s = e / lp, j = e % lp;
    const size_t src = (((size_t)b * t + t0 + j) * g + grp) * n + s;
    ct[e] = j < len ? to_f32(cm[src]) : 0.f;
    bt[e] = j < len ? to_f32(bm[src]) : 0.f;
  }
  const float* hi = states + ((size_t)bh * nc + c) * n * p;
  for (int e = tid; e < n * p4; e += kScanThreads) {
    const int s = e / p4, col = e % p4;
    hs[e] = col < p ? hi[s * p + col] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // G in 4x4 tiles of the lower triangle; consecutive threads take
  // consecutive row quads, so each stores one contiguous row of gt.
  const int nq = lp / 4;
  for (int e = tid; e < nq * nq; e += kScanThreads) {
    const int tj = e / nq, ti = e % nq;
    if (tj > ti) continue;
    const int i0 = 4 * ti, j0 = 4 * tj;
    float acc[4][4] = {};
    for (int s = 0; s < n; ++s) {
      const float4 cv = *reinterpret_cast<const float4*>(ct + s * lp + i0);
      const float4 bv = *reinterpret_cast<const float4*>(bt + s * lp + j0);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w}, ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ca[r], ba[q], acc[r][q]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      float out[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        out[r] = j <= i ? acc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
      }
      *reinterpret_cast<float4*>(gt + j * lp + i0) = make_float4(out[0], out[1], out[2], out[3]);
    }
  }
  __syncthreads();

  // y in 4x4 tiles: intra (G X over j <= i), inter (C H), skip (D x).
  const int pq = p4 / 4;
  for (int e = tid; e < nq * pq; e += kScanThreads) {
    const int i0 = (e / pq) * 4, c0 = (e % pq) * 4;
    if (i0 >= len) continue;
    float acc[4][4] = {}, inter[4][4] = {};
    const int jend = min(i0 + 4, len);
    for (int j = 0; j < jend; ++j) {
      const float4 gv = *reinterpret_cast<const float4*>(gt + j * lp + i0);
      const float4 xv = load4(xs + j * p4 + c0);
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w}, xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ga[r], xa[q], acc[r][q]);
    }
    for (int s = 0; s < n; ++s) {
      const float4 cv = *reinterpret_cast<const float4*>(ct + s * lp + i0);
      const float4 hv = *reinterpret_cast<const float4*>(hs + s * p4 + c0);
      const float ca[4] = {cv.x, cv.y, cv.z, cv.w}, ha[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) inter[r][q] = fmaf(ca[r], ha[q], inter[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      if (i >= len) break;
      const float ec = expf(cum[i]);
      T* yo = y + (((size_t)b * t + t0 + i) * h + hd) * p;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int col = c0 + q;
        if (col < p)
          store(yo + col, acc[r][q] + ec * inter[r][q] + dv * to_f32(xs[i * p4 + col]));
      }
    }
  }
}

// Phase 3, tensor-core instance (bf16, N a multiple of 16, P in {16, 32, 64,
// 128}). A block of 4 warps owns one chunk; row tile q (16 rows) goes with row
// tile nrt-1-q to one warp, so every warp walks about the same number of key
// tiles under the causal mask. X, B and C stay bf16 in shared memory, rows
// padded by 16 bytes so that the 8 rows an ldmatrix phase reads fall in 8
// different bank groups. Per key tile of 16 (none above the warp's diagonal):
// S = C B^T on mma.sync, scaled in its f32 accumulators by
// exp(cum_i - cum_j) dt_j where j <= i (0 elsewhere), packed to bf16 A
// fragments and multiplied with X through ldmatrix.trans, onto accumulators
// that start from the inter-chunk term exp(cum_i) C_i . H_c, float32
// multiply-adds in registers, as is the skip.
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;

// At P <= 64 five blocks fit an SM within 102 registers a thread; P = 128
// would spill there and takes two.
template <int P>
__global__ void __launch_bounds__(kTcThreads, P <= 64 ? 5 : 2)
ssd_chunk_scan_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ cd,
                  const __nv_bfloat16* __restrict__ cm, const __nv_bfloat16* __restrict__ bm,
                  const float* __restrict__ dskip, const float* __restrict__ states,
                  __nv_bfloat16* __restrict__ y, int t, int h, int g, int n, int chunk) {
  constexpr int kXRow = P + 8;  // bf16 per staged x row
  constexpr int kPTiles = P / 8;
  static_assert(P % 16 == 0, "tensor-core P must be a multiple of 16");
  const int lp = round_up(chunk, 16), nrow = n + 8;  // bf16 per staged B / C row
  extern __shared__ __align__(16) unsigned char sm_tc[];
  float* hs = reinterpret_cast<float*>(sm_tc);  // (n, P) state entering the chunk
  float* cum = hs + n * P;                      // (lp,)
  float* dts = cum + lp;                        // (lp,)
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dts + lp);  // (lp, kXRow)
  __nv_bfloat16* bs = xs + lp * kXRow;                              // (lp, nrow)
  __nv_bfloat16* cs = bs + lp * nrow;                               // (lp, nrow)

  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / h, hd = bh % h, grp = hd / (h / g);
  const int t0 = c * chunk, len = min(chunk, t - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;  // fragment row group, thread in group

  // Stage everything with 16-byte cp.async; rows past len are zero-filled.
  const float* hi = states + ((size_t)bh * nc + c) * n * P;
  for (int e = tid; e < n * P / 4; e += kTcThreads) cp_async16(smem_addr(hs + 4 * e), hi + 4 * e, 16);
  const float* cdi = cd + ((size_t)bh * nc + c) * 2 * lp;
  for (int e = tid; e < 2 * lp / 4; e += kTcThreads)
    cp_async16(smem_addr(cum + 4 * e), cdi + 4 * e, 16);  // cum, then dts
  stage_rows(xs, kXRow, x + (((size_t)b * t + t0) * h + hd) * P, (size_t)h * P, P, len, lp,
             true);
  const size_t bc0 = (((size_t)b * t + t0) * g + grp) * n;
  stage_rows(bs, nrow, bm + bc0, (size_t)g * n, n, len, lp, true);
  stage_rows(cs, nrow, cm + bc0, (size_t)g * n, n, len, lp, true);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const float dv = dskip[hd];
  const int nrt = lp / 16, ksteps = n / 16;
  auto row_tile = [&](int rt) {
    const int i0 = 16 * rt;
    if (i0 >= len) return;
    const float cum_r[2] = {cum[i0 + gr], cum[i0 + gr + 8]};
    // The accumulators start from the inter-chunk term exp(cum_i) C_i . H_c,
    // in float32 (rows gr and gr+8 share each load of H); the intra-chunk
    // products then add onto it.
    float o[kPTiles][4];
#pragma unroll
    for (int nt = 0; nt < kPTiles; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
    for (int sidx = 0; sidx < n; ++sidx) {
      const float cv0 = __bfloat162float(cs[(i0 + gr) * nrow + sidx]);
      const float cv1 = __bfloat162float(cs[(i0 + gr + 8) * nrow + sidx]);
#pragma unroll
      for (int nt = 0; nt < kPTiles; ++nt) {
        const float2 hv = *reinterpret_cast<const float2*>(hs + sidx * P + 8 * nt + 2 * t4);
        o[nt][0] = fmaf(cv0, hv.x, o[nt][0]);
        o[nt][1] = fmaf(cv0, hv.y, o[nt][1]);
        o[nt][2] = fmaf(cv1, hv.x, o[nt][2]);
        o[nt][3] = fmaf(cv1, hv.y, o[nt][3]);
      }
    }
    {
      const float ec0 = expf(cum_r[0]), ec1 = expf(cum_r[1]);
#pragma unroll
      for (int nt = 0; nt < kPTiles; ++nt) {
        o[nt][0] *= ec0;
        o[nt][1] *= ec0;
        o[nt][2] *= ec1;
        o[nt][3] *= ec1;
      }
    }

    const int kt_end = min(rt, (len - 1) / 16);  // key tiles past len hold only zeros
    for (int kt = 0; kt <= kt_end; ++kt) {
      const int k0 = 16 * kt;
      float s[2][4] = {};
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a[4], b0, b1, b2, b3;
        ldsm_x4(smem_addr(cs + (i0 + (lane & 7) + ((lane >> 3) & 1) * 8) * nrow + ks * 16 +
                          (lane >> 4) * 8),
                a[0], a[1], a[2], a[3]);
        ldsm_x4(smem_addr(bs + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * nrow + ks * 16 +
                          ((lane >> 3) & 1) * 8),
                b0, b1, b2, b3);
        mma_bf16(s[0], a, b0, b1);
        mma_bf16(s[1], a, b2, b3);
      }
      // decay and dt in the accumulators; exp only where j <= i
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = k0 + 8 * nt + 2 * t4;
        const float2 cj = *reinterpret_cast<const float2*>(cum + j);
        const float2 dj = *reinterpret_cast<const float2*>(dts + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0 + gr + (e >= 2 ? 8 : 0), jj = j + (e & 1);
          const float cjj = (e & 1) ? cj.y : cj.x, djj = (e & 1) ? dj.y : dj.x;
          s[nt][e] = jj <= i ? s[nt][e] * __expf(cum_r[e >> 1] - cjj) * djj : 0.f;
        }
      }
      const unsigned a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                             pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
      for (int nt = 0; nt < kPTiles; nt += 2) {
        unsigned b0, b1, b2, b3;
        const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(smem_addr(xs + row * kXRow + 8 * nt + (lane >> 4) * 8), b0, b1, b2, b3);
        mma_bf16(o[nt], a, b0, b1);
        mma_bf16(o[nt + 1], a, b2, b3);
      }
    }

    // the skip, and y as bf16 pairs
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + gr + 8 * r;
      if (i >= len) continue;
      unsigned* yo = reinterpret_cast<unsigned*>(y + (((size_t)b * t + t0 + i) * h + hd) * P);
#pragma unroll
      for (int nt = 0; nt < kPTiles; ++nt) {
        const int col = 8 * nt + 2 * t4;
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xs + i * kXRow + col);
        const float y0 = o[nt][2 * r] + dv * __low2float(xv);
        const float y1 = o[nt][2 * r + 1] + dv * __high2float(xv);
        yo[col / 2] = pack_bf16(y0, y1);
      }
    }
  };
  for (int q = warp; q < (nrt + 1) / 2; q += kTcWarps) {
    row_tile(q);
    if (nrt - 1 - q != q) row_tile(nrt - 1 - q);
  }
}

template <typename T>
size_t state_smem(int chunk, int p, int n) {
  const int lp = round_up(chunk, 16), n4 = round_up(n, 4);
  return sizeof(float) * ((size_t)state_wbs_floats(lp, n4) + 2 * lp + 32) +
         sizeof(T) * ((size_t)lp * round_up(p, 4) + (size_t)lp * n4);
}

template <typename T>
size_t scan_smem(int chunk, int p, int n) {
  const int lp = round_up(chunk, 16), p4 = round_up(p, 4);
  return sizeof(float) * (2 * (size_t)n * lp + (size_t)lp * lp + (size_t)n * p4 + 2 * lp) +
         sizeof(T) * (size_t)lp * p4;
}

size_t scan_tc_smem(int chunk, int p, int n) {
  const int lp = round_up(chunk, 16);
  return sizeof(float) * ((size_t)n * p + 2 * lp) +
         sizeof(__nv_bfloat16) * ((size_t)lp * (p + 8) + 2 * (size_t)lp * (n + 8));
}

// Asks for the largest shared-memory carveout (more blocks an SM) and raises
// the kernel's dynamic shared memory limit where it needs more than 48 KB.
template <typename K>
int allow_smem(K kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || smem <= 48 * 1024) return (int)err;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

template <typename T>
int chunk_state(const void* x, const float* dt, const float* a, const void* bm, float* cd,
                float* states, int b, int t, int h, int p, int g, int n, int chunk,
                cudaStream_t stream) {
  const size_t smem = state_smem<T>(chunk, p, n);
  if (int err = allow_smem(ssd_chunk_state<T>, smem)) return err;
  const dim3 grid(b * h, (t + chunk - 1) / chunk);
  ssd_chunk_state<T><<<grid, kStateThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm), cd, states, t, h, p, g, n,
      chunk, vec_rows<T>(x, p, (size_t)h * p), vec_rows<T>(bm, n, (size_t)g * n));
  return (int)cudaGetLastError();
}

template <typename T>
int chunk_scan(const void* x, const float* cd, const void* cm, const void* bm,
               const float* dskip, const float* states, void* y, int b, int t, int h, int p,
               int g, int n, int chunk, cudaStream_t stream) {
  const size_t smem = scan_smem<T>(chunk, p, n);
  if (int err = allow_smem(ssd_chunk_scan<T>, smem)) return err;
  const dim3 grid(b * h, (t + chunk - 1) / chunk);
  ssd_chunk_scan<T><<<grid, kScanThreads, smem, stream>>>(
      static_cast<const T*>(x), cd, static_cast<const T*>(cm), static_cast<const T*>(bm), dskip,
      states, static_cast<T*>(y), t, h, p, g, n, chunk, vec_rows<T>(x, p, (size_t)h * p));
  return (int)cudaGetLastError();
}

template <int P>
int chunk_scan_tc(const void* x, const float* cd, const void* cm, const void* bm,
                  const float* dskip, const float* states, void* y, int b, int t, int h, int g,
                  int n, int chunk, cudaStream_t stream) {
  const size_t smem = scan_tc_smem(chunk, P, n);
  if (int err = allow_smem(ssd_chunk_scan_tc<P>, smem)) return err;
  const dim3 grid(b * h, (t + chunk - 1) / chunk);
  ssd_chunk_scan_tc<P><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), cd, static_cast<const __nv_bfloat16*>(cm),
      static_cast<const __nv_bfloat16*>(bm), dskip, states, static_cast<__nv_bfloat16*>(y), t, h,
      g, n, chunk);
  return (int)cudaGetLastError();
}

int state_passing(const float* cd, float* states, float* hout, int bh, int nc, int np, int lp,
                  cudaStream_t stream) {
  const size_t threads = (size_t)bh * np;
  const unsigned blocks = (unsigned)((threads + kPassThreads - 1) / kPassThreads);
  ssd_state_passing<<<blocks, kPassThreads, 0, stream>>>(cd, states, hout, bh, nc, np, lp);
  return (int)cudaGetLastError();
}

int chunk_scan_any(const void* x, const float* cd, const void* cm, const void* bm,
                   const float* dskip, const float* states, void* y, int b, int t, int h, int p,
                   int g, int n, int chunk, int bf16, int tc, cudaStream_t stream) {
  if (tc) {
    switch (p) {
      case 16: return chunk_scan_tc<16>(x, cd, cm, bm, dskip, states, y, b, t, h, g, n, chunk, stream);
      case 32: return chunk_scan_tc<32>(x, cd, cm, bm, dskip, states, y, b, t, h, g, n, chunk, stream);
      case 64: return chunk_scan_tc<64>(x, cd, cm, bm, dskip, states, y, b, t, h, g, n, chunk, stream);
      case 128: return chunk_scan_tc<128>(x, cd, cm, bm, dskip, states, y, b, t, h, g, n, chunk, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (bf16)
    return chunk_scan<__nv_bfloat16>(x, cd, cm, bm, dskip, states, y, b, t, h, p, g, n, chunk,
                                     stream);
  return chunk_scan<float>(x, cd, cm, bm, dskip, states, y, b, t, h, p, g, n, chunk, stream);
}

}  // namespace

// The three phases, launched in order on one stream. x (b,t,h,p), B and C
// (b,t,g,n) and y (b,t,h,p) in float32 (bf16 = 0) or bfloat16 (bf16 = 1); dt
// (b,t,h), a (h,), dskip (h,), the scratch cd (b*h, nc, 2, lp) and states
// (b,h,nc,n,p), and hout (b,h,n,p) in float32; all contiguous, with
// nc = ceil(t / chunk) < 65536, lp = chunk rounded up to 16, t >= 1 and
// h % g == 0 (the caller checks). tc = 1 takes the tensor-core chunk scan:
// bf16, n a multiple of 16, p in {16, 32, 64, 128}, x, B and C 16-byte
// aligned (the caller checks). events, if not null, holds four cudaEvent_t
// recorded on the stream before the first phase and after each.
extern "C" int rt_ssd_scan(const void* x, const float* dt, const float* a, const void* bm,
                           const void* cm, const float* dskip, float* cd, float* states, void* y,
                           float* hout, int b, int t, int h, int p, int g, int n, int chunk,
                           int bf16, int tc, void* const* events, cudaStream_t stream) {
  auto mark = [&](int i) {
    return events ? (int)cudaEventRecord(static_cast<cudaEvent_t>(events[i]), stream) : 0;
  };
  const int nc = (t + chunk - 1) / chunk, lp = round_up(chunk, 16);
  if (int err = mark(0)) return err;
  if (int err = bf16 ? chunk_state<__nv_bfloat16>(x, dt, a, bm, cd, states, b, t, h, p, g, n,
                                                  chunk, stream)
                     : chunk_state<float>(x, dt, a, bm, cd, states, b, t, h, p, g, n, chunk,
                                          stream))
    return err;
  if (int err = mark(1)) return err;
  if (int err = state_passing(cd, states, hout, b * h, nc, n * p, lp, stream)) return err;
  if (int err = mark(2)) return err;
  if (int err = chunk_scan_any(x, cd, cm, bm, dskip, states, y, b, t, h, p, g, n, chunk, bf16,
                               tc, stream))
    return err;
  return mark(3);
}
