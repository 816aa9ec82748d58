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
//   * float32 products with both operands in shared memory: in bf16 phases 1
//     and 3 run their products on mma.sync m16n8k16 (the tensor-core
//     instance below), every operand that is not bf16 already (w_j B_j, the
//     state H_c, the scaled C B^T) as a hi and a lo bf16 part, so that it
//     keeps some 16 bits and the state stays within 3e-4; the float32
//     instance keeps CUDA-core products but gives each thread a 4x4 register
//     tile, so one pair of 16-byte shared loads feeds 16 multiply-adds.
// At mamba2-2.7b's shape (x (2,2048,80,64) bf16, N = 128) the float32
// states written by phase 1, rewritten by phase 2 and read by phase 3 are 84
// MB each way; they, not the 10.7 GFLOP of products, bound this design.
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

// The chunk's inclusive cumsum of dt*a into cum, by warp shuffles, then the
// warps' totals; dts holds dt, zero past len, so cum past len repeats the
// total. Writes cum and dt to cdo (the chunk's row of the scratch cd) and
// turns dts into the weights w_j = exp(total - cum_j) dt_j (0 past len). A
// block of kStateThreads calls it, all threads at once.
__device__ __forceinline__ void chunk_weights(float* dts, float* cum, float* wsum, float av,
                                              int lp, float* cdo) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
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
  for (int j = tid; j < lp; j += kStateThreads) {  // the same thread reads and rewrites dts[j]
    cdo[j] = cum[j];
    cdo[lp + j] = dts[j];
    dts[j] = expf(total - cum[j]) * dts[j];
  }
}

// Splits the pair (x0, x1) into two bf16 pairs, hi (x rounded) and lo (what
// that rounding left, rounded again): hi + lo is x to about 2^-16 relative.
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// Phase 1, CUDA-core instance: one block per (batch*head, chunk).
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
  const int tid = threadIdx.x;
  const float av = a[hd];

  stage_rows(xs, p4, x + (((size_t)b * t + t0) * h + hd) * p, (size_t)h * p, p, len, lp,
             vec_x);
  stage_rows(bs, n4, bm + (((size_t)b * t + t0) * g + grp) * n, (size_t)g * n, n, len, lp,
             vec_b);
  cp_async_commit();
  for (int j = tid; j < lp; j += kStateThreads)
    dts[j] = j < len ? dt[((size_t)b * t + t0 + j) * h + hd] : 0.f;
  __syncthreads();

  chunk_weights(dts, cum, wsum, av, lp, cd + ((size_t)bh * nc + c) * 2 * lp);
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
// (Lp, Lp), so that four consecutive rows are one 16-byte load. Once G is made
// B^T is not read again, and the (N, P) state entering the chunk is loaded
// into its room: at N = 128 (mamba2-2.7b), P = 64 and L = 128 that keeps the
// block at 230,400 bytes, where separate rooms would need 263,168, above the
// 232,448 a block may have.
template <typename T>
__global__ void __launch_bounds__(kScanThreads)
ssd_chunk_scan(const T* __restrict__ x, const float* __restrict__ cd, const T* __restrict__ cm,
               const T* __restrict__ bm, const float* __restrict__ dskip,
               const float* __restrict__ states, T* __restrict__ y, int t, int h, int p, int g,
               int n, int chunk, int vec_x) {
  const int lp = round_up(chunk, 16), p4 = round_up(p, 4);
  extern __shared__ __align__(16) float sm3[];
  float* ct = sm3;             // (n, lp)
  float* bt = ct + n * lp;     // (n, lp) until G is made
  float* hs = bt;              // then (n, p4): the state entering the chunk
  float* gt = bt + max(n * lp, n * p4);  // (lp, lp): gt[j][i] = G[i][j], zero above the diagonal
  float* cum = gt + lp * lp;   // (lp,)
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
  __syncthreads();  // B^T is done with: the state takes its room

  const float* hi = states + ((size_t)bh * nc + c) * n * p;
  for (int e = tid; e < n * p4; e += kScanThreads) {
    const int s = e / p4, col = e % p4;
    hs[e] = col < p ? hi[s * p + col] : 0.f;
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

// The tensor-core instance (bf16, N in {16, 32, 64, 128}, P in {16, 32, 64,
// 128}): phases 1 and 3 on mma.sync m16n8k16 with float32 accumulators, by
// blocks of 4 warps. X, B and C stay bf16 (exact as operands); what is not
// bf16 (w_j B_j in phase 1, the state H_c in phase 3, the scaled C B^T) is
// split into a hi and a lo bf16 part (split_bf16) and multiplied twice, which
// keeps some 16 bits of it where one bf16 rounding keeps 8: the state stays
// within 3e-4, as in float32. Staged rows are padded by 16 bytes so that the
// 8 rows an ldmatrix phase reads fall in 8 different bank groups.
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
static_assert(kTcThreads == kStateThreads, "phase 1's cumsum takes kStateThreads threads");

// Phase 1, tensor-core instance: S_c = (w . B)^T X, an (N x Lp) by (Lp x P)
// product. Warp w takes the 16-row tiles w, w + 4, ... of S_c (the states s);
// per 16-key step it reads its A fragment of B^T by ldmatrix.trans from the
// staged B (Lp, N+8), scales each element by w_j in float32 and splits it
// (two products), and reads X's B fragments by ldmatrix.trans as phase 3
// does. At mamba2-2.7b's chunk 128, P 64, N 128 a block holds 54,400 bytes of
// shared memory (x, B, dt and cum), four blocks an SM.
template <int P>
__global__ void __launch_bounds__(kTcThreads, 4)
ssd_chunk_state_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
                   float* __restrict__ cd, float* __restrict__ states, int t, int h, int g,
                   int n, int chunk) {
  constexpr int kXRow = P + 8;  // bf16 per staged x row
  constexpr int kPTiles = P / 8;
  const int lp = round_up(chunk, 16), nrow = n + 8;  // bf16 per staged B row
  extern __shared__ __align__(16) unsigned char sm_st[];
  float* dts = reinterpret_cast<float*>(sm_st);  // (lp,) dt, then w
  float* cum = dts + lp;                         // (lp,)
  float* wsum = cum + lp;                        // (32,) per-warp totals of the scan
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(wsum + 32);  // (lp, kXRow)
  __nv_bfloat16* bs = xs + lp * kXRow;                               // (lp, nrow)

  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / h, hd = bh % h, grp = hd / (h / g);
  const int t0 = c * chunk, len = min(chunk, t - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;  // fragment row group, thread in group

  stage_rows(xs, kXRow, x + (((size_t)b * t + t0) * h + hd) * P, (size_t)h * P, P, len, lp,
             true);
  stage_rows(bs, nrow, bm + (((size_t)b * t + t0) * g + grp) * n, (size_t)g * n, n, len, lp,
             true);
  cp_async_commit();
  for (int j = tid; j < lp; j += kTcThreads)
    dts[j] = j < len ? dt[((size_t)b * t + t0 + j) * h + hd] : 0.f;
  __syncthreads();
  chunk_weights(dts, cum, wsum, a[hd], lp, cd + ((size_t)bh * nc + c) * 2 * lp);
  cp_async_wait_all();
  __syncthreads();

  float* so = states + ((size_t)bh * nc + c) * n * P;
  const int ksteps = (len + 15) / 16;  // key steps past len hold only zeros
  for (int mt = warp; mt < n / 16; mt += kTcWarps) {
    float acc[kPTiles][4];
#pragma unroll
    for (int nt = 0; nt < kPTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = 16 * ks;
      // A = (w . B)^T over keys k0..k0+15: matrices (s 0-7 | 8-15) x (j 0-7 | 8-15)
      // of the staged B, transposed on load, so a0..a3 hold (s, j) pairs along j
      unsigned raw[4];
      ldsm_x4_trans(smem_addr(bs + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * nrow + mt * 16 +
                              ((lane >> 3) & 1) * 8),
                    raw[0], raw[1], raw[2], raw[3]);
      const float2 w_lo = *reinterpret_cast<const float2*>(dts + k0 + 2 * t4);
      const float2 w_hi = *reinterpret_cast<const float2*>(dts + k0 + 8 + 2 * t4);
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 wv = e < 2 ? w_lo : w_hi;
        const float2 bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[e]));
        split_bf16(bv.x * wv.x, bv.y * wv.y, ahi[e], alo[e]);
      }
#pragma unroll
      for (int nt = 0; nt < kPTiles; nt += 2) {
        unsigned b0, b1, b2, b3;
        const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(smem_addr(xs + row * kXRow + 8 * nt + (lane >> 4) * 8), b0, b1, b2, b3);
        mma_bf16(acc[nt], ahi, b0, b1);
        mma_bf16(acc[nt], alo, b0, b1);
        mma_bf16(acc[nt + 1], ahi, b2, b3);
        mma_bf16(acc[nt + 1], alo, b2, b3);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kPTiles; ++nt) {
      const int col = 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(so + (mt * 16 + gr) * P + col) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(so + (mt * 16 + gr + 8) * P + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// Phase 3, tensor-core instance. A block owns one chunk; row tile q (16 rows)
// goes with row tile nrt-1-q to one warp, so every warp walks about the same
// number of key tiles under the causal mask. Per row tile the warp loads C's
// A fragments for every k-step into registers once, from device memory (C is
// one group's, shared by the heads, and stays in L2); they serve both
// products:
//   * inter-chunk: the accumulators start from C_i (H_hi + H_lo), H_c staged
//     as its two bf16 parts and read by ldmatrix.trans, then scaled by
//     exp(cum_i) in float32;
//   * intra-chunk, per key tile of 16 (none above the warp's diagonal): S = C
//     B^T, scaled in its f32 accumulators by exp(cum_i - cum_j) dt_j where j
//     <= i (0 elsewhere), split into hi and lo A fragments and multiplied with
//     X through ldmatrix.trans onto the same accumulators;
// then the skip D x in float32. Shared memory holds H's parts, x, B, cum and
// dt: 91,136 bytes at mamba2-2.7b's chunk 128, P 64, N 128, two blocks an SM.
template <int N, int P>
__global__ void __launch_bounds__(kTcThreads, N <= 32 && P <= 64 ? 5 : 2)
ssd_chunk_scan_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ cd,
                  const __nv_bfloat16* __restrict__ cm, const __nv_bfloat16* __restrict__ bm,
                  const float* __restrict__ dskip, const float* __restrict__ states,
                  __nv_bfloat16* __restrict__ y, int t, int h, int g, int chunk) {
  constexpr int kXRow = P + 8;  // bf16 per staged x or H row
  constexpr int kBRow = N + 8;  // bf16 per staged B row
  constexpr int kPTiles = P / 8, kSteps = N / 16;
  static_assert(P % 16 == 0 && N % 16 == 0, "tensor-core P and N are multiples of 16");
  const int lp = round_up(chunk, 16);
  extern __shared__ __align__(16) unsigned char sm_tc[];
  float* cum = reinterpret_cast<float*>(sm_tc);                   // (lp,)
  float* dts = cum + lp;                                          // (lp,)
  __nv_bfloat16* hh = reinterpret_cast<__nv_bfloat16*>(dts + lp);  // (N, kXRow) H_c's hi part
  __nv_bfloat16* hl = hh + N * kXRow;                               // (N, kXRow) and its lo part
  __nv_bfloat16* xs = hl + N * kXRow;                               // (lp, kXRow)
  __nv_bfloat16* bs = xs + lp * kXRow;                              // (lp, kBRow)

  const int bh = blockIdx.x, c = blockIdx.y, nc = gridDim.y;
  const int b = bh / h, hd = bh % h, grp = hd / (h / g);
  const int t0 = c * chunk, len = min(chunk, t - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;  // fragment row group, thread in group

  // Stage x, B, cum and dt with 16-byte cp.async (rows past len zero-filled),
  // and H_c, read as float4, as its hi and lo parts.
  const float* cdi = cd + ((size_t)bh * nc + c) * 2 * lp;
  for (int e = tid; e < 2 * lp / 4; e += kTcThreads)
    cp_async16(smem_addr(cum + 4 * e), cdi + 4 * e, 16);  // cum, then dts
  stage_rows(xs, kXRow, x + (((size_t)b * t + t0) * h + hd) * P, (size_t)h * P, P, len, lp,
             true);
  const size_t bc0 = (((size_t)b * t + t0) * g + grp) * N;
  stage_rows(bs, kBRow, bm + bc0, (size_t)g * N, N, len, lp, true);
  cp_async_commit();
  // H in batches of 8 float4 loads a thread in flight, then split and stored
  const float* hsrc = states + ((size_t)bh * nc + c) * N * P;
  constexpr int kH4 = N * P / 4, kBatch = 8;
  for (int e0 = 0; e0 < kH4; e0 += kBatch * kTcThreads) {
    float4 hv[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kTcThreads + tid;
      hv[u] = e < kH4 ? *reinterpret_cast<const float4*>(hsrc + 4 * e) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * kTcThreads + tid;
      if (e >= kH4) break;
      const int s = 4 * e / P, col = 4 * e % P;
      unsigned h0, l0, h1, l1;
      split_bf16(hv[u].x, hv[u].y, h0, l0);
      split_bf16(hv[u].z, hv[u].w, h1, l1);
      *reinterpret_cast<uint2*>(hh + s * kXRow + col) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(hl + s * kXRow + col) = make_uint2(l0, l1);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const float dv = dskip[hd];
  const int nrt = lp / 16;
  auto row_tile = [&](int rt) {
    const int i0 = 16 * rt;
    if (i0 >= len) return;
    const float cum_r[2] = {cum[i0 + gr], cum[i0 + gr + 8]};
    // C rows i0+gr and i0+gr+8 as A fragments, zero past len
    unsigned cf[kSteps][4];
    {
      const bool in0 = i0 + gr < len, in1 = i0 + gr + 8 < len;
      const unsigned* c0 = reinterpret_cast<const unsigned*>(
          cm + bc0 + (size_t)(in0 ? i0 + gr : 0) * g * N);
      const unsigned* c1 = reinterpret_cast<const unsigned*>(
          cm + bc0 + (size_t)(in1 ? i0 + gr + 8 : 0) * g * N);
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        const int col = (16 * ks + 2 * t4) / 2;  // in pairs of bf16
        cf[ks][0] = in0 ? c0[col] : 0u;
        cf[ks][1] = in1 ? c1[col] : 0u;
        cf[ks][2] = in0 ? c0[col + 4] : 0u;
        cf[ks][3] = in1 ? c1[col + 4] : 0u;
      }
    }

    // The inter-chunk term exp(cum_i) C_i . (H_hi + H_lo); the intra-chunk
    // products then add onto it.
    float o[kPTiles][4];
#pragma unroll
    for (int nt = 0; nt < kPTiles; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const int row = 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int nt = 0; nt < kPTiles; nt += 2) {
        unsigned b0, b1, b2, b3;
        ldsm_x4_trans(smem_addr(hh + row * kXRow + 8 * nt + (lane >> 4) * 8), b0, b1, b2, b3);
        mma_bf16(o[nt], cf[ks], b0, b1);
        mma_bf16(o[nt + 1], cf[ks], b2, b3);
        ldsm_x4_trans(smem_addr(hl + row * kXRow + 8 * nt + (lane >> 4) * 8), b0, b1, b2, b3);
        mma_bf16(o[nt], cf[ks], b0, b1);
        mma_bf16(o[nt + 1], cf[ks], b2, b3);
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
      // S = C B^T, the even and odd k-steps in separate accumulators (two
      // dependent chains of kSteps / 2 products, not one of kSteps)
      float s[2][4] = {}, s_odd[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        unsigned b0, b1, b2, b3;
        ldsm_x4(smem_addr(bs + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * kBRow + ks * 16 +
                          ((lane >> 3) & 1) * 8),
                b0, b1, b2, b3);
        if (ks % 2) {
          mma_bf16(s_odd[0], cf[ks], b0, b1);
          mma_bf16(s_odd[1], cf[ks], b2, b3);
        } else {
          mma_bf16(s[0], cf[ks], b0, b1);
          mma_bf16(s[1], cf[ks], b2, b3);
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e / 4][e % 4] += s_odd[e / 4][e % 4];
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
      // S as two bf16 fragments, hi and the rest, each multiplied with x: one
      // bf16 rounding of S left errors of 0.05 in a y near 0 at N = 128
      // (C.B sums 128 products)
      unsigned ahi[4], alo[4];
      split_bf16(s[0][0], s[0][1], ahi[0], alo[0]);
      split_bf16(s[0][2], s[0][3], ahi[1], alo[1]);
      split_bf16(s[1][0], s[1][1], ahi[2], alo[2]);
      split_bf16(s[1][2], s[1][3], ahi[3], alo[3]);
#pragma unroll
      for (int nt = 0; nt < kPTiles; nt += 2) {
        unsigned b0, b1, b2, b3;
        const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_trans(smem_addr(xs + row * kXRow + 8 * nt + (lane >> 4) * 8), b0, b1, b2, b3);
        mma_bf16(o[nt], ahi, b0, b1);
        mma_bf16(o[nt], alo, b0, b1);
        mma_bf16(o[nt + 1], ahi, b2, b3);
        mma_bf16(o[nt + 1], alo, b2, b3);
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
  const size_t bt_or_state = (size_t)n * (lp > p4 ? lp : p4);  // B^T, then the state
  return sizeof(float) * ((size_t)n * lp + bt_or_state + (size_t)lp * lp + 2 * lp) +
         sizeof(T) * (size_t)lp * p4;
}

// The tensor-core phases: dt, cum and the scan's warp totals in float32, x
// (lp, p+8) and B (lp, n+8) in bf16; and the chunk scan's cum and dt, H's two
// bf16 parts (n, p+8), x and B (kernels/ssd_scan.py::smem_bytes mirrors them)
size_t state_tc_smem(int chunk, int p, int n) {
  const int lp = round_up(chunk, 16);
  return sizeof(float) * (2 * (size_t)lp + 32) +
         sizeof(__nv_bfloat16) * ((size_t)lp * (p + 8) + (size_t)lp * (n + 8));
}

size_t scan_tc_smem(int chunk, int p, int n) {
  const int lp = round_up(chunk, 16);
  return sizeof(float) * 2 * (size_t)lp +
         sizeof(__nv_bfloat16) * (2 * (size_t)n * (p + 8) + (size_t)lp * (p + 8) +
                                  (size_t)lp * (n + 8));
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
int chunk_state_tc(const void* x, const float* dt, const float* a, const void* bm, float* cd,
                   float* states, int b, int t, int h, int g, int n, int chunk,
                   cudaStream_t stream) {
  const size_t smem = state_tc_smem(chunk, P, n);
  if (int err = allow_smem(ssd_chunk_state_tc<P>, smem)) return err;
  const dim3 grid(b * h, (t + chunk - 1) / chunk);
  ssd_chunk_state_tc<P><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, a, static_cast<const __nv_bfloat16*>(bm), cd,
      states, t, h, g, n, chunk);
  return (int)cudaGetLastError();
}

template <int N, int P>
int chunk_scan_tc(const void* x, const float* cd, const void* cm, const void* bm,
                  const float* dskip, const float* states, void* y, int b, int t, int h, int g,
                  int chunk, cudaStream_t stream) {
  const size_t smem = scan_tc_smem(chunk, P, N);
  if (int err = allow_smem(ssd_chunk_scan_tc<N, P>, smem)) return err;
  const dim3 grid(b * h, (t + chunk - 1) / chunk);
  ssd_chunk_scan_tc<N, P><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), cd, static_cast<const __nv_bfloat16*>(cm),
      static_cast<const __nv_bfloat16*>(bm), dskip, states, static_cast<__nv_bfloat16*>(y), t, h,
      g, chunk);
  return (int)cudaGetLastError();
}

template <int P>
int chunk_scan_tc_n(const void* x, const float* cd, const void* cm, const void* bm,
                    const float* dskip, const float* states, void* y, int b, int t, int h,
                    int g, int n, int chunk, cudaStream_t stream) {
  switch (n) {
    case 16: return chunk_scan_tc<16, P>(x, cd, cm, bm, dskip, states, y, b, t, h, g, chunk, stream);
    case 32: return chunk_scan_tc<32, P>(x, cd, cm, bm, dskip, states, y, b, t, h, g, chunk, stream);
    case 64: return chunk_scan_tc<64, P>(x, cd, cm, bm, dskip, states, y, b, t, h, g, chunk, stream);
    case 128: return chunk_scan_tc<128, P>(x, cd, cm, bm, dskip, states, y, b, t, h, g, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int state_passing(const float* cd, float* states, float* hout, int bh, int nc, int np, int lp,
                  cudaStream_t stream) {
  const size_t threads = (size_t)bh * np;
  const unsigned blocks = (unsigned)((threads + kPassThreads - 1) / kPassThreads);
  ssd_state_passing<<<blocks, kPassThreads, 0, stream>>>(cd, states, hout, bh, nc, np, lp);
  return (int)cudaGetLastError();
}

int chunk_state_any(const void* x, const float* dt, const float* a, const void* bm, float* cd,
                    float* states, int b, int t, int h, int p, int g, int n, int chunk, int bf16,
                    int tc, cudaStream_t stream) {
  if (tc) {
    switch (p) {
      case 16: return chunk_state_tc<16>(x, dt, a, bm, cd, states, b, t, h, g, n, chunk, stream);
      case 32: return chunk_state_tc<32>(x, dt, a, bm, cd, states, b, t, h, g, n, chunk, stream);
      case 64: return chunk_state_tc<64>(x, dt, a, bm, cd, states, b, t, h, g, n, chunk, stream);
      case 128: return chunk_state_tc<128>(x, dt, a, bm, cd, states, b, t, h, g, n, chunk, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (bf16)
    return chunk_state<__nv_bfloat16>(x, dt, a, bm, cd, states, b, t, h, p, g, n, chunk, stream);
  return chunk_state<float>(x, dt, a, bm, cd, states, b, t, h, p, g, n, chunk, stream);
}

int chunk_scan_any(const void* x, const float* cd, const void* cm, const void* bm,
                   const float* dskip, const float* states, void* y, int b, int t, int h, int p,
                   int g, int n, int chunk, int bf16, int tc, cudaStream_t stream) {
  if (tc) {
    switch (p) {
      case 16: return chunk_scan_tc_n<16>(x, cd, cm, bm, dskip, states, y, b, t, h, g, n, chunk, stream);
      case 32: return chunk_scan_tc_n<32>(x, cd, cm, bm, dskip, states, y, b, t, h, g, n, chunk, stream);
      case 64: return chunk_scan_tc_n<64>(x, cd, cm, bm, dskip, states, y, b, t, h, g, n, chunk, stream);
      case 128: return chunk_scan_tc_n<128>(x, cd, cm, bm, dskip, states, y, b, t, h, g, n, chunk, stream);
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
// h % g == 0 (the caller checks). tc = 1 takes the tensor-core chunk state
// and chunk scan: bf16, n and p in {16, 32, 64, 128}, x, B and C 16-byte
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
  if (int err = chunk_state_any(x, dt, a, bm, cd, states, b, t, h, p, g, n, chunk, bf16, tc,
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
