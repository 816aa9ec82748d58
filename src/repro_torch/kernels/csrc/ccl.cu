// Connected component labeling (4-connectivity) for Hopper (sm_90a):
// block-based union-find (Allegretti, Bolelli and Grana, IEEE TPDS 2019,
// after Playne and Hawick, IEEE TPDS 2018), the paper's BWLabel by tiles.
//
// Replaces: src/repro/kernels/ccl.py::ccl_sweep_pallas and its fixed-point
// loop ccl_pallas, which iterate min-label propagation by associative scans
// over 256^2 VMEM tiles with a halo exchange between calls.
//
// What it computes: labels[i] = the smallest flat index of i's component on
// the mask, -1 off it (the canonical labelling of ref.ccl_unionfind_host).
//
// Bound on the H100: bytes. The least traffic is the int32 mask in and the
// int32 labels out, 8 bytes a pixel (40 us at 4096^2 at 3.35 TB/s). This
// design moves those 8 bytes in its local phase, then reads again (and
// rewrites where they changed) only the labels of tiles that a border union
// touched, and chases pointers only across tile borders and from a tile's
// roots to its components' roots.
//
// Design: three launches, each on the given stream.
//   local:    one block of 256 threads a 32x32 tile. Each thread loads 4
//             pixels of a row (one 16-byte load where the width is a
//             multiple of 4 and the mask is 16-byte aligned, else 4 scalar
//             loads). The row's 8 lanes OR their bits into the row's 32-bit
//             mask (__shfl_xor_sync), and every set pixel's parent is the
//             first pixel of its run: a row needs no union. A union-find
//             forest in shared memory then joins each row to the one above
//             where a run of pixels set in both rows begins (one union per
//             overlap, not per pixel): it links the larger root under the
//             smaller with atomicMin and retries if another thread moved that
//             root first. Then each run's first pixel takes its root, and
//             every pixel reads its run's root: one walk per run. In a tile,
//             local raster order is global flat-index order, so each local
//             root is its local component's minimum flat index; every pixel's
//             provisional label is that global index, so parents only
//             decrease and the forest stays acyclic. The block also writes the
//             tile's edges (top and bottom rows, left and right columns) as
//             four bit masks, and clears its flag.
//   border:   one warp per tile reads its edges and its neighbours' (16 bytes
//             each): lane k unites pixel k of the top row (left column) with
//             its neighbour across the border where a run of pairs set on both
//             sides begins, with the same atomicMin union on the label array
//             in device memory, and marks both tiles. Reads of the forest in
//             this phase bypass L1 (__ldcg) so a retry sees links made by
//             other SMs.
//   compress: one block per marked tile; a tile that no border union touched
//             holds final labels already (its local roots are global roots)
//             and is skipped. Each thread sets its 4 labels to their roots and
//             writes the root over every parent on the chain it walked, so
//             later walkers take one hop; lanes of a warp with the same first
//             label (__match_any_sync) share one walk, and a thread writes
//             only labels that changed. Background stays -1.
// The result is exact and needs no iteration cap.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;        // a tile is kTile x kTile pixels
constexpr int kSeg = 4;          // pixels a thread takes in the local and compress phases
constexpr int kRowThreads = kTile / kSeg;      // threads a tile row
constexpr int kThreads = kTile * kTile / kSeg;  // 256
constexpr unsigned kFull = 0xffffffffu;

// -- union-find in shared memory (tile-local indices) ------------------------
__device__ __forceinline__ int find_local(volatile int* s, int x) {
  int p = s[x];
  while (p != x) {
    x = p;
    p = s[x];
  }
  return x;
}

__device__ void unite_local(int* s, int a, int b) {
  while (true) {
    a = find_local(s, a);
    b = find_local(s, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(s + a, b);
    if (old == a) return;
    a = old;
  }
}

// -- union-find in device memory (global flat indices) -----------------------
__device__ __forceinline__ int find_root_cg(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root_cg(parent, a);
    b = find_root_cg(parent, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // a > b: hang root a under b; if a was no longer a root, unite its
    // current parent with b instead.
    const int old = atomicMin(parent + a, b);
    if (old == a) return;
    a = old;
  }
}

// The thread's 4 pixels of row y from column x, fill outside the image.
template <bool kVec>
__device__ __forceinline__ void load4(const int* p, int y, int x, int h, int w, int fill,
                                      int (&v)[kSeg]) {
  const size_t at = (size_t)y * w + x;
  if (kVec) {
    // w % 4 == 0, so the 4 pixels lie wholly inside or wholly outside the image
    int4 q = make_int4(fill, fill, fill, fill);
    if (y < h && x < w) q = *reinterpret_cast<const int4*>(p + at);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kSeg; ++k) v[k] = (y < h && x + k < w) ? p[at + k] : fill;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(int* p, int y, int x, int h, int w, const int (&v)[kSeg]) {
  const size_t at = (size_t)y * w + x;
  if (kVec) {
    if (y < h && x < w) *reinterpret_cast<int4*>(p + at) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      if (y < h && x + k < w) p[at + k] = v[k];
    }
  }
}

// Column of the first pixel of the run that holds column c (bit c of bits set).
__device__ __forceinline__ int run_start(unsigned bits, int c) {
  const unsigned below = ~bits & ((1u << c) - 1u);
  return below ? 32 - __clz(below) : 0;
}

// Bit k of the result: bit k of bits is set and bit k - 1 is not (a run of
// set bits begins at k).
__device__ __forceinline__ unsigned run_begins(unsigned bits) { return bits & ~(bits << 1); }

// grid: one block per tile, tiles in raster order (ntx tiles a row).
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ccl_local(const int* __restrict__ mask,
                                                      int* __restrict__ labels,
                                                      uint4* __restrict__ edges,
                                                      int* __restrict__ flags, int h, int w,
                                                      int ntx) {
  static_assert(kTile == 32, "a tile row is one 32-bit mask");
  __shared__ int s[kTile * kTile];
  __shared__ unsigned rows[kTile];  // bit c of rows[r]: pixel (r, c) is set
  const int ty0 = (blockIdx.x / ntx) * kTile;
  const int tx0 = (blockIdx.x % ntx) * kTile;
  const int ly = threadIdx.x / kRowThreads;
  const int lx = (threadIdx.x % kRowThreads) * kSeg;
  int m[kSeg];
  load4<kVec>(mask, ty0 + ly, tx0 + lx, h, w, 0, m);

  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kSeg; ++k) bits |= (unsigned)(m[k] != 0) << (lx + k);
#pragma unroll
  for (int d = 1; d < kRowThreads; d <<= 1) bits |= __shfl_xor_sync(kFull, bits, d);
  if (lx == 0) rows[ly] = bits;
  const int base = ly * kTile;
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const int c = lx + k;
    s[base + c] = (bits >> c) & 1u ? base + run_start(bits, c) : -1;
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the tile's edges for the border phase: top, bottom, left, right
    const unsigned r = rows[threadIdx.x];
    const unsigned left = __ballot_sync(kFull, r & 1u);
    const unsigned right = __ballot_sync(kFull, r >> 31);
    if (threadIdx.x == 0) {
      edges[blockIdx.x] = make_uint4(rows[0], rows[kTile - 1], left, right);
      flags[blockIdx.x] = 0;
    }
  }

  // unite with the row above where a run of pixels set in both rows begins
  if (ly > 0) {
    unsigned mine = (run_begins(bits & rows[ly - 1]) >> lx) & 0xFu;
    while (mine) {
      const int c = lx + __ffs(mine) - 1;
      mine &= mine - 1;
      unite_local(s, base + c, base + c - kTile);
    }
  }
  __syncthreads();

  // each run's first pixel takes its root; no union runs now, so a walker
  // passing through it reads the old parent or the root, both on its path
  unsigned firsts = (run_begins(bits) >> lx) & 0xFu;
  while (firsts) {
    const int i = base + lx + __ffs(firsts) - 1;
    firsts &= firsts - 1;
    s[i] = find_local(s, i);
  }
  __syncthreads();

  int out[kSeg];
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    const int c = lx + k;
    out[k] = -1;
    if ((bits >> c) & 1u) {
      const int r = s[base + run_start(bits, c)];
      out[k] = (ty0 + r / kTile) * w + tx0 + r % kTile;
    }
  }
  store4<kVec>(labels, ty0 + ly, tx0 + lx, h, w, out);
}

// One warp per tile, tiles in column order: lane k unites the pair k across
// the tile's top row and across its left column where a run of pairs set on
// both sides begins (the pairs after it in the run are joined through the
// tiles' own labels), and marks both tiles.
__global__ void __launch_bounds__(kThreads) ccl_border(int* labels,
                                                       const uint4* __restrict__ edges,
                                                       int* __restrict__ flags, int w, int nty,
                                                       int ntx) {
  const int warp = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32);
  if (warp >= nty * ntx) return;
  const int lane = threadIdx.x & 31;
  // tiles in column order: blocks start roughly in index order, so a row's
  // unions mostly run left to right and each finds its left neighbour already
  // linked to the row's root, which keeps the trees shallow
  const int ty = warp % nty;
  const int tx = warp / nty;
  const int tile = ty * ntx + tx;
  const uint4 e = edges[tile];
  const size_t corner = (size_t)ty * kTile * w + (size_t)tx * kTile;
  if (ty > 0 && (run_begins(e.x & edges[tile - ntx].y) >> lane) & 1u) {
    flags[tile] = 1;
    flags[tile - ntx] = 1;
    const int i = (int)(corner + lane);
    unite(labels, i, i - w);
  }
  if (tx > 0 && (run_begins(e.z & edges[tile - 1].w) >> lane) & 1u) {
    flags[tile] = 1;
    flags[tile - 1] = 1;
    const int i = (int)(corner + (size_t)lane * w);
    unite(labels, i, i - 1);
  }
}

// The root of l's tree, written over every parent on the way to it.
__device__ __forceinline__ int resolve(int* labels, int l) {
  int r = l;
  int p = labels[r];
  while (p != r) {
    r = p;
    p = labels[r];
  }
  while (l != r) {
    const int next = labels[l];
    if (next == r) break;
    labels[l] = r;
    l = next;
  }
  return r;
}

// grid: one block per tile, as the local phase.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) ccl_compress(int* labels,
                                                         const int* __restrict__ flags, int h,
                                                         int w, int ntx) {
  if (flags[blockIdx.x] == 0) return;  // no border union touched this tile
  const int y = (blockIdx.x / ntx) * kTile + threadIdx.x / kRowThreads;
  const int x = (blockIdx.x % ntx) * kTile + (threadIdx.x % kRowThreads) * kSeg;
  int l[kSeg];
  load4<kVec>(labels, y, x, h, w, -1, l);
  int key = -1;  // the first set pixel's label
#pragma unroll
  for (int k = 0; k < kSeg; ++k) key = key < 0 ? l[k] : key;
  // lanes whose key agrees share one walk
  const unsigned same = __match_any_sync(kFull, key);
  const int leader = __ffs(same) - 1;
  int root = key;
  if (key >= 0 && (int)(threadIdx.x % 32) == leader) root = resolve(labels, key);
  root = __shfl_sync(kFull, root, leader);

  int out[kSeg];
  bool changed = false;
  int prev_l = key, prev_r = root;
#pragma unroll
  for (int k = 0; k < kSeg; ++k) {
    out[k] = -1;
    if (l[k] >= 0) {
      if (l[k] != prev_l) {
        prev_l = l[k];
        prev_r = resolve(labels, l[k]);
      }
      out[k] = prev_r;
      changed |= prev_r != l[k];
    }
  }
  if (changed) store4<kVec>(labels, y, x, h, w, out);
}

}  // namespace

// The int32 scratch that rt_ccl needs for an (h, w) mask: 5 a tile, each
// tile's edges (4 bit masks), then the tiles' flags.
extern "C" int rt_ccl_scratch_ints(int h, int w) {
  const long long tiles = (long long)((h + kTile - 1) / kTile) * ((w + kTile - 1) / kTile);
  return (int)(5 * tiles);
}

// mask, labels: (h, w) int32; h * w must fit in int32 (checked by the
// caller). scratch: rt_ccl_scratch_ints(h, w) int32, 16-byte aligned. events, if not null, holds four
// cudaEvent_t recorded before the local phase and after each of the three.
extern "C" int rt_ccl(const int* mask, int* labels, int* scratch, int h, int w,
                      void* const* events, cudaStream_t stream) {
  auto mark = [&](int i) -> int {
    return events ? (int)cudaEventRecord(static_cast<cudaEvent_t>(events[i]), stream) : 0;
  };
  if ((long long)h * w <= 0) return (int)cudaGetLastError();
  const int nty = (h + kTile - 1) / kTile;
  const int ntx = (w + kTile - 1) / kTile;
  const unsigned tiles = (unsigned)nty * (unsigned)ntx;
  uint4* edges = reinterpret_cast<uint4*>(scratch);
  int* flags = scratch + 4 * (size_t)tiles;
  const bool vec = w % kSeg == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(labels) % 16 == 0;
  int err = mark(0);
  if (err) return err;
  if (vec) {
    ccl_local<true><<<tiles, kThreads, 0, stream>>>(mask, labels, edges, flags, h, w, ntx);
  } else {
    ccl_local<false><<<tiles, kThreads, 0, stream>>>(mask, labels, edges, flags, h, w, ntx);
  }
  if ((err = mark(1))) return err;
  const unsigned border_blocks = (unsigned)(((long long)tiles * 32 + kThreads - 1) / kThreads);
  ccl_border<<<border_blocks, kThreads, 0, stream>>>(labels, edges, flags, w, nty, ntx);
  if ((err = mark(2))) return err;
  if (vec) {
    ccl_compress<true><<<tiles, kThreads, 0, stream>>>(labels, flags, h, w, ntx);
  } else {
    ccl_compress<false><<<tiles, kThreads, 0, stream>>>(labels, flags, h, w, ntx);
  }
  if ((err = mark(3))) return err;
  return (int)cudaGetLastError();
}
