// Grayscale morphological reconstruction by dilation (4-connectivity) for
// Hopper (sm_90a): a tiled wavefront with an active-tile worklist, the
// paper's irregular wavefront propagation pattern (IWPP) at tile granularity.
//
// Replaces: src/repro/kernels/morph_recon.py::morph_recon_sweep_pallas and the
// fixed-point loop morph_recon_pallas, which relax 256^2 VMEM tiles with
// clamp-composition associative scans plus a 1-pixel halo exchange.
//
// What it computes: the fixed point of repro.kernels.ref.morph_recon_sweep_ref
// from min(marker, mask), i.e. the reconstruction that ref.morph_recon_ref
// reaches when its sweep cap does not bind. Every update is
//   j_p <- min(mask_p, max(j_p, j_q))   for a 4-neighbour q,
// which only selects values (min and max of float32 never round) and only
// raises j. Reconstruction by dilation has one fixed point, so any order of
// such updates that stops where no pixel can change gives the converged
// reference's result bit for bit. The kernel always runs to that point; it
// has no iteration cap.
//
// Bound on the H100: bytes. The least traffic is marker + mask in and the
// result out, 12 bytes a pixel (60 us at 4096^2 at 3.35 TB/s); a pass does 2
// min/max per pixel, so operations never bound it.
//
// Design. The image is cut into 64x64 tiles; a block of 64 threads takes one
// tile at a time and loads its j and mask into shared memory (padded with
// -inf outside the image, so ragged tiles run the same code) and the four
// 64-pixel halos of its neighbours into a small array. It then relaxes the
// tile to its local fixed point: thread c walks column c down and up, then
// row c right and left (the reference sweep's order), each line held in
// registers while it is walked, and the block repeats until __syncthreads_or
// reports no change. The shared rows have an odd pitch, so both the column
// and the row walks are free of bank conflicts.
//
// Across tiles, one launch is one round of the wavefront. Round 0 visits every
// tile, reads the marker and applies min(marker, mask) itself (its halos are
// min(marker, mask) of the neighbours, a valid lower bound of their current
// values). Later rounds visit only the tiles in the round's worklist. A tile
// whose edge row or column changed puts the neighbour across that edge on the
// next round's list (an atomic flag keeps it there once). A neighbour that
// read the edge before the change is revisited next round, and one that read
// it after gains nothing it lacks, so when a round queues no tile, every tile
// is at its local fixed point against its neighbours' final edges: the global
// fixed point. Lists, flags and counts rotate over three buffers, so that a
// round resets the count that the round after next appends to without racing
// any reader. The host reads the next round's count once every few rounds;
// rounds launched past the fixed point find an empty list and return.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;          // tile side; one thread per line of a tile
constexpr int kPitch = kTile + 1;  // odd: column and row walks hit 32 banks
constexpr int kHeader = 5;         // state: counts of the 3 lists, rounds with work, visits

// j at a pixel as a round sees it: round 0 reads min(marker, mask).
__device__ __forceinline__ float read_j(const float* marker, const float* mask, const float* out,
                                        size_t i, bool first) {
  return first ? fminf(marker[i], mask[i]) : out[i];
}

// Walk one line held in registers forward from `before`, then back from
// `after`; returns whether any value rose.
__device__ __forceinline__ bool walk_line(float (&j)[kTile], const float (&m)[kTile], float before,
                                          float after) {
  bool changed = false;
  float prev = before;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const float x = fminf(m[i], fmaxf(j[i], prev));
    changed |= x != j[i];
    j[i] = x;
    prev = x;
  }
  prev = after;
#pragma unroll
  for (int i = kTile - 1; i >= 0; --i) {
    const float x = fminf(m[i], fmaxf(j[i], prev));
    changed |= x != j[i];
    j[i] = x;
    prev = x;
  }
  return changed;
}

__device__ __forceinline__ void enqueue(int* state, int* list, int* queued, int tile) {
  if (atomicExch(queued + tile, 1) == 0) list[atomicAdd(state, 1)] = tile;
}

// state: [0..2] the three lists' counts, [3] rounds that had work, [4] tile
// visits; then lists (3 x ntiles tile ids) and queued (3 x ntiles flags).
__global__ void __launch_bounds__(kTile)
recon_round(const float* __restrict__ marker, const float* __restrict__ mask, float* out,
            int* state, int h, int w, int tiles_x, int tiles_y, int round) {
  __shared__ float sj[kTile * kPitch];
  __shared__ float sm[kTile * kPitch];
  __shared__ float halo[4][kTile];  // above, below, left of, right of the tile
  const int ntiles = tiles_x * tiles_y;
  int* lists = state + kHeader;
  int* queued = lists + 3 * ntiles;
  const bool first = round == 0;
  const int cur = round % 3, nxt = (round + 1) % 3;
  const int n = first ? ntiles : state[cur];
  const int c = threadIdx.x;
  if (blockIdx.x == 0 && c == 0) {
    state[(round + 2) % 3] = 0;  // the list that round + 1 fills
    if (n > 0) state[3] += 1;
  }

  for (int i = blockIdx.x; i < n; i += gridDim.x) {
    const int t = first ? i : lists[cur * ntiles + i];
    if (!first && c == 0) queued[cur * ntiles + t] = 0;
    const int ty = t / tiles_x, tx = t % tiles_x;
    const int y0 = ty * kTile, x0 = tx * kTile;
    const int th = min(kTile, h - y0), tw = min(kTile, w - x0);

    // Load the tile (coalesced rows, kBatch rows of loads in flight at once)
    // and the halos; -inf outside the image.
    constexpr int kBatch = 16;
    for (int r0 = 0; r0 < kTile; r0 += kBatch) {
      float jv[kBatch], mv[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        jv[k] = mv[k] = -INFINITY;
        if (r0 + k < th && c < tw) {
          const size_t idx = (size_t)(y0 + r0 + k) * w + x0 + c;
          mv[k] = mask[idx];
          jv[k] = first ? fminf(marker[idx], mv[k]) : out[idx];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        sj[(r0 + k) * kPitch + c] = jv[k];
        sm[(r0 + k) * kPitch + c] = mv[k];
      }
    }
    halo[0][c] = y0 > 0 && c < tw ? read_j(marker, mask, out, (size_t)(y0 - 1) * w + x0 + c, first)
                                  : -INFINITY;
    halo[1][c] = y0 + th < h && c < tw
                     ? read_j(marker, mask, out, (size_t)(y0 + th) * w + x0 + c, first)
                     : -INFINITY;
    halo[2][c] = x0 > 0 && c < th ? read_j(marker, mask, out, (size_t)(y0 + c) * w + x0 - 1, first)
                                  : -INFINITY;
    halo[3][c] = x0 + tw < w && c < th
                     ? read_j(marker, mask, out, (size_t)(y0 + c) * w + x0 + tw, first)
                     : -INFINITY;
    __syncthreads();
    // A neighbour exists across an edge only where the tile is whole, so the
    // edges are row and column kTile - 1.
    const float top = sj[c], bottom = sj[(kTile - 1) * kPitch + c];
    const float left = sj[c * kPitch], right = sj[c * kPitch + kTile - 1];

    // Local fixed point: columns down and up, then rows right and left.
    bool tile_changed = false;
    for (;;) {
      float line[kTile], lmask[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        line[r] = sj[r * kPitch + c];
        lmask[r] = sm[r * kPitch + c];
      }
      bool changed = walk_line(line, lmask, halo[0][c], halo[1][c]);
#pragma unroll
      for (int r = 0; r < kTile; ++r) sj[r * kPitch + c] = line[r];
      __syncthreads();
#pragma unroll
      for (int x = 0; x < kTile; ++x) {
        line[x] = sj[c * kPitch + x];
        lmask[x] = sm[c * kPitch + x];
      }
      changed |= walk_line(line, lmask, halo[2][c], halo[3][c]);
#pragma unroll
      for (int x = 0; x < kTile; ++x) sj[c * kPitch + x] = line[x];
      if (!__syncthreads_or(changed)) break;
      tile_changed = true;
    }

    if (first || tile_changed) {
      for (int r = 0; r < th; ++r)
        if (c < tw) out[(size_t)(y0 + r) * w + x0 + c] = sj[r * kPitch + c];
    }
    if (tile_changed) {  // wake the neighbours across the edges that moved
      const bool up = __syncthreads_or(sj[c] != top);
      const bool down = __syncthreads_or(sj[(kTile - 1) * kPitch + c] != bottom);
      const bool west = __syncthreads_or(sj[c * kPitch] != left);
      const bool east = __syncthreads_or(sj[c * kPitch + kTile - 1] != right);
      if (c == 0) {
        int* list = lists + nxt * ntiles;
        int* flag = queued + nxt * ntiles;
        if (up && ty > 0) enqueue(state + nxt, list, flag, t - tiles_x);
        if (down && ty + 1 < tiles_y) enqueue(state + nxt, list, flag, t + tiles_x);
        if (west && tx > 0) enqueue(state + nxt, list, flag, t - 1);
        if (east && tx + 1 < tiles_x) enqueue(state + nxt, list, flag, t + 1);
      }
    }
    if (c == 0) atomicAdd(state + 4, 1);
    __syncthreads();  // shared memory is free for the next tile
  }
}

}  // namespace

// Rounds first_round .. first_round + nrounds - 1 of the reconstruction of
// (h, w) float32 marker and mask into out. state is int32, zeroed before
// round 0, with 5 + 6 * ceil(h/64) * ceil(w/64) entries; after the launches
// state[(first_round + nrounds) % 3] is the number of tiles queued for the
// next round (0 at the fixed point), state[3] the rounds that had work and
// state[4] the tile visits so far.
extern "C" int rt_morph_recon_rounds(const float* marker, const float* mask, float* out,
                                     int* state, int h, int w, int first_round, int nrounds,
                                     cudaStream_t stream) {
  if (h <= 0 || w <= 0) return (int)cudaGetLastError();
  const int tiles_x = (w + kTile - 1) / kTile, tiles_y = (h + kTile - 1) / kTile;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, recon_round, kTile, 0);
  if (err != cudaSuccess) return (int)err;
  const int blocks = max(1, min(tiles_x * tiles_y, sms * per_sm));
  for (int r = first_round; r < first_round + nrounds; ++r) {
    recon_round<<<blocks, kTile, 0, stream>>>(marker, mask, out, state, h, w, tiles_x, tiles_y, r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
