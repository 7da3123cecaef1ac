// Chamfer distance transform of seed maps (CoarseDistanceMap::growDistBFS).
//
// Replaces the TPU kernel
// sdv_loam_tpu/ops/pallas_kernels.py:_distmap_kernel (wrapper
// distance_transform_pallas): `iters` sweeps of 8-neighbour min-plus (+1)
// relaxation, d <- min(d, min_nb(d_nb + 1)), of a seed map that holds 0 at
// seeds and 1000 elsewhere; outside the image counts as 1000. Any number of
// sweeps, over one map (h, w) or a stack of lanes (lanes, h, w).
//
// One sweep is computed as d <- min(d, fl(M(d) + 1)), where M is the 3x3
// minimum with the centre included. That is bit for bit the same as the
// neighbour form for every input without NaN: fl(x + 1) is monotone, so the
// minimum of the sums is the sum of the minimum; fl(x + 1) >= x, so letting
// the centre into the minimum never changes the result; and the minimum is
// exact and separable (along the row, then along the column). A cell update
// is 4 mins, 1 add and 1 min instead of 8 adds and 9 mins.
//
// Bound on the card: operations, and the latency of a chain of dependent
// sweeps. The bytes are one read and one write of the map (0.86 MB at
// 180x600); 32 sweeps over 108,000 cells are ~20 M operations. The TPU
// kernel kept the grid in VMEM; a map is larger than a block's shared
// memory, so each block relaxes its own tile plus a halo of kHalo cells: a
// sweep moves information one cell, so after <= kHalo sweeps a tile cell
// depends only on cells inside its halo, and wrong values that start at the
// region's edge travel inward one cell per sweep and never reach the tile.
// More sweeps run as launches of kHalo sweeps each (chunks), each starting
// from the previous chunk's output.
//
// What the design does about it:
//  * registers instead of shared memory: each thread owns C adjacent
//    columns of its block's region and a strip of S rows of them in
//    registers; one warp spans the region's width. Horizontal neighbours
//    come from one shuffle each way per row, vertical ones from the
//    thread's own registers; only the row minima of each strip's top and
//    bottom rows go through shared memory, double-buffered so that a sweep
//    needs one barrier. There is no per-cell index arithmetic;
//  * a 16-cell halo with 32 sweeps run as two chunks of 16: a 32x32 tile's
//    region shrinks from 96x96 (a 32-cell halo: 9x the tile's cells) to
//    64x64 (4x), for one extra launch (on an H100 at 180x600: 12.8 us
//    against 45 us for the same sweep code over 32-cell halos);
//  * the tile size follows the work: one map at 180x600 is 114 tiles of
//    32x32, one wave on 132 SMs; when those would take more than one wave
//    (several lanes), 64x64 tiles (96x96 regions, 2.25x) cut the recompute;
//  * a lane grid dimension: L maps go in one launch.
// Cells outside the image are pinned at 1000 and never relax, as the plain
// version's padding; the region's own edge treats a missing neighbour as
// the cell itself, which is neutral for a minimum.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kHalo = 16;
constexpr float kBig = 1000.0f;

// C columns per thread (one warp: 32 * C columns), WY strips of S rows
template <int C, int WY, int S>
__global__ void __launch_bounds__(WY * 32)
distance_sweeps_kernel(const float* __restrict__ src, float* __restrict__ dst,
                       int h, int w, int iters) {
  constexpr int RW = 32 * C;             // region width
  constexpr int TW = RW - 2 * kHalo;     // tile width
  constexpr int TH = S * WY - 2 * kHalo; // tile height
  static_assert(TW > 0 && TH > 0, "region smaller than its halo");
  static_assert(S * C <= 32, "cell mask is 32 bits");
  // row minima of each strip's top (0) and bottom (1) rows
  __shared__ float edge[2][WY][2][RW];

  const int lane = threadIdx.x & 31;
  const int wy = threadIdx.x >> 5;
  const int rc0 = lane * C;                           // first region column
  const int gx0 = blockIdx.x * TW - kHalo + rc0;
  const int gy0 = blockIdx.y * TH - kHalo + wy * S;   // first row of the strip
  const int64_t plane = static_cast<int64_t>(h) * w;
  const float* in = src + blockIdx.z * plane;

  float d[S][C];
  unsigned inside = 0;   // bit r * C + c: cell (r, c) lies in the image
#pragma unroll
  for (int r = 0; r < S; ++r) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int gy = gy0 + r, gx = gx0 + c;
      const bool in_img = gy >= 0 && gy < h && gx >= 0 && gx < w;
      d[r][c] = in_img ? in[static_cast<int64_t>(gy) * w + gx] : kBig;
      inside |= (in_img ? 1u : 0u) << (r * C + c);
    }
  }

  constexpr unsigned kAll = 0xffffffffu;
  for (int it = 0; it < iters; ++it) {
    const int b = it & 1;
    // row minima over (c - 1, c, c + 1): pair minima q, then neighbours
    float hm[S][C];
#pragma unroll
    for (int r = 0; r < S; ++r) {
      float left = __shfl_up_sync(kAll, d[r][C - 1], 1);
      float right = __shfl_down_sync(kAll, d[r][0], 1);
      if (lane == 0) left = d[r][0];
      if (lane == 31) right = d[r][C - 1];
      float q[C + 1];   // q[k] = min(x[k - 1], x[k]), x[-1] = left, x[C] = right
      q[0] = fminf(left, d[r][0]);
#pragma unroll
      for (int c = 1; c < C; ++c) q[c] = fminf(d[r][c - 1], d[r][c]);
      q[C] = fminf(d[r][C - 1], right);
#pragma unroll
      for (int c = 0; c < C; ++c) hm[r][c] = fminf(q[c], q[c + 1]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      edge[b][wy][0][rc0 + c] = hm[0][c];
      edge[b][wy][1][rc0 + c] = hm[S - 1][c];
    }
    __syncthreads();
    float up[C], dn[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      up[c] = wy > 0 ? edge[b][wy - 1][1][rc0 + c] : hm[0][c];
      dn[c] = wy < WY - 1 ? edge[b][wy + 1][0][rc0 + c] : hm[S - 1][c];
    }
    // column minima, +1, and the min with the cell itself
#pragma unroll
    for (int r = 0; r < S; ++r) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float a = r > 0 ? hm[r - 1][c] : up[c];
        const float z = r < S - 1 ? hm[r + 1][c] : dn[c];
        const float m = fminf(fminf(a, hm[r][c]), z);
        const float nd = fminf(d[r][c], m + 1.0f);
        d[r][c] = ((inside >> (r * C + c)) & 1u) ? nd : d[r][c];
      }
    }
  }

  float* out = dst + blockIdx.z * plane;
#pragma unroll
  for (int r = 0; r < S; ++r) {
    const int ry = wy * S + r;
    if (ry < kHalo || ry >= kHalo + TH) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int rc = rc0 + c;
      if (rc >= kHalo && rc < kHalo + TW && ((inside >> (r * C + c)) & 1u))
        out[static_cast<int64_t>(gy0 + r) * w + gx0 + c] = d[r][c];
    }
  }
}

template <int C, int WY, int S>
struct Config {
  static constexpr int kTileW = 32 * C - 2 * kHalo;
  static constexpr int kTileH = S * WY - 2 * kHalo;

  static int64_t tiles(int lanes, int h, int w) {
    return static_cast<int64_t>(lanes) * ((h + kTileH - 1) / kTileH) *
           ((w + kTileW - 1) / kTileW);
  }

  static cudaError_t launch(const float* src, float* dst, int lanes, int h,
                            int w, int iters, cudaStream_t stream) {
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    lanes);
    distance_sweeps_kernel<C, WY, S>
        <<<grid, WY * 32, 0, stream>>>(src, dst, h, w, iters);
    return cudaGetLastError();
  }
};

using Tile32 = Config<2, 16, 4>;   // 32x32 tiles, 64x64 regions, 512 threads
using Tile64 = Config<3, 16, 6>;   // 64x64 tiles, 96x96 regions, 512 threads

int sm_count() {
  static int cached[64];   // per device; 0 = not yet asked
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
        cudaSuccess)
      return 0;
    cached[dev] = n;
  }
  return cached[dev];
}

}  // namespace

// seed, out, scratch: (lanes, h, w) maps; scratch is used (and must be
// given) when iters takes more than one chunk of 16 sweeps. tile: 0 picks
// the tile size from the work, 32 or 64 forces one. Returns a cudaError_t.
extern "C" int sdv_distance_transform(const float* seed, float* out,
                                      float* scratch, int lanes, int h, int w,
                                      int iters, int tile, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (iters < 0 || lanes < 0 || h < 0 || w < 0 ||
      (tile != 0 && tile != 32 && tile != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t cells = static_cast<int64_t>(lanes) * h * w;
  if (cells == 0) return static_cast<int>(cudaSuccess);
  if (iters == 0)
    return static_cast<int>(cudaMemcpyAsync(out, seed, cells * sizeof(float),
                                            cudaMemcpyDeviceToDevice, st));
  const int chunks = (iters + kHalo - 1) / kHalo;
  if (chunks > 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (tile == 0) tile = Tile32::tiles(lanes, h, w) <= sm_count() ? 32 : 64;
  const float* src = seed;
  for (int c = 0; c < chunks; ++c) {
    // the last chunk writes `out`; the chunks before it alternate between
    // the scratch map and `out`, so that a chunk never reads what it writes
    float* dst = (chunks - 1 - c) % 2 == 0 ? out : scratch;
    const int n = c + 1 < chunks ? kHalo : iters - kHalo * (chunks - 1);
    const cudaError_t err =
        tile == 32 ? Tile32::launch(src, dst, lanes, h, w, n, st)
                   : Tile64::launch(src, dst, lanes, h, w, n, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    src = dst;
  }
  return static_cast<int>(cudaSuccess);
}
