// Chamfer distance transform of a seed map (CoarseDistanceMap::growDistBFS).
//
// Replaces the TPU kernel
// sdv_loam_tpu/ops/pallas_kernels.py:_distmap_kernel (wrapper
// distance_transform_pallas): `iters` sweeps of 8-neighbour min-plus (+1)
// relaxation, d <- min(d, min_nb(d_nb + 1)), of a seed map that holds 0 at
// seeds and 1000 elsewhere; outside the image counts as 1000.
//
// Bound on the card: bytes, and only if each sweep went through global
// memory (32 sweeps x 2 maps of up to 422 KB). The TPU kernel kept the whole
// grid in VMEM; an H100 block has 227 KB of shared memory, less than one
// map. So each block owns a 32x32 output tile and loads it with a 32-cell
// halo (96x96 floats) into shared memory once, runs all sweeps there with a
// double buffer (Jacobi order, as the reference) and writes only its tile
// back: one read and one write of the map in total. The result is exact:
// a sweep moves information one cell, so after <= 32 sweeps a tile cell
// depends only on cells inside its halo, and wrong values that start at the
// edge of the loaded region travel inward one cell per sweep and never reach
// the tile. Halo cells outside the image are pinned at 1000 and never relax,
// which matches the padding of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 32;
constexpr int kRegion = kTile + 2 * kHalo;        // 96
constexpr int kCells = kRegion * kRegion;          // 9216
constexpr float kBig = 1000.0f;

__global__ void __launch_bounds__(kTile * kTile)
distance_transform_kernel(const float* __restrict__ seed,
                          float* __restrict__ out, int h, int w, int iters) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + kCells;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kTile;
  const int y0 = blockIdx.y * kTile - kHalo;
  const int x0 = blockIdx.x * kTile - kHalo;

  for (int c = tid; c < kCells; c += nthreads) {
    const int gy = y0 + c / kRegion;
    const int gx = x0 + c % kRegion;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const float v = inside ? seed[gy * w + gx] : kBig;
    cur[c] = v;
    nxt[c] = v;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    for (int c = tid; c < kCells; c += nthreads) {
      const int ry = c / kRegion;
      const int rx = c % kRegion;
      const int gy = y0 + ry;
      const int gx = x0 + rx;
      const float d = cur[c];
      if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
        nxt[c] = d;  // pinned border value
        continue;
      }
      float m = d;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          if (dy == 0 && dx == 0) continue;
          const int ny = ry + dy;
          const int nx = rx + dx;
          if (ny < 0 || ny >= kRegion || nx < 0 || nx >= kRegion) continue;
          m = fminf(m, cur[ny * kRegion + nx] + 1.0f);
        }
      }
      nxt[c] = fminf(d, m);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  const int oy = blockIdx.y * kTile + threadIdx.y;
  const int ox = blockIdx.x * kTile + threadIdx.x;
  if (oy < h && ox < w) {
    out[oy * w + ox] =
        cur[(threadIdx.y + kHalo) * kRegion + (threadIdx.x + kHalo)];
  }
}

}  // namespace

extern "C" int sdv_distance_transform(const float* seed, float* out, int h,
                                      int w, int iters, void* stream) {
  if (iters < 0 || iters > kHalo) return static_cast<int>(cudaErrorInvalidValue);
  const int smem_bytes = 2 * kCells * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      distance_transform_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kTile, kTile);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  distance_transform_kernel<<<grid, block, smem_bytes,
                              static_cast<cudaStream_t>(stream)>>>(
      seed, out, h, w, iters);
  return static_cast<int>(cudaGetLastError());
}
