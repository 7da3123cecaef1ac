// Hole-filling pass of the tracking-reference depth maps (makeCoarseDepthL0).
//
// Replaces the TPU kernel sdv_loam_tpu/ops/pallas_kernels.py:_dilate_kernel
// (wrapper dilate_depth_pallas). Each empty cell (weight <= 0) with at least
// one filled neighbour takes the mean of the neighbours' idepth sums and the
// mean of their weights. Neighbours are the 4 diagonals (levels 0-1) or the
// 4-cross (levels >= 2); outside the image counts as empty (zero fill).
//
// Bound on the card: bytes. One pass reads two float maps and writes two
// (at most 360x1200, 1.7 MB each), with ~10 flops per cell. The TPU kernel
// kept the whole map in VMEM; here the maps are far larger than one block's
// shared memory but small enough to stay in the 50 MB L2, so the design is
// one thread per output cell reading its 4 neighbours straight from global
// memory: the 3x3 reuse is served by L1/L2, adjacent threads touch adjacent
// addresses, and nothing is staged. The neighbours are summed in the TPU
// kernel's order (cross: r, l, d, u; diagonal: ul, dr, ur, dl) with IEEE
// division, so the result is bit-identical to the plain PyTorch version.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void accumulate(const float* __restrict__ idepth,
                                           const float* __restrict__ weight,
                                           int h, int w, int y, int x,
                                           float& ssum, float& nsum,
                                           float& cnt) {
  if (y < 0 || y >= h || x < 0 || x >= w) {
    // zero fill: an empty neighbour adds exact zeros
    ssum = ssum + 0.0f;
    nsum = nsum + 0.0f;
    cnt = cnt + 0.0f;
    return;
  }
  const float wn = weight[y * w + x];
  const bool filled = wn > 0.0f;
  ssum = ssum + (filled ? idepth[y * w + x] : 0.0f);
  nsum = nsum + (filled ? wn : 0.0f);
  cnt = cnt + (filled ? 1.0f : 0.0f);
}

__global__ void dilate_depth_kernel(const float* __restrict__ idepth,
                                    const float* __restrict__ weight,
                                    float* __restrict__ out_i,
                                    float* __restrict__ out_w,
                                    int h, int w, int diagonal) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  float ssum = 0.0f, nsum = 0.0f, cnt = 0.0f;
  if (diagonal) {
    accumulate(idepth, weight, h, w, y + 1, x + 1, ssum, nsum, cnt);  // ul
    accumulate(idepth, weight, h, w, y - 1, x - 1, ssum, nsum, cnt);  // dr
    accumulate(idepth, weight, h, w, y + 1, x - 1, ssum, nsum, cnt);  // ur
    accumulate(idepth, weight, h, w, y - 1, x + 1, ssum, nsum, cnt);  // dl
  } else {
    accumulate(idepth, weight, h, w, y, x - 1, ssum, nsum, cnt);      // r
    accumulate(idepth, weight, h, w, y, x + 1, ssum, nsum, cnt);      // l
    accumulate(idepth, weight, h, w, y - 1, x, ssum, nsum, cnt);      // d
    accumulate(idepth, weight, h, w, y + 1, x, ssum, nsum, cnt);      // u
  }
  const int i = y * w + x;
  const float di = idepth[i];
  const float wt = weight[i];
  const bool fill_ok = (wt <= 0.0f) && (cnt > 0.0f);
  const float denom = fmaxf(cnt, 1.0f);
  out_i[i] = fill_ok ? __fdiv_rn(ssum, denom) : di;
  out_w[i] = fill_ok ? __fdiv_rn(nsum, denom) : wt;
}

}  // namespace

extern "C" int sdv_dilate_depth(const float* idepth, const float* weight,
                                float* out_i, float* out_w, int h, int w,
                                int diagonal, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  dilate_depth_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      idepth, weight, out_i, out_w, h, w, diagonal);
  return static_cast<int>(cudaGetLastError());
}
