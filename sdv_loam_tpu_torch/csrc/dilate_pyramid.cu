// The whole hole-filling chain of the tracking-reference depth maps
// (makeCoarseDepthL0) in one launch.
//
// Replaces the TPU kernel sdv_loam_tpu/ops/pallas_kernels.py:_dilate_kernel
// (wrapper dilate_depth_pallas), which build_track_ref called once per
// pyramid level with XLA's 2x2 sum-pool in between. Here one launch does the
// whole chain, for every level and every lane:
//
//   D_0 = dilate(S_0, diagonal)
//   P_l = sum-pool of D_{l-1}: (x00 + x01) + (x10 + x11), odd row and
//         column cropped
//   D_l = dilate(P_l, diagonal if l < 2 else cross)
//
// dilate: each empty cell (weight <= 0) with at least one filled neighbour
// takes the mean of the neighbours' idepth sums and the mean of their
// weights; outside a level's own shape counts as empty (zero fill). The
// neighbours are summed in the TPU kernel's order (diagonal: ul, dr, ur, dl;
// cross: r, l, d, u) with IEEE division, so every level is bit-identical to
// the plain PyTorch chain (hopper_kernels.dilate_pyramid_plain).
//
// Bound on the card: bytes, and those few. At 360x1200 the chain reads two
// level-0 maps and writes the four levels' two maps, ~8 MB, 2.4 us at
// 3.35 TB/s, with ~10 flops per cell. What the chain of four single-pass
// launches lost was not the bytes but the fixed costs around them (four
// launches and eight pooling ops, each with its own wrapper and ramp), and
// the levels depend on each other across tiles. The design:
//
//  * a tile-local pyramid: each block owns a 64x64 tile of level 0 (8x8 of
//    level 3) and builds, in shared memory, the nested regions it needs down
//    to its level-3 tile: the level-0 region is 64 + 2 * 15 = 94 cells a
//    side, only the thin halos are computed twice (2.2x at level 0, less
//    below), and no block waits for another. A grid barrier between levels
//    (a persistent cooperative kernel) costs more than the chain's bytes
//    (20.7 us against this design's 10.6 us at 360x1200 on an H100), and
//    cooperative grids of several fleet streams can wait on each other;
//  * each thread computes a 2x2 block of a level from a 4x4 window and
//    writes the pooled cell of the next level straight from registers, so
//    neither the level maps nor the pools make a round trip through device
//    memory; a level's cells are written out only by the block whose tile
//    holds them;
//  * level-0 rows are read 16 bytes at a time where the width allows (both
//    presets: 1200 and 424), neighbouring threads on neighbouring addresses;
//  * a pyramid deeper than 4 levels (images of 1280x960 and up) finishes in
//    the same launch: the last block to finish its tile (a ticket taken
//    with an atomic after a fence) computes levels 4.. alone, from the
//    level-3 maps in device memory; those levels are 1/256 of level 0 and
//    smaller.
//
// Output layout (one buffer): for each level l, the lanes' idepth maps
// (lanes, h_l, w_l) then their weight maps; then the pooled maps P_4.. of a
// deeper pyramid, in the same layout, as scratch; then the ticket counter.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kTileLevels = 4;   // levels built tile by tile
constexpr int kMaxLevels = 8;    // hopper_kernels.DILATE_MAX_LEVELS
constexpr int kTile0 = 64;       // level-0 tile side
constexpr int kRegion0 = kTile0 + 2 * ((1 << kTileLevels) - 1);   // 94
constexpr int kLoadW = kTile0 + 32;   // level-0 columns loaded per row, 96
constexpr int kRegion1 = (kRegion0 - 2) / 2;                        // 46
constexpr int kSmemFloats = 2 * kRegion0 * kLoadW + 2 * kRegion1 * kRegion1;

struct Geometry {
  int h[kMaxLevels], w[kMaxLevels];
  int64_t out[kMaxLevels];    // offset of level l's idepth maps in `out`
  int64_t pool[kMaxLevels];   // offset of P_l (l >= kTileLevels)
  int64_t counter;            // offset of the ticket counter
  int levels, lanes;
};

__device__ __forceinline__ void accumulate(float vi, float vw, float& ssum,
                                           float& nsum, float& cnt) {
  const bool filled = vw > 0.0f;
  ssum = ssum + (filled ? vi : 0.0f);
  nsum = nsum + (filled ? vw : 0.0f);
  cnt = cnt + (filled ? 1.0f : 0.0f);
}

// one hole-filling cell at window position (r, c) (compile-time after
// unrolling), neighbours in the TPU kernel's order; the window holds zeros
// outside the level's shape
template <int N>
__device__ __forceinline__ void dilate_cell(const float (&wi)[N][N],
                                            const float (&ww)[N][N], int r,
                                            int c, bool diagonal, float& oi,
                                            float& ow) {
  float ssum = 0.0f, nsum = 0.0f, cnt = 0.0f;
  if (diagonal) {
    accumulate(wi[r + 1][c + 1], ww[r + 1][c + 1], ssum, nsum, cnt);  // ul
    accumulate(wi[r - 1][c - 1], ww[r - 1][c - 1], ssum, nsum, cnt);  // dr
    accumulate(wi[r + 1][c - 1], ww[r + 1][c - 1], ssum, nsum, cnt);  // ur
    accumulate(wi[r - 1][c + 1], ww[r - 1][c + 1], ssum, nsum, cnt);  // dl
  } else {
    accumulate(wi[r][c - 1], ww[r][c - 1], ssum, nsum, cnt);          // r
    accumulate(wi[r][c + 1], ww[r][c + 1], ssum, nsum, cnt);          // l
    accumulate(wi[r - 1][c], ww[r - 1][c], ssum, nsum, cnt);          // d
    accumulate(wi[r + 1][c], ww[r + 1][c], ssum, nsum, cnt);          // u
  }
  const float ci = wi[r][c], cw = ww[r][c];
  const bool fill_ok = (cw <= 0.0f) && (cnt > 0.0f);
  // the means, correctly rounded as IEEE division: cnt is 1, 2, 3 or 4, and
  // a power of two scales exactly (the same rounding of the same quotient),
  // so only a count of 3 divides
  const float scale = cnt == 4.0f ? 0.25f : (cnt == 2.0f ? 0.5f : 1.0f);
  float qi = ssum * scale, qw = nsum * scale;
  if (fill_ok && cnt == 3.0f) {
    qi = __fdiv_rn(ssum, 3.0f);
    qw = __fdiv_rn(nsum, 3.0f);
  }
  oi = fill_ok ? qi : ci;
  ow = fill_ok ? qw : cw;
}

__device__ __forceinline__ void store(const Geometry& g, float* out, int l,
                                      int lane, int y, int x, float vi,
                                      float vw) {
  const int64_t n = static_cast<int64_t>(g.lanes) * g.h[l] * g.w[l];
  const int64_t o = g.out[l] +
                    (static_cast<int64_t>(lane) * g.h[l] + y) * g.w[l] + x;
  out[o] = vi;
  out[o + n] = vw;
}

// level 0's region of the block's tile, zero outside the image, into
// shared memory (row stride kLoadW; column 0 is image column 64 tx - 16).
// Every load of a thread is issued before its first store, so the block
// waits for device memory once, not once per quad.
__device__ void load_level0(const float* __restrict__ idepth,
                            const float* __restrict__ weight, int h, int w,
                            int lane, int oy, int n, float* s_i, float* s_w) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  const float* li = idepth + lane * plane;
  const float* lw = weight + lane * plane;
  const int x0 = blockIdx.x * kTile0 - 16;
  const bool vec = (w % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(idepth) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(weight) % 16 == 0);
  constexpr int kQuads = kLoadW / 4;
  constexpr int kPerThread = (kRegion0 * kQuads + kThreads - 1) / kThreads;
  float4 vi[kPerThread], vw[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kQuads;
    const int x = x0 + 4 * (idx % kQuads);
    const int y = oy + r;
    vi[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    vw[k] = vi[k];
    if (r < n && y >= 0 && y < h) {
      const int64_t row = static_cast<int64_t>(y) * w;
      if (vec) {
        // x is a multiple of 4, and so is w: the quad is all in or all out
        if (x >= 0 && x < w) {
          vi[k] = __ldg(reinterpret_cast<const float4*>(li + row + x));
          vw[k] = __ldg(reinterpret_cast<const float4*>(lw + row + x));
        }
      } else {
        float ti[4], tw[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool in = x + c >= 0 && x + c < w;
          ti[c] = in ? __ldg(li + row + x + c) : 0.0f;
          tw[c] = in ? __ldg(lw + row + x + c) : 0.0f;
        }
        vi[k] = make_float4(ti[0], ti[1], ti[2], ti[3]);
        vw[k] = make_float4(tw[0], tw[1], tw[2], tw[3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    if (idx / kQuads < n) {
      reinterpret_cast<float4*>(s_i)[idx] = vi[k];
      reinterpret_cast<float4*>(s_w)[idx] = vw[k];
    }
  }
}

// levels >= kTileLevels, by one block, through device memory (read from
// L2: the level-3 maps were written by the other blocks)
__device__ void finish_deep_levels(const Geometry& g, float* out) {
  for (int l = kTileLevels; l < g.levels; ++l) {
    const int h = g.h[l], w = g.w[l], hp = g.h[l - 1], wp = g.w[l - 1];
    const int64_t n = static_cast<int64_t>(g.lanes) * h * w;
    const int64_t np = static_cast<int64_t>(g.lanes) * hp * wp;
    float* p_i = out + g.pool[l];
    float* p_w = p_i + n;
    const float* d_i = out + g.out[l - 1];
    const float* d_w = d_i + np;
    for (int64_t idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int x = static_cast<int>(idx % w);
      const int64_t t = idx / w;
      const int y = static_cast<int>(t % h);
      const int64_t base = (t / h) * hp * wp + 2 * static_cast<int64_t>(y) *
                           wp + 2 * x;
      p_i[idx] = (__ldcg(d_i + base) + __ldcg(d_i + base + 1)) +
                 (__ldcg(d_i + base + wp) + __ldcg(d_i + base + wp + 1));
      p_w[idx] = (__ldcg(d_w + base) + __ldcg(d_w + base + 1)) +
                 (__ldcg(d_w + base + wp) + __ldcg(d_w + base + wp + 1));
    }
    __syncthreads();
    for (int64_t idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int x = static_cast<int>(idx % w);
      const int64_t t = idx / w;
      const int y = static_cast<int>(t % h);
      const int lane = static_cast<int>(t / h);
      float wi[3][3], ww[3][3];
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int yy = y + r - 1, xx = x + c - 1;
          const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
          const int64_t o = (static_cast<int64_t>(lane) * h + yy) * w + xx;
          wi[r][c] = in ? __ldcg(p_i + o) : 0.0f;
          ww[r][c] = in ? __ldcg(p_w + o) : 0.0f;
        }
      }
      float oi, ow;
      dilate_cell<3>(wi, ww, 1, 1, l < 2, oi, ow);
      store(g, out, l, lane, y, x, oi, ow);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dilate_pyramid_kernel(const float* __restrict__ idepth0,
                      const float* __restrict__ weight0, float* out,
                      const Geometry g) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // A holds level 0's region, then P_2; B holds P_1, then P_3
  float* const a_i = smem;
  float* const a_w = smem + kRegion0 * kLoadW;
  float* const b_i = smem + 2 * kRegion0 * kLoadW;
  float* const b_w = b_i + kRegion1 * kRegion1;
  const int lane = blockIdx.z;
  const int G = g.levels < kTileLevels ? g.levels : kTileLevels;
  const int halo = (1 << G) - 1;   // level-0 input halo of a G-level pyramid
  // the block's input region at the current level: side n, origin (oy, ox),
  // in shared memory with row stride `stride`, column c at c + coff
  int n = kTile0 + 2 * halo;
  int oy = blockIdx.y * kTile0 - halo;
  int ox = blockIdx.x * kTile0 - halo;
  int stride = kLoadW;
  int coff = 16 - halo;
  bool in_a = true;   // the current level's input is in A
  load_level0(idepth0, weight0, g.h[0], g.w[0], lane, oy, n, a_i, a_w);
  __syncthreads();

#pragma unroll
  for (int l = 0; l < kTileLevels; ++l) {   // unrolled: l is a constant
    if (l >= G) break;
    const bool diagonal = l < 2;
    const float* in_i = in_a ? a_i : b_i;
    const float* in_w = in_a ? a_w : b_w;
    const int ty0 = (blockIdx.y * kTile0) >> l;   // the block's tile of l
    const int tx0 = (blockIdx.x * kTile0) >> l;
    const int ts = kTile0 >> l;
    if (l + 1 < G) {
      // 2x2 cells of D_l from 4x4 windows, and the pooled cell of P_{l+1}
      const int m = (n - 2) / 2;
      const int py0 = (oy + 1) / 2, px0 = (ox + 1) / 2;   // P's origin
      float* p_i = in_a ? b_i : a_i;
      float* p_w = in_a ? b_w : a_w;
      for (int idx = threadIdx.x; idx < m * m; idx += blockDim.x) {
        const int i = idx / m, j = idx % m;
        float wi[4][4], ww[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = (2 * i + r) * stride + 2 * j + c + coff;
            wi[r][c] = in_i[s];
            ww[r][c] = in_w[s];
          }
        }
        float di[2][2], dw[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            dilate_cell<4>(wi, ww, r + 1, c + 1, diagonal, di[r][c],
                           dw[r][c]);
            const int y = oy + 1 + 2 * i + r, x = ox + 1 + 2 * j + c;
            if (y >= ty0 && y < ty0 + ts && x >= tx0 && x < tx0 + ts &&
                y < g.h[l] && x < g.w[l])
              store(g, out, l, lane, y, x, di[r][c], dw[r][c]);
          }
        }
        const int py = py0 + i, px = px0 + j;
        const bool in = py >= 0 && py < g.h[l + 1] && px >= 0 &&
                        px < g.w[l + 1];
        p_i[i * m + j] = in ? (di[0][0] + di[0][1]) + (di[1][0] + di[1][1])
                            : 0.0f;
        p_w[i * m + j] = in ? (dw[0][0] + dw[0][1]) + (dw[1][0] + dw[1][1])
                            : 0.0f;
      }
      __syncthreads();
      n = m;
      oy = py0;
      ox = px0;
      stride = m;
      coff = 0;
      in_a = !in_a;
    } else {
      // the last tile level: its tile's cells from 3x3 windows
      for (int idx = threadIdx.x; idx < ts * ts; idx += blockDim.x) {
        const int i = idx / ts, j = idx % ts;
        const int y = ty0 + i, x = tx0 + j;
        if (y >= g.h[l] || x >= g.w[l]) continue;
        float wi[3][3], ww[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int s = (i + r) * stride + j + c + coff;
            wi[r][c] = in_i[s];
            ww[r][c] = in_w[s];
          }
        }
        float oi, ow;
        dilate_cell<3>(wi, ww, 1, 1, diagonal, oi, ow);
        store(g, out, l, lane, y, x, oi, ow);
      }
    }
  }

  if (g.levels > kTileLevels) {
    // the last block to finish its tile computes the deeper levels
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* counter = reinterpret_cast<unsigned*>(out + g.counter);
      const unsigned blocks = gridDim.x * gridDim.y * gridDim.z;
      last = atomicAdd(counter, 1u) == blocks - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    finish_deep_levels(g, out);
  }
}

bool set_smem_attribute() {
  static bool done[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return false;
  if (!done[dev]) {
    if (cudaFuncSetAttribute(dilate_pyramid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemFloats * sizeof(float)) != cudaSuccess)
      return false;
    done[dev] = true;
  }
  return true;
}

}  // namespace

// idepth0 / weight0: (lanes, h0, w0) maps; out: the buffer described above,
// at least (2 * sum of the levels' cells + 2 * sum of the cells of levels
// >= 4) * lanes + 1 floats (the wrapper sizes it). Returns a cudaError_t.
extern "C" int sdv_dilate_pyramid(const float* idepth0, const float* weight0,
                                  float* out, int lanes, int h0, int w0,
                                  int levels, void* stream) {
  if (levels < 1 || levels > kMaxLevels || lanes < 0 || h0 < 0 || w0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geometry g{};
  g.levels = levels;
  g.lanes = lanes;
  int64_t off = 0;
  for (int l = 0; l < levels; ++l) {
    g.h[l] = l == 0 ? h0 : g.h[l - 1] / 2;
    g.w[l] = l == 0 ? w0 : g.w[l - 1] / 2;
    g.out[l] = off;
    off += 2 * static_cast<int64_t>(lanes) * g.h[l] * g.w[l];
  }
  for (int l = kTileLevels; l < levels; ++l) {
    g.pool[l] = off;
    off += 2 * static_cast<int64_t>(lanes) * g.h[l] * g.w[l];
  }
  g.counter = off;
  if (static_cast<int64_t>(lanes) * h0 * w0 == 0)
    return static_cast<int>(cudaSuccess);
  if (levels > kTileLevels) {
    const cudaError_t err =
        cudaMemsetAsync(out + g.counter, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!set_smem_attribute()) return static_cast<int>(cudaGetLastError());
  const dim3 grid((w0 + kTile0 - 1) / kTile0, (h0 + kTile0 - 1) / kTile0,
                  lanes);
  dilate_pyramid_kernel<<<grid, kThreads, kSmemFloats * sizeof(float), st>>>(
      idepth0, weight0, out, g);
  return static_cast<int>(cudaGetLastError());
}
