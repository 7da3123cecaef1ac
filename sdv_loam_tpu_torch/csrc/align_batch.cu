// The matcher's patch warp and inverse-compositional patch alignment (SVO's
// warpAffine, Reprojector.cpp:51-82, then align2D for corners and align1D
// for edgelets, :344-551, reached from findMatchDirect :238-293): every
// candidate row of a matcher call, its border patch and its whole
// Gauss-Newton loop, in one launch.
//
// Stands for the JAX package's `warp_affine_patches` (K6,
// sdv_loam_tpu/ops/align.py:147) and `align_batch` (K5, :319, a
// `lax.while_loop` whose body XLA fuses); no Pallas kernel exists for
// either. Plain PyTorch versions: hopper_kernels.warp_affine_patches_plain
// and align_batch_plain (`align_setup`, then the batched loop of
// `align_body` through device_loop.run("align"), which runs while any row
// is still running and at most n_iter times); the fused call's is
// warp_align_plain, the one then the other. This kernel computes:
//   * the patch warp (K6), per row: the inverse of A_cur_ref (2x2) with
//     its non-finite entries set to 0; per pixel (x, y) of the 10x10 grid
//     the offset ((x - 5) s, (y - 5) s), s = 2^warp_level, mapped through
//     that inverse and moved to px_ref; the in-image test 0 <= x < w - 1,
//     0 <= y < h - 1; the clamp to [0, w - 1.001] x [0, h - 1.001]; the
//     bilinear sample of the host frames' quad pack (a row [I(x,y),
//     I(x+1,y), I(x,y+1), I(x+1,y+1)] per pixel) at row
//     host_idx h w + y0 w + x0; 0 outside the image, NaN where that row
//     lies outside the pack (as the plain version's gather reads it);
//   * the alignment's setup (K5), per valid row: from the 10x10 patch the
//     8x8 reference patch and its central differences dx, dy; J = [dx, dy,
//     1] for a corner, [dgrad, 1, 0] with dgrad = d0 dx + d1 dy for an
//     edgelet; the target aff_a ref + aff_b; H = sum J J^T over the 64
//     pixels and Hinv = inv(H + 1e-9 I), non-finite entries set to 0;
//   * per iteration, while the row runs and fewer than n_iter have run:
//     the in-bounds test of floor(u), floor(v) against the row's level
//     width and height (a row that fails it stops, alive false); the 64
//     samples at min(max(u, 4), w - 4) + (x - 4) (and v alike), each one
//     16-byte quad row of the target pyramid at base + y0 w + x0 (NaN for
//     a row outside the pack); res = cur - target + mean_diff;
//     Jres = -sum res J; upd = Hinv Jres; the corner update of u, v and
//     mean_diff, or the edgelet's step along the direction; converged
//     when upd0^2 + upd1^2 < 0.03^2 (then the row stops);
//   * out: px = (u, v), conv & valid, and per lane (n_lanes, 2) the
//     counts of the failure masks valid & ~conv & ~alive (walked out of
//     bounds) and valid & ~conv & alive (out of iterations): a failing
//     row's warp adds one with an atomic to counts a small kernel zeroed
//     on the same stream first (the plain version sums its masks, a
//     reduction kernel of its own on the card).
// Modes: kFused (the matcher's call: warp, then align; no patch leaves the
// chip), kAlign (align the given border patches: hopper_kernels.align_batch)
// and kPatches (warp every row's patch and write it out, align nothing:
// hopper_kernels.warp_affine_patches).
// Row by row this is the batched loop: the rows never meet (a row's step
// reads only its own carries), and a row that has stopped keeps every
// carry there, so its loop may as well end when it stops. Each row's warp
// leaves at its own stop; no row waits on another.
//
// Bound on the card: latency. A running row's iteration reads 64 quad
// rows (1 KB) and does ~2,300 operations; its patch warp reads 100 quad
// rows of the host frames. At the main path's 2560 rows that is a few MB
// and a few hundredths of a GFLOP, microseconds at the card's memory and
// float32 rates. What costs is one row's chain: the patch's loads, the
// float64 setup, then per iteration the samples, a warp reduction and a
// 3x3 product, each waiting on the one before. The design:
//   * a warp per row, kWarps rows a block, lane l owning the patch pixels
//     l and l + 32 (p = 8 y + x) in the alignment and p = l + 32 k < 100
//     in the warp; the row's scalars (u, v, mean_diff) are held by every
//     lane and Hinv's rows by a third of the lanes each, so the loop runs
//     with no barrier but __syncwarp;
//   * the patch goes into a per-warp shared-memory patch (400 bytes) and
//     the setup reads it there: in the fused mode it never goes through
//     device memory;
//   * each lane factors H (the LU), and each third of the warp solves
//     one column of its inverse (inverse3_column: six float64 divisions a
//     lane where twelve were), passed on by shuffles;
//   * a row's inputs are read at once, then K6's loads are issued and the
//     level tables read, so that their latencies overlap;
//   * every sample reads its quad row from the pack through __ldg: after a
//     row's first iteration its samples are L1 hits. Staging a search
//     window of quad rows in shared memory by cp.async was slower on an
//     H100 at every reach tried (0-4 pixels; PERF.md);
//   * 2560 rows are one wave of 320 blocks (kMinBlocks).
//
// Precision. Per-pixel quantities are float32, each operation rounded on
// its own as the plain versions' tensor operations round it (__fadd_rn,
// __fsub_rn, __fmul_rn: no contraction): the warp's source point
// (Ainv[i][0] ox + Ainv[i][1] oy) + px_ref[i] (the plain version's einsum
// may contract it: a float32 ulp of the point), dx = 0.5 (b[x+1] -
// b[x-1]), dgrad = d0 dx + d1 dy, target = aff_a ref + aff_b, the sample
// point, the weights (1 - ax)(1 - ay), ax(1 - ay), (1 - ax) ay, ax ay, the
// sample ((q0 w0 + q1 w1) + q2 w2) + q3 w3, and res = (cur - target) +
// mean_diff. The 64-term sums (H's six distinct entries, the three of J^T
// res) are taken in float64 over exact products and rounded to float32
// once, where the plain version sums in float32. The inverses are LU with
// partial pivoting (the first row of strictly largest |a| below the
// diagonal; a NaN never wins) and the triangular solves against the
// identity, in float64 from the float32 entries, each entry rounded to
// float32 once and set to 0 when not finite (the plain versions' inv_ex
// solves in float32: an entry differs by a few float32 ulps). H + 1e-9 I
// is formed in float32. upd_i = sum_j Hinv_ij Jres_j is a float64 sum of
// exact products, j = 0, 1, 2 in order, rounded once. An edgelet's H has a
// zero third row and column, so its Hinv has exact zeros there and ~1e9
// on the diagonal; Jres_2 = -sum res 0 is an exact (signed) zero for
// finite res, so upd keeps the plain version's value (no inf 0), and a
// non-finite res makes every upd entry NaN, as the plain version's does.
//
// Reduction order of a sum over the 64 pixels (fixed: it depends on
// nothing but the row): lane l adds its two pixels' terms, l then l + 32;
// then five butterfly stages, each lane adding the partner's partial sum
// at lane distance 16, 8, 4, 2, 1 (__shfl_xor_sync); addition commutes, so
// every lane of a butterfly ends with the same bits, and three sums are
// finished in a third of the warp each (warp_sum3), which also computes
// one row of upd each.
//
// An iteration's time is its chain of dependent steps, not a load (after
// the first iteration a row's samples are L1 hits): the samples, the
// conversions to float64 and back (the SM converts 16 a clock), the
// shuffles of the sums (32 lanes a clock) and the 3x3 product; warp_sum3
// halves the shuffles and the conversions of three butterflies and three
// full rows of upd.
//
// Device counters (g_launches, one per mode, and one for the zeroing kernel
// that runs before every aligning launch) are incremented by one thread per
// launch, so launches captured in a CUDA graph, also inside its IF and
// WHILE nodes, are counted each time they run; sdv_warp_align_counts reads
// or resets them (the caller synchronizes the device first).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;            // rows (warps) per block
constexpr int kHalf = 4;             // HALF_PATCH
constexpr int kPatch = 8;            // PATCH
constexpr int kBorder = 10;          // BORDER_PATCH
constexpr int kPixels = kBorder * kBorder;
constexpr int kCenter = 5;           // HALF_PATCH + 1
// blocks an SM must hold at once: 3 of 8 rows, 2560 rows in one wave on 132
// SMs, caps a thread at 80 registers
constexpr int kMinBlocks = 3;
constexpr float kMinUpdateSq = static_cast<float>(0.03 * 0.03);
constexpr float kEps = 1e-9f;        // H's regulariser
constexpr unsigned kAll = 0xffffffffu;

enum Mode { kFused = 0, kAlign = 1, kPatches = 2, kModes = 3 };
// g_launches: one counter per mode, then zero_counts' launches
constexpr int kZeroCounter = kModes;
constexpr int kCounters = kModes + 1;

__device__ unsigned long long g_launches[kCounters];

struct Args {
  // the alignment: the target pyramids' quad pack and level tables
  const float4* quad;          // (T, 4)
  long long quad_rows;         // T
  const long long* offsets;    // level tables, indexed by search_level
  const long long* widths;
  const long long* heights;
  const long long* level;      // (M,) search_level
  // the patch warp: the host frames' quad pack (F h w, 4)
  const float4* host_quad;
  long long host_rows;
  const long long* host;       // (M,) host_idx
  const float* px_ref;         // (M, 2)
  const float* A;              // (M, 2, 2) A_cur_ref
  const long long* warp_level; // (M,)
  const float* border;         // (M, 10, 10): kAlign's given patches
  const float* px0;            // (M, 2) px_init_scaled
  const float* dir;            // (M, 2)
  const bool* is_edge;         // (M,)
  const bool* valid;           // (M,)
  const float* aff_a;          // (M,)
  const float* aff_b;          // (M,)
  float* px;                   // (M, 2)
  bool* conv;                  // (M,)
  // (lanes, 2): per lane the rows that walked out of bounds and those out
  // of iterations, zeroed by zero_counts before the launch
  unsigned long long* fails;
  long long lane_rows;         // rows a lane
  float* patches;              // (M, 10, 10): kPatches' output
  long long rows;
  int h, w;                    // the host frames' size
  float xmax, ymax;            // w - 1.001 and h - 1.001 as float32
  int n_iter;
  int mode;
};

__device__ __forceinline__ float nan_f() {
  return __int_as_float(0x7fc00000);
}

// Three sums over the warp of each lane's partial sums a, b, c, each in
// the order of the five-stage butterfly (lane distance 16, 8, 4, 2, 1,
// each lane adding its partner's partial sum to its own), which leaves
// every lane of a butterfly with the same bits, so each sum may be
// finished in a part of the warp alone: after the first stage lanes 0-15
// keep a and b and lanes 16-31 keep c (each lane receives what it keeps),
// after the second lanes 0-7 keep a and lanes 8-15 b. Returns the lane's
// group's sum: a in lanes 0-7, b in 8-15, c in 16-31 (`group`). Six
// 64-bit shuffles where three butterflies take fifteen.
__device__ __forceinline__ double warp_sum3(double a, double b, double c,
                                           int lane) {
  const bool low = lane < 16;
  const double r0 = __shfl_xor_sync(kAll, low ? c : a, 16);
  const double r1 = __shfl_xor_sync(kAll, b, 16);
  if (low) {
    a = __dadd_rn(a, r0);
    b = __dadd_rn(b, r1);
  } else {
    c = __dadd_rn(c, r0);
  }
  const bool first = (lane & 8) == 0;
  double mine = low ? (first ? a : b) : c;
  mine = __dadd_rn(mine, __shfl_xor_sync(kAll, low ? (first ? b : a) : c,
                                         8));
#pragma unroll
  for (int m = 4; m >= 1; m >>= 1)
    mine = __dadd_rn(mine, __shfl_xor_sync(kAll, mine, m));
  return mine;
}

// the sum of warp_sum3 that a lane holds (0: lanes 0-7, 1: 8-15, 2:
// 16-31), and the first lane of group i
__device__ __forceinline__ int group(int lane) {
  return lane < 8 ? 0 : lane < 16 ? 1 : 2;
}
__device__ __forceinline__ int group_lane(int i) { return 8 * i; }

// a float of group i's lanes, to every lane
__device__ __forceinline__ float from_group(float v, int i) {
  return __shfl_sync(kAll, v, group_lane(i));
}

__device__ __forceinline__ float finite_or_zero(double x) {
  const float f = static_cast<float>(x);
  return isfinite(f) ? f : 0.0f;
}

// the bilinear sum of a quad row at the fractions ax, ay:
// ((q0 w0 + q1 w1) + q2 w2) + q3 w3, each product and sum rounded
__device__ __forceinline__ float bilinear(const float4 q, float ax,
                                          float ay) {
  const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(q.x, __fmul_rn(bx, by)),
                          __fmul_rn(q.y, __fmul_rn(ax, by))),
                __fmul_rn(q.z, __fmul_rn(bx, ay))),
      __fmul_rn(q.w, __fmul_rn(ax, ay)));
}

// inv(A) of a row-major 2x2 (float32 entries), float64 LU with partial
// pivoting (row 1 is the pivot when |A10| > |A00|, so a NaN never wins) and
// the two triangular solves against the identity; each entry rounded
// once, non-finite ones 0
__device__ __forceinline__ void inverse2(const float* A, float inv[2][2]) {
  double a[2][2] = {{A[0], A[1]}, {A[2], A[3]}};
  const bool swap = fabs(a[1][0]) > fabs(a[0][0]);
  if (swap) {
    const double t0 = a[0][0], t1 = a[0][1];
    a[0][0] = a[1][0];
    a[0][1] = a[1][1];
    a[1][0] = t0;
    a[1][1] = t1;
  }
  const double l = __ddiv_rn(a[1][0], a[0][0]);
  const double u11 = __dsub_rn(a[1][1], __dmul_rn(l, a[0][1]));
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    // column c of inv(A) solves A x = e_c: P e_c, then L, then U
    const double b0 = (swap ? c == 1 : c == 0) ? 1.0 : 0.0;
    const double b1 = (swap ? c == 0 : c == 1) ? 1.0 : 0.0;
    const double y1 = __dsub_rn(b1, __dmul_rn(l, b0));
    const double x1 = __ddiv_rn(y1, u11);
    const double x0 = __ddiv_rn(__dsub_rn(b0, __dmul_rn(a[0][1], x1)),
                                a[0][0]);
    inv[0][c] = finite_or_zero(x0);
    inv[1][c] = finite_or_zero(x1);
  }
}

// Column c of inv(A) of a 3x3 (float32 entries): float64 LU with partial
// pivoting, then the solve against e_c; each entry rounded once,
// non-finite ones 0 (the warp solves the three columns in three groups of
// lanes at once, each lane three divisions of the solves where all nine
// were)
__device__ __forceinline__ void inverse3_column(const float A[3][3], int c,
                                                float col[3]) {
  double a[3][3];
  int perm[3] = {0, 1, 2};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) a[i][j] = A[i][j];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    double best = fabs(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (fabs(a[i][k]) > best) {
        best = fabs(a[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const double t = a[k][j];
          a[k][j] = a[i][j];
          a[i][j] = t;
        }
        const int t = perm[k];
        perm[k] = perm[i];
        perm[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const double l = __ddiv_rn(a[i][k], a[k][k]);
      a[i][k] = l;
#pragma unroll
      for (int j = k + 1; j < 3; ++j)
        a[i][j] = __dsub_rn(a[i][j], __dmul_rn(l, a[k][j]));
    }
  }
  double y[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    y[i] = perm[i] == c ? 1.0 : 0.0;
#pragma unroll
    for (int j = 0; j < i; ++j)
      y[i] = __dsub_rn(y[i], __dmul_rn(a[i][j], y[j]));
  }
#pragma unroll
  for (int i = 2; i >= 0; --i) {
#pragma unroll
    for (int j = i + 1; j < 3; ++j)
      y[i] = __dsub_rn(y[i], __dmul_rn(a[i][j], y[j]));
    y[i] = __ddiv_rn(y[i], a[i][i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) col[i] = finite_or_zero(y[i]);
}

// K6, first half: the row's warp read (A_cur_ref, px_ref, host slot,
// level), its inverse, and each of the lane's border pixels p = lane + 32 k
// (k < 4, p < 100): the bilinear fractions and the quad row's load, issued
// here and read in warp_patch_finish (so that other loads can be issued
// between)
struct PatchLoads {
  float4 q[4];
  float ax[4], ay[4];
  unsigned inside;             // bit k: pixel k inside the image
  unsigned in_pack;            // bit k: its quad row inside the pack
};

__device__ __forceinline__ void warp_patch_issue(const Args& a,
                                                 long long row, int lane,
                                                 PatchLoads& l) {
  float inv[2][2];
  inverse2(a.A + 4 * row, inv);
  // the grid offset times 2^level: exact (small integers, a power of 2)
  const float scale = ldexpf(1.0f, static_cast<int>(a.warp_level[row]));
  const float prx = a.px_ref[2 * row], pry = a.px_ref[2 * row + 1];
  const long long hbase = a.host[row] * a.h * a.w;
  l.inside = l.in_pack = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = lane + 32 * k;
    const float ox = static_cast<float>(p % kBorder - kCenter) * scale;
    const float oy = static_cast<float>(p / kBorder - kCenter) * scale;
    const float x = __fadd_rn(
        __fadd_rn(__fmul_rn(inv[0][0], ox), __fmul_rn(inv[0][1], oy)), prx);
    const float y = __fadd_rn(
        __fadd_rn(__fmul_rn(inv[1][0], ox), __fmul_rn(inv[1][1], oy)), pry);
    const float xc = fminf(fmaxf(x, 0.0f), a.xmax);
    const float yc = fminf(fmaxf(y, 0.0f), a.ymax);
    const float x0 = floorf(xc), y0 = floorf(yc);
    l.ax[k] = __fsub_rn(xc, x0);
    l.ay[k] = __fsub_rn(yc, y0);
    const long long idx = hbase + static_cast<long long>(y0) * a.w +
                          static_cast<long long>(x0);
    const bool inside = p < kPixels && x >= 0.0f && y >= 0.0f &&
                        x < static_cast<float>(a.w - 1) &&
                        y < static_cast<float>(a.h - 1);
    const bool ok = inside && idx >= 0 && idx < a.host_rows;
    l.inside |= static_cast<unsigned>(inside) << k;
    l.in_pack |= static_cast<unsigned>(ok) << k;
    l.q[k] = ok ? __ldg(a.host_quad + idx) : make_float4(0, 0, 0, 0);
  }
}

// K6, second half: the samples into `patch` (and into a.patches in
// kPatches): 0 outside the image, NaN inside it where the quad row lies
// outside the pack
__device__ __forceinline__ void warp_patch_finish(const Args& a,
                                                  long long row, int lane,
                                                  const PatchLoads& l,
                                                  float* patch) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = lane + 32 * k;
    if (p >= kPixels) break;
    float val = 0.0f;
    if (l.inside >> k & 1u)
      val = l.in_pack >> k & 1u ? bilinear(l.q[k], l.ax[k], l.ay[k])
                                : nan_f();
    patch[p] = val;
    if (a.mode == kPatches) a.patches[kPixels * row + p] = val;
  }
}

// one pixel's bilinear sample of the row's level (its first quad row
// `base`, width w) from the pack, NaN where the quad row lies outside it
__device__ __forceinline__ float sample(const Args& a, long long base, int w,
                                        float x, float y) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float ax = __fsub_rn(x, x0), ay = __fsub_rn(y, y0);
  const int xi = static_cast<int>(x0), yi = static_cast<int>(y0);
  const long long idx = base + (yi * w + xi);
  return idx >= 0 && idx < a.quad_rows
             ? bilinear(__ldg(a.quad + idx), ax, ay)
             : nan_f();
}

__global__ void __launch_bounds__(32 * kWarps, kMinBlocks)
    warp_align_kernel(Args a) {
  __shared__ float s_patch[kWarps][kPixels];
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_launches[a.mode], 1ull);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + wid;
  if (row >= a.rows) return;           // the whole warp: a row is a warp
  float* patch = s_patch[wid];
  PatchLoads pl;
  if (a.mode == kPatches) {
    warp_patch_issue(a, row, lane, pl);
    warp_patch_finish(a, row, lane, pl, patch);
    return;
  }
  // the row's inputs, all read at once
  const bool valid = a.valid[row];
  float u = a.px0[2 * row], v = a.px0[2 * row + 1];
  const long long lvl = a.level[row];
  const bool edge = a.is_edge[row];
  const float d0 = a.dir[2 * row], d1 = a.dir[2 * row + 1];
  const float fa = a.aff_a[row], fb = a.aff_b[row];
  bool conv = false, alive = valid;
  if (valid && a.n_iter > 0) {
    // K6's loads (or the given patch's), then the level tables
    if (a.mode == kFused) {
      warp_patch_issue(a, row, lane, pl);
    } else {
      const float* bp = a.border + kPixels * row;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = lane + 32 * k;
        if (p < kPixels) patch[p] = bp[p];
      }
    }
    const long long base = a.offsets[lvl];
    const int wv = static_cast<int>(a.widths[lvl]);
    const int hv = static_cast<int>(a.heights[lvl]);
    const float wm = static_cast<float>(wv - kHalf);
    const float hm = static_cast<float>(hv - kHalf);
    // a row that fails the first in-bounds test stops there: no setup
    const bool runs = floorf(u) >= kHalf && floorf(v) >= kHalf &&
                      floorf(u) < wm && floorf(v) < hm;
    if (a.mode == kFused) warp_patch_finish(a, row, lane, pl, patch);
    __syncwarp();
    if (!runs) {
      alive = false;                   // out of the level at its start
    } else {
      // the lane's two pixels (p = lane + 32 k: the same x, y 4 k apart):
      // J, target, and the offsets of the samples
      const int px = lane % kPatch, py = lane / kPatch;
      float J[2][3], target[2];
      double h6[6] = {0, 0, 0, 0, 0, 0};   // H00 H01 H02 H11 H12 H22
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float* c = patch + (py + 4 * k + 1) * kBorder + (px + 1);
        const float dx = 0.5f * __fsub_rn(c[1], c[-1]);
        const float dy = 0.5f * __fsub_rn(c[kBorder], c[-kBorder]);
        if (edge) {
          J[k][0] = __fadd_rn(__fmul_rn(d0, dx), __fmul_rn(d1, dy));
          J[k][1] = 1.0f;
          J[k][2] = 0.0f;
        } else {
          J[k][0] = dx;
          J[k][1] = dy;
          J[k][2] = 1.0f;
        }
        target[k] = __fadd_rn(__fmul_rn(fa, c[0]), fb);
        int n = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = i; j < 3; ++j, ++n)
            h6[n] = __dadd_rn(h6[n], __dmul_rn(J[k][i], J[k][j]));
      }
      const float s1 = static_cast<float>(
          warp_sum3(h6[0], h6[1], h6[2], lane));
      const float s2 = static_cast<float>(
          warp_sum3(h6[3], h6[4], h6[5], lane));
      // H + 1e-9 I in float32, as the plain version adds eye * 1e-9 (a +0
      // off the diagonal, which makes a -0 sum +0)
      float H[3][3];
      H[0][0] = from_group(s1, 0);
      H[0][1] = H[1][0] = from_group(s1, 1);
      H[0][2] = H[2][0] = from_group(s1, 2);
      H[1][1] = from_group(s2, 0);
      H[1][2] = H[2][1] = from_group(s2, 1);
      H[2][2] = from_group(s2, 2);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          H[i][j] = __fadd_rn(H[i][j], i == j ? kEps : 0.0f);
      // the row of Hinv whose product with Jres the lane's group takes:
      // group j solves column j, whose lanes 0, 1, 2 (of the group) then
      // hold its entries 0, 1, 2 for the groups' rows
      double hrow[3];
      {
        const int g = group(lane);
        float col[3];
        inverse3_column(H, g, col);
        const int k = lane - group_lane(g);
        const float entry = k == 0 ? col[0] : k == 1 ? col[1] : col[2];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          hrow[j] = __shfl_sync(kAll, entry, group_lane(j) + g);
      }

      const float ox = static_cast<float>(px - kHalf);
      const float oy = static_cast<float>(py - kHalf);
      float md = 0.0f;
      for (int it = 0; it < a.n_iter; ++it) {
        const float ur = floorf(u), vr = floorf(v);
        if (!(ur >= kHalf && vr >= kHalf && ur < wm && vr < hm)) {
          alive = false;               // walked out of the level
          break;
        }
        const float uc = fminf(fmaxf(u, static_cast<float>(kHalf)), wm);
        const float vc = fminf(fmaxf(v, static_cast<float>(kHalf)), hm);
        double jr[3] = {0, 0, 0};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float cur = sample(a, base, wv, __fadd_rn(uc, ox),
                                   __fadd_rn(vc, oy + 4.0f * k));
          const float res = __fadd_rn(__fsub_rn(cur, target[k]), md);
#pragma unroll
          for (int i = 0; i < 3; ++i)
            jr[i] = __dadd_rn(jr[i], __dmul_rn(res, J[k][i]));
        }
        // Jres_i = -sum res J_i, each group one i; then each group its
        // row of upd = Hinv Jres
        const float own = -static_cast<float>(
            warp_sum3(jr[0], jr[1], jr[2], lane));
        float Jres[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) Jres[i] = from_group(own, i);
        double s = __dmul_rn(hrow[0], Jres[0]);
        s = __dadd_rn(s, __dmul_rn(hrow[1], Jres[1]));
        s = __dadd_rn(s, __dmul_rn(hrow[2], Jres[2]));
        const float mine = static_cast<float>(s);
        float upd[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) upd[i] = from_group(mine, i);
        if (edge) {
          u = __fadd_rn(u, __fmul_rn(upd[0], d0));
          v = __fadd_rn(v, __fmul_rn(upd[0], d1));
          md = __fadd_rn(md, upd[1]);
        } else {
          u = __fadd_rn(u, upd[0]);
          v = __fadd_rn(v, upd[1]);
          md = __fadd_rn(md, upd[2]);
        }
        if (__fadd_rn(__fmul_rn(upd[0], upd[0]),
                      __fmul_rn(upd[1], upd[1])) < kMinUpdateSq) {
          conv = true;
          break;
        }
      }
    }
  }
  if (lane == 0) {
    a.px[2 * row] = u;
    a.px[2 * row + 1] = v;
    a.conv[row] = conv && valid;
    // the failure counts (a few rows a call fail): one atomic a failure
    if (valid && !conv) atomicAdd(a.fails + 2 * (row / a.lane_rows) + alive,
                                  1ull);
  }
}

// the failure counts zeroed, on the launch's stream before it (a kernel
// node, as a CUDA graph's conditional bodies hold), counted like the
// aligning launch it precedes
__global__ void zero_counts(unsigned long long* c, int n) {
  if (threadIdx.x == 0) atomicAdd(&g_launches[kZeroCounter], 1ull);
  for (int i = threadIdx.x; i < n; i += blockDim.x) c[i] = 0ull;
}

}  // namespace

// p: the alignment's quad (T, 4), offsets, widths, heights, search_level
//    (M,); the patch warp's host quad pack (F h w, 4), host_idx (M,),
//    px_ref (M, 2), A_cur_ref (M, 2, 2), warp level (M,); border_patch
//    (M, 10, 10); px_init_scaled (M, 2), direction (M, 2), is_edge (M,),
//    valid (M,), aff_a (M,), aff_b (M,); then the outputs px (M, 2), conv
//    (M,), the failure counts (n_lanes, 2) int64 (one lane when n_lanes is
//    0; M a multiple of n_lanes) and patches (M, 10, 10). A mode reads and
//    writes
//    only its own: kFused all but border_patch and patches, kAlign all but
//    the patch warp's and patches, kPatches the patch warp's and patches
//    (the others may be null).
extern "C" int sdv_warp_align(void* const* p, long long quad_rows,
                              long long host_rows, long long rows, int h,
                              int w, int n_iter, int n_lanes, int mode,
                              void* stream) {
  if (rows <= 0) return 0;
  if (mode < 0 || mode >= kModes || n_lanes < 0 ||
      (n_lanes && rows % n_lanes))
    return cudaErrorInvalidValue;
  Args a;
  a.quad = static_cast<const float4*>(p[0]);
  a.quad_rows = quad_rows;
  a.offsets = static_cast<const long long*>(p[1]);
  a.widths = static_cast<const long long*>(p[2]);
  a.heights = static_cast<const long long*>(p[3]);
  a.level = static_cast<const long long*>(p[4]);
  a.host_quad = static_cast<const float4*>(p[5]);
  a.host_rows = host_rows;
  a.host = static_cast<const long long*>(p[6]);
  a.px_ref = static_cast<const float*>(p[7]);
  a.A = static_cast<const float*>(p[8]);
  a.warp_level = static_cast<const long long*>(p[9]);
  a.border = static_cast<const float*>(p[10]);
  a.px0 = static_cast<const float*>(p[11]);
  a.dir = static_cast<const float*>(p[12]);
  a.is_edge = static_cast<const bool*>(p[13]);
  a.valid = static_cast<const bool*>(p[14]);
  a.aff_a = static_cast<const float*>(p[15]);
  a.aff_b = static_cast<const float*>(p[16]);
  a.px = static_cast<float*>(p[17]);
  a.conv = static_cast<bool*>(p[18]);
  a.fails = static_cast<unsigned long long*>(p[19]);
  a.lane_rows = n_lanes ? rows / n_lanes : rows;
  a.patches = static_cast<float*>(p[20]);
  a.rows = rows;
  a.h = h;
  a.w = w;
  a.xmax = static_cast<float>(w - 1.001);
  a.ymax = static_cast<float>(h - 1.001);
  a.n_iter = n_iter;
  a.mode = mode;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode != kPatches) {
    zero_counts<<<1, 32, 0, s>>>(a.fails, 2 * (n_lanes ? n_lanes : 1));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  warp_align_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, 0, s>>>(a);
  return cudaGetLastError();
}

// The launches counted on the current device since the last reset, per
// mode (kFused, kAlign, kPatches) into out[0..2] and the zeroing kernel's
// into out[3]; with `reset`, the counters are zeroed after the read.
extern "C" int sdv_warp_align_counts(unsigned long long* out, int reset) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_launches, kCounters * sizeof(*out));
  if (err != cudaSuccess || !reset) return err;
  const unsigned long long zero[kCounters] = {0, 0, 0, 0};
  return cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}
