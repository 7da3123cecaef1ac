// The matcher's inverse-compositional patch alignment (SVO's align2D for
// corners and align1D for edgelets, Reprojector.cpp:344-551, reached from
// findMatchDirect :238-293): every candidate row of a matcher call, each
// row's whole Gauss-Newton loop, in one launch.
//
// Stands for the JAX package's `align_batch` (sdv_loam_tpu/ops/align.py
// :319), a `lax.while_loop` whose body XLA fuses; no Pallas kernel exists
// for it. The plain PyTorch version is hopper_kernels.align_batch_plain:
// `align_setup`, then the batched loop of `align_body` through
// device_loop.run("align"), which runs while any row is still running
// (alive, valid, not converged) and at most n_iter times. This kernel
// computes the same function:
//   * setup, per row: from the 10x10 border patch the 8x8 reference patch
//     and its central differences dx, dy; J = [dx, dy, 1] for a corner,
//     [dgrad, 1, 0] with dgrad = d0 dx + d1 dy for an edgelet; the target
//     aff_a ref + aff_b; H = sum J J^T over the 64 pixels and
//     Hinv = inv(H + 1e-9 I), non-finite entries set to 0;
//   * per iteration, while the row runs and fewer than n_iter have run:
//     the in-bounds test of floor(u), floor(v) against the row's level
//     width and height (a row that fails it stops, alive false); the 64
//     samples at min(max(u, 4), w - 4) + (x - 4) (and v alike), each one
//     16-byte load of its quad row at base + y0 w + x0 (NaN for a row
//     outside the pack); res = cur - target + mean_diff;
//     Jres = -sum res J; upd = Hinv Jres; the corner update of u, v and
//     mean_diff, or the edgelet's step along the direction; converged
//     when upd0^2 + upd1^2 < 0.03^2 (then the row stops);
//   * out: px = (u, v), conv & valid, and the failure masks valid & ~conv
//     & ~alive (walked out of bounds) and valid & ~conv & alive (out of
//     iterations).
// Row by row this is the batched loop: the rows never meet (a row's step
// reads only its own carries), and a row that has stopped keeps every
// carry there, so its loop may as well end when it stops. Each row's warp
// leaves at its own stop; no row waits on another.
//
// Bound on the card: latency. A running row's iteration reads 64 quad
// rows (1 KB) and does ~2,300 operations; a row's setup reads its 400-byte
// border patch. At the main path's 2560 rows and ~5 iterations a row
// that is ~14 MB, 4 us at the card's memory rate, and 0.03 GFLOP, under
// 1 us at its float32 rate. What costs is one row's chain of iterations,
// each a dependent load, a warp reduction and a 3x3 product. The design:
// a warp per row, kWarps rows a block, lane l owning the patch pixels l
// and l + 32 (p = 8 y + x); the row's scalars (u, v, mean_diff, Hinv) are
// held by every lane, so a warp runs its iterations with no shared memory
// and no barrier, and 2560 rows are one wave of 320 blocks.
//
// Precision. Per-pixel quantities are float32, each operation rounded on
// its own as the plain version's tensor operations round it (__fadd_rn,
// __fsub_rn, __fmul_rn: no contraction): dx = 0.5 (b[x+1] - b[x-1]),
// dgrad = d0 dx + d1 dy, target = aff_a ref + aff_b, the sample point,
// the weights (1 - ax)(1 - ay), ax(1 - ay), (1 - ax) ay, ax ay, the sample
// ((q0 w0 + q1 w1) + q2 w2) + q3 w3, and res = (cur - target) + mean_diff.
// The 64-term sums (H's six distinct entries, the three of J^T res) are
// taken in float64 over exact products and rounded to float32 once, where
// the plain version sums in float32. H + 1e-9 I is formed in float32;
// its inverse is LU with partial pivoting (the first row of strictly
// largest |a| below the diagonal; a NaN never wins) and the triangular
// solves against the identity, in float64, each entry rounded to float32
// once and set to 0 when not finite (the plain version's inv_ex solves in
// float32). upd_i = sum_j Hinv_ij Jres_j is a float64 sum of exact
// products, j = 0, 1, 2 in order, rounded once. An edgelet's H has a zero
// third row and column, so its Hinv has exact zeros there and ~1e9 on the
// diagonal; Jres_2 = -sum res 0 is an exact (signed) zero for finite res,
// so upd keeps the plain version's value (no inf 0), and a non-finite res
// makes every upd entry NaN, as the plain version's does.
//
// Reduction order of a sum over the 64 pixels (fixed: it depends on
// nothing but the row): lane l adds its two pixels' terms, l then l + 32;
// then five butterfly stages, each lane adding the partner's partial sum
// at lane distance 16, 8, 4, 2, 1 (__shfl_xor_sync); addition commutes, so
// every lane ends with the same bits.
//
// A device counter (g_launches) is incremented by one thread per launch, so
// launches captured in a CUDA graph, also inside its IF and WHILE nodes,
// are counted each time they run; sdv_align_batch_counts reads or resets
// it (the caller synchronizes the device first).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;            // rows (warps) per block
constexpr int kHalf = 4;             // HALF_PATCH
constexpr int kPatch = 8;            // PATCH
constexpr int kBorder = 10;          // BORDER_PATCH
constexpr float kMinUpdateSq = static_cast<float>(0.03 * 0.03);
constexpr float kEps = 1e-9f;        // H's regulariser
constexpr unsigned kAll = 0xffffffffu;

__device__ unsigned long long g_launches;

struct Args {
  const float4* quad;          // (T, 4): the quad-packed target pyramids
  long long quad_rows;         // T
  const long long* offsets;    // level tables, indexed by search_level
  const long long* widths;
  const long long* heights;
  const long long* level;      // (M,)
  const float* border;         // (M, 10, 10)
  const float* px0;            // (M, 2)
  const float* dir;            // (M, 2)
  const bool* is_edge;         // (M,)
  const bool* valid;           // (M,)
  const float* aff_a;          // (M,)
  const float* aff_b;          // (M,)
  float* px;                   // (M, 2)
  bool* conv;                  // (M,)
  bool* fails;                 // (M, 2): out of bounds, out of iterations
  long long rows;
  int n_iter;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(kAll, v, m));
  return v;
}

__device__ __forceinline__ float finite_or_zero(double x) {
  const float f = static_cast<float>(x);
  return isfinite(f) ? f : 0.0f;
}

// inv(A) of a 3x3 (float32 entries), float64 LU with partial pivoting and
// the solves against the identity; each entry rounded once, non-finite
// ones 0
__device__ __forceinline__ void inverse3(const float A[3][3],
                                         float inv[3][3]) {
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
#pragma unroll
  for (int c = 0; c < 3; ++c) {
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
    for (int i = 0; i < 3; ++i) inv[i][c] = finite_or_zero(y[i]);
  }
}

// one pixel's bilinear sample of the row's level (NaN outside the pack)
__device__ __forceinline__ float sample(const Args& a, long long base,
                                        long long w, float x, float y) {
  const float x0 = floorf(x), y0 = floorf(y);
  const float ax = __fsub_rn(x, x0), ay = __fsub_rn(y, y0);
  const long long idx = base + static_cast<long long>(y0) * w +
                        static_cast<long long>(x0);
  if (idx < 0 || idx >= a.quad_rows) return __int_as_float(0x7fc00000);
  const float4 q = __ldg(a.quad + idx);
  const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(q.x, __fmul_rn(bx, by)),
                          __fmul_rn(q.y, __fmul_rn(ax, by))),
                __fmul_rn(q.z, __fmul_rn(bx, ay))),
      __fmul_rn(q.w, __fmul_rn(ax, ay)));
}

__global__ void __launch_bounds__(32 * kWarps) align_batch_kernel(Args a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ull);
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  float u = a.px0[2 * row], v = a.px0[2 * row + 1];
  const bool valid = a.valid[row];
  bool conv = false, alive = valid;
  if (valid && a.n_iter > 0) {
    const bool edge = a.is_edge[row];
    const float d0 = a.dir[2 * row], d1 = a.dir[2 * row + 1];
    const float fa = a.aff_a[row], fb = a.aff_b[row];
    const long long lvl = a.level[row];
    const long long base = a.offsets[lvl], wv = a.widths[lvl];
    const float wm = static_cast<float>(wv - kHalf);
    const float hm = static_cast<float>(a.heights[lvl] - kHalf);
    const float* bp = a.border + kBorder * kBorder * row;
    // the lane's two pixels: J, target, and the offsets of the samples
    float J[2][3], target[2], ox[2], oy[2];
    double h6[6] = {0, 0, 0, 0, 0, 0};   // H00 H01 H02 H11 H12 H22
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int p = lane + 32 * k;
      const int x = p % kPatch, y = p / kPatch;
      const float* c = bp + (y + 1) * kBorder + (x + 1);
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
      ox[k] = static_cast<float>(x - kHalf);
      oy[k] = static_cast<float>(y - kHalf);
      int n = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = i; j < 3; ++j, ++n)
          h6[n] = __dadd_rn(h6[n], __dmul_rn(J[k][i], J[k][j]));
    }
#pragma unroll
    for (int n = 0; n < 6; ++n) h6[n] = warp_sum(h6[n]);
    // H + 1e-9 I in float32, as the plain version adds eye * 1e-9 (a +0
    // off the diagonal, which makes a -0 sum +0)
    float H[3][3];
    H[0][0] = static_cast<float>(h6[0]);
    H[0][1] = H[1][0] = static_cast<float>(h6[1]);
    H[0][2] = H[2][0] = static_cast<float>(h6[2]);
    H[1][1] = static_cast<float>(h6[3]);
    H[1][2] = H[2][1] = static_cast<float>(h6[4]);
    H[2][2] = static_cast<float>(h6[5]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        H[i][j] = __fadd_rn(H[i][j], i == j ? kEps : 0.0f);
    float Hinv[3][3];
    inverse3(H, Hinv);

    float md = 0.0f;
    for (int it = 0; it < a.n_iter; ++it) {
      const float ur = floorf(u), vr = floorf(v);
      if (!(ur >= kHalf && vr >= kHalf && ur < wm && vr < hm)) {
        alive = false;                 // walked out of the level
        break;
      }
      const float uc = fminf(fmaxf(u, static_cast<float>(kHalf)), wm);
      const float vc = fminf(fmaxf(v, static_cast<float>(kHalf)), hm);
      double jr[3] = {0, 0, 0};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float cur = sample(a, base, wv, __fadd_rn(uc, ox[k]),
                                 __fadd_rn(vc, oy[k]));
        const float res = __fadd_rn(__fsub_rn(cur, target[k]), md);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          jr[i] = __dadd_rn(jr[i], __dmul_rn(res, J[k][i]));
      }
      float Jres[3];
#pragma unroll
      for (int i = 0; i < 3; ++i)
        Jres[i] = -static_cast<float>(warp_sum(jr[i]));
      float upd[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        double s = __dmul_rn(Hinv[i][0], Jres[0]);
        s = __dadd_rn(s, __dmul_rn(Hinv[i][1], Jres[1]));
        s = __dadd_rn(s, __dmul_rn(Hinv[i][2], Jres[2]));
        upd[i] = static_cast<float>(s);
      }
      if (edge) {
        u = __fadd_rn(u, __fmul_rn(upd[0], d0));
        v = __fadd_rn(v, __fmul_rn(upd[0], d1));
        md = __fadd_rn(md, upd[1]);
      } else {
        u = __fadd_rn(u, upd[0]);
        v = __fadd_rn(v, upd[1]);
        md = __fadd_rn(md, upd[2]);
      }
      if (__fadd_rn(__fmul_rn(upd[0], upd[0]), __fmul_rn(upd[1], upd[1])) <
          kMinUpdateSq) {
        conv = true;
        break;
      }
    }
  }
  if (lane == 0) {
    a.px[2 * row] = u;
    a.px[2 * row + 1] = v;
    a.conv[row] = conv && valid;
    a.fails[2 * row] = valid && !conv && !alive;
    a.fails[2 * row + 1] = valid && !conv && alive;
  }
}

}  // namespace

// p: quad (T, 4), offsets, widths, heights, search_level (M,),
//    border_patch (M, 10, 10), px_init_scaled (M, 2), direction (M, 2),
//    is_edge (M,), valid (M,), aff_a (M,), aff_b (M,), then the outputs
//    px (M, 2), conv (M,), fails (M, 2)
extern "C" int sdv_align_batch(void* const* p, long long quad_rows,
                               long long rows, int n_iter, void* stream) {
  if (rows <= 0) return 0;
  Args a;
  a.quad = static_cast<const float4*>(p[0]);
  a.quad_rows = quad_rows;
  a.offsets = static_cast<const long long*>(p[1]);
  a.widths = static_cast<const long long*>(p[2]);
  a.heights = static_cast<const long long*>(p[3]);
  a.level = static_cast<const long long*>(p[4]);
  a.border = static_cast<const float*>(p[5]);
  a.px0 = static_cast<const float*>(p[6]);
  a.dir = static_cast<const float*>(p[7]);
  a.is_edge = static_cast<const bool*>(p[8]);
  a.valid = static_cast<const bool*>(p[9]);
  a.aff_a = static_cast<const float*>(p[10]);
  a.aff_b = static_cast<const float*>(p[11]);
  a.px = static_cast<float*>(p[12]);
  a.conv = static_cast<bool*>(p[13]);
  a.fails = static_cast<bool*>(p[14]);
  a.rows = rows;
  a.n_iter = n_iter;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  align_batch_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launches counted on the current device since the last reset into
// out[0]; with `reset`, the counter is zeroed after the read.
extern "C" int sdv_align_batch_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_launches, sizeof(*out));
  if (err != cudaSuccess || !reset) return err;
  const unsigned long long zero = 0;
  return cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
}
