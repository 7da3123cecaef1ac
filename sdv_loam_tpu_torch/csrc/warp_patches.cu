// The matcher's patch warp (SVO's warpAffine, Reprojector.cpp:51-82): for
// each candidate row, its 10x10 border patch sampled from the host frame's
// level-0 intensities through the inverse of the row's affine warp, in one
// launch for all rows.
//
// Stands for the JAX package's `warp_affine_patches`
// (sdv_loam_tpu/ops/align.py:147), which XLA fuses; no Pallas kernel
// exists for it. The plain PyTorch version is
// hopper_kernels.warp_affine_patches_plain; this kernel computes the same
// function: per row the inverse of A_cur_ref (M, 2, 2) with its non-finite
// entries set to 0, per pixel (x, y) of the 10x10 grid the offset
// ((x - 5) s, (y - 5) s), s = 2^search_level, mapped through that inverse
// and moved to px_ref, the in-image test 0 <= x < w - 1, 0 <= y < h - 1,
// the clamp to [0, w - 1.001] x [0, h - 1.001], and the bilinear sample of
// the quad-packed stack (a row [I(x,y), I(x+1,y), I(x,y+1), I(x+1,y+1)]
// per pixel) at row host_idx * h * w + y0 * w + x0; 0 outside the image,
// NaN where that row lies outside the pack (as the plain version's gather
// reads it).
//
// Bound on the card: latency. A row reads 100 quad rows of 16 bytes and
// its 40 bytes of warp, level, host and pixel, writes 400 bytes, and does
// ~30 operations a pixel: at the main path's 2560 rows 5.2 MB, 1.6 us at
// the card's memory rate. What costs is one dependent chain per pixel
// (the inverse, the address, one 16-byte load, the weights). The design:
// one thread per patch pixel, 256 a block, each thread one float4 load of
// its pixel's quad row; the row's 2x2 inverse is recomputed by each of its
// 100 threads (a handful of float64 operations, cheaper than a shared
// memory round trip and a barrier).
//
// Precision: the inverse is LU with partial pivoting (row 1 is the pivot
// when |A10| > |A00|, so a NaN never wins) and the two triangular solves
// against the identity, in float64 from the float32 entries, each entry
// rounded to float32 once and set to 0 when not finite. The plain
// version's `torch.linalg.inv_ex` runs the same LU in float32 (LAPACK on
// the CPU, cuBLAS or MAGMA on the card), so an entry of Ainv differs from
// its by a few float32 ulps, and a sampled intensity by that times the
// image gradient. Everything after the inverse is float32, rounded as the
// plain version's tensor operations round it: the source point as
// (Ainv[i][0] ox + Ainv[i][1] oy) + px_ref[i] (the 2-term product of the
// plain version's einsum, whose library may contract it: a float32 ulp of
// the point), the weights (1 - ax)(1 - ay), ax(1 - ay), (1 - ax) ay,
// ax ay, and the sample ((q0 w0 + q1 w1) + q2 w2) + q3 w3, each product
// and sum rounded on its own (__fmul_rn, __fadd_rn: no contraction).
//
// A device counter (g_launches) is incremented by one thread per launch, so
// launches captured in a CUDA graph, also inside its IF and WHILE nodes,
// are counted each time they run; sdv_warp_patches_counts reads or resets
// it (the caller synchronizes the device first).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBorder = 10;              // BORDER_PATCH
constexpr int kPixels = kBorder * kBorder;
constexpr int kCenter = 5;               // HALF_PATCH + 1
constexpr int kThreads = 256;

__device__ unsigned long long g_launches;

struct Args {
  const float4* quad;        // (T, 4)
  long long quad_rows;       // T
  const long long* host;     // (M,)
  const float* px_ref;       // (M, 2)
  const float* A;            // (M, 2, 2)
  const long long* level;    // (M,)
  float* out;                // (M, 10, 10)
  long long rows;            // M
  int h, w;
  float xmax, ymax;          // w - 1.001 and h - 1.001 as float32
};

__device__ __forceinline__ float finite_or_zero(double x) {
  const float f = static_cast<float>(x);
  return isfinite(f) ? f : 0.0f;
}

// inv(A) of a row-major 2x2, its non-finite entries 0 (see the header)
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

__global__ void __launch_bounds__(kThreads) warp_patches_kernel(Args a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches, 1ull);
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.rows * kPixels) return;
  const long long row = t / kPixels;
  const int p = static_cast<int>(t - row * kPixels);
  float inv[2][2];
  inverse2(a.A + 4 * row, inv);
  // the grid offset times 2^level: exact (small integers, a power of 2)
  const float scale = ldexpf(1.0f, static_cast<int>(a.level[row]));
  const float ox = static_cast<float>(p % kBorder - kCenter) * scale;
  const float oy = static_cast<float>(p / kBorder - kCenter) * scale;
  const float x = __fadd_rn(
      __fadd_rn(__fmul_rn(inv[0][0], ox), __fmul_rn(inv[0][1], oy)),
      a.px_ref[2 * row]);
  const float y = __fadd_rn(
      __fadd_rn(__fmul_rn(inv[1][0], ox), __fmul_rn(inv[1][1], oy)),
      a.px_ref[2 * row + 1]);
  float val = 0.0f;
  if (x >= 0.0f && y >= 0.0f && x < static_cast<float>(a.w - 1) &&
      y < static_cast<float>(a.h - 1)) {
    const float xc = fminf(fmaxf(x, 0.0f), a.xmax);
    const float yc = fminf(fmaxf(y, 0.0f), a.ymax);
    const float x0 = floorf(xc), y0 = floorf(yc);
    const float ax = __fsub_rn(xc, x0), ay = __fsub_rn(yc, y0);
    const long long idx = a.host[row] * a.h * a.w +
                          static_cast<long long>(y0) * a.w +
                          static_cast<long long>(x0);
    if (idx >= 0 && idx < a.quad_rows) {
      const float4 q = __ldg(a.quad + idx);
      const float bx = __fsub_rn(1.0f, ax), by = __fsub_rn(1.0f, ay);
      val = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(q.x, __fmul_rn(bx, by)),
                              __fmul_rn(q.y, __fmul_rn(ax, by))),
                    __fmul_rn(q.z, __fmul_rn(bx, ay))),
          __fmul_rn(q.w, __fmul_rn(ax, ay)));
    } else {
      val = __int_as_float(0x7fc00000);   // NaN
    }
  }
  a.out[t] = val;
}

}  // namespace

// p: quad (T, 4), host_idx (M,), px_ref (M, 2), A (M, 2, 2),
//    search_level (M,), out (M, 10, 10)
extern "C" int sdv_warp_patches(void* const* p, long long quad_rows,
                                long long rows, int h, int w, void* stream) {
  if (rows <= 0) return 0;
  Args a;
  a.quad = static_cast<const float4*>(p[0]);
  a.quad_rows = quad_rows;
  a.host = static_cast<const long long*>(p[1]);
  a.px_ref = static_cast<const float*>(p[2]);
  a.A = static_cast<const float*>(p[3]);
  a.level = static_cast<const long long*>(p[4]);
  a.out = static_cast<float*>(p[5]);
  a.rows = rows;
  a.h = h;
  a.w = w;
  a.xmax = static_cast<float>(w - 1.001);
  a.ymax = static_cast<float>(h - 1.001);
  const long long blocks = (rows * kPixels + kThreads - 1) / kThreads;
  warp_patches_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launches counted on the current device since the last reset into
// out[0]; with `reset`, the counter is zeroed after the read.
extern "C" int sdv_warp_patches_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_launches, sizeof(*out));
  if (err != cudaSuccess || !reset) return err;
  const unsigned long long zero = 0;
  return cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
}
