// The tracking LM's residual and 8x8 system (CoarseTracker::calcRes fused
// with calcGSSSE), for B pose rows in one launch.
//
// Stands for the JAX package's `calc_res_gs`
// (sdv_loam_tpu/ops/photometric.py:162), which XLA fuses into a few
// kernels; no Pallas kernel exists for it (sdv_loam_tpu/ops/warp.py:9-12
// names a fused warp that was never written). The plain PyTorch version is
// hopper_kernels.calc_res_gs_plain; this kernel computes the same function:
// per pool point the projection through T, the bilinear sample of the
// target level at the row's lane, the in-bounds / hit / finite / positive
// depth tests, the Huber weight and the saturation split at `cutoff`, the
// energy and the count of terms, the 8 Jacobian columns, J^T W J and
// J^T W r divided by the inlier count and scaled by STEP_SCALE, and the
// flow indicators over every 32nd valid slot.
//
// Bound on the card: latency. A row reads 17 bytes per point of its pool
// and one 48-byte bilinear support, and does ~150 operations per point
// (the 64 products of J^T W J among them): at N = 1024 and 32 rows that
// is 2.2 MB and 5 M operations, 0.7 us and 0.07 us at the card's peaks.
// What it costs is the chain of one pass over the pool and a block
// reduction of 76 sums per row. The design keeps every intermediate in
// registers (nothing per point touches device memory but the pool and the
// sample) and launches once for all B rows.
//
// Precision: every per-point quantity (the projection, the sample, r, the
// Huber weight, J, J w, the energy and flow terms) is float32, rounded as
// the plain version's tensor operations round it; the products of J^T W J
// and J^T W r are formed exactly and every sum is taken in float64; each
// output is rounded to float32 once. The plain version's float32 sums
// (and the JAX package's) differ from these by their own rounding. The
// tracking systems are ill-conditioned, so the LM follows such sum errors
// into its steps (csrc/track_lm_update.cu solves in float64 for the same
// reason).
//
// Reduction order (fixed, so the result does not depend on B, on the other
// rows, on the grid or on which stream or graph launches it; a row alone
// and the same row among L*B gives the same bits):
//   * one block of kThreads threads per row; thread t sums points
//     t, t + kThreads, t + 2 kThreads, ... in that order, in float64;
//   * then each warp sums its 32 lanes by __shfl_down_sync at offsets 16,
//     8, 4, 2, 1 (lane l adds lane l + offset), lane 0 holding the warp's
//     sum;
//   * then one thread per sum adds the warps' sums in warp order 0..7.
// The counts (terms, saturated, inliers, flow slots) are integer sums.
//
// IEEE semantics of the plain version: it forms J^T (J w) and (J w)^T r
// over every point, non-inliers (w = 0) included, so a point whose J or r
// is inf or NaN makes H and b NaN (0 * inf). The kernel adds a point's
// terms to H and b when it is an inlier, or when one of its J columns or
// its r is not finite. A point it skips has every J column and r finite and
// w = 0, so each skipped term J_i * (J_j * 0) or (J_i * 0) * r is a zero
// (of either sign), which leaves a float sum unchanged up to the sign of a
// zero sum.
//
// A device counter (g_launches) is incremented by one thread per launch, so
// launches captured in a CUDA graph, also inside its IF and WHILE nodes,
// are counted each time they run; sdv_track_res_gs_counts reads or resets
// it (the caller synchronizes the device first).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 64 + 8 + 4;   // H, b, E of inliers, E saturated, flows
constexpr int kCounts = 4;          // terms, saturated, inliers, flow slots

__constant__ float kStepScale[8] = {1.0f, 1.0f, 1.0f, 0.5f,
                                    0.5f, 0.5f, 10.0f, 1000.0f};

__device__ unsigned long long g_launches;

// the per-point arithmetic rounds each operation on its own (no fused
// multiply-add), as the plain version's separate tensor operations do
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}

struct ResGsArgs {
  // pool fields of L lanes, (L, N) each (lane stride `pool_stride`)
  const float* u;
  const float* v;
  const float* idepth;
  const float* color;
  const bool* valid;
  long long pool_stride;
  int n;
  // pack_bilinear's (L * h * w, 12) stack, intrinsics (L, 4)
  const float* packed;
  int h, w;
  const float* K;
  const long long* lane;   // (B,), or null: every row is lane 0
  // per row: T (B, 4, 4), aff_rel (B, 2); ref_aff_b and cutoff as a
  // pointer with a row stride (0: one value) or, with a null pointer, a
  // value
  const float* T;
  const float* aff_rel;
  const float* ref_b;
  long long ref_b_stride;
  float ref_b_value;
  const float* cutoff;
  long long cutoff_stride;
  float cutoff_value;
  float huber;
  // outputs, (B,) each, H (B, 8, 8), b (B, 8)
  float* E;
  long long* n_terms;
  float* sat_frac;
  float* H;
  float* b;
  float* flow_t;
  float* flow_rt;
};

// squared pixel shift of q against the reference pixel (calcRes:538-565)
__device__ __forceinline__ float pix_shift(float q0, float q1, float q2,
                                           float fx, float fy, float cx,
                                           float cy, float u0, float v0) {
  const float du = sub(add(mul(fx, dvd(q0, q2)), cx), u0);
  const float dv = sub(add(mul(fy, dvd(q1, q2)), cy), v0);
  return add(mul(du, du), mul(dv, dv));
}

__global__ void __launch_bounds__(kThreads)
track_res_gs_kernel(ResGsArgs a) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  if (row == 0 && tid == 0) atomicAdd(&g_launches, 1ull);

  const long long ln = a.lane ? a.lane[row] : 0;
  const float* Kl = a.K + 4 * ln;
  const float fx = Kl[0], fy = Kl[1], cx = Kl[2], cy = Kl[3];
  const float* T = a.T + 16 * row;
  float R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = T[4 * i + j];
    t[i] = T[4 * i + 3];
  }
  const float aff_a = a.aff_rel[2 * row], aff_b = a.aff_rel[2 * row + 1];
  const float ref_b =
      a.ref_b ? a.ref_b[a.ref_b_stride * row] : a.ref_b_value;
  const float cutoff =
      a.cutoff ? a.cutoff[a.cutoff_stride * row] : a.cutoff_value;
  const float huber = a.huber;
  const float max_energy =
      sub(mul(mul(2.0f, huber), cutoff), mul(huber, huber));
  const float wlim = static_cast<float>(a.w - 3);
  const float hlim = static_cast<float>(a.h - 3);
  const float xmax = static_cast<float>(a.w - 2);
  const float ymax = static_cast<float>(a.h - 2);
  const long long base = ln * a.h * a.w;

  const float* pu = a.u + ln * a.pool_stride;
  const float* pv = a.v + ln * a.pool_stride;
  const float* pid = a.idepth + ln * a.pool_stride;
  const float* pcol = a.color + ln * a.pool_stride;
  const bool* pval = a.valid + ln * a.pool_stride;

  double acc[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
  int cnt[kCounts] = {0, 0, 0, 0};

  for (int i = tid; i < a.n; i += kThreads) {
    const float u0 = pu[i], v0 = pv[i], idp = pid[i], color = pcol[i];
    const bool valid = pval[i];
    const float xn = dvd(sub(u0, cx), fx);
    const float yn = dvd(sub(v0, cy), fy);
    float pr[3], pt[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pr[k] = add(add(mul(xn, R[k][0]), mul(yn, R[k][1])), R[k][2]);
      pt[k] = add(pr[k], mul(t[k], idp));
    }
    const float u = dvd(pt[0], pt[2]);
    const float v = dvd(pt[1], pt[2]);
    const float Ku = add(mul(fx, u), cx);
    const float Kv = add(mul(fy, v), cy);
    const float nid = dvd(idp, pt[2]);
    bool inb = valid && Ku > 2.0f && Kv > 2.0f && Ku < wlim && Kv < hlim &&
               nid > 0.0f;

    // bilinear sample: the 2x2 support lies inside (false for NaN too)
    float hit[3] = {0.0f, 0.0f, 0.0f};
    const float x0f = floorf(Ku), y0f = floorf(Kv);
    const bool hit_ok = x0f >= 0.0f && x0f <= xmax && y0f >= 0.0f &&
                        y0f <= ymax;
    if (hit_ok) {
      const float ax = sub(Ku, x0f), ay = sub(Kv, y0f);
      const float wc[4] = {mul(sub(1.0f, ax), sub(1.0f, ay)),
                           mul(ax, sub(1.0f, ay)), mul(sub(1.0f, ax), ay),
                           mul(ax, ay)};
      const float4* g = reinterpret_cast<const float4*>(
          a.packed + 12 * (base + static_cast<long long>(y0f) * a.w +
                           static_cast<long long>(x0f)));
      const float4 g0 = g[0], g1 = g[1], g2 = g[2];
      const float q[12] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y,
                           g1.z, g1.w, g2.x, g2.y, g2.z, g2.w};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float s = mul(q[c], wc[0]);
#pragma unroll
        for (int k = 1; k < 4; ++k) s = add(s, mul(q[3 * k + c], wc[k]));
        hit[c] = s;
      }
    }
    inb = inb && hit_ok && isfinite(hit[0]);

    const float r = sub(hit[0], add(mul(aff_a, color), aff_b));
    const float absr = fabsf(r);
    const float hw =
        absr < huber ? 1.0f : dvd(huber, fmaxf(absr, 1e-12f));
    const bool saturated = inb && absr > cutoff;
    const bool inlier = inb && absr <= cutoff;
    cnt[0] += inb;
    cnt[1] += saturated;
    cnt[2] += inlier;
    if (inlier) acc[72] += mul(mul(mul(hw, r), r), sub(2.0f, hw));
    if (saturated) acc[73] += max_energy;

    // Jacobian columns (calcGSSSE:442-462)
    const float dxf = mul(hit[1], fx), dyf = mul(hit[2], fy);
    const float uv = mul(u, v);
    float J[8];
    J[0] = mul(nid, dxf);
    J[1] = mul(nid, dyf);
    J[2] = mul(-nid, add(mul(u, dxf), mul(v, dyf)));
    J[3] = -add(mul(uv, dxf), mul(add(1.0f, mul(v, v)), dyf));
    J[4] = add(mul(uv, dyf), mul(add(1.0f, mul(u, u)), dxf));
    J[5] = sub(mul(u, dyf), mul(v, dxf));
    J[6] = mul(aff_a, sub(ref_b, color));
    J[7] = -1.0f;
    bool finite = isfinite(r);
#pragma unroll
    for (int k = 0; k < 8; ++k) finite = finite && isfinite(J[k]);
    if (inlier || !finite) {
      const float wgt = inlier ? hw : 0.0f;
      float Jw[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) Jw[k] = mul(J[k], wgt);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          acc[8 * p + q] += static_cast<double>(J[p]) * Jw[q];
        acc[64 + p] += static_cast<double>(Jw[p]) * r;
      }
    }

    // flow indicators over every 32nd valid slot
    if (valid && (i % 32) == 0) {
      cnt[3] += 1;
      float ti[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) ti[k] = mul(t[k], idp);
      const float p0[3] = {xn, yn, 1.0f};
      acc[74] += add(
          pix_shift(add(p0[0], ti[0]), add(p0[1], ti[1]), add(p0[2], ti[2]),
                    fx, fy, cx, cy, u0, v0),
          pix_shift(sub(p0[0], ti[0]), sub(p0[1], ti[1]), sub(p0[2], ti[2]),
                    fx, fy, cx, cy, u0, v0));
      acc[75] += add(
          pix_shift(pt[0], pt[1], pt[2], fx, fy, cx, cy, u0, v0),
          pix_shift(sub(pr[0], ti[0]), sub(pr[1], ti[1]), sub(pr[2], ti[2]),
                    fx, fy, cx, cy, u0, v0));
    }
  }

  // the block's sums, in the order stated at the top of the file
  __shared__ double wsum[kWarps][kSums];
  __shared__ int wcnt[kWarps][kCounts];
  __shared__ double tot[kSums];
  __shared__ int totc[kCounts];
  const int lane = tid & 31, warp = tid >> 5;
  constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    double x = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kAll, x, off);
    if (lane == 0) wsum[warp][k] = x;
  }
#pragma unroll
  for (int k = 0; k < kCounts; ++k) {
    int x = cnt[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kAll, x, off);
    if (lane == 0) wcnt[warp][k] = x;
  }
  __syncthreads();
  if (tid < kSums) {
    double s = wsum[0][tid];
    for (int k = 1; k < kWarps; ++k) s += wsum[k][tid];
    tot[tid] = s;
  } else if (tid < kSums + kCounts) {
    int s = 0;
    for (int k = 0; k < kWarps; ++k) s += wcnt[k][tid - kSums];
    totc[tid - kSums] = s;
  }
  __syncthreads();

  // each output rounded to float32 once, from the float64 sums
  const double n_in = static_cast<double>(max(totc[2], 1));
  if (tid < 64) {
    const int p = tid >> 3, q = tid & 7;
    a.H[64 * row + tid] = static_cast<float>(
        tot[tid] / n_in * kStepScale[p] * kStepScale[q]);
  } else if (tid < 72) {
    const int p = tid - 64;
    a.b[8 * row + p] = static_cast<float>(tot[tid] / n_in * kStepScale[p]);
  } else if (tid == 72) {
    a.E[row] = static_cast<float>(tot[72] + tot[73]);
    a.n_terms[row] = totc[0];
    a.sat_frac[row] = dvd(static_cast<float>(totc[1]),
                          static_cast<float>(max(totc[0], 1)));
  } else if (tid == 73) {
    const float num = add(mul(static_cast<float>(totc[3]), 2.0f), 0.1f);
    a.flow_t[row] = static_cast<float>(tot[74] / num);
    a.flow_rt[row] = static_cast<float>(tot[75] / num);
  }
}

}  // namespace

// Launch for B rows on `stream`; returns the launch's cudaError_t.
extern "C" int sdv_track_res_gs(void* const* p, long long pool_stride,
                                int n, int h, int w, int rows,
                                long long ref_b_stride, float ref_b_value,
                                long long cutoff_stride, float cutoff_value,
                                float huber, void* stream) {
  // p: u, v, idepth, color, valid, packed, K, lane, T, aff_rel, ref_b,
  //    cutoff, E, n_terms, sat_frac, H, b, flow_t, flow_rt
  ResGsArgs a;
  a.u = static_cast<const float*>(p[0]);
  a.v = static_cast<const float*>(p[1]);
  a.idepth = static_cast<const float*>(p[2]);
  a.color = static_cast<const float*>(p[3]);
  a.valid = static_cast<const bool*>(p[4]);
  a.pool_stride = pool_stride;
  a.n = n;
  a.packed = static_cast<const float*>(p[5]);
  a.h = h;
  a.w = w;
  a.K = static_cast<const float*>(p[6]);
  a.lane = static_cast<const long long*>(p[7]);
  a.T = static_cast<const float*>(p[8]);
  a.aff_rel = static_cast<const float*>(p[9]);
  a.ref_b = static_cast<const float*>(p[10]);
  a.ref_b_stride = ref_b_stride;
  a.ref_b_value = ref_b_value;
  a.cutoff = static_cast<const float*>(p[11]);
  a.cutoff_stride = cutoff_stride;
  a.cutoff_value = cutoff_value;
  a.huber = huber;
  a.E = static_cast<float*>(p[12]);
  a.n_terms = static_cast<long long*>(p[13]);
  a.sat_frac = static_cast<float*>(p[14]);
  a.H = static_cast<float*>(p[15]);
  a.b = static_cast<float*>(p[16]);
  a.flow_t = static_cast<float*>(p[17]);
  a.flow_rt = static_cast<float*>(p[18]);
  if (rows <= 0) return 0;
  track_res_gs_kernel<<<rows, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launches counted on the current device since the last reset, into
// *out; with `reset`, the counter is zeroed after the read.
extern "C" int sdv_track_res_gs_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_launches, sizeof(*out));
  if (err != cudaSuccess || !reset) return err;
  const unsigned long long zero = 0;
  return cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
}
