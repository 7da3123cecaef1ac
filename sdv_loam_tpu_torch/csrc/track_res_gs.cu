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
// What it costs is the chain of one pass over a row's points and the
// reduction of 76 sums per row. The design spreads each row over a thread
// block cluster of kCluster blocks (on as many SMs: the refinement's 3
// rows of 6144 points take 24 SMs, not 3), keeps each point's terms in
// shared memory instead of 76 float64 accumulators per thread, and adds
// the blocks' partial sums through the cluster's distributed shared memory
// (no global scratch, no atomics).
//
// Precision: every per-point quantity (the projection, the sample, r, the
// Huber weight, J, J w, the energy and flow terms) is float32, rounded as
// the plain version's tensor operations round it; the products of J^T W J
// and J^T W r are formed exactly (a float32 product is exact in float64)
// and every sum is taken in float64; each output is rounded to float32
// once. The plain version's float32 sums (and the JAX package's) differ
// from these by their own rounding. The tracking systems are
// ill-conditioned, so the LM follows such sum errors into its steps
// (csrc/track_lm_update.cu solves in float64 for the same reason).
//
// Reduction order (fixed: it depends on n alone, never on B, on the other
// rows or on which stream or graph launches it, so a row alone and the
// same row among L*B give the same bits):
//   * a row's n points split into kCluster contiguous ranges of
//     ceil(n / kCluster) points (the last ones shorter or empty); block
//     rank c of the row's cluster takes range c;
//   * a block walks its range in tiles of kThreads points, in order; a
//     tile of m points splits into kSlices contiguous slices of
//     ceil(m / kSlices) points (the last shorter);
//   * for each of the 76 sums and each slice s, one thread adds the
//     slice's terms in point order, tile after tile, into one float64
//     accumulator (a fused multiply-add of the two float32 factors of the
//     term, exact products: the same value as adding the product);
//   * the block's partial sum is (slice 0 + slice 1) + slice 2;
//   * block rank 0 adds the cluster's partial sums in rank order,
//     ((rank 0 + rank 1) + rank 2) + ... + rank kCluster-1, reading the
//     other ranks' shared memory after a cluster barrier.
// The counts (terms, saturated, inliers, flow slots) are integer sums.
//
// IEEE semantics of the plain version: it forms J^T (J w) and (J w)^T r
// over every point, non-inliers (w = 0) included, so a point whose J or r
// is inf or NaN makes H and b NaN (0 * inf). The kernel adds a point's
// terms to H and b when it is an inlier, or when one of its J columns or
// its r is not finite. A point it skips has every J column and r finite and
// w = 0, so each skipped term J_i * (J_j * 0) or (J_i * 0) * r is a zero
// (of either sign), which leaves a float sum unchanged up to the sign of a
// zero sum. A skipped term enters the tile as +0 * +0, which leaves every
// accumulator (started at +0) unchanged, bit for bit.
//
// A device counter (g_launches) is incremented by one thread per launch, so
// launches captured in a CUDA graph, also inside its IF and WHILE nodes,
// are counted each time they run; sdv_track_res_gs_counts reads or resets
// it (the caller synchronizes the device first).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;         // blocks per row (the portable size)
constexpr int kThreads = 256;       // threads per block, points per tile
constexpr int kSlices = 3;          // slices of a tile, per sum
constexpr int kBlocksPerSm = 3;     // resident blocks the registers allow
constexpr int kSums = 64 + 8 + 4;   // H, b, E of inliers, E saturated, flows
constexpr int kCounts = 4;          // terms, saturated, inliers, flow slots
// a tile's per-point terms, float32 values held as float64 (converted
// once per point, not once per sum): J (0-7), J w (8-15), r, the inlier
// energy, the saturated energy, the two flow terms, and a row of ones
constexpr int kTermRows = 22;
constexpr int kRowR = 16, kRowOne = 21;
constexpr int kStride = kThreads + 1;   // one word of padding per row

static_assert(kSums * kSlices <= kThreads, "a thread per sum and slice");

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

// a row's constants: T (4, 4), K, and the per-row scalars
struct RowConst {
  float T[16];
  float K[4];
  float cutoff, max_energy, aff_a, aff_b, ref_b;
};

// the two term rows whose product is sum k's term
__device__ __forceinline__ void sum_rows(int k, int& ra, int& rb) {
  if (k < 64) {
    ra = k >> 3;              // J_p
    rb = 8 + (k & 7);         // (J w)_q
  } else if (k < 72) {
    ra = 8 + (k - 64);        // (J w)_p
    rb = kRowR;               // r
  } else {
    ra = 17 + (k - 72);       // the energies and flows, times one
    rb = kRowOne;
  }
}

// at most 85 registers a thread, so three blocks fit an SM: the ladder's
// 32 rows (256 blocks) then run in one wave
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kBlocksPerSm)
track_res_gs_kernel(ResGsArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  if (row == 0 && rank == 0 && tid == 0) atomicAdd(&g_launches, 1ull);

  __shared__ double terms[kTermRows][kStride];
  __shared__ double slice_sum[kSlices][kSums];
  __shared__ double part[kSums];   // this block's partial sums
  __shared__ double tot[kSums];    // the row's sums (rank 0)
  __shared__ int totc[kCounts];

  // the row's constants, in shared memory: read where used, they hold no
  // registers across the tiles (the per-point code then fits 85 registers,
  // three blocks to an SM)
  __shared__ RowConst rc;
  const long long ln = a.lane ? a.lane[row] : 0;
  if (tid < 16) {
    rc.T[tid] = a.T[16 * row + tid];
  } else if (tid < 20) {
    rc.K[tid - 16] = a.K[4 * ln + tid - 16];
  } else if (tid == 20) {
    const float cutoff =
        a.cutoff ? a.cutoff[a.cutoff_stride * row] : a.cutoff_value;
    rc.cutoff = cutoff;
    rc.max_energy =
        sub(mul(mul(2.0f, a.huber), cutoff), mul(a.huber, a.huber));
    rc.aff_a = a.aff_rel[2 * row];
    rc.aff_b = a.aff_rel[2 * row + 1];
    rc.ref_b = a.ref_b ? a.ref_b[a.ref_b_stride * row] : a.ref_b_value;
  }
  const long long pool0 = ln * a.pool_stride;

  // this block's range of the row's points
  const int span = (a.n + kCluster - 1) / kCluster;
  const int beg = min(a.n, rank * span);
  const int end = min(a.n, beg + span);

  // this thread's sum and slice (threads past kSums * kSlices only
  // compute points)
  const bool summer = tid < kSums * kSlices;
  const int k_sum = tid % kSums, slice = tid / kSums;
  int ra = 0, rb = 0;
  sum_rows(k_sum, ra, rb);
  double acc = 0.0;
  __shared__ int cnt[kCounts];
  if (tid < kCounts) cnt[tid] = 0;
  terms[kRowOne][tid] = 1.0;
  __syncthreads();

  for (int t0 = beg; t0 < end; t0 += kThreads) {
    const int m = min(kThreads, end - t0);
    const int i = t0 + tid;
    bool inb = false, saturated = false, inlier = false, flow = false;
    float J[8], Jw[8], r = 0.0f, e_in = 0.0f, e_sat = 0.0f, ft = 0.0f,
                       frt = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) J[k] = Jw[k] = 0.0f;
    if (tid < m) {
      const float u0 = a.u[pool0 + i], v0 = a.v[pool0 + i];
      const float idp = a.idepth[pool0 + i], color = a.color[pool0 + i];
      const bool valid = a.valid[pool0 + i];
      const float fx = rc.K[0], fy = rc.K[1], cx = rc.K[2], cy = rc.K[3];
      const float huber = a.huber, cutoff = rc.cutoff;
      const float aff_a = rc.aff_a;
      const float xn = dvd(sub(u0, cx), fx);
      const float yn = dvd(sub(v0, cy), fy);
      float pr[3], pt[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pr[k] = add(add(mul(xn, rc.T[4 * k]), mul(yn, rc.T[4 * k + 1])),
                    rc.T[4 * k + 2]);
        pt[k] = add(pr[k], mul(rc.T[4 * k + 3], idp));
      }
      const float u = dvd(pt[0], pt[2]);
      const float v = dvd(pt[1], pt[2]);
      const float Ku = add(mul(fx, u), cx);
      const float Kv = add(mul(fy, v), cy);
      const float nid = dvd(idp, pt[2]);
      inb = valid && Ku > 2.0f && Kv > 2.0f &&
            Ku < static_cast<float>(a.w - 3) &&
            Kv < static_cast<float>(a.h - 3) && nid > 0.0f;

      // bilinear sample: the 2x2 support lies inside (false for NaN too)
      float hit[3] = {0.0f, 0.0f, 0.0f};
      const float x0f = floorf(Ku), y0f = floorf(Kv);
      const bool hit_ok = x0f >= 0.0f &&
                          x0f <= static_cast<float>(a.w - 2) &&
                          y0f >= 0.0f && y0f <= static_cast<float>(a.h - 2);
      if (hit_ok) {
        const float ax = sub(Ku, x0f), ay = sub(Kv, y0f);
        const float wc[4] = {mul(sub(1.0f, ax), sub(1.0f, ay)),
                             mul(ax, sub(1.0f, ay)), mul(sub(1.0f, ax), ay),
                             mul(ax, ay)};
        const float4* g = reinterpret_cast<const float4*>(
            a.packed + 12 * (ln * a.h * a.w +
                             static_cast<long long>(y0f) * a.w +
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

      const float res = sub(hit[0], add(mul(aff_a, color), rc.aff_b));
      const float absr = fabsf(res);
      const float hw =
          absr < huber ? 1.0f : dvd(huber, fmaxf(absr, 1e-12f));
      saturated = inb && absr > cutoff;
      inlier = inb && absr <= cutoff;
      if (inlier) e_in = mul(mul(mul(hw, res), res), sub(2.0f, hw));
      if (saturated) e_sat = rc.max_energy;

      // Jacobian columns (calcGSSSE:442-462)
      const float dxf = mul(hit[1], fx), dyf = mul(hit[2], fy);
      const float uv = mul(u, v);
      float Jp[8];
      Jp[0] = mul(nid, dxf);
      Jp[1] = mul(nid, dyf);
      Jp[2] = mul(-nid, add(mul(u, dxf), mul(v, dyf)));
      Jp[3] = -add(mul(uv, dxf), mul(add(1.0f, mul(v, v)), dyf));
      Jp[4] = add(mul(uv, dyf), mul(add(1.0f, mul(u, u)), dxf));
      Jp[5] = sub(mul(u, dyf), mul(v, dxf));
      Jp[6] = mul(aff_a, sub(rc.ref_b, color));
      Jp[7] = -1.0f;
      bool finite = isfinite(res);
#pragma unroll
      for (int k = 0; k < 8; ++k) finite = finite && isfinite(Jp[k]);
      if (inlier || !finite) {
        const float wgt = inlier ? hw : 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          J[k] = Jp[k];
          Jw[k] = mul(Jp[k], wgt);
        }
        r = res;
      }

      // flow indicators over every 32nd valid slot
      flow = valid && (i % 32) == 0;
      if (flow) {
        float ti[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) ti[k] = mul(rc.T[4 * k + 3], idp);
        const float p0[3] = {xn, yn, 1.0f};
        ft = add(
            pix_shift(add(p0[0], ti[0]), add(p0[1], ti[1]),
                      add(p0[2], ti[2]), fx, fy, cx, cy, u0, v0),
            pix_shift(sub(p0[0], ti[0]), sub(p0[1], ti[1]),
                      sub(p0[2], ti[2]), fx, fy, cx, cy, u0, v0));
        frt = add(
            pix_shift(pt[0], pt[1], pt[2], fx, fy, cx, cy, u0, v0),
            pix_shift(sub(pr[0], ti[0]), sub(pr[1], ti[1]),
                      sub(pr[2], ti[2]), fx, fy, cx, cy, u0, v0));
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      terms[k][tid] = J[k];
      terms[8 + k][tid] = Jw[k];
    }
    terms[kRowR][tid] = r;
    terms[17][tid] = e_in;
    terms[18][tid] = e_sat;
    terms[19][tid] = ft;
    terms[20][tid] = frt;
    // the tile's counts (each a block barrier: the terms are then in
    // shared memory for every thread)
    const int c0 = __syncthreads_count(inb);
    const int c1 = __syncthreads_count(saturated);
    const int c2 = __syncthreads_count(inlier);
    const int c3 = __syncthreads_count(flow);
    if (tid == 0) {
      cnt[0] += c0;
      cnt[1] += c1;
      cnt[2] += c2;
      cnt[3] += c3;
    }

    // this thread's slice of the tile into its sum, in point order
    if (summer) {
      const int per = (m + kSlices - 1) / kSlices;
      const int lo = min(m, slice * per), hi = min(m, lo + per);
      const double* xa = terms[ra];
      const double* xb = terms[rb];
#pragma unroll 4
      for (int p = lo; p < hi; ++p) acc = __fma_rn(xa[p], xb[p], acc);
    }
    __syncthreads();   // the next tile overwrites the terms
  }

  // the block's partial sums: its slices in order
  if (summer) slice_sum[slice][k_sum] = acc;
  __syncthreads();
  if (tid < kSums) {
    double s = slice_sum[0][tid];
#pragma unroll
    for (int j = 1; j < kSlices; ++j) s += slice_sum[j][tid];
    part[tid] = s;
  }
  // rank 0 adds the cluster's partial sums in rank order
  cluster.sync();
  if (rank == 0) {
    if (tid < kSums) {
      double s = part[tid];
#pragma unroll
      for (int c = 1; c < kCluster; ++c)
        s += *cluster.map_shared_rank(&part[tid], c);
      tot[tid] = s;
    } else if (tid < kSums + kCounts) {
      int s = 0;
#pragma unroll
      for (int c = 0; c < kCluster; ++c)
        s += *cluster.map_shared_rank(&cnt[tid - kSums], c);
      totc[tid - kSums] = s;
    }
  }
  // no block leaves while rank 0 may still read its shared memory
  cluster.sync();
  if (rank != 0) return;

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
  track_res_gs_kernel<<<dim3(kCluster, rows), kThreads, 0,
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
