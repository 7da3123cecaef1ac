// The rest of one tracking LM iteration (trackNewestCoarse's LM loop,
// CoarseTracker.cpp:703-818) around the residual evaluation
// (csrc/track_res_gs.cu), in one launch per iteration:
//
//   sdv_lm_step         the damped solve (H + diag(H) lambda + 1e-12 I)
//                       inc = -b of each row's scaled 8x8 system, the
//                       extrapolation factor, the zeroing of non-finite
//                       steps, the step scale, T_new = se3_exp(inc[:6]) T,
//                       aff_new, and the brightness transfer of aff_new
//                       (aff_transfer) that the evaluation takes; launched
//                       once per LM call, before its loop;
//   sdv_lm_accept_step  after the evaluation at T_new: the accept test on
//                       E / n, the per-row selects of T, aff and the
//                       residual carries, the lambda update, `done`, `n_it`
//                       and the loop's flag (whether any row is still
//                       running), then, from the carries just selected, the
//                       next iteration's step (as sdv_lm_step). The step
//                       after the loop's last accept goes unused.
//
// Stands for the JAX package's LM body (sdv_loam_tpu/ops/photometric.py
// :310-328, with _solve_scaled :264-275), which XLA fuses; no Pallas kernel
// exists for it. The plain PyTorch versions are
// hopper_kernels.lm_update_step_plain and lm_update_accept_step_plain
// (lm_update_accept_plain, then lm_update_step_plain; the solve there is
// torch.linalg.solve_ex).
//
// Bound on the card: latency. A row is 8x8 numbers: the step reads ~300
// bytes and does ~700 operations per row, the accept moves ~600 bytes per
// row; for 32 rows both are far under a microsecond at the card's peaks.
// What it costs is the chain of dependent float64 operations of the solve
// and the launches. The design: one launch per LM iteration (the accept of
// one iteration and the step of the next), a warp per row. In a row's
// warp, lanes 0-7 hold the rows of the damped system and of x (each group
// of 8 lanes holds the same system); the pivot search, the row swap and
// the elimination run across the lanes with shuffles, and the carries are
// copied by the warp's lanes, coalesced, with the accept test computed
// once per row. The accept-step runs as one thread block cluster of 8
// blocks of W warps (W = ceil(B / 8), at most 16; warp w of block c takes
// rows c W + w, then 8 W further on): a row's warp carries 32 lanes of
// float64 work, and one block of 32 such warps on one SM was bound by that
// SM's float64 rate (on an H100 80GB at 700 W: 12.8 us for 32 rows, where
// the step alone, over 4 SMs, took 5 us). The loop's flag is each block's
// OR (__syncthreads_or), then rank 0's OR of the blocks' flags through the
// cluster's distributed shared memory.
//
// The solve is LU with partial pivoting in a fixed order, then forward and
// back substitution, in float64 registers (the damped system is formed in
// float32 as the plain version forms it; the step is rounded to float32):
// deterministic, and the same for a row alone and among others. Pivot
// rule, that of a serial scan down column k (a one-thread-per-row solve):
// the first row of strictly largest |A[i][k]| among rows k..7, where a
// NaN never wins, and row k when |A[k][k]| is NaN (no comparison with it
// is true). Each element sees the operations of that serial solve in the
// same order, each multiply-subtract fused as nvcc contracts it
// (A[i][j] - l A[k][j] as one rounding), so the step is bit for bit that
// serial solve's. The tracking systems are ill-conditioned, so a float32
// solve (the plain version's, on LAPACK or cuSOLVER alike) leaves an error
// in the step that the LM then follows; the float64 solve leaves only the
// error of forming the system in float32 (DSO's CoarseTracker solves this
// system in double too: its Mat88 is a double matrix). It is held to
// torch.linalg.solve_ex under a tolerance, not bit for bit.
//
// Device counters (g_launches: step, accept_step) are incremented by one
// thread per launch, so launches inside a CUDA graph's IF and WHILE nodes
// count each time they run; sdv_track_lm_update_counts reads or resets
// them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kStepWarps = 8;      // sdv_lm_step: warps (rows) per block
// sdv_lm_accept_step: one cluster of kCluster blocks of at most kMaxWarps
// warps, a warp per row (more rows: each warp takes several in turn)
constexpr int kCluster = 8;
constexpr int kMaxWarps = 16;
constexpr float kLambdaLimit = 0.001f;   // LAMBDA_EXTRAPOLATION_LIMIT
constexpr unsigned kAll = 0xffffffffu;

__constant__ float kStepScale[8] = {1.0f, 1.0f, 1.0f, 0.5f,
                                    0.5f, 0.5f, 10.0f, 1000.0f};

__device__ unsigned long long g_launches[2];

// the step's per-row inputs and outputs
struct StepArgs {
  const float* exposures;   // (2,) or (B, 2): row stride exp_stride
  long long exp_stride;
  const float* ref_aff;     // (2,) or (B, 2): row stride ref_stride
  long long ref_stride;
  float* T_new;          // (B, 4, 4)
  float* aff_new;        // (B, 2)
  float* aff_rel;        // (B, 2)
  float* inc;            // (B, 8)
};

// The inputs of one row's step as its warp's lanes hold them: lane i (mod
// 8) row i of H and b[i]; lane 4 r + c (< 16) column c of T; the affine
// state in every lane.
struct StepIn {
  float h[8];
  float b;
  float tcol[4];
  float aff0, aff1;
  float lam;
};

// The loads of StepIn from a row's carries (H (8, 8), b (8,), T (4, 4),
// aff (2,)).
__device__ __forceinline__ void load_step(StepIn& in, const float* H,
                                          const float* b, const float* T,
                                          const float* aff, int lane) {
  const int i = lane & 7, c = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) in.h[j] = H[8 * i + j];
  in.b = b[i];
#pragma unroll
  for (int k = 0; k < 4; ++k) in.tcol[k] = T[4 * k + c];
  in.aff0 = aff[0];
  in.aff1 = aff[1];
}

// One row's step, by its warp (every lane passes).
__device__ void step_row(const StepArgs& a, int row, const StepIn& in,
                         int lane) {
  const float lam = in.lam;
  // lane i (mod 8) holds row i of the damped system, formed in float32 as
  // the plain version forms it, then solved in float64
  const int i = lane & 7;
  const int group = lane & ~7;   // the first lane of this lane's 8
  double A[8];
  double x;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float hij = in.h[j];
    A[j] = i == j ? __fadd_rn(__fadd_rn(hij, __fmul_rn(hij, lam)), 1e-12f)
                  : __fadd_rn(hij, __fmul_rn(0.0f, lam));
  }
  x = -in.b;
  // LU with partial pivoting, eliminating below the pivot row
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    // the pivot: the serial scan's choice (see the top of the file), the
    // lowest row holding the largest key; a NaN ranks below every
    // magnitude (row k's NaN above all: the scan then keeps k), rows above
    // k below that
    const double mag = fabs(A[k]);
    const double key =
        i < k ? -2.0 : (isnan(mag) ? (i == k ? INFINITY : -1.0) : mag);
    double best = key;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      best = fmax(best, __shfl_xor_sync(kAll, best, off, 8));
    const int p =
        __ffs((__ballot_sync(kAll, key == best) >> group) & 0xffu) - 1;
    // the pivot row (row p) to every lane; rows k and p trade places
    // (columns below k are no longer read)
    double piv[8], row_k[8];
#pragma unroll
    for (int j = k; j < 8; ++j) {
      piv[j] = __shfl_sync(kAll, A[j], p, 8);
      row_k[j] = __shfl_sync(kAll, A[j], k, 8);
    }
    const double xp = __shfl_sync(kAll, x, p, 8);
    const double xk = __shfl_sync(kAll, x, k, 8);
    if (i == k || i == p) {
#pragma unroll
      for (int j = k; j < 8; ++j) A[j] = i == k ? piv[j] : row_k[j];
      x = i == k ? xp : xk;
    }
    if (i > k) {
      const double l = __ddiv_rn(A[k], piv[k]);
#pragma unroll
      for (int j = k + 1; j < 8; ++j) A[j] = __fma_rn(-l, piv[j], A[j]);
      x = __fma_rn(-l, xp, x);
    }
  }
  // back substitution: x_i = (x_i - A[i][i+1] x_{i+1} - ...) / A[i][i],
  // computed by lane i, its terms in column order, then shared
  double X[8];
#pragma unroll
  for (int r = 7; r >= 0; --r) {
    double s = x;
#pragma unroll
    for (int j = r + 1; j < 8; ++j) s = __fma_rn(-A[j], X[j], s);
    X[r] = __shfl_sync(kAll, __ddiv_rn(s, A[r]), r, 8);
  }

  const float extrap =
      lam < kLambdaLimit ? sqrtf(sqrtf(kLambdaLimit / fmaxf(lam, 1e-12f)))
                         : 1.0f;
  float xi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float s = static_cast<float>(X[j]) * extrap;
    s = isfinite(s) ? s : 0.0f;
    if (lane == j) a.inc[8 * row + j] = s;
    xi[j] = s * kStepScale[j];
  }

  // se3_exp of [upsilon, omega] = xi[0:6] (utils/se3.se3_exp), every lane
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float theta = sqrtf(fmaxf(theta2, 1e-30f));
  const bool small = theta2 < 1e-8f;
  const float t2c = fmaxf(theta2, 1e-30f);
  const float ca = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float cb = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / t2c;
  const float cc = small ? 1.0f / 6.0f - theta2 / 120.0f : (1.0f - ca) / t2c;
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float E[4][4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float tv = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float w2ij = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) w2ij += W[r][k] * W[k][j];
      const float id = r == j ? 1.0f : 0.0f;
      E[r][j] = id + ca * W[r][j] + cb * w2ij;
      tv += (id + cb * W[r][j] + cc * w2ij) * xi[j];
    }
    E[r][3] = tv;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
  // T_new = E T: lane 4 r + c (r, c < 4) forms element (r, c)
  if (lane < 16) {
    const int r = lane >> 2, c = lane & 3;
    float e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      e[k] = r == 0 ? E[0][k] : r == 1 ? E[1][k] : r == 2 ? E[2][k]
                                                          : E[3][k];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) s += e[k] * in.tcol[k];
    a.T_new[16 * row + lane] = s;
  } else if (lane == 16) {
    // aff_new and its transfer from the reference (aff_transfer)
    const float an0 = in.aff0 + xi[6];
    const float an1 = in.aff1 + xi[7];
    a.aff_new[2 * row] = an0;
    a.aff_new[2 * row + 1] = an1;
    const float* ex = a.exposures + a.exp_stride * row;
    const float* ra = a.ref_aff + a.ref_stride * row;
    const bool zero = ex[0] == 0.0f || ex[1] == 0.0f;
    const float er = zero ? 1.0f : ex[0], en = zero ? 1.0f : ex[1];
    const float rel_a = expf(an0 - ra[0]) * en / er;
    a.aff_rel[2 * row] = rel_a;
    a.aff_rel[2 * row + 1] = an1 - rel_a * ra[1];
  }
}

struct StepOnlyArgs {
  const float* H;        // (B, 8, 8)
  const float* b;        // (B, 8)
  const float* lam;      // (B,)
  const float* T;        // (B, 4, 4)
  const float* aff;      // (B, 2)
  StepArgs s;
  int rows;
};

__global__ void __launch_bounds__(32 * kStepWarps)
lm_step_kernel(StepOnlyArgs a) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches[0], 1ull);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kStepWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  StepIn in;
  load_step(in, a.H + 64 * row, a.b + 8 * row, a.T + 16 * row,
            a.aff + 2 * row, lane);
  in.lam = a.lam[row];
  step_row(a.s, row, in, lane);
}

// residual carries of one LM state: E, n, sat_frac, H, b, flow_t, flow_rt
struct Res {
  const float* E;
  const long long* n;
  const float* sat;
  const float* H;
  const float* b;
  const float* ft;
  const float* frt;
};

struct AcceptArgs {
  Res r, rn;             // the carried residual, and the one at T_new
  const float* T;
  const float* T_new;
  const float* aff;
  const float* aff_new;
  const float* lam;
  const bool* done;
  const long long* n_it;
  const float* inc;
  // outputs
  float* E;
  long long* n;
  float* sat;
  float* H;
  float* b;
  float* ft;
  float* frt;
  float* T_out;
  float* aff_out;
  float* lam_out;
  bool* done_out;
  long long* n_it_out;
  bool* active;          // () any row still running
  StepArgs s;            // the next step's outputs
  int rows;
};

__device__ __forceinline__ float energy(const float* E, const long long* n,
                                        int row) {
  return E[row] / static_cast<float>(n[row] > 1 ? n[row] : 1);
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(32 * kMaxWarps)
lm_accept_step_kernel(AcceptArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches[1], 1ull);
  bool running = false;
  for (int row = blockIdx.x * warps + (threadIdx.x >> 5); row < a.rows;
       row += kCluster * warps) {
    // the accept test, once per row (every lane alike)
    const bool act = !a.done[row];
    const bool accept = energy(a.rn.E, a.rn.n, row) <
                        energy(a.r.E, a.r.n, row);
    const bool take = accept && act;
    const float* H = (take ? a.rn.H : a.r.H) + 64 * row;
    const float* b = (take ? a.rn.b : a.r.b) + 8 * row;
    const float* T = (take ? a.T_new : a.T) + 16 * row;
    const float* aff = (take ? a.aff_new : a.aff) + 2 * row;
    StepIn in;
    load_step(in, H, b, T, aff, lane);
    // the carries, copied by the warp's lanes
#pragma unroll
    for (int e = lane; e < 64; e += 32) a.H[64 * row + e] = H[e];
    if (lane < 16) a.T_out[16 * row + lane] = T[lane];
    if (lane < 8) a.b[8 * row + lane] = b[lane];
    if (lane < 2) a.aff_out[2 * row + lane] = aff[lane];
    const float lam = a.lam[row];
    const float lam_n =
        accept ? lam * 0.5f : fmaxf(lam * 4.0f, kLambdaLimit);
    const float lam_out = act ? lam_n : lam;
    float ss = 0.0f;
    for (int k = 0; k < 8; ++k) ss += a.inc[8 * row + k] * a.inc[8 * row + k];
    const bool small = !(sqrtf(ss) > 1e-3f);
    const bool done = a.done[row] || (act && small);
    if (lane == 0) {
      a.E[row] = (take ? a.rn.E : a.r.E)[row];
      a.n[row] = (take ? a.rn.n : a.r.n)[row];
      a.sat[row] = (take ? a.rn.sat : a.r.sat)[row];
      a.ft[row] = (take ? a.rn.ft : a.r.ft)[row];
      a.frt[row] = (take ? a.rn.frt : a.r.frt)[row];
      a.lam_out[row] = lam_out;
      a.done_out[row] = done;
      a.n_it_out[row] = a.n_it[row] + (act ? 1 : 0);
    }
    running = running || !done;
    // the next iteration's step from the carries just selected
    in.lam = lam_out;
    step_row(a.s, row, in, lane);
  }
  // the loop's flag: each block's OR, then rank 0 ORs the blocks' in rank
  // order through the cluster's shared memory
  __shared__ int block_running;
  running = __syncthreads_or(running);
  if (threadIdx.x == 0) block_running = running;
  cluster.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    int any = 0;
#pragma unroll
    for (int c = 0; c < kCluster; ++c)
      any |= *cluster.map_shared_rank(&block_running, c);
    *a.active = any != 0;
  }
  // no block leaves while rank 0 may still read its flag
  cluster.sync();
}

Res res_from(void* const* p) {
  return Res{static_cast<const float*>(p[0]),
             static_cast<const long long*>(p[1]),
             static_cast<const float*>(p[2]),
             static_cast<const float*>(p[3]),
             static_cast<const float*>(p[4]),
             static_cast<const float*>(p[5]),
             static_cast<const float*>(p[6])};
}

// p: exposures, ref_aff, T_new, aff_new, aff_rel, inc
StepArgs step_from(void* const* p, long long exp_stride,
                   long long ref_stride) {
  return StepArgs{static_cast<const float*>(p[0]), exp_stride,
                  static_cast<const float*>(p[1]), ref_stride,
                  static_cast<float*>(p[2]), static_cast<float*>(p[3]),
                  static_cast<float*>(p[4]), static_cast<float*>(p[5])};
}

}  // namespace

// p: H, b, lam, T, aff, exposures, ref_aff, T_new, aff_new, aff_rel, inc
extern "C" int sdv_lm_step(void* const* p, int rows,
                           long long exp_stride, long long ref_stride,
                           void* stream) {
  if (rows <= 0) return 0;
  StepOnlyArgs a;
  a.H = static_cast<const float*>(p[0]);
  a.b = static_cast<const float*>(p[1]);
  a.lam = static_cast<const float*>(p[2]);
  a.T = static_cast<const float*>(p[3]);
  a.aff = static_cast<const float*>(p[4]);
  a.s = step_from(p + 5, exp_stride, ref_stride);
  a.rows = rows;
  const int blocks = (rows + kStepWarps - 1) / kStepWarps;
  lm_step_kernel<<<blocks, 32 * kStepWarps, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// p: the carried residual (7: E, n, sat_frac, H, b, flow_t, flow_rt), the
//    residual at T_new (7), T, T_new, aff, aff_new, lam, done, n_it, inc,
//    then the outputs E, n, sat_frac, H, b, flow_t, flow_rt, T, aff, lam,
//    done, n_it, active, then the step's exposures, ref_aff and outputs
//    T_new, aff_new, aff_rel, inc
extern "C" int sdv_lm_accept_step(void* const* p, int rows,
                                  long long exp_stride, long long ref_stride,
                                  void* stream) {
  if (rows <= 0) return 0;
  AcceptArgs a;
  a.r = res_from(p);
  a.rn = res_from(p + 7);
  a.T = static_cast<const float*>(p[14]);
  a.T_new = static_cast<const float*>(p[15]);
  a.aff = static_cast<const float*>(p[16]);
  a.aff_new = static_cast<const float*>(p[17]);
  a.lam = static_cast<const float*>(p[18]);
  a.done = static_cast<const bool*>(p[19]);
  a.n_it = static_cast<const long long*>(p[20]);
  a.inc = static_cast<const float*>(p[21]);
  a.E = static_cast<float*>(p[22]);
  a.n = static_cast<long long*>(p[23]);
  a.sat = static_cast<float*>(p[24]);
  a.H = static_cast<float*>(p[25]);
  a.b = static_cast<float*>(p[26]);
  a.ft = static_cast<float*>(p[27]);
  a.frt = static_cast<float*>(p[28]);
  a.T_out = static_cast<float*>(p[29]);
  a.aff_out = static_cast<float*>(p[30]);
  a.lam_out = static_cast<float*>(p[31]);
  a.done_out = static_cast<bool*>(p[32]);
  a.n_it_out = static_cast<long long*>(p[33]);
  a.active = static_cast<bool*>(p[34]);
  a.s = step_from(p + 35, exp_stride, ref_stride);
  a.rows = rows;
  const int per_block = (rows + kCluster - 1) / kCluster;
  const int warps = per_block < kMaxWarps ? per_block : kMaxWarps;
  lm_accept_step_kernel<<<kCluster, 32 * warps, 0,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launches counted on the current device since the last reset (step,
// accept_step) into out[0..1]; with `reset`, the counters are zeroed after
// the read.
extern "C" int sdv_track_lm_update_counts(unsigned long long* out,
                                          int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_launches, 2 * sizeof(*out));
  if (err != cudaSuccess || !reset) return err;
  const unsigned long long zero[2] = {0, 0};
  return cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}
