// The rest of one tracking LM iteration (trackNewestCoarse's LM loop,
// CoarseTracker.cpp:703-818), in two launches around the residual
// evaluation (csrc/track_res_gs.cu):
//
//   sdv_lm_step    the damped solve (H + diag(H) lambda + 1e-12 I) inc = -b
//                  of each row's scaled 8x8 system, the extrapolation
//                  factor, the zeroing of non-finite steps, the step
//                  scale, T_new = se3_exp(inc[:6]) T, aff_new, and the
//                  brightness transfer of aff_new (aff_transfer) that the
//                  evaluation takes;
//   sdv_lm_accept  after the evaluation at T_new: the accept test on E / n,
//                  the per-row selects of T, aff and the residual carries,
//                  the lambda update, `done`, `n_it` and the loop's flag
//                  (whether any row is still running).
//
// Stands for the JAX package's LM body (sdv_loam_tpu/ops/photometric.py
// :310-328, with _solve_scaled :264-275), which XLA fuses; no Pallas kernel
// exists for it. The plain PyTorch versions are
// hopper_kernels.lm_update_step_plain and lm_update_accept_plain (the
// solve there is torch.linalg.solve_ex).
//
// Bound on the card: latency. A row is 8x8 numbers: the step reads ~300
// bytes and does ~700 operations per row, the accept moves ~600 bytes per
// row; for 32 rows both are far under a microsecond at the card's peaks.
// Both launch once for all rows: the step with one thread per row, the
// accept as one block (so the block also reduces the loop's flag) whose
// threads copy the selected carries element by element, coalesced.
//
// The solve is LU with partial pivoting in a fixed order (the first row of
// largest magnitude in each column), then forward and back substitution,
// in float64 registers (the damped system is formed in float32 as the
// plain version forms it; the step is rounded to float32): deterministic,
// and the same for a row alone and among others. The tracking systems are
// ill-conditioned, so a float32 solve (the plain version's, on LAPACK or
// cuSOLVER alike) leaves an error in the step that the LM then follows;
// the float64 solve leaves only the error of forming the system in
// float32 (DSO's CoarseTracker solves this system in double too: its
// Mat88 is a double matrix). It is held to torch.linalg.solve_ex under a
// tolerance, not bit for bit.
//
// Device counters (g_launches: step, accept) are incremented by one thread
// per launch, so launches inside a CUDA graph's IF and WHILE nodes count
// each time they run; sdv_track_lm_update_counts reads or resets them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStepThreads = 128;
constexpr int kAcceptThreads = 256;
constexpr float kLambdaLimit = 0.001f;   // LAMBDA_EXTRAPOLATION_LIMIT

__constant__ float kStepScale[8] = {1.0f, 1.0f, 1.0f, 0.5f,
                                    0.5f, 0.5f, 10.0f, 1000.0f};

__device__ unsigned long long g_launches[2];

struct StepArgs {
  const float* H;        // (B, 8, 8)
  const float* b;        // (B, 8)
  const float* lam;      // (B,)
  const float* T;        // (B, 4, 4)
  const float* aff;      // (B, 2)
  const float* exposures;   // (2,) or (B, 2): row stride exp_stride
  long long exp_stride;
  const float* ref_aff;     // (2,) or (B, 2): row stride ref_stride
  long long ref_stride;
  float* T_new;          // (B, 4, 4)
  float* aff_new;        // (B, 2)
  float* aff_rel;        // (B, 2)
  float* inc;            // (B, 8)
  int rows;
};

__global__ void __launch_bounds__(kStepThreads) lm_step_kernel(StepArgs a) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_launches[0], 1ull);
  if (row >= a.rows) return;

  // the damped system, formed in float32 as the plain version forms it,
  // then solved in float64
  const float lam = a.lam[row];
  double A[8][8], x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float hij = a.H[64 * row + 8 * i + j];
      A[i][j] = i == j ? __fadd_rn(__fadd_rn(hij, __fmul_rn(hij, lam)),
                                   1e-12f)
                       : __fadd_rn(hij, __fmul_rn(0.0f, lam));
    }
    x[i] = -a.b[8 * row + i];
  }
  // LU with partial pivoting, eliminating below the pivot row by row
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int p = k;
    double best = fabs(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      if (fabs(A[i][k]) > best) {
        best = fabs(A[i][k]);
        p = i;
      }
    }
    if (p != k) {
      // swap through registers: every row is visited, so the indices
      // stay compile-time constants
#pragma unroll
      for (int i = k + 1; i < 8; ++i) {
        if (i == p) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const double tmp = A[k][j];
            A[k][j] = A[i][j];
            A[i][j] = tmp;
          }
          const double tmp = x[k];
          x[k] = x[i];
          x[i] = tmp;
        }
      }
    }
#pragma unroll
    for (int i = k + 1; i < 8; ++i) {
      const double l = A[i][k] / A[k][k];
#pragma unroll
      for (int j = k + 1; j < 8; ++j) A[i][j] -= l * A[k][j];
      x[i] -= l * x[k];
    }
  }
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    double s = x[i];
#pragma unroll
    for (int j = i + 1; j < 8; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
  }

  const float extrap =
      lam < kLambdaLimit ? sqrtf(sqrtf(kLambdaLimit / fmaxf(lam, 1e-12f)))
                         : 1.0f;
  float xi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = static_cast<float>(x[i]) * extrap;
    s = isfinite(s) ? s : 0.0f;
    a.inc[8 * row + i] = s;
    xi[i] = s * kStepScale[i];
  }

  // se3_exp of [upsilon, omega] = xi[0:6] (utils/se3.se3_exp)
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
  for (int i = 0; i < 3; ++i) {
    float tv = 0.0f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float w2ij = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) w2ij += W[i][k] * W[k][j];
      const float id = i == j ? 1.0f : 0.0f;
      E[i][j] = id + ca * W[i][j] + cb * w2ij;
      tv += (id + cb * W[i][j] + cc * w2ij) * xi[j];
    }
    E[i][3] = tv;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
  const float* T = a.T + 16 * row;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += E[i][k] * T[4 * k + j];
      a.T_new[16 * row + 4 * i + j] = s;
    }
  }

  // aff_new and its transfer from the reference (aff_transfer)
  const float an0 = a.aff[2 * row] + xi[6];
  const float an1 = a.aff[2 * row + 1] + xi[7];
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
  int rows;
};

__device__ __forceinline__ float energy(const float* E, const long long* n,
                                        int row) {
  return E[row] / static_cast<float>(n[row] > 1 ? n[row] : 1);
}

// whether a running row takes the state at T_new (its energy per term
// is lower)
__device__ __forceinline__ bool takes(const AcceptArgs& a, int row) {
  return !a.done[row] &&
         energy(a.rn.E, a.rn.n, row) < energy(a.r.E, a.r.n, row);
}

// out[i] = (row i / width takes T_new) ? fresh[i] : kept[i], the block's
// threads over consecutive elements
__device__ __forceinline__ void select_rows(const AcceptArgs& a, int width,
                                            const float* fresh,
                                            const float* kept, float* out) {
  for (int i = threadIdx.x; i < a.rows * width; i += kAcceptThreads)
    out[i] = takes(a, i / width) ? fresh[i] : kept[i];
}

__global__ void __launch_bounds__(kAcceptThreads)
lm_accept_kernel(AcceptArgs a) {
  const int tid = threadIdx.x;
  if (tid == 0) atomicAdd(&g_launches[1], 1ull);
  // the wide carries, element by element
  select_rows(a, 64, a.rn.H, a.r.H, a.H);
  select_rows(a, 16, a.T_new, a.T, a.T_out);
  select_rows(a, 8, a.rn.b, a.r.b, a.b);
  select_rows(a, 2, a.aff_new, a.aff, a.aff_out);
  // the per-row carries and decisions
  bool running = false;
  for (int row = tid; row < a.rows; row += kAcceptThreads) {
    const bool act = !a.done[row];
    const bool accept = energy(a.rn.E, a.rn.n, row) <
                        energy(a.r.E, a.r.n, row);
    const Res& s = accept && act ? a.rn : a.r;
    a.E[row] = s.E[row];
    a.n[row] = s.n[row];
    a.sat[row] = s.sat[row];
    a.ft[row] = s.ft[row];
    a.frt[row] = s.frt[row];
    const float lam = a.lam[row];
    const float lam_n =
        accept ? lam * 0.5f : fmaxf(lam * 4.0f, kLambdaLimit);
    a.lam_out[row] = act ? lam_n : lam;
    float ss = 0.0f;
    for (int k = 0; k < 8; ++k) ss += a.inc[8 * row + k] * a.inc[8 * row + k];
    const bool small = !(sqrtf(ss) > 1e-3f);
    const bool done = a.done[row] || (act && small);
    a.done_out[row] = done;
    a.n_it_out[row] = a.n_it[row] + (act ? 1 : 0);
    running = running || !done;
  }
  running = __syncthreads_or(running);
  if (tid == 0) *a.active = running;
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

}  // namespace

// p: H, b, lam, T, aff, exposures, ref_aff, T_new, aff_new, aff_rel, inc
extern "C" int sdv_lm_step(void* const* p, int rows,
                           long long exp_stride, long long ref_stride,
                           void* stream) {
  if (rows <= 0) return 0;
  StepArgs a;
  a.H = static_cast<const float*>(p[0]);
  a.b = static_cast<const float*>(p[1]);
  a.lam = static_cast<const float*>(p[2]);
  a.T = static_cast<const float*>(p[3]);
  a.aff = static_cast<const float*>(p[4]);
  a.exposures = static_cast<const float*>(p[5]);
  a.exp_stride = exp_stride;
  a.ref_aff = static_cast<const float*>(p[6]);
  a.ref_stride = ref_stride;
  a.T_new = static_cast<float*>(p[7]);
  a.aff_new = static_cast<float*>(p[8]);
  a.aff_rel = static_cast<float*>(p[9]);
  a.inc = static_cast<float*>(p[10]);
  a.rows = rows;
  const int blocks = (rows + kStepThreads - 1) / kStepThreads;
  lm_step_kernel<<<blocks, kStepThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// p: the carried residual (7: E, n, sat_frac, H, b, flow_t, flow_rt), the
//    residual at T_new (7), T, T_new, aff, aff_new, lam, done, n_it, inc,
//    then the outputs E, n, sat_frac, H, b, flow_t, flow_rt, T, aff, lam,
//    done, n_it, active
extern "C" int sdv_lm_accept(void* const* p, int rows, void* stream) {
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
  a.rows = rows;
  lm_accept_kernel<<<1, kAcceptThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launches counted on the current device since the last reset (step,
// accept) into out[0..1]; with `reset`, the counters are zeroed after the
// read.
extern "C" int sdv_track_lm_update_counts(unsigned long long* out,
                                          int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_launches, 2 * sizeof(*out));
  if (err != cudaSuccess || !reset) return err;
  const unsigned long long zero[2] = {0, 0};
  return cudaMemcpyToSymbol(g_launches, zero, sizeof(zero));
}
