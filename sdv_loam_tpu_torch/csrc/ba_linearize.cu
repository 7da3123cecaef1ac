// The windowed BA's residual linearization (PointFrameResidual::linearize)
// over the dense (L, N, F) residual grid of L windows, one launch.
//
// Stands for the JAX package's XLA-fused `linearize_residuals`
// (sdv_loam_tpu/models/backend.py), given its photometric gate; no Pallas
// kernel exists for it. The plain PyTorch version is
// models/backend.linearize_residuals_lanes_plain; this kernel computes the
// same function once the gate (energy_phot, wJI2) is given: per residual
// (lane, point, target) the FEJ projection through the pair's (R0, t0), the
// current projection through (Rc, tc) where the residual is not taken at the
// FEJ point, the projection and bounds tests, the 2-D reprojection residual
// against the matcher's position, its Huber weight and energy, the pose,
// calibration and depth Jacobians scaled by the weight's square root, the
// outlier test against the host's and target's energy thresholds, the
// residual's new state, and the zeroing of every non-IN residual's terms.
// The plain version gathers the pairs' transforms per residual; here a
// block stages its lane's F * F pairs (and K and the thresholds) in shared
// memory and each thread reads its residual's pair from there.
//
// Bound on the card: bytes. A residual reads 19 bytes (the matcher's
// position, its flags and state, the gate's two values) and writes 114
// (resF, Jxi, Jc, Jd, the energy, the centre, the state and proj_ok), a
// point 20 more, so at L = 8, N = 4096, F = 8 it moves 35.6 MB: 10.6 us
// at 3.35 TB/s; it does ~120 float32 operations a residual (31 M, 0.5 us
// at 67 TFLOP/s). The
// design: one thread per residual, consecutive threads on consecutive
// residuals (each output row is one or a few vector stores of a
// contiguous run); the pairs in shared memory replace four gathers of
// (L, N, F, 3, 3) and (L, N, F, 3) tensors.
//
// Precision: every quantity is float32, each operation rounded on its own
// (no fused multiply-add), in the order of the plain version's tensor
// operations; the plain version's products R0 @ [x, y, 1] and the norm of
// the residual are library reductions whose order is the library's, here
// ((R[0] x + R[1] y) + R[2]) + t * idepth and sqrt(r0 r0 + r1 r1); a
// scalar over a tensor is torch's reciprocal times the scalar. The CPU
// emulation of this arithmetic (tests/k7_lin.py) gives the kernel's bits.
// There is no reduction: every output is one residual's.
//
// A device counter (g_launches) is incremented by one thread per launch, so
// launches captured in a CUDA graph, also inside its IF and WHILE nodes,
// are counted each time they run; sdv_ba_linearize_counts reads or resets
// it (the caller synchronizes the device first).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // residuals per block
constexpr int kMaxF = 8;        // frame slots (the pairs staged: F * F)
constexpr int RES_IN = 0, RES_OOB = 1, RES_OUTLIER = 2;

__device__ unsigned long long g_launches;

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
// torch.clamp(x, min=lo) and torch.maximum: NaN propagates
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// a strided (L, P, 3, 3) rotation or (L, P, 3) translation view
struct Strided {
  const float* p;
  long long lane, pair, row, col;
};

struct LinArgs {
  // points (L, N)
  const float* u;
  const float* v;
  const float* idepth;
  const long long* host;
  // residual grids (L, N, F); the matcher's position (L, N, F, 2)
  const bool* res_active;
  const int8_t* res_state;
  const float* matcher_px;
  const bool* matcher_valid;
  const float* energy_phot;
  const float* wJI2;
  // the pairs' transforms (pair = host * F + target)
  Strided R0, t0, Rc, tc;
  const float* feth;   // (L, F)
  const float* K;      // (L, 4)
  int N, F, w, h;
  float huber;
  int resf_at_fej;
  // outputs (L, N, F, ...)
  float* resF;
  float* Jxi;
  float* Jc;
  float* Jd;
  int8_t* new_state;
  float* energy;
  float* center;
  bool* proj_ok;
};

// a lane's pair (FEJ R0, t0 and current Rc, tc) in shared memory
struct Pair {
  float R0[9], t0[3], Rc[9], tc[3];
};

__global__ void __launch_bounds__(kThreads)
    ba_linearize_kernel(LinArgs a) {
  const int lane = blockIdx.y;
  const int tid = threadIdx.x;
  const int F = a.F;
  if (lane == 0 && blockIdx.x == 0 && tid == 0) atomicAdd(&g_launches, 1ull);

  __shared__ Pair pairs[kMaxF * kMaxF];
  __shared__ float feth[kMaxF];
  __shared__ float Kc[4];
  const int n_pairs = F * F;
  for (int e = tid; e < n_pairs * 24; e += kThreads) {
    const int p = e / 24, k = e % 24;
    float* dst = reinterpret_cast<float*>(&pairs[p]) + k;
    const Strided& s = k < 9 ? a.R0 : k < 12 ? a.t0 : k < 21 ? a.Rc : a.tc;
    long long off = s.lane * lane + s.pair * p;
    if (k < 9) {
      off += s.row * (k / 3) + s.col * (k % 3);
    } else if (k < 12) {
      off += s.row * (k - 9);
    } else if (k < 21) {
      off += s.row * ((k - 12) / 3) + s.col * ((k - 12) % 3);
    } else {
      off += s.row * (k - 21);
    }
    *dst = s.p[off];
  }
  if (tid < F) feth[tid] = a.feth[lane * F + tid];
  if (tid < 4) Kc[tid] = a.K[lane * 4 + tid];
  __syncthreads();

  const long long r_lane = static_cast<long long>(a.N) * F;
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (r >= r_lane) return;
  const int n = static_cast<int>(r / F);
  const int f = static_cast<int>(r % F);
  const long long pt = static_cast<long long>(lane) * a.N + n;
  const long long ri = static_cast<long long>(lane) * r_lane + r;

  const float fx = Kc[0], fy = Kc[1], cx = Kc[2], cy = Kc[3];
  const float fxi = dvd(1.0f, fx), fyi = dvd(1.0f, fy);
  const float pu = a.u[pt], pv = a.v[pt], idp = a.idepth[pt];
  long long hst = a.host[pt];
  hst = hst < 0 ? 0 : (hst >= F ? F - 1 : hst);   // slots lie in [0, F)
  const int host = static_cast<int>(hst);
  const Pair& P = pairs[host * F + f];

  const float k0 = mul(sub(pu, cx), fxi);
  const float k1 = mul(sub(pv, cy), fyi);
  float ptp[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    ptp[i] = add(add(add(mul(P.R0[3 * i], k0), mul(P.R0[3 * i + 1], k1)),
                     P.R0[3 * i + 2]),
                 mul(P.t0[i], idp));
  const float drescale = dvd(1.0f, ptp[2]);
  const float nid0 = mul(idp, drescale);
  const float uu = mul(ptp[0], drescale);
  const float vv = mul(ptp[1], drescale);
  const float Ku0 = add(mul(uu, fx), cx);
  const float Kv0 = add(mul(vv, fy), cy);
  const float wlim = static_cast<float>(a.w - 3);
  const float hlim = static_cast<float>(a.h - 3);

  float Ku, Kv, nid;
  bool pok;
  if (a.resf_at_fej) {
    Ku = Ku0;
    Kv = Kv0;
    nid = nid0;
    pok = drescale > 0.0f && Ku0 > 1.1f && Kv0 > 1.1f && Ku0 < wlim &&
          Kv0 < hlim;
  } else {
    float ptc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      ptc[i] = add(add(add(mul(P.Rc[3 * i], k0), mul(P.Rc[3 * i + 1], k1)),
                       P.Rc[3 * i + 2]),
                   mul(P.tc[i], idp));
    const float drc = dvd(1.0f, ptc[2]);
    nid = mul(idp, drc);
    Ku = add(mul(mul(ptc[0], drc), fx), cx);
    Kv = add(mul(mul(ptc[1], drc), fy), cy);
    pok = drc > 0.0f && Ku > 1.1f && Kv > 1.1f && Ku < wlim && Kv < hlim &&
          drescale > 0.0f;
  }

  const bool mvalid = a.matcher_valid[ri];
  const bool ractive = a.res_active[ri];
  const bool oob =
      !pok || !mvalid || a.res_state[ri] == RES_OOB || !ractive;

  // depth, calibration and pose Jacobians (Residuals.cpp linearize)
  const float dd_x = mul(mul(drescale, sub(P.t0[0], mul(P.t0[2], uu))), fx);
  const float dd_y = mul(mul(drescale, sub(P.t0[1], mul(P.t0[2], vv))), fy);
  const float dCx2 = mul(drescale, sub(mul(P.R0[6], uu), P.R0[0]));
  const float dCx3 =
      mul(mul(mul(fx, drescale), sub(mul(P.R0[7], uu), P.R0[1])), fyi);
  const float dCx0 = mul(k0, dCx2);
  const float dCx1 = mul(k1, dCx3);
  const float dCy2 =
      mul(mul(mul(fy, drescale), sub(mul(P.R0[6], vv), P.R0[3])), fxi);
  const float dCy3 = mul(drescale, sub(mul(P.R0[7], vv), P.R0[4]));
  const float dCy0 = mul(k0, dCy2);
  const float dCy1 = mul(k1, dCy3);
  float Jc[8] = {add(dCx0, uu), dCx1, add(dCx2, 1.0f), dCx3,
                 dCy0, add(dCy1, vv), dCy2, add(dCy3, 1.0f)};
  float Jx[12] = {mul(nid0, fx),
                  0.0f,
                  mul(mul(-nid0, uu), fx),
                  mul(mul(-uu, vv), fx),
                  mul(add(1.0f, mul(uu, uu)), fx),
                  mul(-vv, fx),
                  0.0f,
                  mul(nid0, fy),
                  mul(mul(-nid0, vv), fy),
                  mul(-add(1.0f, mul(vv, vv)), fy),
                  mul(mul(uu, vv), fy),
                  mul(uu, fy)};

  // the reprojection residual against the matcher's position, Huber
  const float r0 = sub(Ku, a.matcher_px[2 * ri]);
  const float r1 = sub(Kv, a.matcher_px[2 * ri + 1]);
  const float rnorm = __fsqrt_rn(add(mul(r0, r0), mul(r1, r1)));
  // huber / x is torch's reciprocal(x) * huber
  const float hw2 = rnorm < a.huber
                        ? 1.0f
                        : mul(dvd(1.0f, clamp_min(rnorm, 1e-12f)), a.huber);
  const float energy2d = mul(mul(hw2, mul(rnorm, rnorm)), sub(2.0f, hw2));
  const float hw2s = hw2 < 1.0f ? __fsqrt_rn(hw2) : hw2;

  const float th = nan_max(feth[host], feth[f]);
  const bool outlier = a.energy_phot[ri] > th || a.wJI2[ri] < 2.0f;
  int st = oob ? RES_OOB : (outlier ? RES_OUTLIER : RES_IN);
  if (!ractive) st = RES_OOB;
  const bool zm = st == RES_IN;

  float res[2] = {0.0f, 0.0f}, jd[2] = {0.0f, 0.0f};
  if (zm) {
    res[0] = mul(r0, hw2s);
    res[1] = mul(r1, hw2s);
    jd[0] = mul(dd_x, hw2s);
    jd[1] = mul(dd_y, hw2s);
#pragma unroll
    for (int k = 0; k < 12; ++k) Jx[k] = mul(Jx[k], hw2s);
#pragma unroll
    for (int k = 0; k < 8; ++k) Jc[k] = mul(Jc[k], hw2s);
  } else {
#pragma unroll
    for (int k = 0; k < 12; ++k) Jx[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) Jc[k] = 0.0f;
  }

  reinterpret_cast<float2*>(a.resF)[ri] = make_float2(res[0], res[1]);
  reinterpret_cast<float2*>(a.Jd)[ri] = make_float2(jd[0], jd[1]);
  float4* jx4 = reinterpret_cast<float4*>(a.Jxi) + 3 * ri;
  jx4[0] = make_float4(Jx[0], Jx[1], Jx[2], Jx[3]);
  jx4[1] = make_float4(Jx[4], Jx[5], Jx[6], Jx[7]);
  jx4[2] = make_float4(Jx[8], Jx[9], Jx[10], Jx[11]);
  float4* jc4 = reinterpret_cast<float4*>(a.Jc) + 2 * ri;
  jc4[0] = make_float4(Jc[0], Jc[1], Jc[2], Jc[3]);
  jc4[1] = make_float4(Jc[4], Jc[5], Jc[6], Jc[7]);
  a.new_state[ri] = static_cast<int8_t>(st);
  a.energy[ri] = (pok && mvalid && ractive) ? energy2d : 0.0f;
  a.center[3 * ri] = Ku;
  a.center[3 * ri + 1] = Kv;
  a.center[3 * ri + 2] = nid;
  a.proj_ok[ri] = pok;
}

}  // namespace

// Launch for L windows of N points and F frame slots on `stream`; returns
// the launch's cudaError_t. p: u, v, idepth, host, res_active, res_state,
// matcher_px, matcher_valid, energy_phot, wJI2, R0, t0, Rc, tc, feth, K,
// resF, Jxi, Jc, Jd, new_state, energy, center, proj_ok; strides: R0's,
// t0's, Rc's and tc's (lane, pair, row, col) in elements (a translation's
// col is unused).
extern "C" int sdv_ba_linearize(void* const* p, const long long* strides,
                                int lanes, int n, int f, int w, int h,
                                float huber, int resf_at_fej, void* stream) {
  if (f < 1 || f > kMaxF) return cudaErrorInvalidValue;
  LinArgs a;
  a.u = static_cast<const float*>(p[0]);
  a.v = static_cast<const float*>(p[1]);
  a.idepth = static_cast<const float*>(p[2]);
  a.host = static_cast<const long long*>(p[3]);
  a.res_active = static_cast<const bool*>(p[4]);
  a.res_state = static_cast<const int8_t*>(p[5]);
  a.matcher_px = static_cast<const float*>(p[6]);
  a.matcher_valid = static_cast<const bool*>(p[7]);
  a.energy_phot = static_cast<const float*>(p[8]);
  a.wJI2 = static_cast<const float*>(p[9]);
  Strided* views[4] = {&a.R0, &a.t0, &a.Rc, &a.tc};
  for (int i = 0; i < 4; ++i) {
    views[i]->p = static_cast<const float*>(p[10 + i]);
    views[i]->lane = strides[4 * i];
    views[i]->pair = strides[4 * i + 1];
    views[i]->row = strides[4 * i + 2];
    views[i]->col = strides[4 * i + 3];
  }
  a.feth = static_cast<const float*>(p[14]);
  a.K = static_cast<const float*>(p[15]);
  a.resF = static_cast<float*>(p[16]);
  a.Jxi = static_cast<float*>(p[17]);
  a.Jc = static_cast<float*>(p[18]);
  a.Jd = static_cast<float*>(p[19]);
  a.new_state = static_cast<int8_t*>(p[20]);
  a.energy = static_cast<float*>(p[21]);
  a.center = static_cast<float*>(p[22]);
  a.proj_ok = static_cast<bool*>(p[23]);
  a.N = n;
  a.F = f;
  a.w = w;
  a.h = h;
  a.huber = huber;
  a.resf_at_fej = resf_at_fej;
  const long long per_lane = static_cast<long long>(n) * f;
  if (lanes <= 0 || per_lane <= 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((per_lane + kThreads - 1) / kThreads);
  ba_linearize_kernel<<<dim3(blocks, lanes), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// The launches counted on the current device since the last reset, into
// *out; with `reset`, the counter is zeroed after the read.
extern "C" int sdv_ba_linearize_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_launches, sizeof(*out));
  if (err != cudaSuccess || !reset) return err;
  const unsigned long long zero = 0;
  return cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
}
