// The windowed BA's accumulation (AccumulatedTopHessian /
// AccumulatedSCHessian over the residual grid) for L windows: the per-pair
// 10x10 blocks transported to the absolute (4 + 6F) system, the per-point
// depth terms and the Schur complement over the points' depths.
//
// Stands for the JAX package's XLA-fused accumulation in `build_system` /
// `marginalize_points` (sdv_loam_tpu/models/backend.py: `_accumulate` and
// `_stitch`); no Pallas kernel exists for it. The plain PyTorch version is
// models/backend._accumulate_plain; these kernels compute the same tuple
// (H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act) from the
// linearization's Jc, Jxi, Jd, resF and the active mask, without the plain
// version's (L, N F, 100) outer products, its one-hot pair matrix or its
// gathered per-residual adjoints.
//
// Bound on the card: bytes. The linearization's terms are read once (97
// bytes a residual) and Vpt written once (4 D bytes a point): 33.5 MB at
// L = 8, N = 4096, F = 8, 10.0 us at 3.35 TB/s; the work is ~450 float32
// operations a residual (the pair blocks, Vpt) and ~4,300 a point (the
// Schur complement's 1,430 entries), 257 M at that shape, 3.8 us at the
// card's 67 TFLOP/s outside the tensor cores. The design, three launches:
//   1. ba_acc_tiles_kernel, a block per (tile of kTile points, lane): per
//      chunk of kChunk points it stages the chunk's terms in shared
//      memory, forms each point's depth terms (Hdd, bd, Hcd, JpJd), HdiF,
//      its Vpt row (the host's and target's adjoints read from the pairs'
//      (L, F F, 6, 6) tensors, cached), and adds the chunk's residuals'
//      10x10 blocks and b into the tile's per-(host, target) sums
//      (registers: each thread owns two (target, entry) sums for each of
//      the F hosts) and the points' Vpt^T diag(wsc) Vpt and b_sc terms into
//      the tile's Schur sums (registers: five entries a thread). It writes
//      the tile's sums to a scratch of (L, tiles, P);
//   2. ba_acc_sum_kernel adds each lane's tiles, tile by tile in order,
//      into (L, P) totals;
//   3. ba_acc_stitch_kernel, a block per lane, transports the totals'
//      pair blocks to the absolute system (stitchDouble) and writes H_top,
//      b_top, H_sc and b_sc.
//
// Precision: float32, as the plain version computes. The linearization's
// terms are float32 (K7's or the plain version's outputs); every product
// and every sum (over a residual's two rows, a point's residuals, a tile's
// points, the tiles, the pairs) and the transport is a float32 operation,
// rounded on its own and written as an intrinsic (__fmul_rn, __fadd_rn: no
// fused multiply-add), so the CPU emulation (tests/k8_acc.py) gives the
// kernels' bits. HdiF is 1 / max(Hdd, 1e-10), as the plain version forms
// it; H_sc and b_sc are formed from Vpt, HdiF and bd as written. (Sums in
// float64, each output rounded once, were tried first: nearer a float64
// reference on every accumulation, and no better end to end; over a set of
// drives on an H100 they failed more of the accuracy gates than these
// float32 sums or the plain version did. PERF.md section 6 has the
// readings.)
//
// Reduction order (fixed: it depends on N and F alone, never on L, on the
// other lanes or on which stream or graph launches it; no floating-point
// atomics):
//   * a lane's points split into tiles of kTile points (the last shorter),
//     a tile into chunks of kChunk points; a tile's sums start at +0 and
//     add its points in point order, chunk after chunk;
//   * a point's sums add its residuals in target order, each residual's
//     two rows in order; a residual's JpJd is row 0's product plus row 1's;
//   * Vpt's frame part: each target's adT JpJd (j = 0..5 in order) plus,
//     at the host's column, the sum over targets in order of adH JpJd (0
//     times that sum elsewhere, as the plain version's one-hot product);
//   * the totals add the tiles in tile order from +0;
//   * the transport adds the pairs' products in target, then host order,
//     as the plain version's sums over its (F, F) pair grid.
// H_top and H_sc are written symmetric (the upper triangle mirrored).
//
// A device counter (g_launches) is incremented by one thread of the last
// launch of each call, so calls captured in a CUDA graph, also inside its
// IF and WHILE nodes, are counted each time they run;
// sdv_ba_accumulate_counts reads or resets it (the caller synchronizes the
// device first).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxF = 8;                  // frame slots
constexpr int kMaxD = 4 + 6 * kMaxF;      // the absolute system's size
constexpr int kChunk = 32;                // points a chunk stages
constexpr int kTile = 128;                // points a tile sums
constexpr int kThreads = 288;             // pass 1: 9 warps
constexpr int kPairTerms = 65;            // a pair's 55 H entries and 10 b
constexpr int kPairSums = 2;              // (target, entry) sums a thread
constexpr int kScSums = 5;                // Schur entries a thread
constexpr int kSumThreads = 256;          // passes 2 and 3

static_assert(kChunk * kMaxF <= kThreads, "a thread per chunk residual");
static_assert(kMaxF * kPairTerms <= kPairSums * kThreads,
              "every (target, entry) pair sum owned");
static_assert(kMaxD * (kMaxD + 1) / 2 + kMaxD <= kScSums * kThreads,
              "every Schur entry owned");

__device__ unsigned long long g_launches;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
// torch.clamp(x, min=lo): NaN propagates
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

// a strided (L, F F, 6, 6) adjoint view
struct Adj {
  const float* p;
  long long lane, pair, row, col;
  __device__ __forceinline__ float at(int l, int pr, int i, int j) const {
    return __ldg(p + lane * l + pair * pr + row * i + col * j);
  }
};

struct AccArgs {
  // the linearization (L, N, F, ...): Jc (.., 2, 4), Jxi (.., 2, 6),
  // Jd (.., 2), resF (.., 2), active (L, N, F)
  const float* Jc;
  const float* Jxi;
  const float* Jd;
  const float* res;
  const bool* active;
  // points (L, N)
  const long long* host;
  const bool* is_sensor;
  const float* prior;
  const bool* sc_mask;
  Adj adH, adT;
  int N, F, D, tiles, P;
  // scratch: (L, tiles, P) tile sums, (L, P) totals
  float* part;
  float* tot;
  // outputs
  float* H_top;
  float* b_top;
  float* H_sc;
  float* b_sc;
  float* Hdd;
  float* bd;
  float* HdiF;
  float* Vpt;
  long long* n_act;
};

// (i, j), i <= j, of entry k of an n x n upper triangle, row by row
__device__ __forceinline__ void triu(int k, int n, int& i, int& j) {
  i = 0;
  while (k >= n - i) {
    k -= n - i;
    ++i;
  }
  j = i + k;
}

// entry (i, j) of a 10x10 pair block in its 55-entry upper triangle
__device__ __forceinline__ int tri10(int i, int j) {
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  return i * 10 - i * (i - 1) / 2 + (j - i);
}

struct TileSmem {
  // the chunk's residuals: [row 0: Jc 0-3, Jxi 4-9 | row 1: 10-19]
  float J[kChunk * kMaxF][20];
  float r[kChunk * kMaxF][2];
  float jd[kChunk * kMaxF][2];
  float jpjd[kChunk * kMaxF][6];
  bool act[kChunk * kMaxF];
  // the chunk's points
  float vpt[kChunk][kMaxD];
  float sums[6][kChunk];   // Hdd (less the prior), bd, Hcd 0-3
  float vhs[kChunk][6];    // sum over targets of adH JpJd
  int host[kChunk];
  int nact[kChunk];
  float wsc[kChunk];
  float bdf[kChunk];
  float prior[kChunk];
  bool sensor[kChunk];
  bool sc[kChunk];
};

__global__ void __launch_bounds__(kThreads, 2)
    ba_acc_tiles_kernel(AccArgs a) {
  __shared__ TileSmem s;
  const int tile = blockIdx.x, lane = blockIdx.y, tid = threadIdx.x;
  const int F = a.F, D = a.D, N = a.N;
  const int n_res = kChunk * F;
  const int n_combo = F * kPairTerms;
  const int tri = D * (D + 1) / 2;
  const int n_sc = tri + D;

  // this thread's sums: (target, entry) of every host, and Schur entries
  float acc[kPairSums][kMaxF];
  float sacc[kScSums];
  int si[kScSums], sj[kScSums];
#pragma unroll
  for (int m = 0; m < kPairSums; ++m)
#pragma unroll
    for (int h = 0; h < kMaxF; ++h) acc[m][h] = 0.0f;
#pragma unroll
  for (int m = 0; m < kScSums; ++m) {
    sacc[m] = 0.0f;
    const int k = tid + kThreads * m;
    if (k < tri) {
      triu(k, D, si[m], sj[m]);
    } else {
      si[m] = k - tri;   // b_sc (unused past n_sc)
      sj[m] = -1;
    }
  }

  const int t0 = tile * kTile;
  for (int c0 = t0; c0 < min(N, t0 + kTile); c0 += kChunk) {
    const int np = min(kChunk, N - c0);
    // A: stage the chunk
    if (tid < n_res) {
      const int p = tid / F, f = tid % F;
      float J[20] = {}, r[2] = {0.0f, 0.0f}, jd[2] = {0.0f, 0.0f};
      bool act = false;
      if (p < np) {
        const long long ri =
            (static_cast<long long>(lane) * N + c0 + p) * F + f;
        const float4* jc4 = reinterpret_cast<const float4*>(a.Jc) + 2 * ri;
        const float4* jx4 = reinterpret_cast<const float4*>(a.Jxi) + 3 * ri;
        const float4 c_0 = jc4[0], c_1 = jc4[1];
        const float4 x_0 = jx4[0], x_1 = jx4[1], x_2 = jx4[2];
        const float Jc8[8] = {c_0.x, c_0.y, c_0.z, c_0.w,
                              c_1.x, c_1.y, c_1.z, c_1.w};
        const float Jx12[12] = {x_0.x, x_0.y, x_0.z, x_0.w, x_1.x, x_1.y,
                                x_1.z, x_1.w, x_2.x, x_2.y, x_2.z, x_2.w};
#pragma unroll
        for (int row = 0; row < 2; ++row) {
#pragma unroll
          for (int i = 0; i < 4; ++i) J[10 * row + i] = Jc8[4 * row + i];
#pragma unroll
          for (int i = 0; i < 6; ++i) J[10 * row + 4 + i] = Jx12[6 * row + i];
        }
        const float2 d2 = reinterpret_cast<const float2*>(a.Jd)[ri];
        const float2 r2 = reinterpret_cast<const float2*>(a.res)[ri];
        jd[0] = d2.x;
        jd[1] = d2.y;
        r[0] = r2.x;
        r[1] = r2.y;
        act = a.active[ri];
      }
#pragma unroll
      for (int k = 0; k < 20; ++k) s.J[tid][k] = J[k];
      s.r[tid][0] = r[0];
      s.r[tid][1] = r[1];
      s.jd[tid][0] = jd[0];
      s.jd[tid][1] = jd[1];
      s.act[tid] = act;
#pragma unroll
      for (int i = 0; i < 6; ++i)
        s.jpjd[tid][i] =
            add_rn(mul_rn(J[4 + i], jd[0]), mul_rn(J[14 + i], jd[1]));
    } else if (tid - n_res < kChunk) {
      const int p = tid - n_res;
      int h = 0;
      float prior = 0.0f;
      bool sensor = true, sc = false;
      if (p < np) {
        const long long pt = static_cast<long long>(lane) * N + c0 + p;
        const long long hh = a.host[pt];
        h = static_cast<int>(hh < 0 ? 0 : (hh >= F ? F - 1 : hh));
        prior = a.prior[pt];
        sensor = a.is_sensor[pt];
        sc = a.sc_mask[pt];
      }
      s.host[p] = h;
      s.prior[p] = prior;
      s.sensor[p] = sensor;
      s.sc[p] = sc;
    }
    __syncthreads();

    // B: per point, its sums over its residuals; adH JpJd over targets
    for (int e = tid; e < 13 * kChunk; e += kThreads) {
      if (e < 6 * kChunk) {
        const int q = e / kChunk, p = e % kChunk;
        float sm = 0.0f;
        for (int f = 0; f < F; ++f) {
          const int rr = p * F + f;
#pragma unroll
          for (int row = 0; row < 2; ++row) {
            const float d = s.jd[rr][row];
            const float x = q == 1 ? s.r[rr][row]
                            : q == 0 ? d : s.J[rr][10 * row + q - 2];
            sm = add_rn(sm, mul_rn(x, d));
          }
        }
        s.sums[q][p] = sm;
      } else if (e < 7 * kChunk) {
        const int p = e - 6 * kChunk;
        int cnt = 0;
        for (int f = 0; f < F; ++f) cnt += s.act[p * F + f];
        s.nact[p] = cnt;
      } else {
        const int p = (e - 7 * kChunk) / 6, i = (e - 7 * kChunk) % 6;
        const int h = s.host[p];
        float sm = 0.0f;
        for (int f = 0; f < F; ++f) {
          const int pr = h * F + f;
          float vh = 0.0f;
#pragma unroll
          for (int j = 0; j < 6; ++j)
            vh = add_rn(vh, mul_rn(a.adH.at(lane, pr, i, j),
                                   s.jpjd[p * F + f][j]));
          sm = add_rn(sm, vh);
        }
        s.vhs[p][i] = sm;
      }
    }
    __syncthreads();

    // C: per point Hdd, bd, Hcd, HdiF, wsc; Vpt's frame part
    for (int e = tid; e < kChunk + kChunk * F * 6; e += kThreads) {
      if (e < kChunk) {
        const int p = e;
        const float hdd = add_rn(s.sums[0][p], s.prior[p]);
        const float bdv = s.sums[1][p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s.vpt[p][i] = s.sums[2 + i][p];
        const int cnt = s.nact[p];
        const float hdif =
            cnt > 0 ? __fdiv_rn(1.0f, clamp_min(hdd, 1e-10f)) : 0.0f;
        s.wsc[p] = (s.sc[p] && !s.sensor[p] && cnt > 0) ? hdif : 0.0f;
        s.bdf[p] = bdv;
        if (p < np) {
          const long long pt = static_cast<long long>(lane) * N + c0 + p;
          a.Hdd[pt] = hdd;
          a.bd[pt] = bdv;
          a.HdiF[pt] = hdif;
          a.n_act[pt] = cnt;
        }
      } else {
        const int q = e - kChunk;
        const int p = q / (F * 6), f = (q / 6) % F, i = q % 6;
        const int h = s.host[p];
        float vt = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j)
          vt = add_rn(vt, mul_rn(a.adT.at(lane, h * F + f, i, j),
                                 s.jpjd[p * F + f][j]));
        const float vh = s.vhs[p][i];
        s.vpt[p][4 + 6 * f + i] = add_rn(vt, f == h ? vh : mul_rn(0.0f, vh));
      }
    }
    __syncthreads();

    // D: Vpt out; the chunk into the tile's pair and Schur sums
    for (int e = tid; e < np * D; e += kThreads) {
      const int p = e / D, k = e % D;
      a.Vpt[(static_cast<long long>(lane) * N + c0 + p) * D + k] = s.vpt[p][k];
    }
#pragma unroll
    for (int m = 0; m < kPairSums; ++m) {
      const int c = tid + kThreads * m;
      if (c >= n_combo) continue;
      const int f = c / kPairTerms, e = c % kPairTerms;
      int i = e - 55, j = -1;
      if (e < 55) triu(e, 10, i, j);
      for (int p = 0; p < np; ++p) {
        const int rr = p * F + f;
        const float term =
            j >= 0 ? add_rn(mul_rn(s.J[rr][i], s.J[rr][j]),
                            mul_rn(s.J[rr][10 + i], s.J[rr][10 + j]))
                   : add_rn(mul_rn(s.J[rr][i], s.r[rr][0]),
                            mul_rn(s.J[rr][10 + i], s.r[rr][1]));
        const int h = s.host[p];
#pragma unroll
        for (int hh = 0; hh < kMaxF; ++hh)
          if (hh == h) acc[m][hh] = add_rn(acc[m][hh], term);
      }
    }
#pragma unroll
    for (int m = 0; m < kScSums; ++m) {
      const int k = tid + kThreads * m;
      if (k >= n_sc) continue;
      const int i = si[m], j = sj[m];
      for (int p = 0; p < np; ++p) {
        const float w = s.wsc[p];
        const float vi = s.vpt[p][i];
        sacc[m] = add_rn(sacc[m],
                         j >= 0 ? mul_rn(mul_rn(vi, w), s.vpt[p][j])
                                : mul_rn(vi, mul_rn(w, s.bdf[p])));
      }
    }
    __syncthreads();   // the next chunk overwrites the staged terms
  }

  // the tile's sums out: pair (host * F + target) blocks, then Schur
  float* out = a.part + (static_cast<long long>(lane) * a.tiles + tile) * a.P;
#pragma unroll
  for (int m = 0; m < kPairSums; ++m) {
    const int c = tid + kThreads * m;
    if (c >= n_combo) continue;
    const int f = c / kPairTerms, e = c % kPairTerms;
#pragma unroll
    for (int h = 0; h < kMaxF; ++h)
      if (h < F) out[(h * F + f) * kPairTerms + e] = acc[m][h];
  }
#pragma unroll
  for (int m = 0; m < kScSums; ++m) {
    const int k = tid + kThreads * m;
    if (k < n_sc) out[F * F * kPairTerms + k] = sacc[m];
  }
}

// the lanes' totals: each entry's tile sums added in tile order
__global__ void __launch_bounds__(kSumThreads)
    ba_acc_sum_kernel(AccArgs a) {
  const int lane = blockIdx.y;
  const int k = blockIdx.x * kSumThreads + threadIdx.x;
  if (k >= a.P) return;
  const float* in = a.part + static_cast<long long>(lane) * a.tiles * a.P + k;
  float sm = 0.0f;
  for (int t = 0; t < a.tiles; ++t)
    sm = add_rn(sm, in[static_cast<long long>(t) * a.P]);
  a.tot[static_cast<long long>(lane) * a.P + k] = sm;
}

// stitchDouble: a lane's pair blocks transported to the absolute system
__global__ void __launch_bounds__(kSumThreads)
    ba_acc_stitch_kernel(AccArgs a) {
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int F = a.F, D = a.D, FF = F * F;
  if (lane == 0 && tid == 0) atomicAdd(&g_launches, 1ull);
  const float* tot = a.tot + static_cast<long long>(lane) * a.P;
  // adH Hxx and adT Hxx of every pair
  __shared__ float AH[kMaxF * kMaxF][6][6];
  __shared__ float AT[kMaxF * kMaxF][6][6];
  for (int e = tid; e < 2 * FF * 36; e += kSumThreads) {
    const bool t_side = e >= FF * 36;
    const int q = t_side ? e - FF * 36 : e;
    const int p = q / 36, i = (q / 6) % 6, m = q % 6;
    const Adj& ad = t_side ? a.adT : a.adH;
    float sm = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      sm = add_rn(sm, mul_rn(ad.at(lane, p, i, k),
                             tot[p * kPairTerms + tri10(4 + k, 4 + m)]));
    (t_side ? AT : AH)[p][i][m] = sm;
  }
  __syncthreads();

  const int tri = D * (D + 1) / 2;
  float* H = a.H_top + static_cast<long long>(lane) * D * D;
  float* Hs = a.H_sc + static_cast<long long>(lane) * D * D;
  const float* sc = tot + FF * kPairTerms;
  for (int e = tid; e < tri + D; e += kSumThreads) {
    if (e >= tri) {
      // b_top, b_sc
      const int r = e - tri;
      float v = 0.0f;
      if (r < 4) {
        for (int p = 0; p < FF; ++p)
          v = add_rn(v, tot[p * kPairTerms + 55 + r]);
      } else {
        const int f = (r - 4) / 6, i = (r - 4) % 6;
        float s1 = 0.0f, s2 = 0.0f;
        for (int t = 0; t < F; ++t) {
          const int p = f * F + t;
          float x = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k)
            x = add_rn(x, mul_rn(a.adH.at(lane, p, i, k),
                                 tot[p * kPairTerms + 59 + k]));
          s1 = add_rn(s1, x);
        }
        for (int h = 0; h < F; ++h) {
          const int p = h * F + f;
          float x = 0.0f;
#pragma unroll
          for (int k = 0; k < 6; ++k)
            x = add_rn(x, mul_rn(a.adT.at(lane, p, i, k),
                                 tot[p * kPairTerms + 59 + k]));
          s2 = add_rn(s2, x);
        }
        v = add_rn(s1, s2);
      }
      a.b_top[static_cast<long long>(lane) * D + r] = v;
      a.b_sc[static_cast<long long>(lane) * D + r] = sc[tri + r];
      continue;
    }
    int r, c;
    triu(e, D, r, c);
    float v = 0.0f;
    if (c < 4) {
      for (int p = 0; p < FF; ++p)
        v = add_rn(v, tot[p * kPairTerms + tri10(r, c)]);
    } else if (r < 4) {
      // the calibration-frame block: Mfc[f][i][r]
      const int f = (c - 4) / 6, i = (c - 4) % 6;
      float s1 = 0.0f, s2 = 0.0f;
      for (int t = 0; t < F; ++t) {
        const int p = f * F + t;
        float x = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k)
          x = add_rn(x, mul_rn(a.adH.at(lane, p, i, k),
                               tot[p * kPairTerms + tri10(r, 4 + k)]));
        s1 = add_rn(s1, x);
      }
      for (int h = 0; h < F; ++h) {
        const int p = h * F + f;
        float x = 0.0f;
#pragma unroll
        for (int k = 0; k < 6; ++k)
          x = add_rn(x, mul_rn(a.adT.at(lane, p, i, k),
                               tot[p * kPairTerms + tri10(r, 4 + k)]));
        s2 = add_rn(s2, x);
      }
      v = add_rn(s1, s2);
    } else {
      const int f = (r - 4) / 6, i = (r - 4) % 6;
      const int g = (c - 4) / 6, j = (c - 4) % 6;
      // ht[pq][x][y] = (adH Hxx adT^T)[x][y] of pair pq
      auto ht = [&](int pq, int x, int y) {
        float sm = 0.0f;
#pragma unroll
        for (int m = 0; m < 6; ++m)
          sm = add_rn(sm, mul_rn(AH[pq][x][m], a.adT.at(lane, pq, y, m)));
        return sm;
      };
      if (f == g) {
        float s1 = 0.0f, s2 = 0.0f;
        for (int t = 0; t < F; ++t) {
          const int p = f * F + t;
          float x = 0.0f;
#pragma unroll
          for (int m = 0; m < 6; ++m)
            x = add_rn(x, mul_rn(AH[p][i][m], a.adH.at(lane, p, j, m)));
          s1 = add_rn(s1, x);
        }
        for (int h = 0; h < F; ++h) {
          const int p = h * F + f;
          float x = 0.0f;
#pragma unroll
          for (int m = 0; m < 6; ++m)
            x = add_rn(x, mul_rn(AT[p][i][m], a.adT.at(lane, p, j, m)));
          s2 = add_rn(s2, x);
        }
        v = add_rn(add_rn(add_rn(s1, s2), ht(f * F + f, i, j)),
                   ht(f * F + f, j, i));
      } else {
        v = add_rn(add_rn(0.0f, ht(f * F + g, i, j)), ht(g * F + f, j, i));
      }
    }
    H[r * D + c] = v;
    H[c * D + r] = v;
    const float sv = sc[e];
    Hs[r * D + c] = sv;
    Hs[c * D + r] = sv;
  }
}

}  // namespace

// Launch the three kernels for L windows of N points and F frame slots on
// `stream`; returns the first failed launch's cudaError_t. p: Jc, Jxi,
// Jd, resF, active, host, is_sensor, prior, sc_mask, adH, adT,
// part (scratch, L * tiles * P floats), tot (scratch, L * P floats),
// H_top, b_top, H_sc, b_sc, Hdd, bd, HdiF, Vpt, n_act; strides: adH's and
// adT's (lane, pair, row, col) in elements. `tiles` must be
// sdv_ba_accumulate_tiles(n) and P sdv_ba_accumulate_part(f).
extern "C" int sdv_ba_accumulate(void* const* p, const long long* strides,
                                 int lanes, int n, int f, void* stream) {
  if (f < 1 || f > kMaxF || n < 0) return cudaErrorInvalidValue;
  AccArgs a;
  a.Jc = static_cast<const float*>(p[0]);
  a.Jxi = static_cast<const float*>(p[1]);
  a.Jd = static_cast<const float*>(p[2]);
  a.res = static_cast<const float*>(p[3]);
  a.active = static_cast<const bool*>(p[4]);
  a.host = static_cast<const long long*>(p[5]);
  a.is_sensor = static_cast<const bool*>(p[6]);
  a.prior = static_cast<const float*>(p[7]);
  a.sc_mask = static_cast<const bool*>(p[8]);
  Adj* views[2] = {&a.adH, &a.adT};
  for (int i = 0; i < 2; ++i) {
    views[i]->p = static_cast<const float*>(p[9 + i]);
    views[i]->lane = strides[4 * i];
    views[i]->pair = strides[4 * i + 1];
    views[i]->row = strides[4 * i + 2];
    views[i]->col = strides[4 * i + 3];
  }
  a.part = static_cast<float*>(p[11]);
  a.tot = static_cast<float*>(p[12]);
  a.H_top = static_cast<float*>(p[13]);
  a.b_top = static_cast<float*>(p[14]);
  a.H_sc = static_cast<float*>(p[15]);
  a.b_sc = static_cast<float*>(p[16]);
  a.Hdd = static_cast<float*>(p[17]);
  a.bd = static_cast<float*>(p[18]);
  a.HdiF = static_cast<float*>(p[19]);
  a.Vpt = static_cast<float*>(p[20]);
  a.n_act = static_cast<long long*>(p[21]);
  a.N = n;
  a.F = f;
  a.D = 4 + 6 * f;
  a.tiles = (n + kTile - 1) / kTile;
  a.P = f * f * kPairTerms + a.D * (a.D + 1) / 2 + a.D;
  if (lanes <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.tiles > 0) {
    ba_acc_tiles_kernel<<<dim3(a.tiles, lanes), kThreads, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ba_acc_sum_kernel<<<dim3((a.P + kSumThreads - 1) / kSumThreads, lanes),
                      kSumThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ba_acc_stitch_kernel<<<lanes, kSumThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// The tiles a lane of n points splits into, and the sums a tile keeps for
// f frame slots (the scratch the wrapper allocates).
extern "C" int sdv_ba_accumulate_tiles(int n) {
  return (n + kTile - 1) / kTile;
}
extern "C" int sdv_ba_accumulate_part(int f) {
  const int d = 4 + 6 * f;
  return f * f * kPairTerms + d * (d + 1) / 2 + d;
}

// The calls counted on the current device since the last reset, into *out;
// with `reset`, the counter is zeroed after the read.
extern "C" int sdv_ba_accumulate_counts(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_launches, sizeof(*out));
  if (err != cudaSuccess || !reset) return err;
  const unsigned long long zero = 0;
  return cudaMemcpyToSymbol(g_launches, &zero, sizeof(zero));
}
