// The rescue's float64 Adam step and float64 analysis for Hopper (sm_90a):
// two fused sweeps per lane over read-only lanes-first inputs.
//
// beam_dd_kernel<false> replaces openpystruct_tpu/ops/beam_kernel_dd.py:376
// _beam_dd_opt_kernel (launcher pallas_beam_opt_step_dd): stiffness ->
// masked bending-only 2x2 assembly with the axial chain -> Jacobi scaling ->
// block-Thomas factorization fused with the forward sweep and the 3-DOF
// pivot min_i a_i |det2(S_i)| -> back sweep -> forces, the loss and its
// semi-gradient, all in float64; Adam in float32 on the gradient cast to
// float32.  Inputs and outputs are float32.
//
// beam_dd_kernel<true> replaces openpystruct_tpu/ops/beam_kernel_dd.py:337
// _beam_dd_kernel (launcher pallas_beam_analysis_dd), the rescue's and the
// accuracy autopilot's float64 analysis: the same forward sweep, so the
// same pivot, and a back sweep that writes u (u_x the exact zero x_0 * 0)
// and V, M from the float64 unscaled u, each cast to float32, with no loss
// or Adam.  As in the JAX kernel there is no refinement (float64's forward
// error is already below float32's resolution) and no saved C.
//
// Bound on an H100 SXM: the opt step must read I, mu, nu, Le (n - 1 each),
// the free mask (3n), the loads (n) and udl, and write I, mu, nu, stats (4)
// and the pivot: 1,110 floats per lane at n = 101; the analysis reads I,
// Le, the mask, the loads and udl and writes u (3n), V, M and the pivot:
// 1,109.  Both ~21.7 us at B = 16384 on 3.35 TB/s.  Their few hundred
// float64 flops per node are below that at 34 TFLOP/s.  What keeps a
// one-thread-per-lane kernel from it is latency: the recurrence is serial
// along the lane, and at the rescue's buckets (256-8192 lanes) the card
// holds at most a few warps per SM, so each node step waits on whatever its
// slowest operand waits on.  The design keeps that to the float64
// arithmetic itself:
//  - two sweeps instead of seven passes.  The forward sweep computes each
//    node's element stiffness, masked blocks, right-hand side, axial terms
//    and scales on the fly from the inputs (element i - 1's values ride in
//    registers), factors, substitutes forward and tracks the pivot.  The
//    backward sweep substitutes back and, as soon as x_i and x_{i+1} are
//    known, recovers element i's V and M, then its loss terms, gradient and
//    Adam step, or (the analysis) writes them with node i's u.  It
//    recomputes element i's stiffness and scaled U_i from the inputs and
//    the saved scales rather than reading them back.
//  - scratch written once, read once: the Schur inverses, y and the scales,
//    7 doubles per node, lanes innermost, through their own pointer; the
//    backward sweep loads node i - 1's while it works on node i.
//  - lanes-first I/O staged through shared memory: the block copies a
//    (lanes x kChunk nodes) tile of each input with cp.async while it works
//    on the previous tile, and writes I, mu, nu (or u, V, M) through a tile
//    too, so every global access is coalesced and the wrapper copies
//    nothing.  Only a lane whose u_x zero is -0 or NaN, known once x_0 is,
//    has its u_x column written a second time.
//
// Against the seven-pass kernels they replace: every expression keeps its
// tree, including the back sweep's Sinv_i (U_i x_{i+1}), and each value
// those kernels stored to their workspace before a later stage added to it
// (stiffness, scaled diagonal and right-hand side) is rounded with
// __dmul_rn, which the compiler never contracts into an FMA.  That keeps
// the forward sweep, and so the pivot, bitwise equal; the opt step's I
// comes within a float32 ulp, mu and nu within ~1e-8 of their scale,
// because nvcc contracts by basic block and the backward block now holds
// the back substitution, forces, loss and Adam together.  The loss sums run
// in reverse order.
//
// Floating point: no --use_fast_math; IEEE division and square root.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

// lanes (threads) per block: 32 ran 3% faster than 64 at n = 101 and level
// at n = 201, 128 slowest (PERF.md, #8's B-sweep); the tiles take 19 KB
constexpr int kLanes = 32;
constexpr int kChunk = 8;               // nodes per staged tile
constexpr int kPitch = kChunk + 1;      // odd pitches: no bank conflicts
constexpr int kPitch3 = 3 * kChunk + 1;
// forward stage: I, Le, loads tiles and the free tile; backward stage: I,
// Le, mu, nu tiles and the free tile (the analysis's: no mu, nu); plus the
// three output tiles (the analysis's: V, M and u of kChunk + 1 nodes)
constexpr int kFwdStage = 3 * kPitch + kPitch3;
constexpr int kBwdStage = 4 * kPitch + kPitch3;
constexpr int kBwdStageA = 2 * kPitch + kPitch3;
constexpr int kPitchU = 3 * (kChunk + 1);
constexpr int kSmemFloats =
    (2 * kFwdStage > 2 * kBwdStage + 3 * kPitch) ? 2 * kFwdStage
                                                 : 2 * kBwdStage + 3 * kPitch;
static_assert(2 * kBwdStageA + 2 * kPitch + kPitchU <= kSmemFloats,
              "the analysis's tiles");

// scratch components per node
enum : int { SI0 = 0, SI1, SI2, Y0, Y1, S0, S1, NSCR };

__device__ __forceinline__ double rsq(double x) { return 1.0 / sqrt(x); }

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf do not.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a) ? a : ((b != b || b < a) ? b : a);
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b || b > a) ? b : a);
}

struct Stiff {
  double ea, k11, k12, k13, k2;  // EA/Le, 12EI/Le^3, 6EI/Le^2, 4EI/Le, 2EI/Le
};

__device__ __forceinline__ Stiff stiffness(float I, float Le, double E,
                                           double EA) {
  const double inv_le = 1.0 / double(Le);
  const double eil = __dmul_rn(__dmul_rn(E, double(I)), inv_le);
  const double eil2 = __dmul_rn(eil, inv_le);
  const double eil3 = __dmul_rn(eil2, inv_le);
  return {__dmul_rn(EA, inv_le), __dmul_rn(12.0, eil3), __dmul_rn(6.0, eil2),
          __dmul_rn(4.0, eil), __dmul_rn(2.0, eil)};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy columns [c0, c0 + W) of rows b0 .. b0 + kLanes - 1 of a
// lanes-first (B, len) float array into tile[kLanes][pitch], skipping what
// lies outside it.  Consecutive threads take consecutive columns of a row:
// coalesced.
template <int W>
__device__ __forceinline__ void stage(float* tile, int pitch,
                                      const float* __restrict__ src, int len,
                                      int c0, int b0, int B) {
  constexpr int T = kLanes;
  for (int k = threadIdx.x; k < T * W; k += T) {
    const int r = k / W, c = k - r * W;
    if (b0 + r < B && c0 + c < len)
      cp_async4(tile + r * pitch + c, src + (size_t)(b0 + r) * len + c0 + c);
  }
}

// ANALYSIS: the float64 analysis, whose outputs I_out, mu_out, nu_out are
// u (B, n, 3), V, M (B, n - 1); mu, nu, stats and the Adam scalars go
// unread.
template <bool ANALYSIS>
__global__ void __launch_bounds__(kLanes)
beam_dd_kernel(const float* __restrict__ I_g, const float* __restrict__ mu_g,
               const float* __restrict__ nu_g, const float* __restrict__ Le_g,
               const float* __restrict__ fr_g,
               const float* __restrict__ loads_g,
               const float* __restrict__ udl, float* __restrict__ I_out,
               float* __restrict__ mu_out, float* __restrict__ nu_out,
               float* __restrict__ stats, float* __restrict__ piv,
               double* __restrict__ scr, int B, int n, double E, double EA,
               double Gs, double alpha_m, double alpha_s, float clamp_min,
               float lr_t, float bc1, float bc2) {
  constexpr int T = kLanes;
  __shared__ float smem[kSmemFloats * T];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * T;
  const int b = b0 + t;
  const bool live = b < B;
  const int nelem = n - 1;
  const size_t Bs = (size_t)B;
  auto at = [&](int i, int c) -> size_t {
    return ((size_t)i * NSCR + c) * Bs + b;
  };
  const double w = live ? double(udl[b]) : 0.0;

  // ---- forward sweep: assembly, scaling, factorization, y, pivot ----
  float* fbuf[2] = {smem, smem + kFwdStage * T};
  auto stage_fwd = [&](int c, float* s) {
    const int c0 = c * kChunk;
    stage<kChunk>(s, kPitch, I_g, nelem, c0, b0, B);
    stage<kChunk>(s + kPitch * T, kPitch, Le_g, nelem, c0, b0, B);
    stage<kChunk>(s + 2 * kPitch * T, kPitch, loads_g, n, c0, b0, B);
    // the free mask of nodes c0 + 1 .. c0 + kChunk (node i reads i + 1's)
    stage<3 * kChunk>(s + 3 * kPitch * T, kPitch3, fr_g, 3 * n,
                         3 * (c0 + 1), b0, B);
    cp_async_commit();
  };

  // element i - 1 and node i - 1, carried
  double ea_p = 0.0, k11_p = 0.0, k12_p = 0.0, k13_p = 0.0, le_p = 0.0;
  double f0 = 0.0, f1 = 0.0, f2 = 0.0;          // free mask of node i
  double pu00 = 0.0, pu01 = 0.0, pu10 = 0.0, pu11 = 0.0;  // raw U_{i-1}
  double ps0 = 0.0, ps1 = 0.0;                  // scales of node i - 1
  double pax1 = 0.0, pr = 0.0;                  // axial u00, rsq(d00)
  double s00 = 0.0, s01 = 0.0, s11 = 0.0, y0 = 0.0, y1 = 0.0;
  double a_prev = 0.0, min_piv = 0.0;
  if (live) {
    const float* f = fr_g + (size_t)b * 3 * n;
    f0 = f[0];
    f1 = f[1];
    f2 = f[2];
  }

  const int nchunk = (n + kChunk - 1) / kChunk;
  stage_fwd(0, fbuf[0]);
  for (int c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) {
      stage_fwd(c + 1, fbuf[(c + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tI = fbuf[c & 1] + t * kPitch;
    const float* tLe = tI + kPitch * T;
    const float* tL = tI + 2 * kPitch * T;
    const float* tF = fbuf[c & 1] + 3 * kPitch * T + t * kPitch3;
    const int cnt = min(kChunk, n - c * kChunk);
    for (int k = 0; live && k < cnt; ++k) {
      const int i = c * kChunk + k;
      double ea_n = 0.0, k11_n = 0.0, k12_n = 0.0, k13_n = 0.0, k2_n = 0.0,
             le_n = 0.0;
      if (i < nelem) {
        const Stiff s = stiffness(tI[k], tLe[k], E, EA);
        ea_n = s.ea;
        k11_n = s.k11;
        k12_n = s.k12;
        k13_n = s.k13;
        k2_n = s.k2;
        le_n = double(tLe[k]);
      }
      double fn0 = f0, fn1 = f1, fn2 = f2;
      if (i + 1 < n) {
        fn0 = tF[3 * k];
        fn1 = tF[3 * k + 1];
        fn2 = tF[3 * k + 2];
      }
      // masked assembly of node i
      const double d11 = k11_p + k11_n;
      const double d12 = -k12_p + k12_n;
      const double d22 = k13_p + k13_n;
      const double D0 = d11 * (f1 * f1 + (1.0 - f1));
      const double D1 = d12 * (f1 * f2);
      const double D2 = d22 * (f2 * f2 + (1.0 - f2));
      const double u00 = -(k11_n * (f1 * fn1));
      const double u01 = k12_n * (f1 * fn2);
      const double u10 = -(k12_n * (f2 * fn1));
      const double u11 = k2_n * (f2 * fn2);
      // consistent UDL loads + nodal point loads (no axial load exists)
      const double fy = (le_p + le_n) * w * 0.5 + double(tL[k]);
      const double fm = (le_n * le_n - le_p * le_p) * w / 12.0;
      const double F0 = fy * f1, F1 = fm * f2;
      const double ax0 = (ea_p + ea_n) * (f0 * f0 + (1.0 - f0));
      const double ax1 = -ea_n * (f0 * fn0);
      // Jacobi scaling
      const double sc0 = rsq(D0), sc1 = rsq(D2);
      const double m0 = __dmul_rn(D0 * sc0, sc0);
      const double m1 = __dmul_rn(D1 * sc0, sc1);
      const double m2 = __dmul_rn(D2 * sc1, sc1);
      const double r0 = __dmul_rn(F0, sc0), r1 = __dmul_rn(F1, sc1);
      const double r_cur = rsq(ax0);
      if (i == 0) {
        double det = m0 * m2 - m1 * m1;
        const double inv = 1.0 / det;
        s00 = m2 * inv;
        s01 = -(m1 * inv);
        s11 = m0 * inv;
        y0 = s00 * r0 + s01 * r1;
        y1 = s01 * r0 + s11 * r1;
        det = fabs(det);
        a_prev = ax0 * (r_cur * r_cur);
        min_piv = a_prev * det;
      } else {
        // U_{i-1} scaled by the scales of nodes i - 1 and i
        const double q00 = pu00 * ps0 * sc0, q01 = pu01 * ps0 * sc1;
        const double q10 = pu10 * ps1 * sc0, q11 = pu11 * ps1 * sc1;
        const double w00 = s00 * q00 + s01 * q10;
        const double w01 = s00 * q01 + s01 * q11;
        const double w10 = s01 * q00 + s11 * q10;
        const double w11 = s01 * q01 + s11 * q11;
        // S_i = D_i - U^T W (symmetric)
        const double mm0 = m0 - (q00 * w00 + q10 * w10);
        const double mm1 = m1 - (q00 * w01 + q10 * w11);
        const double mm2 = m2 - (q01 * w01 + q11 * w11);
        double det = mm0 * mm2 - mm1 * mm1;
        const double inv = 1.0 / det;
        s00 = mm2 * inv;
        s01 = -(mm1 * inv);
        s11 = mm0 * inv;
        // fused forward substitution y_i = Sinv_i (f_i - U^T y_{i-1})
        const double qq0 = r0 - (q00 * y0 + q10 * y1);
        const double qq1 = r1 - (q01 * y0 + q11 * y1);
        y0 = s00 * qq0 + s01 * qq1;
        y1 = s01 * qq0 + s11 * qq1;
        det = fabs(det);
        // axial Schur chain a_i = d00s_i - u00s_{i-1}^2 / a_{i-1}
        const double u00s = pax1 * pr * r_cur;
        const double d00s = ax0 * r_cur * r_cur;
        a_prev = d00s - u00s * u00s / a_prev;
        min_piv = nan_min(min_piv, a_prev * det);
      }
      scr[at(i, SI0)] = s00;
      scr[at(i, SI1)] = s01;
      scr[at(i, SI2)] = s11;
      scr[at(i, Y0)] = y0;
      scr[at(i, Y1)] = y1;
      scr[at(i, S0)] = sc0;
      scr[at(i, S1)] = sc1;
      ea_p = ea_n;
      k11_p = k11_n;
      k12_p = k12_n;
      k13_p = k13_n;
      le_p = le_n;
      f0 = fn0;
      f1 = fn1;
      f2 = fn2;
      pu00 = u00;
      pu01 = u01;
      pu10 = u10;
      pu11 = u11;
      ps0 = sc0;
      ps1 = sc1;
      pax1 = ax1;
      pr = r_cur;
    }
    __syncthreads();
  }
  if (live) piv[b] = float(min_piv);

  // ---- backward sweep: x, forces, then loss, semi-gradient, Adam or (the
  // analysis) u, V, M ----
  constexpr int kStage = ANALYSIS ? kBwdStageA : kBwdStage;
  constexpr int kFrOff = ANALYSIS ? 2 * kPitch : 4 * kPitch;
  float* bbuf[2] = {smem, smem + kStage * T};
  float* oI = smem + 2 * kStage * T;
  float* oMu = oI + kPitch * T;
  float* oNu = oMu + kPitch * T;     // the analysis's u tile, pitch kPitchU
  auto stage_bwd = [&](int c, float* s) {
    const int c0 = c * kChunk;
    stage<kChunk>(s, kPitch, I_g, nelem, c0, b0, B);
    stage<kChunk>(s + kPitch * T, kPitch, Le_g, nelem, c0, b0, B);
    if (!ANALYSIS) {
      stage<kChunk>(s + 2 * kPitch * T, kPitch, mu_g, nelem, c0, b0, B);
      stage<kChunk>(s + 3 * kPitch * T, kPitch, nu_g, nelem, c0, b0, B);
    }
    stage<3 * kChunk>(s + kFrOff * T, kPitch3, fr_g, 3 * n, 3 * c0, b0, B);
    cp_async_commit();
  };

  // node j + 1, carried: x, its unscaled displacements, scales, mask
  double x0 = 0.0, x1 = 0.0, uy_j = 0.0, th_j = 0.0, sn0 = 0.0, sn1 = 0.0;
  double fn1 = 0.0, fn2 = 0.0;
  // node j's scratch, loaded one element ahead
  double c_si0 = 0.0, c_si1 = 0.0, c_si2 = 0.0, c_y0 = 0.0, c_y1 = 0.0,
         c_s0 = 0.0, c_s1 = 0.0;
  if (live) {
    x0 = scr[at(n - 1, Y0)];
    x1 = scr[at(n - 1, Y1)];
    sn0 = scr[at(n - 1, S0)];
    sn1 = scr[at(n - 1, S1)];
    uy_j = x0 * sn0;
    th_j = x1 * sn1;
    const float* f = fr_g + ((size_t)b * n + (n - 1)) * 3;
    fn1 = f[1];
    fn2 = f[2];
    c_si0 = scr[at(n - 2, SI0)];
    c_si1 = scr[at(n - 2, SI1)];
    c_si2 = scr[at(n - 2, SI2)];
    c_y0 = scr[at(n - 2, Y0)];
    c_y1 = scr[at(n - 2, Y1)];
    c_s0 = scr[at(n - 2, S0)];
    c_s1 = scr[at(n - 2, S1)];
  }
  double tb = 0.0, ts = 0.0, ti = 0.0;
  const float b1 = 0.9f, b2 = 0.999f, eps = 1e-8f;
  const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);

  const int nce = (nelem + kChunk - 1) / kChunk;
  stage_bwd(nce - 1, bbuf[(nce - 1) & 1]);
  for (int c = nce - 1; c >= 0; --c) {
    if (c > 0) {
      stage_bwd(c - 1, bbuf[(c - 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* tI = bbuf[c & 1] + t * kPitch;
    const float* tLe = tI + kPitch * T;
    const float* tMu = tI + 2 * kPitch * T;
    const float* tNu = tI + 3 * kPitch * T;
    const float* tF = bbuf[c & 1] + kFrOff * T + t * kPitch3;
    const int c0 = c * kChunk;
    const int cnt = min(kChunk, nelem - c0);
    for (int k = cnt - 1; live && k >= 0; --k) {
      const int j = c0 + k;
      const double si0 = c_si0, si1 = c_si1, si2 = c_si2, yy0 = c_y0,
                   yy1 = c_y1, s0 = c_s0, s1 = c_s1;
      if (j > 0) {
        c_si0 = scr[at(j - 1, SI0)];
        c_si1 = scr[at(j - 1, SI1)];
        c_si2 = scr[at(j - 1, SI2)];
        c_y0 = scr[at(j - 1, Y0)];
        c_y1 = scr[at(j - 1, Y1)];
        c_s0 = scr[at(j - 1, S0)];
        c_s1 = scr[at(j - 1, S1)];
      }
      const float Ij32 = tI[k];
      const Stiff st = stiffness(Ij32, tLe[k], E, EA);
      const double k11 = st.k11, k12 = st.k12, k13 = st.k13, k2 = st.k2;
      const double g1 = tF[3 * k + 1], g2 = tF[3 * k + 2];
      // U_j as the forward sweep scaled it
      const double u00 = -(k11 * (g1 * fn1)) * s0 * sn0;
      const double u01 = k12 * (g1 * fn2) * s0 * sn1;
      const double u10 = -(k12 * (g2 * fn1)) * s1 * sn0;
      const double u11 = k2 * (g2 * fn2) * s1 * sn1;
      // x_j = y_j - Sinv_j (U_j x_{j+1}); the analysis takes the seven-pass
      // kernel's FMAs, which read U_j back (nvcc folds the negation of
      // u00 and u10 here and fuses the other product)
      const double t0 = ANALYSIS ? __fma_rn(u00, x0, __dmul_rn(u01, x1))
                                 : u00 * x0 + u01 * x1;
      const double t1 = ANALYSIS ? __fma_rn(u10, x0, __dmul_rn(u11, x1))
                                 : u10 * x0 + u11 * x1;
      const double v0 = si0 * t0 + si1 * t1;
      const double v1 = si1 * t0 + si2 * t1;
      x0 = yy0 - v0;
      x1 = yy1 - v1;
      // element j's end forces, loss terms and semi-gradient
      const double uy_i = x0 * s0, th_i = x1 * s1;
      const double le = tLe[k], Ij = Ij32;
      const double V =
          k11 * uy_i + k12 * th_i - k11 * uy_j + k12 * th_j - w * le * 0.5;
      const double M = k12 * uy_i + k13 * th_i - k12 * uy_j + k2 * th_j -
                       w * le * le / 12.0;
      if constexpr (ANALYSIS) {
        oI[t * kPitch + k] = float(V);
        oMu[t * kPitch + k] = float(M);
        float* u = oNu + t * kPitchU + 3 * k;
        u[0] = 0.0f;
        u[1] = float(uy_i);
        u[2] = float(th_i);
        if (j + 1 == nelem) {   // the last element writes the last node too
          u[3] = 0.0f;
          u[4] = float(uy_j);
          u[5] = float(th_j);
        }
      } else {
        const double den_b = 2.0 * E * Ij + 1e-6;
        const double den_s = Gs * (0.03 * sqrt(Ij));
        const double be = M * M / den_b;
        const double se = V * V / den_s;
        const double g =
            1.0 - alpha_m * be * 2.0 * E / den_b - alpha_s * 0.5 * se / Ij;
        // Adam in float32 on the gradient cast to float32; the clamp
        // applies to I only
        const float g32 = float(g);
        const float m = b1 * tMu[k] + omb1 * g32;
        const float v = b2 * tNu[k] + omb2 * g32 * g32;
        const float step = lr_t * (m * bc1) / (sqrtf(v * bc2) + eps);
        oI[t * kPitch + k] = nan_max(Ij32 - step, clamp_min);
        oMu[t * kPitch + k] = m;
        oNu[t * kPitch + k] = v;
        tb = tb + be;
        ts = ts + se;
        ti = ti + Ij;
      }
      uy_j = uy_i;
      th_j = th_i;
      sn0 = s0;
      sn1 = s1;
      fn1 = g1;
      fn2 = g2;
    }
    __syncthreads();
    if constexpr (ANALYSIS) {
      // coalesced write-back of the chunk's V, M and u
      for (int kk = t; kk < T * kChunk; kk += T) {
        const int r = kk / kChunk, col = kk - r * kChunk;
        if (b0 + r < B && col < cnt) {
          const size_t o = (size_t)(b0 + r) * nelem + c0 + col;
          mu_out[o] = oI[r * kPitch + col];
          nu_out[o] = oMu[r * kPitch + col];
        }
      }
      const int ucols = 3 * (cnt + (c0 + cnt == nelem ? 1 : 0));
      for (int kk = t; kk < T * kPitchU; kk += T) {
        const int r = kk / kPitchU, col = kk - r * kPitchU;
        if (b0 + r < B && col < ucols)
          I_out[(size_t)(b0 + r) * 3 * n + 3 * c0 + col] =
              oNu[r * kPitchU + col];
      }
    } else {
      // coalesced write-back of the chunk's I, mu, nu
      for (int kk = t; kk < T * kChunk; kk += T) {
        const int r = kk / kChunk, col = kk - r * kChunk;
        if (b0 + r < B && col < cnt) {
          const size_t o = (size_t)(b0 + r) * nelem + c0 + col;
          I_out[o] = oI[r * kPitch + col];
          mu_out[o] = oMu[r * kPitch + col];
          nu_out[o] = oNu[r * kPitch + col];
        }
      }
    }
  }
  if constexpr (ANALYSIS) {
    // u_x = x_0 * 0 at every node, the JAX kernel's exact zero: the tiles
    // wrote +0, so only a lane whose zero is -0 or NaN is written again
    const float z = live ? float(x0 * 0.0) : 0.0f;
    const unsigned redo =
        __ballot_sync(0xffffffffu, __float_as_uint(z) != 0u);
    __syncthreads();
    smem[t] = z;
    __syncthreads();
    for (int kk = t; redo != 0u && kk < T * n; kk += T) {
      const int r = kk / n, i = kk - r * n;
      if ((redo >> r) & 1u) I_out[(size_t)(b0 + r) * 3 * n + 3 * i] = smem[r];
    }
    return;
  }
  if (live) {
    const float4 out = make_float4(float(ti + alpha_m * tb + alpha_s * ts),
                                   float(ti), float(alpha_m * tb),
                                   float(alpha_s * ts));
    reinterpret_cast<float4*>(stats)[b] = out;
  }
}

}  // namespace

extern "C" {

// Scratch doubles per node per lane.
int beam_opt_dd_scratch_per_node(void) { return NSCR; }

// Lanes-first float32 I/O: I, mu, nu, Le, I_out, mu_out, nu_out (B, n - 1),
// free (B, n, 3), loads (B, n), udl (B,), stats (B, 4), piv (B,); scratch
// (n, 7, B) float64; all contiguous, n >= 2.
int beam_opt_step_dd_f32io(const float* I, const float* mu, const float* nu,
                           const float* Le, const float* fr,
                           const float* loads, const float* udl, float* I_out,
                           float* mu_out, float* nu_out, float* stats,
                           float* piv, double* scr, int B, int n, double E,
                           double EA, double G, double alpha_m,
                           double alpha_s, float clamp_min, float lr_t,
                           float bc1, float bc2, void* stream) {
  if (B <= 0) return 0;
  if (n < 2) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kLanes - 1) / kLanes;
  beam_dd_kernel<false><<<blocks, kLanes, 0, (cudaStream_t)stream>>>(
      I, mu, nu, Le, fr, loads, udl, I_out, mu_out, nu_out, stats, piv, scr,
      B, n, E, EA, G, alpha_m, alpha_s, clamp_min, lr_t, bc1, bc2);
  return (int)cudaGetLastError();
}

// The float64 analysis, lanes-first float32 I/O: I, Le, V, M (B, n - 1),
// free (B, n, 3), loads (B, n), udl (B,), u (B, n, 3), piv (B,); scratch
// (n, 7, B) float64 as the opt step's; all contiguous, n >= 2.
int beam_analysis_dd_f32io(const float* I, const float* Le, const float* fr,
                           const float* loads, const float* udl, float* u,
                           float* V, float* M, float* piv, double* scr, int B,
                           int n, double E, double EA, void* stream) {
  if (B <= 0) return 0;
  if (n < 2) return (int)cudaErrorInvalidValue;
  const int blocks = (B + kLanes - 1) / kLanes;
  beam_dd_kernel<true><<<blocks, kLanes, 0, (cudaStream_t)stream>>>(
      I, nullptr, nullptr, Le, fr, loads, udl, u, V, M, nullptr, piv, scr, B,
      n, E, EA, 0.0, 0.0, 0.0, 0.0f, 0.0f, 0.0f, 0.0f);
  return (int)cudaGetLastError();
}

}  // extern "C"
