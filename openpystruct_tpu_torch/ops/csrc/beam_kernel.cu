// Fused beam FEA kernels for Hopper (sm_90a), one thread per scenario lane.
//
// beam_analysis_kernel replaces openpystruct_tpu/ops/beam_kernel.py
// _beam_kernel_b2 (launcher pallas_beam_analysis): stiffness -> masked
// bending-only 2x2 block-tridiagonal assembly -> Jacobi scaling ->
// block-Thomas factorization (Schur inverses and C_i = Sinv_i U_i saved)
// fused with the forward sweep -> back sweep -> `refine` compensated
// sweeps -> unscaling -> shear/moment recovery, plus the 3-DOF min Schur
// pivot min_i a_i |det2(S_i)| with the axial chain a_i run in float32.
//
// beam_analysis_dd_kernel replaces openpystruct_tpu/ops/beam_kernel_dd.py
// _beam_dd_kernel, the rescue's double-double analysis.  The H100 has
// native FP64, so "dd" here means float64: the same stage functions,
// instantiated for double (as the JAX dd module hands its float32 stages
// hi/lo pairs), with float32 inputs and outputs.  No refinement stage and
// no saved C, as in the dd kernel; the pivot's axial chain runs in float64
// too.  The two Adam-step kernels, the datagen's (_beam_opt_kernel_b2) and
// the rescue's (_beam_dd_opt_kernel), have sources of their own:
// beam_opt.cu and beam_opt_dd.cu.
//
// Design.  Each thread walks its lane's 101-node recurrence serially, as
// one TPU vector lane did.  The per-lane scratch (~27 values per node) does
// not fit in registers, so it lives in a global workspace the wrapper
// allocates, laid out [node][component][lane]: neighbouring threads touch
// neighbouring addresses, as do the lane-innermost inputs and outputs the
// wrapper transposes to.  A bounds check retires the threads past B, so no
// lane is padded: the JAX launchers' well-posed dummy lanes
// (_pad_lane_fixup) are not needed here.
//
// Bound on an H100 SXM: each call must read its inputs once and write its
// outputs once, about 1,109 floats (4.4 KB) per lane at n = 101, which at
// B = 16384 is ~22 us at 3.35 TB/s; the arithmetic (a few hundred flops per
// node) is below that at 67 TFLOP/s float32 and at 34 TFLOP/s float64, so
// the kernels are bound by bytes.  What this simple design leaves on
// the table:
//  - occupancy: B = 16384 lanes is ~124 threads per SM, and the compaction
//    stages go down to 256-512 lanes; each thread's chain of dependent
//    loads runs at memory latency, not bandwidth;
//  - scratch traffic: the workspace (~190 MB at B = 16384, twice that in
//    float64) streams through L2 and HBM several times per call instead of
//    staying on chip.
// beam_opt.cu and beam_opt_dd.cu redesign the two opt steps along these
// lines: fused sweeps over read-only lanes-first inputs, scratch written
// once per sweep, no layout copies.  The kernels here keep the simple
// design.
//
// Floating point: no --use_fast_math; IEEE division and square root.  The
// compiler may contract a*b+c into an FMA anywhere except in the
// error-free transforms below, which use the _rn intrinsics.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlock = 64;

// Workspace components per node.
enum : int {
  KS0 = 0, KS1, KS2, KS3, KS4,  // element j: EA/Le, 12EI/Le^3, 6EI/Le^2, 4EI/Le, 2EI/Le
  D0, D1, D2,                   // symmetric diagonal block [ww, wt, tt]
  U00, U01, U10, U11,           // block coupling node i to i+1
  F0, F1,                       // scaled right-hand side (kept for residuals)
  S0, S1,                       // Jacobi scales
  SI0, SI1, SI2,                // symmetric Schur inverses
  Y0, Y1,                       // scaled solution
  R0, R1,                       // refinement work / adjoint solution
  NC_COMMON
};
// The axial chain's d00/u00 for the pivot; the float64 kernels stop there,
// the float32 analysis also saves C.
enum : int { AX0 = NC_COMMON, AX1, NC_DD };
enum : int { C00 = NC_DD, C01, C10, C11, NC_ANALYSIS };

template <typename T>
struct Lane {
  T* ws;
  size_t B;
  int nc;
  int b;
  __device__ __forceinline__ T& operator()(int i, int c) const {
    return ws[((size_t)i * nc + c) * B + b];
  }
};

// Inputs are float32 in every kernel; the float64 stages widen on read.
struct In {
  const float* p;
  size_t B;
  int b;
  __device__ __forceinline__ float operator()(int i) const {
    return p[(size_t)i * B + b];
  }
};

// Error-free transforms.  nvcc contracts a*b - c into one FMA by default,
// which silently destroys Dekker's split; these use the never-contracted
// _rn intrinsics instead.  two_prod gets the exact error from one FMA, the
// same (p, e) Dekker's split gives.
__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// lax.rsqrt: 1/sqrt with IEEE sqrt and division, not the approximate rsqrt.
__device__ __forceinline__ float rsq(float x) { return 1.0f / sqrtf(x); }
__device__ __forceinline__ double rsq(double x) { return 1.0 / sqrt(x); }
__device__ __forceinline__ float absval(float x) { return fabsf(x); }
__device__ __forceinline__ double absval(double x) { return fabs(x); }

// jnp.minimum / jnp.maximum propagate NaN; fminf / fmaxf do not.  A lane
// that went NaN must stay NaN so the validity gate drops it.
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a) ? a : ((b != b || b < a) ? b : a);
}
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b || b > a) ? b : a);
}

template <typename T>
__device__ void stiffness(const Lane<T>& W, const In& I, const In& Le,
                          int nelem, T E, T EA) {
  for (int j = 0; j < nelem; ++j) {
    const T inv_le = T(1) / T(Le(j));
    const T eil = E * T(I(j)) * inv_le;
    const T eil2 = eil * inv_le;
    const T eil3 = eil2 * inv_le;
    W(j, KS0) = EA * inv_le;
    W(j, KS1) = T(12) * eil3;
    W(j, KS2) = T(6) * eil2;
    W(j, KS3) = T(4) * eil;
    W(j, KS4) = T(2) * eil;
  }
}

// Masked bending-only assembly + RHS; with AX also the axial chain's d00
// and u00 for the pivot.  Free masks are (n, 3, B) floats.
template <typename T, bool AX>
__device__ void assemble_b2(const Lane<T>& W, const In& Le, const float* fr,
                            const In& loads, T w, int n) {
  const int nelem = n - 1;
  const size_t B = W.B;
  const int b = W.b;
  auto freev = [&](int i, int a) { return T(fr[((size_t)i * 3 + a) * B + b]); };
  for (int i = 0; i < n; ++i) {
    T ea_p = T(0), k11_p = T(0), k12_p = T(0), k13_p = T(0), le_p = T(0);
    T ea_n = T(0), k11_n = T(0), k12_n = T(0), k13_n = T(0), k2_n = T(0),
      le_n = T(0);
    if (i > 0) {
      ea_p = W(i - 1, KS0);
      k11_p = W(i - 1, KS1);
      k12_p = W(i - 1, KS2);
      k13_p = W(i - 1, KS3);
      le_p = T(Le(i - 1));
    }
    if (i < nelem) {
      ea_n = W(i, KS0);
      k11_n = W(i, KS1);
      k12_n = W(i, KS2);
      k13_n = W(i, KS3);
      k2_n = W(i, KS4);
      le_n = T(Le(i));
    }
    const T d11 = k11_p + k11_n;
    const T d12 = -k12_p + k12_n;
    const T d22 = k13_p + k13_n;
    const T f0 = freev(i, 0), f1 = freev(i, 1), f2 = freev(i, 2);
    W(i, D0) = d11 * (f1 * f1 + (T(1) - f1));
    W(i, D1) = d12 * (f1 * f2);
    W(i, D2) = d22 * (f2 * f2 + (T(1) - f2));
    const int inx = i + 1 < n ? i + 1 : n - 1;
    const T fn0 = freev(inx, 0), fn1 = freev(inx, 1), fn2 = freev(inx, 2);
    W(i, U00) = -(k11_n * (f1 * fn1));
    W(i, U01) = k12_n * (f1 * fn2);
    W(i, U10) = -(k12_n * (f2 * fn1));
    W(i, U11) = k2_n * (f2 * fn2);
    // consistent UDL loads + nodal point loads (no axial load exists)
    const T fy = (le_p + le_n) * w * T(0.5) + T(loads(i));
    const T fm = (le_n * le_n - le_p * le_p) * w / T(12);
    W(i, F0) = fy * f1;
    W(i, F1) = fm * f2;
    if (AX) {
      W(i, AX0) = (ea_p + ea_n) * (f0 * f0 + (T(1) - f0));
      W(i, AX1) = -ea_n * (f0 * fn0);
    }
  }
}

template <typename T>
__device__ void scale_b2(const Lane<T>& W, int n) {
  for (int i = 0; i < n; ++i) {
    const T s1 = rsq(W(i, D0)), s2 = rsq(W(i, D2));
    W(i, S0) = s1;
    W(i, S1) = s2;
    W(i, D0) = W(i, D0) * s1 * s1;
    W(i, D1) = W(i, D1) * s1 * s2;
    W(i, D2) = W(i, D2) * s2 * s2;
    W(i, F0) = W(i, F0) * s1;
    W(i, F1) = W(i, F1) * s2;
  }
  for (int i = 0; i < n - 1; ++i) {
    const T si0 = W(i, S0), si1 = W(i, S1);
    const T sn0 = W(i + 1, S0), sn1 = W(i + 1, S1);
    W(i, U00) = W(i, U00) * si0 * sn0;
    W(i, U01) = W(i, U01) * si0 * sn1;
    W(i, U10) = W(i, U10) * si1 * sn0;
    W(i, U11) = W(i, U11) * si1 * sn1;
  }
}

// Block-Thomas factorization of the bending chain fused with the forward
// sweep (y into Y0/Y1, F kept for the residuals).  WITH_C saves C_i; AX
// tracks the axial chain and returns min_i a_i |det2(S_i)|, the 3-DOF
// pivot, with the axial chain in T: the semantics the datagen validity
// gates (pivot_tol = 1e-9, the rescue's 1e-12) are calibrated on.
template <typename T, bool WITH_C, bool AX>
__device__ T factor_b2(const Lane<T>& W, int n) {
  T m0 = W(0, D0), m1 = W(0, D1), m2 = W(0, D2);
  T det = m0 * m2 - m1 * m1;
  T inv = T(1) / det;
  T s00 = m2 * inv, s01 = -(m1 * inv), s11 = m0 * inv;
  W(0, SI0) = s00;
  W(0, SI1) = s01;
  W(0, SI2) = s11;
  T c00 = T(0), c01 = T(0), c10 = T(0), c11 = T(0);
  if (WITH_C) {
    const T u00 = W(0, U00), u01 = W(0, U01), u10 = W(0, U10),
            u11 = W(0, U11);
    c00 = s00 * u00 + s01 * u10;
    c01 = s00 * u01 + s01 * u11;
    c10 = s01 * u00 + s11 * u10;
    c11 = s01 * u01 + s11 * u11;
    W(0, C00) = c00;
    W(0, C01) = c01;
    W(0, C10) = c10;
    W(0, C11) = c11;
  }
  const T r0 = W(0, F0), r1 = W(0, F1);
  T y0 = s00 * r0 + s01 * r1, y1 = s01 * r0 + s11 * r1;
  W(0, Y0) = y0;
  W(0, Y1) = y1;

  det = absval(det);
  T min_piv = det, a_prev = T(0);
  if (AX) {
    const T a = W(0, AX0);
    const T r = rsq(a);
    a_prev = a * (r * r);
    min_piv = a_prev * det;
  }
  for (int i = 1; i < n; ++i) {
    const T u00 = W(i - 1, U00), u01 = W(i - 1, U01), u10 = W(i - 1, U10),
            u11 = W(i - 1, U11);
    T w00, w01, w10, w11;
    if (WITH_C) {
      w00 = c00;
      w01 = c01;
      w10 = c10;
      w11 = c11;
    } else {
      w00 = s00 * u00 + s01 * u10;
      w01 = s00 * u01 + s01 * u11;
      w10 = s01 * u00 + s11 * u10;
      w11 = s01 * u01 + s11 * u11;
    }
    // S_i = D_i - U^T W (symmetric)
    m0 = W(i, D0) - (u00 * w00 + u10 * w10);
    m1 = W(i, D1) - (u00 * w01 + u10 * w11);
    m2 = W(i, D2) - (u01 * w01 + u11 * w11);
    det = m0 * m2 - m1 * m1;
    inv = T(1) / det;
    s00 = m2 * inv;
    s01 = -(m1 * inv);
    s11 = m0 * inv;
    W(i, SI0) = s00;
    W(i, SI1) = s01;
    W(i, SI2) = s11;
    if (WITH_C) {
      const T v00 = W(i, U00), v01 = W(i, U01), v10 = W(i, U10),
              v11 = W(i, U11);
      c00 = s00 * v00 + s01 * v10;
      c01 = s00 * v01 + s01 * v11;
      c10 = s01 * v00 + s11 * v10;
      c11 = s01 * v01 + s11 * v11;
      W(i, C00) = c00;
      W(i, C01) = c01;
      W(i, C10) = c10;
      W(i, C11) = c11;
    }
    // fused forward substitution y_i = Sinv_i (f_i - U^T y_{i-1})
    const T q0 = W(i, F0) - (u00 * y0 + u10 * y1);
    const T q1 = W(i, F1) - (u01 * y0 + u11 * y1);
    y0 = s00 * q0 + s01 * q1;
    y1 = s01 * q0 + s11 * q1;
    W(i, Y0) = y0;
    W(i, Y1) = y1;
    det = absval(det);
    if (AX) {
      // axial Schur chain a_i = d00s_i - u00s_{i-1}^2 / a_{i-1}
      const T d_prev = W(i - 1, AX0), d_cur = W(i, AX0);
      const T r_prev = rsq(d_prev), r_cur = rsq(d_cur);
      const T u00s = W(i - 1, AX1) * r_prev * r_cur;
      const T d00s = d_cur * r_cur * r_cur;
      a_prev = d00s - u00s * u00s / a_prev;
      min_piv = nan_min(min_piv, a_prev * det);
    }
  }
  return min_piv;
}

// x_i = y_i - C_i x_{i+1} in place on components (X0c, X1c); C from the
// workspace when saved, else Sinv_i (U_i x_{i+1}).
template <typename T, bool WITH_C>
__device__ void bsub_b2(const Lane<T>& W, int n, int X0c, int X1c) {
  T x0 = W(n - 1, X0c), x1 = W(n - 1, X1c);
  for (int i = n - 2; i >= 0; --i) {
    T v0, v1;
    if (WITH_C) {
      v0 = W(i, C00) * x0 + W(i, C01) * x1;
      v1 = W(i, C10) * x0 + W(i, C11) * x1;
    } else {
      const T t0 = W(i, U00) * x0 + W(i, U01) * x1;
      const T t1 = W(i, U10) * x0 + W(i, U11) * x1;
      const T s00 = W(i, SI0), s01 = W(i, SI1), s11 = W(i, SI2);
      v0 = s00 * t0 + s01 * t1;
      v1 = s01 * t0 + s11 * t1;
    }
    x0 = W(i, X0c) - v0;
    x1 = W(i, X1c) - v1;
    W(i, X0c) = x0;
    W(i, X1c) = x1;
  }
}

// Solve K_s x = rhs in place (components hold rhs on entry, x on exit).
template <bool WITH_C>
__device__ void subst_b2(const Lane<float>& W, int n, int X0c, int X1c) {
  float r0 = W(0, X0c), r1 = W(0, X1c);
  float x0 = W(0, SI0) * r0 + W(0, SI1) * r1;
  float x1 = W(0, SI1) * r0 + W(0, SI2) * r1;
  W(0, X0c) = x0;
  W(0, X1c) = x1;
  for (int i = 1; i < n; ++i) {
    const float u00 = W(i - 1, U00), u01 = W(i - 1, U01),
                u10 = W(i - 1, U10), u11 = W(i - 1, U11);
    r0 = W(i, X0c) - (u00 * x0 + u10 * x1);
    r1 = W(i, X1c) - (u01 * x0 + u11 * x1);
    const float s00 = W(i, SI0), s01 = W(i, SI1), s11 = W(i, SI2);
    x0 = s00 * r0 + s01 * r1;
    x1 = s01 * r0 + s11 * r1;
    W(i, X0c) = x0;
    W(i, X1c) = x1;
  }
  bsub_b2<float, WITH_C>(W, n, X0c, X1c);
}

// `refine` sweeps: error-free residual rhs - K_s x into the work
// components, one substitution with the saved factors, x += correction.
template <bool WITH_C>
__device__ void refine_b2(const Lane<float>& W, int n, int refine, int H0c,
                          int H1c, int X0c, int X1c, int K0c, int K1c) {
  for (int it = 0; it < refine; ++it) {
    for (int i = 0; i < n; ++i) {
      const int ip = i > 0 ? i - 1 : 0;
      const int iq = i < n - 2 ? i : n - 2;
      const int inx = i < n - 1 ? i + 1 : n - 1;
      const float mp = i > 0 ? 1.0f : 0.0f;
      const float mn = i < n - 1 ? 1.0f : 0.0f;
      const float xi[2] = {W(i, X0c), W(i, X1c)};
      const float xp[2] = {W(ip, X0c) * mp, W(ip, X1c) * mp};
      const float xn[2] = {W(inx, X0c) * mn, W(inx, X1c) * mn};
      const float md[2][2] = {{W(i, D0), W(i, D1)}, {W(i, D1), W(i, D2)}};
      const float lm[2][2] = {{W(ip, U00), W(ip, U10)},
                              {W(ip, U01), W(ip, U11)}};  // U_{i-1}^T
      const float um[2][2] = {{W(iq, U00), W(iq, U01)},
                              {W(iq, U10), W(iq, U11)}};
      const float rhs[2] = {W(i, H0c), W(i, H1c)};
      float out[2];
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        float acc_s = rhs[a], acc_c = 0.0f, p, e, e2;
#pragma unroll
        for (int bb = 0; bb < 2; ++bb) {
          two_prod(-md[a][bb], xi[bb], p, e);
          two_sum(acc_s, p, acc_s, e2);
          acc_c = acc_c + e2 + e;
          two_prod(-lm[a][bb], xp[bb], p, e);
          two_sum(acc_s, p, acc_s, e2);
          acc_c = acc_c + e2 + e;
          two_prod(-um[a][bb], xn[bb], p, e);
          two_sum(acc_s, p, acc_s, e2);
          acc_c = acc_c + e2 + e;
        }
        out[a] = acc_s + acc_c;
      }
      W(i, K0c) = out[0];
      W(i, K1c) = out[1];
    }
    subst_b2<WITH_C>(W, n, K0c, K1c);
    for (int i = 0; i < n; ++i) {
      W(i, X0c) = W(i, X0c) + W(i, K0c);
      W(i, X1c) = W(i, X1c) + W(i, K1c);
    }
  }
}

// Unscaled displacements (u_x == 0 exactly, NaN if the solve went NaN)
// and the element end forces, local p = k_e [u_i; u_j] - f_eq with V =
// p[1], M = p[2], from the scaled solution in Y0/Y1.
template <typename T>
__device__ void write_solution(const Lane<T>& W, const In& Le, T w, int n,
                               float* __restrict__ u_t,
                               float* __restrict__ V_t,
                               float* __restrict__ M_t) {
  const size_t Bs = W.B;
  const int b = W.b;
  const float zero = float(W(0, Y0) * T(0));
  for (int i = 0; i < n; ++i) {
    u_t[((size_t)i * 3 + 0) * Bs + b] = zero;
    u_t[((size_t)i * 3 + 1) * Bs + b] = float(W(i, Y0) * W(i, S0));
    u_t[((size_t)i * 3 + 2) * Bs + b] = float(W(i, Y1) * W(i, S1));
  }
  T uy_i = W(0, Y0) * W(0, S0), th_i = W(0, Y1) * W(0, S1);
  for (int j = 0; j < n - 1; ++j) {
    const T uy_j = W(j + 1, Y0) * W(j + 1, S0);
    const T th_j = W(j + 1, Y1) * W(j + 1, S1);
    const T k11 = W(j, KS1), k12 = W(j, KS2), k13 = W(j, KS3),
            k2 = W(j, KS4), le = T(Le(j));
    V_t[(size_t)j * Bs + b] = float(k11 * uy_i + k12 * th_i - k11 * uy_j +
                                    k12 * th_j - w * le * T(0.5));
    M_t[(size_t)j * Bs + b] = float(k12 * uy_i + k13 * th_i - k12 * uy_j +
                                    k2 * th_j - w * le * le / T(12));
    uy_i = uy_j;
    th_i = th_j;
  }
}

__global__ void __launch_bounds__(kBlock)
beam_analysis_kernel(const float* __restrict__ I_t,
                     const float* __restrict__ Le_t,
                     const float* __restrict__ free_t,
                     const float* __restrict__ loads_t,
                     const float* __restrict__ udl, float* __restrict__ u_t,
                     float* __restrict__ V_t, float* __restrict__ M_t,
                     float* __restrict__ piv, float* __restrict__ ws, int B,
                     int n, int refine, float E, float EA) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  const Lane<float> W{ws, Bs, NC_ANALYSIS, b};
  const In I{I_t, Bs, b}, Le{Le_t, Bs, b}, loads{loads_t, Bs, b};
  const int nelem = n - 1;
  const float w = udl[b];

  stiffness(W, I, Le, nelem, E, EA);
  assemble_b2<float, true>(W, Le, free_t, loads, w, n);
  scale_b2(W, n);
  piv[b] = factor_b2<float, true, true>(W, n);
  bsub_b2<float, true>(W, n, Y0, Y1);
  refine_b2<true>(W, n, refine, F0, F1, Y0, Y1, R0, R1);
  write_solution(W, Le, w, n, u_t, V_t, M_t);
}

// The float64 solve of the rescue's analysis: stiffness -> assembly with
// the axial chain -> scaling -> factor with the fused forward sweep (no C)
// -> back sweep.  Returns the 3-DOF min pivot.
__device__ double solve_dd(const Lane<double>& W, const In& I, const In& Le,
                           const float* free_t, const In& loads, double w,
                           int n, double E, double EA) {
  stiffness(W, I, Le, n - 1, E, EA);
  assemble_b2<double, true>(W, Le, free_t, loads, w, n);
  scale_b2(W, n);
  const double piv = factor_b2<double, false, true>(W, n);
  bsub_b2<double, false>(W, n, Y0, Y1);
  return piv;
}

__global__ void __launch_bounds__(kBlock)
beam_analysis_dd_kernel(const float* __restrict__ I_t,
                        const float* __restrict__ Le_t,
                        const float* __restrict__ free_t,
                        const float* __restrict__ loads_t,
                        const float* __restrict__ udl,
                        float* __restrict__ u_t, float* __restrict__ V_t,
                        float* __restrict__ M_t, float* __restrict__ piv,
                        double* __restrict__ ws, int B, int n, double E,
                        double EA) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  const Lane<double> W{ws, Bs, NC_DD, b};
  const In I{I_t, Bs, b}, Le{Le_t, Bs, b}, loads{loads_t, Bs, b};
  const double w = udl[b];
  piv[b] = float(solve_dd(W, I, Le, free_t, loads, w, n, E, EA));
  write_solution(W, Le, w, n, u_t, V_t, M_t);
}

// ---------------------------------------------------------------------------
// beam_solve_kernel replaces openpystruct_tpu/ops/beam_kernel.py
// _beam_kernel (launcher pallas_beam_solve): the 3-DOF solve of K(I) x = rhs
// for an explicit right-hand side, the reverse pass of the fused analysis.
// Stages as in the TPU kernel (_stage_stiffness, _stage_assemble with an
// explicit RHS, _stage_scale, _stage_factor with C and the fused forward
// sweep, _back_substitute, _stage_refine, _substitute_inplace): full 3x3
// blocks, because an arbitrary RHS may load the axial chain.  Only the
// branch pallas_beam_solve runs is ported (explicit RHS, no force
// recovery): no caller in the JAX package reaches the others.  The pivot is
// min_i |det3(S_i)| of the Jacobi-scaled factorization, without the
// bending kernels' axial-chain product.
//
// Bound on an H100 SXM: I, Le, free, rhs in and x, pivot out, 11n - 1
// floats per lane (1110 at n = 101, ~21.7 us at B = 16384); the ~650
// flops per node with one refinement sweep are ~16 us at 67 TFLOP/s, so
// bytes bound it.  The 53 floats per node of scratch go through the same
// lane-innermost global workspace as the other kernels.
// ---------------------------------------------------------------------------

enum : int {
  Q_D = 5,            // after the stiffness components KS0..KS4
  Q_U = Q_D + 9,      // block coupling node i to i+1, row-major
  Q_F = Q_U + 9,      // scaled masked right-hand side
  Q_S = Q_F + 3,      // Jacobi scales
  Q_SI = Q_S + 3,     // Schur inverses
  Q_C = Q_SI + 9,     // C_i = Sinv_i U_i
  Q_Y = Q_C + 9,      // scaled solution
  Q_R = Q_Y + 3,      // refinement work vector
  NC_SOLVE3 = Q_R + 3
};

struct Mat3 {
  float m[3][3];
};

__device__ __forceinline__ Mat3 ld3(const Lane<float>& W, int i, int base) {
  Mat3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = W(i, base + 3 * a + c);
  return r;
}

__device__ __forceinline__ void st3(const Lane<float>& W, int i, int base,
                                    const Mat3& x) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) W(i, base + 3 * a + c) = x.m[a][c];
}

// Cofactor inverse times 1/det (block_tridiag.py _inv3_det).
__device__ __forceinline__ Mat3 inv3(const Mat3& x) {
  const float a = x.m[0][0], b = x.m[0][1], c = x.m[0][2];
  const float d = x.m[1][0], e = x.m[1][1], f = x.m[1][2];
  const float g = x.m[2][0], h = x.m[2][1], i = x.m[2][2];
  const float A = e * i - f * h;
  const float B = -(d * i - f * g);
  const float C = d * h - e * g;
  const float D = -(b * i - c * h);
  const float E = a * i - c * g;
  const float F = -(a * h - b * g);
  const float G = b * f - c * e;
  const float H = -(a * f - c * d);
  const float I = a * e - b * d;
  const float inv_det = 1.0f / (a * A + b * B + c * C);
  Mat3 r;
  r.m[0][0] = A * inv_det; r.m[0][1] = D * inv_det; r.m[0][2] = G * inv_det;
  r.m[1][0] = B * inv_det; r.m[1][1] = E * inv_det; r.m[1][2] = H * inv_det;
  r.m[2][0] = C * inv_det; r.m[2][1] = F * inv_det; r.m[2][2] = I * inv_det;
  return r;
}

// beam_kernel.py _det3
__device__ __forceinline__ float det3(const Mat3& x) {
  const float a = x.m[0][0], b = x.m[0][1], c = x.m[0][2];
  const float d = x.m[1][0], e = x.m[1][1], f = x.m[1][2];
  const float g = x.m[2][0], h = x.m[2][1], i = x.m[2][2];
  return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
}

// p q; with TP, p^T q
template <bool TP>
__device__ __forceinline__ Mat3 mm3(const Mat3& p, const Mat3& q) {
  Mat3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        acc = acc + (TP ? p.m[k][a] : p.m[a][k]) * q.m[k][c];
      r.m[a][c] = acc;
    }
  return r;
}

// p v; with TP, p^T v
template <bool TP>
__device__ __forceinline__ void mv3(const Mat3& p, const float* v,
                                    float* out) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) acc = acc + (TP ? p.m[k][a] : p.m[a][k]) * v[k];
    out[a] = acc;
  }
}

// Masked 3-DOF assembly with an explicit RHS (_stage_assemble): constrained
// rows and columns zeroed, the original diagonal entry kept on the diagonal;
// the axial and bending couplings are zero off the diagonal.  A missing
// neighbour element contributes its (clamped) coefficients times 0, as on
// the TPU.
__device__ void assemble3(const Lane<float>& W, const float* fr,
                          const float* rhs, int n) {
  const int nelem = n - 1;
  const size_t B = W.B;
  const int b = W.b;
  auto at = [&](const float* p, int i, int a) {
    return p[((size_t)i * 3 + a) * B + b];
  };
  for (int i = 0; i < n; ++i) {
    const int jp = i - 1 < 0 ? 0 : i - 1;
    const int jn = i < nelem ? i : nelem - 1;
    const float mp = i > 0 ? 1.0f : 0.0f;
    const float mn = i < nelem ? 1.0f : 0.0f;
    const float ea_p = W(jp, KS0) * mp, k11_p = W(jp, KS1) * mp,
                k12_p = W(jp, KS2) * mp, k13_p = W(jp, KS3) * mp;
    const float ea_n = W(jn, KS0) * mn, k11_n = W(jn, KS1) * mn,
                k12_n = W(jn, KS2) * mn, k13_n = W(jn, KS3) * mn,
                k2_n = W(jn, KS4) * mn;
    const float d00 = ea_p + ea_n;
    const float d11 = k11_p + k11_n;
    const float d12 = -k12_p + k12_n;
    const float d22 = k13_p + k13_n;
    const float f0 = at(fr, i, 0), f1 = at(fr, i, 1), f2 = at(fr, i, 2);
    const int inx = i + 1 < n ? i + 1 : n - 1;
    const float fn0 = at(fr, inx, 0), fn1 = at(fr, inx, 1),
                fn2 = at(fr, inx, 2);
    Mat3 d, u;
    d.m[0][0] = d00 * f0 * f0 + d00 * (1.0f - f0);
    d.m[0][1] = 0.0f;
    d.m[0][2] = 0.0f;
    d.m[1][0] = 0.0f;
    d.m[1][1] = d11 * f1 * f1 + d11 * (1.0f - f1);
    d.m[1][2] = d12 * f1 * f2;
    d.m[2][0] = 0.0f;
    d.m[2][1] = d12 * f2 * f1;
    d.m[2][2] = d22 * f2 * f2 + d22 * (1.0f - f2);
    u.m[0][0] = -ea_n * f0 * fn0;
    u.m[0][1] = 0.0f;
    u.m[0][2] = 0.0f;
    u.m[1][0] = 0.0f;
    u.m[1][1] = -k11_n * f1 * fn1;
    u.m[1][2] = k12_n * f1 * fn2;
    u.m[2][0] = 0.0f;
    u.m[2][1] = -k12_n * f2 * fn1;
    u.m[2][2] = k2_n * f2 * fn2;
    st3(W, i, Q_D, d);
    st3(W, i, Q_U, u);
    W(i, Q_F + 0) = at(rhs, i, 0) * f0;
    W(i, Q_F + 1) = at(rhs, i, 1) * f1;
    W(i, Q_F + 2) = at(rhs, i, 2) * f2;
  }
}

// Jacobi scaling s = rsqrt(diag) (_stage_scale).
__device__ void scale3(const Lane<float>& W, int n) {
  for (int i = 0; i < n; ++i) {
    float s[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) s[a] = rsq(W(i, Q_D + 4 * a));
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      W(i, Q_S + a) = s[a];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        W(i, Q_D + 3 * a + c) = W(i, Q_D + 3 * a + c) * s[a] * s[c];
      W(i, Q_F + a) = W(i, Q_F + a) * s[a];
    }
  }
  for (int i = 0; i < n - 1; ++i)
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        W(i, Q_U + 3 * a + c) =
            W(i, Q_U + 3 * a + c) * W(i, Q_S + a) * W(i + 1, Q_S + c);
}

// Factorization saving Sinv and C, fused with the forward sweep into Y
// (_stage_factor); returns min_i |det3(S_i)|.
__device__ float factor3(const Lane<float>& W, int n) {
  const Mat3 d0 = ld3(W, 0, Q_D);
  Mat3 sinv = inv3(d0);
  st3(W, 0, Q_SI, sinv);
  Mat3 c = mm3<false>(sinv, ld3(W, 0, Q_U));
  st3(W, 0, Q_C, c);
  float y[3], f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) f[a] = W(0, Q_F + a);
  mv3<false>(sinv, f, y);
#pragma unroll
  for (int a = 0; a < 3; ++a) W(0, Q_Y + a) = y[a];
  float min_det = fabsf(det3(d0));
  for (int i = 1; i < n; ++i) {
    const Mat3 u_prev = ld3(W, i - 1, Q_U);
    const Mat3 uc = mm3<true>(u_prev, c);
    Mat3 s = ld3(W, i, Q_D);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 3; ++k) s.m[a][k] = s.m[a][k] - uc.m[a][k];
    sinv = inv3(s);
    st3(W, i, Q_SI, sinv);
    c = mm3<false>(sinv, ld3(W, i, Q_U));
    st3(W, i, Q_C, c);
    float uy[3], q[3];
    mv3<true>(u_prev, y, uy);
#pragma unroll
    for (int a = 0; a < 3; ++a) q[a] = W(i, Q_F + a) - uy[a];
    mv3<false>(sinv, q, y);
#pragma unroll
    for (int a = 0; a < 3; ++a) W(i, Q_Y + a) = y[a];
    min_det = nan_min(min_det, fabsf(det3(s)));
  }
  return min_det;
}

// x_i = y_i - C_i x_{i+1} in place on components X..X+2 (_back_substitute).
__device__ void bsub3(const Lane<float>& W, int n, int X) {
  float x[3], cx[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) x[a] = W(n - 1, X + a);
  for (int i = n - 2; i >= 0; --i) {
    mv3<false>(ld3(W, i, Q_C), x, cx);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      x[a] = W(i, X + a) - cx[a];
      W(i, X + a) = x[a];
    }
  }
}

// Solve K_s x = rhs in place with the saved factors (_substitute_inplace).
__device__ void subst3(const Lane<float>& W, int n, int X) {
  float x[3], r[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) r[a] = W(0, X + a);
  mv3<false>(ld3(W, 0, Q_SI), r, x);
#pragma unroll
  for (int a = 0; a < 3; ++a) W(0, X + a) = x[a];
  for (int i = 1; i < n; ++i) {
    float ux[3];
    mv3<true>(ld3(W, i - 1, Q_U), x, ux);
#pragma unroll
    for (int a = 0; a < 3; ++a) r[a] = W(i, X + a) - ux[a];
    mv3<false>(ld3(W, i, Q_SI), r, x);
#pragma unroll
    for (int a = 0; a < 3; ++a) W(i, X + a) = x[a];
  }
  bsub3(W, n, X);
}

// `refine` sweeps (_stage_refine): the error-free residual F - K_s Y into
// R, one substitution with the saved factors, Y += R.
__device__ void refine3(const Lane<float>& W, int n, int refine) {
  for (int it = 0; it < refine; ++it) {
    for (int i = 0; i < n; ++i) {
      const int ip = i > 0 ? i - 1 : 0;
      const int iq = i < n - 2 ? i : (n - 2 > 0 ? n - 2 : 0);
      const int inx = i < n - 1 ? i + 1 : n - 1;
      const float mp = i > 0 ? 1.0f : 0.0f;
      const float mn = i < n - 1 ? 1.0f : 0.0f;
      float xi[3], xp[3], xn[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        xi[a] = W(i, Q_Y + a);
        xp[a] = W(ip, Q_Y + a) * mp;
        xn[a] = W(inx, Q_Y + a) * mn;
      }
      const Mat3 md = ld3(W, i, Q_D);
      const Mat3 up = ld3(W, ip, Q_U);   // U_{i-1}, used transposed
      const Mat3 um = ld3(W, iq, Q_U);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float acc_s = W(i, Q_F + a), acc_c = 0.0f, p, e, e2;
#pragma unroll
        for (int bb = 0; bb < 3; ++bb) {
          two_prod(-md.m[a][bb], xi[bb], p, e);
          two_sum(acc_s, p, acc_s, e2);
          acc_c = acc_c + e2 + e;
          two_prod(-up.m[bb][a], xp[bb], p, e);
          two_sum(acc_s, p, acc_s, e2);
          acc_c = acc_c + e2 + e;
          two_prod(-um.m[a][bb], xn[bb], p, e);
          two_sum(acc_s, p, acc_s, e2);
          acc_c = acc_c + e2 + e;
        }
        W(i, Q_R + a) = acc_s + acc_c;
      }
    }
    subst3(W, n, Q_R);
    for (int i = 0; i < n; ++i)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        W(i, Q_Y + a) = W(i, Q_Y + a) + W(i, Q_R + a);
  }
}

__global__ void __launch_bounds__(kBlock)
beam_solve_kernel(const float* __restrict__ I_t,
                  const float* __restrict__ Le_t,
                  const float* __restrict__ free_t,
                  const float* __restrict__ rhs_t, float* __restrict__ x_t,
                  float* __restrict__ piv, float* __restrict__ ws, int B,
                  int n, int refine, float E, float EA) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  const Lane<float> W{ws, Bs, NC_SOLVE3, b};
  const In I{I_t, Bs, b}, Le{Le_t, Bs, b};

  stiffness(W, I, Le, n - 1, E, EA);
  assemble3(W, free_t, rhs_t, n);
  scale3(W, n);
  piv[b] = factor3(W, n);
  bsub3(W, n, Q_Y);
  refine3(W, n, refine);
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      x_t[((size_t)i * 3 + a) * Bs + b] = W(i, Q_Y + a) * W(i, Q_S + a);
}

}  // namespace

extern "C" {

// Workspace values per node per lane: kind 0 analysis, 4 explicit-RHS
// solve, both float32; kind 3 the float64 analysis, float64.
int beam_ws_floats_per_node(int kind) {
  switch (kind) {
    case 0: return NC_ANALYSIS;
    case 4: return NC_SOLVE3;
    default: return NC_DD;
  }
}

int beam_solve_f32(const float* I_t, const float* Le_t, const float* free_t,
                   const float* rhs_t, float* x_t, float* piv, float* ws,
                   int B, int n, int refine, float E, float EA,
                   void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kBlock - 1) / kBlock;
  beam_solve_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      I_t, Le_t, free_t, rhs_t, x_t, piv, ws, B, n, refine, E, EA);
  return (int)cudaGetLastError();
}

int beam_analysis_f32(const float* I_t, const float* Le_t, const float* free_t,
                      const float* loads_t, const float* udl, float* u_t,
                      float* V_t, float* M_t, float* piv, float* ws, int B,
                      int n, int refine, float E, float EA, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kBlock - 1) / kBlock;
  beam_analysis_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      I_t, Le_t, free_t, loads_t, udl, u_t, V_t, M_t, piv, ws, B, n, refine,
      E, EA);
  return (int)cudaGetLastError();
}

int beam_analysis_dd_f32io(const float* I_t, const float* Le_t,
                           const float* free_t, const float* loads_t,
                           const float* udl, float* u_t, float* V_t,
                           float* M_t, float* piv, double* ws, int B, int n,
                           double E, double EA, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kBlock - 1) / kBlock;
  beam_analysis_dd_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      I_t, Le_t, free_t, loads_t, udl, u_t, V_t, M_t, piv, ws, B, n, E, EA);
  return (int)cudaGetLastError();
}

}  // extern "C"
