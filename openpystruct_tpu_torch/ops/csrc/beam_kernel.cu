// The explicit-RHS 3-DOF beam solve for Hopper (sm_90a), one thread per
// scenario lane.
//
// beam_solve_kernel replaces openpystruct_tpu/ops/beam_kernel.py:682
// _beam_kernel (launcher pallas_beam_solve): the 3-DOF solve of K(I) x =
// rhs for an explicit right-hand side, the reverse pass of the fused
// analysis.  Stages as in the TPU kernel (_stage_stiffness, _stage_assemble
// with an explicit RHS, _stage_scale, _stage_factor with C and the fused
// forward sweep, _back_substitute, _stage_refine, _substitute_inplace): full
// 3x3 blocks, because an arbitrary RHS may load the axial chain.  Only the
// branch pallas_beam_solve runs is ported (explicit RHS, no force recovery):
// no caller in the JAX package reaches the others.  The pivot is min_i
// |det3(S_i)| of the Jacobi-scaled factorization, without the bending
// kernels' axial-chain product.  The bending-only analysis and Adam-step
// kernels, float32 and float64, have sources of their own: beam_opt.cu and
// beam_opt_dd.cu.
//
// Design.  Each thread walks its lane's recurrence serially, as one TPU
// vector lane did.  The per-lane scratch (53 values per node) does not fit
// in registers, so it lives in a global workspace the wrapper allocates,
// laid out [node][component][lane]: neighbouring threads touch neighbouring
// addresses, as do the lane-innermost inputs and outputs the wrapper
// transposes to.  A bounds check retires the threads past B, so no lane is
// padded: the JAX launcher's well-posed dummy lanes (_pad_lane_fixup) are
// not needed here.
//
// Bound on an H100 SXM: I, Le, free, rhs in and x, pivot out, 11n - 1
// floats per lane (1110 at n = 101, ~21.7 us at B = 16384 on 3.35 TB/s);
// the ~650 flops per node with one refinement sweep are ~16 us at 67
// TFLOP/s, so bytes bound it.  What this simple design leaves on the table:
//  - occupancy: B = 16384 lanes is ~124 threads per SM; each thread's chain
//    of dependent loads runs at memory latency, not bandwidth;
//  - scratch traffic: the workspace (~350 MB at B = 16384) streams through
//    L2 and HBM several times per call instead of staying on chip.
// beam_opt.cu and beam_opt_dd.cu redesign the bending kernels along these
// lines: fused sweeps over read-only lanes-first inputs, scratch written
// once per sweep, no layout copies.
//
// Floating point: no --use_fast_math; IEEE division and square root.  The
// compiler may contract a*b+c into an FMA anywhere except in the
// error-free transforms below, which use the _rn intrinsics.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlock = 64;

// Workspace components per node: element j's EA/Le, 12EI/Le^3, 6EI/Le^2,
// 4EI/Le, 2EI/Le first.
enum : int { KS0 = 0, KS1, KS2, KS3, KS4 };

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

// jnp.minimum propagates NaN; fminf does not.  A lane that went NaN must
// stay NaN so the validity gate drops it.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b || b < a) ? b : a);
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

// ---------------------------------------------------------------------------
// The 3x3 stages.
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

// Workspace floats per node per lane of the explicit-RHS solve.
int beam_solve_ws_per_node(void) { return NC_SOLVE3; }

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

}  // extern "C"
