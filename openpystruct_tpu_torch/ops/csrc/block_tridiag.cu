// Symmetric 3x3 block-tridiagonal Thomas solves for Hopper (sm_90a), one
// thread per system (lane): the block-Thomas factorization
// S_i = D_i - U_{i-1}^T C_{i-1}, C_i = S_i^-1 U_i, fused with the forward
// sweep y_i = S_i^-1 (b_i - U_{i-1}^T y_{i-1}), then the back sweep
// x_i = y_i - C_i x_{i+1}.  The lower band is U^T (K symmetric).  The
// float32 one-launch solve (#4) is block_resident.cu and the float32
// streamed one (#6) block_stream.cu; both read lanes-first systems and
// carry their own copy of the row step below.
//
// thomas_fwd_kernel and thomas_bwd_kernel are the streamed pair: the
// recurrence split into two launches, the forward one writing C and y to
// device memory and the backward one reading them back in reverse.  The
// carries (C, y, U of the previous row; x of the next) start at zero, so
// row 0 and row n-1 fall out of the generic step.
//
// thomas_fwd_kernel<double, true> and thomas_bwd_kernel<double, float>
// replace openpystruct_tpu/ops/block_stream_dd.py _fwd_kernel_dd and
// _bwd_kernel_dd (launcher pallas_solve_dd_streamed, entry point
// thomas_streamed_dd_f64): the streamed pair in float64, the
// H100's native type where the TPU carried float32 hi/lo pairs.  The
// forward sweep also keeps the running min |det S_i| of each lane (the
// Schur-pivot diagnostic) and writes it once; the backward sweep carries x
// in float64 and writes it as float32 (float32 out, float64 inside, the
// JAX contract).  The TPU kernels' 32-node chunks and identity-padded rows
// and lanes existed for VMEM and have no counterpart.
//
// thomas_bidi_kernel replaces openpystruct_tpu/ops/block_tridiag.py
// _thomas_kernel_bidi (pallas_block_tridiag_solve(bidi=True)): two
// elimination chains, rows [0, m) rising and rows (m, n) falling with
// m = n / 2, meet at row m and back-substitute outward.  One thread runs
// both chains in one loop, so two independent dependency chains are in
// flight together: the experiment asks whether that hides the latency of
// the dependent row loads that bounds one chain per thread on this card.
// Right chain: S'_k = D_k - U_k C'_{k+1}, C'_k = S'_k^-1 U_{k-1}^T,
// y'_k = S'_k^-1 (b_k - U_k y'_{k+1}); meeting row:
// S_m = D_m - U_{m-1}^T C_{m-1} - (U_m S'_{m+1}^-1) U_m^T,
// x_m = S_m^-1 (b_m - U_{m-1}^T y_{m-1} - U_m y'_{m+1});
// then x_i = y_i - C_i x_{i+1} (left, falling), x_k = y'_k - C'_k x_{k-1}
// (right, rising).  S'_{m+1}^-1 stays in registers.  Needs n >= 3.
//
// Arithmetic order is the TPU kernels': the cofactor inverse times 1/det
// (block_tridiag.py _inv3_det), 3x3 products summed over k = 0, 1, 2.  The
// row step is a template over the scalar type; its float instantiation is
// the same expressions as before the float64 kernels, and the compiler may
// contract products and sums into FMAs.
//
// Layout: lane-innermost, diag (n, 3, 3, B), upper (n-1, 3, 3, B), b and x
// (n, 3, B), C (n, 3, 3, B) workspace or output, y (n, 3, B): neighbouring
// threads read neighbouring addresses.  A bounds check retires the threads
// past B, so no lane is padded (the TPU launchers' identity-padded lanes).
//
// Bound on an H100 SXM: each solve must read diag, upper, b once and write
// x once, 24n - 9 floats per lane (2415 at n = 101, ~47 us at B = 16384 and
// 3.35 TB/s); ~190 flops per row are ~5 us at 67 TFLOP/s float32, so the
// function is bound by bytes.  The float64 pair reads 21n - 9 doubles and
// writes 3n + 1 floats per lane (~89 us at n = 101).  This simple design
// also streams C and y through L2 and device memory, and each thread's
// chain of dependent row loads runs at memory latency with ~124 threads per
// SM at B = 16384 (block_stream.cu stages the rows ahead of the chain
// instead).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kBlock = 64;

template <typename T>
struct M3 {
  T m[3][3];
};
template <typename T>
struct V3 {
  T v[3];
};

template <typename T>
__device__ __forceinline__ M3<T> load_m(const T* __restrict__ p, int i,
                                        size_t B, int b) {
  M3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = p[((size_t)i * 9 + a * 3 + c) * B + b];
  return r;
}

template <typename T>
__device__ __forceinline__ void store_m(T* __restrict__ p, int i, size_t B,
                                        int b, const M3<T>& x) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) p[((size_t)i * 9 + a * 3 + c) * B + b] = x.m[a][c];
}

template <typename T>
__device__ __forceinline__ V3<T> load_v(const T* __restrict__ p, int i,
                                        size_t B, int b) {
  V3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a) r.v[a] = p[((size_t)i * 3 + a) * B + b];
  return r;
}

template <typename T, typename S>
__device__ __forceinline__ void store_v(S* __restrict__ p, int i, size_t B,
                                        int b, const V3<T>& x) {
#pragma unroll
  for (int a = 0; a < 3; ++a) p[((size_t)i * 3 + a) * B + b] = (S)x.v[a];
}

template <typename T>
__device__ __forceinline__ M3<T> zero_m() {
  M3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = T(0);
  return r;
}

// Cofactor inverse times 1/det (block_tridiag.py _inv3_det); det out.
template <typename T>
__device__ __forceinline__ M3<T> inv3(const M3<T>& x, T& det) {
  const T a = x.m[0][0], b = x.m[0][1], c = x.m[0][2];
  const T d = x.m[1][0], e = x.m[1][1], f = x.m[1][2];
  const T g = x.m[2][0], h = x.m[2][1], i = x.m[2][2];
  const T A = e * i - f * h;
  const T B = -(d * i - f * g);
  const T C = d * h - e * g;
  const T D = -(b * i - c * h);
  const T E = a * i - c * g;
  const T F = -(a * h - b * g);
  const T G = b * f - c * e;
  const T H = -(a * f - c * d);
  const T I = a * e - b * d;
  det = a * A + b * B + c * C;
  const T inv_det = T(1) / det;
  M3<T> r;
  r.m[0][0] = A * inv_det; r.m[0][1] = D * inv_det; r.m[0][2] = G * inv_det;
  r.m[1][0] = B * inv_det; r.m[1][1] = E * inv_det; r.m[1][2] = H * inv_det;
  r.m[2][0] = C * inv_det; r.m[2][1] = F * inv_det; r.m[2][2] = I * inv_det;
  return r;
}

// p q
template <typename T>
__device__ __forceinline__ M3<T> mm(const M3<T>& p, const M3<T>& q) {
  M3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r.m[a][c] = p.m[a][0] * q.m[0][c] + p.m[a][1] * q.m[1][c] +
                  p.m[a][2] * q.m[2][c];
  return r;
}

// p^T q
template <typename T>
__device__ __forceinline__ M3<T> mtm(const M3<T>& p, const M3<T>& q) {
  M3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r.m[a][c] = p.m[0][a] * q.m[0][c] + p.m[1][a] * q.m[1][c] +
                  p.m[2][a] * q.m[2][c];
  return r;
}

// p q^T
template <typename T>
__device__ __forceinline__ M3<T> mmt(const M3<T>& p, const M3<T>& q) {
  M3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r.m[a][c] = p.m[a][0] * q.m[c][0] + p.m[a][1] * q.m[c][1] +
                  p.m[a][2] * q.m[c][2];
  return r;
}

// p - q
template <typename T>
__device__ __forceinline__ M3<T> sub_m(const M3<T>& p, const M3<T>& q) {
  M3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = p.m[a][c] - q.m[a][c];
  return r;
}

// p v
template <typename T>
__device__ __forceinline__ V3<T> mv(const M3<T>& p, const V3<T>& v) {
  V3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.v[a] = p.m[a][0] * v.v[0] + p.m[a][1] * v.v[1] + p.m[a][2] * v.v[2];
  return r;
}

// p^T v
template <typename T>
__device__ __forceinline__ V3<T> mtv(const M3<T>& p, const V3<T>& v) {
  V3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.v[a] = p.m[0][a] * v.v[0] + p.m[1][a] * v.v[1] + p.m[2][a] * v.v[2];
  return r;
}

// u - v
template <typename T>
__device__ __forceinline__ V3<T> sub_v(const V3<T>& u, const V3<T>& v) {
  V3<T> r;
#pragma unroll
  for (int a = 0; a < 3; ++a) r.v[a] = u.v[a] - v.v[a];
  return r;
}

// One forward row: from the previous row's U, C, y (zero before row 0) and
// this row's D, U, b, the new C_i and y_i, and det S_i.  U_{n-1} is zero
// (the TPU launchers zero-pad the super-diagonal), so C_{n-1} = 0.
template <typename T>
struct Carry {
  M3<T> u, c;
  V3<T> y;
};

template <typename T>
__device__ __forceinline__ void fwd_row(const T* __restrict__ diag_t,
                                        const T* __restrict__ upper_t,
                                        const T* __restrict__ b_t, int i,
                                        int n, size_t B, int b, Carry<T>& k,
                                        T& det) {
  const M3<T> s = sub_m(load_m(diag_t, i, B, b), mtm(k.u, k.c));
  const M3<T> sinv = inv3(s, det);
  const M3<T> u = i < n - 1 ? load_m(upper_t, i, B, b) : zero_m<T>();
  const V3<T> q = sub_v(load_v(b_t, i, B, b), mtv(k.u, k.y));
  k.c = mm(sinv, u);
  k.y = mv(sinv, q);
  k.u = u;
}

// One right-chain row k of the bidirectional solve, falling, 1 <= k <= n-1:
// from the carry U_k, C'_{k+1}, y'_{k+1} (zero past row n-1), the new C'_k
// and y'_k; the carry's U becomes U_{k-1}.  S'_k^-1 out.
template <typename T>
__device__ __forceinline__ void right_row(const T* __restrict__ diag_t,
                                          const T* __restrict__ upper_t,
                                          const T* __restrict__ b_t, int k,
                                          size_t B, int b, Carry<T>& r,
                                          M3<T>& sinv) {
  T det;
  sinv = inv3(sub_m(load_m(diag_t, k, B, b), mm(r.u, r.c)), det);
  const M3<T> u = load_m(upper_t, k - 1, B, b);
  const V3<T> q = sub_v(load_v(b_t, k, B, b), mv(r.u, r.y));
  r.c = mmt(sinv, u);
  r.y = mv(sinv, q);
  r.u = u;
}

template <typename T>
__device__ __forceinline__ V3<T> bwd_row(const M3<T>& c, const V3<T>& y,
                                         const V3<T>& x_next) {
  return sub_v(y, mv(c, x_next));
}

template <typename T>
__device__ __forceinline__ Carry<T> zero_carry() {
  Carry<T> k;
  k.u = zero_m<T>();
  k.c = zero_m<T>();
#pragma unroll
  for (int a = 0; a < 3; ++a) k.y.v[a] = T(0);
  return k;
}

// Streamed forward sweep: C (n, 3, 3, B) and y (n, 3, B) to device memory;
// with kPivot, the running min |det S_i| of the lane to piv (NaN once any
// det is NaN, as jnp.minimum and torch.minimum propagate it).
template <typename T, bool kPivot>
__global__ void __launch_bounds__(kBlock)
thomas_fwd_kernel(const T* __restrict__ diag_t, const T* __restrict__ upper_t,
                  const T* __restrict__ b_t, T* __restrict__ c_t,
                  T* __restrict__ y_t, float* __restrict__ piv, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  Carry<T> k = zero_carry<T>();
  T det, pmin = T(INFINITY);
  for (int i = 0; i < n; ++i) {
    fwd_row(diag_t, upper_t, b_t, i, n, Bs, b, k, det);
    store_m(c_t, i, Bs, b, k.c);
    store_v(y_t, i, Bs, b, k.y);
    if (kPivot) {
      const T ad = fabs(det);
      pmin = (ad < pmin || isnan(ad)) ? ad : pmin;
    }
  }
  if (kPivot) piv[b] = (float)pmin;
}

// Streamed backward sweep, rows in reverse from a zero x carry; x is
// carried in T and written as S.
template <typename T, typename S>
__global__ void __launch_bounds__(kBlock)
thomas_bwd_kernel(const T* __restrict__ c_t, const T* __restrict__ y_t,
                  S* __restrict__ x_t, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  V3<T> x;
#pragma unroll
  for (int a = 0; a < 3; ++a) x.v[a] = T(0);
  for (int i = n - 1; i >= 0; --i) {
    x = bwd_row(load_m(c_t, i, Bs, b), load_v(y_t, i, Bs, b), x);
    store_v(x_t, i, Bs, b, x);
  }
}

// Bidirectional: y and y' go into x, C and C' into the (n, 3, 3, B)
// workspace (row m unused), then both back sweeps overwrite x in place.
// The first loop runs both chains (the right one has n-1-m <= m rows); an
// even n leaves one left row, and one left back-substitution, for after.
__global__ void __launch_bounds__(kBlock)
thomas_bidi_kernel(const float* __restrict__ diag_t,
                   const float* __restrict__ upper_t,
                   const float* __restrict__ b_t, float* __restrict__ x_t,
                   float* __restrict__ c_ws, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  const int m = n / 2;
  const int nr = n - 1 - m;
  Carry<float> l = zero_carry<float>(), r = zero_carry<float>();
  M3<float> sinv_r = zero_m<float>();
  float det;
  for (int j = 0; j < nr; ++j) {
    fwd_row(diag_t, upper_t, b_t, j, n, Bs, b, l, det);
    right_row(diag_t, upper_t, b_t, n - 1 - j, Bs, b, r, sinv_r);
    store_m(c_ws, j, Bs, b, l.c);
    store_v(x_t, j, Bs, b, l.y);
    store_m(c_ws, n - 1 - j, Bs, b, r.c);
    store_v(x_t, n - 1 - j, Bs, b, r.y);
  }
  if (nr < m) {
    fwd_row(diag_t, upper_t, b_t, m - 1, n, Bs, b, l, det);
    store_m(c_ws, m - 1, Bs, b, l.c);
    store_v(x_t, m - 1, Bs, b, l.y);
  }
  // meeting row: l holds U_{m-1}, C_{m-1}, y_{m-1}; r holds U_m, y'_{m+1}
  const M3<float> s = sub_m(sub_m(load_m(diag_t, m, Bs, b), mtm(l.u, l.c)),
                            mmt(mm(r.u, sinv_r), r.u));
  const V3<float> q = sub_v(sub_v(load_v(b_t, m, Bs, b), mtv(l.u, l.y)),
                            mv(r.u, r.y));
  const V3<float> xm = mv(inv3(s, det), q);
  store_v(x_t, m, Bs, b, xm);
  V3<float> xl = xm, xr = xm;
  for (int j = 1; j <= nr; ++j) {
    xl = bwd_row(load_m(c_ws, m - j, Bs, b), load_v(x_t, m - j, Bs, b), xl);
    xr = bwd_row(load_m(c_ws, m + j, Bs, b), load_v(x_t, m + j, Bs, b), xr);
    store_v(x_t, m - j, Bs, b, xl);
    store_v(x_t, m + j, Bs, b, xr);
  }
  if (nr < m) {
    xl = bwd_row(load_m(c_ws, 0, Bs, b), load_v(x_t, 0, Bs, b), xl);
    store_v(x_t, 0, Bs, b, xl);
  }
}

}  // namespace

extern "C" {

// Float64 systems (lane-innermost), float64 workspace C (n, 3, 3, B) and
// y (n, 3, B); x (n, 3, B) and pivot (B,) out in float32.
int thomas_streamed_dd_f64(const double* diag_t, const double* upper_t,
                           const double* b_t, double* c_t, double* y_t,
                           float* x_t, float* piv, int B, int n,
                           void* stream) {
  if (B <= 0 || n <= 0) return 0;
  const int blocks = (B + kBlock - 1) / kBlock;
  thomas_fwd_kernel<double, true><<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      diag_t, upper_t, b_t, c_t, y_t, piv, B, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  thomas_bwd_kernel<double, float>
      <<<blocks, kBlock, 0, (cudaStream_t)stream>>>(c_t, y_t, x_t, B, n);
  return (int)cudaGetLastError();
}

// The bidirectional solve; c_ws is (n, 3, 3, B).  n < 3 is refused.
int thomas_bidi_f32(const float* diag_t, const float* upper_t,
                    const float* b_t, float* x_t, float* c_ws, int B, int n,
                    void* stream) {
  if (n < 3) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int blocks = (B + kBlock - 1) / kBlock;
  thomas_bidi_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      diag_t, upper_t, b_t, x_t, c_ws, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
