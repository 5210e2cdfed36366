// Bidirectional symmetric 3x3 block-tridiagonal Thomas solve for Hopper
// (sm_90a), float32, one thread per system (lane).  The other block-Thomas
// solves carry their own row step: the one-launch float32 solve (#4) is
// block_resident.cu, the streamed float32 one (#6) block_stream.cu and the
// streamed float64 one (#9) block_stream_dd.cu.
//
// thomas_bidi_kernel replaces openpystruct_tpu/ops/block_tridiag.py
// _thomas_kernel_bidi (pallas_block_tridiag_solve(bidi=True)): two
// elimination chains, rows [0, m) rising and rows (m, n) falling with
// m = n / 2, meet at row m and back-substitute outward.  One thread runs
// both chains in one loop, so two independent dependency chains are in
// flight together: the experiment asks whether that hides the latency of
// the dependent row loads that bounds one chain per thread on this card.
// Left chain: S_i = D_i - U_{i-1}^T C_{i-1}, C_i = S_i^-1 U_i,
// y_i = S_i^-1 (b_i - U_{i-1}^T y_{i-1}) from zero carries.
// Right chain: S'_k = D_k - U_k C'_{k+1}, C'_k = S'_k^-1 U_{k-1}^T,
// y'_k = S'_k^-1 (b_k - U_k y'_{k+1}); meeting row:
// S_m = D_m - U_{m-1}^T C_{m-1} - (U_m S'_{m+1}^-1) U_m^T,
// x_m = S_m^-1 (b_m - U_{m-1}^T y_{m-1} - U_m y'_{m+1});
// then x_i = y_i - C_i x_{i+1} (left, falling), x_k = y'_k - C'_k x_{k-1}
// (right, rising).  The lower band is U^T (K symmetric).  S'_{m+1}^-1
// stays in registers.  Needs n >= 3.
//
// Arithmetic order is the TPU kernel's: the cofactor inverse times 1/det
// (block_tridiag.py _inv3_det), 3x3 products summed over k = 0, 1, 2; the
// compiler may contract products and sums into FMAs.
//
// Layout: lane-innermost, diag (n, 3, 3, B), upper (n-1, 3, 3, B), b and x
// (n, 3, B), C (n, 3, 3, B) workspace: neighbouring threads read
// neighbouring addresses; the wrapper makes these copies of the lanes-first
// systems.  A bounds check retires the threads past B, so no lane is padded
// (the TPU launcher's identity-padded lanes).
//
// Bound on an H100 SXM: each solve must read diag, upper, b once and write
// x once, 24n - 9 floats per lane (2415 at n = 101, ~47 us at B = 16384 and
// 3.35 TB/s); ~190 flops per row are ~5 us at 67 TFLOP/s float32, so the
// function is bound by bytes.  This simple design also streams C and y
// through L2 and device memory, and each thread's chains of dependent row
// loads run at memory latency with ~124 threads per SM at B = 16384.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kBlock = 64;

struct M3 {
  float m[3][3];
};
struct V3 {
  float v[3];
};

__device__ __forceinline__ M3 load_m(const float* __restrict__ p, int i,
                                     size_t B, int b) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = p[((size_t)i * 9 + a * 3 + c) * B + b];
  return r;
}

__device__ __forceinline__ void store_m(float* __restrict__ p, int i,
                                        size_t B, int b, const M3& x) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) p[((size_t)i * 9 + a * 3 + c) * B + b] = x.m[a][c];
}

__device__ __forceinline__ V3 load_v(const float* __restrict__ p, int i,
                                     size_t B, int b) {
  V3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a) r.v[a] = p[((size_t)i * 3 + a) * B + b];
  return r;
}

__device__ __forceinline__ void store_v(float* __restrict__ p, int i,
                                        size_t B, int b, const V3& x) {
#pragma unroll
  for (int a = 0; a < 3; ++a) p[((size_t)i * 3 + a) * B + b] = x.v[a];
}

__device__ __forceinline__ M3 zero_m() {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = 0.0f;
  return r;
}

// Cofactor inverse times 1/det (block_tridiag.py _inv3_det); det out.
__device__ __forceinline__ M3 inv3(const M3& x, float& det) {
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
  det = a * A + b * B + c * C;
  const float inv_det = 1.0f / det;
  M3 r;
  r.m[0][0] = A * inv_det; r.m[0][1] = D * inv_det; r.m[0][2] = G * inv_det;
  r.m[1][0] = B * inv_det; r.m[1][1] = E * inv_det; r.m[1][2] = H * inv_det;
  r.m[2][0] = C * inv_det; r.m[2][1] = F * inv_det; r.m[2][2] = I * inv_det;
  return r;
}

// p q
__device__ __forceinline__ M3 mm(const M3& p, const M3& q) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r.m[a][c] = p.m[a][0] * q.m[0][c] + p.m[a][1] * q.m[1][c] +
                  p.m[a][2] * q.m[2][c];
  return r;
}

// p^T q
__device__ __forceinline__ M3 mtm(const M3& p, const M3& q) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r.m[a][c] = p.m[0][a] * q.m[0][c] + p.m[1][a] * q.m[1][c] +
                  p.m[2][a] * q.m[2][c];
  return r;
}

// p q^T
__device__ __forceinline__ M3 mmt(const M3& p, const M3& q) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r.m[a][c] = p.m[a][0] * q.m[c][0] + p.m[a][1] * q.m[c][1] +
                  p.m[a][2] * q.m[c][2];
  return r;
}

// p - q
__device__ __forceinline__ M3 sub_m(const M3& p, const M3& q) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = p.m[a][c] - q.m[a][c];
  return r;
}

// p v
__device__ __forceinline__ V3 mv(const M3& p, const V3& v) {
  V3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.v[a] = p.m[a][0] * v.v[0] + p.m[a][1] * v.v[1] + p.m[a][2] * v.v[2];
  return r;
}

// p^T v
__device__ __forceinline__ V3 mtv(const M3& p, const V3& v) {
  V3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.v[a] = p.m[0][a] * v.v[0] + p.m[1][a] * v.v[1] + p.m[2][a] * v.v[2];
  return r;
}

// u - v
__device__ __forceinline__ V3 sub_v(const V3& u, const V3& v) {
  V3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a) r.v[a] = u.v[a] - v.v[a];
  return r;
}

// The previous row's U, C, y of a chain (zero before its first row).
struct Carry {
  M3 u, c;
  V3 y;
};

// One left-chain row: from the carry and this row's D, U, b, the new C_i
// and y_i, and det S_i.  U_{n-1} is zero (the TPU launchers zero-pad the
// super-diagonal), so C_{n-1} = 0.

__device__ __forceinline__ void fwd_row(const float* __restrict__ diag_t,
                                        const float* __restrict__ upper_t,
                                        const float* __restrict__ b_t, int i,
                                        int n, size_t B, int b, Carry& k,
                                        float& det) {
  const M3 s = sub_m(load_m(diag_t, i, B, b), mtm(k.u, k.c));
  const M3 sinv = inv3(s, det);
  const M3 u = i < n - 1 ? load_m(upper_t, i, B, b) : zero_m();
  const V3 q = sub_v(load_v(b_t, i, B, b), mtv(k.u, k.y));
  k.c = mm(sinv, u);
  k.y = mv(sinv, q);
  k.u = u;
}

// One right-chain row k of the bidirectional solve, falling, 1 <= k <= n-1:
// from the carry U_k, C'_{k+1}, y'_{k+1} (zero past row n-1), the new C'_k
// and y'_k; the carry's U becomes U_{k-1}.  S'_k^-1 out.
__device__ __forceinline__ void right_row(const float* __restrict__ diag_t,
                                          const float* __restrict__ upper_t,
                                          const float* __restrict__ b_t, int k,
                                          size_t B, int b, Carry& r,
                                          M3& sinv) {
  float det;
  sinv = inv3(sub_m(load_m(diag_t, k, B, b), mm(r.u, r.c)), det);
  const M3 u = load_m(upper_t, k - 1, B, b);
  const V3 q = sub_v(load_v(b_t, k, B, b), mv(r.u, r.y));
  r.c = mmt(sinv, u);
  r.y = mv(sinv, q);
  r.u = u;
}

__device__ __forceinline__ V3 bwd_row(const M3& c, const V3& y,
                                      const V3& x_next) {
  return sub_v(y, mv(c, x_next));
}

__device__ __forceinline__ Carry zero_carry() {
  Carry k;
  k.u = zero_m();
  k.c = zero_m();
#pragma unroll
  for (int a = 0; a < 3; ++a) k.y.v[a] = 0.0f;
  return k;
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
  Carry l = zero_carry(), r = zero_carry();
  M3 sinv_r = zero_m();
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
  const M3 s = sub_m(sub_m(load_m(diag_t, m, Bs, b), mtm(l.u, l.c)),
                     mmt(mm(r.u, sinv_r), r.u));
  const V3 q = sub_v(sub_v(load_v(b_t, m, Bs, b), mtv(l.u, l.y)),
                     mv(r.u, r.y));
  const V3 xm = mv(inv3(s, det), q);
  store_v(x_t, m, Bs, b, xm);
  V3 xl = xm, xr = xm;
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
