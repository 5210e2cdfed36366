// Symmetric 3x3 block-tridiagonal Thomas solves for Hopper (sm_90a), one
// thread per system (lane).
//
// thomas_kernel replaces openpystruct_tpu/ops/block_tridiag.py
// _thomas_kernel (launcher pallas_block_tridiag_solve): factorization
// S_i = D_i - U_{i-1}^T C_{i-1}, C_i = S_i^-1 U_i, fused with the forward
// sweep y_i = S_i^-1 (b_i - U_{i-1}^T y_{i-1}), then the back sweep
// x_i = y_i - C_i x_{i+1}.  The lower band is U^T (K symmetric).
//
// thomas_fwd_kernel and thomas_bwd_kernel replace
// openpystruct_tpu/ops/block_stream.py _fwd_kernel and _bwd_kernel
// (launcher pallas_block_tridiag_solve_streamed): the same recurrence split
// into two launches, the forward one writing C and y to device memory and
// the backward one reading them back in reverse.  The carries (C, y, U of
// the previous row; x of the next) start at zero, so row 0 and row n-1 fall
// out of the generic step as in the TPU kernels, with the same arithmetic
// as thomas_kernel.  The TPU kernels' 64-node chunks existed to stream
// through VMEM; here each thread walks all n rows, so there are no chunks.
//
// Arithmetic order is the TPU kernels': the cofactor inverse times 1/det
// (block_tridiag.py _inv3_det), 3x3 products summed over k = 0, 1, 2.  The
// compiler may contract products and sums into FMAs.
//
// Layout: lane-innermost, diag (n, 3, 3, B), upper (n-1, 3, 3, B), b and x
// (n, 3, B), C (n, 3, 3, B) workspace or output, y (n, 3, B): neighbouring
// threads read neighbouring addresses.  A bounds check retires the threads
// past B, so no lane is padded (the TPU launchers' identity-padded lanes).
//
// Bound on an H100 SXM: each solve must read diag, upper, b once and write
// x once, 24n - 9 floats per lane (2415 at n = 101, ~47 us at B = 16384 and
// 3.35 TB/s); ~190 flops per row are ~5 us at 67 TFLOP/s float32, so the
// function is bound by bytes.  This simple design also streams C (and, in
// the two-launch version, y) through L2 and device memory, and each
// thread's chain of dependent row loads runs at memory latency with ~124
// threads per SM at B = 16384.

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

// Cofactor inverse times 1/det (block_tridiag.py _inv3_det).
__device__ __forceinline__ M3 inv3(const M3& x) {
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
  const float det = a * A + b * B + c * C;
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

// One forward row: from the previous row's U, C, y (zero before row 0) and
// this row's D, U, b, the new C_i and y_i.  U_{n-1} is zero (the TPU
// launchers zero-pad the super-diagonal), so C_{n-1} = 0.
struct Carry {
  M3 u, c;
  V3 y;
};

__device__ __forceinline__ void fwd_row(const float* __restrict__ diag_t,
                                        const float* __restrict__ upper_t,
                                        const float* __restrict__ b_t, int i,
                                        int n, size_t B, int b, Carry& k) {
  const M3 d = load_m(diag_t, i, B, b);
  const M3 uc = mtm(k.u, k.c);
  M3 s;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) s.m[a][c] = d.m[a][c] - uc.m[a][c];
  const M3 sinv = inv3(s);
  const M3 u = i < n - 1 ? load_m(upper_t, i, B, b) : zero_m();
  const V3 bi = load_v(b_t, i, B, b);
  const V3 uy = mtv(k.u, k.y);
  V3 q;
#pragma unroll
  for (int a = 0; a < 3; ++a) q.v[a] = bi.v[a] - uy.v[a];
  k.c = mm(sinv, u);
  k.y = mv(sinv, q);
  k.u = u;
}

__device__ __forceinline__ V3 bwd_row(const M3& c, const V3& y,
                                      const V3& x_next) {
  const V3 cx = mv(c, x_next);
  V3 x;
#pragma unroll
  for (int a = 0; a < 3; ++a) x.v[a] = y.v[a] - cx.v[a];
  return x;
}

__device__ __forceinline__ Carry zero_carry() {
  Carry k;
  k.u = zero_m();
  k.c = zero_m();
#pragma unroll
  for (int a = 0; a < 3; ++a) k.y.v[a] = 0.0f;
  return k;
}

// One launch: y goes into x, C into the (n-1, 3, 3, B) workspace, then the
// back sweep overwrites x in place.
__global__ void __launch_bounds__(kBlock)
thomas_kernel(const float* __restrict__ diag_t,
              const float* __restrict__ upper_t,
              const float* __restrict__ b_t, float* __restrict__ x_t,
              float* __restrict__ c_ws, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  Carry k = zero_carry();
  for (int i = 0; i < n; ++i) {
    fwd_row(diag_t, upper_t, b_t, i, n, Bs, b, k);
    if (i < n - 1) store_m(c_ws, i, Bs, b, k.c);
    store_v(x_t, i, Bs, b, k.y);
  }
  V3 x = k.y;  // x_{n-1} = y_{n-1}
  for (int i = n - 2; i >= 0; --i) {
    x = bwd_row(load_m(c_ws, i, Bs, b), load_v(x_t, i, Bs, b), x);
    store_v(x_t, i, Bs, b, x);
  }
}

// Streamed forward sweep: C (n, 3, 3, B) and y (n, 3, B) to device memory.
__global__ void __launch_bounds__(kBlock)
thomas_fwd_kernel(const float* __restrict__ diag_t,
                  const float* __restrict__ upper_t,
                  const float* __restrict__ b_t, float* __restrict__ c_t,
                  float* __restrict__ y_t, int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  Carry k = zero_carry();
  for (int i = 0; i < n; ++i) {
    fwd_row(diag_t, upper_t, b_t, i, n, Bs, b, k);
    store_m(c_t, i, Bs, b, k.c);
    store_v(y_t, i, Bs, b, k.y);
  }
}

// Streamed backward sweep, rows in reverse from a zero x carry.
__global__ void __launch_bounds__(kBlock)
thomas_bwd_kernel(const float* __restrict__ c_t,
                  const float* __restrict__ y_t, float* __restrict__ x_t,
                  int B, int n) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = (size_t)B;
  V3 x;
#pragma unroll
  for (int a = 0; a < 3; ++a) x.v[a] = 0.0f;
  for (int i = n - 1; i >= 0; --i) {
    x = bwd_row(load_m(c_t, i, Bs, b), load_v(y_t, i, Bs, b), x);
    store_v(x_t, i, Bs, b, x);
  }
}

}  // namespace

extern "C" {

int thomas_f32(const float* diag_t, const float* upper_t, const float* b_t,
               float* x_t, float* c_ws, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  const int blocks = (B + kBlock - 1) / kBlock;
  thomas_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      diag_t, upper_t, b_t, x_t, c_ws, B, n);
  return (int)cudaGetLastError();
}

int thomas_streamed_f32(const float* diag_t, const float* upper_t,
                        const float* b_t, float* c_t, float* y_t, float* x_t,
                        int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  const int blocks = (B + kBlock - 1) / kBlock;
  thomas_fwd_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      diag_t, upper_t, b_t, c_t, y_t, B, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  thomas_bwd_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      c_t, y_t, x_t, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
