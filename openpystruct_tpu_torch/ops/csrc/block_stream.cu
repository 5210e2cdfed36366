// Streamed symmetric 3x3 block-tridiagonal Thomas solve for Hopper (sm_90a),
// float32, lanes-first.
//
// stream_fwd_kernel and stream_bwd_kernel replace
// openpystruct_tpu/ops/block_stream.py _fwd_kernel and _bwd_kernel
// (launcher pallas_block_tridiag_solve_streamed).  The forward launch runs
// the factorization fused with the forward sweep from zero carries,
// S_i = D_i - U_{i-1}^T C_{i-1}, C_i = S_i^-1 U_i (U_{n-1} = 0, so C_{n-1}
// = 0), y_i = S_i^-1 (b_i - U_{i-1}^T y_{i-1}), and writes C and y to
// device memory; the backward launch reads them back in reverse,
// x_i = y_i - C_i x_{i+1} from x_n = 0.  The lower band is U^T (K
// symmetric).  The TPU kernels' 64-node chunks streamed through VMEM; here
// each lane's thread walks all n rows.
//
// Arithmetic: the row step below is block_tridiag.cu's (inv3, mtm, mm, mv,
// mtv, fwd_row, bwd_row) in float, expression for expression: the cofactor
// inverse times an IEEE 1/det (block_tridiag.py _inv3_det), 3x3 products
// summed over k = 0, 1, 2, the compiler free to contract a*b+c into an FMA
// within a row as it is there.  No --use_fast_math.  x comes out bitwise
// equal to block_resident.cu's one-launch solve.  Each lane is one thread's
// chain, so a NaN lane stays NaN and touches no other lane.
//
// Bound on an H100 SXM: a solve must read diag (B, n, 3, 3), upper (B, n-1,
// 3, 3), b (B, n, 3) once and write x (B, n, 3) once, 24n - 9 floats per
// lane (47.2 us at B = 16384, n = 101 on 3.35 TB/s); ~190 flops per row
// (~5 us at 67 TFLOP/s) are below it.  The streamed contract adds the
// workspace, C and y (12 floats per row and lane) written by the forward
// launch and read by the backward one: 79 MB at B = 16384, n = 101, another
// ~24 us each way from device memory, more than the 50 MB L2 holds; at
// B <= 8192 (<= 40 MB) the backward launch, which reads the rows written
// last first, finds much of it in L2.  What kept the lane-per-thread kernel
// it replaces at ~6x that bound was latency: each row's 21 loads were issued
// only after the previous row's chain was done, one memory round trip per
// row and sweep, with lane-innermost copies made around it.  The design:
//  - lanes-first I/O, no layout copy.  A block owns L lanes (4-32) and one
//    chain warp, thread = lane.  A lane's rows lie contiguous in diag, upper
//    and b (9n, 9(n-1), 3n floats), at offsets that are not 16-byte aligned
//    in general (36n bytes per lane), so staging warps copy them with 4-byte
//    cp.async, 32 consecutive floats of one lane's run per instruction:
//    coalesced 128-byte accesses, addresses advanced once per lane and tile.
//  - rows staged ahead of the chain, by other warps.  A ring of R tiles of
//    kT rows x L lanes in shared memory (lane-major, odd pitch: no bank
//    conflicts); kStagers staging warps hand a tile to the chain through
//    named barriers as soon as its copies land and refill a slot once the
//    chain has read it, so the chain warp issues nothing but its rows.
//  - L chosen at launch from B and the card's SM count: the fewest lanes
//    per block whose blocks fit two to an SM, so that at the compaction's
//    buckets (512-2048 lanes) every SM takes part and each one's memory
//    pipe serves fewer lanes (the backward launch, which waits on that
//    pipe, ran 1.7-1.9x faster at 512 lanes with L = 4 than with 32).  The
//    rings are fixed: 2 tiles forward (3 and 4 measured no faster: the
//    chain, not the copies, sets the forward launch's pace), 4 backward
//    (2 measured up to 12% slower); four blocks of 32 lanes fit an SM's
//    shared memory in either launch.
//  - a private workspace, lanes innermost within the block: (blocks, n, 12,
//    L), C then y.  The forward chain writes each component as one
//    coalesced store; in the backward launch one warp stages a tile of kT
//    rows as one contiguous run with 16-byte cp.async, R tiles deep, in
//    reverse, the chain runs the rows, and a third warp writes each x tile,
//    left in one of two shared buffers, to lanes-first rows.
//
// Layout: lanes-first, diag (B, n, 3, 3), upper (B, n-1, 3, 3), b and x
// (B, n, 3), contiguous; workspace (ceil(B / L), n, 12, L), which fits in
// ceil(B / 32) * 32 * n * 12 floats at every L (L divides 32).  The chain
// warp's threads past the block's lanes run the chain on a live lane's tile
// and store nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kT = 8;                     // rows per staged tile
constexpr int kRun = 21 * kT;             // a lane's diag, upper, b per tile
constexpr int kPitch = kRun + 1;          // odd pitches: no bank conflicts
constexpr int kWs = 12;                   // workspace floats per row: C, y
constexpr int kPitchX = 3 * kT + 1;
constexpr int kStagers = 2;               // forward staging warps
constexpr int kRingFwd = 2;               // ring depths, in tiles
constexpr int kRingBwd = 4;
constexpr int kFwdThreads = 32 * (1 + kStagers);
constexpr int kBwdThreads = 3 * 32;       // chain, stager, x writer
// named barriers (0 is __syncthreads'): ring slot s full / empty, x tile
// buffer full / empty
constexpr int kFull = 1, kEmpty = 5, kXFull = 9, kXEmpty = 11;

// floats of a forward ring slot, a backward ring slot, an x tile
__host__ __device__ constexpr int fwd_slot(int L) { return L * kPitch; }
__host__ __device__ constexpr int bwd_slot(int L) { return kT * kWs * L; }
__host__ __device__ constexpr int x_tile(int L) { return L * kPitchX; }

struct M3 {
  float m[3][3];
};
struct V3 {
  float v[3];
};

__device__ __forceinline__ M3 read_m(const float* p) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = p[a * 3 + c];
  return r;
}

__device__ __forceinline__ V3 read_v(const float* p) {
  V3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a) r.v[a] = p[a];
  return r;
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

// The previous row's U, C, y (zero before row 0).
struct Carry {
  M3 u, c;
  V3 y;
};

// One forward row from this row's D, U (zero at row n - 1) and b: the new
// C_i, y_i and det S_i.
__device__ __forceinline__ void fwd_row(const M3& d, const M3& u,
                                        const V3& b, Carry& k, float& det) {
  const M3 s = sub_m(d, mtm(k.u, k.c));
  const M3 sinv = inv3(s, det);
  const V3 q = sub_v(b, mtv(k.u, k.y));
  k.c = mm(sinv, u);
  k.y = mv(sinv, q);
  k.u = u;
}

__device__ __forceinline__ V3 bwd_row(const M3& c, const V3& y,
                                      const V3& x_next) {
  return sub_v(y, mv(c, x_next));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Named barriers between warps of a block; N threads take part in each.
template <int N>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// Stage rows [i0, i0 + kT) of the block's lanes [j0, j1) into a forward
// slot (a staging warp, lane t of it): lane j's diag, upper and b rows are
// three contiguous runs (upper stops at row n - 2), copied to slot[j *
// kPitch + (0, 9 kT, 18 kT) + e], 32 consecutive floats per instruction.
__device__ __forceinline__ void stage_rows(float* slot,
                                           const float* __restrict__ diag,
                                           const float* __restrict__ upper,
                                           const float* __restrict__ rhs,
                                           int t, int b0, int j0, int j1,
                                           int n, int i0) {
  const int nd = 9 * min(kT, n - i0);
  const int nu = 9 * min(kT, n - 1 - i0);
  const int nb = 3 * min(kT, n - i0);
  const float* sd = diag + ((size_t)(b0 + j0) * n + i0) * 9 + t;
  const float* su = upper + ((size_t)(b0 + j0) * (n - 1) + i0) * 9 + t;
  const float* sb = rhs + ((size_t)(b0 + j0) * n + i0) * 3 + t;
  float* dst = slot + j0 * kPitch + t;
  for (int j = j0; j < j1; ++j) {
#pragma unroll
    for (int m = 0; m < (9 * kT + 31) / 32; ++m) {
      if (t + 32 * m < nd) cp_async4(dst + 32 * m, sd + 32 * m);
      if (t + 32 * m < nu) cp_async4(dst + 9 * kT + 32 * m, su + 32 * m);
    }
#pragma unroll
    for (int m = 0; m < (3 * kT + 31) / 32; ++m)
      if (t + 32 * m < nb) cp_async4(dst + 18 * kT + 32 * m, sb + 32 * m);
    sd += 9 * (size_t)n;
    su += 9 * (size_t)(n - 1);
    sb += 3 * (size_t)n;
    dst += kPitch;
  }
}

// Forward sweep: C and y of rows 0 .. n-1 to the workspace.  Warp 0 is the
// chain; the kStagers staging warps, each over its share of the lanes, keep
// R - 1 tiles in flight: they hand tile c over as soon as its copies have
// landed (kFull), then refill the slot tile c - 1 used once the chain has
// read it (kEmpty), so the chain never waits on a refill.
template <int L>
__global__ void __launch_bounds__(kFwdThreads)
stream_fwd_kernel(const float* __restrict__ diag,
                  const float* __restrict__ upper,
                  const float* __restrict__ rhs, float* __restrict__ ws,
                  int B, int n) {
  constexpr int R = kRingFwd;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = threadIdx.x % 32;
  const int b0 = blockIdx.x * L;
  const int lanes = min(L, B - b0);
  const int ntiles = (n + kT - 1) / kT;

  if (threadIdx.x >= 32) {  // a staging warp
    constexpr int kShare = (L + kStagers - 1) / kStagers;
    const int j0 = min(lanes, ((int)threadIdx.x / 32 - 1) * kShare);
    const int j1 = min(lanes, j0 + kShare);
    auto stage = [&](int k) {
      stage_rows(smem + (k % R) * fwd_slot(L), diag, upper, rhs, t, b0, j0,
                 j1, n, k * kT);
    };
#pragma unroll
    for (int k = 0; k < R - 1; ++k) {
      if (k < ntiles) stage(k);
      cp_async_commit();
    }
    for (int c = 0; c < ntiles; ++c) {
      cp_async_wait<R - 2>();
      bar_arrive<kFwdThreads>(kFull + c % R);
      const int next = c + R - 1;
      if (next < ntiles) {
        if (c >= 1) bar_sync<kFwdThreads>(kEmpty + (c - 1) % R);
        stage(next);
      }
      cp_async_commit();
    }
    return;
  }

  const bool live = t < lanes;
  float* w = ws + (size_t)blockIdx.x * n * kWs * L + t;
  Carry k;
  k.u = zero_m();
  k.c = zero_m();
#pragma unroll
  for (int a = 0; a < 3; ++a) k.y.v[a] = 0.0f;
  float det;
  for (int tile = 0; tile < ntiles; ++tile) {
    bar_sync<kFwdThreads>(kFull + tile % R);
    const float* row =
        smem + (tile % R) * fwd_slot(L) + min(t, L - 1) * kPitch;
    const int i0 = tile * kT;
    auto step = [&](int r) {
      const int i = i0 + r;
      const M3 u = i < n - 1 ? read_m(row + 9 * kT + 9 * r) : zero_m();
      fwd_row(read_m(row + 9 * r), u, read_v(row + 18 * kT + 3 * r), k,
              det);
      if (live) {
        float* wr = w + (size_t)i * kWs * L;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) wr[(a * 3 + c) * L] = k.c.m[a][c];
#pragma unroll
        for (int a = 0; a < 3; ++a) wr[(9 + a) * L] = k.y.v[a];
      }
    };
    if (i0 + kT <= n) {
#pragma unroll
      for (int r = 0; r < kT; ++r) step(r);
    } else {
#pragma unroll 1
      for (int r = 0; r < n - i0; ++r) step(r);
    }
    if (tile + R < ntiles) bar_arrive<kFwdThreads>(kEmpty + tile % R);
  }
}

// Backward sweep, tiles in reverse: step s reads tile ntiles - 1 - s, whose
// kT rows of the block are one contiguous run of the workspace.  Warp 0 is
// the chain; warp 1 stages the workspace tiles R - 1 ahead (kFull, kEmpty,
// as in the forward sweep); warp 2 writes each finished x tile, which the
// chain leaves in one of two shared buffers (kXFull, kXEmpty), to
// lanes-first rows of x.  Each pair of warps meets on its own barriers.
template <int L>
__global__ void __launch_bounds__(kBwdThreads)
stream_bwd_kernel(const float* __restrict__ ws, float* __restrict__ x,
                  int B, int n) {
  constexpr int R = kRingBwd;
  constexpr int kPair = 64;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* xs = smem + R * bwd_slot(L);
  const int t = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int b0 = blockIdx.x * L;
  const int lanes = min(L, B - b0);
  const int ntiles = (n + kT - 1) / kT;
  auto first_row = [&](int s) { return (ntiles - 1 - s) * kT; };

  if (warp == 1) {  // the stager
    const float* wb = ws + (size_t)blockIdx.x * n * kWs * L;
    auto stage = [&](int s) {
      const int i0 = first_row(s);
      const int quads = min(kT, n - i0) * (kWs * L / 4);
      const float* src = wb + (size_t)i0 * kWs * L;
      float* dst = smem + (s % R) * bwd_slot(L);
      for (int q = t; q < quads; q += 32)
        cp_async16(dst + 4 * q, src + 4 * q);
    };
#pragma unroll
    for (int s = 0; s < R - 1; ++s) {
      if (s < ntiles) stage(s);
      cp_async_commit();
    }
    for (int s = 0; s < ntiles; ++s) {
      cp_async_wait<R - 2>();
      bar_arrive<kPair>(kFull + s % R);
      const int next = s + R - 1;
      if (next < ntiles) {
        if (s >= 1) bar_sync<kPair>(kEmpty + (s - 1) % R);
        stage(next);
      }
      cp_async_commit();
    }
    return;
  }
  if (warp == 2) {  // the x writer
    for (int s = 0; s < ntiles; ++s) {
      const int i0 = first_row(s);
      const int cnt = min(kT, n - i0);
      bar_sync<kPair>(kXFull + s % 2);
      // lane j's rows i0 .. i0 + cnt - 1 of x are 3 cnt contiguous floats
      if (t < 3 * cnt) {
        const float* src = xs + (s % 2) * x_tile(L) + t;
        float v[L];
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = src[j * kPitchX];
        float* dx = x + ((size_t)b0 * n + i0) * 3 + t;
#pragma unroll
        for (int j = 0; j < L; ++j)
          if (j < lanes) dx[(size_t)j * 3 * n] = v[j];
      }
      if (s + 2 < ntiles) bar_arrive<kPair>(kXEmpty + s % 2);
    }
    return;
  }

  V3 xv;
#pragma unroll
  for (int a = 0; a < 3; ++a) xv.v[a] = 0.0f;
  const int tc = min(t, L - 1);
  for (int s = 0; s < ntiles; ++s) {
    bar_sync<kPair>(kFull + s % R);
    if (s >= 2) bar_sync<kPair>(kXEmpty + s % 2);
    const float* tile = smem + (s % R) * bwd_slot(L) + tc;
    float* xt = xs + (s % 2) * x_tile(L) + tc * kPitchX;
    const int i0 = first_row(s);
    auto step = [&](int r) {
      const float* p = tile + r * kWs * L;
      M3 c;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) c.m[a][cc] = p[(a * 3 + cc) * L];
      V3 y;
#pragma unroll
      for (int a = 0; a < 3; ++a) y.v[a] = p[(9 + a) * L];
      xv = bwd_row(c, y, xv);
      if (t < L) {
#pragma unroll
        for (int a = 0; a < 3; ++a) xt[3 * r + a] = xv.v[a];
      }
    };
    if (i0 + kT <= n) {
#pragma unroll
      for (int r = kT - 1; r >= 0; --r) step(r);
    } else {
#pragma unroll 1
      for (int r = n - i0 - 1; r >= 0; --r) step(r);
    }
    bar_arrive<kPair>(kXFull + s % 2);
    if (s + R < ntiles) bar_arrive<kPair>(kEmpty + s % R);
  }
}

// The device's SM count, cached per device.
cudaError_t sm_count(int& out) {
  static int cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (cache[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&cache[dev],
                                    cudaDevAttrMultiProcessorCount, dev)) !=
          cudaSuccess)
    return err;
  out = cache[dev];
  return cudaSuccess;
}

// The fewest lanes per block (4-32) whose blocks fit two to an SM, 32 once
// none does (PERF.md, #6).
int pick_lanes(int sms, int B) {
  for (int L = 4; L < 32; L *= 2)
    if ((B + L - 1) / L <= 2 * sms) return L;
  return 32;
}

template <int L>
cudaError_t launch(const float* diag, const float* upper, const float* rhs,
                   float* ws, float* x, int B, int n, cudaStream_t st) {
  const int blocks = (B + L - 1) / L;
  const size_t fwd_bytes = (size_t)kRingFwd * fwd_slot(L) * sizeof(float);
  const size_t bwd_bytes =
      ((size_t)kRingBwd * bwd_slot(L) + 2 * x_tile(L)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stream_fwd_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwd_bytes);
  if (err != cudaSuccess) return err;
  stream_fwd_kernel<L><<<blocks, kFwdThreads, fwd_bytes, st>>>(
      diag, upper, rhs, ws, B, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stream_bwd_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bwd_bytes);
  if (err != cudaSuccess) return err;
  stream_bwd_kernel<L><<<blocks, kBwdThreads, bwd_bytes, st>>>(ws, x, B, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lanes-first float32 systems diag (B, n, 3, 3), upper (B, n-1, 3, 3), rhs
// (B, n, 3), contiguous; x (B, n, 3) out; ws of ceil(B / 32) * 32 * n * 12
// floats, 16-byte aligned.  Lanes per block are picked from B and the
// current device's SM count.  0 on success, else a CUDA error code.
int thomas_streamed_f32(const float* diag, const float* upper,
                        const float* rhs, float* ws, float* x, int B, int n,
                        void* stream) {
  if (B <= 0 || n <= 0) return 0;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pick_lanes(sms, B)) {
    case 4: return (int)launch<4>(diag, upper, rhs, ws, x, B, n, st);
    case 8: return (int)launch<8>(diag, upper, rhs, ws, x, B, n, st);
    case 16: return (int)launch<16>(diag, upper, rhs, ws, x, B, n, st);
    default: return (int)launch<32>(diag, upper, rhs, ws, x, B, n, st);
  }
}

}  // extern "C"
