// One-launch symmetric 3x3 block-tridiagonal Thomas solve for Hopper
// (sm_90a), float32, lanes-first, C and y resident in shared memory.
//
// resident_kernel replaces openpystruct_tpu/ops/block_tridiag.py
// _thomas_kernel (launcher pallas_block_tridiag_solve): the factorization
// S_i = D_i - U_{i-1}^T C_{i-1}, C_i = S_i^-1 U_i, fused with the forward
// sweep y_i = S_i^-1 (b_i - U_{i-1}^T y_{i-1}), then the back sweep
// x_i = y_i - C_i x_{i+1} from x_{n-1} = y_{n-1}.  The lower band is U^T (K
// symmetric).  The TPU kernel kept C and y in VMEM scratch for the whole
// solve; here they stay in the block's shared memory, so the only device
// memory traffic is diag, upper and b read once and x written once.  Meshes
// too long for that go to the streamed kernel (block_stream.cu), as the TPU
// package's dispatch sends meshes past VMEM to its streamed kernel.
//
// Arithmetic: the row step below is block_tridiag.cu's (inv3, mtm, mm, mv,
// mtv, fwd_row, bwd_row) in float, expression for expression, copied as
// block_stream.cu copies it: the cofactor inverse times an IEEE 1/det
// (block_tridiag.py _inv3_det), 3x3 products summed over k = 0, 1, 2, the
// compiler free to contract a*b+c into an FMA within a row.  No
// --use_fast_math.  x comes out bitwise equal to block_stream.cu's streamed
// solve.  Each lane is one thread's chain, so a NaN lane stays NaN and
// touches no other lane.
//
// Bound on an H100 SXM: a solve must read diag (B, n, 3, 3), upper (B, n-1,
// 3, 3), b (B, n, 3) once and write x (B, n, 3) once, 24n - 9 floats per
// lane (47.2 us at B = 16384, n = 101 on 3.35 TB/s); ~190 flops per row
// (~5 us at 67 TFLOP/s) are below it.  This kernel moves exactly those
// bytes.  What bounds it instead is the chain: each lane's rows are one
// dependent recurrence on one thread (~450 cycles a row on one warp,
// block_stream.cu's forward sweep), and the lanes in flight are as many as
// the SMs' shared memory holds (12n - 9 floats of C and y per lane).  The
// design:
//  - lanes-first I/O, no layout copy.  A block owns L lanes (1-16) and one
//    chain warp, thread = lane; two staging warps copy each lane's rows of
//    diag, upper and b (contiguous runs at offsets that are not 16-byte
//    aligned in general) with 4-byte cp.async, 32 consecutive floats of one
//    lane's run per instruction, into a ring of 2 tiles of kT rows x L
//    lanes (lane-major, odd pitch: no bank conflicts), and hand each tile
//    to the chain through named barriers as soon as its copies land; the
//    chain warp issues nothing but its rows (block_stream.cu's forward
//    staging, unchanged).
//  - C and y in dynamic shared memory.  C_i (rows 0 .. n-2) lanes
//    innermost, (n-1, 9, L); y lane-major, (L, P) with an odd pitch P >= 3n:
//    the chain's threads touch consecutive or odd-strided words, no bank
//    conflicts.  The back sweep reads them there and writes x_i over y_i.
//    Both sweeps read a row before they store the previous one, so no
//    shared load waits behind a shared store it cannot be proved apart from.
//  - x leaves through shared memory: once the back sweep is done, all three
//    warps copy the block's x, L lanes x 3n floats that are one contiguous
//    run of lanes-first x, with coalesced stores.
//  - L chosen at launch from B, n and the card: where every lane fits one
//    block per SM, the fewest lanes per block that do (every SM takes part);
//    else the L whose blocks, as many to an SM as shared memory, registers
//    and warps allow, take the fewest rounds, ties to the larger L (fewer
//    chain warps issue the same rows).  At most 16 lanes a block.  What
//    this design cannot change: a round is as long as the chain, so past
//    one round #4 is slower than the streamed kernel, whose workspace in
//    device memory lets 128 lanes an SM be in flight (PERF.md, #4;
//    block_tridiag.uses_streamed dispatches on it).  A block needs
//    4 L (2 kPitch + 9 (n - 1) + P) bytes; past the 227 KB a block may hold
//    at L = 1 (n ~ 4,800) the launch returns an error.
//
// Layout: lanes-first, diag (B, n, 3, 3), upper (B, n-1, 3, 3), b and x
// (B, n, 3), contiguous.  The chain warp's threads past the block's lanes
// run the chain on the last live lane's rows and store nothing.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int kT = 8;                     // rows per staged tile
constexpr int kRun = 21 * kT;             // a lane's diag, upper, b per tile
constexpr int kPitch = kRun + 1;          // odd pitch: no bank conflicts
constexpr int kStagers = 2;               // staging warps
constexpr int kRing = 2;                  // ring depth, in tiles
constexpr int kThreads = 32 * (1 + kStagers);
// named barriers (0 is __syncthreads'): ring slot s full / empty
constexpr int kFull = 1, kEmpty = 1 + kRing;

// y's pitch per lane, odd; the shared floats of a block of L lanes
__host__ __device__ inline int y_pitch(int n) { return 3 * n | 1; }
__host__ __device__ inline size_t block_floats(int L, int n) {
  return (size_t)L * (kRing * kPitch + 9 * (n - 1) + y_pitch(n));
}

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

// Stage rows [i0, i0 + kT) of the block's lanes [j0, j1) into a ring slot
// (a staging warp, lane t of it): lane j's diag, upper and b rows are three
// contiguous runs (upper stops at row n - 2), copied to slot[j * kPitch +
// (0, 9 kT, 18 kT) + e], 32 consecutive floats per instruction.
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

// The whole solve of L lanes.  Warp 0 is the chain; the kStagers staging
// warps, each over its share of the lanes, keep R - 1 tiles in flight: they
// hand tile c over as soon as its copies have landed (kFull), then refill
// the slot tile c - 1 used once the chain has read it (kEmpty).  The chain
// runs the forward sweep into shared C and y, then the back sweep, x over
// y; then every warp copies x out.
__global__ void __launch_bounds__(kThreads)
resident_kernel(const float* __restrict__ diag,
                const float* __restrict__ upper,
                const float* __restrict__ rhs, float* __restrict__ x, int B,
                int n, int L) {
  constexpr int R = kRing;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);
  const int slot = L * kPitch;
  float* cs = ring + R * slot;               // C: (n - 1, 9, L)
  float* ys = cs + (size_t)9 * (n - 1) * L;  // y, then x: (L, P)
  const int P = y_pitch(n);
  const int t = threadIdx.x % 32;
  const int b0 = blockIdx.x * L;
  const int lanes = min(L, B - b0);
  const int ntiles = (n + kT - 1) / kT;

  if (threadIdx.x >= 32) {  // a staging warp
    const int share = (L + kStagers - 1) / kStagers;
    const int j0 = min(lanes, ((int)threadIdx.x / 32 - 1) * share);
    const int j1 = min(lanes, j0 + share);
    auto stage = [&](int k) {
      stage_rows(ring + (k % R) * slot, diag, upper, rhs, t, b0, j0, j1, n,
                 k * kT);
    };
#pragma unroll
    for (int k = 0; k < R - 1; ++k) {
      if (k < ntiles) stage(k);
      cp_async_commit();
    }
    for (int c = 0; c < ntiles; ++c) {
      cp_async_wait<R - 2>();
      bar_arrive<kThreads>(kFull + c % R);
      const int next = c + R - 1;
      if (next < ntiles) {
        if (c >= 1) bar_sync<kThreads>(kEmpty + (c - 1) % R);
        stage(next);
      }
      cp_async_commit();
    }
  } else {
    const bool live = t < lanes;
    const int tc = min(t, lanes - 1);
    float* c_lane = cs + tc;       // C_i of this lane: c_lane[(9 i + e) L]
    float* y_lane = ys + tc * P;   // y_i of this lane: y_lane[3 i + a]
    Carry k;
    k.u = zero_m();
    k.c = zero_m();
#pragma unroll
    for (int a = 0; a < 3; ++a) k.y.v[a] = 0.0f;
    float det;
    for (int tile = 0; tile < ntiles; ++tile) {
      bar_sync<kThreads>(kFull + tile % R);
      const float* row = ring + (tile % R) * slot + tc * kPitch;
      const int i0 = tile * kT;
      const int cnt = min(kT, n - i0);
      // each row's D, U and b are read before the previous row's C and y
      // are stored, so no shared load waits behind a shared store
      auto read = [&](int r, M3& d, M3& u, V3& bv) {
        d = read_m(row + 9 * r);
        u = i0 + r < n - 1 ? read_m(row + 9 * kT + 9 * r) : zero_m();
        bv = read_v(row + 18 * kT + 3 * r);
      };
      M3 d, u;
      V3 bv;
      read(0, d, u, bv);
      auto step = [&](int r) {
        const int i = i0 + r;
        M3 d1, u1;
        V3 b1;
        read(min(r + 1, cnt - 1), d1, u1, b1);
        fwd_row(d, u, bv, k, det);
        if (live) {
          if (i < n - 1) {
            float* cr = c_lane + (size_t)i * 9 * L;
#pragma unroll
            for (int a = 0; a < 3; ++a)
#pragma unroll
              for (int c = 0; c < 3; ++c) cr[(a * 3 + c) * L] = k.c.m[a][c];
          }
#pragma unroll
          for (int a = 0; a < 3; ++a) y_lane[3 * i + a] = k.y.v[a];
        }
        d = d1;
        u = u1;
        bv = b1;
      };
      if (cnt == kT) {
#pragma unroll
        for (int r = 0; r < kT; ++r) step(r);
      } else {
#pragma unroll 1
        for (int r = 0; r < cnt; ++r) step(r);
      }
      if (tile + R < ntiles) bar_arrive<kThreads>(kEmpty + tile % R);
    }
    // back sweep: x_{n-1} = y_{n-1} stays where it is; row i - 1's C and y
    // are read before x_i is stored over y_i
    V3 xv = k.y;
    auto read_cy = [&](int i, M3& c, V3& y) {
      const float* cr = c_lane + (size_t)i * 9 * L;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) c.m[a][cc] = cr[(a * 3 + cc) * L];
      y = read_v(y_lane + 3 * i);
    };
    M3 c;
    V3 y;
    if (n >= 2) read_cy(n - 2, c, y);
#pragma unroll 4
    for (int i = n - 2; i >= 0; --i) {
      M3 c1;
      V3 y1;
      read_cy(max(i - 1, 0), c1, y1);
      xv = bwd_row(c, y, xv);
      if (live) {
#pragma unroll
        for (int a = 0; a < 3; ++a) y_lane[3 * i + a] = xv.v[a];
      }
      c = c1;
      y = y1;
    }
  }
  __syncthreads();
  // lane j's x is 3n contiguous floats of lanes-first x, the block's lanes
  // one run
  const int m = 3 * n;
  float* xb = x + (size_t)b0 * m;
  for (int j = 0; j < lanes; ++j)
    for (int r = threadIdx.x; r < m; r += kThreads)
      xb[(size_t)j * m + r] = ys[j * P + r];
}

// What the launcher needs of the current device, read once per device.
struct Card {
  int sms, smem_sm, smem_block, reserved, regs;
};

cudaError_t card(Card& out) {
  static Card cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Card& c = cache[dev];
  if (c.sms == 0) {
    Card r;
    cudaFuncAttributes fa;
    if ((err = cudaDeviceGetAttribute(
             &r.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev)) !=
            cudaSuccess ||
        (err = cudaDeviceGetAttribute(&r.smem_block,
                                      cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&r.reserved,
                                      cudaDevAttrReservedSharedMemoryPerBlock,
                                      dev)) != cudaSuccess ||
        (err = cudaFuncGetAttributes(&fa, resident_kernel)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             resident_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             r.smem_block)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&r.sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return err;
    r.regs = fa.numRegs;
    c = r;
  }
  out = c;
  return cudaSuccess;
}

// Blocks of L lanes an SM holds at once: by shared memory, by registers
// (allocated per warp in units of 256), by warps (64) and blocks (32).
int blocks_per_sm(const Card& c, int L, int n) {
  const size_t bytes = block_floats(L, n) * sizeof(float) + c.reserved;
  const int warp_regs = (c.regs * 32 + 255) / 256 * 256;
  int k = (int)(c.smem_sm / bytes);
  k = std::min(k, 65536 / (warp_regs * (kThreads / 32)));
  k = std::min(k, 64 / (kThreads / 32));
  return std::min(k, 32);
}

// Lanes per block (PERF.md, #4), at most 16 (two blocks of 16 lanes an SM
// ran 1-14% faster than one of 32 where lanes take several rounds): 0 when
// not one lane fits a block.
int pick_lanes(const Card& c, int B, int n) {
  int lmax = 16;
  while (lmax > 0 &&
         block_floats(lmax, n) * sizeof(float) > (size_t)c.smem_block)
    --lmax;
  if (lmax == 0) return 0;
  const int spread = (B + c.sms - 1) / c.sms;  // one block per SM
  if (spread <= lmax) return spread;
  int best = lmax;
  long best_rounds = -1;
  for (int L = lmax; L >= 1; --L) {
    const long slots = (long)c.sms * blocks_per_sm(c, L, n);
    if (slots == 0) continue;
    const long rounds = ((B + L - 1) / L + slots - 1) / slots;
    if (best_rounds < 0 || rounds < best_rounds) {
      best_rounds = rounds;
      best = L;
    }
  }
  return best;
}

}  // namespace

extern "C" {

// Lanes per block the launcher picks for B lanes of n rows on the current
// device: 0 when one lane does not fit a block's shared memory, a negative
// CUDA error code on failure.
int thomas_resident_lanes(int B, int n) {
  if (B <= 0 || n <= 0) return 0;
  Card c;
  const cudaError_t err = card(c);
  if (err != cudaSuccess) return -(int)err;
  return pick_lanes(c, B, n);
}

// Lanes-first float32 systems diag (B, n, 3, 3), upper (B, n-1, 3, 3), rhs
// (B, n, 3), contiguous; x (B, n, 3) out.  0 on success, else a CUDA error
// code (cudaErrorInvalidValue where one lane's C and y do not fit a block).
int thomas_resident_f32(const float* diag, const float* upper,
                        const float* rhs, float* x, int B, int n,
                        void* stream) {
  if (B <= 0 || n <= 0) return 0;
  Card c;
  const cudaError_t err = card(c);
  if (err != cudaSuccess) return (int)err;
  const int L = pick_lanes(c, B, n);
  if (L == 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = block_floats(L, n) * sizeof(float);
  resident_kernel<<<(B + L - 1) / L, kThreads, bytes,
                    (cudaStream_t)stream>>>(diag, upper, rhs, x, B, n, L);
  return (int)cudaGetLastError();
}

}  // extern "C"
