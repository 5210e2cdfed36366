// Bidirectional symmetric 3x3 block-tridiagonal Thomas solve for Hopper
// (sm_90a), float32, lanes-first, one launch.  The other block-Thomas
// solves carry their own row step: the one-launch float32 solve (#4) is
// block_resident.cu, the streamed float32 one (#6) block_stream.cu and the
// streamed float64 one (#9) block_stream_dd.cu.
//
// bidi_kernel replaces openpystruct_tpu/ops/block_tridiag.py
// _thomas_kernel_bidi (pallas_block_tridiag_solve(bidi=True)): two
// elimination chains, rows [0, m) rising and rows (m, n) falling with
// m = n / 2, meet at row m and back-substitute outward.
// Left chain: S_i = D_i - U_{i-1}^T C_{i-1}, C_i = S_i^-1 U_i,
// y_i = S_i^-1 (b_i - U_{i-1}^T y_{i-1}) from zero carries.
// Right chain: S'_k = D_k - U_k C'_{k+1}, C'_k = S'_k^-1 U_{k-1}^T,
// y'_k = S'_k^-1 (b_k - U_k y'_{k+1}); meeting row:
// S_m = D_m - U_{m-1}^T C_{m-1} - (U_m S'_{m+1}^-1) U_m^T,
// x_m = S_m^-1 (b_m - U_{m-1}^T y_{m-1} - U_m y'_{m+1});
// then x_i = y_i - C_i x_{i+1} (left, falling), x_k = y'_k - C'_k x_{k-1}
// (right, rising).  The lower band is U^T (K symmetric).  Needs n >= 3.
//
// Arithmetic: the one-thread-a-lane kernel's before it, expression for
// expression (fwd_row, right_row, bwd_row, the meeting row): the cofactor
// inverse times an IEEE 1/det (block_tridiag.py _inv3_det), 3x3 products
// summed over k = 0, 1, 2, the compiler free to contract a*b+c into an FMA
// within a row as it was there.  No --use_fast_math.  Each lane is one
// thread's chain in each warp, so a NaN lane stays NaN and touches no
// other lane.
//
// Bound on an H100 SXM: a solve must read diag (B, n, 3, 3), upper (B, n-1,
// 3, 3), b (B, n, 3) once and write x (B, n, 3) once, 24n - 9 floats per
// lane (47.2 us at B = 16384, n = 101 on 3.35 TB/s); ~190 flops per row
// (~5 us at 67 TFLOP/s) are below it.  C and y of every row (12 floats a
// row and lane) go to a workspace and come back for the back sweeps: with
// them the streamed floor is 48n - 9 floats a lane (~94 us there).  The
// one-thread-a-lane kernel ran at ~5x the bound, each row's loads issued
// only after the previous row's chain, with lane-innermost copies made
// around it.  The design is #6's (block_stream.cu) with two chains:
//  - lanes-first I/O, no layout copy.  A block owns L lanes (4-32), picked
//    in C from B and the SM count as #6 picks them (every SM takes part at
//    the compaction's buckets), with thread = lane in each chain warp.
//  - two chain warps, each fed by two staging warps of its own through a
//    ring of kRingFwd tiles of kT rows in shared memory (4-byte cp.async,
//    full / empty named barriers): the left chain warp runs rows 0 .. m-1
//    rising, the right one rows n-1 .. m+1 falling from the top of its
//    tiles, so that the chain of dependent rows is half of #6's.  A right
//    tile is the contiguous run of rows [k - kT + 1, k]; its upper run
//    (U_{k-1} at row k) starts one row lower.
//  - the meeting row: the right chain warp leaves U_m, S'_{m+1}^-1 and
//    y'_{m+1} in shared memory (21 floats a lane); a named barrier joins
//    the two chain warps; the left one forms x_m from its last tile, which
//    holds row m, and hands it back through shared memory.
//  - a private workspace, lanes innermost within the block: (blocks, n, 12,
//    L), C then y, written as coalesced stores by the chains.  The block
//    reads back only what it wrote itself: a fence and a block barrier
//    order the reads after the writes, and at B <= 8192, n = 101 (<= 40
//    MB) the workspace stays in the 50 MB L2 in between.  Then both back
//    sweeps run at once, outward: per side a staging warp copies the rows
//    in reverse order of the forward sweep with 16-byte cp.async, kRingBwd
//    tiles deep, the chain warp runs them, and a writer warp stores each x
//    tile, left in one of two shared buffers, to lanes-first rows.  Row m
//    goes out with the left side's first x tile.
//  - one launch, not #6's two: the workspace's round trip stays in L2, and
//    the compaction's small buckets pay one launch of host time.
// Named barriers: 16 a block, 0 being __syncthreads'.  The forward sweep
// uses 9 (two sides x 2 slots x full / empty, the meeting), the back sweep
// 12 (two sides x 3 slots x full / empty; the x buffers are handed over
// through the same barriers: the writer arrives on "full" once a buffer is
// free and waits on "empty" for the chain's tile), after the block barrier
// that ends the forward sweep, when every phase of the first set is done.
//
// Layout: lanes-first, diag (B, n, 3, 3), upper (B, n-1, 3, 3), b and x
// (B, n, 3), contiguous; workspace (ceil(B / L), n, 12, L), which fits in
// ceil(B / 32) * 32 * n * 12 floats at every L (L divides 32).  The chain
// warps' threads past the block's lanes run a live lane's rows and store
// nothing.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kT = 8;                     // rows per staged tile
constexpr int kRun = 21 * kT;             // a lane's diag, upper, b per tile
constexpr int kPitch = kRun + 1;          // odd pitches: no bank conflicts
constexpr int kWs = 12;                   // workspace floats per row: C, y
constexpr int kPitchX = 3 * kT + 1;
constexpr int kStagers = 2;               // forward staging warps per side
constexpr int kRingFwd = 2;               // ring depths, in tiles
constexpr int kRingBwd = 3;
constexpr int kThreads = 32 * 2 * (1 + kStagers);   // 6 warps
constexpr int kCarry = 21 + 3;            // U_m, S'^-1_{m+1}, y'_{m+1}; x_m
// forward barriers: side s's slot r full / empty, the meeting
__host__ __device__ constexpr int fwd_full(int s, int r) {
  return 1 + 2 * kRingFwd * s + r;
}
__host__ __device__ constexpr int fwd_empty(int s, int r) {
  return 1 + 2 * kRingFwd * s + kRingFwd + r;
}
constexpr int kMeet = 1 + 4 * kRingFwd;
// back-sweep barriers, the same way
__host__ __device__ constexpr int bwd_full(int s, int r) {
  return 1 + 2 * kRingBwd * s + r;
}
__host__ __device__ constexpr int bwd_empty(int s, int r) {
  return 1 + 2 * kRingBwd * s + kRingBwd + r;
}
static_assert(kMeet <= 15 && bwd_empty(1, kRingBwd - 1) <= 15,
              "16 named barriers a block, 0 is __syncthreads'");

// floats of a forward ring slot, a backward ring slot, an x tile
__host__ __device__ constexpr int fwd_slot(int L) { return L * kPitch; }
__host__ __device__ constexpr int bwd_slot(int L) { return kT * kWs * L; }
__host__ __device__ constexpr int x_tile(int L) { return L * kPitchX; }
// floats of the forward rings, the back-sweep rings and x buffers (which
// reuse the same space, 16-byte aligned), and the block's whole space
__host__ __device__ constexpr int fwd_floats(int L) {
  return 2 * kRingFwd * fwd_slot(L);
}
__host__ __device__ constexpr int bwd_floats(int L) {
  return 2 * (kRingBwd * bwd_slot(L) + 2 * x_tile(L));
}
__host__ __device__ constexpr int smem_floats(int L) {
  return ((fwd_floats(L) > bwd_floats(L) ? fwd_floats(L) : bwd_floats(L)) +
          3) / 4 * 4 + kCarry * 32;
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

// One left-chain row from this row's D, U and b: the new C_i and y_i.
__device__ __forceinline__ void fwd_row(const M3& d, const M3& u,
                                        const V3& b, Carry& k) {
  float det;
  const M3 s = sub_m(d, mtm(k.u, k.c));
  const M3 sinv = inv3(s, det);
  const V3 q = sub_v(b, mtv(k.u, k.y));
  k.c = mm(sinv, u);
  k.y = mv(sinv, q);
  k.u = u;
}

// One right-chain row k, falling, from its D_k, U_{k-1} and b_k: from the
// carry U_k, C'_{k+1}, y'_{k+1} (zero past row n-1), the new C'_k and y'_k;
// the carry's U becomes U_{k-1}.  S'_k^-1 out.
__device__ __forceinline__ void right_row(const M3& d, const M3& u,
                                          const V3& b, Carry& r, M3& sinv) {
  float det;
  sinv = inv3(sub_m(d, mm(r.u, r.c)), det);
  const V3 q = sub_v(b, mv(r.u, r.y));
  r.c = mmt(sinv, u);
  r.y = mv(sinv, q);
  r.u = u;
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

// A side's forward tile c: rows [lo, lo + cnt), its upper run from row
// ulo.  Left (s = 0): rows 0 .. m rising, row m the meeting row.  Right
// (s = 1): rows n-1 .. m+1 falling, tile c the run ending at row n-1-c kT,
// its upper run one row lower (row k reads U_{k-1}).
struct Tile {
  int lo, cnt, ulo;
};
__device__ __forceinline__ Tile side_tile(int s, int c, int n, int m) {
  Tile t;
  if (s == 0) {
    t.lo = c * kT;
    t.cnt = min(kT, m + 1 - t.lo);
    t.ulo = t.lo;
  } else {
    const int hi = n - 1 - c * kT;
    t.lo = max(m + 1, hi - kT + 1);
    t.cnt = hi - t.lo + 1;
    t.ulo = t.lo - 1;
  }
  return t;
}
__device__ __forceinline__ int side_tiles(int s, int n, int m) {
  return ((s == 0 ? m + 1 : n - 1 - m) + kT - 1) / kT;
}

// Stage a tile of the block's lanes [j0, j1) into a forward slot (a
// staging warp, lane t of it): lane j's diag, upper and b rows are three
// contiguous runs, copied to slot[j * kPitch + (0, 9 kT, 18 kT) + e], 32
// consecutive floats per instruction.
__device__ __forceinline__ void stage_rows(float* slot,
                                           const float* __restrict__ diag,
                                           const float* __restrict__ upper,
                                           const float* __restrict__ rhs,
                                           int t, int b0, int j0, int j1,
                                           int n, Tile tl) {
  const int nd = 9 * tl.cnt;
  const int nb = 3 * tl.cnt;
  const float* sd = diag + ((size_t)(b0 + j0) * n + tl.lo) * 9 + t;
  const float* su = upper + ((size_t)(b0 + j0) * (n - 1) + tl.ulo) * 9 + t;
  const float* sb = rhs + ((size_t)(b0 + j0) * n + tl.lo) * 3 + t;
  float* dst = slot + j0 * kPitch + t;
  for (int j = j0; j < j1; ++j) {
#pragma unroll
    for (int e = 0; e < (9 * kT + 31) / 32; ++e) {
      if (t + 32 * e < nd) {
        cp_async4(dst + 32 * e, sd + 32 * e);
        cp_async4(dst + 9 * kT + 32 * e, su + 32 * e);
      }
    }
#pragma unroll
    for (int e = 0; e < (3 * kT + 31) / 32; ++e)
      if (t + 32 * e < nb) cp_async4(dst + 18 * kT + 32 * e, sb + 32 * e);
    sd += 9 * (size_t)n;
    su += 9 * (size_t)(n - 1);
    sb += 3 * (size_t)n;
    dst += kPitch;
  }
}

// Warps 0 and 1 are the left and right chains.  Forward sweep: warps 2-3
// stage the left side's tiles, 4-5 the right side's.  Back sweep: warps 2
// and 3 stage the left and right sides' workspace tiles, warps 4 and 5
// write their x tiles.
template <int L>
__global__ void __launch_bounds__(kThreads, 2)
bidi_kernel(const float* __restrict__ diag, const float* __restrict__ upper,
            const float* __restrict__ rhs, float* __restrict__ ws,
            float* __restrict__ x, int B, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // U_m, S'^-1_{m+1}, y'_{m+1} (the right chain's carry), then x_m, each
  // component as 32 consecutive floats
  float* carry = smem + smem_floats(L) - kCarry * 32;
  const int t = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int b0 = blockIdx.x * L;
  const int lanes = min(L, B - b0);
  const int m = n / 2;
  const int tc = min(t, L - 1);
  const bool live = t < lanes;
  float* wb = ws + (size_t)blockIdx.x * n * kWs * L;

  // ---- forward sweep ----------------------------------------------------
  if (warp >= 2) {  // a staging warp of side s
    constexpr int R = kRingFwd;
    constexpr int kShare = (L + kStagers - 1) / kStagers;
    const int s = (warp - 2) / kStagers;
    const int j0 = min(lanes, ((warp - 2) % kStagers) * kShare);
    const int j1 = min(lanes, j0 + kShare);
    const int ntiles = side_tiles(s, n, m);
    float* ring = smem + s * R * fwd_slot(L);
    auto stage = [&](int c) {
      stage_rows(ring + (c % R) * fwd_slot(L), diag, upper, rhs, t, b0, j0,
                 j1, n, side_tile(s, c, n, m));
    };
#pragma unroll
    for (int c = 0; c < R - 1; ++c) {
      if (c < ntiles) stage(c);
      cp_async_commit();
    }
    for (int c = 0; c < ntiles; ++c) {
      cp_async_wait<R - 2>();
      bar_arrive<32 * (1 + kStagers)>(fwd_full(s, c % R));
      const int next = c + R - 1;
      if (next < ntiles) {
        if (c >= 1)
          bar_sync<32 * (1 + kStagers)>(fwd_empty(s, (c - 1) % R));
        stage(next);
      }
      cp_async_commit();
    }
    cp_async_wait<0>();
  } else {  // a chain warp: side s = warp
    constexpr int R = kRingFwd;
    const int s = warp;
    const int ntiles = side_tiles(s, n, m);
    const float* ring = smem + s * R * fwd_slot(L);
    Carry k;
    k.u = zero_m();
    k.c = zero_m();
#pragma unroll
    for (int a = 0; a < 3; ++a) k.y.v[a] = 0.0f;
    M3 sinv_r = zero_m();
    const float* row = nullptr;
    for (int c = 0; c < ntiles; ++c) {
      bar_sync<32 * (1 + kStagers)>(fwd_full(s, c % R));
      row = ring + (c % R) * fwd_slot(L) + tc * kPitch;
      const Tile tl = side_tile(s, c, n, m);
      // store C, y of row i to the workspace
      auto put = [&](int i) {
        if (live) {
          float* wr = wb + (size_t)i * kWs * L + t;
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int cc = 0; cc < 3; ++cc) wr[(a * 3 + cc) * L] = k.c.m[a][cc];
#pragma unroll
          for (int a = 0; a < 3; ++a) wr[(9 + a) * L] = k.y.v[a];
        }
      };
      // The row loops are unrolled four rows deep: eight deep, the two
      // chains' loops made every row ~1.6-1.8x slower where the chain sets
      // the pace (512-2048 lanes), rolled ~1.1-1.2x (PERF.md, #5)
      if (s == 0) {  // rows lo .. lo + cnt - 1 rising, all but row m
#pragma unroll 4
        for (int r = 0; r < min(tl.cnt, m - tl.lo); ++r) {
          fwd_row(read_m(row + 9 * r), read_m(row + 9 * kT + 9 * r),
                  read_v(row + 18 * kT + 3 * r), k);
          put(tl.lo + r);
        }
      } else {  // rows hi .. lo falling, from the top of the tile
#pragma unroll 4
        for (int r = tl.cnt - 1; r >= 0; --r) {
          right_row(read_m(row + 9 * r), read_m(row + 9 * kT + 9 * r),
                    read_v(row + 18 * kT + 3 * r), k, sinv_r);
          put(tl.lo + r);
        }
      }
      if (c + R < ntiles)
        bar_arrive<32 * (1 + kStagers)>(fwd_empty(s, c % R));
    }
    if (s == 1) {  // the right chain's carry at row m + 1, for the meeting
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          carry[(a * 3 + cc) * 32 + t] = k.u.m[a][cc];
          carry[(9 + a * 3 + cc) * 32 + t] = sinv_r.m[a][cc];
        }
#pragma unroll
      for (int a = 0; a < 3; ++a) carry[(18 + a) * 32 + t] = k.y.v[a];
      bar_arrive<64>(kMeet);
    } else {  // the meeting row: k holds U_{m-1}, C_{m-1}, y_{m-1}
      bar_sync<64>(kMeet);
      M3 ru, rs;
      V3 ry;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int cc = 0; cc < 3; ++cc) {
          ru.m[a][cc] = carry[(a * 3 + cc) * 32 + t];
          rs.m[a][cc] = carry[(9 + a * 3 + cc) * 32 + t];
        }
#pragma unroll
      for (int a = 0; a < 3; ++a) ry.v[a] = carry[(18 + a) * 32 + t];
      // row m lies in the left side's last tile
      const int r = m - side_tile(0, ntiles - 1, n, m).lo;
      const M3 sm = sub_m(sub_m(read_m(row + 9 * r), mtm(k.u, k.c)),
                          mmt(mm(ru, rs), ru));
      const V3 q = sub_v(sub_v(read_v(row + 18 * kT + 3 * r),
                               mtv(k.u, k.y)),
                         mv(ru, ry));
      float det;
      const V3 xm = mv(inv3(sm, det), q);
#pragma unroll
      for (int a = 0; a < 3; ++a) carry[(21 + a) * 32 + t] = xm.v[a];
    }
    // the workspace rows at L2 before any warp of the block reads them
    __threadfence();
  }
  __syncthreads();

  // ---- back sweeps, both sides at once, outward ---------------------------
  // side s's step j runs its forward tile c = ntiles - 1 - j: left tiles
  // fall from row m, right tiles rise from row m + 1
  constexpr int R = kRingBwd;
  constexpr int kSide = 96;   // chain, stager and writer of one side
  const int s = warp < 2 ? warp : (warp - 2) % 2;
  const int ntiles = side_tiles(s, n, m);
  float* ring = smem + s * R * bwd_slot(L);
  float* xs = smem + 2 * R * bwd_slot(L) + s * 2 * x_tile(L);

  if (warp == 2 || warp == 3) {  // a stager
    auto stage = [&](int j) {
      const Tile tl = side_tile(s, ntiles - 1 - j, n, m);
      const int quads = tl.cnt * (kWs * L / 4);
      const float* src = wb + (size_t)tl.lo * kWs * L;
      float* dst = ring + (j % R) * bwd_slot(L);
      for (int q = t; q < quads; q += 32) cp_async16(dst + 4 * q, src + 4 * q);
    };
#pragma unroll
    for (int j = 0; j < R - 1; ++j) {
      if (j < ntiles) stage(j);
      cp_async_commit();
    }
    for (int j = 0; j < ntiles; ++j) {
      cp_async_wait<R - 2>();
      bar_arrive<kSide>(bwd_full(s, j % R));
      if (j >= 1) bar_sync<kSide>(bwd_empty(s, (j - 1) % R));
      if (j + R - 1 < ntiles) stage(j + R - 1);
      cp_async_commit();
    }
    bar_sync<kSide>(bwd_empty(s, (ntiles - 1) % R));
    return;
  }
  if (warp >= 4) {  // an x writer
    for (int j = 0; j < 2 && j < ntiles; ++j)
      bar_arrive<kSide>(bwd_full(s, j % R));
    for (int j = 0; j < ntiles; ++j) {
      const Tile tl = side_tile(s, ntiles - 1 - j, n, m);
      bar_sync<kSide>(bwd_empty(s, j % R));
      // lane i's rows lo .. lo + cnt - 1 of x are 3 cnt contiguous floats
      if (t < 3 * tl.cnt) {
        const float* src = xs + (j % 2) * x_tile(L) + t;
        float v[L];
#pragma unroll
        for (int i = 0; i < L; ++i) v[i] = src[i * kPitchX];
        float* dx = x + ((size_t)b0 * n + tl.lo) * 3 + t;
#pragma unroll
        for (int i = 0; i < L; ++i)
          if (i < lanes) dx[(size_t)i * 3 * n] = v[i];
      }
      if (j + 2 < ntiles) bar_arrive<kSide>(bwd_full(s, (j + 2) % R));
    }
    return;
  }

  // a chain: x_m from the meeting row, then outward
  V3 xv;
#pragma unroll
  for (int a = 0; a < 3; ++a) xv.v[a] = carry[(21 + a) * 32 + t];
  for (int j = 0; j < ntiles; ++j) {
    const Tile tl = side_tile(s, ntiles - 1 - j, n, m);
    bar_sync<kSide>(bwd_full(s, j % R));
    const float* tile = ring + (j % R) * bwd_slot(L) + tc;
    float* xt = xs + (j % 2) * x_tile(L) + tc * kPitchX;
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
    if (s == 0) {  // rows falling; row m, the first one, is x_m itself
      int top = tl.cnt;
      if (j == 0) {
        --top;
        if (t < L) {
#pragma unroll
          for (int a = 0; a < 3; ++a) xt[3 * top + a] = xv.v[a];
        }
      }
      if (top == kT) {
#pragma unroll
        for (int r = kT - 1; r >= 0; --r) step(r);
      } else {
#pragma unroll 1
        for (int r = top - 1; r >= 0; --r) step(r);
      }
    } else {  // rows rising
      if (tl.cnt == kT) {
#pragma unroll
        for (int r = 0; r < kT; ++r) step(r);
      } else {
#pragma unroll 1
        for (int r = 0; r < tl.cnt; ++r) step(r);
      }
    }
    bar_arrive<kSide>(bwd_empty(s, j % R));
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
// none does (#6's rule, block_stream.cu pick_lanes).
int pick_lanes(int sms, int B) {
  for (int L = 4; L < 32; L *= 2)
    if ((B + L - 1) / L <= 2 * sms) return L;
  return 32;
}

template <int L>
cudaError_t launch(const float* diag, const float* upper, const float* rhs,
                   float* ws, float* x, int B, int n, cudaStream_t st) {
  const int blocks = (B + L - 1) / L;
  const size_t bytes = (size_t)smem_floats(L) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      bidi_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  bidi_kernel<L><<<blocks, kThreads, bytes, st>>>(diag, upper, rhs, ws, x,
                                                  B, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Lanes-first float32 systems diag (B, n, 3, 3), upper (B, n-1, 3, 3), rhs
// (B, n, 3), contiguous; x (B, n, 3) out; ws of ceil(B / 32) * 32 * n * 12
// floats, 16-byte aligned.  Lanes per block are picked from B and the
// current device's SM count.  n < 3 is refused.  0 on success, else a
// CUDA error code.
int thomas_bidi_f32(const float* diag, const float* upper, const float* rhs,
                    float* ws, float* x, int B, int n, void* stream) {
  if (n < 3) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
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
