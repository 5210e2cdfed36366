// The explicit-RHS 3-DOF beam solve for Hopper (sm_90a): fused sweeps per
// lane over read-only lanes-first float32 inputs, one chain that carries
// the axial and the bending factorization together.
//
// beam_solve_kernel replaces openpystruct_tpu/ops/beam_kernel.py:682
// _beam_kernel (launcher pallas_beam_solve): the solve of K(I) x = rhs for
// an explicit right-hand side, the reverse pass of the fused analysis.
// Stages as in the TPU kernel (_stage_stiffness, _stage_assemble with an
// explicit RHS, _stage_scale, _stage_factor with C and the fused forward
// sweep, _back_substitute, _stage_refine, _substitute_inplace).  Only the
// branch pallas_beam_solve runs is ported (explicit RHS, no force
// recovery).  The pivot is min_i |det3(S_i)| of the Jacobi-scaled
// factorization, without the bending kernels' axial-chain product.
//
// K is block-diagonal inside every 3x3 block: the assembly writes exact
// zeros at (0,1), (0,2), (1,0), (2,0) of each diagonal and coupling block,
// and scaling, Schur complements, C_i = Sinv_i U_i and the residual keep
// them for finite values.  So the system is an axial scalar chain beside a
// 2x2 bending chain, and only the right-hand side may load the axial DOFs.
// The kernel forms the nonzeros alone: per node 5 of S, Sinv and C, 15 of
// the refinement residual's 27 error-free terms.  The chain stays one: the
// cofactor inverse couples the two through det3 = a det2, so Sinv_00 =
// det2 (1/det3) and the bending entries are (a i) (1/det3) and so on.
//
// Every nonzero keeps the expression tree and the stored rounding of the
// full 3x3 kernel this one replaced (one thread a lane, a 53-float global
// workspace): its sums over k of p_ak q_kc ran as FMAs from 0 in order of
// k, so a zero leading term leaves fma(p, q, 0) on the first nonzero, and
// its det2 = e i - f h fused the first product.  The chain pins those forms
// with __fmaf_rn / __fmul_rn (nvcc contracts across basic blocks otherwise),
// and the helpers round every product the old kernel stored.  Zeros times a
// non-finite value were what spread a NaN through all three components
// there: a lane whose 1/det3 or y goes non-finite at some node now comes
// out NaN in every component, and NaN in its pivot when that node is not
// the last, as before.
//
// Bound on an H100 SXM: I, Le, free, rhs in and x, pivot out, 11n - 1
// floats per lane (1110 at n = 101, ~21.7 us at B = 16384 on 3.35 TB/s);
// the flops (~390 per node with one refinement sweep, chip_smoke.py's
// count) are below that at 67 TFLOP/s.  What keeps a kernel that walks each lane's recurrence on one
// thread from it is latency: at B = 16384 the card holds about one
// lane-warp per scheduler, so each step waits on its operands.  The design,
// the skeleton of beam_opt.cu's sweeps:
//  - fused sweeps.  The first forward sweep builds each node's scaled
//    system from the inputs, factors and substitutes forward.  Each back
//    sweep forms node i + 1's compensated residual as soon as x_i is known,
//    so a refinement is one forward and one back sweep; the last back sweep
//    unscales x and writes it.
//  - the recurrence alone on the lane's thread.  A block is one chain warp
//    (thread = lane) and kHelpers helper warps over the same 32 lanes.  The
//    chain runs the factorization (S, det2, det3, one division, Sinv, C),
//    the forward and the back substitutions.  The helpers do everything
//    that waits on no recurrence, on node tiles in shared memory: the
//    stiffness with its 1/Le, the masked assembly, the IEEE rsqrt scales,
//    the scaled blocks and right-hand side (handed to the chain in tiles
//    through two full/empty pairs of named barriers, so the chain runs up
//    to two tiles ahead), the error-free residuals and the unscaled output
//    (handed x by the chain through a ring of nodes).
//  - scratch written once per sweep, lanes innermost (row stride the lane
//    count rounded up to 32): the nonzeros of Sinv, U, C and D (5 each), F,
//    the scales, x and the residual (3 each), 32 floats a node.  The chain
//    stages the rows it reads a tile ahead into shared memory with 16-byte
//    cp.async.
//  - lanes-first I/O staged through shared memory: the helpers copy (lanes
//    x nodes) tiles of I, Le, the mask and the right-hand side with
//    cp.async while they work on the previous tile, and write x through a
//    tile, so every global access is coalesced and the wrapper copies
//    nothing.
//
// Floating point: no --use_fast_math; IEEE division and square root.  The
// chain, the stiffness and the error-free transforms use the _rn
// intrinsics; the compiler may contract a*b+c elsewhere, where the masks
// (0 or 1) make every product exact.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kLanes = 32;                     // lanes per block
constexpr int kHelpers = 7;                    // helper warps, as beam_opt.cu
constexpr int kThreads = kLanes * (1 + kHelpers);
constexpr int kHelperThreads = kLanes * kHelpers;
constexpr int kChunk = 8;                      // nodes per tile
constexpr int kPitch = kChunk + 1;             // odd pitches: no bank conflicts
constexpr int kRing = 32;                      // nodes of x in the ring

// named barriers: 0 is __syncthreads; full / empty pairs per tile buffer;
// the helpers' own
constexpr int kFull = 1, kEmpty = 3, kHelp = 5;

// scratch components per node, the nonzeros of each block: the chain's
// rows first (Schur inverse, scaled U_i coupling node i to i + 1 and zero
// at the last node, C_i = Sinv_i U_i, x (y in the forward sweep), the
// residual or its substitution), then the scaled diagonal block, scaled
// right-hand side and scales
enum : int {
  SI00 = 0, SI11, SI12, SI21, SI22,
  U00, U11, U12, U21, U22,
  C00, C11, C12, C21, C22,
  X0, X1, X2,
  R0, R1, R2,
  D00, D11, D12, D21, D22,
  F0, F1, F2,
  S0, S1, S2,
  NC_SOLVE
};
// the most rows a sweep stages a node: SI, U and a right-hand side (the
// forward substitution; the back sweeps stage C, X and R)
constexpr int kChainRows = U22 + 1 + 3;

// shared memory, in floats: the first forward sweep's input windows
// (elements c0 - 1 .. c0 + kChunk of I and Le, the mask of nodes c0 .. c0 +
// kChunk + 1, the right-hand side of the tile's nodes), its system tiles
// and per node c0 .. c0 + kChunk its scales and element's EA/Le, k11, k12,
// k2
constexpr int kWinE = kChunk + 3;                // pitch of I and Le
constexpr int kWinF = 3 * (kChunk + 2) + 1;      // pitch of the free mask
constexpr int kWinR = 3 * kChunk + 1;            // pitch of the rhs
constexpr int kWin = 2 * kWinE + kWinF + kWinR;
constexpr int kSysVals = 13;   // D00 D11 D12 D21 D22 F0 F1 F2 U00 U11 U12 U21 U22
constexpr int kNodeVals = 7;
constexpr int kSmemFwd =
    (2 * kWin + 2 * kSysVals * kPitch + kNodeVals * kWinE) * kLanes;
// the back sweeps: the chain's row tiles, the x ring, the output tile (x
// of the tile's nodes and node n - 1)
constexpr int kPitchX = 3 * (kChunk + 1);
constexpr int kSmemBwd =
    2 * kChainRows * kChunk * kLanes + 3 * kRing * kLanes + kPitchX * kLanes;
constexpr int kSmemSweep = kSmemFwd > kSmemBwd ? kSmemFwd : kSmemBwd;
// after them, kept through every sweep: the lanes' non-finite flags
constexpr int kSmemFloats = kSmemSweep + kLanes;

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

__device__ __forceinline__ bool is_finite(float x) {
  return fabsf(x) <= 3.402823466e38f;
}

// p1 q1 + p2 q2 as a sum from zero in order: fma(p2, q2, fma(p1, q1, 0))
__device__ __forceinline__ float dot2(float p1, float q1, float p2,
                                      float q2) {
  return __fmaf_rn(p2, q2, __fmaf_rn(p1, q1, 0.0f));
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

// Named barriers: the producer arrives, the consumer waits; both count all
// kThreads threads.  bar.arrive releases the producer's shared-memory
// writes to the threads that bar.sync.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void help_sync() {
  bar_sync(kHelp, kHelperThreads);
}

// Copy columns [c0, c0 + W) of rows b0 .. b0 + kLanes - 1 of a
// lanes-first (B, len) float array into tile[kLanes][pitch], skipping what
// lies outside it; thread `tid` of `nthr` copying.  Consecutive threads
// take consecutive columns of a row: coalesced.
template <int W>
__device__ __forceinline__ void stage(float* tile, int pitch,
                                      const float* __restrict__ src, int len,
                                      int c0, int b0, int B, int tid,
                                      int nthr) {
  for (int k = tid; k < kLanes * W; k += nthr) {
    const int r = k / W, c = k - r * W;
    if (b0 + r < B && c0 + c >= 0 && c0 + c < len)
      cp_async4(tile + r * pitch + c, src + (size_t)(b0 + r) * len + c0 + c);
  }
}

struct Ctx {
  const float* __restrict__ I;
  const float* __restrict__ Le;
  const float* __restrict__ fr;
  const float* __restrict__ rhs;
  float* __restrict__ x;
  float* __restrict__ piv;
  float* __restrict__ blk;      // scratch (n, NC_SOLVE, Bp) at lane 0
  float* __restrict__ own;      // ... at this thread's lane
  int B, n, Bp, b0;
  int ns;                       // node stride NC_SOLVE * Bp
  int lane;                     // this thread's lane in the block
  int hw;                       // helper warp 0 .. kHelpers - 1, or -1
  bool live;                    // the lane is < B
  float E, EA;

  // this lane's scratch value
  __device__ __forceinline__ float& at(int i, int c) const {
    return own[(size_t)i * ns + c * Bp];
  }
};

// An element's EA/Le, 12EI/Le^3, 6EI/Le^2, 4EI/Le, 2EI/Le, each rounded as
// the workspace stored it (__fmul_rn is never contracted into an FMA).
struct Stiff {
  float ea, k11, k12, k13, k2;
};

__device__ __forceinline__ Stiff stiffness(float I, float le, float E,
                                           float EA) {
  const float inv_le = 1.0f / le;
  const float eil = __fmul_rn(__fmul_rn(E, I), inv_le);
  const float eil2 = __fmul_rn(eil, inv_le);
  const float eil3 = __fmul_rn(eil2, inv_le);
  return {__fmul_rn(EA, inv_le), __fmul_rn(12.0f, eil3),
          __fmul_rn(6.0f, eil2), __fmul_rn(4.0f, eil), __fmul_rn(2.0f, eil)};
}

// d f f + d (1 - f): the constrained DOF's diagonal entry restored
__device__ __forceinline__ float restore(float d, float f) {
  return __fadd_rn(__fmul_rn(__fmul_rn(d, f), f),
                   __fmul_rn(d, __fsub_rn(1.0f, f)));
}

// C v over the nonzeros: the back substitution's product with x_{i+1}, or
// U^T v with U (the forward substitution's U_{i-1}^T y_{i-1})
struct Blk5 {
  float m00, m11, m12, m21, m22;
};
__device__ __forceinline__ void mul5(const Blk5& m, float v0, float v1,
                                     float v2, float& o0, float& o1,
                                     float& o2) {
  o0 = __fmaf_rn(m.m00, v0, 0.0f);
  o1 = dot2(m.m11, v1, m.m12, v2);
  o2 = dot2(m.m21, v1, m.m22, v2);
}
__device__ __forceinline__ void mul5t(const Blk5& m, float v0, float v1,
                                      float v2, float& o0, float& o1,
                                      float& o2) {
  o0 = __fmaf_rn(m.m00, v0, 0.0f);
  o1 = dot2(m.m11, v1, m.m21, v2);
  o2 = dot2(m.m12, v1, m.m22, v2);
}

// Error-free residual f_k - K_s x of node k over its 15 nonzero terms, in
// the full kernel's order within each row (over columns, the D_k, U_{k-1}^T
// and U_k terms); xp = x_{k-1} (0 at node 0), xn = x_{k+1} (0 at the last
// node, whose U is 0).
__device__ __forceinline__ void residual(const Ctx& c, int k, const float* xp,
                                         const float* xi, const float* xn,
                                         float* out) {
  const int kp = k > 0 ? k - 1 : 0;
  const float md[5] = {c.at(k, D00), c.at(k, D11), c.at(k, D12),
                       c.at(k, D21), c.at(k, D22)};
  const float up[5] = {c.at(kp, U00), c.at(kp, U11), c.at(kp, U12),
                       c.at(kp, U21), c.at(kp, U22)};
  const float um[5] = {c.at(k, U00), c.at(k, U11), c.at(k, U12),
                       c.at(k, U21), c.at(k, U22)};
  float acc_s, acc_c, p, e, e2;
  auto term = [&](float m, float v) {
    two_prod(-m, v, p, e);
    two_sum(acc_s, p, acc_s, e2);
    acc_c = __fadd_rn(__fadd_rn(acc_c, e2), e);
  };
  // row 0: column 0 alone
  acc_s = c.at(k, F0);
  acc_c = 0.0f;
  term(md[0], xi[0]);
  term(up[0], xp[0]);
  term(um[0], xn[0]);
  out[0] = __fadd_rn(acc_s, acc_c);
  // row 1: columns 1 and 2 (U_{k-1}^T's row 1 is U_{k-1}'s column 1)
  acc_s = c.at(k, F1);
  acc_c = 0.0f;
  term(md[1], xi[1]);
  term(up[1], xp[1]);
  term(um[1], xn[1]);
  term(md[2], xi[2]);
  term(up[3], xp[2]);
  term(um[2], xn[2]);
  out[1] = __fadd_rn(acc_s, acc_c);
  // row 2
  acc_s = c.at(k, F2);
  acc_c = 0.0f;
  term(md[3], xi[1]);
  term(up[2], xp[1]);
  term(um[3], xn[1]);
  term(md[4], xi[2]);
  term(up[4], xp[2]);
  term(um[4], xn[2]);
  out[2] = __fadd_rn(acc_s, acc_c);
}

// ---------------------------------------------------------------------------
// The first forward sweep.  Helpers: node i's scaled blocks, right-hand side
// and scaled U_i from the inputs into a system tile and the scratch (D, F,
// S, U).  Chain: S_i = D_i - U_{i-1}^T C_{i-1}, its inverse, C_i and y
// (SI, C, X), the pivot and the lane's non-finite flags.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void forward_factor(const Ctx& c, float* smem,
                                               unsigned* bad) {
  constexpr int T = kLanes;
  const int n = c.n, nelem = n - 1, b0 = c.b0, B = c.B, lane = c.lane;
  const int nchunk = (n + kChunk - 1) / kChunk;
  auto win = [&](int ch) { return smem + (ch & 1) * kWin * T; };
  auto sys = [&](int ch) {
    return smem + 2 * kWin * T + (ch & 1) * kSysVals * kPitch * T;
  };

  if (c.hw >= 0) {
    // ---- helpers ----
    const int htid = c.hw * T + lane;
    float* nv = smem + 2 * kWin * T + 2 * kSysVals * kPitch * T + lane * kWinE;
    auto stage_win = [&](int ch) {
      const int c0 = ch * kChunk;
      float* s = win(ch);
      stage<kChunk + 2>(s, kWinE, c.I, nelem, c0 - 1, b0, B, htid,
                        kHelperThreads);
      stage<kChunk + 2>(s + kWinE * T, kWinE, c.Le, nelem, c0 - 1, b0, B,
                        htid, kHelperThreads);
      stage<3 * (kChunk + 2)>(s + 2 * kWinE * T, kWinF, c.fr, 3 * n, 3 * c0,
                              b0, B, htid, kHelperThreads);
      stage<3 * kChunk>(s + (2 * kWinE + kWinF) * T, kWinR, c.rhs, 3 * n,
                        3 * c0, b0, B, htid, kHelperThreads);
      cp_async_commit();
    };
    stage_win(0);
    for (int ch = 0; ch < nchunk; ++ch) {
      if (ch + 1 < nchunk) {
        stage_win(ch + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      help_sync();
      if (ch >= 2) bar_sync(kEmpty + (ch & 1), kThreads);
      const int c0 = ch * kChunk;
      const int cnt = min(kChunk, n - c0);
      const float* wI = win(ch) + lane * kWinE;
      const float* wLe = wI + kWinE * T;
      const float* wF = win(ch) + 2 * kWinE * T + lane * kWinF;
      const float* wR = win(ch) + (2 * kWinE + kWinF) * T + lane * kWinR;
      float* st = sys(ch) + lane * kPitch;
      // elements j - 1 and j of node j = c0 + k sit at window columns k and
      // k + 1; a missing one contributes zeros
      auto elem = [&](int j, int col) -> Stiff {
        if (j < 0 || j >= nelem) return {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        return stiffness(wI[col], wLe[col], c.E, c.EA);
      };
      // phase 1, nodes c0 .. c0 + cnt (the next tile's first too): the
      // masked diagonal block, its scales, the scaled block and right-hand
      // side
      const int cnt1 = cnt + (c0 + cnt < n ? 1 : 0);
      for (int k = c.hw; c.live && k < cnt1; k += kHelpers) {
        const int i = c0 + k;
        const Stiff ep = elem(i - 1, k), en = elem(i, k + 1);
        const float f0 = wF[3 * k], f1 = wF[3 * k + 1], f2 = wF[3 * k + 2];
        const float d00 = __fadd_rn(ep.ea, en.ea);
        const float d11 = __fadd_rn(ep.k11, en.k11);
        const float d12 = __fadd_rn(-ep.k12, en.k12);
        const float d22 = __fadd_rn(ep.k13, en.k13);
        const float m00 = restore(d00, f0);
        const float m11 = restore(d11, f1);
        const float m12 = __fmul_rn(__fmul_rn(d12, f1), f2);
        const float m21 = __fmul_rn(__fmul_rn(d12, f2), f1);
        const float m22 = restore(d22, f2);
        // Jacobi scaling
        const float s0 = rsq(m00), s1 = rsq(m11), s2 = rsq(m22);
        nv[k] = s0;
        nv[kWinE * T + k] = s1;
        nv[2 * kWinE * T + k] = s2;
        nv[3 * kWinE * T + k] = en.ea;
        nv[4 * kWinE * T + k] = en.k11;
        nv[5 * kWinE * T + k] = en.k12;
        nv[6 * kWinE * T + k] = en.k2;
        if (k == cnt) continue;   // the next tile's node: its scales only
        const float v[8] = {
            __fmul_rn(__fmul_rn(m00, s0), s0),
            __fmul_rn(__fmul_rn(m11, s1), s1),
            __fmul_rn(__fmul_rn(m12, s1), s2),
            __fmul_rn(__fmul_rn(m21, s2), s1),
            __fmul_rn(__fmul_rn(m22, s2), s2),
            __fmul_rn(__fmul_rn(wR[3 * k], f0), s0),
            __fmul_rn(__fmul_rn(wR[3 * k + 1], f1), s1),
            __fmul_rn(__fmul_rn(wR[3 * k + 2], f2), s2)};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          st[q * kPitch * T + k] = v[q];
          c.at(i, D00 + q) = v[q];    // D00 .. D22, F0 .. F2
        }
        c.at(i, S0) = s0;
        c.at(i, S1) = s1;
        c.at(i, S2) = s2;
      }
      help_sync();
      // phase 2: U_i scaled by the scales of nodes i and i + 1 (zero at the
      // last node)
      for (int k = c.hw; c.live && k < cnt; k += kHelpers) {
        const int i = c0 + k;
        float u[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (i + 1 < n) {
          const float f0 = wF[3 * k], f1 = wF[3 * k + 1], f2 = wF[3 * k + 2];
          const float g0 = wF[3 * k + 3], g1 = wF[3 * k + 4],
                      g2 = wF[3 * k + 5];
          const float s0 = nv[k], s1 = nv[kWinE * T + k],
                      s2 = nv[2 * kWinE * T + k];
          const float t0 = nv[k + 1], t1 = nv[kWinE * T + k + 1],
                      t2 = nv[2 * kWinE * T + k + 1];
          const float ea = nv[3 * kWinE * T + k], k11 = nv[4 * kWinE * T + k],
                      k12 = nv[5 * kWinE * T + k], k2 = nv[6 * kWinE * T + k];
          auto sc = [](float m, float f, float g, float s, float t) {
            return __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(m, f), g), s), t);
          };
          u[0] = sc(-ea, f0, g0, s0, t0);
          u[1] = sc(-k11, f1, g1, s1, t1);
          u[2] = sc(k12, f1, g2, s1, t2);
          u[3] = sc(-k12, f2, g1, s2, t1);
          u[4] = sc(k2, f2, g2, s2, t2);
        }
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          st[(8 + q) * kPitch * T + k] = u[q];
          c.at(i, U00 + q) = u[q];
        }
      }
      bar_arrive(kFull + (ch & 1), kThreads);
      help_sync();    // the window and node values are read before reuse
    }
  } else {
    // ---- chain ----
    Blk5 pu{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // U_{i-1}
    Blk5 pc{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // C_{i-1}
    float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, piv = 0.0f;
    bool any_bad = false, piv_nan = false;
    for (int ch = 0; ch < nchunk; ++ch) {
      bar_sync(kFull + (ch & 1), kThreads);
      const int c0 = ch * kChunk;
      const int cnt = min(kChunk, n - c0);
      const float* st = sys(ch) + lane * kPitch;
      for (int k = 0; c.live && k < cnt; ++k) {
        const int i = c0 + k;
        auto tv = [&](int q) { return st[q * kPitch * T + k]; };
        // S = D - U_{i-1}^T C_{i-1} and q = f - U_{i-1}^T y_{i-1} (node 0:
        // D and f)
        float a = tv(0), e = tv(1), f = tv(2), h = tv(3), ii = tv(4);
        float q0 = tv(5), q1 = tv(6), q2 = tv(7);
        if (i > 0) {
          a = __fsub_rn(a, __fmaf_rn(pu.m00, pc.m00, 0.0f));
          e = __fsub_rn(e, dot2(pu.m11, pc.m11, pu.m21, pc.m21));
          f = __fsub_rn(f, dot2(pu.m11, pc.m12, pu.m21, pc.m22));
          h = __fsub_rn(h, dot2(pu.m12, pc.m11, pu.m22, pc.m21));
          ii = __fsub_rn(ii, dot2(pu.m12, pc.m12, pu.m22, pc.m22));
          float w0, w1, w2;
          mul5t(pu, y0, y1, y2, w0, w1, w2);
          q0 = __fsub_rn(q0, w0);
          q1 = __fsub_rn(q1, w1);
          q2 = __fsub_rn(q2, w2);
        }
        // the cofactor inverse's nonzeros
        const float det2 = __fmaf_rn(e, ii, -__fmul_rn(f, h));
        const float det3 = __fmul_rn(a, det2);
        const float inv = 1.0f / det3;
        const Blk5 si{__fmul_rn(det2, inv), __fmul_rn(__fmul_rn(a, ii), inv),
                      __fmul_rn(-__fmul_rn(a, f), inv),
                      __fmul_rn(-__fmul_rn(a, h), inv),
                      __fmul_rn(__fmul_rn(a, e), inv)};
        // y = Sinv q, C_i = Sinv U_i
        y0 = __fmaf_rn(si.m00, q0, 0.0f);
        y1 = dot2(si.m11, q1, si.m12, q2);
        y2 = dot2(si.m21, q1, si.m22, q2);
        pu = Blk5{tv(8), tv(9), tv(10), tv(11), tv(12)};
        pc = Blk5{__fmaf_rn(si.m00, pu.m00, 0.0f),
                  dot2(si.m11, pu.m11, si.m12, pu.m21),
                  dot2(si.m11, pu.m12, si.m12, pu.m22),
                  dot2(si.m21, pu.m11, si.m22, pu.m21),
                  dot2(si.m21, pu.m12, si.m22, pu.m22)};
        piv = i == 0 ? fabsf(det3) : nan_min(piv, fabsf(det3));
        // the zeros a non-finite 1/det3 or y would have met
        if (!is_finite(inv)) {
          any_bad = true;
          piv_nan |= i + 1 < n;
        }
        if (!(is_finite(y0) && is_finite(y1) && is_finite(y2))) any_bad = true;
        c.at(i, SI00) = si.m00;
        c.at(i, SI11) = si.m11;
        c.at(i, SI12) = si.m12;
        c.at(i, SI21) = si.m21;
        c.at(i, SI22) = si.m22;
        c.at(i, C00) = pc.m00;
        c.at(i, C11) = pc.m11;
        c.at(i, C12) = pc.m12;
        c.at(i, C21) = pc.m21;
        c.at(i, C22) = pc.m22;
        c.at(i, X0) = y0;
        c.at(i, X1) = y1;
        c.at(i, X2) = y2;
      }
      if (ch + 2 < nchunk) bar_arrive(kEmpty + (ch & 1), kThreads);
    }
    bad[lane] = any_bad ? 1u : 0u;
    if (c.live) c.piv[b0 + lane] = piv_nan ? __int_as_float(0x7fffffff) : piv;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The chain's row tiles: rows (node, component) of the block's 32 lanes,
// 128 bytes each, staged with 16-byte cp.async by the chain warp.
// ---------------------------------------------------------------------------

// Stage nodes node0 .. node0 + cnt - 1, components [pa, pa + na) and [pb,
// pb + nb), into tile[k][row][lane] with `rows` = na + nb rows per node.
__device__ __forceinline__ void stage_rows(const Ctx& c, float* tile,
                                           int node0, int cnt, int pa, int na,
                                           int pb, int nb) {
  const int rows = na + nb;
  for (int q = c.lane; q < cnt * rows * 8; q += kLanes) {
    const int row = q >> 3, part = q & 7;
    const int k = row / rows, j = row - k * rows;
    const int comp = j < na ? pa + j : pb + (j - na);
    cp_async16(tile + row * kLanes + part * 4,
               c.blk + (size_t)(node0 + k) * c.ns + comp * c.Bp + part * 4);
  }
  cp_async_commit();
}

// Forward substitution z_i = Sinv_i (r_i - U_{i-1}^T z_{i-1}) with the saved
// factors, r from R and z into R.  The chain alone.
__device__ __forceinline__ void forward_subst(const Ctx& c, float* smem) {
  constexpr int T = kLanes;
  if (c.hw < 0) {
    const int n = c.n, lane = c.lane;
    const int nchunk = (n + kChunk - 1) / kChunk;
    auto tile = [&](int ch) {
      return smem + (ch & 1) * kChainRows * kChunk * T;
    };
    Blk5 pu{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // U_{i-1}
    float z0 = 0.0f, z1 = 0.0f, z2 = 0.0f;
    stage_rows(c, tile(0), 0, min(kChunk, n), 0, U22 + 1, R0, 3);
    for (int ch = 0; ch < nchunk; ++ch) {
      const int c0 = ch * kChunk;
      const int cnt = min(kChunk, n - c0);
      if (ch + 1 < nchunk) {
        stage_rows(c, tile(ch + 1), c0 + kChunk,
                   min(kChunk, n - c0 - kChunk), 0, U22 + 1, R0, 3);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const float* t = tile(ch) + lane;
      for (int k = 0; c.live && k < cnt; ++k) {
        const float* row = t + k * kChainRows * T;
        float q0 = row[(U22 + 1) * T], q1 = row[(U22 + 2) * T],
              q2 = row[(U22 + 3) * T];
        if (c0 + k > 0) {
          float w0, w1, w2;
          mul5t(pu, z0, z1, z2, w0, w1, w2);
          q0 = __fsub_rn(q0, w0);
          q1 = __fsub_rn(q1, w1);
          q2 = __fsub_rn(q2, w2);
        }
        const Blk5 si{row[SI00 * T], row[SI11 * T], row[SI12 * T],
                      row[SI21 * T], row[SI22 * T]};
        mul5(si, q0, q1, q2, z0, z1, z2);
        c.at(c0 + k, R0) = z0;
        c.at(c0 + k, R1) = z1;
        c.at(c0 + k, R2) = z2;
        pu = Blk5{row[U00 * T], row[U11 * T], row[U12 * T], row[U21 * T],
                  row[U22 * T]};
      }
      __syncwarp();   // the tile is read before it is staged again
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Back sweeps.  Chain: FIRST, X holds y and x_i = y_i - C_i x_{i+1}; else R
// holds the forward-substituted residual z, the correction is c_i = z_i -
// C_i c_{i+1} and x_i = X_i + c_i.  It hands x_i to the helpers through the
// ring, a tile of elements at a time.  Helpers: not OUT, node i + 1's
// residual; OUT, the unscaled x of node i (and of node n - 1) through an
// output tile.
// ---------------------------------------------------------------------------

template <bool FIRST, bool OUT>
__device__ __forceinline__ void back_sweep(const Ctx& c, float* smem,
                                           const unsigned* bad) {
  constexpr int T = kLanes;
  // the chain's rows of a node: C, X (and R)
  constexpr int kRows = FIRST ? X2 + 1 - C00 : R2 + 1 - C00;
  constexpr int rX = X0 - C00, rR = R0 - C00;
  const int n = c.n, nelem = n - 1, b0 = c.b0, B = c.B, lane = c.lane;
  const int nce = (nelem + kChunk - 1) / kChunk;
  auto ctile = [&](int ch) {
    return smem + (ch & 1) * kChainRows * kChunk * T;
  };
  float* ring = smem + 2 * kChainRows * kChunk * T;     // [3][kRing][T]
  float* outt = ring + 3 * kRing * T;                   // [T][kPitchX]
  auto rx = [&](int comp, int i) -> float& {
    return ring[(comp * kRing + i % kRing) * T + lane];
  };

  if (c.hw < 0) {
    // ---- chain ----
    float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;  // the chain's value at node i + 1
    if (c.live) {
      v0 = c.at(n - 1, FIRST ? X0 : R0);
      v1 = c.at(n - 1, FIRST ? X1 : R1);
      v2 = c.at(n - 1, FIRST ? X2 : R2);
      float x0 = v0, x1 = v1, x2 = v2;
      if (!FIRST) {
        x0 = __fadd_rn(c.at(n - 1, X0), v0);
        x1 = __fadd_rn(c.at(n - 1, X1), v1);
        x2 = __fadd_rn(c.at(n - 1, X2), v2);
        if (!OUT) {
          c.at(n - 1, X0) = x0;
          c.at(n - 1, X1) = x1;
          c.at(n - 1, X2) = x2;
        }
      }
      rx(0, n - 1) = x0;
      rx(1, n - 1) = x1;
      rx(2, n - 1) = x2;
    }
    stage_rows(c, ctile(nce - 1), (nce - 1) * kChunk,
               nelem - (nce - 1) * kChunk, C00, kRows, 0, 0);
    for (int d = 0; d < nce; ++d) {
      const int ch = nce - 1 - d;
      const int c0 = ch * kChunk;
      const int cnt = min(kChunk, nelem - c0);
      if (ch > 0) {
        stage_rows(c, ctile(ch - 1), c0 - kChunk, kChunk, C00, kRows, 0, 0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      if (d >= 2) bar_sync(kEmpty + (d & 1), kThreads);
      const float* t = ctile(ch) + lane;
      for (int k = cnt - 1; c.live && k >= 0; --k) {
        const int i = c0 + k;
        const float* row = t + k * kRows * T;
        const Blk5 cm{row[0], row[T], row[2 * T], row[3 * T], row[4 * T]};
        float w0, w1, w2;
        mul5(cm, v0, v1, v2, w0, w1, w2);
        const int rv = FIRST ? rX : rR;
        v0 = __fsub_rn(row[rv * T], w0);
        v1 = __fsub_rn(row[(rv + 1) * T], w1);
        v2 = __fsub_rn(row[(rv + 2) * T], w2);
        float x0 = v0, x1 = v1, x2 = v2;
        if (!FIRST) {
          x0 = __fadd_rn(row[rX * T], v0);
          x1 = __fadd_rn(row[(rX + 1) * T], v1);
          x2 = __fadd_rn(row[(rX + 2) * T], v2);
        }
        if (!OUT) {
          c.at(i, X0) = x0;
          c.at(i, X1) = x1;
          c.at(i, X2) = x2;
        }
        rx(0, i) = x0;
        rx(1, i) = x1;
        rx(2, i) = x2;
      }
      bar_arrive(kFull + (d & 1), kThreads);
      __syncwarp();   // the tile is read before it is staged again
    }
    __syncthreads();
    return;
  }

  // ---- helpers ----
  const int htid = c.hw * T + lane;
  const bool nan_lane = bad[lane] != 0u;
  for (int d = 0; d < nce; ++d) {
    const int ch = nce - 1 - d;
    const int c0 = ch * kChunk;
    const int cnt = min(kChunk, nelem - c0);
    bar_sync(kFull + (d & 1), kThreads);
    for (int k = c.hw; c.live && k < cnt; k += kHelpers) {
      const int i = c0 + k;           // element i, nodes i and i + 1
      const float xi[3] = {rx(0, i), rx(1, i), rx(2, i)};
      const float xj[3] = {rx(0, i + 1), rx(1, i + 1), rx(2, i + 1)};
      if (!OUT) {
        // node i + 1's residual, x_{i+2} = 0 past the last node
        float xn[3] = {0.0f, 0.0f, 0.0f};
        if (i + 2 < n) {
          xn[0] = rx(0, i + 2);
          xn[1] = rx(1, i + 2);
          xn[2] = rx(2, i + 2);
        }
        float r[3];
        residual(c, i + 1, xi, xj, xn, r);
        c.at(i + 1, R0) = r[0];
        c.at(i + 1, R1) = r[1];
        c.at(i + 1, R2) = r[2];
      } else {
        // node i's unscaled x (and the last node's with the last element)
        float* o = outt + lane * kPitchX + 3 * k;
        const float nanf = __int_as_float(0x7fffffff);
#pragma unroll
        for (int a = 0; a < 3; ++a)
          o[a] = nan_lane ? nanf : __fmul_rn(xi[a], c.at(i, S0 + a));
        if (i + 2 == n) {
#pragma unroll
          for (int a = 0; a < 3; ++a)
            o[3 + a] = nan_lane ? nanf : __fmul_rn(xj[a], c.at(i + 1, S0 + a));
        }
      }
    }
    if (d + 2 < nce) bar_arrive(kEmpty + (d & 1), kThreads);
    if (!OUT) continue;
    help_sync();
    // coalesced write-back of the tile's x
    const int cols = 3 * (cnt + (c0 + cnt == nelem ? 1 : 0));
    for (int kk = htid; kk < T * kPitchX; kk += kHelperThreads) {
      const int r = kk / kPitchX, col = kk - r * kPitchX;
      if (b0 + r < B && col < cols)
        c.x[(size_t)(b0 + r) * 3 * n + 3 * c0 + col] = outt[r * kPitchX + col];
    }
    help_sync();   // the tile is read before it is written again
  }
  if (!OUT && c.hw == 0 && c.live) {
    // node 0's residual (no U_{-1} term: x_{-1} = 0)
    const float xp[3] = {0.0f, 0.0f, 0.0f};
    const float xi[3] = {rx(0, 0), rx(1, 0), rx(2, 0)};
    const float xn[3] = {rx(0, 1), rx(1, 1), rx(2, 1)};
    float r[3];
    residual(c, 0, xp, xi, xn, r);
    c.at(0, R0) = r[0];
    c.at(0, R1) = r[1];
    c.at(0, R2) = r[2];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
beam_solve_kernel(const float* __restrict__ I, const float* __restrict__ Le,
                  const float* __restrict__ fr, const float* __restrict__ rhs,
                  float* __restrict__ x, float* __restrict__ piv,
                  float* __restrict__ scr, int B, int Bp, int n, int refine,
                  float E, float EA) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const Ctx c{I, Le, fr, rhs, x, piv, scr + b0, scr + b0 + lane, B, n, Bp,
              b0, NC_SOLVE * Bp, lane, warp - 1, b0 + lane < B, E, EA};
  unsigned* bad = reinterpret_cast<unsigned*>(smem + kSmemSweep);
  forward_factor(c, smem, bad);
  if (refine == 0) {
    back_sweep<true, true>(c, smem, bad);
    return;
  }
  back_sweep<true, false>(c, smem, bad);
  for (int k = 1; k < refine; ++k) {
    forward_subst(c, smem);
    back_sweep<false, false>(c, smem, bad);
  }
  forward_subst(c, smem);
  back_sweep<false, true>(c, smem, bad);
}

}  // namespace

extern "C" {

// Scratch floats per node per lane; the scratch is (n, NC_SOLVE, Bp) with
// Bp the lane count rounded up to 32.
int beam_solve_scratch_per_node(void) { return NC_SOLVE; }

// Lanes-first float32 I/O: I, Le (B, n - 1), free, rhs, x (B, n, 3), piv
// (B,); all contiguous, n >= 2.
int beam_solve_f32(const float* I, const float* Le, const float* fr,
                   const float* rhs, float* x, float* piv, float* scr, int B,
                   int n, int refine, float E, float EA, void* stream) {
  if (B <= 0) return 0;
  if (n < 2 || refine < 0) return (int)cudaErrorInvalidValue;
  const int bytes = kSmemFloats * (int)sizeof(float);
  const cudaError_t set = cudaFuncSetAttribute(
      beam_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return (int)set;
  const int blocks = (B + kLanes - 1) / kLanes;
  beam_solve_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      I, Le, fr, rhs, x, piv, scr, B, blocks * kLanes, n, refine, E, EA);
  return (int)cudaGetLastError();
}

}  // extern "C"
