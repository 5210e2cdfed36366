// The datagen's Adam step and the float32 analysis for Hopper (sm_90a):
// fused sweeps per lane over read-only lanes-first float32 inputs, the
// recurrences alone on the lane's thread.
//
// beam_opt_step_kernel replaces openpystruct_tpu/ops/beam_kernel.py:819
// _beam_opt_kernel_b2 (launcher pallas_beam_opt_step): stiffness -> masked
// bending-only 2x2 assembly -> Jacobi scaling -> block-Thomas factorization
// fused with the forward sweep -> back sweep -> `refine` compensated
// sweeps -> forces, the loss sum(I) + a_m sum M^2/(2EI+1e-6) + a_s sum
// V^2/(G 0.03 sqrt(I)) and its gradient: the semi-gradient (M and V held
// constant) or the exact adjoint (K lam = g_hat solved with the same
// factors and `refine` sweeps, then banded products) -> Adam with clamp.
// All in float32.  Given the epoch loop's lane state, the same launch also
// does the loop's freeze and early-stop bookkeeping (lane_epilogue): a lane
// that was done on entry returns its inputs, and a block whose lanes are
// all done skips its solve.
//
// beam_analysis_kernel replaces openpystruct_tpu/ops/beam_kernel.py:751
// _beam_kernel_b2 (launcher pallas_beam_analysis): the same sweeps with
// another last one (mode kAnalysis), which writes the unscaled u (u_x the
// exact zero x_0 * 0), and V, M recovered from the float32 u.  As the JAX
// kernel, the first forward sweep saves C_i = Sinv_i U_i and every back
// substitution reads it (x_i = y_i - C_i x_{i+1}); it also returns the
// 3-DOF pivot min_i a_i |det2(S_i)|, the axial chain's a_i in float32 with
// a NaN-propagating min (the datagen gate pivot_tol = 1e-9 and the rescue's
// 1e-12 are calibrated on it).  Its stiffness and axial EA/Le are rounded
// as the seven-pass kernel it replaces stored them, so the forward sweep
// and the pivot keep that kernel's roundings.
//
// Bound on an H100 SXM: the opt step must read I, mu, nu, Le (n - 1 each),
// the free mask (3n), the loads (n) and udl, and write I, mu, nu and stats
// (4); the analysis reads I, Le, the mask, the loads and udl and writes u
// (3n), V, M (n - 1 each) and the pivot.  Both are 1,109 floats per lane at
// n = 101, ~21.7 us at B = 16384 on 3.35 TB/s.  Their flops (~360 per node
// with one refinement sweep, ~610 in adjoint mode, ~320 in the analysis)
// are below that at 67 TFLOP/s.  What keeps a kernel that walks each lane's
// recurrence on one thread from it is latency: at B = 16384 the card holds
// about one lane-warp per scheduler, the compaction's 512-lane buckets a
// sixteenth of that, so each step waits on its operands.  The design:
//  - fused sweeps.  The first forward sweep builds each node's scaled
//    system from the inputs, factors and substitutes forward.  Each back
//    sweep forms node i + 1's compensated residual as soon as x_i is known,
//    so a refinement is one forward and one back sweep.  The last back
//    sweep recovers element i's V and M, its loss terms, gradient and Adam
//    step (semi), or the adjoint's right-hand side one node behind
//    (adjoint), after which the same sweeps solve for lam and the last one
//    does the banded products and Adam; in the analysis it writes u, V, M.
//  - the recurrences alone on the lane's thread.  A block is one chain warp
//    (thread = lane) and kHelpers helper warps over the same 32 lanes.  The
//    chain warp runs the factorization, forward substitutions and back
//    substitutions: in the first sweep ~50 flops and one division per node.
//    The helpers do everything that waits on no recurrence, on node tiles
//    in shared memory: the stiffness with its 1/Le, the IEEE rsqrt scales,
//    w/12, the scaled blocks and right-hand side (handed to the chain in
//    tiles), the error-free residuals, forces, loss, gradient, g_hat and
//    Adam (handed x by the chain through a ring of nodes).  The analysis's
//    axial chain, a second recurrence with one division a node, runs on
//    the last helper warp beside the chain, which only multiplies its a_i
//    by |det2(S_i)| and takes the min.  Tiles pass between the two through
//    two full/empty pairs of named barriers (bar.arrive / bar.sync), so the
//    chain runs up to two tiles ahead.
//  - scratch written once per sweep, lanes innermost (row stride the lane
//    count rounded up to 32): the scaled system, Schur inverses, scales, x
//    and the residual, 18 floats per node (22 in adjoint mode, with g and
//    the three banded rows; 22 in the analysis, with C).  The chain stages
//    the rows it reads a tile ahead into shared memory with 16-byte
//    cp.async.
//  - lanes-first I/O staged through shared memory: the helpers copy
//    (lanes x nodes) tiles of each input with cp.async while they work on
//    the previous tile, and write I, mu, nu (or u, V, M) through a tile
//    too, so every global access is coalesced and the wrapper copies
//    nothing.  Only a lane whose u_x zero is -0 or NaN, known once x_0 is,
//    has its u_x column written a second time.
//
// Against the seven-pass kernels they replace, every expression keeps its
// tree (the opt step's back sweep Sinv_i (U_i x_{i+1}), the analysis's C_i
// x_{i+1}, the refinement's error-free transforms, torch's Adam); nvcc's
// FMA contraction differs with the basic blocks, so outputs agree to
// float32 rounding, not bitwise.  The loss sums run in another order.
//
// Floating point: no --use_fast_math; IEEE division and square root.  The
// compiler may contract a*b+c into an FMA anywhere except in the error-free
// transforms and the analysis's stiffness, which use the _rn intrinsics.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kLanes = 32;                     // lanes per block
// helper warps per block: 7 ran a median 1.19x faster than 3 (5: 1.08x)
// over 32 sizes and modes, 4-8% slower at B = 16384 in adjoint mode
// (PERF.md); two blocks fit an SM
constexpr int kHelpers = 7;
constexpr int kThreads = kLanes * (1 + kHelpers);
constexpr int kHelperThreads = kLanes * kHelpers;
constexpr int kChunk = 8;                      // nodes per tile
constexpr int kPitch = kChunk + 1;             // odd pitches: no bank conflicts
constexpr int kRing = 32;                      // nodes of x in the ring
constexpr int kElemRing = 2 * kChunk;          // elements of g_hat terms

// named barriers: 0 is __syncthreads; full / empty pairs per tile buffer;
// the helpers' own
constexpr int kFull = 1, kEmpty = 3, kHelp = 5;

// scratch components per node: the chain's rows first (Schur inverse,
// scaled U_i coupling node i to i + 1 and zero at the last node, x (y in
// the forward sweep), residual or its forward substitution), then the
// scaled diagonal block, scaled right-hand side (the adjoint's once the
// primal is done) and scales; in adjoint mode also element i's gradient so
// far and its three (dK_e/dI_e) u_e rows
enum : int {
  SI0 = 0, SI1, SI2, U00, U01, U10, U11, X0, X1, R0, R1, D0, D1, D2, F0, F1,
  S0, S1, NC_SEMI,
  GR = NC_SEMI, RU, RTI, RTJ, NC_ADJOINT
};
// the analysis keeps C_i = Sinv_i U_i where the adjoint keeps its rows
enum : int { C00 = NC_SEMI, C01, C10, C11, NC_ANALYSIS };
constexpr int kChainRows = R1 + 1;   // SI, U, X, R: a back sweep's chain rows
constexpr int kSubstRows = U11 + 3;  // SI, U and a right-hand side pair

// what the last back sweep does with x
enum : int {
  kRefine = 0,     // not the last: store x, form the residual
  kSemi = 1,       // forces, loss, semi-gradient, Adam
  kPrimal = 2,     // forces, loss, g and rows, adjoint right-hand side
  kAdjoint = 3,    // banded products, Adam
  kAnalysis = 4    // u, V, M
};

// shared memory, in floats: the first forward sweep's input windows
// (elements c0 - 1 .. c0 + kChunk of I and Le, loads of the tile's nodes,
// the free mask of nodes c0 .. c0 + kChunk + 1) and its system tiles
constexpr int kWinE = kChunk + 3;                // pitch of I and Le
constexpr int kWinF = 3 * (kChunk + 2) + 1;      // pitch of the free mask
constexpr int kWin = 2 * kWinE + kPitch + kWinF;
constexpr int kSysVals = 9;    // m0 m1 m2 r0 r1 q00 q01 q10 q11
// per node c0 .. c0 + kChunk: its scales and element's k11, k12, k2; in
// the analysis also its axial d00, rsqrt(d00) and u00
constexpr int kNodeVals = 5;
constexpr int kNodeValsAx = kNodeVals + 3;
// the analysis's axial pivot factors a_i of the tile's nodes, two tiles
constexpr int kAxTile = 2 * kWin + 2 * kSysVals * kPitch + kNodeValsAx * kWinE;
constexpr int kSmemFwd = (kAxTile + 2 * kPitch) * kLanes;
// the back sweeps: the chain's row tiles, the x ring, the helpers' input
// tiles (at most I, Le and the free mask, or I, Le, mu, nu), the output
// tiles or the g_hat term ring, the helpers' partial sums
constexpr int kPitch3 = 3 * kChunk + 1;
constexpr int kPitchU = 3 * (kChunk + 1);   // the analysis's u tile: 9 nodes
constexpr int kHin = (2 * kPitch + kPitch3 > 4 * kPitch) ? 2 * kPitch + kPitch3
                                                         : 4 * kPitch;
constexpr int kOutOrRing =
    (3 * kPitch > 5 * kElemRing) ? 3 * kPitch : 5 * kElemRing;
constexpr int kSmemBwd = 2 * kChainRows * kChunk * kLanes + 2 * kRing * kLanes +
                         2 * kHin * kLanes + kOutOrRing * kLanes +
                         3 * kHelpers * kLanes;
constexpr int kSmemFloats = kSmemFwd > kSmemBwd ? kSmemFwd : kSmemBwd;
static_assert(2 * kPitch + kPitchU <= kOutOrRing, "V, M, u output tiles");

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

// jnp.maximum propagates NaN; fmaxf does not.  A lane that went NaN must
// stay NaN so the validity gate drops it.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b || b > a) ? b : a);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b || b < a) ? b : a);
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
  const float* __restrict__ mu;
  const float* __restrict__ nu;
  const float* __restrict__ Le;
  const float* __restrict__ fr;
  const float* __restrict__ loads;
  float* __restrict__ I_out;
  float* __restrict__ mu_out;
  float* __restrict__ nu_out;
  float* __restrict__ stats;
  float* __restrict__ blk;      // scratch (n, nc, Bp) at the block's lane 0
  float* __restrict__ own;      // ... at this thread's lane
  int B, n, nc, Bp, b0;
  int ns;                       // node stride nc * Bp
  int lane;                     // this thread's lane in the block
  int hw;                       // helper warp 0 .. kHelpers - 1, or -1
  bool live;                    // the lane is < B
  float w, E, Gs, alpha_m, alpha_s, clamp_min, lr_t, bc1, bc2;
  // the analysis's outputs: u (B, n, 3), V, M (B, n - 1), pivot (B,)
  float* __restrict__ u;
  float* __restrict__ V;
  float* __restrict__ M;
  float* __restrict__ piv;
  float EA;

  // this lane's scratch value
  __device__ __forceinline__ float& at(int i, int c) const {
    return own[(size_t)i * ns + c * Bp];
  }
};

// The epoch loop's per-lane early-stopping state (opt/beam_opt.py
// _lane_state_init), updated in place; done == nullptr: none given.
struct Lanes {
  bool* __restrict__ done;             // (B,)
  float* __restrict__ best;            // (B,)
  int* __restrict__ no_improve;        // (B,)
  int* __restrict__ n_epochs;          // (B,)
  float* __restrict__ I_solved;        // (B, n - 1)
  const float* __restrict__ stats_prev;  // (B, 4), the previous epoch's
  float tolerance;
  int patience;
};

struct Stiff {
  float k11, k12, k13, k2, le;   // 12EI/Le^3, 6EI/Le^2, 4EI/Le, 2EI/Le, Le
  float ea;                      // EA/Le (RN only)
};

// RN: the coefficients rounded as the seven-pass analysis kernel stored
// them, before a sum read them back (__fmul_rn is never contracted into an
// FMA), and the axial EA/Le too.
template <bool RN>
__device__ __forceinline__ Stiff stiffness(float I, float le, float E,
                                           float EA = 0.0f) {
  const float inv_le = 1.0f / le;
  const float eil = E * I * inv_le;
  const float eil2 = eil * inv_le;
  const float eil3 = eil2 * inv_le;
  if (RN)
    return {__fmul_rn(12.0f, eil3), __fmul_rn(6.0f, eil2),
            __fmul_rn(4.0f, eil), __fmul_rn(2.0f, eil), le,
            __fmul_rn(EA, inv_le)};
  return {12.0f * eil3, 6.0f * eil2, 4.0f * eil, 2.0f * eil, le, 0.0f};
}

// Torch's Adam in float32 (bias-corrected moments; lr_t, bc1, bc2 computed
// in float32 from the epoch counter); the clamp applies to I only.
__device__ __forceinline__ void adam(const Ctx& c, float I, float mu, float nu,
                                     float g, float& I_new, float& mu_new,
                                     float& nu_new) {
  const float b1 = 0.9f, b2 = 0.999f, eps = 1e-8f;
  const float omb1 = (float)(1.0 - 0.9), omb2 = (float)(1.0 - 0.999);
  mu_new = b1 * mu + omb1 * g;
  nu_new = b2 * nu + omb2 * g * g;
  const float step = c.lr_t * (mu_new * c.bc1) / (sqrtf(nu_new * c.bc2) + eps);
  I_new = nan_max(I - step, c.clamp_min);
}

// Error-free residual f_k - K_s x of node k from node k's D, f and U_k
// (coupling to x_{k+1}) and U_{k-1} (coupling to x_{k-1}, used
// transposed); the term order of the plain version's _refine_b2
// (ops/beam_kernel.py).
__device__ __forceinline__ void residual(const Ctx& c, int k, float xp0,
                                         float xp1, float xi0, float xi1,
                                         float xn0, float xn1, float& out0,
                                         float& out1) {
  const int kl = k > 0 ? k - 1 : 0;    // U_{-1} meets x_{-1} = 0
  const float xi[2] = {xi0, xi1};
  const float xp[2] = {xp0, xp1};
  const float xn[2] = {xn0, xn1};
  const float d1 = c.at(k, D1);
  const float md[2][2] = {{c.at(k, D0), d1}, {d1, c.at(k, D2)}};
  const float lm[2][2] = {{c.at(kl, U00), c.at(kl, U10)},
                          {c.at(kl, U01), c.at(kl, U11)}};
  const float um[2][2] = {{c.at(k, U00), c.at(k, U01)},
                          {c.at(k, U10), c.at(k, U11)}};
  const float rhs[2] = {c.at(k, F0), c.at(k, F1)};
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
  out0 = out[0];
  out1 = out[1];
}

// ---------------------------------------------------------------------------
// The first forward sweep.  Helpers: node i's scaled blocks, right-hand side
// and scaled U_i from the inputs into a system tile and the scratch (D, F,
// S, U).  Chain: factorization and y (SI, X).  ANALYSIS: the chain also
// stores C_{i-1} = Sinv_{i-1} U_{i-1}, the W its Schur complement forms,
// and the pivot min_i a_i |det2(S_i)|; the last helper warp walks the axial
// chain a_i (one division a node) beside it and hands a_i over in a tile.
// ---------------------------------------------------------------------------

// Node i's masked diagonal block from the stiffness of elements i - 1 and
// i and its mask.
__device__ __forceinline__ void node_diag(const Stiff& ep, const Stiff& en,
                                          float f1, float f2, float& Dw,
                                          float& Dc, float& Dt) {
  const float d11 = ep.k11 + en.k11;
  const float d12 = -ep.k12 + en.k12;
  const float d22 = ep.k13 + en.k13;
  Dw = d11 * (f1 * f1 + (1.0f - f1));
  Dc = d12 * (f1 * f2);
  Dt = d22 * (f2 * f2 + (1.0f - f2));
}

template <bool ANALYSIS>
__device__ __forceinline__ void forward_factor(const Ctx& c, float* smem) {
  constexpr int T = kLanes;
  const int n = c.n, nelem = n - 1, b0 = c.b0, B = c.B, lane = c.lane;
  const int nchunk = (n + kChunk - 1) / kChunk;
  auto win = [&](int ch) { return smem + (ch & 1) * kWin * T; };
  auto sys = [&](int ch) {
    return smem + 2 * kWin * T + (ch & 1) * kSysVals * kPitch * T;
  };
  auto axt = [&](int ch) {
    return smem + (kAxTile + (ch & 1) * kPitch) * T + lane * kPitch;
  };
  // the helper warp that walks the axial chain (ANALYSIS)
  constexpr int kAxWarp = kHelpers - 1;
  constexpr int kPhase2 = ANALYSIS ? kHelpers - 1 : kHelpers;

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
      stage<kChunk>(s + 2 * kWinE * T, kPitch, c.loads, n, c0, b0, B, htid,
                    kHelperThreads);
      stage<3 * (kChunk + 2)>(s + (2 * kWinE + kPitch) * T, kWinF, c.fr,
                              3 * n, 3 * c0, b0, B, htid, kHelperThreads);
      cp_async_commit();
    };
    // the axial walk's carry: a_{i-1}, rsqrt(d00_{i-1}), u00_{i-1}
    float ax_a = 0.0f, ax_r = 0.0f, ax_u = 0.0f;
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
      const float* wL = win(ch) + 2 * kWinE * T + lane * kPitch;
      const float* wF = win(ch) + (2 * kWinE + kPitch) * T + lane * kWinF;
      float* st = sys(ch) + lane * kPitch;
      // elements j - 1 and j of node j = c0 + k sit at window columns k and
      // k + 1
      auto elem = [&](int j, int col) -> Stiff {
        if (j < 0 || j >= nelem) return {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        return stiffness<ANALYSIS>(wI[col], wLe[col], c.E, c.EA);
      };
      // phase 1, nodes c0 .. c0 + cnt (the next tile's first too): blocks,
      // right-hand side and scales
      const int cnt1 = cnt + (c0 + cnt < n ? 1 : 0);
      for (int k = c.hw; c.live && k < cnt1; k += kHelpers) {
        const int i = c0 + k;
        const Stiff ep = elem(i - 1, k), en = elem(i, k + 1);
        const float f1 = wF[3 * k + 1], f2 = wF[3 * k + 2];
        float Dw, Dc, Dt;
        node_diag(ep, en, f1, f2, Dw, Dc, Dt);
        // Jacobi scaling
        const float sc0 = rsq(Dw), sc1 = rsq(Dt);
        nv[k] = sc0;
        nv[kWinE * T + k] = sc1;
        nv[2 * kWinE * T + k] = en.k11;
        nv[3 * kWinE * T + k] = en.k12;
        nv[4 * kWinE * T + k] = en.k2;
        if (k == cnt) continue;   // the next tile's node: its scales only
        if (ANALYSIS) {
          // the axial chain's masked d00 (its diagonal restored) and u00
          const float f0 = wF[3 * k];
          const float d00 = (ep.ea + en.ea) * (f0 * f0 + (1.0f - f0));
          nv[5 * kWinE * T + k] = d00;
          nv[6 * kWinE * T + k] = rsq(d00);
          nv[7 * kWinE * T + k] = i + 1 < n ? -en.ea * (f0 * wF[3 * k + 3])
                                            : 0.0f;
        }
        // consistent UDL loads + nodal point loads (no axial load exists)
        const float fy = (ep.le + en.le) * c.w * 0.5f + wL[k];
        const float fm = (en.le * en.le - ep.le * ep.le) * c.w / 12.0f;
        const float m0 = Dw * sc0 * sc0;
        const float m1 = Dc * sc0 * sc1;
        const float m2 = Dt * sc1 * sc1;
        const float r0 = fy * f1 * sc0, r1 = fm * f2 * sc1;
        st[k] = m0;
        st[kPitch * T + k] = m1;
        st[2 * kPitch * T + k] = m2;
        st[3 * kPitch * T + k] = r0;
        st[4 * kPitch * T + k] = r1;
        c.at(i, D0) = m0;
        c.at(i, D1) = m1;
        c.at(i, D2) = m2;
        c.at(i, F0) = r0;
        c.at(i, F1) = r1;
        c.at(i, S0) = sc0;
        c.at(i, S1) = sc1;
      }
      help_sync();
      if (ANALYSIS && c.hw == kAxWarp) {
        // the axial Schur chain a_i = d00s_i - u00s_{i-1}^2 / a_{i-1}, in
        // the seven-pass kernel's expressions
        float* at = axt(ch);
        for (int k = 0; c.live && k < cnt; ++k) {
          const float d = nv[5 * kWinE * T + k], r = nv[6 * kWinE * T + k];
          if (c0 + k == 0) {
            ax_a = d * (r * r);
          } else {
            const float u00s = ax_u * ax_r * r;
            const float d00s = d * r * r;
            ax_a = d00s - u00s * u00s / ax_a;
          }
          at[k] = ax_a;
          ax_r = r;
          ax_u = nv[7 * kWinE * T + k];
        }
      } else {
        // phase 2: U_i scaled by the scales of nodes i and i + 1 (zero at
        // the last node)
        for (int k = c.hw; c.live && k < cnt; k += kPhase2) {
          const int i = c0 + k;
          float q00 = 0.0f, q01 = 0.0f, q10 = 0.0f, q11 = 0.0f;
          if (i + 1 < n) {
            const float f1 = wF[3 * k + 1], f2 = wF[3 * k + 2];
            const float g1 = wF[3 * k + 4], g2 = wF[3 * k + 5];
            const float sc0 = nv[k], sc1 = nv[kWinE * T + k];
            const float sn0 = nv[k + 1], sn1 = nv[kWinE * T + k + 1];
            const float k11 = nv[2 * kWinE * T + k],
                        k12 = nv[3 * kWinE * T + k],
                        k2 = nv[4 * kWinE * T + k];
            q00 = -(k11 * (f1 * g1)) * sc0 * sn0;
            q01 = k12 * (f1 * g2) * sc0 * sn1;
            q10 = -(k12 * (f2 * g1)) * sc1 * sn0;
            q11 = k2 * (f2 * g2) * sc1 * sn1;
          }
          st[5 * kPitch * T + k] = q00;
          st[6 * kPitch * T + k] = q01;
          st[7 * kPitch * T + k] = q10;
          st[8 * kPitch * T + k] = q11;
          c.at(i, U00) = q00;
          c.at(i, U01) = q01;
          c.at(i, U10) = q10;
          c.at(i, U11) = q11;
        }
      }
      bar_arrive(kFull + (ch & 1), kThreads);
      help_sync();    // the window and node values are read before reuse
    }
  } else {
    // ---- chain ----
    float p00 = 0.0f, p01 = 0.0f, p10 = 0.0f, p11 = 0.0f;  // U_{i-1}
    float s00 = 0.0f, s01 = 0.0f, s11 = 0.0f, y0 = 0.0f, y1 = 0.0f;
    float piv = 0.0f;
    for (int ch = 0; ch < nchunk; ++ch) {
      bar_sync(kFull + (ch & 1), kThreads);
      const int c0 = ch * kChunk;
      const int cnt = min(kChunk, n - c0);
      const float* st = sys(ch) + lane * kPitch;
      const float* at = axt(ch);
      for (int k = 0; c.live && k < cnt; ++k) {
        const int i = c0 + k;
        const float m0 = st[k], m1 = st[kPitch * T + k],
                    m2 = st[2 * kPitch * T + k];
        const float r0 = st[3 * kPitch * T + k], r1 = st[4 * kPitch * T + k];
        if (i == 0) {
          const float det = m0 * m2 - m1 * m1;
          const float inv = 1.0f / det;
          s00 = m2 * inv;
          s01 = -(m1 * inv);
          s11 = m0 * inv;
          y0 = s00 * r0 + s01 * r1;
          y1 = s01 * r0 + s11 * r1;
          if (ANALYSIS) piv = at[k] * fabsf(det);
        } else {
          const float w00 = s00 * p00 + s01 * p10;
          const float w01 = s00 * p01 + s01 * p11;
          // the seven-pass kernel formed C_{i-1} beside s01 = -(m1 inv),
          // whose negation nvcc folds, so its FMA took the s11 product
          const float w10 = ANALYSIS ? __fmaf_rn(s11, p10, __fmul_rn(s01, p00))
                                     : s01 * p00 + s11 * p10;
          const float w11 = ANALYSIS ? __fmaf_rn(s11, p11, __fmul_rn(s01, p01))
                                     : s01 * p01 + s11 * p11;
          if (ANALYSIS) {
            c.at(i - 1, C00) = w00;
            c.at(i - 1, C01) = w01;
            c.at(i - 1, C10) = w10;
            c.at(i - 1, C11) = w11;
          }
          // S_i = D_i - U^T W (symmetric)
          const float mm0 = m0 - (p00 * w00 + p10 * w10);
          const float mm1 = m1 - (p00 * w01 + p10 * w11);
          const float mm2 = m2 - (p01 * w01 + p11 * w11);
          const float det = mm0 * mm2 - mm1 * mm1;
          const float inv = 1.0f / det;
          s00 = mm2 * inv;
          s01 = -(mm1 * inv);
          s11 = mm0 * inv;
          // fused forward substitution y_i = Sinv_i (f_i - U^T y_{i-1})
          const float qq0 = r0 - (p00 * y0 + p10 * y1);
          const float qq1 = r1 - (p01 * y0 + p11 * y1);
          y0 = s00 * qq0 + s01 * qq1;
          y1 = s01 * qq0 + s11 * qq1;
          if (ANALYSIS) piv = nan_min(piv, at[k] * fabsf(det));
        }
        c.at(i, SI0) = s00;
        c.at(i, SI1) = s01;
        c.at(i, SI2) = s11;
        c.at(i, X0) = y0;
        c.at(i, X1) = y1;
        p00 = st[5 * kPitch * T + k];
        p01 = st[6 * kPitch * T + k];
        p10 = st[7 * kPitch * T + k];
        p11 = st[8 * kPitch * T + k];
      }
      if (ch + 2 < nchunk) bar_arrive(kEmpty + (ch & 1), kThreads);
    }
    if (ANALYSIS && c.live) c.piv[b0 + lane] = piv;
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

// Forward substitution z_i = Sinv_i (rhs_i - U_{i-1}^T z_{i-1}) with the
// saved factors, rhs from components IN, z into OUT (may be IN).  The
// chain alone.
__device__ __forceinline__ void forward_subst(const Ctx& c, float* smem,
                                              int IN, int OUT) {
  constexpr int T = kLanes;
  if (c.hw < 0) {
    const int n = c.n, lane = c.lane;
    const int nchunk = (n + kChunk - 1) / kChunk;
    auto tile = [&](int ch) {
      return smem + (ch & 1) * kSubstRows * kChunk * T;
    };
    float p00 = 0.0f, p01 = 0.0f, p10 = 0.0f, p11 = 0.0f;  // U_{i-1}
    float z0 = 0.0f, z1 = 0.0f;
    stage_rows(c, tile(0), 0, min(kChunk, n), 0, U11 + 1, IN, 2);
    for (int ch = 0; ch < nchunk; ++ch) {
      const int c0 = ch * kChunk;
      const int cnt = min(kChunk, n - c0);
      if (ch + 1 < nchunk) {
        stage_rows(c, tile(ch + 1), c0 + kChunk,
                   min(kChunk, n - c0 - kChunk), 0, U11 + 1, IN, 2);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const float* t = tile(ch) + lane;
      for (int k = 0; c.live && k < cnt; ++k) {
        const float* row = t + k * kSubstRows * T;
        const float si0 = row[SI0 * T], si1 = row[SI1 * T],
                    si2 = row[SI2 * T];
        const float r0 = row[(U11 + 1) * T], r1 = row[(U11 + 2) * T];
        const float q0 = r0 - (p00 * z0 + p10 * z1);
        const float q1 = r1 - (p01 * z0 + p11 * z1);
        z0 = si0 * q0 + si1 * q1;
        z1 = si1 * q0 + si2 * q1;
        c.at(c0 + k, OUT) = z0;
        c.at(c0 + k, OUT + 1) = z1;
        p00 = row[U00 * T];
        p01 = row[U01 * T];
        p10 = row[U10 * T];
        p11 = row[U11 * T];
      }
      __syncwarp();   // the tile is read before it is staged again
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Back sweeps.  Chain: FIRST, X holds y and x_i = y_i - Sinv_i (U_i
// x_{i+1}); else R holds the forward-substituted residual z, the correction
// is c_i = z_i - Sinv_i (U_i c_{i+1}) and x_i = X_i + c_i.  WITH_C reads
// the saved C_i for Sinv_i U_i.  It hands x_i to the helpers through the
// ring, a tile of elements at a time.  Helpers: what LAST says follows x
// (kRefine: node i + 1's residual).
// ---------------------------------------------------------------------------

template <bool FIRST, int LAST, bool WITH_C>
__device__ __forceinline__ void back_sweep(const Ctx& c, float* smem) {
  constexpr int T = kLanes;
  // the chain's rows of a node: SI, U, X (and R); WITH_C: C, X (and R)
  constexpr int kRows =
      WITH_C ? (FIRST ? 6 : 8) : (FIRST ? X1 + 1 : kChainRows);
  constexpr int rX = WITH_C ? 4 : X0;
  constexpr int rR = WITH_C ? 6 : R0;
  const int n = c.n, nelem = n - 1, b0 = c.b0, B = c.B, lane = c.lane;
  const int nce = (nelem + kChunk - 1) / kChunk;
  auto ctile = [&](int ch) {
    return smem + (ch & 1) * kChainRows * kChunk * T;
  };
  float* ring = smem + 2 * kChainRows * kChunk * T;          // [2][kRing][T]
  auto hin = [&](int ch) { return ring + 2 * kRing * T + (ch & 1) * kHin * T; };
  float* outr = ring + 2 * kRing * T + 2 * kHin * T;  // outputs or g_hat ring
  float* part = outr + kOutOrRing * T;   // [3][kHelpers][T]
  auto rx = [&](int comp, int i) -> float& {
    return ring[(comp * kRing + i % kRing) * T + lane];
  };

  if (c.hw < 0) {
    // ---- chain ----
    auto stage_tile = [&](int ch, int node0, int cnt) {
      if (WITH_C)
        stage_rows(c, ctile(ch), node0, cnt, C00, 4, X0, kRows - 4);
      else
        stage_rows(c, ctile(ch), node0, cnt, 0, kRows, 0, 0);
    };
    float cv0 = 0.0f, cv1 = 0.0f;  // the chain's value at node i + 1
    if (c.live) {
      const float a0 = c.at(n - 1, FIRST ? X0 : R0);
      const float a1 = c.at(n - 1, FIRST ? X1 : R1);
      cv0 = a0;
      cv1 = a1;
      float x0 = a0, x1 = a1;
      if (!FIRST) {
        x0 = c.at(n - 1, X0) + a0;
        x1 = c.at(n - 1, X1) + a1;
        if (LAST == kRefine) {
          c.at(n - 1, X0) = x0;
          c.at(n - 1, X1) = x1;
        }
      }
      rx(0, n - 1) = x0;
      rx(1, n - 1) = x1;
    }
    stage_tile(nce - 1, (nce - 1) * kChunk, nelem - (nce - 1) * kChunk);
    for (int d = 0; d < nce; ++d) {
      const int ch = nce - 1 - d;
      const int c0 = ch * kChunk;
      const int cnt = min(kChunk, nelem - c0);
      if (ch > 0) {
        stage_tile(ch - 1, c0 - kChunk, kChunk);
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
        float v0, v1;
        if (WITH_C) {
          v0 = row[0] * cv0 + row[T] * cv1;
          v1 = row[2 * T] * cv0 + row[3 * T] * cv1;
        } else {
          const float u00 = row[U00 * T], u01 = row[U01 * T],
                      u10 = row[U10 * T], u11 = row[U11 * T];
          const float si0 = row[SI0 * T], si1 = row[SI1 * T],
                      si2 = row[SI2 * T];
          const float t0 = u00 * cv0 + u01 * cv1;
          const float t1 = u10 * cv0 + u11 * cv1;
          v0 = si0 * t0 + si1 * t1;
          v1 = si1 * t0 + si2 * t1;
        }
        float x0, x1;
        if (FIRST) {
          cv0 = row[rX * T] - v0;
          cv1 = row[(rX + 1) * T] - v1;
          x0 = cv0;
          x1 = cv1;
        } else {
          cv0 = row[rR * T] - v0;
          cv1 = row[(rR + 1) * T] - v1;
          x0 = row[rX * T] + cv0;
          x1 = row[(rX + 1) * T] + cv1;
        }
        if (LAST == kRefine) {
          c.at(i, X0) = x0;
          c.at(i, X1) = x1;
        }
        rx(0, i) = x0;
        rx(1, i) = x1;
      }
      bar_arrive(kFull + (d & 1), kThreads);
      __syncwarp();   // the tile is read before it is staged again
    }
    __syncthreads();
    return;
  }

  // ---- helpers ----
  const int htid = c.hw * T + lane;
  float* oI = outr;
  float* oMu = outr + kPitch * T;
  float* oNu = outr + 2 * kPitch * T;
  // kAnalysis: V, M of the tile's elements, u of its nodes (and node n - 1)
  float* oV = outr;
  float* oM = outr + kPitch * T;
  float* oU = outr + 2 * kPitch * T;
  // the g_hat terms of element e (kPrimal): gV k11, gM k12, gV k12, gM k13,
  // gM k2
  auto gr_ring = [&](int v, int e) -> float& {
    return outr[(v * kElemRing + e % kElemRing) * T + lane];
  };
  auto stage_hin = [&](int ch) {
    const int c0 = ch * kChunk;
    float* s = hin(ch);
    if (LAST == kSemi || LAST == kPrimal || LAST == kAnalysis) {
      stage<kChunk>(s, kPitch, c.I, nelem, c0, b0, B, htid, kHelperThreads);
      stage<kChunk>(s + kPitch * T, kPitch, c.Le, nelem, c0, b0, B, htid,
                    kHelperThreads);
    }
    if (LAST == kSemi || LAST == kAdjoint) {
      if (LAST == kAdjoint)
        stage<kChunk>(s, kPitch, c.I, nelem, c0, b0, B, htid,
                      kHelperThreads);
      stage<kChunk>(s + 2 * kPitch * T, kPitch, c.mu, nelem, c0, b0, B, htid,
                    kHelperThreads);
      stage<kChunk>(s + 3 * kPitch * T, kPitch, c.nu, nelem, c0, b0, B, htid,
                    kHelperThreads);
    }
    if (LAST == kPrimal)   // the mask of nodes c0 + 1 .. c0 + kChunk
      stage<3 * kChunk>(s + 2 * kPitch * T, kPitch3, c.fr, 3 * n,
                        3 * (c0 + 1), b0, B, htid, kHelperThreads);
    cp_async_commit();
  };
  constexpr bool kStage = LAST != kRefine;
  float tb = 0.0f, ts = 0.0f, ti = 0.0f;
  if (kStage) stage_hin(nce - 1);
  for (int d = 0; d < nce; ++d) {
    const int ch = nce - 1 - d;
    const int c0 = ch * kChunk;
    const int cnt = min(kChunk, nelem - c0);
    if (kStage) {
      if (ch > 0) {
        stage_hin(ch - 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      help_sync();
    }
    bar_sync(kFull + (d & 1), kThreads);
    const float* tI = hin(ch) + lane * kPitch;
    const float* tLe = tI + kPitch * T;
    const float* tMu = tI + 2 * kPitch * T;
    const float* tNu = tI + 3 * kPitch * T;
    const float* tF = hin(ch) + 2 * kPitch * T + lane * kPitch3;
    for (int k = c.hw; c.live && k < cnt; k += kHelpers) {
      const int i = c0 + k;           // element i, nodes i and i + 1
      const float xi0 = rx(0, i), xi1 = rx(1, i);
      const float xj0 = rx(0, i + 1), xj1 = rx(1, i + 1);
      if (LAST == kRefine) {
        // node i + 1's residual, x_{i+2} = 0 past the last node
        float xn0 = 0.0f, xn1 = 0.0f;
        if (i + 2 < n) {
          xn0 = rx(0, i + 2);
          xn1 = rx(1, i + 2);
        }
        float r0, r1;
        residual(c, i + 1, xi0, xi1, xj0, xj1, xn0, xn1, r0, r1);
        c.at(i + 1, R0) = r0;
        c.at(i + 1, R1) = r1;
      } else if (LAST == kAdjoint) {
        // g_e -= lam_e^T (dK_e/dI_e) u_e, then Adam
        const float ly = xi0 * c.at(i, S0), lt = xi1 * c.at(i, S1);
        const float lyj = xj0 * c.at(i + 1, S0), ltj = xj1 * c.at(i + 1, S1);
        const float g = c.at(i, GR) - ((ly - lyj) * c.at(i, RU) +
                                       lt * c.at(i, RTI) + ltj * c.at(i, RTJ));
        adam(c, tI[k], tMu[k], tNu[k], g, oI[lane * kPitch + k],
             oMu[lane * kPitch + k], oNu[lane * kPitch + k]);
      } else if (LAST == kAnalysis) {
        // node i's unscaled displacements (u_x for the whole lane once x_0
        // is known) and element i's end forces from them
        const Stiff s = stiffness<true>(tI[k], tLe[k], c.E);
        const float le = s.le, w = c.w;
        const float uy_i = xi0 * c.at(i, S0), th_i = xi1 * c.at(i, S1);
        const float uy_j = xj0 * c.at(i + 1, S0), th_j = xj1 * c.at(i + 1, S1);
        oV[lane * kPitch + k] = s.k11 * uy_i + s.k12 * th_i - s.k11 * uy_j +
                                s.k12 * th_j - w * le * 0.5f;
        oM[lane * kPitch + k] = s.k12 * uy_i + s.k13 * th_i - s.k12 * uy_j +
                                s.k2 * th_j - w * le * le / 12.0f;
        float* u = oU + lane * kPitchU + 3 * k;
        u[0] = 0.0f;
        u[1] = uy_i;
        u[2] = th_i;
        if (i + 2 == n) {   // the last element writes the last node too
          u[3] = 0.0f;
          u[4] = uy_j;
          u[5] = th_j;
        }
      } else {
        // element i's end forces, loss terms and explicit dL/dI
        const float Ij = tI[k];
        const Stiff s = stiffness<false>(Ij, tLe[k], c.E);
        const float le = s.le, E = c.E, w = c.w;
        const float uy_i = xi0 * c.at(i, S0), th_i = xi1 * c.at(i, S1);
        const float uy_j = xj0 * c.at(i + 1, S0), th_j = xj1 * c.at(i + 1, S1);
        const float V = s.k11 * uy_i + s.k12 * th_i - s.k11 * uy_j +
                        s.k12 * th_j - w * le * 0.5f;
        const float M = s.k12 * uy_i + s.k13 * th_i - s.k12 * uy_j +
                        s.k2 * th_j - w * le * le / 12.0f;
        const float den_b = 2.0f * E * Ij + 1e-6f;
        const float den_s = c.Gs * (0.03f * sqrtf(Ij));
        const float be = M * M / den_b;
        const float se = V * V / den_s;
        float g = 1.0f - c.alpha_m * be * 2.0f * E / den_b -
                  c.alpha_s * 0.5f * se / Ij;
        if (LAST == kSemi) {
          adam(c, Ij, tMu[k], tNu[k], g, oI[lane * kPitch + k],
               oMu[lane * kPitch + k], oNu[lane * kPitch + k]);
        } else {
          // loss cotangents on the force fields; (dK_e/dI_e) u_e rows,
          // which are also the direct dV/dI, dM/dI at fixed u
          const float gV = c.alpha_s * 2.0f * V / den_s;
          const float gM = c.alpha_m * 2.0f * M / den_b;
          const float c1 = E / (le * le * le);
          const float ru = c1 * (12.0f * (uy_i - uy_j) +
                                 6.0f * le * (th_i + th_j));
          const float rti = c1 * le * (6.0f * (uy_i - uy_j) +
                                       le * (4.0f * th_i + 2.0f * th_j));
          const float rtj = c1 * le * (6.0f * (uy_i - uy_j) +
                                       le * (2.0f * th_i + 4.0f * th_j));
          g = g + gV * ru + gM * rti;
          c.at(i, GR) = g;
          c.at(i, RU) = ru;
          c.at(i, RTI) = rti;
          c.at(i, RTJ) = rtj;
          gr_ring(0, i) = gV * s.k11;
          gr_ring(1, i) = gM * s.k12;
          gr_ring(2, i) = gV * s.k12;
          gr_ring(3, i) = gM * s.k13;
          gr_ring(4, i) = gM * s.k2;
        }
        tb = tb + be;
        ts = ts + se;
        ti = ti + Ij;
      }
    }
    if (d + 2 < nce) bar_arrive(kEmpty + (d & 1), kThreads);
    if (!kStage) continue;
    help_sync();
    if (LAST == kPrimal) {
      // node j = i + 1's g_hat = (dV/du)^T gV + (dM/du)^T gM over elements
      // j (absent at the last node) and j - 1, masked and scaled: the
      // adjoint's right-hand side
      for (int k = c.hw; c.live && k < cnt; k += kHelpers) {
        const int j = c0 + k + 1;
        const bool has_n = j < nelem;
        const float a_n = has_n ? gr_ring(0, j) : 0.0f;
        const float b_n = has_n ? gr_ring(1, j) : 0.0f;
        const float c_n = has_n ? gr_ring(2, j) : 0.0f;
        const float d_n = has_n ? gr_ring(3, j) : 0.0f;
        const float gy = a_n + b_n - gr_ring(0, j - 1) - gr_ring(1, j - 1);
        const float gt = c_n + d_n + gr_ring(2, j - 1) + gr_ring(4, j - 1);
        c.at(j, F0) = gy * tF[3 * k + 1] * c.at(j, S0);
        c.at(j, F1) = gt * tF[3 * k + 2] * c.at(j, S1);
      }
    } else if (LAST == kAnalysis) {
      // coalesced write-back of the tile's V, M and u
      for (int kk = htid; kk < T * kChunk; kk += kHelperThreads) {
        const int r = kk / kChunk, col = kk - r * kChunk;
        if (b0 + r < B && col < cnt) {
          const size_t o = (size_t)(b0 + r) * nelem + c0 + col;
          c.V[o] = oV[r * kPitch + col];
          c.M[o] = oM[r * kPitch + col];
        }
      }
      const int ucols = 3 * (cnt + (c0 + cnt == nelem ? 1 : 0));
      for (int kk = htid; kk < T * kPitchU; kk += kHelperThreads) {
        const int r = kk / kPitchU, col = kk - r * kPitchU;
        if (b0 + r < B && col < ucols)
          c.u[(size_t)(b0 + r) * 3 * n + 3 * c0 + col] = oU[r * kPitchU + col];
      }
    } else {
      // coalesced write-back of the tile's I, mu, nu
      for (int kk = htid; kk < T * kChunk; kk += kHelperThreads) {
        const int r = kk / kChunk, col = kk - r * kChunk;
        if (b0 + r < B && col < cnt) {
          const size_t o = (size_t)(b0 + r) * nelem + c0 + col;
          c.I_out[o] = oI[r * kPitch + col];
          c.mu_out[o] = oMu[r * kPitch + col];
          c.nu_out[o] = oNu[r * kPitch + col];
        }
      }
    }
    help_sync();   // tiles and rings are read before they are written again
  }
  if (c.hw == 0 && c.live) {
    if (LAST == kRefine) {
      // node 0's residual (no U_{-1} term: x_{-1} = 0)
      float r0, r1;
      residual(c, 0, 0.0f, 0.0f, rx(0, 0), rx(1, 0), rx(0, 1), rx(1, 1), r0,
               r1);
      c.at(0, R0) = r0;
      c.at(0, R1) = r1;
    }
    if (LAST == kPrimal) {
      // node 0's g_hat: element 0 only
      const float* f = c.fr + (size_t)(b0 + lane) * 3 * n;
      const float gy = gr_ring(0, 0) + gr_ring(1, 0);
      const float gt = gr_ring(2, 0) + gr_ring(3, 0);
      c.at(0, F0) = gy * f[1] * c.at(0, S0);
      c.at(0, F1) = gt * f[2] * c.at(0, S1);
    }
  }
  if (LAST == kAnalysis) {
    // u_x = x_0 * 0 at every node, the JAX kernel's exact zero: the tiles
    // wrote +0, so only a lane whose zero is -0 or NaN is written again
    unsigned* redo = reinterpret_cast<unsigned*>(part);
    float* zero = part + 1;
    if (c.hw == 0) {
      const float z = c.live ? rx(0, 0) * 0.0f : 0.0f;
      zero[lane] = z;
      const unsigned m = __ballot_sync(0xffffffffu, __float_as_uint(z) != 0u);
      if (lane == 0) *redo = m;
    }
    help_sync();
    const unsigned m = *redo;
    for (int kk = htid; m != 0u && kk < T * n; kk += kHelperThreads) {
      const int r = kk / n, i = kk - r * n;
      if ((m >> r) & 1u) c.u[(size_t)(b0 + r) * 3 * n + 3 * i] = zero[r];
    }
  }
  if (LAST == kSemi || LAST == kPrimal) {
    part[(0 * kHelpers + c.hw) * T + lane] = tb;
    part[(1 * kHelpers + c.hw) * T + lane] = ts;
    part[(2 * kHelpers + c.hw) * T + lane] = ti;
    help_sync();
    if (c.hw == 0 && c.live) {
      float sb = 0.0f, ss = 0.0f, si = 0.0f;
      for (int h = 0; h < kHelpers; ++h) {
        sb = sb + part[(0 * kHelpers + h) * T + lane];
        ss = ss + part[(1 * kHelpers + h) * T + lane];
        si = si + part[(2 * kHelpers + h) * T + lane];
      }
      reinterpret_cast<float4*>(c.stats)[b0 + lane] = make_float4(
          si + c.alpha_m * sb + c.alpha_s * ss, si, c.alpha_m * sb,
          c.alpha_s * ss);
    }
  }
  __syncthreads();
}

// The sweeps after a forward one: the back sweep, then per refinement a
// forward and a back sweep; LAST names the last back sweep's work.  The
// analysis's back substitutions read the saved C.
template <int LAST>
__device__ __forceinline__ void solve_tail(const Ctx& c, float* smem,
                                           int refine) {
  constexpr bool C = LAST == kAnalysis;
  if (refine == 0) {
    back_sweep<true, LAST, C>(c, smem);
    return;
  }
  back_sweep<true, kRefine, C>(c, smem);
  for (int k = 1; k < refine; ++k) {
    forward_subst(c, smem, R0, R0);
    back_sweep<false, kRefine, C>(c, smem);
  }
  forward_subst(c, smem, R0, R0);
  back_sweep<false, LAST, C>(c, smem);
}

// Copy the block's rows of a lanes-first (B, nelem) array from src: a row
// whose bit is set in mask1 to dst1, in mask0 to dst0.  Warp w takes rows w,
// w + kWarps, .., its lanes the columns; a pass issues all its loads before
// any store, so that the copy waits on memory about once, not once a row.
__device__ __forceinline__ void copy_rows(const float* __restrict__ src,
                                          float* __restrict__ dst1,
                                          unsigned mask1,
                                          float* __restrict__ dst0,
                                          unsigned mask0, int b0, int nelem) {
  constexpr int kWarps = kThreads / kLanes, kRowsEach = kLanes / kWarps;
  static_assert(kLanes % kWarps == 0,
                "copy_rows: the warps take every row of the block");
  constexpr int kCols = 4;   // columns a lane takes a pass
  const int lane = threadIdx.x % kLanes, warp = threadIdx.x / kLanes;
  if ((mask1 | mask0) == 0u) return;
  for (int c0 = lane; c0 < nelem; c0 += kCols * kLanes) {
    float v[kRowsEach][kCols];
#pragma unroll
    for (int i = 0; i < kRowsEach; ++i) {
      const int r = warp + i * kWarps;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = c0 + j * kLanes;
        if (((mask1 | mask0) >> r) & 1u && col < nelem)
          v[i][j] = src[(size_t)(b0 + r) * nelem + col];
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsEach; ++i) {
      const int r = warp + i * kWarps;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = c0 + j * kLanes;
        const size_t o = (size_t)(b0 + r) * nelem + col;
        if (col >= nelem) continue;
        if ((mask1 >> r) & 1u) dst1[o] = v[i][j];
        else if ((mask0 >> r) & 1u) dst0[o] = v[i][j];
      }
    }
  }
}

// The epoch loop's freeze bookkeeping after the step (the plain version is
// ops/beam_kernel.py freeze_lanes).  A lane active on entry (done == 0)
// saves its input I as its last solved I and takes the step's total:
// improved = total < best - tolerance (in float32, as torch subtracts),
// no_improve reset or counted, best kept or replaced, n_epochs + 1, done
// once no_improve reaches patience.  A lane done on entry has its inputs I,
// mu, nu and its previous stats as outputs, and its state is left alone.
// Every thread of the block, after the step's outputs are written.  Not
// inlined: inlined, its address arithmetic was hoisted into the sweeps and
// the kernel spilled 164 bytes where it spills 36.
__device__ __noinline__ void lane_epilogue(
    const float* __restrict__ I, const float* __restrict__ mu,
    const float* __restrict__ nu, float* __restrict__ I_out,
    float* __restrict__ mu_out, float* __restrict__ nu_out,
    float* __restrict__ stats, const Lanes& st, int B, int n) {
  const int nelem = n - 1, lane = threadIdx.x % kLanes;
  const int b0 = blockIdx.x * kLanes, b = b0 + lane;
  const bool live = b < B;
  const bool act = live && !st.done[b];
  const unsigned active = __ballot_sync(0xffffffffu, act);
  const unsigned done = __ballot_sync(0xffffffffu, live) & ~active;
  copy_rows(I, st.I_solved, active, I_out, done, b0, nelem);
  copy_rows(mu, mu_out, done, nullptr, 0u, b0, nelem);
  copy_rows(nu, nu_out, done, nullptr, 0u, b0, nelem);
  __syncthreads();   // every warp has read the done flags
  if (threadIdx.x >= kLanes || !live) return;   // the chain warp's lanes
  float4* out = reinterpret_cast<float4*>(stats) + b;
  if (!act) {
    const float* prev = st.stats_prev + 4 * (size_t)b;
    *out = make_float4(prev[0], prev[1], prev[2], prev[3]);
    return;
  }
  const float total = out->x;
  const bool improved = total < st.best[b] - st.tolerance;
  const int ni = improved ? 0 : st.no_improve[b] + 1;
  if (improved) st.best[b] = total;
  st.no_improve[b] = ni;
  st.n_epochs[b] += 1;
  st.done[b] = ni >= st.patience;
}

__global__ void __launch_bounds__(kThreads, 2)
beam_opt_step_kernel(const float* __restrict__ I, const float* __restrict__ mu,
                     const float* __restrict__ nu,
                     const float* __restrict__ Le,
                     const float* __restrict__ fr,
                     const float* __restrict__ loads,
                     const float* __restrict__ udl,
                     float* __restrict__ I_out, float* __restrict__ mu_out,
                     float* __restrict__ nu_out, float* __restrict__ stats,
                     float* __restrict__ scr, const Lanes st, int B, int Bp,
                     int n, int refine, int grad_semi, float E, float Gs,
                     float alpha_m, float alpha_s, float clamp_min,
                     float lr_t, float bc1, float bc2) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const bool live = b0 + lane < B;
  const int nc = grad_semi ? NC_SEMI : NC_ADJOINT;
  const Ctx c{I, mu, nu, Le, fr, loads, I_out, mu_out, nu_out, stats,
              scr + b0, scr + b0 + lane, B, n, nc, Bp, b0, nc * Bp, lane,
              warp - 1, live, live ? udl[b0 + lane] : 0.0f, E, Gs, alpha_m,
              alpha_s, clamp_min, lr_t, bc1, bc2};
  const bool lanes = st.done != nullptr;
  // a block whose lanes are all done only copies their state
  if (lanes && !__syncthreads_or(live && !st.done[b0 + lane])) {
    lane_epilogue(I, mu, nu, I_out, mu_out, nu_out, stats, st, B, n);
    return;
  }
  forward_factor<false>(c, smem);
  if (grad_semi) {
    solve_tail<kSemi>(c, smem, refine);
  } else {
    solve_tail<kPrimal>(c, smem, refine);
    // K lam = g_hat (K is symmetric) with the same factors
    forward_subst(c, smem, F0, X0);
    solve_tail<kAdjoint>(c, smem, refine);
  }
  if (lanes)
    lane_epilogue(I, mu, nu, I_out, mu_out, nu_out, stats, st, B, n);
}

__global__ void __launch_bounds__(kThreads, 2)
beam_analysis_kernel(const float* __restrict__ I,
                     const float* __restrict__ Le,
                     const float* __restrict__ fr,
                     const float* __restrict__ loads,
                     const float* __restrict__ udl, float* __restrict__ u,
                     float* __restrict__ V, float* __restrict__ M,
                     float* __restrict__ piv, float* __restrict__ scr, int B,
                     int Bp, int n, int refine, float E, float EA) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int b0 = blockIdx.x * kLanes;
  const bool live = b0 + lane < B;
  constexpr int nc = NC_ANALYSIS;
  const Ctx c{I, nullptr, nullptr, Le, fr, loads, nullptr, nullptr, nullptr,
              nullptr, scr + b0, scr + b0 + lane, B, n, nc, Bp, b0, nc * Bp,
              lane, warp - 1, live, live ? udl[b0 + lane] : 0.0f, E, 0.0f,
              0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, u, V, M, piv, EA};
  forward_factor<true>(c, smem);
  solve_tail<kAnalysis>(c, smem, refine);
}

// The kernels' dynamic shared memory limit, raised once a device: the
// attribute holds for the device's context, and the epoch loop need not
// pay the call every launch.  `set` records the devices done.
constexpr int kMaxDevices = 64;
unsigned char g_opt_smem[kMaxDevices], g_analysis_smem[kMaxDevices];

template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, int bytes, unsigned char* set) {
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && set[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && known) set[dev] = 1;
  return e;
}

}  // namespace

extern "C" {

// Scratch floats per node per lane, semi (grad_semi != 0) or adjoint; the
// scratch is (n, nc, Bp) with Bp the lane count rounded up to 32.
int beam_opt_scratch_per_node(int grad_semi) {
  return grad_semi ? NC_SEMI : NC_ADJOINT;
}

// Lanes-first float32 I/O: I, mu, nu, Le, I_out, mu_out, nu_out (B, n - 1),
// free (B, n, 3), loads (B, n), udl (B,), stats (B, 4); all contiguous, n
// >= 2.  The lane state, or done == NULL for none: done (B,) bool, best
// (B,) float32, no_improve and n_epochs (B,) int32, I_solved (B, n - 1),
// stats_prev (B, 4), contiguous, updated in place (but stats_prev).
int beam_opt_step_f32(const float* I, const float* mu, const float* nu,
                      const float* Le, const float* fr, const float* loads,
                      const float* udl, float* I_out, float* mu_out,
                      float* nu_out, float* stats, float* scr, bool* done,
                      float* best, int* no_improve, int* n_epochs,
                      float* I_solved, const float* stats_prev, int B, int n,
                      int refine, int grad_semi, int patience, float E,
                      float G, float alpha_m, float alpha_s, float clamp_min,
                      float lr_t, float bc1, float bc2, float tolerance,
                      void* stream) {
  if (B <= 0) return 0;
  if (n < 2 || refine < 0) return (int)cudaErrorInvalidValue;
  const int bytes = kSmemFloats * (int)sizeof(float);
  const cudaError_t set = smem_limit(beam_opt_step_kernel, bytes, g_opt_smem);
  if (set != cudaSuccess) return (int)set;
  const int blocks = (B + kLanes - 1) / kLanes;
  const Lanes st{done,     best,       no_improve, n_epochs,
                 I_solved, stats_prev, tolerance,  patience};
  beam_opt_step_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      I, mu, nu, Le, fr, loads, udl, I_out, mu_out, nu_out, stats, scr, st,
      B, blocks * kLanes, n, refine, grad_semi, E, G, alpha_m, alpha_s,
      clamp_min, lr_t, bc1, bc2);
  return (int)cudaGetLastError();
}

// Scratch floats per node per lane of the analysis: the semi step's and C.
int beam_analysis_scratch_per_node(void) { return NC_ANALYSIS; }

// Lanes-first float32 I/O: I, Le, V, M (B, n - 1), free (B, n, 3), loads
// (B, n), udl (B,), u (B, n, 3), piv (B,); scratch (n, NC_ANALYSIS, Bp);
// all contiguous, n >= 2.
int beam_analysis_f32(const float* I, const float* Le, const float* fr,
                      const float* loads, const float* udl, float* u,
                      float* V, float* M, float* piv, float* scr, int B,
                      int n, int refine, float E, float EA, void* stream) {
  if (B <= 0) return 0;
  if (n < 2 || refine < 0) return (int)cudaErrorInvalidValue;
  const int bytes = kSmemFloats * (int)sizeof(float);
  const cudaError_t set =
      smem_limit(beam_analysis_kernel, bytes, g_analysis_smem);
  if (set != cudaSuccess) return (int)set;
  const int blocks = (B + kLanes - 1) / kLanes;
  beam_analysis_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
      I, Le, fr, loads, udl, u, V, M, piv, scr, B, blocks * kLanes, n,
      refine, E, EA);
  return (int)cudaGetLastError();
}

}  // extern "C"
