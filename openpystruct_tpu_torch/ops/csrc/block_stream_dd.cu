// Streamed symmetric 3x3 block-tridiagonal Thomas solve in float64 for
// Hopper (sm_90a), lanes-first, with the beam assembly as an input mode.
//
// stream_dd_fwd_kernel and stream_dd_bwd_kernel replace
// openpystruct_tpu/ops/block_stream_dd.py _fwd_kernel_dd and _bwd_kernel_dd
// (launcher pallas_solve_dd_streamed):
// the block-Thomas recurrence of block_stream.cu (kernel #6) carried in
// float64, the H100's native type where the TPU carried float32 hi/lo
// pairs.  The forward launch factors and substitutes forward from zero
// carries, S_i = D_i - U_{i-1}^T C_{i-1}, C_i = S_i^-1 U_i (U_{n-1} = 0),
// y_i = S_i^-1 (b_i - U_{i-1}^T y_{i-1}), writes C and y to a workspace and
// keeps each lane's running min |det S_i| (the Schur-pivot diagnostic, NaN
// once any det is, as torch.minimum propagates it), written once; the
// backward launch reads C and y back in reverse, x_i = y_i - C_i x_{i+1}
// from x_n = 0, carries x in float64 and writes it as float32.
//
// Two input modes of the same two sweeps (template flag kBeam):
//  - the system solve (thomas_streamed_dd_f64): float64 diag (B, n, 3, 3),
//    upper (B, n-1, 3, 3), rhs (B, n, 3) in, x (B, n, 3) out;
//  - the beam solve (beam_streamed_dd_f64, the whole route of
//    ops/block_stream_dd.py solve_beam_dd_streamed): the callers' float32
//    I, Le (B, n-1), free mask (B, n, 3), point loads (B, n) and udl (B,)
//    in.  Helper warps assemble each row in float64 as the plain
//    assemble_beam_system_dd does on the card, one rounding per PyTorch op
//    (__dmul_rn / __dadd_rn / __dsub_rn / __ddiv_rn, which nvcc never
//    contracts; the division by the scalar 12 a product with its
//    reciprocal, as PyTorch divides a CUDA tensor by a Python number):
//    the element stiffness, the masked diagonal and upper blocks with the
//    original diagonal entry put back, the load vector, the Jacobi scale
//    s = rsqrt(diag) and the scaled row; they write s beside C and y.  The
//    backward sweep writes u = (float)((double)(float)x * s), the rounding
//    chain of (x.to(float64) * s).to(float32), instead of x.
//
// Arithmetic: the row step (inv3, mtm, mm, mv, mtv, fwd_row, bwd_row) is
// the one-thread-a-lane kernel's thomas_fwd_kernel<double, true> /
// thomas_bwd_kernel<double, float>, expression for expression: the
// cofactor inverse times 1/det (block_tridiag.py _inv3_det), 3x3 products
// summed over k = 0, 1, 2, nvcc free to contract a*b+c into a DFMA within a
// row as it was there.  No --use_fast_math: IEEE division and square root.
// Each lane is one thread's chain, so a NaN lane touches no other lane.
//
// Bound on an H100 SXM (3.35 TB/s, 34 TFLOP/s float64): the system solve
// must read diag, upper and rhs once (21n - 9 doubles a lane) and write x
// and the pivot (3n + 1 floats): 88.6 us at B = 16384, n = 101; its ~194
// flops a row take 9.4 us.  The beam solve reads ~6n floats a lane and
// writes 3n + 1: ~18 us at B = 16384, n = 101 (the assembly's ~95 flops a
// row add ~5 us at the float64 rate, below it).  The streamed contract adds
// the workspace, written once and read once: C and y, 12 doubles a row, and
// s, 3 more in the beam mode, 159 MB (199 MB) at B = 16384, n = 101, ~95
// (~119) us more each way through device memory.  What held the
// one-thread-a-lane kernel it replaces (0.40 ms at n = 101, and 0.39 ms of
// layout copies around it) was latency: each row's loads were issued only
// after the previous row's chain, one memory round trip a row.  The design
// is block_stream.cu's, in float64:
//  - lanes-first I/O, no layout copy.  A block owns L lanes (4-32) and one
//    chain warp, thread = lane.  In the system mode two staging warps copy
//    each lane's diag, upper and rhs rows (contiguous runs, 8-byte aligned)
//    with 8-byte cp.async, 32 consecutive doubles an instruction.  In the
//    beam mode four helper warps each take a quarter of a tile's rows
//    (thread = lane and a run of rows), load the float32 inputs of their
//    rows of the next tile into registers before assembling this one, and
//    carry the last element's and node's values from row to row.
//  - rows a tile ahead of the chain: a ring of 2 tiles of kT = 8 rows x L
//    lanes in shared memory (lane-major, odd pitch in doubles: conflict
//    free), handed over through full/empty named barriers, so the chain
//    warp issues nothing but its rows.
//  - a private workspace, lanes innermost within the block: (blocks, n,
//    kWs, L) doubles, C then y (then s).  The forward chain writes each
//    component as one coalesced store; in the backward launch one warp
//    stages kT rows of the block, one contiguous run, with 16-byte
//    cp.async, a ring of 3 tiles, in reverse; the chain runs the rows and a
//    third warp writes each finished x (or u) tile, left in one of two
//    shared buffers, to lanes-first rows.
//  - sizes for two blocks an SM at 32 lanes: forward 86,528 B (two 21 kT +
//    1 doubles slots a lane), backward 80,128 B (system) or 98,560 B (beam:
//    three slots of 8 x 12 or 15 doubles a lane and two x tiles), both
//    under half of the SM's 228 KB; __launch_bounds__ asks for two blocks.
//    L is chosen at launch from B and the SM count, block_stream.cu's rule:
//    the fewest lanes per block whose blocks fit two to an SM.
//
// Layout: lanes-first, contiguous; workspace (ceil(B / L), n, kWs, L)
// doubles, which fits in ceil(B / 32) * 32 * n * kWs doubles at every L (L
// divides 32).  The chain warp's threads past the block's lanes run the
// chain on a live lane's tile and store nothing; no lane past B is read or
// written.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kT = 8;                     // rows per staged tile
constexpr int kRun = 21 * kT;             // a lane's diag, upper, b per tile
constexpr int kPitch = kRun + 1;          // odd pitches: no bank conflicts
constexpr int kPitchX = 3 * kT + 1;
constexpr int kStagers = 2;               // system mode staging warps
constexpr int kHelpers = 4;               // beam mode assembly warps
constexpr int kRingFwd = 2;               // ring depths, in tiles
constexpr int kRingBwd = 3;
constexpr int kBwdThreads = 3 * 32;       // chain, stager, x writer
// named barriers (0 is __syncthreads'): ring slot s full / empty, x tile
// buffer full / empty
constexpr int kFull = 1, kEmpty = 5, kXFull = 9, kXEmpty = 11;
constexpr double kInv12 = 1.0 / 12.0;     // PyTorch's x / 12.0 on the card

// workspace doubles per row: C and y, and in the beam mode s
__host__ __device__ constexpr int ws_row(bool beam) { return beam ? 15 : 12; }
__host__ __device__ constexpr int fwd_threads(bool beam) {
  return 32 * (1 + (beam ? kHelpers : kStagers));
}
// doubles of a forward ring slot, a backward ring slot; floats of an x tile
__host__ __device__ constexpr int fwd_slot(int L) { return L * kPitch; }
__host__ __device__ constexpr int bwd_slot(int L, bool beam) {
  return kT * ws_row(beam) * L;
}
__host__ __device__ constexpr int x_tile(int L) { return L * kPitchX; }

struct M3 {
  double m[3][3];
};
struct V3 {
  double v[3];
};

__device__ __forceinline__ M3 read_m(const double* p) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) r.m[a][c] = p[a * 3 + c];
  return r;
}

__device__ __forceinline__ V3 read_v(const double* p) {
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
    for (int c = 0; c < 3; ++c) r.m[a][c] = 0.0;
  return r;
}

// Cofactor inverse times 1/det (block_tridiag.py _inv3_det); det out.
__device__ __forceinline__ M3 inv3(const M3& x, double& det) {
  const double a = x.m[0][0], b = x.m[0][1], c = x.m[0][2];
  const double d = x.m[1][0], e = x.m[1][1], f = x.m[1][2];
  const double g = x.m[2][0], h = x.m[2][1], i = x.m[2][2];
  const double A = e * i - f * h;
  const double B = -(d * i - f * g);
  const double C = d * h - e * g;
  const double D = -(b * i - c * h);
  const double E = a * i - c * g;
  const double F = -(a * h - b * g);
  const double G = b * f - c * e;
  const double H = -(a * f - c * d);
  const double I = a * e - b * d;
  det = a * A + b * B + c * C;
  const double inv_det = 1.0 / det;
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
                                        const V3& b, Carry& k, double& det) {
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

// ---------------------------------------------------------------------------
// The beam assembly, op for op as ops/block_stream_dd.py
// assemble_beam_system_dd runs on the card.  Every rounding is explicit.
// ---------------------------------------------------------------------------

// torch.rsqrt of a CUDA float64 tensor: CUDA's rsqrt(double)
__device__ __forceinline__ double torch_rsqrt(double x) { return rsqrt(x); }

// An element's stiffness and load terms.
struct Elem {
  double ea, k11, k12, k13, k2;  // EA/Le, 12EI/Le^3, 6EI/Le^2, 4EI/Le, 2EI/Le
  double half, fme;              // w Le 0.5, w Le Le / 12
};

__device__ __forceinline__ Elem element(float I, float Le, double w,
                                        double E, double EA) {
  const double le = Le;
  const double r = __ddiv_rn(1.0, le);           // 1.0 / Le: reciprocal
  const double eil = __dmul_rn(__dmul_rn(E, (double)I), r);
  const double eil2 = __dmul_rn(eil, r);
  const double eil3 = __dmul_rn(eil2, r);
  const double wl = __dmul_rn(w, le);
  Elem e;
  e.ea = __dmul_rn(EA, r);
  e.k11 = __dmul_rn(12.0, eil3);
  e.k12 = __dmul_rn(6.0, eil2);
  e.k13 = __dmul_rn(4.0, eil);
  e.k2 = __dmul_rn(2.0, eil);
  e.half = __dmul_rn(wl, 0.5);
  e.fme = __dmul_rn(__dmul_rn(wl, le), kInv12);
  return e;
}

// F.pad(left, (1, 0)) + F.pad(right, (0, 1)) at one node: the left
// element's end (0 at node 0) plus the right one's start (0 at node n-1).
__device__ __forceinline__ double node_sum(bool hl, double l, bool hr,
                                           double r) {
  return __dadd_rn(hl ? l : 0.0, hr ? r : 0.0);
}

// d fr fr + d (1 - fr): a masked diagonal entry, the original put back.
__device__ __forceinline__ double masked(double d, double fr) {
  return __dadd_rn(__dmul_rn(__dmul_rn(d, fr), fr),
                   __dmul_rn(d, __dsub_rn(1.0, fr)));
}

// (x s_a) s_b
__device__ __forceinline__ double scale2(double x, double sa, double sb) {
  return __dmul_rn(__dmul_rn(x, sa), sb);
}

// A node's masked, unscaled diagonal block (its nonzeros), free mask and
// scale.
struct Node {
  double d00, d11, d22, d12, d21;
  double fr[3], s[3];
};

__device__ __forceinline__ Node node(const Elem& l, bool hl, const Elem& r,
                                     bool hr, const float* fr) {
  Node o;
#pragma unroll
  for (int a = 0; a < 3; ++a) o.fr[a] = fr[a];
  const double d12 = node_sum(hl, -l.k12, hr, r.k12);
  o.d00 = masked(node_sum(hl, l.ea, hr, r.ea), o.fr[0]);
  o.d11 = masked(node_sum(hl, l.k11, hr, r.k11), o.fr[1]);
  o.d22 = masked(node_sum(hl, l.k13, hr, r.k13), o.fr[2]);
  o.d12 = __dmul_rn(__dmul_rn(d12, o.fr[1]), o.fr[2]);
  o.d21 = __dmul_rn(__dmul_rn(d12, o.fr[2]), o.fr[1]);
  o.s[0] = torch_rsqrt(o.d00);
  o.s[1] = torch_rsqrt(o.d11);
  o.s[2] = torch_rsqrt(o.d22);
  return o;
}

// Write row i's scaled diag, upper (with node i + 1, where i < n - 1) and
// right-hand side into a lane's forward slot at row r.
__device__ __forceinline__ void write_row(double* row, int r, const Node& p,
                                          const Elem& l, bool hl,
                                          const Elem& e, bool he,
                                          const Node& q, float load) {
  const double* s = p.s;
  double dm[3][3] = {{p.d00, 0.0, 0.0}, {0.0, p.d11, p.d12},
                     {0.0, p.d21, p.d22}};
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      row[9 * r + 3 * a + b] = scale2(dm[a][b], s[a], s[b]);
  if (he) {  // element i joins node i to node i + 1
    const double* fn = p.fr;
    const double* fx = q.fr;
    double um[3][3] = {{0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}, {0.0, 0.0, 0.0}};
    um[0][0] = __dmul_rn(__dmul_rn(-e.ea, fn[0]), fx[0]);
    um[1][1] = __dmul_rn(__dmul_rn(-e.k11, fn[1]), fx[1]);
    um[1][2] = __dmul_rn(__dmul_rn(e.k12, fn[1]), fx[2]);
    um[2][1] = __dmul_rn(__dmul_rn(-e.k12, fn[2]), fx[1]);
    um[2][2] = __dmul_rn(__dmul_rn(e.k2, fn[2]), fx[2]);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        row[9 * kT + 9 * r + 3 * a + b] = scale2(um[a][b], s[a], q.s[b]);
  }
  const double fy = __dadd_rn(node_sum(hl, l.half, he, e.half), (double)load);
  const double fm = __dsub_rn(he ? e.fme : 0.0, hl ? l.fme : 0.0);
  row[18 * kT + 3 * r + 0] = __dmul_rn(0.0, s[0]);
  row[18 * kT + 3 * r + 1] = __dmul_rn(__dmul_rn(fy, p.fr[1]), s[1]);
  row[18 * kT + 3 * r + 2] = __dmul_rn(__dmul_rn(fm, p.fr[2]), s[2]);
}

// The beam mode's inputs (float32, lanes-first) and constants.
struct BeamIn {
  const float* I;      // (B, n - 1)
  const float* Le;     // (B, n - 1)
  const float* free;   // (B, n, 3)
  const float* loads;  // (B, n)
  const float* udl;    // (B,)
  double E, EA;
};

// The system mode's inputs (float64, lanes-first).
struct SysIn {
  const double* diag;   // (B, n, 3, 3)
  const double* upper;  // (B, n - 1, 3, 3)
  const double* rhs;    // (B, n, 3)
};

// One helper thread's raw float32 inputs for a run of kRows rows from row
// i of one lane: I and Le of elements i - 1 .. i + kRows, the free mask of
// nodes i .. i + kRows, the point loads of nodes i .. i + kRows - 1; 0 past
// either end.  Loaded a tile ahead of their use, so that their latency
// overlaps the tile before.
template <int kRows>
struct Raw {
  float I[kRows + 2], Le[kRows + 2], fr[3 * (kRows + 1)], ld[kRows];
};

template <int kRows>
__device__ __forceinline__ Raw<kRows> fetch(const BeamIn& in, int b, int n,
                                            int i) {
  const int ne = n - 1;
  const float* I = in.I + (size_t)b * ne;
  const float* Le = in.Le + (size_t)b * ne;
  const float* fr = in.free + (size_t)b * n * 3;
  const float* ld = in.loads + (size_t)b * n;
  Raw<kRows> w;
#pragma unroll
  for (int k = 0; k < kRows + 2; ++k) {
    const int e = i - 1 + k;
    const bool ok = e >= 0 && e < ne;
    w.I[k] = ok ? I[e] : 0.0f;
    w.Le[k] = ok ? Le[e] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kRows + 1; ++k)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      w.fr[3 * k + a] = i + k < n ? fr[3 * (i + k) + a] : 0.0f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) w.ld[k] = i + k < n ? ld[i + k] : 0.0f;
  return w;
}

// Assemble rows i .. i + cnt - 1 (cnt <= kRows) of one lane from its raw
// inputs (fetched from row i) into its slot row, r0 = i's row in the tile,
// and write their scales to the workspace (w: the lane's column of the
// block's workspace).  The first row's left element and node are formed
// once, then each row forms element i + 1 and node i + 1 and moves them
// down.
template <int kRows>
__device__ __forceinline__ void assemble_run(double* row, double* w, int L,
                                             const BeamIn& in, double udl,
                                             const Raw<kRows>& raw, int n,
                                             int i, int r0, int cnt) {
  const int ne = n - 1;
  auto elem = [&](int k) {  // element i - 1 + k
    return element(raw.I[k], raw.Le[k], udl, in.E, in.EA);
  };
  // element i - 1 (left of node i) and element i (right of it)
  Elem l = i >= 1 ? elem(0) : Elem{};
  Elem e = i < ne ? elem(1) : Elem{};
  Node p = node(l, i >= 1, e, i < ne, raw.fr);
#pragma unroll
  for (int k = 0; k < kRows; ++k, ++i) {
    if (k == cnt) break;
    Elem x = e;
    Node q = p;
    if (i < ne) {  // node i + 1, from elements i and i + 1
      x = i + 1 < ne ? elem(k + 2) : Elem{};
      q = node(e, true, x, i + 1 < ne, raw.fr + 3 * (k + 1));
    }
    write_row(row, r0 + k, p, l, i >= 1, e, i < ne, q, raw.ld[k]);
    double* ws = w + (size_t)i * ws_row(true) * L;
#pragma unroll
    for (int a = 0; a < 3; ++a) ws[(12 + a) * L] = p.s[a];
    l = e;
    e = x;
    p = q;
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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
// slot (a staging warp, lane t of it): lane j's diag, upper and rhs rows
// are three contiguous runs (upper stops at row n - 2), copied to
// slot[j * kPitch + (0, 9 kT, 18 kT) + e], 32 consecutive doubles per
// instruction.
__device__ __forceinline__ void stage_rows(double* slot, const SysIn& in,
                                           int t, int b0, int j0, int j1,
                                           int n, int i0) {
  const int nd = 9 * min(kT, n - i0);
  const int nu = 9 * min(kT, n - 1 - i0);
  const int nb = 3 * min(kT, n - i0);
  const double* sd = in.diag + ((size_t)(b0 + j0) * n + i0) * 9 + t;
  const double* su = in.upper + ((size_t)(b0 + j0) * (n - 1) + i0) * 9 + t;
  const double* sb = in.rhs + ((size_t)(b0 + j0) * n + i0) * 3 + t;
  double* dst = slot + j0 * kPitch + t;
  for (int j = j0; j < j1; ++j) {
#pragma unroll
    for (int m = 0; m < (9 * kT + 31) / 32; ++m) {
      if (t + 32 * m < nd) cp_async8(dst + 32 * m, sd + 32 * m);
      if (t + 32 * m < nu) cp_async8(dst + 9 * kT + 32 * m, su + 32 * m);
    }
#pragma unroll
    for (int m = 0; m < (3 * kT + 31) / 32; ++m)
      if (t + 32 * m < nb) cp_async8(dst + 18 * kT + 32 * m, sb + 32 * m);
    sd += 9 * (size_t)n;
    su += 9 * (size_t)(n - 1);
    sb += 3 * (size_t)n;
    dst += kPitch;
  }
}

// Forward sweep: C and y of rows 0 .. n-1 to the workspace, the pivot to
// piv.  Warp 0 is the chain.  System mode: kStagers warps, each over its
// share of the lanes, copy tile c + 1 while the chain runs tile c (handed
// over on kFull once the copies land; a slot refilled after kEmpty says
// the chain has read it).  Beam mode: kHelpers warps assemble each tile,
// thread = lane and a run of kT / parts rows, on the same barriers.
template <int L, bool kBeam>
__global__ void __launch_bounds__(fwd_threads(kBeam), 2)
stream_dd_fwd_kernel(SysIn sys, BeamIn beam, double* __restrict__ ws,
                     float* __restrict__ piv, int B, int n) {
  constexpr int R = kRingFwd;
  constexpr int N = fwd_threads(kBeam);
  constexpr int kWs = ws_row(kBeam);
  extern __shared__ double2 smem2[];
  double* smem = reinterpret_cast<double*>(smem2);
  const int t = threadIdx.x % 32;
  const int b0 = blockIdx.x * L;
  const int lanes = min(L, B - b0);
  const int ntiles = (n + kT - 1) / kT;
  double* wb = ws + (size_t)blockIdx.x * n * kWs * L;

  if (threadIdx.x >= 32) {
    if constexpr (kBeam) {  // an assembly warp
      constexpr int kParts = (kHelpers * 32 / L < kT) ? kHelpers * 32 / L
                                                      : kT;
      constexpr int kRows = kT / kParts;
      const int q = threadIdx.x - 32;
      const int j = q % L, part = q / L;
      const int r0 = part * kRows;
      const bool works = j < lanes && part < kParts;
      const double udl = works ? (double)beam.udl[b0 + j] : 0.0;
      Raw<kRows> next{};
      if (works) next = fetch<kRows>(beam, b0 + j, n, r0);
      for (int c = 0; c < ntiles; ++c) {
        const Raw<kRows> raw = next;
        if (works && c + 1 < ntiles)
          next = fetch<kRows>(beam, b0 + j, n, (c + 1) * kT + r0);
        if (c >= R) bar_sync<N>(kEmpty + c % R);
        const int cnt = min(kRows, n - c * kT - r0);
        if (works && cnt > 0)
          assemble_run<kRows>(smem + (c % R) * fwd_slot(L) + j * kPitch,
                              wb + j, L, beam, udl, raw, n, c * kT + r0, r0,
                              cnt);
        bar_arrive<N>(kFull + c % R);
      }
    } else {  // a staging warp
      constexpr int kShare = (L + kStagers - 1) / kStagers;
      const int j0 = min(lanes, ((int)threadIdx.x / 32 - 1) * kShare);
      const int j1 = min(lanes, j0 + kShare);
      auto stage = [&](int k) {
        stage_rows(smem + (k % R) * fwd_slot(L), sys, t, b0, j0, j1, n,
                   k * kT);
      };
#pragma unroll
      for (int k = 0; k < R - 1; ++k) {
        if (k < ntiles) stage(k);
        cp_async_commit();
      }
      for (int c = 0; c < ntiles; ++c) {
        cp_async_wait<R - 2>();
        bar_arrive<N>(kFull + c % R);
        const int next = c + R - 1;
        if (next < ntiles) {
          if (c >= 1) bar_sync<N>(kEmpty + (c - 1) % R);
          stage(next);
        }
        cp_async_commit();
      }
    }
    return;
  }

  const bool live = t < lanes;
  double* w = wb + t;
  Carry k;
  k.u = zero_m();
  k.c = zero_m();
#pragma unroll
  for (int a = 0; a < 3; ++a) k.y.v[a] = 0.0;
  double det, pmin = INFINITY;
  for (int tile = 0; tile < ntiles; ++tile) {
    bar_sync<N>(kFull + tile % R);
    const double* row =
        smem + (tile % R) * fwd_slot(L) + min(t, L - 1) * kPitch;
    const int i0 = tile * kT;
    auto step = [&](int r) {
      const int i = i0 + r;
      const M3 u = i < n - 1 ? read_m(row + 9 * kT + 9 * r) : zero_m();
      fwd_row(read_m(row + 9 * r), u, read_v(row + 18 * kT + 3 * r), k,
              det);
      if (live) {
        double* wr = w + (size_t)i * kWs * L;
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) wr[(a * 3 + c) * L] = k.c.m[a][c];
#pragma unroll
        for (int a = 0; a < 3; ++a) wr[(9 + a) * L] = k.y.v[a];
      }
      const double ad = fabs(det);
      pmin = (ad < pmin || isnan(ad)) ? ad : pmin;
    };
    if (i0 + kT <= n) {
#pragma unroll
      for (int r = 0; r < kT; ++r) step(r);
    } else {
#pragma unroll 1
      for (int r = 0; r < n - i0; ++r) step(r);
    }
    if (tile + R < ntiles) bar_arrive<N>(kEmpty + tile % R);
  }
  if (live) piv[b0 + t] = (float)pmin;
}

// Backward sweep, tiles in reverse: step s reads tile ntiles - 1 - s, whose
// kT rows of the block are one contiguous run of the workspace.  Warp 0 is
// the chain; warp 1 stages the workspace tiles R - 1 ahead (kFull, kEmpty);
// warp 2 writes each finished x tile (the beam mode: u = x s), which the
// chain leaves in one of two shared buffers (kXFull, kXEmpty), to
// lanes-first rows of out.  Each pair of warps meets on its own barriers.
template <int L, bool kBeam>
__global__ void __launch_bounds__(kBwdThreads, 2)
stream_dd_bwd_kernel(const double* __restrict__ ws, float* __restrict__ out,
                     int B, int n) {
  constexpr int R = kRingBwd;
  constexpr int kPair = 64;
  constexpr int kWs = ws_row(kBeam);
  extern __shared__ double2 smem2[];
  double* smem = reinterpret_cast<double*>(smem2);
  float* xs = reinterpret_cast<float*>(smem + R * bwd_slot(L, kBeam));
  const int t = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int b0 = blockIdx.x * L;
  const int lanes = min(L, B - b0);
  const int ntiles = (n + kT - 1) / kT;
  auto first_row = [&](int s) { return (ntiles - 1 - s) * kT; };

  if (warp == 1) {  // the stager
    const double* wb = ws + (size_t)blockIdx.x * n * kWs * L;
    auto stage = [&](int s) {
      const int i0 = first_row(s);
      const int pairs = min(kT, n - i0) * (kWs * L / 2);
      const double* src = wb + (size_t)i0 * kWs * L;
      double* dst = smem + (s % R) * bwd_slot(L, kBeam);
      for (int q = t; q < pairs; q += 32)
        cp_async16(dst + 2 * q, src + 2 * q);
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
      // lane j's rows i0 .. i0 + cnt - 1 of out are 3 cnt contiguous floats
      if (t < 3 * cnt) {
        const float* src = xs + (s % 2) * x_tile(L) + t;
        float v[L];
#pragma unroll
        for (int j = 0; j < L; ++j) v[j] = src[j * kPitchX];
        float* dx = out + ((size_t)b0 * n + i0) * 3 + t;
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
  for (int a = 0; a < 3; ++a) xv.v[a] = 0.0;
  const int tc = min(t, L - 1);
  for (int s = 0; s < ntiles; ++s) {
    bar_sync<kPair>(kFull + s % R);
    if (s >= 2) bar_sync<kPair>(kXEmpty + s % 2);
    const double* tile = smem + (s % R) * bwd_slot(L, kBeam) + tc;
    float* xt = xs + (s % 2) * x_tile(L) + tc * kPitchX;
    const int i0 = first_row(s);
    auto step = [&](int r) {
      const double* p = tile + r * kWs * L;
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
        for (int a = 0; a < 3; ++a) {
          const float xf = (float)xv.v[a];
          xt[3 * r + a] =
              kBeam ? (float)__dmul_rn((double)xf, p[(12 + a) * L]) : xf;
        }
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
// none does (block_stream.cu's rule).
int pick_lanes(int sms, int B) {
  for (int L = 4; L < 32; L *= 2)
    if ((B + L - 1) / L <= 2 * sms) return L;
  return 32;
}

template <int L, bool kBeam>
cudaError_t launch(const SysIn& sys, const BeamIn& beam, double* ws,
                   float* out, float* piv, int B, int n, cudaStream_t st) {
  const int blocks = (B + L - 1) / L;
  const size_t fwd_bytes = (size_t)kRingFwd * fwd_slot(L) * sizeof(double);
  const size_t bwd_bytes = (size_t)kRingBwd * bwd_slot(L, kBeam) *
                               sizeof(double) +
                           2 * (size_t)x_tile(L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stream_dd_fwd_kernel<L, kBeam>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_bytes);
  if (err != cudaSuccess) return err;
  stream_dd_fwd_kernel<L, kBeam>
      <<<blocks, fwd_threads(kBeam), fwd_bytes, st>>>(sys, beam, ws, piv, B,
                                                      n);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(stream_dd_bwd_kernel<L, kBeam>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bwd_bytes);
  if (err != cudaSuccess) return err;
  stream_dd_bwd_kernel<L, kBeam>
      <<<blocks, kBwdThreads, bwd_bytes, st>>>(ws, out, B, n);
  return cudaGetLastError();
}

template <bool kBeam>
int dispatch(const SysIn& sys, const BeamIn& beam, double* ws, float* out,
             float* piv, int B, int n, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  int sms = 0;
  const cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pick_lanes(sms, B)) {
    case 4: return (int)launch<4, kBeam>(sys, beam, ws, out, piv, B, n, st);
    case 8: return (int)launch<8, kBeam>(sys, beam, ws, out, piv, B, n, st);
    case 16:
      return (int)launch<16, kBeam>(sys, beam, ws, out, piv, B, n, st);
    default:
      return (int)launch<32, kBeam>(sys, beam, ws, out, piv, B, n, st);
  }
}

}  // namespace

extern "C" {

// Workspace doubles per row and lane: 12 for the system solve, 15 for the
// beam solve.
int stream_dd_ws_per_row(int beam) { return ws_row(beam != 0); }

// Lanes-first float64 systems diag (B, n, 3, 3), upper (B, n-1, 3, 3), rhs
// (B, n, 3), contiguous; x (B, n, 3) and the pivot (B,) out in float32; ws
// of ceil(B / 32) * 32 * n * 12 doubles, 16-byte aligned.  Lanes per block
// are picked from B and the current device's SM count.  0 on success, else
// a CUDA error code.
int thomas_streamed_dd_f64(const double* diag, const double* upper,
                           const double* rhs, double* ws, float* x,
                           float* piv, int B, int n, void* stream) {
  return dispatch<false>(SysIn{diag, upper, rhs}, BeamIn{}, ws, x, piv, B, n,
                         stream);
}

// The beam solve from the callers' lanes-first float32 I, Le (B, n-1), free
// mask (B, n, 3), point loads (B, n) and udl (B,), n >= 2, with E and E A
// (host doubles); u (B, n, 3) and the pivot (B,) out in float32; ws of
// ceil(B / 32) * 32 * n * 15 doubles.
int beam_streamed_dd_f64(const float* I, const float* Le, const float* free,
                         const float* loads, const float* udl, double E,
                         double EA, double* ws, float* u, float* piv, int B,
                         int n, void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  return dispatch<true>(SysIn{}, BeamIn{I, Le, free, loads, udl, E, EA}, ws,
                        u, piv, B, n, stream);
}

}  // extern "C"
