// The band-pipelined wavefront: one stripe of a refined grid swept by many
// blocks per pair, each sweep held in registers, with no block-wide barrier
// per diagonal. Its users: K7 and K7-stack (stripe_wavefront.cu), K3<inc,
// boundary> for f <= 32 (adjoint_collapse.cu), K1 and K1-stack
// (rbf_gen_wavefront.cu), which sweep a pair's whole frame with increments
// generated from its paths, K3<gen> for f <= 32 (adjoint_collapse.cu), the
// reverse sweep of that whole frame, and K8 for f <= 32 (adjoint_ckpt.cu),
// the same reverse sweep over a base increment grid with the forward values
// recomputed from the sparse stack (kBandCkpt, below), K5
// (deriv_wavefront.cu), whose sweep carries three states a cell (below),
// and K2, K2-stack and K2-sparse (inc_wavefront.cu), a pair's whole frame
// over its base increment grid (IncSource; K2-sparse writes the sparse
// stack, kBandSparse, below). wavefront.cuh's `sweep` (one block a pair, a
// barrier a diagonal) stays for K6 alone, and adjoint.cuh for K3<inc>, and
// for K3<inc, boundary>, K3<gen> and K8 at f > 32.
//
// Decomposition. The stripe's rows 1 .. rows (row 0 is the north boundary
// bd) are cut into bands of kBandRows = 128 rows, one block of four warps a
// band, one row a lane: lane t of warp w in band b owns row i = 128 b +
// 32 w + t + 1. The last band may be short, and a warp whose rows all lie
// past `rows` returns at once. Blocks: P * ceil(rows / 128).
//
// Inside a warp. Lane t sweeps its row along the warp's skewed diagonals:
// at step s it computes column c = s - t, so the 32 lanes of one step lie on
// one anti-diagonal of the grid. It keeps the west value K[i][c-1] and the
// north-west K[i-1][c-1] in registers and takes the north K[i-1][c] from
// lane t - 1 by __shfl_up_sync (what lane t - 1 computed one step before);
// lane 0 takes it from the warp above through a hand-off (below). Each cell
// is scheme(K[i-1][c-1], K[i-1][c], K[i][c-1], u) with the operands and
// the op order of the plain sweep, so every value is bit-equal to it.
//
// Hand-offs carry a warp's last row to the warp below, in chunks of kChunk =
// 32 columns (one value a lane of the consumer), each published by a
// counter that the producing lane raises after a fence:
//   - between the warps of a block, a ring of kRingChunks chunks in shared
//     memory; the consumer raises `consumed` after it loaded a chunk, and
//     the producer waits on it before it overwrites a slot (back-pressure;
//     safe, as the warps of one block are resident together);
//   - between bands, a whole row in global scratch, (P, nbands - 1, C + 1),
//     and one progress counter per (pair, band); no back-pressure, so a band
//     never waits on one below it;
//   - band 0's first warp reads bd, which is ready; the warp holding row
//     `rows` writes the stripe's bottom row (bottom[0] = 1, the west
//     corner), except in kBandAdjoint, which has no bottom row.
// The consumer polls with volatile loads and __nanosleep, fences, and reads
// the values with volatile loads (never __ldg: the read-only path may hold a
// stale line).
//
// Forward progress whatever the scheduler does. Each block takes a ticket
// (atomicAdd on a counter the wrapper zeroes before every launch) and maps
// it band-major, band = t / P, pair = t % P, so the band it waits on holds a
// smaller ticket: its block has started and waits only on smaller tickets
// in turn. blockIdx is not used, so nothing assumes the order in which
// blocks start, and any number of blocks (more than are resident) is safe.
//
// Increments come from a source type (the kernel's Src), one value per base
// cell: lane t asks its Src::Lane for base column q = 0, 1, 2, ... in that
// order, keeps the value for the f refined columns of the cell, and asks for
// the next one a whole base column ahead of its use, at its own wrap. A
// source with kAligned set (RbfSource, whose values cost two exp) is asked
// instead on the warp-uniform steps s = 0 mod f, one column a lane, for the
// column after the next (u_more), so that a warp issues the generation once
// every f steps, not on every step for the 32 / f lanes that wrap on it:
// between two wraps of a lane (f steps apart) lies exactly one such step,
// and a lane that holds u_more already skips it. GridSource (the
// default; K7, K7-stack, K3<inc, boundary>) reads a pair's base grid with
// StripeGrid's arithmetic (zero past the frame's R rows, both axes reversed
// with flip, transposed when Mb > Nb, exact 1 / f^2 scaling) and sweeps a
// stripe from its north boundary bd, writing its bottom row.
// rbf_gen.cuh's RbfSource (K1, K1-stack; K3<gen> with flip, its columns
// walked from the last to the first) generates the increments from the
// pair's paths and sweeps the whole frame (Src::kStripe false): row 0 is
// the constant 1, read from no tensor, and the lane that owns row R writes
// only the corner K[R][C], into `bottom` (P,), except in kBandAdjoint.
// IncSource (K2, K2-stack, K2-sparse; below) reads a pair's base grid over
// the whole frame the same way, kIncAhead base columns ahead of its use.
//
// The stack (kBandStack) is K2-stack's layout for the stripe: stack[p (rows
// + 1) + i] = K[i][p - i], written in full. The lanes of one step share the
// diagonal p = i + c, so their stores are neighbouring addresses. Each
// warp also writes its rows' fixed entries (0 before column 0, 1 at it, 0
// past column C), and band 0's first warp row 0 (bd, then 0).
//
// The sparse stack (kBandSparse, K2-sparse; a whole frame, window W =
// Src::W >= 2) keeps the full stack's rows whose diagonal p has p % W < 2
// and p / W < ckpt_pairs(rows, C, W) (wavefront.cuh's layout): diagonal p
// in row 2 (p / W) + p % W. Lane t at step s sits on diagonal p = i0 + s,
// one p for the warp, so whether the step's cells are stored is uniform
// (the warp tracks p / W and p % W from step to step), and the lanes of a
// stored step write neighbouring addresses. Each warp writes its rows'
// fixed entries on the stored diagonals only, and band 0's first warp row 0
// (1 to column C, then 0). The corner's diagonal rows + C is never stored.
//
// The adjoint (kBandAdjoint, always with flip: the reverse problem's stripe
// from its boundary bd, forward stripe row0 .. row0 + rows - 1 in `stack`,
// K7-stack's layout; or, with RbfSource, the reverse problem's whole frame
// from 1s, row0 = 0 and rows = R, K1-stack's stack). Lane t at step s
// holds nw = K_rev[i-1][c-1], which pairs with forward cell (a, b) = (rows
// - i, C - c) on forward diagonal p = a + b = rows + C - i0 - s, one p for
// the whole warp (i0 its first row): the term is mul(stack[p][a], nw), the
// operand order of adjoint.cuh. As i runs over 1 .. rows and c over 1 .. C
// these are the forward cells of rows 0 .. rows - 1 and columns 0 .. C - 1,
// the boundary row included. The stack values reach shared memory a stage
// of Src::kStage steps ahead by cp.async (each lane copies and reads only
// its own entries, so no barrier), and the lanes of one step read
// neighbouring addresses. The stage's depth is the source's: 32 steps for
// GridSource (K3<inc, boundary>), 16 for RbfSource (K3<gen>, whose double
// instance at D = 3, f = 2 then takes 96 registers, not 158), each the
// faster of the two on an H100 (sigkernel_tpu_torch/probes/k3_probe.py).
//
// The collapse, in registers, in scan_solver.collapse_refined's order
// (forward p descending, then forward row ascending). Since rows, row0 and
// the warp's first row - 1 are multiples of f (f <= 32), forward base row a
// / f is one aligned group of f lanes, forward row ascending being lane
// descending. Step s is one forward diagonal, and the group's f terms fall
// in at most two base columns: with b0 = C - s + (the group's first lane),
// the lanes j >= f - r of the group, r = b0 mod f (the same for every
// group), lie in column b0 / f + 1 and the others in b0 / f. Every lane of
// the group shuffles in its f terms, j descending, and adds each into `hi`
// or `lo` (the two open base cells; all lanes hold the same sums). When r
// becomes f - 1 a new column enters, the one in `hi` (b0 / f + 2) has had
// its last term, and the group's first lane adds it into ct once; then hi
// = lo, lo = 0. After the last step the two open cells are added. f is a
// template argument (one instance per f = 1 .. 32), so the f shuffles
// unroll; ct's value of the cell in hi is read when it opens, f steps
// before its add needs it. Base rows
// at or past the frame's R / f (padding) write nothing; ct is in the
// pairs' own frame, transposed when Mb > Nb. Each base cell is add(ct,
// sum), the sum started at 0: bit for bit the plain version's ct += sums.
// A source with kFold set (K3<gen>'s RbfFoldSource, rbf_gen.cuh) closes each
// base cell of the frame exactly once, so the lead lane stores
// mul(mul(add(0, sum), scale), wt[pair]) (times 1, exact, when wt is
// null) and ct is neither read nor zeroed: the zero fill, the division by
// f^2 and the weighting that would otherwise run over ct in three passes.
// The weight sits in a register from the start. A branch on wt at each
// store took 7 more registers (103, not 96, in double at f = 2, D = 3: 4
// blocks an SM, not 5) and 4.7 % more time on an H100; the weight kept in
// shared memory took 3 % more, read from global memory at each store
// (113 registers) 8 % more.
//
// The sparse-checkpoint adjoint (kBandCkpt, K8): kBandAdjoint over the
// whole reverse frame from 1s (row0 0, rows R) with CkptSource, a
// GridSource walked with flip, whose forward values come from no full
// stack: the sparse stack (wavefront.cuh) holds only diagonals e = w W and
// e + 1 of each window w, and each warp recomputes the others at its own
// rows. Since a warp's lanes share one forward diagonal p at each step, the
// warp walks the windows p / W downward and needs, for window w, the
// values of diagonals e .. e + W - 1 at its forward rows a = rows - i0 - t.
// Diagonals e and e + 1 are rows 2 w and 2 w + 1 of the sparse stack (the
// lanes read neighbouring addresses); diagonal d = e + k, k = 2 .. W - 1,
// is recomputed as the forward computed it: scheme(K[a-1][d-a-1],
// K[a-1][d-a], K[a][d-a-1], inc(a - 1, d - a - 1)), the forward's operands
// and op order, inside the frame, and wavefront.cuh's edge value outside
// it, so every value is the forward's bit for bit. Row a - 1 is lane t +
// 1's, taken by a shuffle; for lane 31, the warp's top row a_lo, it is the
// next warp's, which runs later in the pipeline and cannot hand it on. The
// window bounds the dependence: diagonal e + k at row a needs rows down to
// a - (k - 1) of the stored pair only. So each warp also recomputes a halo
// of the W - 2 rows a_lo - 1 .. a_lo - (W - 2) above it, one a lane (lane t
// < W - 2 holds row a_lo - 1 - t as a second row): at step k halo lane t
// is right while t + k <= W - 2, and every value the main rows read is
// right. Rows before the frame (a < 0, a short last warp) take no load.
// A window's W values a lane go to one of two buffers a warp in shared
// memory (each lane reads back only what it wrote). Interleaved (float,
// kCkptInterleave), the warp prepares window w - 1 one unit a step (the
// stored pair's loads, their shuffles, then one diagonal a step; CkptWarp)
// while it consumes window w, so that each step carries two independent
// chains and every load is issued a step before its use; otherwise
// (double) a window is prepared all at once when the walk enters it, which
// takes more registers (128 against 108 at f 2) and ran 4-6 % faster on an
// H100 in double, where float ran up to 4 % slower. The band scratch and
// counters are those of the other modes; no bound on rows or columns
// applies.
//
// The state a cell (Src::State). Every source above sweeps one value a
// cell, State = T. K5's DerivSource sweeps the derivative Gram's three,
// Triple<T> = (K, K_diff, K_diffdiff), over three base grids whose
// increments come as a Triple too: each register above (cur, nw, up, the
// increments) holds one, the north values come by three shuffles, and the
// hand-offs (ring and scratch) carry a Triple a column, its three values
// side by side, so the ring is 3 x 256 values a warp and the scratch (P,
// nbands - 1, C + 1, 3). Row 0 and column 0 are (1, 0, 0) (`lift`), and
// each cell is `band_cell`: for T the scheme, for a Triple the scheme and
// the product-rule recurrences of ops/scan_solver.py's
// solve_derivatives_final in their op order. With State = T every helper
// is the expression it replaces, so the one-value instances compile as
// before.
#pragma once

#include <type_traits>

#include "wavefront.cuh"

namespace sigkernel {

constexpr int kBandWarps = 4;
constexpr int kBandRows = 32 * kBandWarps;
constexpr int kChunk = 32;
constexpr int kRingChunks = 8;
constexpr int kRing = kChunk * kRingChunks;
constexpr unsigned kFullMask = 0xffffffffu;

// What a band sweep writes: the bottom row (K7; the corner with a whole
// frame, K1, K5, K2), the bottom row and the stack (K7-stack; K1-stack,
// K2-stack), the reverse stripe's product with a forward stack, collapsed
// into the base cotangent (K3<inc, boundary>; K3<gen>), the same with the
// forward values recomputed from a sparse stack (K8), or the corner and the
// sparse stack (K2-sparse).
enum BandMode : int {
  kBandBottom = 0, kBandStack = 1, kBandAdjoint = 2, kBandCkpt = 3,
  kBandSparse = 4
};

// kBandCkpt: prepare the next window while the current one is consumed
// (see above), or each window all at once when the walk enters it: in
// float the first, in double the second, each the faster on an H100
// (sigkernel_tpu_torch/probes/k8_probe.py).
template <typename T>
constexpr bool kCkptInterleave = sizeof(T) == 4;

// K5's state a cell: the kernel value and its first and second
// directional derivatives.
template <typename T>
struct Triple {
  T k, d, s;
};

// A value with zero derivatives, as the state type S holds it.
template <typename S, typename T>
__device__ __forceinline__ S lift(T v) {
  if constexpr (std::is_same<S, T>::value) {
    return v;
  } else {
    return S{v, T(0), T(0)};
  }
}

// Lane src's value, and lane t - 1's (lane 0 keeps its own).
template <typename T>
__device__ __forceinline__ T shfl(T v, int src) {
  return __shfl_sync(kFullMask, v, src);
}
template <typename T>
__device__ __forceinline__ Triple<T> shfl(Triple<T> v, int src) {
  return {shfl(v.k, src), shfl(v.d, src), shfl(v.s, src)};
}
template <typename T>
__device__ __forceinline__ T shfl_up(T v) {
  return __shfl_up_sync(kFullMask, v, 1);
}
template <typename T>
__device__ __forceinline__ Triple<T> shfl_up(Triple<T> v) {
  return {shfl_up(v.k), shfl_up(v.d), shfl_up(v.s)};
}

// Hand-off loads and stores, through volatile pointers.
template <typename T>
__device__ __forceinline__ T vload(const volatile T* p) {
  return *p;
}
template <typename T>
__device__ __forceinline__ Triple<T> vload(const volatile Triple<T>* p) {
  return {p->k, p->d, p->s};
}
template <typename T>
__device__ __forceinline__ void vstore(volatile T* p, T v) {
  *p = v;
}
template <typename T>
__device__ __forceinline__ void vstore(volatile Triple<T>* p, Triple<T> v) {
  p->k = v.k;
  p->d = v.d;
  p->s = v.s;
}

// One cell from its north-west, north and west neighbours and its
// increment: the scheme; for K5's Triple the scheme for K and the
// product-rule recurrences f1..f4 / g1..g4 for the derivatives, in the op
// order of ops/scan_solver.py's solve_derivatives_final (order 2 only).
template <typename T>
__device__ __forceinline__ T band_cell(T nw, T n, T w, T u, bool naive) {
  return scheme(nw, n, w, u, naive);
}
template <typename T>
__device__ __forceinline__ Triple<T> band_cell(Triple<T> nw, Triple<T> n,
                                               Triple<T> w, Triple<T> inc,
                                               bool) {
  const T k00 = nw.k, k01 = n.k, k10 = w.k;
  const T d00 = nw.d, d01 = n.d, d10 = w.d;
  const T s00 = nw.s, s01 = n.s, s10 = w.s;
  const T u = inc.k, ud = inc.d, us = inc.s;

  const T k = scheme(k00, k01, k10, u, false);

  const T f1 = add(mul(k00, ud), mul(d00, u));
  const T f2 = add(mul(k01, ud), mul(d01, u));
  const T f3 = add(mul(k10, ud), mul(d10, u));
  const T dsum = sub(add(d01, d10), d00);
  const T f4 = add(mul(k, ud), mul(add(dsum, f1), u));
  const T d = add(dsum, mul(T(0.25), add(add(add(f1, f2), f3), f4)));

  const T two = T(2);
  const T g1 = add(add(mul(k00, us), mul(mul(two, d00), ud)), mul(s00, u));
  const T g2 = add(add(mul(k01, us), mul(mul(two, d01), ud)), mul(s01, u));
  const T g3 = add(add(mul(k10, us), mul(mul(two, d10), ud)), mul(s10, u));
  const T ssum = sub(add(s01, s10), s00);
  const T g4 = add(add(mul(k, us), mul(mul(two, d), ud)),
                   mul(add(ssum, g1), u));
  const T s = add(ssum, mul(T(0.25), add(add(add(g1, g2), g3), g4)));
  return {k, d, s};
}

template <typename S>
struct BandShared {
  S ring[kBandWarps - 1][kRing];
  int ready[kBandWarps - 1];     // chunks warp w has published to warp w + 1
  int consumed[kBandWarps - 1];  // chunks warp w + 1 has loaded
  int ticket;
};

// kBandAdjoint's stage: the forward values of Src::kStage steps x 32 lanes
// a buffer, two buffers a warp (one read while the next is copied in), in
// dynamic shared memory.
template <typename T, typename Src>
constexpr size_t band_stage_bytes() {
  return sizeof(T) * kBandWarps * 2 * Src::kStage * 32;
}

// A hand-off that never comes (a broken kernel, not a slow one: the longest
// real wait is the pipeline's fill, well under a millisecond) traps after
// about 2^34 cycles (~9 s at 1.98 GHz), so the launch fails and the wrapper
// raises instead of the card hanging.
constexpr long long kWaitCycles = 1ll << 34;

__device__ __forceinline__ void wait_for(const volatile int* counter,
                                         int at_least) {
  if (*counter >= at_least) return;
  const long long t0 = clock64();
  while (*counter < at_least) {
    __nanosleep(64);
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// One value from global to shared memory, asynchronously (cp.async), and
// the waits on the groups of such copies.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(to), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

inline int band_count(int rows) { return (rows + kBandRows - 1) / kBandRows; }

__host__ __device__ constexpr int log2_of(int f) {
  return f > 1 ? 1 + log2_of(f / 2) : 0;
}

// A pair's base increment grid (P, Mb, Nb), read with StripeGrid's
// arithmetic; a stripe from a north boundary.
template <typename T>
struct GridSource {
  using State = T;
  static constexpr bool kStripe = true;
  static constexpr bool kAligned = false;  // read at each lane's wrap
  static constexpr bool kFold = false;     // the collapse adds into ct
  static constexpr int kStage = 32;  // kBandAdjoint's stage, in steps
  const T* inc;

  struct Lane {
    const T* g;
    int ra, Nb, Cb, flip, transpose;
    bool has_inc;
    T scale;
    // base column q of this lane's row, in the order the sweep meets them
    __device__ __forceinline__ T col(int q) {
      if (!has_inc || q >= Cb) return T(0);
      const int cb = flip ? Cb - 1 - q : q;
      const int64_t at = transpose ? static_cast<int64_t>(cb) * Nb + ra
                                   : static_cast<int64_t>(ra) * Nb + cb;
      return __ldg(g + at) * scale;
    }
  };

  // the lane of pair `pair` whose frame base row is ra (has_inc false: a
  // row past the stripe or the frame, whose increments are 0)
  __device__ __forceinline__ Lane lane(int64_t pair, int ra, bool has_inc,
                                       int Mb, int Nb, int f,
                                       int flip) const {
    const int transpose = Mb > Nb;
    return Lane{inc + pair * static_cast<int64_t>(Mb) * Nb, ra, Nb,
                transpose ? Mb : Nb, flip, transpose, has_inc,
                T(1) / T(f * f)};
  }
};

// K5's source: three base grids (P, Mb, Nb), the derivative Gram's
// increments of K, K_diff and K_diffdiff, each read with GridSource's
// arithmetic (zero past the frame, transposed when Mb > Nb, the exact 1 /
// f^2) over the whole frame from 1s, the three values of a base cell asked
// together a whole base column ahead of their use.
template <typename T>
struct DerivSource {
  using State = Triple<T>;
  static constexpr bool kStripe = false;
  static constexpr bool kAligned = false;  // read at each lane's wrap
  static constexpr bool kFold = false;     // unused: no adjoint mode
  static constexpr int kStage = 32;  // unused: no adjoint mode
  const T* inc;
  const T* inc_d;
  const T* inc_dd;

  struct Lane {
    const T *g, *gd, *gs;
    int ra, Nb, Cb, transpose;
    bool has_inc;
    T scale;
    __device__ __forceinline__ State col(int q) {
      if (!has_inc || q >= Cb) return {T(0), T(0), T(0)};
      const int64_t at = transpose ? static_cast<int64_t>(q) * Nb + ra
                                   : static_cast<int64_t>(ra) * Nb + q;
      return {__ldg(g + at) * scale, __ldg(gd + at) * scale,
              __ldg(gs + at) * scale};
    }
  };

  __device__ __forceinline__ Lane lane(int64_t pair, int ra, bool has_inc,
                                       int Mb, int Nb, int f, int) const {
    const int transpose = Mb > Nb;
    const int64_t off = pair * static_cast<int64_t>(Mb) * Nb;
    return Lane{inc + off, inc_d + off, inc_dd + off, ra, Nb,
                transpose ? Mb : Nb, transpose, has_inc, T(1) / T(f * f)};
  }
};

// K8's source (kBandCkpt): GridSource's increments over the whole frame
// from 1s, and the window W of the sparse stack that band_stripe's `stack`
// points to.
template <typename T>
struct CkptSource : GridSource<T> {
  static constexpr bool kStripe = false;
  int W;
};

// K2's source (K2, K2-stack, K2-sparse): a pair's base grid (P, Mb, Nb)
// over the whole frame from 1s, with GridSource's arithmetic (transposed
// when Mb > Nb, the exact 1 / f^2 applied after the load), and the window W
// of kBandSparse. Each lane keeps the next kIncAhead base columns of its
// row in registers, unscaled: the load of column q + kIncAhead starts
// when column q is taken, and its first use, the queue's shift, comes
// kIncAhead wraps (kIncAhead f steps) later. GridSource scales each value as
// it is loaded, so that its first use is the load's own multiply. A queue
// of 1 ran K2 fastest on an H100: GridSource's pattern (as CkptSource, a
// whole frame) took 22-27 % longer, a queue of 2 took 2-8 % longer and of
// 4, whose registers cost occupancy, 9-23 %
// (sigkernel_tpu_torch/probes/k2_probe.py).
template <typename T>
constexpr int kIncAhead = 1;

template <typename T>
struct IncSource {
  using State = T;
  static constexpr bool kStripe = false;
  static constexpr bool kAligned = false;  // read at each lane's wrap
  static constexpr bool kFold = false;     // unused: no adjoint mode
  static constexpr int kStage = 32;  // unused: no adjoint mode
  static constexpr int kAhead = kIncAhead<T>;
  const T* inc;
  int W;

  struct Lane {
    const T* g;  // base column 0 of this lane's row
    int64_t step;  // elements from one base column to the next
    int Cb, next;  // base columns; the next one to load
    bool has_inc;
    T scale;
    T raw[kAhead];  // columns next - kAhead .. next - 1
    __device__ __forceinline__ T load(int q) const {
      return has_inc && q < Cb ? __ldg(g + q * step) : T(0);
    }
    // base column q of this lane's row; asked for in order, q = 0, 1, ...
    __device__ __forceinline__ T col(int) {
      const T v = raw[0] * scale;
#pragma unroll
      for (int k = 0; k + 1 < kAhead; ++k) raw[k] = raw[k + 1];
      raw[kAhead - 1] = load(next++);
      return v;
    }
  };

  // the lane of pair `pair` whose frame base row is ra (has_inc false: a
  // row past the frame, whose increments are 0)
  __device__ __forceinline__ Lane lane(int64_t pair, int ra, bool has_inc,
                                       int Mb, int Nb, int f, int) const {
    const int transpose = Mb > Nb;
    Lane l{inc + pair * static_cast<int64_t>(Mb) * Nb +
               (transpose ? ra : static_cast<int64_t>(ra) * Nb),
           transpose ? Nb : 1, transpose ? Mb : Nb, kAhead, has_inc,
           T(1) / T(f * f), {}};
#pragma unroll
    for (int k = 0; k < kAhead; ++k) l.raw[k] = l.load(k);
    return l;
  }
};

// kBandCkpt's window buffers: two a warp, W diagonals x 32 lanes each.
template <typename T>
constexpr size_t ckpt_window_bytes(int W) {
  return sizeof(T) * kBandWarps * 2 * static_cast<size_t>(W) * 32;
}

// kBandCkpt: one warp's forward values, a window at a time (see above).
// Lane t holds forward row a and, for t < W - 2, halo row ah (else -1).
// Window w's values go to buffer w & 1 of `win`, diagonal-major, one per
// lane. Its W units, one a step when interleaved: k = 0 loads the stored
// pair (diagonals e and e + 1), k = 1 writes it to the buffer and shuffles
// in row a - 1's values, k = 2 .. W - 1 recompute diagonal e + k; k = W:
// the window is ready. Each load is used a unit after it was issued: the
// stored pair's, and each recomputed cell's increment.
template <typename T, int kF>
struct CkptWarp {
  const T* sparse;  // this pair's sparse stack, (2 ckpt_pairs, R + 1)
  const T* g;       // this pair's base grid, in the pairs' frame
  T* win;           // this warp's two window buffers
  int R, C, W, Nb, transpose, lane, a, ah;
  bool naive;
  int w = -1, k = 0;  // the window being prepared, and its next unit
  // the last diagonal's values at rows a and ah (cur, hcur), rows a - 1's
  // and ah - 1's at the last two diagonals (n, nn; hn, hnn), and the
  // increments of the next diagonal's cells at rows a and ah (u, hu)
  T cur = T(0), n = T(0), nn = T(0), hcur = T(0), hn = T(0), hnn = T(0);
  T u = T(0), hu = T(0);

  // the increment that forward cell (row, d - row) reads, by IncGrid's
  // arithmetic (wavefront.cuh); 0 for a cell the sweep does not compute
  __device__ __forceinline__ T inc(int row, int d) const {
    constexpr int lg = log2_of(kF);
    if (row < d - C || row < 1 || row > d - 1 || row > R) return T(0);
    const int rb = (row - 1) >> lg, cb = (d - row - 1) >> lg;
    const int64_t at = transpose ? static_cast<int64_t>(cb) * Nb + rb
                                 : static_cast<int64_t>(rb) * Nb + cb;
    return __ldg(g + at) * (T(1) / T(kF * kF));
  }

  // forward cell (row, b = d - row) from K[row-1][b-1] (k00), K[row-1][b]
  // (k01) and K[row][b-1] (k10) and its increment, as wavefront.cuh's
  // sweep computes it; outside the frame its edge value
  __device__ __forceinline__ T cell(int row, int d, T k00, T k01, T k10,
                                    T uu) const {
    if (row < d - C || row < 1 || row > d - 1 || row > R) {
      return edge<T>(row, d, C);
    }
    return scheme(k00, k01, k10, uu, naive);
  }

  // row a - 1's value at every lane: lane t + 1's, and for lane 31 lane
  // 0's halo row
  __device__ __forceinline__ T below(T v, T hv) const {
    return __shfl_sync(kFullMask, lane == 0 ? hv : v, (lane + 1) & 31);
  }

  __device__ __forceinline__ void start(int window) {
    w = window;
    k = 0;
  }

  __device__ __forceinline__ void unit() {  // uniform over the warp
    const int e = w * W;
    if (k == 0) {  // the stored pair, into nn, cur (rows a) and hnn, hcur
      const T* s0 = sparse + 2 * static_cast<int64_t>(w) * (R + 1);
      const T* s1 = s0 + (R + 1);
      nn = a >= 0 ? __ldg(s0 + a) : T(0);
      cur = a >= 0 ? __ldg(s1 + a) : T(0);
      hnn = ah >= 0 ? __ldg(s0 + ah) : T(0);
      hcur = ah >= 0 ? __ldg(s1 + ah) : T(0);
      u = inc(a, e + 2);
      hu = inc(ah, e + 2);
    } else if (k == 1) {
      T* buf = win + (w & 1) * W * 32;
      buf[lane] = nn;
      buf[32 + lane] = cur;
      const T n0 = below(nn, hnn), hn0 = __shfl_down_sync(kFullMask, hnn, 1);
      n = below(cur, hcur);
      hn = __shfl_down_sync(kFullMask, hcur, 1);
      nn = n0;
      hnn = hn0;
    } else {
      const int d = e + k;
      const T v = cell(a, d, nn, n, cur, u);
      const T hv = cell(ah, d, hnn, hn, hcur, hu);
      win[(w & 1) * W * 32 + k * 32 + lane] = v;
      nn = n;
      hnn = hn;
      n = below(v, hv);
      hn = __shfl_down_sync(kFullMask, hv, 1);
      cur = v;
      hcur = hv;
      u = inc(a, d + 1);
      hu = inc(ah, d + 1);
    }
    ++k;
  }
};

// Sweep one stripe (see above). src: the increments (GridSource: the pairs'
// base grids (P, Mb, Nb)); bd, bottom: (P, C + 1) (a whole frame: no bd,
// bottom (P,) the corners); stack: (P, rows + C + 1, rows + 1), written
// with kBandStack, read with kBandAdjoint; scratch: (P, nbands - 1, C + 1);
// bd, bottom and scratch hold Src::State values (K5: Triples);
// counters: P * nbands progress counters then the ticket, all zero at
// launch; ct (kBandAdjoint): (P, Mb, Nb). Mb, Nb: the base frame in the
// pairs' own orientation, which sets ct's (K1 passes its oriented frame,
// Mb <= Nb; K3<gen> and K8 the pairs' own, transposed when Mb > Nb). kF:
// with kBandAdjoint and kBandCkpt, f (1 .. 32) fixed at compile time, so
// that the collapse over a group's f lanes unrolls; the other modes read f
// at run time. kBandCkpt: stack is the sparse stack (P, 2 ckpt_pairs(rows,
// C, src.W), rows + 1) and Src a CkptSource. kBandSparse: stack is the
// sparse stack (P, 2 ckpt_pairs(rows, C, src.W), rows + 1), written, and
// Src an IncSource.
template <typename T, int kMode, int kF = 1, typename Src = GridSource<T>>
__global__ void __launch_bounds__(kBandRows)
band_stripe(const Src src, const typename Src::State* __restrict__ bd,
            typename Src::State* __restrict__ bottom, T* __restrict__ stack,
            typename Src::State* scratch, int* counters, T* __restrict__ ct,
            int64_t P, int nbands, int Mb, int Nb, int f, int row0, int rows,
            int flip, int naive) {
  using S = typename Src::State;
  constexpr bool kStack = kMode == kBandStack;
  constexpr bool kCkpt = kMode == kBandCkpt;
  constexpr bool kSparse = kMode == kBandSparse;
  constexpr bool kAdjoint = kMode == kBandAdjoint || kCkpt;
  constexpr bool kStripe = Src::kStripe;  // else a whole frame from 1s
  constexpr int kStage = Src::kStage;
  __shared__ BandShared<S> sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kBandWarps - 1) {
    sh.ready[threadIdx.x] = 0;
    sh.consumed[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) sh.ticket = atomicAdd(counters + P * nbands, 1);
  __syncthreads();  // the only block-wide barrier
  const int64_t ticket = sh.ticket;
  const int band = static_cast<int>(ticket / P);
  const int64_t pair = ticket % P;
  const int i0 = band * kBandRows + warp * 32 + 1;  // the warp's first row
  if (i0 > rows) return;  // past the stripe: nobody waits on this warp

  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  const int Cb = C / f;
  const int i = i0 + lane;
  const bool live = i <= rows;
  const S* bd_p = kStripe ? bd + pair * (C + 1) : nullptr;

  // this row's base increments, in the order the sweep meets them
  int r = flip ? rows - i : i - 1;
  r += row0;
  const bool has_inc = live && r < R;
  const int ra = has_inc ? r / f : 0;
  typename Src::Lane incs = src.lane(pair, ra, has_inc, Mb, Nb, f, flip);

  // where the north values come from: bd, the ring of the warp above, or
  // the global row of the band above
  const volatile S* north = nullptr;  // none: row 0 of a whole frame, 1s
  const volatile int* north_ready = nullptr;
  bool north_ring = false;
  if (warp > 0) {
    north = sh.ring[warp - 1];
    north_ready = sh.ready + warp - 1;
    north_ring = true;
  } else if (band > 0) {
    north = scratch + (pair * (nbands - 1) + band - 1) * (C + 1);
    north_ready = counters + pair * nbands + band - 1;
  } else if (kStripe) {
    north = bd_p;
  }
  // where this warp's last row goes: the bottom row (none with kBandAdjoint),
  // the ring, the global row
  const int bottom_lane = rows - i0 < 32 ? rows - i0 : -1;
  const int out_lane = bottom_lane < 0 ? 31 : kAdjoint ? -1 : bottom_lane;
  const bool out_ring = bottom_lane < 0 && warp < kBandWarps - 1;
  S* out = bottom_lane >= 0
               ? (kAdjoint || !kStripe ? nullptr : bottom + pair * (C + 1))
           : out_ring ? nullptr
                      : scratch + (pair * (nbands - 1) + band) * (C + 1);
  int* out_ready = bottom_lane >= 0 || out_ring
                       ? nullptr : counters + pair * nbands + band;
  if (kStripe && bottom_lane >= 0 && lane == out_lane) {
    out[0] = lift<S>(T(1));
  }

  int W = 0;  // kBandCkpt's and kBandSparse's window
  if constexpr (kCkpt || kSparse) W = src.W;
  T* stk = !kStack && !kAdjoint && !kSparse ? nullptr
           : stack + pair * (kCkpt || kSparse ? sparse_elems(rows, C, W)
                                              : stack_elems(rows, C));
  const int64_t stride = rows + 1;
  if constexpr (kStack) {
    for (int p = 0; p <= i0 + 31; ++p) {  // left of and at column 0
      if (live && p <= i) stk[p * stride + i] = p == i ? T(1) : T(0);
    }
    for (int p = i0 + C + 1; p <= rows + C; ++p) {  // past column C
      if (live && p > i + C) stk[p * stride + i] = T(0);
    }
    if (band == 0 && warp == 0) {
      for (int p = lane; p <= rows + C; p += 32) {
        stk[p * stride] = p > C ? T(0) : kStripe ? bd_p[p] : T(1);
      }
    }
  }
  // kBandSparse: the last stored pair, and this step's diagonal p = i0 + s
  // as p / W and p % W (uniform)
  [[maybe_unused]] int last_pair = 0, pq = 0, pw = 0;
  if constexpr (kSparse) {
    last_pair = ckpt_pairs(rows, C, W) - 1;
    pq = (i0 + 1) / W;
    pw = (i0 + 1) % W;
    // the stored diagonals' entries left of and at column 0, past column C,
    // and, by band 0's first warp, in row 0
    for (int w = 0; w <= last_pair && w * W <= i0 + 31; ++w) {
      for (int k = 0; k < 2; ++k) {
        const int p = w * W + k;
        if (live && p <= i) {
          stk[(2 * w + k) * stride + i] = p == i ? T(1) : T(0);
        }
      }
    }
    for (int w = (i0 + C + 1) / W; w <= last_pair; ++w) {
      for (int k = 0; k < 2; ++k) {
        const int p = w * W + k;
        if (live && p > i + C) stk[(2 * w + k) * stride + i] = T(0);
      }
    }
    if (band == 0 && warp == 0) {
      for (int r = lane; r <= 2 * last_pair + 1; r += 32) {
        stk[r * stride] = (r >> 1) * W + (r & 1) > C ? T(0) : T(1);
      }
    }
  }

  // kBandAdjoint: the staged forward values, the group (see above), the
  // group's frame base row, and where a finished base cell goes
  extern __shared__ __align__(16) unsigned char band_smem[];
  T* stage = reinterpret_cast<T*>(band_smem) + warp * 2 * kStage * 32;
  auto prefetch = [&](int k) {  // stage k's steps into buffer k & 1
    T* buf = stage + (k & 1) * kStage * 32;
    for (int js = 0; js < kStage; ++js) {
      const int s = k * kStage + js + 1;
      const int c = s - lane;
      if (has_inc && c >= 1 && c <= C) {
        const int64_t p = rows + C - i0 - s;
        copy_async(buf + js * 32 + lane, stk + p * stride + (rows - i));
      }
    }
    commit_async();
  };
  constexpr int lg = log2_of(kF);
  const int gbase = lane & ~(kF - 1);  // the group's first lane
  const bool lead = has_inc && lane == gbase;
  const int ga = row0 / f + ((rows - i0 + 1) >> lg) - (lane >> lg) - 1;
  T* ct_p = kAdjoint ? ct + pair * static_cast<int64_t>(Mb) * Nb : nullptr;
  auto cell = [&](int b) -> T* {  // base cell (ga, b), or none
    if (b < 0 || b >= Cb) return nullptr;
    return ct_p + (transpose ? static_cast<int64_t>(b) * (R / f) + ga
                             : static_cast<int64_t>(ga) * Cb + b);
  };
  // Src::kFold: the pair's weight (1 without weights), read once
  [[maybe_unused]] const T weight = [&] {
    if constexpr (Src::kFold) {
      return lead && src.wt != nullptr ? __ldg(src.wt + pair) : T(1);
    } else {
      return T(1);
    }
  }();
  // base cell b has all its terms: add them to ct's value `was`; with
  // Src::kFold store them, scaled and weighted, without reading ct
  auto emit = [&](T acc, int b, T was) {
    if constexpr (Src::kFold) {
      if (T* at = cell(b)) *at = mul(mul(add(T(0), acc), src.scale), weight);
    } else {
      if (T* at = cell(b)) *at = add(was, acc);
    }
  };
  auto fetch = [&](int b) -> T {
    const T* at = cell(b);
    return at != nullptr ? *at : T(0);
  };
  // the two open base cells, and ct's value of hi's, read when hi opened so
  // that the add at its close does not wait on memory
  T hi = T(0), lo = T(0), ct_hi = T(0);
  if constexpr (kAdjoint && !kCkpt) prefetch(0);
  // kBandCkpt: the warp's recompute; the first diagonal of the window the
  // walk is in (none yet: past every p), and this lane's slot of that
  // window's buffer
  [[maybe_unused]] auto ck = [&] {
    if constexpr (kCkpt) {
      const int a_lo = rows - i0 - 31;  // the warp's top forward row
      return CkptWarp<T, kF>{
          stk, src.inc + pair * static_cast<int64_t>(Mb) * Nb,
          reinterpret_cast<T*>(band_smem) + warp * 2 * W * 32, rows, C, W,
          Nb, transpose, lane, rows - i, lane < W - 2 ? a_lo - 1 - lane : -1,
          naive != 0};
    } else {
      return 0;
    }
  }();
  [[maybe_unused]] int e_cur = rows + C;
  [[maybe_unused]] const T* fwd = nullptr;

  S cur = lift<S>(T(1));                // K[i][c - 1]; column 0 is 1
  // K[i - 1][c - 1] (lane 0's start; bd[0] is the west corner, 1)
  S nw = kStripe && i == 1 ? bd_p[0] : lift<S>(T(1));
  S up = lift<S>(T(0));                 // lane j: north of column s + j
  S u = incs.col(0), u_next = incs.col(1);
  // Src::kAligned: the lanes generate together, on the steps that are
  // multiples of f, the column after u_next into u_more (see above)
  S u_more = lift<S>(T(0));
  bool more = false;
  int q = 0, m = 0;                     // base column, refined within it
  for (int s = 1; s <= C + 31; ++s) {
    const int j = (s - 1) & (kChunk - 1);
    const int js = (s - 1) & (kStage - 1);  // the step within its stage
    if constexpr (Src::kAligned) {
      if ((s & (f - 1)) == 0 && !more) {  // uniform step, f a power of 2
        u_more = incs.col(q + 2);
        more = true;
      }
    }
    // kBandCkpt: forward diagonal p's window, ready before the wait below
    // so that its loads are in flight meanwhile (see above)
    if constexpr (kCkpt) {
      const int p = rows + C - i0 - s;
      if (p >= 0 && p < e_cur) {  // uniform: the walk enters window p / W
        const int w = p / W;
        if (ck.w != w) ck.start(w);
        while (ck.k < W) ck.unit();
        e_cur = w * W;
        fwd = ck.win + (w & 1) * W * 32 + lane;
        if (kCkptInterleave<T> && w > 0) ck.start(w - 1);
      }
      if (kCkptInterleave<T> && ck.k < W) ck.unit();
    }
    if (j == 0 && s <= C) {  // uniform: the next chunk of north values
      const int k = (s - 1) / kChunk;
      if (north_ready != nullptr) {
        wait_for(north_ready, k + 1);
        if (north_ring) __threadfence_block(); else __threadfence();
      }
      const int c = s + lane;
      up = c > C ? lift<S>(T(0))
           : north_ring ? vload(north + ((c - 1) & (kRing - 1)))
           : kStripe || north != nullptr ? vload(north + c) : lift<S>(T(1));
      if (north_ring) {
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          *(volatile int*)(sh.consumed + warp - 1) = k + 1;
        }
      }
    }
    if constexpr (kAdjoint && !kCkpt) {
      if (js == 0) {  // this stage's forward values are in; fetch the next
        prefetch((s - 1) / kStage + 1);
        wait_async<1>();
      }
    }
    const S from_up = shfl(up, j);
    S n = shfl_up(cur);
    if (lane == 0) n = from_up;
    const int c = s - lane;
    T term = T(0);
    if (c >= 1 && c <= C) {
      const S v = band_cell(nw, n, cur, u, naive != 0);
      if constexpr (kCkpt) {
        if (has_inc) term = mul(fwd[(rows + C - i0 - s - e_cur) * 32], nw);
      } else if constexpr (kAdjoint) {
        if (has_inc) {
          term = mul(stage[(((s - 1) / kStage) & 1) * kStage * 32 + js * 32 +
                           lane], nw);
        }
      }
      cur = v;
      if (++m == f) {
        m = 0;
        ++q;
        u = u_next;
        if constexpr (Src::kAligned) {
          u_next = u_more;
          more = false;
        } else {
          u_next = incs.col(q + 1);
        }
      }
      if constexpr (kStack) {
        if (live) stk[static_cast<int64_t>(i + c) * stride + i] = v;
      }
      if constexpr (kSparse) {
        if (live && pw < 2 && pq <= last_pair) {
          stk[(2 * pq + pw) * stride + i] = v;
        }
      }
      if (lane == out_lane) {
        const int k = (c - 1) / kChunk;
        const bool last = (c & (kChunk - 1)) == 0 || c == C;
        if (out_ring) {
          volatile S* ring = sh.ring[warp];
          if (((c - 1) & (kChunk - 1)) == 0 && k >= kRingChunks) {
            wait_for(sh.consumed + warp, k - kRingChunks + 1);
          }
          vstore(ring + ((c - 1) & (kRing - 1)), v);
          if (last) {
            __threadfence_block();
            *(volatile int*)(sh.ready + warp) = k + 1;
          }
        } else if (kStripe || out != nullptr) {
          vstore(static_cast<volatile S*>(out + c), v);
          if (last && out_ready != nullptr) {
            __threadfence();
            *(volatile int*)out_ready = k + 1;
          }
        } else if (c == C) {
          bottom[pair] = v;  // a whole frame's corner K[R][C]
        }
      }
    }
    if constexpr (kAdjoint) {  // the group's terms of forward diagonal p
      const int rr = (C - s) & (kF - 1);
      if (rr == kF - 1) {  // uniform: a new base column enters
        const int b = ((C - s + gbase) >> lg) + 2;  // hi's column
        if (lead) {
          emit(hi, b, ct_hi);
          if constexpr (!Src::kFold) ct_hi = fetch(b - 1);
        }
        hi = lo;
        lo = T(0);
      }
#pragma unroll
      for (int jj = kF - 1; jj >= 0; --jj) {
        const T t = __shfl_sync(kFullMask, term, gbase + jj);
        const int cs = s - gbase - jj;
        if (cs >= 1 && cs <= C) {
          if (jj >= kF - rr) hi = add(hi, t); else lo = add(lo, t);
        }
      }
    }
    nw = n;
    if constexpr (kSparse) {
      if (++pw == W) {
        pw = 0;
        ++pq;
      }
    }
  }
  if constexpr (kAdjoint) {  // the two cells still open
    if (lead) {
      const int b0 = gbase - 31;  // C - s + gbase after the last step
      emit(hi, (b0 >> lg) + 1, ct_hi);
      if constexpr (Src::kFold) {
        emit(lo, b0 >> lg, T(0));
      } else {
        emit(lo, b0 >> lg, fetch(b0 >> lg));
      }
    }
  }
}

}  // namespace sigkernel
