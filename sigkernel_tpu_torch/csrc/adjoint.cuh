// The adjoint PDE sweep with the product and the dyadic collapse done in
// flight, one thread block per pair: the body of K3 (adjoint_collapse.cu)
// and K8 (adjoint_ckpt.cu).
//
// What it computes. The gradient of the corner K[R, C] with respect to the
// refined increment of cell (i + 1, j + 1) is K[i, j] * K_rev[R-1-i, C-1-j],
// where K_rev solves the same PDE on the increments flipped along both axes
// (variation of parameters; sigkernel_tpu/ops/solve.py:235-248). The base
// cotangent of base cell (a, b) is the sum of that product over the f x f
// refined cells of the base cell, times 1 / f^2 (the VJP of the dyadic
// refinement). This kernel writes the block SUMS; the wrapper applies the
// exact 1 / f^2 and the caller the upstream cotangent g (outside, in the
// backward's dtype, as the f64-grade JAX route does), so one launch serves
// every weighting.
//
// Index algebra, in the solve's frame (rows r < R are the shorter refined
// side, R = Rb f, C = Cb f; the forward stack is in the same frame):
//   - reverse cell (i', j') lies on reverse diagonal q = i' + j'; its
//     increment is inc(R - i', C - j') (inc(r, c) feeds forward cell
//     (r + 1, c + 1), and flipping both axes maps reverse cell (i', j') to
//     forward increment (R-1-(i'-1), C-1-(j'-1)));
//   - the product pairs reverse cell (i', j') = (R-1-i, C-1-j) with forward
//     cell (i, j) on forward diagonal p = R + C - 2 - q, for 0 <= i < R,
//     0 <= j < C; that is reverse diagonals q = 0 .. R + C - 2, and the
//     forward value is stack[p][i];
//   - the output is in the ORIGINAL frame: base cell (a, b) of the solve's
//     frame goes to ct[a * Cb + b], or to ct[b * Rb + a] when the solve was
//     transposed.
//
// The collapse without races or atomics: thread t owns base rows a = t,
// t + T, ... of the solve's frame, i.e. refined rows a f .. a f + f - 1. On
// one diagonal those f cells fall into at most two base columns, and no
// other thread ever touches row a, so each term is added with a plain
// read-add-write into the output (zeroed by the wrapper). The order of the
// terms of one base cell is fixed: diagonals in the reverse sweep's order
// (forward p descending), rows k = 0 .. f - 1 ascending within one
// diagonal. scan_solver.collapse_refined sums in the same order, so the
// kernel and its plain version agree bit for bit.
//
// Races on the ring: the product of reverse diagonal q reads only ring
// slot q % 3, after the barrier that ends diagonal q. Diagonal q + 1 writes
// slot (q + 1) % 3; slot q % 3 is rewritten at diagonal q + 3, after two more
// barriers that every thread reaches only after its product of q. One
// barrier per diagonal, as in the forward.
//
// Generalisations. `fwd(p)` returns the forward solution's diagonal p
// (K3: a row of the stack; K8: a row of the window it rebuilt, which may
// run barriers of its own, so every thread calls it on every diagonal).
// kNorth: row 0 of the reverse sweep is the north boundary bd[0 .. C] (the
// reverse problem's stripe above, K3<inc, boundary>) instead of 1. The
// sweep's rows may be one stripe of a taller frame: its base rows are frame
// base rows a0 .. a0 + R / f - 1, the frame has Rb_all base rows, and rows
// at or past Rb_all (zero-row padding) write nothing.
#pragma once

#include "wavefront.cuh"

namespace sigkernel {

// The forward solution from a full stack (K3).
template <typename T>
struct StackRows {
  const T* __restrict__ stack;
  int stride;
  __device__ __forceinline__ const T* operator()(int p) const {
    return stack + static_cast<int64_t>(p) * stride;
  }
};

template <typename T, bool kNorth = false, typename Inc, typename Fwd>
__device__ void adjoint_body(T* ring, int R, int C, int f, bool naive,
                             const Inc& inc, const Fwd& fwd, T* __restrict__ ct,
                             int transpose, int a0, int Rb_all,
                             const T* __restrict__ bd = nullptr) {
  const int stride = R + 1;
  const int Rb = R / f, Cb = C / f;
  for (int k = threadIdx.x; k < 3 * stride; k += blockDim.x) {
    ring[k] = kNorth && k == 0 ? bd[0] : kNorth && k == stride ? bd[1] : T(1);
  }
  __syncthreads();
  for (int q = 0; q <= R + C - 2; ++q) {
    T* cur = ring + (q % 3) * stride;
    if (q >= 2) {
      const T* m1 = ring + ((q - 1) % 3) * stride;
      const T* m2 = ring + ((q - 2) % 3) * stride;
      const int lo = q - C > 1 ? q - C : 1;
      const int hi = q - 1 < R ? q - 1 : R;
      if constexpr (kNorth) {
        if (threadIdx.x == 0 && q <= C) cur[0] = bd[q];
      }
      for (int i = lo + threadIdx.x; i <= hi; i += blockDim.x) {
        cur[i] = scheme(m2[i - 1], m1[i - 1], m1[i], inc(R - i, C - (q - i)),
                        naive);
      }
    }
    // diagonals 0 and 1 are boundary cells: the ring already holds them
    const int p = R + C - 2 - q;
    const T* srow = fwd(p);
    if (q >= 2) __syncthreads();
    for (int a = threadIdx.x; a < Rb; a += blockDim.x) {
      const int ga = a0 + a;  // the frame's base row
      if (ga >= Rb_all) break;
      for (int k = 0; k < f; ++k) {
        const int i = a * f + k;
        const int j = p - i;
        if (j < 0 || j >= C) continue;
        const int b = j / f;
        T* cell = ct + (transpose ? static_cast<int64_t>(b) * Rb_all + ga
                                  : static_cast<int64_t>(ga) * Cb + b);
        *cell = add(*cell, mul(srow[i], cur[R - 1 - i]));
      }
    }
  }
}

}  // namespace sigkernel
