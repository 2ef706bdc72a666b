// RBF increment generation from path points, shared by K1 and K3<gen> for
// f <= 32 (rbf_gen_wavefront.cu and adjoint_collapse.cu, RbfSource), K3<gen>
// past it (adjoint_collapse.cu, RbfGen), K4 (rbf_dd_vjp.cu) and K9
// (rbf_gen_increments.cu), so that all of them round exactly alike.
#pragma once

#include "wavefront.cuh"

namespace sigkernel {

__device__ __forceinline__ float sk_exp(float v) { return expf(v); }
__device__ __forceinline__ double sk_exp(double v) { return exp(v); }

// |x_a - y_b|^2 as (|x_a|^2 + |y_b|^2) - 2 <x_a, y_b>, the sums over d in
// order: the op order of the plain versions (and of the TPU generation
// kernels), symmetric in x and y so a transposed solve rounds exactly as the
// untransposed one.
template <typename T>
__device__ __forceinline__ T sqdist(const T* xa, const T* yb, int D) {
  T dot = T(0), sx = T(0), sy = T(0);
  for (int d = 0; d < D; ++d) {
    dot = add(dot, mul(xa[d], yb[d]));
    sx = add(sx, mul(xa[d], xa[d]));
    sy = add(sy, mul(yb[d], yb[d]));
  }
  return sub(add(sx, sy), mul(T(2), dot));
}

// G = exp(-|x_a - y_b|^2 / sigma) from |x_a|^2, |y_b|^2 and <x_a, y_b>, in
// sqdist's expression: the one every generator rounds G by.
template <typename T>
__device__ __forceinline__ T rbf_value(T sx, T sy, T dot, T sigma) {
  return sk_exp(-sub(add(sx, sy), mul(T(2), dot)) / sigma);
}

// A base cell's increment from its corners' G values, (g11 + g00) - (g10 +
// g01): the TPU generation kernels' op order, and gen_increments'.
template <typename T>
__device__ __forceinline__ T rbf_dd(T g11, T g00, T g10, T g01) {
  return sub(add(g11, g00), add(g10, g01));
}

// One pair's generator: x (Lx, D), y (Ly, D) and sigma.
template <typename T>
struct RbfGen {
  const T* x;
  const T* y;
  int D;
  T sigma;
  T scale;  // 1 / f^2, exact

  __device__ RbfGen(const T* x_, const T* y_, int D_, int f, T sigma_)
      : x(x_), y(y_), D(D_), sigma(sigma_), scale(T(1) / T(f * f)) {}

  // G(a, b) = exp(-|x_a - y_b|^2 / sigma)
  __device__ __forceinline__ T G(int a, int b) const {
    return sk_exp(-sqdist(x + static_cast<int64_t>(a) * D,
                          y + static_cast<int64_t>(b) * D, D) / sigma);
  }

  // The refined increment of every refined cell inside base cell (a, b):
  // (g11 + g00) - (g10 + g01), the TPU generation kernels' op order, then
  // the exact 1 / f^2. The expression is symmetric under flipping both
  // axes, so the reverse sweep's increments round as the forward's.
  __device__ __forceinline__ T inc(int a, int b) const {
    return mul(sub(add(G(a + 1, b + 1), G(a, b)),
                   add(G(a + 1, b), G(a, b + 1))),
               scale);
  }
};

// The band sweep's increment source (band_sweep.cuh) for the RBF kernel:
// one lane of frame row i owns base row ra of the pair's shorter path
// `rows` (the wrapper orients the pair so that Lr <= Lc). It keeps x_ra and
// x_ra+1 (kD > 0: in registers, kD = D; kD = 0: any D, read through __ldg),
// their squared norms, and G(ra, b), G(ra + 1, b) of the last base column b
// it generated, so that the next column's increment costs two new G values
// (two exp, two D-long dot products sharing one y point), not RbfGen::inc's
// four; the sweep asks for the columns on warp-uniform steps (kAligned), so
// a warp generates once every f steps. kD > 0 also loads the next column's
// y point while it generates this one, a column before its use. Each G
// value is sqdist's and RbfGen::G's expression in their op order, and the
// increment RbfGen::inc's, so a cached value rounds as a regenerated one:
// the sweep stays bit-equal to the plain version.
//
// The walk. Forward (K1, K1-stack): the sweep's q-th column is base column
// q, the cache starts at column 0, and column q costs the G values of
// column q + 1. With flip (K3<gen>'s reverse sweep, whose q-th column is
// forward base column b = Cb - 1 - q): the cache starts at column Cb,
// column b costs the G values of column b, and the points are loaded
// downward. The increment is (G(a+1, b+1) + G(a, b)) - (G(a+1, b) + G(a,
// b+1)) either way, with the same two operand pairs: forward the new
// values are the b + 1 ones, so the pairs read (g1n + g0) and (g1 + g0n);
// reversed the new values are the b ones, so they read (g1 + g0n) and
// (g1n + g0). IEEE addition is commutative, so each pair's sum, and so the
// increment, rounds exactly as RbfGen::inc and gen_increments round it.
template <typename T, int kD>
struct RbfSource {
  using State = T;
  static constexpr bool kStripe = false;  // the whole frame, from 1s
  static constexpr bool kAligned = true;  // generated on uniform steps
  static constexpr bool kFold = false;    // K1's; K3<gen>: RbfFoldSource
  static constexpr int kStage = 16;  // kBandAdjoint's stage, in steps
  static constexpr int kN = kD > 0 ? kD : 1;
  const T* rows;
  const T* cols;
  const int64_t* ri;
  const int64_t* ci;
  int Lr, Lc, D;
  T sigma;

  struct Lane {
    const T* x;  // x_ra (kD = 0 only)
    const T* y;  // the pair's column path
    int D, Cb, flip;
    bool has_inc;
    T sigma, scale;
    T x0[kN], x1[kN], yn[kN];  // x_ra, x_ra+1, the next column's y (kD > 0)
    T sx0, sx1;                // |x_ra|^2, |x_ra+1|^2
    T g0, g1;                  // G(ra, b), G(ra + 1, b): the last column b

    __device__ __forceinline__ T G(T sx, T sy, T dot) const {
      return rbf_value(sx, sy, dot, sigma);
    }

    // G(ra, b) and G(ra + 1, b) into g0n, g1n, from point b's values (kD >
    // 0: yb holds them; kD = 0: read from y)
    __device__ __forceinline__ void column(int b, const T* yb, T& g0n,
                                           T& g1n) const {
      T dot0 = T(0), dot1 = T(0), sy = T(0);
      if constexpr (kD > 0) {
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          dot0 = add(dot0, mul(x0[d], yb[d]));
          dot1 = add(dot1, mul(x1[d], yb[d]));
          sy = add(sy, mul(yb[d], yb[d]));
        }
      } else {
        const T* yp = y + static_cast<int64_t>(b) * D;
        for (int d = 0; d < D; ++d) {
          const T v = __ldg(yp + d);
          dot0 = add(dot0, mul(__ldg(x + d), v));
          dot1 = add(dot1, mul(__ldg(x + D + d), v));
          sy = add(sy, mul(v, v));
        }
      }
      g0n = G(sx0, sy, dot0);
      g1n = G(sx1, sy, dot1);
    }

    __device__ __forceinline__ void load(int b) {  // yn = y_b (kD > 0)
      if constexpr (kD > 0) {
        const T* yp = y + static_cast<int64_t>(b) * kD;
#pragma unroll
        for (int d = 0; d < kD; ++d) yn[d] = __ldg(yp + d);
      }
    }

    // the sweep's base column q (forward base column q, or Cb - 1 - q with
    // flip); called for q = 0, 1, 2, ... in order
    __device__ __forceinline__ T col(int q) {
      if (!has_inc || q >= Cb) return T(0);
      const int b = flip ? Cb - 1 - q : q + 1;  // the G column it costs
      T g0n, g1n;
      column(b, yn, g0n, g1n);
      if (q + 1 < Cb) load(flip ? b - 1 : b + 1);
      // the same operand pairs either way (see above)
      const T v = flip ? mul(rbf_dd(g1, g0n, g1n, g0), scale)
                       : mul(rbf_dd(g1n, g0, g1, g0n), scale);
      g0 = g0n;
      g1 = g1n;
      return v;
    }
  };

  // the lane of base row ra of pair `pair`'s frame, (Mb, Nb) in either
  // orientation (its columns are the longer side)
  __device__ __forceinline__ Lane lane(int64_t pair, int ra, bool has_inc,
                                       int Mb, int Nb, int f,
                                       int flip) const {
    Lane l;
    l.x = rows + (ri[pair] * Lr + ra) * static_cast<int64_t>(D);
    l.y = cols + ci[pair] * static_cast<int64_t>(Lc) * D;
    l.D = D;
    l.Cb = Mb > Nb ? Mb : Nb;
    l.flip = flip;
    l.has_inc = has_inc;
    l.sigma = sigma;
    l.scale = T(1) / T(f * f);
    l.sx0 = l.sx1 = l.g0 = l.g1 = T(0);
    if (!has_inc) return l;
    if constexpr (kD > 0) {  // unrolled: the arrays stay in registers
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        l.x0[d] = __ldg(l.x + d);
        l.x1[d] = __ldg(l.x + kD + d);
        l.sx0 = add(l.sx0, mul(l.x0[d], l.x0[d]));
        l.sx1 = add(l.sx1, mul(l.x1[d], l.x1[d]));
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const T a = __ldg(l.x + d), b = __ldg(l.x + D + d);
        l.sx0 = add(l.sx0, mul(a, a));
        l.sx1 = add(l.sx1, mul(b, b));
      }
    }
    const int b0 = flip ? l.Cb : 0;  // the cache's first column
    l.load(b0);
    l.column(b0, l.yn, l.g0, l.g1);
    l.load(flip ? b0 - 1 : 1);
    return l;
  }
};

// K3<gen>'s source: RbfSource, with the collapse's epilogue folded into the
// band kernel (kFold, band_sweep.cuh): each base cell is stored once as
// mul(mul(add(0, sum), scale), wt[pair]), where scale is the exact 1 / f^2
// and wt the launch's per-pair weights (null: a weight of 1). Bit for
// bit the plain version's ct / f^2 * g; a type of its own, so that K1's
// instances (RbfSource) keep their code.
template <typename T, int kD>
struct RbfFoldSource : RbfSource<T, kD> {
  static constexpr bool kFold = true;
  const T* wt;  // (P,) of the launch, or null
  T scale;      // 1 / f^2
};

}  // namespace sigkernel
