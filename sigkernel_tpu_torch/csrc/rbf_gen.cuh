// RBF increment generation from path points, shared by K1
// (rbf_gen_wavefront.cu), K3<gen> (adjoint_collapse.cu) and K4
// (rbf_dd_vjp.cu), so that all three round exactly alike.
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

}  // namespace sigkernel
