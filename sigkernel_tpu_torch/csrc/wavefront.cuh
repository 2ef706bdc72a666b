// Shared anti-diagonal sweep of the Goursat PDE for one path pair.
//
// One thread block solves one pair. The diagonal axis is the shorter
// refined side R (the recurrence is exactly transpose-covariant: k01 and
// k10 enter only as a sum), the other side is C >= R. The last three
// anti-diagonals live in a ring in shared memory, indexed by the row:
// ring[(p % 3) * (R + 1) + i] = K[i, p - i]. Threads stride over the cells
// of a diagonal; one __syncthreads() per diagonal, reached by every thread,
// separates the write of diagonal p from the overwrite of its slot by
// diagonal p + 3 (the ring of three lets diagonal p + 1 write the slot of
// p - 2 while nobody reads it any more).
//
// Only rows max(1, p - C) <= i <= min(R, p - 1) are written, so row 0 and
// the not-yet-reached row p keep the boundary value 1 they were set to.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sigkernel {

constexpr int kMaxThreads = 256;

inline int threads_for(int rows) {
  const int t = ((rows + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// Rounded arithmetic that the compiler may not contract into FMA. The plain
// PyTorch versions round after every operation; with the same op order the
// kernels then round exactly as they do. (In float an FMA-contracted scheme
// drifts from the plain loop by up to 6e-2 at length 1024, dyadic 2: the
// sweep adds millions of rounding errors of one sign.)
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

// Same op order as the plain schemes in ops/scan_solver.py:
//   naive:   (k01 + k10) * (1 + 0.5 u) - k00
//   order 2: (k01 + k10) * (1 + 0.5 u + u^2/12) - k00 * (1 - u^2/12)
template <typename T>
__device__ __forceinline__ T scheme(T k00, T k01, T k10, T u, bool naive) {
  const T s = add(k01, k10);
  const T lin = add(T(1), mul(T(0.5), u));
  if (naive) return sub(mul(s, lin), k00);
  const T u2 = mul(mul(u, u), T(1.0 / 12.0));
  return sub(mul(s, add(lin, u2)), mul(k00, sub(T(1), u2)));
}

// Sweep an R x C refined grid (R >= 1); inc(r, c) is the refined increment
// of cell (r + 1, c + 1) in the solve's frame. Returns K[R, C] to every
// thread.
template <typename T, typename Inc>
__device__ T sweep(T* ring, int R, int C, bool naive, const Inc& inc) {
  const int stride = R + 1;
  for (int k = threadIdx.x; k < 3 * stride; k += blockDim.x) ring[k] = T(1);
  __syncthreads();
  for (int p = 2; p <= R + C; ++p) {
    T* cur = ring + (p % 3) * stride;
    const T* m1 = ring + ((p - 1) % 3) * stride;
    const T* m2 = ring + ((p - 2) % 3) * stride;
    const int lo = p - C > 1 ? p - C : 1;
    const int hi = p - 1 < R ? p - 1 : R;
    for (int i = lo + threadIdx.x; i <= hi; i += blockDim.x) {
      cur[i] = scheme(m2[i - 1], m1[i - 1], m1[i], inc(i - 1, p - i - 1),
                      naive);
    }
    __syncthreads();
  }
  return ring[((R + C) % 3) * stride + R];
}

// Opt in to dynamic shared memory above the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace sigkernel
