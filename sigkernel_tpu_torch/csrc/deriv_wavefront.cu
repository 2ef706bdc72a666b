// K5: the triple wavefront of the derivative Gram, (K, K_diff, K_diffdiff).
//
// Replaces the TPU kernels
//   sigkernel_tpu/ops/pallas_derivatives.py::_deriv_kernel     (float)
//   sigkernel_tpu/ops/pallas_derivatives.py::_deriv_kernel_df  (double)
// The DF twin kept f64-grade derivatives on a chip without f64; here it is
// the double instance of one template.
//
// Three base increment grids (P, Mb, Nb) -- of the static-kernel Gram and
// of its first and second directional derivatives -- are read through
// IncGrid (index shift plus the exact 1 / f^2), so no refined grid exists.
// K takes the order-2 scheme; the derivative states take the product-rule
// recurrences f1..f4 / g1..g4, in the op order of the plain version
// (ops/scan_solver.py::solve_derivatives_final) and rounded after every
// operation, so the two agree bit for bit.
//
// What bounds it on the H100: arithmetic (about 45 rounded operations per
// refined cell, in double for the f64 instance) and one barrier per
// anti-diagonal; the three increment grids are read f^2 times each through
// L1/L2, at base resolution.
//
// Shared memory is the design constraint: three states, not one. A ring of
// three diagonals per state (72 B a row in double) would cap the shorter
// refined side R near 3,200, below the 4,092 rows of length 1024 at dyadic
// 2. So each state keeps two slots of S = R + 2 values (48 B a row in
// double): diagonal p lives in slot p % 2, which diagonal p - 2 used,
// stored cyclically shifted by one place every second diagonal,
//   row i of diagonal p at position (i - floor(p / 2)) mod S.
// Then the cell (p, i) sits where (p - 2, i - 1) sat, and that value, k00,
// is read by the thread of row i alone: each thread reads its k00 and
// overwrites it, and no thread reads a place another one writes. The
// neighbours k01, k10 come from the other slot, which diagonal p does not
// touch. The boundary cells of diagonal p (row 0 when p <= C, row p when
// p <= R) land on places that no row of diagonal p - 2 holds, and are
// written explicitly. One barrier per diagonal, as in K2. The bound is
// 6 (R + 2) sizeof(T) <= 227 KB: R <= 4,840 in double, 9,683 in float
// (ops/cuda_deriv.py::max_rows).
#include "wavefront.cuh"

namespace sigkernel {

// (-floor(p / 2)) mod S: the shift of diagonal p in its slot
__device__ __forceinline__ int slot_base(int p, int S) {
  const int h = (p >> 1) % S;
  return h == 0 ? 0 : S - h;
}

// (i + base) mod S for 0 <= i <= S, 0 <= base < S
__device__ __forceinline__ int slot_pos(int i, int base, int S) {
  const int q = i + base;
  return q < S ? q : q - S;
}

template <typename T>
__global__ void deriv_wavefront(const T* __restrict__ inc,
                                const T* __restrict__ inc_d,
                                const T* __restrict__ inc_dd,
                                T* __restrict__ out_k, T* __restrict__ out_d,
                                T* __restrict__ out_s, int Mb, int Nb, int f,
                                int transpose) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  const int S = R + 2;
  T* ks = reinterpret_cast<T*>(smem);  // [2][S] each
  T* ds = ks + 2 * S;
  T* ss = ds + 2 * S;
  const int64_t pair = blockIdx.x;
  const int64_t off = pair * static_cast<int64_t>(Mb) * Nb;
  const T scale = T(1) / T(f * f);
  const IncGrid<T> gu{inc + off, Nb, f, transpose, scale};
  const IncGrid<T> gd{inc_d + off, Nb, f, transpose, scale};
  const IncGrid<T> gs{inc_dd + off, Nb, f, transpose, scale};

  // diagonals 0 and 1 are all boundary: K = 1, K_diff = K_diffdiff = 0
  for (int k = threadIdx.x; k < 2 * S; k += blockDim.x) {
    ks[k] = T(1);
    ds[k] = T(0);
    ss[k] = T(0);
  }
  __syncthreads();
  for (int p = 2; p <= R + C; ++p) {
    const int cur = (p & 1) * S;  // slot of p (and of p - 2)
    const int prv = S - cur;      // slot of p - 1
    const int base = slot_base(p, S);
    const int base1 = slot_base(p - 1, S);
    const int lo = p - C > 1 ? p - C : 1;
    const int hi = p - 1 < R ? p - 1 : R;
    for (int i = lo + threadIdx.x; i <= hi; i += blockDim.x) {
      const int q = cur + slot_pos(i, base, S);  // (p, i) = (p - 2, i - 1)
      const int a0 = slot_pos(i - 1, base1, S);  // (p - 1, i - 1)
      const int a = prv + a0;
      const int b = prv + (a0 + 1 < S ? a0 + 1 : 0);  // (p - 1, i)
      const T k00 = ks[q], k01 = ks[a], k10 = ks[b];
      const T d00 = ds[q], d01 = ds[a], d10 = ds[b];
      const T s00 = ss[q], s01 = ss[a], s10 = ss[b];
      const int r = i - 1, c = p - i - 1;
      const T u = gu(r, c), ud = gd(r, c), us = gs(r, c);

      const T k = scheme(k00, k01, k10, u, false);

      const T f1 = add(mul(k00, ud), mul(d00, u));
      const T f2 = add(mul(k01, ud), mul(d01, u));
      const T f3 = add(mul(k10, ud), mul(d10, u));
      const T dsum = sub(add(d01, d10), d00);
      const T f4 = add(mul(k, ud), mul(add(dsum, f1), u));
      const T d = add(dsum, mul(T(0.25), add(add(add(f1, f2), f3), f4)));

      const T two = T(2);
      const T g1 = add(add(mul(k00, us), mul(mul(two, d00), ud)),
                       mul(s00, u));
      const T g2 = add(add(mul(k01, us), mul(mul(two, d01), ud)),
                       mul(s01, u));
      const T g3 = add(add(mul(k10, us), mul(mul(two, d10), ud)),
                       mul(s10, u));
      const T ssum = sub(add(s01, s10), s00);
      const T g4 = add(add(mul(k, us), mul(mul(two, d), ud)),
                       mul(add(ssum, g1), u));
      const T s = add(ssum, mul(T(0.25), add(add(add(g1, g2), g3), g4)));

      ks[q] = k;
      ds[q] = d;
      ss[q] = s;
    }
    if (threadIdx.x == 0) {
      if (p <= C) {  // K[0, p]
        const int q = cur + slot_pos(0, base, S);
        ks[q] = T(1);
        ds[q] = T(0);
        ss[q] = T(0);
      }
      if (p <= R) {  // K[p, 0]
        const int q = cur + slot_pos(p, base, S);
        ks[q] = T(1);
        ds[q] = T(0);
        ss[q] = T(0);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int p = R + C;
    const int q = (p & 1) * S + slot_pos(R, slot_base(p, S), S);
    out_k[pair] = ks[q];
    out_d[pair] = ds[q];
    out_s[pair] = ss[q];
  }
}

template <typename T>
int launch_deriv(const void* inc, const void* inc_d, const void* inc_dd,
                 void* out_k, void* out_d, void* out_s, int64_t P, int Mb,
                 int Nb, int f, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const size_t smem = 6 * static_cast<size_t>(R + 2) * sizeof(T);
  e = allow_smem(deriv_wavefront<T>, smem);
  if (e != cudaSuccess) return e;
  deriv_wavefront<T><<<static_cast<unsigned>(P), threads_for(R), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inc), static_cast<const T*>(inc_d),
      static_cast<const T*>(inc_dd), static_cast<T*>(out_k),
      static_cast<T*>(out_d), static_cast<T*>(out_s), Mb, Nb, f, transpose);
  return cudaGetLastError();
}

}  // namespace sigkernel

extern "C" {

// inc, inc_d, inc_dd: (P, Mb, Nb) base grids; out_*: (P,)
int sk_deriv_wavefront_f32(const void* inc, const void* inc_d,
                           const void* inc_dd, void* out_k, void* out_d,
                           void* out_s, int64_t P, int Mb, int Nb, int f,
                           int device, void* stream) {
  return sigkernel::launch_deriv<float>(inc, inc_d, inc_dd, out_k, out_d,
                                        out_s, P, Mb, Nb, f, device, stream);
}

int sk_deriv_wavefront_f64(const void* inc, const void* inc_d,
                           const void* inc_dd, void* out_k, void* out_d,
                           void* out_s, int64_t P, int Mb, int Nb, int f,
                           int device, void* stream) {
  return sigkernel::launch_deriv<double>(inc, inc_d, inc_dd, out_k, out_d,
                                         out_s, P, Mb, Nb, f, device, stream);
}

}  // extern "C"
