// K5: the triple wavefront of the derivative Gram, (K, K_diff, K_diffdiff).
//
// Replaces the TPU kernels
//   sigkernel_tpu/ops/pallas_derivatives.py::_deriv_kernel     (float)
//   sigkernel_tpu/ops/pallas_derivatives.py::_deriv_kernel_df  (double)
// The DF twin kept f64-grade derivatives on a chip without f64; here it is
// the double instance of one template.
//
// Three base increment grids (P, Mb, Nb) -- of the static-kernel Gram and
// of its first and second directional derivatives -- are refined by an
// index shift and the exact 1 / f^2 in the kernel, so no refined grid
// exists. K takes the order-2 scheme; the derivative states take the
// product-rule recurrences f1..f4 / g1..g4, in the op order of the plain
// version (ops/scan_solver.py::solve_derivatives_final) and rounded after
// every operation, so the two agree bit for bit.
//
// The design: the band-pipelined wavefront of band_sweep.cuh with
// DerivSource, a pair's whole frame (transposed when Mb > Nb) swept by
// ceil(R / 128) blocks of 128 rows, a lane a row, each lane holding the
// three states of its west, north-west and north cells in registers and
// the hand-offs carrying the three values of a column. Nothing of the
// frame sits in shared memory, so no row count bounds it (the earlier
// one-block kernel kept two diagonals of each state there: at most 4,840
// rows in double). What bounds it on the H100: the arithmetic, about 45
// rounded operations a refined cell, and the six shuffles of a step (three
// in float); the three grids are read once a base cell by each of its f
// lanes.
#include "band_sweep.cuh"

namespace sigkernel {

template <typename T>
int launch_deriv(const void* inc, const void* inc_d, const void* inc_dd,
                 void* out, void* scratch, void* counters, int64_t P, int Mb,
                 int Nb, int f, int nbands, int device, void* stream) {
  const int R = (Mb > Nb ? Nb : Mb) * f;
  if (Mb < 1 || Nb < 1 || nbands != band_count(R) ||
      P * nbands >= (int64_t(1) << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const DerivSource<T> src{static_cast<const T*>(inc),
                           static_cast<const T*>(inc_d),
                           static_cast<const T*>(inc_dd)};
  band_stripe<T, kBandBottom, 1, DerivSource<T>>
      <<<static_cast<unsigned>(P * nbands), kBandRows, 0,
         static_cast<cudaStream_t>(stream)>>>(
          src, nullptr, static_cast<Triple<T>*>(out), nullptr,
          static_cast<Triple<T>*>(scratch), static_cast<int*>(counters),
          nullptr, P, nbands, Mb, Nb, f, 0, R, 0, 0);
  return cudaGetLastError();
}

}  // namespace sigkernel

extern "C" {

// inc, inc_d, inc_dd: (P, Mb, Nb) base grids, Mb, Nb >= 1; out: (P, 3),
// the corners (K, K_diff, K_diffdiff) of each pair; scratch: (P, nbands -
// 1, C + 1, 3) values with C = max(Mb, Nb) f; counters: P * nbands + 1
// zeroed ints; nbands = ceil(min(Mb, Nb) f / 128).
int sk_deriv_wavefront_f32(const void* inc, const void* inc_d,
                           const void* inc_dd, void* out, void* scratch,
                           void* counters, int64_t P, int Mb, int Nb, int f,
                           int nbands, int device, void* stream) {
  return sigkernel::launch_deriv<float>(inc, inc_d, inc_dd, out, scratch,
                                        counters, P, Mb, Nb, f, nbands,
                                        device, stream);
}

int sk_deriv_wavefront_f64(const void* inc, const void* inc_d,
                           const void* inc_dd, void* out, void* scratch,
                           void* counters, int64_t P, int Mb, int Nb, int f,
                           int nbands, int device, void* stream) {
  return sigkernel::launch_deriv<double>(inc, inc_d, inc_dd, out, scratch,
                                         counters, P, Mb, Nb, f, nbands,
                                         device, stream);
}

}  // extern "C"
