// K1: wavefront with RBF increments generated in-kernel from path points.
//
// Replaces the value path of the TPU kernels
//   sigkernel_tpu/ops/pallas_gen32.py::_wavefront_f32_gen_kernel
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_gen_kernel
//   sigkernel_tpu/ops/pallas_fused.py::_fused_rbf_kernel
//   sigkernel_tpu/ops/pallas_fused.py::_fused_rbf_dyadic_kernel
// (float instance for the f32 kernels, double for the DF one).
//
// Paths in, values out: X (A, Lx, D), Y (B, Ly, D) and the pair index
// arrays ri/ci are all the kernel reads; no increment grid exists in device
// memory. One kernel serves pairwise kernels (ri = ci = arange), the full
// Gram, the symmetric triangle and the Gram linear-combination chunks.
//
// K1-stack (kStack = true) also writes the solution stack the adjoint
// consumes (K2-stack's layout, wavefront.cuh), replacing the stack outputs of
//   sigkernel_tpu/ops/pallas_gen32.py::solve_final_f32_gen_stack
//   sigkernel_tpu/ops/pallas_df64.py::solve_final_df_gen_stack
// one store per stack cell, the lanes of a step on neighbouring addresses.
//
// What bounds it on the H100: the arithmetic of the sweep and of the
// generation, and for K1-stack the stack's bytes (8.6 GB for 128 pairs in
// double at length 1024, dyadic 1). The earlier design ran one block a pair
// with a barrier a diagonal and regenerated four G values (four exp and four
// D-long distances) for every refined cell, f^2 times what the base grid
// needs: ~100x its bound. Here the pair's whole frame is swept by the
// band-pipelined wavefront of band_sweep.cuh (ceil(R / 128) blocks a pair,
// the sweep in registers, no barrier a diagonal; no row bound, since
// nothing of the frame sits in shared memory) with rbf_gen.cuh's RbfSource
// as its increment source: each lane keeps its base row's two points and
// the last base column's two G values, so a base column costs each lane
// two exp, one column ahead of its use. The wrapper (ops/cuda_gen.py)
// orients each pair so that `rows` is the shorter path (the RBF kernel is
// symmetric and the recurrence transpose-covariant), and launches the pairs
// in chunks whose hand-off scratch stays within its bound.
#include "band_sweep.cuh"
#include "rbf_gen.cuh"

namespace sigkernel {

template <typename T, bool kStack, int kD>
cudaError_t launch_gen_band(const void* rows, const void* cols,
                            const void* ri, const void* ci, void* out,
                            void* stack, void* scratch, void* counters,
                            int64_t P, int Lr, int Lc, int D, int f,
                            double sigma, int nbands, int naive,
                            cudaStream_t stream) {
  const RbfSource<T, kD> src{
      static_cast<const T*>(rows), static_cast<const T*>(cols),
      static_cast<const int64_t*>(ri), static_cast<const int64_t*>(ci), Lr,
      Lc, D, static_cast<T>(sigma)};
  constexpr int kMode = kStack ? kBandStack : kBandBottom;
  band_stripe<T, kMode, 1, RbfSource<T, kD>>
      <<<static_cast<unsigned>(P * nbands), kBandRows, 0, stream>>>(
          src, nullptr, static_cast<T*>(out), static_cast<T*>(stack),
          static_cast<T*>(scratch), static_cast<int*>(counters), nullptr, P,
          nbands, Lr - 1, Lc - 1, f, 0, (Lr - 1) * f, 0, naive);
  return cudaGetLastError();
}

// One instance per D = 1 .. 5 (the points in registers), and one for any D
// (kD = 0, the points read through __ldg a column). On an H100 80GB HBM3
// at 700 W, 128 pairs of length 1024, the register instances are faster:
// at D = 3 by 1.08-1.17x at dyadic 1 and 1.25-1.40x at dyadic 0 (K1 and
// K1-stack), at D = 5, dyadic 2 by 1.24x in float and 1.02x in double
// (sigkernel_tpu_torch/probes/k1_probe.py source).
template <typename T, bool kStack>
int launch_gen(const void* rows, const void* cols, const void* ri,
               const void* ci, void* out, void* stack, void* scratch,
               void* counters, int64_t P, int Lr, int Lc, int D, int f,
               double sigma, int nbands, int naive, int device,
               void* stream) {
  if (Lr < 2 || Lr > Lc || D < 1 || nbands != band_count((Lr - 1) * f) ||
      P * nbands >= (int64_t(1) << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  decltype(&launch_gen_band<T, kStack, 0>) launch =
      D == 1 ? &launch_gen_band<T, kStack, 1>
      : D == 2 ? &launch_gen_band<T, kStack, 2>
      : D == 3 ? &launch_gen_band<T, kStack, 3>
      : D == 4 ? &launch_gen_band<T, kStack, 4>
      : D == 5 ? &launch_gen_band<T, kStack, 5>
      : &launch_gen_band<T, kStack, 0>;
  return launch(rows, cols, ri, ci, out, stack, scratch, counters, P, Lr, Lc,
                D, f, sigma, nbands, naive,
                static_cast<cudaStream_t>(stream));
}

}  // namespace sigkernel

// rows/ri are the path side with the shorter refined length (the wrapper
// orients them); 2 <= Lr <= Lc. scratch: (P, nbands - 1, C + 1) values;
// counters: P * nbands + 1 zeroed ints; nbands = ceil((Lr - 1) f / 128).
extern "C" {

int sk_rbf_gen_wavefront_f32(const void* rows, const void* cols,
                             const void* ri, const void* ci, void* out,
                             void* scratch, void* counters, int64_t P,
                             int Lr, int Lc, int D, int f, double sigma,
                             int nbands, int naive, int device,
                             void* stream) {
  return sigkernel::launch_gen<float, false>(
      rows, cols, ri, ci, out, nullptr, scratch, counters, P, Lr, Lc, D, f,
      sigma, nbands, naive, device, stream);
}

int sk_rbf_gen_wavefront_f64(const void* rows, const void* cols,
                             const void* ri, const void* ci, void* out,
                             void* scratch, void* counters, int64_t P,
                             int Lr, int Lc, int D, int f, double sigma,
                             int nbands, int naive, int device,
                             void* stream) {
  return sigkernel::launch_gen<double, false>(
      rows, cols, ri, ci, out, nullptr, scratch, counters, P, Lr, Lc, D, f,
      sigma, nbands, naive, device, stream);
}

// stack: (P, R + C + 1, R + 1) with R = (Lr - 1) f, C = (Lc - 1) f
int sk_rbf_gen_stack_f32(const void* rows, const void* cols, const void* ri,
                         const void* ci, void* out, void* stack,
                         void* scratch, void* counters, int64_t P, int Lr,
                         int Lc, int D, int f, double sigma, int nbands,
                         int naive, int device, void* stream) {
  return sigkernel::launch_gen<float, true>(
      rows, cols, ri, ci, out, stack, scratch, counters, P, Lr, Lc, D, f,
      sigma, nbands, naive, device, stream);
}

int sk_rbf_gen_stack_f64(const void* rows, const void* cols, const void* ri,
                         const void* ci, void* out, void* stack,
                         void* scratch, void* counters, int64_t P, int Lr,
                         int Lc, int D, int f, double sigma, int nbands,
                         int naive, int device, void* stream) {
  return sigkernel::launch_gen<double, true>(
      rows, cols, ri, ci, out, stack, scratch, counters, P, Lr, Lc, D, f,
      sigma, nbands, naive, device, stream);
}

}  // extern "C"
