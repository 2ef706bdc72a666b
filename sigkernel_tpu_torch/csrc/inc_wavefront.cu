// K2: wavefront over a precomputed base increment grid, refined in-kernel.
//
// Replaces the value path of the TPU kernels
//   sigkernel_tpu/ops/pallas_solver.py::_wavefront_kernel
//   sigkernel_tpu/ops/pallas_solver.py::_wavefront_f32_planes_kernel
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_kernel
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_planes_kernel
// The DF (hi/lo f32) kernels existed for a chip without f64; here they are
// the double instance of one template. K2-stack also writes the solution
// stack the adjoint consumes (layout in wavefront.cuh), replacing the
// grid/stack outputs of the same four kernels; K2-sparse writes the sparse
// stack, two of every W diagonals (layout in wavefront.cuh), the forward of
// the sparse-checkpoint adjoint (adjoint_ckpt.cu), replacing the ckpt
// output of
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_kernel (ckpt=True)
//
// All three compute the corner K[R, C] of each pair's Goursat solve over a
// base grid (P, Mb, Nb) refined by f: the grid stays at base resolution,
// refinement being an index shift and an exact 1 / f^2 in the kernel, in
// the solve's frame (transposed when Mb > Nb, so R is the shorter side).
//
// What bounds each on the H100. K2: the grid's bytes (P Mb Nb values, 0.16
// / 0.32 ms for 128 pairs of length 1024 in float / double), read once by
// the f lanes of each base row. K2-stack: the stack's, (R + C + 1) (R + 1)
// values a pair (4.3 GB / 8.6 GB at that shape). K2-sparse: the sparse
// stack's, about W / 2 times fewer. The earlier design ran one block a pair
// with a ring of three diagonals in shared memory and a barrier on each of
// the R + C diagonals: 128 blocks for 132 SMs at that shape, 24-47x K2's
// bound, and a bound on R (the ring). Here each instance is the
// band-pipelined wavefront of band_sweep.cuh over the pair's whole frame
// from 1s (ceil(R / 128) blocks a pair, a lane a row, the sweep in
// registers, no barrier a diagonal, and no row bound, since nothing of the
// frame sits in shared memory) with IncSource, which reads a lane's base
// row kIncAhead base columns ahead of its use and scales each value where
// it is used, so that no load is waited on where it starts. K2 writes the
// corner (kBandBottom); K2-stack the stack too, its stores on one diagonal
// at a step and so neighbouring (kBandStack); K2-sparse only the stack's
// stored diagonals, which a warp knows at each step without a branch per
// lane (kBandSparse). The wrapper (ops/cuda_solver.py) splits the pairs so
// that the bands' hand-off scratch stays within its bound. On an H100 80GB
// HBM3 at 700 W the three ran at 11-21x, 3-4x and 4-8x their bounds at that
// shape (float and double): the grid read is 13-21 % of K2's time in
// float and hidden in double, the scheme 21-24 %, the band pipeline's own
// step (its shuffles, hand-off polls and loop) the rest
// (sigkernel_tpu_torch/probes/k2_probe.py).
#include "band_sweep.cuh"

namespace sigkernel {

template <typename T, int kMode>
int launch_inc(const void* inc, void* out, void* stack, void* scratch,
               void* counters, int64_t P, int Mb, int Nb, int f, int W,
               int nbands, int naive, int device, void* stream) {
  const int R = (Mb > Nb ? Nb : Mb) * f;
  if (Mb < 1 || Nb < 1 || nbands != band_count(R) ||
      (kMode == kBandSparse && W < 2) || P * nbands >= (int64_t(1) << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  IncSource<T> src{};
  src.inc = static_cast<const T*>(inc);
  src.W = W;
  band_stripe<T, kMode, 1, IncSource<T>>
      <<<static_cast<unsigned>(P * nbands), kBandRows, 0,
         static_cast<cudaStream_t>(stream)>>>(
          src, nullptr, static_cast<T*>(out), static_cast<T*>(stack),
          static_cast<T*>(scratch), static_cast<int*>(counters), nullptr, P,
          nbands, Mb, Nb, f, 0, R, 0, naive);
  return cudaGetLastError();
}

}  // namespace sigkernel

// inc: (P, Mb, Nb), Mb, Nb >= 1; out: (P,), the corners; scratch: (P,
// nbands - 1, C + 1) values and counters: P * nbands + 1 zeroed ints, with
// R = min(Mb, Nb) f, C = max(Mb, Nb) f and nbands = ceil(R / 128).
extern "C" {

int sk_inc_wavefront_f32(const void* inc, void* out, void* scratch,
                         void* counters, int64_t P, int Mb, int Nb, int f,
                         int nbands, int naive, int device, void* stream) {
  return sigkernel::launch_inc<float, sigkernel::kBandBottom>(
      inc, out, nullptr, scratch, counters, P, Mb, Nb, f, 0, nbands, naive,
      device, stream);
}

int sk_inc_wavefront_f64(const void* inc, void* out, void* scratch,
                         void* counters, int64_t P, int Mb, int Nb, int f,
                         int nbands, int naive, int device, void* stream) {
  return sigkernel::launch_inc<double, sigkernel::kBandBottom>(
      inc, out, nullptr, scratch, counters, P, Mb, Nb, f, 0, nbands, naive,
      device, stream);
}

// stack: (P, R + C + 1, R + 1)
int sk_inc_stack_f32(const void* inc, void* out, void* stack, void* scratch,
                     void* counters, int64_t P, int Mb, int Nb, int f,
                     int nbands, int naive, int device, void* stream) {
  return sigkernel::launch_inc<float, sigkernel::kBandStack>(
      inc, out, stack, scratch, counters, P, Mb, Nb, f, 0, nbands, naive,
      device, stream);
}

int sk_inc_stack_f64(const void* inc, void* out, void* stack, void* scratch,
                     void* counters, int64_t P, int Mb, int Nb, int f,
                     int nbands, int naive, int device, void* stream) {
  return sigkernel::launch_inc<double, sigkernel::kBandStack>(
      inc, out, stack, scratch, counters, P, Mb, Nb, f, 0, nbands, naive,
      device, stream);
}

// sparse: (P, 2 ckpt_pairs(R, C, W), R + 1), W >= 2
int sk_inc_sparse_f32(const void* inc, void* out, void* sparse,
                      void* scratch, void* counters, int64_t P, int Mb,
                      int Nb, int f, int W, int nbands, int naive, int device,
                      void* stream) {
  return sigkernel::launch_inc<float, sigkernel::kBandSparse>(
      inc, out, sparse, scratch, counters, P, Mb, Nb, f, W, nbands, naive,
      device, stream);
}

int sk_inc_sparse_f64(const void* inc, void* out, void* sparse,
                      void* scratch, void* counters, int64_t P, int Mb,
                      int Nb, int f, int W, int nbands, int naive, int device,
                      void* stream) {
  return sigkernel::launch_inc<double, sigkernel::kBandSparse>(
      inc, out, sparse, scratch, counters, P, Mb, Nb, f, W, nbands, naive,
      device, stream);
}

const char* sk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
