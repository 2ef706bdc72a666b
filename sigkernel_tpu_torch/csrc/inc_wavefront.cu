// K2: wavefront over a precomputed base increment grid, refined in-kernel.
//
// Replaces the value path of the TPU kernels
//   sigkernel_tpu/ops/pallas_solver.py::_wavefront_kernel
//   sigkernel_tpu/ops/pallas_solver.py::_wavefront_f32_planes_kernel
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_kernel
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_planes_kernel
// The DF (hi/lo f32) kernels existed for a chip without f64; here they are
// the double instance of one template.
//
// What bounds it on the H100: reading the base increment grid from device
// memory (P * Mb * Nb values, each read f^2 times from L1/L2 by the refined
// cells it covers) and one barrier per anti-diagonal. The design keeps the
// grid at base resolution (refinement is an index shift and an exact 1/f^2
// scale in the kernel, so the f^2-times larger refined grid never exists),
// keeps the whole solution state in shared memory, and solves the
// transposed problem when the rows are longer than the columns so the ring
// holds the shorter side.
//
// K2-stack (kStack = true) also writes the solution stack the adjoint
// consumes (layout in wavefront.cuh), replacing the grid/stack outputs of
//   sigkernel_tpu/ops/pallas_solver.py::_wavefront_kernel (solve_grid)
//   sigkernel_tpu/ops/pallas_solver.py::_wavefront_f32_planes_kernel
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_kernel (solve_grid)
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_planes_kernel
// The stack's stores are coalesced along each diagonal; they, not the
// increment reads, are the larger share of its device-memory bytes.
//
// K2-sparse (kStack = kSparseStack) writes only the sparse stack, two of
// every W diagonals (layout in wavefront.cuh): the forward of the
// sparse-checkpoint adjoint (adjoint_ckpt.cu), replacing the ckpt output of
//   sigkernel_tpu/ops/pallas_df64.py::_wavefront_df_kernel (ckpt=True)
// Its stack bytes, the larger share of K2-stack's traffic, shrink W / 2
// fold; the sweep is K2's.
#include "wavefront.cuh"

namespace sigkernel {

template <typename T, int kStack>
__global__ void inc_wavefront(const T* __restrict__ inc, T* __restrict__ out,
                              T* __restrict__ stack, int Mb, int Nb, int f,
                              int W, int transpose, int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const IncGrid<T> grid{inc + pair * static_cast<int64_t>(Mb) * Nb, Nb, f,
                        transpose, T(1) / T(f * f)};
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  T* pair_stack = nullptr;
  if constexpr (kStack == kFullStack) {
    pair_stack = stack + pair * stack_elems(R, C);
  } else if constexpr (kStack == kSparseStack) {
    pair_stack = stack + pair * sparse_elems(R, C, W);
  }
  const T v = sweep<T, kStack>(ring, R, C, naive != 0, grid, pair_stack, W);
  if (threadIdx.x == 0) out[pair] = v;
}

template <typename T, int kStack>
int launch_inc(const void* inc, void* out, void* stack, int64_t P, int Mb,
               int Nb, int f, int W, int naive, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const size_t smem = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  e = allow_smem(inc_wavefront<T, kStack>, smem);
  if (e != cudaSuccess) return e;
  inc_wavefront<T, kStack><<<static_cast<unsigned>(P), threads_for(R), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inc), static_cast<T*>(out),
      static_cast<T*>(stack), Mb, Nb, f, W, transpose, naive);
  return cudaGetLastError();
}

}  // namespace sigkernel

extern "C" {

int sk_inc_wavefront_f32(const void* inc, void* out, int64_t P, int Mb,
                         int Nb, int f, int naive, int device, void* stream) {
  return sigkernel::launch_inc<float, sigkernel::kNoStack>(
      inc, out, nullptr, P, Mb, Nb, f, 0, naive, device, stream);
}

int sk_inc_wavefront_f64(const void* inc, void* out, int64_t P, int Mb,
                         int Nb, int f, int naive, int device, void* stream) {
  return sigkernel::launch_inc<double, sigkernel::kNoStack>(
      inc, out, nullptr, P, Mb, Nb, f, 0, naive, device, stream);
}

// stack: (P, R + C + 1, R + 1) with R = min(Mb, Nb) f, C = max(Mb, Nb) f
int sk_inc_stack_f32(const void* inc, void* out, void* stack, int64_t P,
                     int Mb, int Nb, int f, int naive, int device,
                     void* stream) {
  return sigkernel::launch_inc<float, sigkernel::kFullStack>(
      inc, out, stack, P, Mb, Nb, f, 0, naive, device, stream);
}

int sk_inc_stack_f64(const void* inc, void* out, void* stack, int64_t P,
                     int Mb, int Nb, int f, int naive, int device,
                     void* stream) {
  return sigkernel::launch_inc<double, sigkernel::kFullStack>(
      inc, out, stack, P, Mb, Nb, f, 0, naive, device, stream);
}

// sparse: (P, 2 ckpt_pairs(R, C, W), R + 1), W >= 2
int sk_inc_sparse_f32(const void* inc, void* out, void* sparse, int64_t P,
                      int Mb, int Nb, int f, int W, int naive, int device,
                      void* stream) {
  return sigkernel::launch_inc<float, sigkernel::kSparseStack>(
      inc, out, sparse, P, Mb, Nb, f, W, naive, device, stream);
}

int sk_inc_sparse_f64(const void* inc, void* out, void* sparse, int64_t P,
                      int Mb, int Nb, int f, int W, int naive, int device,
                      void* stream) {
  return sigkernel::launch_inc<double, sigkernel::kSparseStack>(
      inc, out, sparse, P, Mb, Nb, f, W, naive, device, stream);
}

const char* sk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
