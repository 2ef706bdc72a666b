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
// What bounds it on the H100: FP32/FP64 arithmetic and exp per refined
// cell. This simple form generates the base increment of every refined
// cell from scratch, (G(a+1,b+1) + G(a,b)) - (G(a+1,b) + G(a,b+1)) with
// G(a,b) = exp(-|x_a - y_b|^2 / sigma): four exp and four D-long distances
// per refined cell, f^2 times more than the base grid needs. The design
// keeps the solution state in shared memory, reads path points through
// L1/L2, and solves the transposed problem (the wrapper swaps X and Y, the
// RBF kernel being symmetric) so the ring holds the shorter side. Caching
// generated G values is later work.
//
// K1-stack (kStack = true) also writes the solution stack the adjoint
// consumes (layout in wavefront.cuh), replacing the stack outputs of
//   sigkernel_tpu/ops/pallas_gen32.py::solve_final_f32_gen_stack
//   sigkernel_tpu/ops/pallas_df64.py::solve_final_df_gen_stack
// It adds one store per stack cell, written coalesced along a diagonal:
// 67 MB a pair in double at length 1024, dyadic 1, so the stack's bytes
// (8.6 GB for 128 pairs, against 3.35 TB/s) cost a few ms beside the
// sweep's arithmetic.
#include "rbf_gen.cuh"

namespace sigkernel {

template <typename T, bool kStack>
__global__ void rbf_gen_wavefront(const T* __restrict__ rows,
                                  const T* __restrict__ cols,
                                  const int64_t* __restrict__ ri,
                                  const int64_t* __restrict__ ci,
                                  T* __restrict__ out, T* __restrict__ stack,
                                  int Lr, int Lc, int D, int f, T sigma,
                                  int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const RbfGen<T> gen(rows + ri[pair] * static_cast<int64_t>(Lr) * D,
                      cols + ci[pair] * static_cast<int64_t>(Lc) * D, D, f,
                      sigma);
  const int R = (Lr - 1) * f, C = (Lc - 1) * f;
  T* pair_stack = kStack ? stack + pair * stack_elems(R, C) : nullptr;
  const T v = sweep<T, kStack>(ring, R, C, naive != 0,
                               [&](int r, int c) -> T {
    return gen.inc(r / f, c / f);
  }, pair_stack);
  if (threadIdx.x == 0) out[pair] = v;
}

template <typename T, bool kStack>
int launch_gen(const void* rows, const void* cols, const void* ri,
               const void* ci, void* out, void* stack, int64_t P, int Lr,
               int Lc, int D, int f, double sigma, int naive, int device,
               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int R = (Lr - 1) * f;
  const size_t smem = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  e = allow_smem(rbf_gen_wavefront<T, kStack>, smem);
  if (e != cudaSuccess) return e;
  rbf_gen_wavefront<T, kStack><<<static_cast<unsigned>(P), threads_for(R),
                                 smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(cols),
      static_cast<const int64_t*>(ri), static_cast<const int64_t*>(ci),
      static_cast<T*>(out), static_cast<T*>(stack), Lr, Lc, D, f,
      static_cast<T>(sigma), naive);
  return cudaGetLastError();
}

}  // namespace sigkernel

// rows/ri are the path side with the shorter refined length (the wrapper
// orders them); Lr <= Lc.
extern "C" {

int sk_rbf_gen_wavefront_f32(const void* rows, const void* cols,
                             const void* ri, const void* ci, void* out,
                             int64_t P, int Lr, int Lc, int D, int f,
                             double sigma, int naive, int device,
                             void* stream) {
  return sigkernel::launch_gen<float, false>(rows, cols, ri, ci, out, nullptr,
                                             P, Lr, Lc, D, f, sigma, naive,
                                             device, stream);
}

int sk_rbf_gen_wavefront_f64(const void* rows, const void* cols,
                             const void* ri, const void* ci, void* out,
                             int64_t P, int Lr, int Lc, int D, int f,
                             double sigma, int naive, int device,
                             void* stream) {
  return sigkernel::launch_gen<double, false>(rows, cols, ri, ci, out,
                                              nullptr, P, Lr, Lc, D, f, sigma,
                                              naive, device, stream);
}

// stack: (P, R + C + 1, R + 1) with R = (Lr - 1) f, C = (Lc - 1) f
int sk_rbf_gen_stack_f32(const void* rows, const void* cols, const void* ri,
                         const void* ci, void* out, void* stack, int64_t P,
                         int Lr, int Lc, int D, int f, double sigma,
                         int naive, int device, void* stream) {
  return sigkernel::launch_gen<float, true>(rows, cols, ri, ci, out, stack,
                                            P, Lr, Lc, D, f, sigma, naive,
                                            device, stream);
}

int sk_rbf_gen_stack_f64(const void* rows, const void* cols, const void* ri,
                         const void* ci, void* out, void* stack, int64_t P,
                         int Lr, int Lc, int D, int f, double sigma,
                         int naive, int device, void* stream) {
  return sigkernel::launch_gen<double, true>(rows, cols, ri, ci, out, stack,
                                             P, Lr, Lc, D, f, sigma, naive,
                                             device, stream);
}

}  // extern "C"
