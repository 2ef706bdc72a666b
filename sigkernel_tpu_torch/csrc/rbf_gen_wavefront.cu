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
#include "wavefront.cuh"

namespace sigkernel {

__device__ __forceinline__ float sk_exp(float v) { return expf(v); }
__device__ __forceinline__ double sk_exp(double v) { return exp(v); }

template <typename T>
__global__ void rbf_gen_wavefront(const T* __restrict__ rows,
                                  const T* __restrict__ cols,
                                  const int64_t* __restrict__ ri,
                                  const int64_t* __restrict__ ci,
                                  T* __restrict__ out, int Lr, int Lc, int D,
                                  int f, T sigma, int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const T* x = rows + ri[pair] * static_cast<int64_t>(Lr) * D;
  const T* y = cols + ci[pair] * static_cast<int64_t>(Lc) * D;
  const T scale = T(1) / T(f * f);

  // G(a, b) = exp(-((|x_a|^2 + |y_b|^2) - 2 <x_a, y_b>) / sigma), the sums
  // over d in order: the op order of the plain version (and of the TPU
  // generation kernels), symmetric in x and y so the transposed solve
  // rounds exactly as the untransposed one
  auto G = [&](int a, int b) -> T {
    const T* xa = x + static_cast<int64_t>(a) * D;
    const T* yb = y + static_cast<int64_t>(b) * D;
    T dot = T(0), sx = T(0), sy = T(0);
    for (int d = 0; d < D; ++d) {
      dot = add(dot, mul(xa[d], yb[d]));
      sx = add(sx, mul(xa[d], xa[d]));
      sy = add(sy, mul(yb[d], yb[d]));
    }
    return sk_exp(-sub(add(sx, sy), mul(T(2), dot)) / sigma);
  };

  const T v = sweep<T>(ring, (Lr - 1) * f, (Lc - 1) * f, naive != 0,
                       [&](int r, int c) -> T {
    const int a = r / f, b = c / f;
    // (g11 + g00) - (g10 + g01), the TPU generation kernels' op order
    return mul(sub(add(G(a + 1, b + 1), G(a, b)),
                   add(G(a + 1, b), G(a, b + 1))),
               scale);
  });
  if (threadIdx.x == 0) out[pair] = v;
}

template <typename T>
int launch_gen(const void* rows, const void* cols, const void* ri,
               const void* ci, void* out, int64_t P, int Lr, int Lc, int D,
               int f, double sigma, int naive, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int R = (Lr - 1) * f;
  const size_t smem = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  e = allow_smem(rbf_gen_wavefront<T>, smem);
  if (e != cudaSuccess) return e;
  rbf_gen_wavefront<T><<<static_cast<unsigned>(P), threads_for(R), smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(cols),
      static_cast<const int64_t*>(ri), static_cast<const int64_t*>(ci),
      static_cast<T*>(out), Lr, Lc, D, f, static_cast<T>(sigma), naive);
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
  return sigkernel::launch_gen<float>(rows, cols, ri, ci, out, P, Lr, Lc, D,
                                      f, sigma, naive, device, stream);
}

int sk_rbf_gen_wavefront_f64(const void* rows, const void* cols,
                             const void* ri, const void* ci, void* out,
                             int64_t P, int Lr, int Lc, int D, int f,
                             double sigma, int naive, int device,
                             void* stream) {
  return sigkernel::launch_gen<double>(rows, cols, ri, ci, out, P, Lr, Lc, D,
                                       f, sigma, naive, device, stream);
}

}  // extern "C"
