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
#include "wavefront.cuh"

namespace sigkernel {

template <typename T>
__global__ void inc_wavefront(const T* __restrict__ inc, T* __restrict__ out,
                              int Mb, int Nb, int f, int transpose,
                              int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const T* g = inc + pair * static_cast<int64_t>(Mb) * Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  const T scale = T(1) / T(f * f);
  const T v = sweep<T>(ring, R, C, naive != 0, [&](int r, int c) -> T {
    const int a = (transpose ? c : r) / f;
    const int b = (transpose ? r : c) / f;
    return g[static_cast<int64_t>(a) * Nb + b] * scale;
  });
  if (threadIdx.x == 0) out[pair] = v;
}

template <typename T>
int launch_inc(const void* inc, void* out, int64_t P, int Mb, int Nb, int f,
               int naive, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const size_t smem = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  e = allow_smem(inc_wavefront<T>, smem);
  if (e != cudaSuccess) return e;
  inc_wavefront<T><<<static_cast<unsigned>(P), threads_for(R), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inc), static_cast<T*>(out), Mb, Nb, f, transpose,
      naive);
  return cudaGetLastError();
}

}  // namespace sigkernel

extern "C" {

int sk_inc_wavefront_f32(const void* inc, void* out, int64_t P, int Mb,
                         int Nb, int f, int naive, int device, void* stream) {
  return sigkernel::launch_inc<float>(inc, out, P, Mb, Nb, f, naive, device,
                                      stream);
}

int sk_inc_wavefront_f64(const void* inc, void* out, int64_t P, int Mb,
                         int Nb, int f, int naive, int device, void* stream) {
  return sigkernel::launch_inc<double>(inc, out, P, Mb, Nb, f, naive, device,
                                       stream);
}

const char* sk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
