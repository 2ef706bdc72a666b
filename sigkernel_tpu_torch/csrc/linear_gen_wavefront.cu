// K6: wavefront with Linear-kernel increments generated in-kernel.
//
// Replaces the TPU kernel
//   sigkernel_tpu/ops/pallas_fused.py::_fused_kernel
// (float there; here one template serves float and double, as for every
// other kernel of the port).
//
// The increment grid of the Linear kernel k(x, y) = scale^2 <x, y> is the
// rank-D product of the two paths' scaled increments: base cell (a, b)
// takes <dx_a, dy_b> with dx_a = scale x_{a+1} - scale x_a (scale applied
// to the points before the difference, as the TPU kernel's
// _refined_increments does), and a refined cell inside it takes that times
// the exact 1 / f^2. The wrapper hands the kernel the increments
// (A, Lx - 1, D) and (B, Ly - 1, D) and the pair index arrays, as K1 takes
// its paths: a Gram, the symmetric triangle and the lincomb chunks copy no
// path per pair, and no increment grid exists in device memory. At the
// north star (100 x 100 pairs, length 1024) the grid it replaces would be
// 84 GB in double.
//
// What bounds it on the H100: the sweep itself (the scheme and one barrier
// per anti-diagonal, as in K2); generation costs 2D loads from L1 and D
// multiply-adds per refined cell, no exp. The sweep is the shared one of
// wavefront.cuh; the wrapper orders the paths so the ring holds the
// shorter side (the dot product rounds alike both ways round).
#include "wavefront.cuh"

namespace sigkernel {

// One pair's generator: increments dx (Lx - 1, D), dy (Ly - 1, D).
template <typename T>
struct LinearGen {
  const T* dx;
  const T* dy;
  int D;
  T scale;  // 1 / f^2, exact

  // <dx_a, dy_b> summed over d in order, then the exact 1 / f^2: the op
  // order of the plain version (ops/cuda_lgen.py::pair_increments)
  __device__ __forceinline__ T inc(int a, int b) const {
    const T* xa = dx + static_cast<int64_t>(a) * D;
    const T* yb = dy + static_cast<int64_t>(b) * D;
    T dot = mul(xa[0], yb[0]);
    for (int d = 1; d < D; ++d) dot = add(dot, mul(xa[d], yb[d]));
    return mul(dot, scale);
  }
};

template <typename T>
__global__ void linear_gen_wavefront(const T* __restrict__ rows,
                                     const T* __restrict__ cols,
                                     const int64_t* __restrict__ ri,
                                     const int64_t* __restrict__ ci,
                                     T* __restrict__ out, int Lr, int Lc,
                                     int D, int f, int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const LinearGen<T> gen{rows + ri[pair] * static_cast<int64_t>(Lr) * D,
                         cols + ci[pair] * static_cast<int64_t>(Lc) * D, D,
                         T(1) / T(f * f)};
  const T v = sweep<T>(ring, Lr * f, Lc * f, naive != 0,
                       [&](int r, int c) -> T {
    return gen.inc(r / f, c / f);
  });
  if (threadIdx.x == 0) out[pair] = v;
}

template <typename T>
int launch_linear_gen(const void* rows, const void* cols, const void* ri,
                      const void* ci, void* out, int64_t P, int Lr, int Lc,
                      int D, int f, int naive, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int R = Lr * f;
  const size_t smem = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  e = allow_smem(linear_gen_wavefront<T>, smem);
  if (e != cudaSuccess) return e;
  linear_gen_wavefront<T><<<static_cast<unsigned>(P), threads_for(R), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(cols),
      static_cast<const int64_t*>(ri), static_cast<const int64_t*>(ci),
      static_cast<T*>(out), Lr, Lc, D, f, naive);
  return cudaGetLastError();
}

}  // namespace sigkernel

// rows/ri are the increments of the side with fewer of them (the wrapper
// orders them): Lr <= Lc increments of D >= 1 coordinates each.
extern "C" {

int sk_linear_gen_wavefront_f32(const void* rows, const void* cols,
                                const void* ri, const void* ci, void* out,
                                int64_t P, int Lr, int Lc, int D, int f,
                                int naive, int device, void* stream) {
  return sigkernel::launch_linear_gen<float>(rows, cols, ri, ci, out, P, Lr,
                                             Lc, D, f, naive, device, stream);
}

int sk_linear_gen_wavefront_f64(const void* rows, const void* cols,
                                const void* ri, const void* ci, void* out,
                                int64_t P, int Lr, int Lc, int D, int f,
                                int naive, int device, void* stream) {
  return sigkernel::launch_linear_gen<double>(rows, cols, ri, ci, out, P, Lr,
                                              Lc, D, f, naive, device,
                                              stream);
}

}  // extern "C"
