// K7: one stripe of a refined grid too tall for one block, swept from a
// north boundary row; one thread block per pair.
//
// Replaces the TPU kernels
//   sigkernel_tpu/ops/pallas_blocked.py::_stripe_kernel       (bottom row)
//   sigkernel_tpu/ops/pallas_blocked.py::_stripe_kernel_df    (its df twin)
//   sigkernel_tpu/ops/pallas_blocked.py::_stripe_kernel_grid  (K7-stack)
//   sigkernel_tpu/ops/pallas_blocked.py::_stripe_kernel_grid_df
// The df (hi/lo f32) kernels existed for a chip without f64; here they are
// the double instance of one template.
//
// What it computes. K2's sweep (wavefront.cuh) over refined rows row0 ..
// row0 + rows - 1 of the pair's solve frame (rows: the shorter refined
// side, so a stripe spans all C columns), with row 0 taken from the north
// boundary bd (P, C + 1), the bottom row of the stripe above, and the
// stripe's own bottom row written to bottom (P, C + 1). The increments are
// the pair's base grid (P, Mb, Nb) read through StripeGrid: refined by an
// index shift and the exact 1 / f^2 as in K2, zero past the frame's rows
// (the striped adjoint pads the last stripe with zero rows, which copy rows
// exactly), and with flip reversed along both axes (the reverse problem's
// stripe, which the striped adjoint needs, read from the forward grid).
// Stripes of one pair run one launch after another on one stream: stripe s
// needs stripe s - 1's bottom row. Pairs give the parallelism.
//
// K7-stack also writes the stripe's stack (rows + C + 1, rows + 1) in
// K2-stack's layout, row 0 holding bd (wavefront.cuh), for the striped
// adjoint's product (adjoint_collapse.cu, the boundary instance).
//
// What bounds it on the H100: as K2, the per-diagonal barrier and the
// increment reads, rows + C diagonals a stripe; the stripe height is the
// largest multiple of f whose ring of three diagonals fits one block's
// shared memory (9,684 rows in double, 19,368 in float). The TPU kernel's
// lane-0 boundary packing, rolling output flush, sheared increment stream
// and DMA batching are not ported: the boundary is one coalesced read per
// diagonal and the bottom row one store per diagonal.
#include "wavefront.cuh"

namespace sigkernel {

template <typename T, bool kStack>
__global__ void stripe_wavefront(const T* __restrict__ inc,
                                 const T* __restrict__ bd,
                                 T* __restrict__ bottom,
                                 T* __restrict__ stack, int Mb, int Nb,
                                 int f, int row0, int rows, int flip,
                                 int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  const StripeGrid<T> grid{
      IncGrid<T>{inc + pair * static_cast<int64_t>(Mb) * Nb, Nb, f, transpose,
                 T(1) / T(f * f)},
      row0, rows, R, C, flip};
  T* pair_stack = kStack ? stack + pair * stack_elems(rows, C) : nullptr;
  sweep<T, kStack ? kFullStack : kNoStack, true>(
      ring, rows, C, naive != 0, grid, pair_stack, 0, bd + pair * (C + 1),
      bottom + pair * (C + 1));
}

template <typename T, bool kStack>
int launch_stripe(const void* inc, const void* bd, void* bottom, void* stack,
                  int64_t P, int Mb, int Nb, int f, int row0, int rows,
                  int flip, int naive, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = 3 * static_cast<size_t>(rows + 1) * sizeof(T);
  e = allow_smem(stripe_wavefront<T, kStack>, smem);
  if (e != cudaSuccess) return e;
  stripe_wavefront<T, kStack><<<static_cast<unsigned>(P), threads_for(rows),
                                smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inc), static_cast<const T*>(bd),
      static_cast<T*>(bottom), static_cast<T*>(stack), Mb, Nb, f, row0, rows,
      flip, naive);
  return cudaGetLastError();
}

}  // namespace sigkernel

extern "C" {

// inc: (P, Mb, Nb); bd, bottom: (P, C + 1) with C = max(Mb, Nb) f; the
// stripe is refined frame rows row0 .. row0 + rows - 1 (row0 a multiple of
// f); stack (K7-stack only): (P, rows + C + 1, rows + 1).
int sk_stripe_f32(const void* inc, const void* bd, void* bottom, int64_t P,
                  int Mb, int Nb, int f, int row0, int rows, int flip,
                  int naive, int device, void* stream) {
  return sigkernel::launch_stripe<float, false>(inc, bd, bottom, nullptr, P,
                                                Mb, Nb, f, row0, rows, flip,
                                                naive, device, stream);
}

int sk_stripe_f64(const void* inc, const void* bd, void* bottom, int64_t P,
                  int Mb, int Nb, int f, int row0, int rows, int flip,
                  int naive, int device, void* stream) {
  return sigkernel::launch_stripe<double, false>(inc, bd, bottom, nullptr, P,
                                                 Mb, Nb, f, row0, rows, flip,
                                                 naive, device, stream);
}

int sk_stripe_stack_f32(const void* inc, const void* bd, void* bottom,
                        void* stack, int64_t P, int Mb, int Nb, int f,
                        int row0, int rows, int flip, int naive, int device,
                        void* stream) {
  return sigkernel::launch_stripe<float, true>(inc, bd, bottom, stack, P, Mb,
                                               Nb, f, row0, rows, flip, naive,
                                               device, stream);
}

int sk_stripe_stack_f64(const void* inc, const void* bd, void* bottom,
                        void* stack, int64_t P, int Mb, int Nb, int f,
                        int row0, int rows, int flip, int naive, int device,
                        void* stream) {
  return sigkernel::launch_stripe<double, true>(inc, bd, bottom, stack, P,
                                                Mb, Nb, f, row0, rows, flip,
                                                naive, device, stream);
}

}  // extern "C"
