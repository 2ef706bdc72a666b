// K3: the adjoint PDE sweep with the product and the dyadic collapse done
// in flight: one thread block per pair for K3<inc>, and for K3<gen> and
// K3<inc, boundary> past f = 32; the band-pipelined wavefront of
// band_sweep.cuh for K3<gen> and K3<inc, boundary> to f = 32.
//
// Replaces the TPU kernels
//   sigkernel_tpu/ops/pallas_adjoint.py::_product_kernel
//   sigkernel_tpu/ops/pallas_adjoint.py::_product_collapse_kernel
//   sigkernel_tpu/ops/pallas_adjoint.py::_product_collapse_planes_kernel
//     (source "inc": the base increment grid; float and double)
//   sigkernel_tpu/ops/pallas_adjoint.py::_product_collapse_planes_gen_kernel
//   sigkernel_tpu/ops/pallas_adjoint.py::_product_collapse_planes_gen_df_kernel
//   sigkernel_tpu/ops/pallas_adjoint.py::_product_collapse_planes_gen32_kernel
//     (source "gen": increments regenerated from the paths; float for the
//     f32 grades, double for the f64 grade the DF kernel emulated)
//
// What it computes, and the index algebra: adjoint.cuh.
//
// K3<inc, boundary> is the same product and collapse on one stripe of a
// grid too tall for one block: the reverse sweep of the reverse problem's
// stripe t = S - 1 - s from its north boundary bd_r[t] (its row 0), times
// forward stripe s's stack (K7-stack), collapsed into stripe s's base rows.
// It replaces the product and collapse that sigkernel_tpu/ops/
// pallas_blocked.py::adjoint_blocked and adjoint_blocked_df run in XLA on
// two materialised stripe grids; here the product grid never exists in
// device memory.
//
// What bounds it on the H100. One block a pair (adjoint_collapse_stripe,
// the earlier design) filled 16 of 132 SMs for phase 11's 16-pair chunks
// and took a barrier on each of the stripe's rows + C - 1 reverse
// diagonals: ~86x its bound, which is the stack's bytes (read once). So for
// f <= 32 it is the band-pipelined wavefront of band_sweep.cuh in its
// kBandAdjoint mode: ceil(rows / 128) blocks a pair, the sweep in registers,
// no barrier a diagonal, the stack staged in shared memory a chunk of
// steps ahead by cp.async, and each base cell summed in registers across
// its f lanes by shuffles and added into ct once (not once per refined
// cell). What is left is K7's: the per-step arithmetic and shuffles (f more
// a step for the collapse), the latency of the increment reads, and the
// pipeline's fill. At f > 32 a base row spans warps and the in-order
// collapse cannot run in flight: the wrapper routes such stripes to the
// one-block kernel, within the row bound its ring of three diagonals in
// shared memory sets.
//
// K3<gen> the same way. One block a pair (adjoint_collapse_gen, the earlier
// design) ran 128 blocks for 132 SMs at the timed shape, a barrier on each
// of its R + C - 1 reverse diagonals, regenerated four G values (four exp)
// for every refined cell and added every refined term into ct in global
// memory: 14x its bound, the stack's bytes read once. So for f <= 32 it is
// kBandAdjoint over the pair's whole frame (row0 0, rows R, from 1s, no
// boundary) with rbf_gen.cuh's RbfSource as its source, the columns walked
// from the last to the first (flip): each lane generates its base row's
// increments once a base column from two cached G values, on the
// warp-uniform steps, and nothing of the frame sits in shared memory, so
// no row bound applies. ct is in the pairs' own frame: the launcher passes
// band_stripe that frame (Mb = Lx - 1, Nb = Ly - 1), so that its transpose
// (Mb > Nb) is the wrapper's. Past f = 32 the one-block kernel stays,
// within the row bound.
#include "adjoint.cuh"
#include "band_sweep.cuh"
#include "rbf_gen.cuh"

namespace sigkernel {

template <typename T>
__global__ void adjoint_collapse_gen(const T* __restrict__ rows,
                                     const T* __restrict__ cols,
                                     const int64_t* __restrict__ ri,
                                     const int64_t* __restrict__ ci,
                                     const T* __restrict__ stack,
                                     T* __restrict__ ct, int Lr, int Lc,
                                     int D, int f, T sigma, int transpose,
                                     int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const RbfGen<T> gen(rows + ri[pair] * static_cast<int64_t>(Lr) * D,
                      cols + ci[pair] * static_cast<int64_t>(Lc) * D, D, f,
                      sigma);
  const int R = (Lr - 1) * f, C = (Lc - 1) * f;
  adjoint_body<T>(ring, R, C, f, naive != 0,
                  [&](int r, int c) -> T { return gen.inc(r / f, c / f); },
                  StackRows<T>{stack + pair * stack_elems(R, C), R + 1},
                  ct + pair * static_cast<int64_t>(Lr - 1) * (Lc - 1),
                  transpose, 0, Lr - 1);
}

template <typename T>
__global__ void adjoint_collapse_inc(const T* __restrict__ inc,
                                     const T* __restrict__ stack,
                                     T* __restrict__ ct, int Mb, int Nb,
                                     int f, int transpose, int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const int64_t cells = static_cast<int64_t>(Mb) * Nb;
  const IncGrid<T> grid{inc + pair * cells, Nb, f, transpose,
                        T(1) / T(f * f)};
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  adjoint_body<T>(ring, R, C, f, naive != 0, grid,
                  StackRows<T>{stack + pair * stack_elems(R, C), R + 1},
                  ct + pair * cells, transpose, 0, R / f);
}

// K3<inc, boundary> on one block a pair (f > 32): forward stripe s = rows row0 .. row0 + rows - 1 of the
// frame (its K7-stack in `stack`), the reverse problem's stripe from its
// north boundary bd (P, C + 1), accumulated into ct's base rows of the
// stripe.
template <typename T>
__global__ void adjoint_collapse_stripe(const T* __restrict__ inc,
                                        const T* __restrict__ stack,
                                        const T* __restrict__ bd,
                                        T* __restrict__ ct, int Mb, int Nb,
                                        int f, int row0, int rows,
                                        int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const int64_t cells = static_cast<int64_t>(Mb) * Nb;
  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  const StripeGrid<T> grid{
      IncGrid<T>{inc + pair * cells, Nb, f, transpose, T(1) / T(f * f)},
      row0, rows, R, C, 0};
  adjoint_body<T, true>(ring, rows, C, f, naive != 0, grid,
                        StackRows<T>{stack + pair * stack_elems(rows, C),
                                     rows + 1},
                        ct + pair * cells, transpose, row0 / f, R / f,
                        bd + pair * (C + 1));
}

template <typename T>
int launch_adjoint_gen(const void* rows, const void* cols, const void* ri,
                       const void* ci, const void* stack, void* ct,
                       int64_t P, int Lr, int Lc, int D, int f, double sigma,
                       int transpose, int naive, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int R = (Lr - 1) * f;
  const size_t smem = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  e = allow_smem(adjoint_collapse_gen<T>, smem);
  if (e != cudaSuccess) return e;
  adjoint_collapse_gen<T><<<static_cast<unsigned>(P), threads_for(R), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rows), static_cast<const T*>(cols),
      static_cast<const int64_t*>(ri), static_cast<const int64_t*>(ci),
      static_cast<const T*>(stack), static_cast<T*>(ct), Lr, Lc, D, f,
      static_cast<T>(sigma), transpose, naive);
  return cudaGetLastError();
}

template <typename T>
int launch_adjoint_inc(const void* inc, const void* stack, void* ct,
                       int64_t P, int Mb, int Nb, int f, int naive,
                       int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const size_t smem = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  e = allow_smem(adjoint_collapse_inc<T>, smem);
  if (e != cudaSuccess) return e;
  adjoint_collapse_inc<T><<<static_cast<unsigned>(P), threads_for(R), smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inc), static_cast<const T*>(stack),
      static_cast<T*>(ct), Mb, Nb, f, transpose, naive);
  return cudaGetLastError();
}

template <typename T>
int launch_adjoint_stripe(const void* inc, const void* stack, const void* bd,
                          void* ct, int64_t P, int Mb, int Nb, int f,
                          int row0, int rows, int naive, int device,
                          void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = 3 * static_cast<size_t>(rows + 1) * sizeof(T);
  e = allow_smem(adjoint_collapse_stripe<T>, smem);
  if (e != cudaSuccess) return e;
  adjoint_collapse_stripe<T><<<static_cast<unsigned>(P), threads_for(rows),
                               smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inc), static_cast<const T*>(stack),
      static_cast<const T*>(bd), static_cast<T*>(ct), Mb, Nb, f, row0, rows,
      naive);
  return cudaGetLastError();
}

template <typename T, int kF>
cudaError_t launch_band(const void* inc, const void* stack, const void* bd,
                        void* ct, void* scratch, void* counters, int64_t P,
                        int Mb, int Nb, int row0, int rows, int nbands,
                        int naive, void* stream) {
  const size_t smem = band_stage_bytes<T, GridSource<T>>();
  cudaError_t e = allow_smem(band_stripe<T, kBandAdjoint, kF>, smem);
  if (e != cudaSuccess) return e;
  band_stripe<T, kBandAdjoint, kF><<<static_cast<unsigned>(P * nbands),
                                     kBandRows, smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      GridSource<T>{static_cast<const T*>(inc)}, static_cast<const T*>(bd),
      nullptr, const_cast<T*>(static_cast<const T*>(stack)),
      static_cast<T*>(scratch),
      static_cast<int*>(counters), static_cast<T*>(ct), P, nbands, Mb, Nb, kF,
      row0, rows, 1, naive);
  return cudaGetLastError();
}

// K3<inc, boundary> on the band kernel, one instance per f = 1 .. 32 (the
// collapse unrolls over a group's f lanes); f > 32 is refused.
template <typename T>
int launch_adjoint_band(const void* inc, const void* stack, const void* bd,
                        void* ct, void* scratch, void* counters, int64_t P,
                        int Mb, int Nb, int f, int row0, int rows, int nbands,
                        int naive, int device, void* stream) {
  if (nbands != band_count(rows) || P * nbands >= (int64_t(1) << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  decltype(&launch_band<T, 1>) launch =
      f == 1 ? &launch_band<T, 1> : f == 2 ? &launch_band<T, 2>
      : f == 4 ? &launch_band<T, 4> : f == 8 ? &launch_band<T, 8>
      : f == 16 ? &launch_band<T, 16> : f == 32 ? &launch_band<T, 32>
      : nullptr;
  if (launch == nullptr) return cudaErrorInvalidValue;
  return launch(inc, stack, bd, ct, scratch, counters, P, Mb, Nb, row0, rows,
                nbands, naive, stream);
}

// K3<gen> on the band kernel: the reverse sweep of each pair's whole frame
// with RbfSource walking the columns backward, times K1-stack's stack.
template <typename T, int kF, int kD>
cudaError_t launch_gen_adjoint_band(const void* rows, const void* cols,
                                    const void* ri, const void* ci, void* ct,
                                    const void* stack, void* scratch,
                                    void* counters, int64_t P, int Lr,
                                    int Lc, int D, double sigma, int nbands,
                                    int transpose, int naive,
                                    cudaStream_t stream) {
  using Src = RbfSource<T, kD>;
  const Src src{static_cast<const T*>(rows), static_cast<const T*>(cols),
                static_cast<const int64_t*>(ri),
                static_cast<const int64_t*>(ci), Lr, Lc, D,
                static_cast<T>(sigma)};
  const size_t smem = band_stage_bytes<T, Src>();
  cudaError_t e = allow_smem(band_stripe<T, kBandAdjoint, kF, Src>, smem);
  if (e != cudaSuccess) return e;
  // the pairs' own base frame (Lx - 1, Ly - 1)
  const int Mb = transpose ? Lc - 1 : Lr - 1;
  const int Nb = transpose ? Lr - 1 : Lc - 1;
  band_stripe<T, kBandAdjoint, kF, Src>
      <<<static_cast<unsigned>(P * nbands), kBandRows, smem, stream>>>(
          src, nullptr, nullptr,
          const_cast<T*>(static_cast<const T*>(stack)),
          static_cast<T*>(scratch), static_cast<int*>(counters),
          static_cast<T*>(ct), P, nbands, Mb, Nb, kF, 0, (Lr - 1) * kF, 1,
          naive);
  return cudaGetLastError();
}

// The instance for dim D: the points in registers for D = 1 .. 5, read
// through __ldg for any other D (kD = 0), as K1's dispatch.
template <typename T, int kF>
decltype(&launch_gen_adjoint_band<T, kF, 0>) gen_adjoint_for(int D) {
  return D == 1 ? &launch_gen_adjoint_band<T, kF, 1>
       : D == 2 ? &launch_gen_adjoint_band<T, kF, 2>
       : D == 3 ? &launch_gen_adjoint_band<T, kF, 3>
       : D == 4 ? &launch_gen_adjoint_band<T, kF, 4>
       : D == 5 ? &launch_gen_adjoint_band<T, kF, 5>
       : &launch_gen_adjoint_band<T, kF, 0>;
}

// K3<gen> for f = 1 .. 32, one instance per (f, D): the collapse unrolls
// over a group's f lanes; f > 32 is refused.
template <typename T>
int launch_adjoint_gen_band(const void* rows, const void* cols,
                            const void* ri, const void* ci, void* ct,
                            const void* stack, void* scratch, void* counters,
                            int64_t P, int Lr, int Lc, int D, int f,
                            double sigma, int nbands, int transpose,
                            int naive, int device, void* stream) {
  if (Lr < 2 || Lr > Lc || D < 1 || nbands != band_count((Lr - 1) * f) ||
      P * nbands >= (int64_t(1) << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  decltype(&launch_gen_adjoint_band<T, 1, 0>) launch =
      f == 1 ? gen_adjoint_for<T, 1>(D) : f == 2 ? gen_adjoint_for<T, 2>(D)
      : f == 4 ? gen_adjoint_for<T, 4>(D) : f == 8 ? gen_adjoint_for<T, 8>(D)
      : f == 16 ? gen_adjoint_for<T, 16>(D)
      : f == 32 ? gen_adjoint_for<T, 32>(D) : nullptr;
  if (launch == nullptr) return cudaErrorInvalidValue;
  return launch(rows, cols, ri, ci, ct, stack, scratch, counters, P, Lr, Lc,
                D, sigma, nbands, transpose, naive,
                static_cast<cudaStream_t>(stream));
}

}  // namespace sigkernel

extern "C" {

// rows/ri: the path side with the shorter refined length (Lr <= Lc);
// transpose: 1 when rows are the pairs' second (Y) side. ct: (P, Lx-1,
// Ly-1) in the pairs' own (X, Y) frame, zeroed. The one-block kernel, for
// f > 32.
int sk_adjoint_gen_f32(const void* rows, const void* cols, const void* ri,
                       const void* ci, const void* stack, void* ct,
                       int64_t P, int Lr, int Lc, int D, int f, double sigma,
                       int transpose, int naive, int device, void* stream) {
  return sigkernel::launch_adjoint_gen<float>(rows, cols, ri, ci, stack, ct,
                                              P, Lr, Lc, D, f, sigma,
                                              transpose, naive, device,
                                              stream);
}

int sk_adjoint_gen_f64(const void* rows, const void* cols, const void* ri,
                       const void* ci, const void* stack, void* ct,
                       int64_t P, int Lr, int Lc, int D, int f, double sigma,
                       int transpose, int naive, int device, void* stream) {
  return sigkernel::launch_adjoint_gen<double>(rows, cols, ri, ci, stack, ct,
                                               P, Lr, Lc, D, f, sigma,
                                               transpose, naive, device,
                                               stream);
}

// K3<gen> on the band-pipelined wavefront (f <= 32): rows, cols, ri, ci,
// ct and transpose as above; stack: (P, R + C + 1, R + 1), K1-stack's;
// scratch: (P, nbands - 1, C + 1) values and counters: P * nbands + 1
// zeroed ints, nbands = ceil((Lr - 1) f / 128), as K1's. Adds each base
// cell's unscaled sum into ct.
int sk_adjoint_gen_band_f32(const void* rows, const void* cols,
                            const void* ri, const void* ci, void* ct,
                            const void* stack, void* scratch, void* counters,
                            int64_t P, int Lr, int Lc, int D, int f,
                            double sigma, int nbands, int transpose,
                            int naive, int device, void* stream) {
  return sigkernel::launch_adjoint_gen_band<float>(
      rows, cols, ri, ci, ct, stack, scratch, counters, P, Lr, Lc, D, f,
      sigma, nbands, transpose, naive, device, stream);
}

int sk_adjoint_gen_band_f64(const void* rows, const void* cols,
                            const void* ri, const void* ci, void* ct,
                            const void* stack, void* scratch, void* counters,
                            int64_t P, int Lr, int Lc, int D, int f,
                            double sigma, int nbands, int transpose,
                            int naive, int device, void* stream) {
  return sigkernel::launch_adjoint_gen_band<double>(
      rows, cols, ri, ci, ct, stack, scratch, counters, P, Lr, Lc, D, f,
      sigma, nbands, transpose, naive, device, stream);
}

// inc: (P, Mb, Nb); ct: (P, Mb, Nb), zeroed.
int sk_adjoint_inc_f32(const void* inc, const void* stack, void* ct,
                       int64_t P, int Mb, int Nb, int f, int naive,
                       int device, void* stream) {
  return sigkernel::launch_adjoint_inc<float>(inc, stack, ct, P, Mb, Nb, f,
                                              naive, device, stream);
}

int sk_adjoint_inc_f64(const void* inc, const void* stack, void* ct,
                       int64_t P, int Mb, int Nb, int f, int naive,
                       int device, void* stream) {
  return sigkernel::launch_adjoint_inc<double>(inc, stack, ct, P, Mb, Nb, f,
                                               naive, device, stream);
}

// inc: (P, Mb, Nb); stack: (P, rows + C + 1, rows + 1), forward stripe
// rows row0 .. row0 + rows - 1 (K7-stack); bd: (P, C + 1), the reverse
// problem's boundary above the matching stripe; ct: (P, Mb, Nb), zeroed
// once for all stripes (each writes only its own base rows). The one-block
// kernel, for f > 32.
int sk_adjoint_stripe_f32(const void* inc, const void* stack, const void* bd,
                          void* ct, int64_t P, int Mb, int Nb, int f,
                          int row0, int rows, int naive, int device,
                          void* stream) {
  return sigkernel::launch_adjoint_stripe<float>(inc, stack, bd, ct, P, Mb,
                                                 Nb, f, row0, rows, naive,
                                                 device, stream);
}

int sk_adjoint_stripe_f64(const void* inc, const void* stack, const void* bd,
                          void* ct, int64_t P, int Mb, int Nb, int f,
                          int row0, int rows, int naive, int device,
                          void* stream) {
  return sigkernel::launch_adjoint_stripe<double>(inc, stack, bd, ct, P, Mb,
                                                  Nb, f, row0, rows, naive,
                                                  device, stream);
}

// K3<inc, boundary> on the band-pipelined wavefront (f <= 32): the
// arguments above, plus scratch: (P, nbands - 1, C + 1) values and
// counters: P * nbands + 1 zeroed ints, nbands = ceil(rows / 128), as K7's.
// Adds each base cell's sum into ct.
int sk_adjoint_band_f32(const void* inc, const void* stack, const void* bd,
                        void* ct, void* scratch, void* counters, int64_t P,
                        int Mb, int Nb, int f, int row0, int rows, int nbands,
                        int naive, int device, void* stream) {
  return sigkernel::launch_adjoint_band<float>(inc, stack, bd, ct, scratch,
                                               counters, P, Mb, Nb, f, row0,
                                               rows, nbands, naive, device,
                                               stream);
}

int sk_adjoint_band_f64(const void* inc, const void* stack, const void* bd,
                        void* ct, void* scratch, void* counters, int64_t P,
                        int Mb, int Nb, int f, int row0, int rows, int nbands,
                        int naive, int device, void* stream) {
  return sigkernel::launch_adjoint_band<double>(inc, stack, bd, ct, scratch,
                                                counters, P, Mb, Nb, f, row0,
                                                rows, nbands, naive, device,
                                                stream);
}

}  // extern "C"
