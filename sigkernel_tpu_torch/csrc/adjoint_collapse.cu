// K3: the adjoint PDE sweep with the product and the dyadic collapse done
// in flight, one thread block per pair.
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
// What it computes. The gradient of the corner K[R, C] with respect to the
// refined increment of cell (i + 1, j + 1) is K[i, j] * K_rev[R-1-i, C-1-j],
// where K_rev solves the same PDE on the increments flipped along both axes
// (variation of parameters; sigkernel_tpu/ops/solve.py:235-248). The base
// cotangent of base cell (a, b) is the sum of that product over the f x f
// refined cells of the base cell, times 1 / f^2 (the VJP of the dyadic
// refinement). This kernel writes the block SUMS; the wrapper applies the
// exact 1 / f^2 and the caller the upstream cotangent g (outside, in the
// backward's dtype, as the f64-grade JAX route does), so one launch serves
// every weighting.
//
// Index algebra, in the solve's frame (rows r < R are the shorter refined
// side, R = Rb f, C = Cb f; the forward stack is in the same frame):
//   - reverse cell (i', j') lies on reverse diagonal q = i' + j'; its
//     increment is inc(R - i', C - j') (inc(r, c) feeds forward cell
//     (r + 1, c + 1), and flipping both axes maps reverse cell (i', j') to
//     forward increment (R-1-(i'-1), C-1-(j'-1)));
//   - the product pairs reverse cell (i', j') = (R-1-i, C-1-j) with forward
//     cell (i, j) on forward diagonal p = R + C - 2 - q, for 0 <= i < R,
//     0 <= j < C; that is reverse diagonals q = 0 .. R + C - 2, and the
//     forward value is stack[p][i];
//   - the output is in the ORIGINAL frame: base cell (a, b) of the solve's
//     frame goes to ct[a * Cb + b], or to ct[b * Rb + a] when the solve was
//     transposed.
//
// The collapse without races or atomics: thread t owns base rows a = t,
// t + T, ... of the solve's frame, i.e. refined rows a f .. a f + f - 1. On
// one diagonal those f cells fall into at most two base columns, and no
// other thread ever touches row a, so each term is added with a plain
// read-add-write into the output (zeroed by the wrapper). The order of the
// terms of one base cell is fixed: diagonals in the reverse sweep's order
// (forward p descending), rows k = 0 .. f - 1 ascending within one
// diagonal. scan_solver.collapse_refined sums in the same order, so the
// kernel and its plain version agree bit for bit.
//
// Races on the ring: the product of reverse diagonal q reads only ring
// slot q % 3, after the barrier that ends diagonal q. Diagonal q + 1 writes
// slot (q + 1) % 3; slot q % 3 is rewritten at diagonal q + 3, after two more
// barriers that every thread reaches only after its product of q. One
// barrier per diagonal, as in the forward.
//
// What bounds it on the H100: the reverse sweep costs what the forward does
// (a barrier per diagonal, and four exp per refined cell for "gen"); on top
// come one stack read (coalesced along the diagonal) and one read-add-write
// of the base cotangent (L1/L2) per refined cell. The refined product grid
// never exists in device memory.
#include "rbf_gen.cuh"

namespace sigkernel {

template <typename T, typename Inc>
__device__ void adjoint_body(T* ring, int R, int C, int f, bool naive,
                             const Inc& inc, const T* __restrict__ stack,
                             T* __restrict__ ct, int transpose) {
  const int stride = R + 1;
  const int Rb = R / f, Cb = C / f;
  for (int k = threadIdx.x; k < 3 * stride; k += blockDim.x) ring[k] = T(1);
  __syncthreads();
  for (int q = 0; q <= R + C - 2; ++q) {
    T* cur = ring + (q % 3) * stride;
    if (q >= 2) {
      const T* m1 = ring + ((q - 1) % 3) * stride;
      const T* m2 = ring + ((q - 2) % 3) * stride;
      const int lo = q - C > 1 ? q - C : 1;
      const int hi = q - 1 < R ? q - 1 : R;
      for (int i = lo + threadIdx.x; i <= hi; i += blockDim.x) {
        cur[i] = scheme(m2[i - 1], m1[i - 1], m1[i], inc(R - i, C - (q - i)),
                        naive);
      }
      __syncthreads();
    }
    // diagonals 0 and 1 are boundary cells: the ring already holds their 1s
    const int p = R + C - 2 - q;
    const T* srow = stack + static_cast<int64_t>(p) * stride;
    for (int a = threadIdx.x; a < Rb; a += blockDim.x) {
      for (int k = 0; k < f; ++k) {
        const int i = a * f + k;
        const int j = p - i;
        if (j < 0 || j >= C) continue;
        const int b = j / f;
        T* cell = ct + (transpose ? static_cast<int64_t>(b) * Rb + a
                                  : static_cast<int64_t>(a) * Cb + b);
        *cell = add(*cell, mul(srow[i], cur[R - 1 - i]));
      }
    }
  }
}

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
                  stack + pair * stack_elems(R, C),
                  ct + pair * static_cast<int64_t>(Lr - 1) * (Lc - 1),
                  transpose);
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
                  stack + pair * stack_elems(R, C), ct + pair * cells,
                  transpose);
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

}  // namespace sigkernel

extern "C" {

// rows/ri: the path side with the shorter refined length (Lr <= Lc);
// transpose: 1 when rows are the pairs' second (Y) side. ct: (P, Lx-1,
// Ly-1) in the pairs' own (X, Y) frame, zeroed.
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

}  // extern "C"
