// K10: the base Linear increment grids of pairs of paths, written from the
// paths' scaled increments in one pass.
//
// Replaces no TPU kernel. The JAX package builds this grid,
// double_difference(LinearKernel.batch_kernel(x, y)), in XLA and
// differentiates it by jax.vjp (sigkernel_tpu/sigkernel.py,
// _pair_fused_bwd). The port built it with a Gram, a multiply and four
// slices in PyTorch and differentiated it by autograd; this kernel builds
// it for the inc family's gradient route (sigkernel._GridPairs, and the
// lgen family's backward, which inherits it), whose backward carries the
// grid's cotangent to the increments by K11 (linear_dd_vjp.cu) instead.
//
// out[p, i, j] = <a_i, b_j>, a = A[ii[p]], b = B[jj[p]]: the scaled
// increments (ops/cuda_lgen.py::scaled_increments, the arrays K6 takes), in
// the pair's own frame ((M-1, N-1), no transposition). The dot product is
// summed over the coordinates in order, non-contracted: K6's op order and
// ops/cuda_lgen.py::pair_increments, the plain version, bit for bit. (The
// Gram's double difference equals it exactly in exact arithmetic:
// scale^2 <dx_i, dy_j>, with no Gram.)
//
// What bounds it on the H100: the write of the grid, (M-1)(N-1) values a
// pair (8.37 MB in double at length 1024: 0.32 ms for 128 pairs at 3.35
// TB/s); D multiply-adds a value are far below that. So nothing but the
// grid is written, and the increments come from registers or cache:
// - One block of kIncWarps warps a (pair, band of kIncRows rows, chunk of
//   kIncChunk columns), as K9 (rbf_gen_increments.cu). A lane owns kIncCols
//   columns of its warp's span, column c0 + k 32 + lane, so each store of a
//   row is 32 neighbouring values, coalesced.
// - kD > 0: a lane keeps its columns' b in registers and the row's a comes
//   by __ldg (one address for the whole warp); kD = 0 (any D): both are
//   read through __ldg.
#include "wavefront.cuh"

namespace sigkernel {

constexpr int kLinWarps = 4;
constexpr int kLinThreads = 32 * kLinWarps;
constexpr int kLinCols = 4;                      // columns a lane owns
constexpr int kLinSpan = 32 * kLinCols;          // a warp's columns
constexpr int kLinChunk = kLinSpan * kLinWarps;  // a block's columns
constexpr int kLinRows = 64;                     // rows a block

// Blocks: pair-major, then bands, then chunks of columns.
template <typename T, int kD>
__global__ void __launch_bounds__(kLinThreads)
linear_gen_increments(const T* __restrict__ A, const T* __restrict__ B,
                      const int64_t* __restrict__ ii,
                      const int64_t* __restrict__ jj, T* __restrict__ out,
                      int Mb, int Nb, int D, int nbands, int nchunks) {
  constexpr int kN = kD > 0 ? kD : 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per_pair = static_cast<int64_t>(nbands) * nchunks;
  const int64_t p = blockIdx.x / per_pair;
  const int rest = static_cast<int>(blockIdx.x % per_pair);
  const int band = rest / nchunks, chunk = rest % nchunks;
  const int c0 = chunk * kLinChunk + warp * kLinSpan;
  if (c0 >= Nb) return;  // a whole warp past the last column
  const int a0 = band * kLinRows;
  const int a1 = min(Mb, a0 + kLinRows);
  const T* a = A + ii[p] * Mb * static_cast<int64_t>(D);
  const T* b = B + jj[p] * Nb * static_cast<int64_t>(D);
  int n[kLinCols];  // the lane's columns, clamped to Nb - 1 for the reads
  T bv[kLinCols][kN];
#pragma unroll
  for (int k = 0; k < kLinCols; ++k) {
    const int c = c0 + k * 32 + lane;
    n[k] = c < Nb ? c : Nb - 1;
    if constexpr (kD > 0) {
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        bv[k][d] = __ldg(b + static_cast<int64_t>(n[k]) * kD + d);
      }
    }
  }
  T* o = out + p * Mb * static_cast<int64_t>(Nb);
#pragma unroll 2
  for (int i = a0; i < a1; ++i) {
    const T* ai = a + static_cast<int64_t>(i) * D;
    T* row = o + static_cast<int64_t>(i) * Nb;
    if constexpr (kD > 0) {
      T av[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) av[d] = __ldg(ai + d);
#pragma unroll
      for (int k = 0; k < kLinCols; ++k) {
        T dot = mul(av[0], bv[k][0]);
#pragma unroll
        for (int d = 1; d < kD; ++d) dot = add(dot, mul(av[d], bv[k][d]));
        const int c = c0 + k * 32 + lane;
        if (c < Nb) row[c] = dot;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kLinCols; ++k) {
        const T* bn = b + static_cast<int64_t>(n[k]) * D;
        T dot = mul(__ldg(ai), __ldg(bn));
        for (int d = 1; d < D; ++d) {
          dot = add(dot, mul(__ldg(ai + d), __ldg(bn + d)));
        }
        const int c = c0 + k * 32 + lane;
        if (c < Nb) row[c] = dot;
      }
    }
  }
}

template <typename T>
using LinIncKernel = void (*)(const T*, const T*, const int64_t*,
                              const int64_t*, T*, int, int, int, int, int);

template <typename T>
LinIncKernel<T> linear_increments_kernel(int D) {
  switch (D) {
    case 1: return linear_gen_increments<T, 1>;
    case 2: return linear_gen_increments<T, 2>;
    case 3: return linear_gen_increments<T, 3>;
    case 4: return linear_gen_increments<T, 4>;
    case 5: return linear_gen_increments<T, 5>;
    case 6: return linear_gen_increments<T, 6>;
    case 7: return linear_gen_increments<T, 7>;
    case 8: return linear_gen_increments<T, 8>;
    default: return linear_gen_increments<T, 0>;
  }
}

// All P pairs, in launches of at most 2^31 - 1 blocks.
template <typename T>
int launch_linear_increments(const void* A, const void* B, const void* ii,
                             const void* jj, void* out, int64_t P, int Mb,
                             int Nb, int D, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (P <= 0 || Mb <= 0 || Nb <= 0 || D <= 0) return cudaSuccess;
  const LinIncKernel<T> kernel = linear_increments_kernel<T>(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nbands = (Mb + kLinRows - 1) / kLinRows;
  const int nchunks = (Nb + kLinChunk - 1) / kLinChunk;
  const int64_t per_pair = static_cast<int64_t>(nbands) * nchunks;
  const int64_t most = (static_cast<int64_t>(1) << 31) - 1;
  const int64_t step = most / per_pair > 0 ? most / per_pair : 1;
  const int64_t cells = static_cast<int64_t>(Mb) * Nb;
  for (int64_t p0 = 0; p0 < P; p0 += step) {
    const int64_t n = P - p0 < step ? P - p0 : step;
    kernel<<<static_cast<unsigned>(n * per_pair), kLinThreads, 0, s>>>(
        static_cast<const T*>(A), static_cast<const T*>(B),
        static_cast<const int64_t*>(ii) + p0,
        static_cast<const int64_t*>(jj) + p0,
        static_cast<T*>(out) + p0 * cells, Mb, Nb, D, nbands, nchunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace sigkernel

extern "C" {

// A (A, Mb, D), B (B, Nb, D) scaled increments, ii/jj (P,) int64; out (P,
// Mb, Nb).
int sk_linear_gen_increments_f32(const void* A, const void* B,
                                 const void* ii, const void* jj, void* out,
                                 int64_t P, int Mb, int Nb, int D,
                                 int device, void* stream) {
  return sigkernel::launch_linear_increments<float>(A, B, ii, jj, out, P, Mb,
                                                    Nb, D, device, stream);
}

int sk_linear_gen_increments_f64(const void* A, const void* B,
                                 const void* ii, const void* jj, void* out,
                                 int64_t P, int Mb, int Nb, int D,
                                 int device, void* stream) {
  return sigkernel::launch_linear_increments<double>(A, B, ii, jj, out, P,
                                                     Mb, Nb, D, device,
                                                     stream);
}

}  // extern "C"
