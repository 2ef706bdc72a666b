// K9: the base RBF increment grids of pairs of paths, written from the
// points in one pass.
//
// Replaces no TPU kernel. The JAX package builds this grid,
// double_difference(RBFKernel.batch_kernel(x, y)), in XLA, which fuses it,
// and differentiates it by jax.vjp (sigkernel_tpu/sigkernel.py,
// _pair_fused_bwd). The port built it with about seven PyTorch passes over
// each pair's grid and differentiated it by autograd; this kernel builds it
// for the inc family's gradient route (sigkernel._GridPairs), whose
// backward carries the grid's cotangent to the paths by K4
// (rbf_dd_vjp.cu) instead.
//
// out[p, a, b] = (G(a+1, b+1) + G(a, b)) - (G(a+1, b) + G(a, b+1)), with
// G(a, b) = exp(-|x_a - y_b|^2 / sigma), x = X[ii[p]], y = Y[jj[p]], in
// the pair's own frame ((M-1, N-1), no transposition). The arithmetic is
// rbf_gen.cuh's (rbf_value, rbf_dd), each sum over the coordinates in
// order, non-contracted: bit for bit ops/cuda_gen.py::gen_increments, the
// plain version.
//
// What bounds it on the H100: the write of the grid, (M-1)(N-1) values a
// pair (8.37 MB in double at length 1024: 1.40 ms for 560 pairs at 3.35
// TB/s); close behind, the operations of G (about 6 D + 6 a point pair
// besides its exact division and exp). So each G is computed once, the
// points are read from registers or cache, and nothing but the grid is
// written:
// - One block of kIncWarps warps a (pair, band of kIncRows rows, chunk of
//   kIncChunk columns). A lane owns kIncCols columns of its warp's span,
//   column c0 + k 32 + lane, so each store of a row is 32 neighbouring
//   values, coalesced. (Rows of an odd N - 1 start off every 16-byte
//   boundary, so the stores are one value a lane.)
// - A lane walks the band's rows down, computing its columns' G once a row
//   and keeping the row above in registers; the east neighbour G(a, b + 1)
//   comes from lane + 1 by __shfl_sync (lane 31: lane 0's next column, or
//   past the span's last column the halo). The halo column, the next
//   span's first, is computed 32 rows at a time, lane l for row a + l, and
//   handed to lane 31 by a shuffle: one G more a warp in 32 rows. The
//   band's first row is computed by the band above too: 1 / kIncRows more.
// - kD > 0: a lane keeps its columns' y points and |y|^2 in registers, and
//   the row's x point comes by __ldg (one address for the whole warp); kD
//   = 0 (any D): x and y are read through __ldg.
#include "rbf_gen.cuh"

namespace sigkernel {

constexpr int kIncWarps = 4;
constexpr int kIncThreads = 32 * kIncWarps;
constexpr int kIncCols = 4;                      // columns a lane owns
constexpr int kIncSpan = 32 * kIncCols;          // a warp's columns
constexpr int kIncChunk = kIncSpan * kIncWarps;  // a block's columns
constexpr int kIncRows = 64;                     // output rows a block
constexpr unsigned kIncFull = 0xffffffffu;

// One lane's points: the pair's x and y, its kIncCols columns' y points and
// |y|^2, and the halo column's (kD > 0: in registers; kD = 0: read through
// __ldg, the norms computed once).
template <typename T, int kD>
struct IncPoints {
  static constexpr int kN = kD > 0 ? kD : 1;
  const T* x;
  const T* y;
  int D;
  int n[kIncCols + 1];  // the columns, then the halo's, clamped to N - 1
  T yv[kIncCols + 1][kN];
  T sy[kIncCols + 1];

  __device__ __forceinline__ void init(const T* x_, const T* y_, int D_,
                                       int c0, int lane, int N) {
    x = x_;
    y = y_;
    D = D_;
#pragma unroll
    for (int k = 0; k <= kIncCols; ++k) {
      const int c = k < kIncCols ? c0 + k * 32 + lane : c0 + kIncSpan;
      n[k] = c < N ? c : N - 1;
      const T* yp = y + static_cast<int64_t>(n[k]) * D;
      T s = T(0);
      if constexpr (kD > 0) {
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          yv[k][d] = __ldg(yp + d);
          s = add(s, mul(yv[k][d], yv[k][d]));
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const T v = __ldg(yp + d);
          s = add(s, mul(v, v));
        }
      }
      sy[k] = s;
    }
  }

  // |x_a|^2, and x_a into xa (kD > 0)
  __device__ __forceinline__ T row(int a, T (&xa)[kN]) const {
    const T* xp = x + static_cast<int64_t>(a) * D;
    T s = T(0);
    if constexpr (kD > 0) {
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        xa[d] = __ldg(xp + d);
        s = add(s, mul(xa[d], xa[d]));
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const T v = __ldg(xp + d);
        s = add(s, mul(v, v));
      }
    }
    return s;
  }

  // G(a, column k) from row a's point (xa, sx), in rbf_value's expression
  __device__ __forceinline__ T G(int a, const T (&xa)[kN], T sx, int k,
                                 T sigma) const {
    T dot = T(0);
    if constexpr (kD > 0) {
#pragma unroll
      for (int d = 0; d < kD; ++d) dot = add(dot, mul(xa[d], yv[k][d]));
    } else {
      const T* xp = x + static_cast<int64_t>(a) * D;
      const T* yp = y + static_cast<int64_t>(n[k]) * D;
      for (int d = 0; d < D; ++d) dot = add(dot, mul(__ldg(xp + d),
                                                     __ldg(yp + d)));
    }
    return rbf_value(sx, sy[k], dot, sigma);
  }
};

// Blocks: pair-major, then bands, then chunks of columns. Rows a0 .. a1 of
// G make output rows a0 .. a1 - 1.
template <typename T, int kD>
__global__ void __launch_bounds__(kIncThreads)
rbf_gen_increments(const T* __restrict__ X, const T* __restrict__ Y,
                   const int64_t* __restrict__ ii,
                   const int64_t* __restrict__ jj, T* __restrict__ out,
                   int M, int N, int D, int nbands, int nchunks, T sigma) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per_pair = static_cast<int64_t>(nbands) * nchunks;
  const int64_t p = blockIdx.x / per_pair;
  const int rest = static_cast<int>(blockIdx.x % per_pair);
  const int band = rest / nchunks, chunk = rest % nchunks;
  const int Mb = M - 1, Nb = N - 1;
  const int c0 = chunk * kIncChunk + warp * kIncSpan;
  if (c0 >= Nb) return;  // a whole warp past the last column
  const int a0 = band * kIncRows;
  const int a1 = min(Mb, a0 + kIncRows);
  IncPoints<T, kD> pts;
  pts.init(X + ii[p] * M * static_cast<int64_t>(D),
           Y + jj[p] * N * static_cast<int64_t>(D), D, c0, lane, N);
  T* o = out + p * Mb * static_cast<int64_t>(Nb);
  T gn[kIncCols], gne[kIncCols];  // the row above: G at b, and at b + 1
  T hb = T(0);  // the halo column's G at row a + lane of the 32 rows
#pragma unroll 1
  for (int a = a0; a <= a1; ++a) {
    const int t = (a - a0) & 31;
    if (t == 0) {  // the next 32 rows' halo, a row a lane
      T xh[IncPoints<T, kD>::kN];
      const int ah = min(a + lane, a1);
      const T sh = pts.row(ah, xh);
      hb = pts.G(ah, xh, sh, kIncCols, sigma);
    }
    const T halo = __shfl_sync(kIncFull, hb, t);
    T xa[IncPoints<T, kD>::kN];
    const T sx = pts.row(a, xa);
    T g[kIncCols], ge[kIncCols];
#pragma unroll
    for (int k = 0; k < kIncCols; ++k) g[k] = pts.G(a, xa, sx, k, sigma);
    // the east neighbours: lane + 1's value; lane 31 takes lane 0's of the
    // next column, or the halo past the span's last
#pragma unroll
    for (int k = 0; k < kIncCols; ++k) {
      ge[k] = __shfl_sync(kIncFull, g[k], (lane + 1) & 31);
    }
    if (lane == 31) {
#pragma unroll
      for (int k = 0; k + 1 < kIncCols; ++k) ge[k] = ge[k + 1];
      ge[kIncCols - 1] = halo;
    }
    if (a > a0) {
      T* row = o + static_cast<int64_t>(a - 1) * Nb;
#pragma unroll
      for (int k = 0; k < kIncCols; ++k) {
        const int b = c0 + k * 32 + lane;
        if (b < Nb) row[b] = rbf_dd(ge[k], gn[k], g[k], gne[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kIncCols; ++k) {
      gn[k] = g[k];
      gne[k] = ge[k];
    }
  }
}

template <typename T>
using IncGenKernel = void (*)(const T*, const T*, const int64_t*,
                              const int64_t*, T*, int, int, int, int, int,
                              T);

template <typename T>
IncGenKernel<T> increments_kernel(int D) {
  switch (D) {
    case 1: return rbf_gen_increments<T, 1>;
    case 2: return rbf_gen_increments<T, 2>;
    case 3: return rbf_gen_increments<T, 3>;
    case 4: return rbf_gen_increments<T, 4>;
    case 5: return rbf_gen_increments<T, 5>;
    case 6: return rbf_gen_increments<T, 6>;
    case 7: return rbf_gen_increments<T, 7>;
    case 8: return rbf_gen_increments<T, 8>;
    default: return rbf_gen_increments<T, 0>;
  }
}

// All P pairs, in launches of at most 2^31 - 1 blocks.
template <typename T>
int launch_increments(const void* X, const void* Y, const void* ii,
                      const void* jj, void* out, int64_t P, int M, int N,
                      int D, double sigma, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int Mb = M - 1, Nb = N - 1;
  if (P <= 0 || Mb <= 0 || Nb <= 0) return cudaSuccess;
  const IncGenKernel<T> kernel = increments_kernel<T>(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nbands = (Mb + kIncRows - 1) / kIncRows;
  const int nchunks = (Nb + kIncChunk - 1) / kIncChunk;
  const int64_t per_pair = static_cast<int64_t>(nbands) * nchunks;
  const int64_t most = (static_cast<int64_t>(1) << 31) - 1;
  const int64_t step = most / per_pair > 0 ? most / per_pair : 1;
  const int64_t cells = static_cast<int64_t>(Mb) * Nb;
  for (int64_t p0 = 0; p0 < P; p0 += step) {
    const int64_t n = P - p0 < step ? P - p0 : step;
    kernel<<<static_cast<unsigned>(n * per_pair), kIncThreads, 0, s>>>(
        static_cast<const T*>(X), static_cast<const T*>(Y),
        static_cast<const int64_t*>(ii) + p0,
        static_cast<const int64_t*>(jj) + p0,
        static_cast<T*>(out) + p0 * cells, M, N, D, nbands, nchunks,
        static_cast<T>(sigma));
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace sigkernel

extern "C" {

// X (A, M, D), Y (B, N, D), ii/jj (P,) int64; out (P, M-1, N-1).
int sk_rbf_gen_increments_f32(const void* X, const void* Y, const void* ii,
                              const void* jj, void* out, int64_t P, int M,
                              int N, int D, double sigma, int device,
                              void* stream) {
  return sigkernel::launch_increments<float>(X, Y, ii, jj, out, P, M, N, D,
                                             sigma, device, stream);
}

int sk_rbf_gen_increments_f64(const void* X, const void* Y, const void* ii,
                              const void* jj, void* out, int64_t P, int M,
                              int N, int D, double sigma, int device,
                              void* stream) {
  return sigkernel::launch_increments<double>(X, Y, ii, jj, out, P, M, N, D,
                                              sigma, device, stream);
}

}  // extern "C"
