// K11: the VJP of the base Linear increment grids to the increments.
//
// Replaces no TPU kernel: the JAX package differentiates the Linear grid
// by jax.vjp (sigkernel_tpu/sigkernel.py, _pair_fused_bwd), as the port
// did by autograd through a grid built in PyTorch. K10
// (linear_gen_increments.cu) writes the grid dd[p, i, j] = <a_i, b_j> from
// the scaled increments a = A[ii[p]], b = B[jj[p]]; given its cotangent ct
// (P, M-1, N-1), this kernel writes, for each pair,
//   U[p, i, :] = sum_j ct[p, i, j] b_j      (the cotangent of a_i)
//   V[p, j, :] = sum_i ct[p, i, j] a_i      (the cotangent of b_j)
// in one read of ct. What is left is (P, M, D)-sized and stays in PyTorch
// (ops/cuda_lgen.py, sigkernel._linear_grid_backward): the scatter onto
// the paths over ii, jj, the difference's transpose and scale's gradient.
//
// What bounds it on the H100: the read of ct, (M-1)(N-1) values a pair
// (1.07 GB in double at 128 pairs of length 1024: 0.32 ms at 3.35 TB/s);
// 2 D multiply-adds a value are far below that. The design:
// - One block of kLvWarps warps a (pair, band of kLvRows rows, chunk of
//   kLvChunk columns), the layout of K10. A lane owns kLvCols columns of
//   its warp's span (column c0 + k 32 + lane), so a warp's loads of a row
//   are 32 neighbouring values, and keeps its columns' b in registers.
// - Walking the band's rows down, a lane sums its columns' V in registers
//   (a_i comes by __ldg, one address for the whole warp), and its part of
//   the row's U, its kLvCols columns in order. The row's U is summed over
//   the warp by the pairs of a halving tree (lanes l and l ^ 16, then l ^
//   8, ... l ^ 1) as a reduce-scatter: each lane trades half of what it
//   holds a level, so the D sums of a row cost about D + 3 shuffles, not 5
//   D. Then the block's warps are added in order in shared memory.
// - No atomics: each block writes its chunk's U of its rows to upart
//   (P, chunks, M-1, W) and its band's V of its columns to vpart (P, bands,
//   N-1, W); linear_dd_vjp_combine adds the chunks and the bands in order.
//   Two launches on one input are equal bit for bit.
// - D <= kLvRegD = 8 in one pass (instances kD = 1 .. 8); a wider D in
//   passes of 8 coordinates, each reading ct again, with scratch of W = 8
//   columns: any D, with the scratch an eighth of ct's size at most.
#include "wavefront.cuh"

namespace sigkernel {

constexpr int kLvWarps = 4;
constexpr int kLvThreads = 32 * kLvWarps;
constexpr int kLvCols = 4;                   // columns a lane owns
constexpr int kLvSpan = 32 * kLvCols;        // a warp's columns
constexpr int kLvChunk = kLvSpan * kLvWarps;  // a block's columns
constexpr int kLvRows = 64;                  // rows a block
constexpr int kLvRegD = 8;                   // coordinates a pass
constexpr unsigned kLvFull = 0xffffffffu;

// the smallest power of 2 >= v, and the log2 of a power of 2
__host__ __device__ constexpr int lin_pow2(int v) {
  return v <= 1 ? 1 : 2 * lin_pow2((v + 1) / 2);
}
__host__ __device__ constexpr int lin_log2(int v) {
  return v <= 1 ? 0 : 1 + lin_log2(v / 2);
}

// The warp's sums of V values (V a power of 2) by the pairs of a halving
// tree, lanes l and l ^ S for S = 16, 8, ..., 1. While a lane holds n > 1
// values it keeps one half (the upper one where its bit S is set) and
// trades the other for its partner's copy of the kept half; holding one, it
// adds its partner's. Value i's sum ends in v[0] of the lanes whose top
// log2(V) bits read i.
template <int kN, int kS, typename T, int V>
__device__ __forceinline__ void lin_scatter(T (&v)[V], int lane) {
  if constexpr (kS > 0) {
    if constexpr (kN > 1) {
      constexpr int h = kN / 2;
      const bool up = lane & kS;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const T send = up ? v[i] : v[i + h];
        const T keep = up ? v[i + h] : v[i];
        v[i] = add(keep, __shfl_xor_sync(kLvFull, send, kS));
      }
      lin_scatter<h, kS / 2>(v, lane);
    } else {
      v[0] = add(v[0], __shfl_xor_sync(kLvFull, v[0], kS));
      lin_scatter<1, kS / 2>(v, lane);
    }
  }
}

// Coordinates d0 .. d0 + kD - 1 of U and V (a, b of row stride D). Shared
// memory: rowpart [kLvRows][warps][kD], a row's sum of each warp.
template <typename T, int kD>
__global__ void __launch_bounds__(kLvThreads)
linear_dd_vjp_band(const T* __restrict__ A, const T* __restrict__ B,
                   const int64_t* __restrict__ ii,
                   const int64_t* __restrict__ jj, const T* __restrict__ ct,
                   T* __restrict__ upart, T* __restrict__ vpart, int Mb,
                   int Nb, int D, int d0, int nbands, int nchunks) {
  constexpr int kV = lin_pow2(kD), kL = lin_log2(kV);
  __shared__ T rowpart[kLvRows][kLvWarps][kD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per_pair = static_cast<int64_t>(nbands) * nchunks;
  const int64_t p = blockIdx.x / per_pair;
  const int rest = static_cast<int>(blockIdx.x % per_pair);
  const int band = rest / nchunks, chunk = rest % nchunks;
  const int c0 = chunk * kLvChunk + warp * kLvSpan;
  const int a0 = band * kLvRows;
  const int rows = min(Mb, a0 + kLvRows) - a0;
  const T* a = A + ii[p] * Mb * static_cast<int64_t>(D) + d0;
  const T* b = B + jj[p] * Nb * static_cast<int64_t>(D) + d0;
  const T* c = ct + p * Mb * static_cast<int64_t>(Nb);
  bool ok[kLvCols];
  T bv[kLvCols][kD], v[kLvCols][kD];
#pragma unroll
  for (int k = 0; k < kLvCols; ++k) {
    const int n = c0 + k * 32 + lane;
    ok[k] = n < Nb;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      bv[k][d] = ok[k] ? __ldg(b + static_cast<int64_t>(n) * D + d) : T(0);
      v[k][d] = T(0);
    }
  }
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    const int64_t i = a0 + r;
    const T* ci = c + i * Nb;
    T cv[kLvCols];
#pragma unroll
    for (int k = 0; k < kLvCols; ++k) {
      cv[k] = ok[k] ? ci[c0 + k * 32 + lane] : T(0);
    }
    T ai[kD];
#pragma unroll
    for (int d = 0; d < kD; ++d) ai[d] = __ldg(a + i * D + d);
    T u[kV];  // the lane's part of the row's U, zero-padded to kV
#pragma unroll
    for (int d = 0; d < kV; ++d) u[d] = T(0);
#pragma unroll
    for (int k = 0; k < kLvCols; ++k) {
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        v[k][d] = add(v[k][d], mul(cv[k], ai[d]));
        u[d] = add(u[d], mul(cv[k], bv[k][d]));
      }
    }
    lin_scatter<kV, 16>(u, lane);
    const int d = lane >> (5 - kL);
    if ((lane & ((32 >> kL) - 1)) == 0 && d < kD) rowpart[r][warp][d] = u[0];
  }
  // the band's V of the lane's columns
  T* vq = vpart + (p * nbands + band) * static_cast<int64_t>(Nb) * kD;
#pragma unroll
  for (int k = 0; k < kLvCols; ++k) {
    if (ok[k]) {
      const int64_t n = c0 + k * 32 + lane;
#pragma unroll
      for (int d = 0; d < kD; ++d) vq[n * kD + d] = v[k][d];
    }
  }
  // the chunk's U of the band's rows: the warps in order
  __syncthreads();
  T* uq = upart + ((p * nchunks + chunk) * static_cast<int64_t>(Mb) + a0)
                      * kD;
  const int warps =
      min(kLvWarps, (Nb - chunk * kLvChunk + kLvSpan - 1) / kLvSpan);
  for (int e = threadIdx.x; e < rows * kD; e += kLvThreads) {
    const int r = e / kD, d = e % kD;
    T t = rowpart[r][0][d];
    for (int w = 1; w < warps; ++w) t = add(t, rowpart[r][w][d]);
    uq[e] = t;
  }
}

// U and V's coordinates d0 .. d0 + W - 1: the chunks' U and the bands' V
// added in order. A thread an entry (p, row or column, coordinate).
template <typename T>
__global__ void linear_dd_vjp_combine(const T* __restrict__ upart,
                                      const T* __restrict__ vpart,
                                      T* __restrict__ U, T* __restrict__ V,
                                      int64_t P, int Mb, int Nb, int D,
                                      int d0, int W, int nbands,
                                      int nchunks) {
  const int64_t per_pair = static_cast<int64_t>(Mb + Nb) * W;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= P * per_pair) return;
  const int64_t p = e / per_pair;
  const int64_t at = e % per_pair;
  const int64_t r = at / W;
  const int d = static_cast<int>(at % W);
  if (r < Mb) {
    const T* q = upart + (p * nchunks * static_cast<int64_t>(Mb) + r) * W + d;
    T t = q[0];
    for (int k = 1; k < nchunks; ++k) {
      t = add(t, q[static_cast<int64_t>(k) * Mb * W]);
    }
    U[(p * Mb + r) * D + d0 + d] = t;
  } else {
    const int64_t j = r - Mb;
    const T* q = vpart + (p * nbands * static_cast<int64_t>(Nb) + j) * W + d;
    T t = q[0];
    for (int k = 1; k < nbands; ++k) {
      t = add(t, q[static_cast<int64_t>(k) * Nb * W]);
    }
    V[(p * Nb + j) * D + d0 + d] = t;
  }
}

template <typename T>
using LinVjpKernel = void (*)(const T*, const T*, const int64_t*,
                              const int64_t*, const T*, T*, T*, int, int,
                              int, int, int, int);

template <typename T>
LinVjpKernel<T> linear_vjp_kernel(int W) {
  switch (W) {
    case 1: return linear_dd_vjp_band<T, 1>;
    case 2: return linear_dd_vjp_band<T, 2>;
    case 3: return linear_dd_vjp_band<T, 3>;
    case 4: return linear_dd_vjp_band<T, 4>;
    case 5: return linear_dd_vjp_band<T, 5>;
    case 6: return linear_dd_vjp_band<T, 6>;
    case 7: return linear_dd_vjp_band<T, 7>;
    default: return linear_dd_vjp_band<T, 8>;
  }
}

// A pass of the band kernel, then the combine, a kLvRegD coordinates at a
// time; the band kernel's pairs in launches of at most 2^31 - 1 blocks.
// upart holds (P, nchunks, Mb, min(D, 8)) values, vpart (P, nbands, Nb,
// min(D, 8)).
template <typename T>
int launch_linear_vjp(const void* A, const void* B, const void* ii,
                      const void* jj, const void* ct, void* U, void* V,
                      void* upart, void* vpart, int64_t P, int Mb, int Nb,
                      int D, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  if (P <= 0 || Mb <= 0 || Nb <= 0 || D <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nbands = (Mb + kLvRows - 1) / kLvRows;
  const int nchunks = (Nb + kLvChunk - 1) / kLvChunk;
  const int64_t per_pair = static_cast<int64_t>(nbands) * nchunks;
  const int64_t most = (static_cast<int64_t>(1) << 31) - 1;
  const int64_t step = most / per_pair > 0 ? most / per_pair : 1;
  const int64_t cells = static_cast<int64_t>(Mb) * Nb;
  const int combine_threads = 256;
  for (int d0 = 0; d0 < D; d0 += kLvRegD) {
    const int W = D - d0 < kLvRegD ? D - d0 : kLvRegD;
    const LinVjpKernel<T> kernel = linear_vjp_kernel<T>(W);
    for (int64_t p0 = 0; p0 < P; p0 += step) {
      const int64_t n = P - p0 < step ? P - p0 : step;
      kernel<<<static_cast<unsigned>(n * per_pair), kLvThreads, 0, s>>>(
          static_cast<const T*>(A), static_cast<const T*>(B),
          static_cast<const int64_t*>(ii) + p0,
          static_cast<const int64_t*>(jj) + p0,
          static_cast<const T*>(ct) + p0 * cells,
          static_cast<T*>(upart) + p0 * nchunks * static_cast<int64_t>(Mb) * W,
          static_cast<T*>(vpart) + p0 * nbands * static_cast<int64_t>(Nb) * W,
          Mb, Nb, D, d0, nbands, nchunks);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    const int64_t entries = P * static_cast<int64_t>(Mb + Nb) * W;
    linear_dd_vjp_combine<T><<<static_cast<unsigned>(
        (entries + combine_threads - 1) / combine_threads), combine_threads,
        0, s>>>(static_cast<const T*>(upart), static_cast<const T*>(vpart),
                static_cast<T*>(U), static_cast<T*>(V), P, Mb, Nb, D, d0, W,
                nbands, nchunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace sigkernel

extern "C" {

// A (A, Mb, D), B (B, Nb, D) scaled increments, ii/jj (P,) int64, ct (P,
// Mb, Nb); out: U (P, Mb, D), V (P, Nb, D); scratch: upart (P,
// ceil(Nb / 512), Mb, min(D, 8)), vpart (P, ceil(Mb / 64), Nb, min(D, 8)).
int sk_linear_dd_vjp_f32(const void* A, const void* B, const void* ii,
                         const void* jj, const void* ct, void* U, void* V,
                         void* upart, void* vpart, int64_t P, int Mb, int Nb,
                         int D, int device, void* stream) {
  return sigkernel::launch_linear_vjp<float>(A, B, ii, jj, ct, U, V, upart,
                                             vpart, P, Mb, Nb, D, device,
                                             stream);
}

int sk_linear_dd_vjp_f64(const void* A, const void* B, const void* ii,
                         const void* jj, const void* ct, void* U, void* V,
                         void* upart, void* vpart, int64_t P, int Mb, int Nb,
                         int D, int device, void* stream) {
  return sigkernel::launch_linear_vjp<double>(A, B, ii, jj, ct, U, V, upart,
                                              vpart, P, Mb, Nb, D, device,
                                              stream);
}

}  // extern "C"
