// K4: the increment-chain VJP of the RBF generation, per pair.
//
// Replaces the TPU kernel
//   sigkernel_tpu/ops/pallas_incvjp.py::_vjp_kernel
// (float and double instances; the TPU kernel was float only).
//
// Given the base cotangent ct (P, M-1, N-1) of the increments
// dd(exp(-|x_m - y_n|^2 / sigma)) of the pairs (x, y) = (X[ii[p]],
// Y[jj[p]]), with D = |x_m - y_n|^2, G = exp(-D / sigma):
//   dG = dd^T(ct)              (M, N), the double difference's transpose
//   E  = dG * G,  W = E * (-1 / sigma)
//   dx_m = 2 (rowsum(W)_m x_m - sum_n W_mn y_n)
//   dy_n = 2 (colsum(W)_n y_n - sum_m W_mn x_m)
//   d sigma = sum(E * D) / sigma^2
// (sigkernel_tpu/ops/df_prep.py::rbf_dd_vjp, pairwise layout.) The kernel
// writes the per-pair dx, dy and, per block of rows, the partial sums of
// E * D; the wrapper adds the partials in torch and scatters dx, dy onto X
// and Y over ii, jj.
//
// What bounds it on the H100: one exp and D-wide distances per cell, and
// the ct reads (four per cell, mostly from L1). With d = 3 the products
// W @ Y and W^T @ X are far too narrow for tensor cores, so there is no
// GEMM here: a row pass (one thread per row m, walking n) and a column pass
// (one thread per column n, walking m) each regenerate W, and W never
// exists in device memory. The column pass reads ct coalesced; the row pass
// strides by N - 1 across a warp and leans on L1 for the next n. Each
// thread keeps its D-wide running sum in shared memory.
#include "rbf_gen.cuh"

namespace sigkernel {

constexpr int kVjpThreads = 128;

// One pass. cols = 0: thread rows u = x (Lu = M) walk v = y (Lv = N);
// cols = 1: thread rows u = y walk v = x. Both passes compute every W_mn in
// the same op order (sqdist is symmetric bit for bit), so W is the same
// number in both.
template <typename T>
__global__ void rbf_dd_vjp_pass(const T* __restrict__ us,
                                const T* __restrict__ vs,
                                const int64_t* __restrict__ ui,
                                const int64_t* __restrict__ vi,
                                const T* __restrict__ ct, T* __restrict__ du,
                                T* __restrict__ esum, int Lu, int Lv, int D,
                                T sigma, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* acc = reinterpret_cast<T*>(smem) + threadIdx.x * D;
  T* red = reinterpret_cast<T*>(smem) + blockDim.x * D;
  const int64_t pair = blockIdx.x;
  const T* u = us + ui[pair] * static_cast<int64_t>(Lu) * D;
  const T* v = vs + vi[pair] * static_cast<int64_t>(Lv) * D;
  const int Mb = (cols ? Lv : Lu) - 1, Nb = (cols ? Lu : Lv) - 1;
  const T* c = ct + pair * static_cast<int64_t>(Mb) * Nb;
  const int m = blockIdx.y * blockDim.x + threadIdx.x;
  const T neg_inv_sigma = T(-1) / sigma;
  // ct, zero outside its (Mb, Nb) grid: the zero padding of dd^T
  auto cv = [&](int a, int b) -> T {
    return (a >= 0 && a < Mb && b >= 0 && b < Nb)
               ? c[static_cast<int64_t>(a) * Nb + b] : T(0);
  };
  T es = T(0);
  if (m < Lu) {
    const T* um = u + static_cast<int64_t>(m) * D;
    for (int d = 0; d < D; ++d) acc[d] = T(0);
    T rs = T(0);
    for (int n = 0; n < Lv; ++n) {
      const int a = cols ? n : m, b = cols ? m : n;  // (x index, y index)
      // ((c[a,b] + c[a-1,b-1]) - c[a,b-1]) - c[a-1,b]: the op order of
      // double_difference over the zero-padded ct
      const T dG = sub(sub(add(cv(a, b), cv(a - 1, b - 1)), cv(a, b - 1)),
                       cv(a - 1, b));
      const T* vn = v + static_cast<int64_t>(n) * D;
      const T dist = sqdist(um, vn, D);
      const T E = mul(dG, sk_exp(-dist / sigma));
      const T W = mul(E, neg_inv_sigma);
      rs = add(rs, W);
      for (int d = 0; d < D; ++d) acc[d] = add(acc[d], mul(W, vn[d]));
      if (!cols) es = add(es, mul(E, dist));
    }
    T* out = du + (pair * Lu + m) * static_cast<int64_t>(D);
    for (int d = 0; d < D; ++d) {
      out[d] = mul(T(2), sub(mul(rs, um[d]), acc[d]));
    }
  }
  if (!cols) {
    red[threadIdx.x] = es;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
      if (threadIdx.x < s) {
        red[threadIdx.x] = add(red[threadIdx.x], red[threadIdx.x + s]);
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) esum[pair * gridDim.y + blockIdx.y] = red[0];
  }
}

template <typename T>
int launch_vjp(const void* X, const void* Y, const void* ii, const void* jj,
               const void* ct, void* dx, void* dy, void* esum, int64_t P,
               int M, int N, int D, double sigma, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = static_cast<size_t>(kVjpThreads) * (D + 1) * sizeof(T);
  e = allow_smem(rbf_dd_vjp_pass<T>, smem);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T sg = static_cast<T>(sigma);
  // rows: blocks of kVjpThreads rows of x; esum gets one partial per block
  dim3 rows_grid(static_cast<unsigned>(P), (M + kVjpThreads - 1) / kVjpThreads);
  rbf_dd_vjp_pass<T><<<rows_grid, kVjpThreads, smem, s>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y),
      static_cast<const int64_t*>(ii), static_cast<const int64_t*>(jj),
      static_cast<const T*>(ct), static_cast<T*>(dx), static_cast<T*>(esum),
      M, N, D, sg, 0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 cols_grid(static_cast<unsigned>(P), (N + kVjpThreads - 1) / kVjpThreads);
  rbf_dd_vjp_pass<T><<<cols_grid, kVjpThreads, smem, s>>>(
      static_cast<const T*>(Y), static_cast<const T*>(X),
      static_cast<const int64_t*>(jj), static_cast<const int64_t*>(ii),
      static_cast<const T*>(ct), static_cast<T*>(dy), nullptr, N, M, D, sg,
      1);
  return cudaGetLastError();
}

}  // namespace sigkernel

extern "C" {

// X (A, M, D), Y (B, N, D), ii/jj (P,) int64, ct (P, M-1, N-1); out: dx
// (P, M, D), dy (P, N, D), esum (P, ceil(M / 128)).
int sk_rbf_dd_vjp_f32(const void* X, const void* Y, const void* ii,
                      const void* jj, const void* ct, void* dx, void* dy,
                      void* esum, int64_t P, int M, int N, int D,
                      double sigma, int device, void* stream) {
  return sigkernel::launch_vjp<float>(X, Y, ii, jj, ct, dx, dy, esum, P, M,
                                      N, D, sigma, device, stream);
}

int sk_rbf_dd_vjp_f64(const void* X, const void* Y, const void* ii,
                      const void* jj, const void* ct, void* dx, void* dy,
                      void* esum, int64_t P, int M, int N, int D,
                      double sigma, int device, void* stream) {
  return sigkernel::launch_vjp<double>(X, Y, ii, jj, ct, dx, dy, esum, P, M,
                                       N, D, sigma, device, stream);
}

}  // extern "C"
