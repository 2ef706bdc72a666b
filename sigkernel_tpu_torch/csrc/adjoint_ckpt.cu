// K8: the adjoint over a base increment grid from a SPARSE forward stack,
// the skipped forward diagonals recomputed in-kernel: for f <= 32 the
// band-pipelined wavefront of band_sweep.cuh (kBandCkpt), past it one block
// per pair.
//
// Replaces the TPU kernel
//   sigkernel_tpu/ops/pallas_adjoint.py::_product_ckpt_kernel
// (f32 there, with an f32 recompute; here one template serves float and
// double). Its forward is K2-sparse (inc_wavefront.cu), which keeps only
// the diagonal pairs (w W, w W + 1) of the full stack (wavefront.cuh).
//
// What it computes: K3<inc>'s reverse sweep, product and collapse
// (adjoint.cuh), with each forward diagonal rebuilt from the stored pair
// of its window w (diagonals w W .. w W + W - 1) in the forward's op order
// (the same scheme on the same three neighbours and the same increment),
// so each recomputed value is the forward's bit for bit and K8's cotangent
// equals K3<inc>'s bit for bit.
//
// What bounds it on the H100. The one-block kernel (adjoint_ckpt below, the
// earlier design) ran 128 blocks for 132 SMs at the timed shape, a barrier
// on each reverse diagonal and on each of the W - 2 recomputed diagonals of
// a window, and kept the window in a per-block scratch in device memory
// read back through L2: 27x its bound, the sparse stack's bytes. So for
// f <= 32 it is band_sweep.cuh's adjoint over the pair's whole reverse
// frame (row0 0, rows R, from 1s), GridSource walked with flip, with no
// barrier a diagonal and the collapse in registers, as K3<gen>'s; each
// warp recomputes its own rows' forward values a window at a time from the
// sparse stack, with a halo of W - 2 rows above it (kBandCkpt), and keeps
// them in shared memory, two windows a warp; nothing is written back to
// device memory but ct. What is left is K3<inc, boundary>'s per-step work
// plus up to one recomputed forward cell a cell ((W - 2) / W of them, and
// the halo's (W - 2) / 32 more), each with an increment read. At f > 32
// (dyadic order 6 and up) a base row spans warps and the in-order collapse
// cannot run in flight, and a window of more than 34 diagonals would need a
// halo wider than a warp: such shapes take the one-block kernel, within the
// row bound its ring of three diagonals in shared memory sets.
//
// The one-block kernel's window. One diagonal is R + 1 values: 32.7 KB in
// double at R = 4,092 (length 1024, dyadic 2). Shared memory (227 KB a
// block) holds the ring of three (98 KB) and three more diagonals at most,
// and a second block per SM would be gone. So the window is a per-block
// scratch in device memory, W x (R + 1) values allocated by the wrapper,
// written and read by the same block within W diagonals of the walk. The
// scratch pointer is neither const nor __restrict__: the block reads what
// it wrote, so the loads must not take the non-coherent read-only path. In
// exchange for the recompute, the stack K2-sparse writes and K8 reads is
// W / 2 times smaller than K2-stack's (67 MB a pair in double at R = C =
// 4,092 and W = 8, against 268 MB), so a chunk of pairs whose full stacks
// would not fit the stack budget in enough pairs to fill the card does.
#include "adjoint.cuh"
#include "band_sweep.cuh"

namespace sigkernel {

// The forward solution, window by window, from the sparse stack.
template <typename T, typename Inc>
struct CkptRows {
  const T* __restrict__ sparse;  // (2 ckpt_pairs, R + 1)
  T* scratch;                    // (W, R + 1), this block's
  const Inc& inc;
  int R, C, W;
  bool naive;

  __device__ const T* operator()(int p) const {
    const int stride = R + 1;
    const int e = p - p % W;  // the window's first diagonal
    if (p == R + C - 2 || p % W == W - 1) {
      __syncthreads();  // every product of the window above is done
      const T* pair = sparse + static_cast<int64_t>(2 * (e / W)) * stride;
      for (int i = threadIdx.x; i < 2 * stride; i += blockDim.x) {
        scratch[i] = pair[i];
      }
      __syncthreads();
      for (int k = 2; k <= p - e; ++k) {
        const int d = e + k;
        T* out = scratch + static_cast<int64_t>(k) * stride;
        const T* m1 = out - stride;
        const T* m2 = out - 2 * stride;
        const int lo = d - C > 1 ? d - C : 1;
        const int hi = d - 1 < R ? d - 1 : R;
        for (int i = threadIdx.x; i <= R; i += blockDim.x) {
          out[i] = i >= lo && i <= hi
                       ? scheme(m2[i - 1], m1[i - 1], m1[i],
                                inc(i - 1, d - i - 1), naive)
                       : edge<T>(i, d, C);
        }
        __syncthreads();
      }
    }
    return scratch + static_cast<int64_t>(p - e) * stride;
  }
};

template <typename T>
__global__ void adjoint_ckpt(const T* __restrict__ inc,
                             const T* __restrict__ sparse, T* scratch,
                             T* __restrict__ ct, int Mb, int Nb, int f,
                             int W, int transpose, int naive) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  const int64_t pair = blockIdx.x;
  const int64_t cells = static_cast<int64_t>(Mb) * Nb;
  const IncGrid<T> grid{inc + pair * cells, Nb, f, transpose,
                        T(1) / T(f * f)};
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  const CkptRows<T, IncGrid<T>> fwd{
      sparse + pair * sparse_elems(R, C, W),
      scratch + pair * static_cast<int64_t>(W) * (R + 1), grid, R, C, W,
      naive != 0};
  adjoint_body<T>(ring, R, C, f, naive != 0, grid, fwd, ct + pair * cells,
                  transpose, 0, R / f);
}

template <typename T>
int launch_adjoint_ckpt(const void* inc, const void* sparse, void* scratch,
                        void* ct, int64_t P, int Mb, int Nb, int f, int W,
                        int naive, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const size_t smem = 3 * static_cast<size_t>(R + 1) * sizeof(T);
  e = allow_smem(adjoint_ckpt<T>, smem);
  if (e != cudaSuccess) return e;
  adjoint_ckpt<T><<<static_cast<unsigned>(P), threads_for(R), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(inc), static_cast<const T*>(sparse),
      static_cast<T*>(scratch), static_cast<T*>(ct), Mb, Nb, f, W, transpose,
      naive);
  return cudaGetLastError();
}

template <typename T, int kF>
cudaError_t launch_ckpt_band(const void* inc, const void* sparse, void* ct,
                             void* scratch, void* counters, int64_t P,
                             int Mb, int Nb, int W, int nbands, int naive,
                             cudaStream_t stream) {
  using Src = CkptSource<T>;
  const size_t smem = ckpt_window_bytes<T>(W);
  cudaError_t e = allow_smem(band_stripe<T, kBandCkpt, kF, Src>, smem);
  if (e != cudaSuccess) return e;
  const int R = (Mb > Nb ? Nb : Mb) * kF;
  Src src{};
  src.inc = static_cast<const T*>(inc);
  src.W = W;
  band_stripe<T, kBandCkpt, kF, Src>
      <<<static_cast<unsigned>(P * nbands), kBandRows, smem, stream>>>(
          src, nullptr, nullptr, const_cast<T*>(static_cast<const T*>(sparse)),
          static_cast<T*>(scratch), static_cast<int*>(counters),
          static_cast<T*>(ct), P, nbands, Mb, Nb, kF, 0, R, 1, naive);
  return cudaGetLastError();
}

// K8 on the band kernel, one instance per f = 1 .. 32 (the collapse unrolls
// over a group's f lanes); f > 32, a window outside 2 .. 34 (its halo of W
// - 2 rows a lane each) and a grid of 2^31 blocks or more are refused.
template <typename T>
int launch_ckpt_band_f(const void* inc, const void* sparse, void* ct,
                       void* scratch, void* counters, int64_t P, int Mb,
                       int Nb, int f, int W, int nbands, int naive,
                       int device, void* stream) {
  if (W < 2 || W - 2 > 32 ||
      nbands != band_count((Mb > Nb ? Nb : Mb) * f) ||
      P * nbands >= (int64_t(1) << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  decltype(&launch_ckpt_band<T, 1>) launch =
      f == 1 ? &launch_ckpt_band<T, 1> : f == 2 ? &launch_ckpt_band<T, 2>
      : f == 4 ? &launch_ckpt_band<T, 4> : f == 8 ? &launch_ckpt_band<T, 8>
      : f == 16 ? &launch_ckpt_band<T, 16>
      : f == 32 ? &launch_ckpt_band<T, 32> : nullptr;
  if (launch == nullptr) return cudaErrorInvalidValue;
  return launch(inc, sparse, ct, scratch, counters, P, Mb, Nb, W, nbands,
                naive, static_cast<cudaStream_t>(stream));
}

}  // namespace sigkernel

extern "C" {

// inc: (P, Mb, Nb); sparse: (P, 2 ckpt_pairs(R, C, W), R + 1) from
// sk_inc_sparse_*; scratch: (P, W, R + 1), any contents; ct: (P, Mb, Nb),
// zeroed. R = min(Mb, Nb) f, C = max(Mb, Nb) f, W >= 2. The one-block
// kernel, for f > 32 or W > 34.
int sk_adjoint_ckpt_f32(const void* inc, const void* sparse, void* scratch,
                        void* ct, int64_t P, int Mb, int Nb, int f, int W,
                        int naive, int device, void* stream) {
  return sigkernel::launch_adjoint_ckpt<float>(inc, sparse, scratch, ct, P,
                                               Mb, Nb, f, W, naive, device,
                                               stream);
}

int sk_adjoint_ckpt_f64(const void* inc, const void* sparse, void* scratch,
                        void* ct, int64_t P, int Mb, int Nb, int f, int W,
                        int naive, int device, void* stream) {
  return sigkernel::launch_adjoint_ckpt<double>(inc, sparse, scratch, ct, P,
                                                Mb, Nb, f, W, naive, device,
                                                stream);
}

// K8 on the band-pipelined wavefront (f <= 32, 2 <= W <= 34): inc, sparse
// and ct as above; scratch: (P, nbands - 1, C + 1) values and counters: P *
// nbands + 1 zeroed ints, nbands = ceil(R / 128). Adds each base cell's
// unscaled sum into ct.
int sk_adjoint_ckpt_band_f32(const void* inc, const void* sparse, void* ct,
                             void* scratch, void* counters, int64_t P,
                             int Mb, int Nb, int f, int W, int nbands,
                             int naive, int device, void* stream) {
  return sigkernel::launch_ckpt_band_f<float>(inc, sparse, ct, scratch,
                                              counters, P, Mb, Nb, f, W,
                                              nbands, naive, device, stream);
}

int sk_adjoint_ckpt_band_f64(const void* inc, const void* sparse, void* ct,
                             void* scratch, void* counters, int64_t P,
                             int Mb, int Nb, int f, int W, int nbands,
                             int naive, int device, void* stream) {
  return sigkernel::launch_ckpt_band_f<double>(inc, sparse, ct, scratch,
                                               counters, P, Mb, Nb, f, W,
                                               nbands, naive, device, stream);
}

}  // extern "C"
