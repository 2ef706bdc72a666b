// K8: the adjoint over a base increment grid from a SPARSE forward stack,
// the skipped forward diagonals recomputed in-kernel; one block per pair.
//
// Replaces the TPU kernel
//   sigkernel_tpu/ops/pallas_adjoint.py::_product_ckpt_kernel
// (f32 there, with an f32 recompute; here one template serves float and
// double). Its forward is K2-sparse (inc_wavefront.cu), which keeps only
// the diagonal pairs (w W, w W + 1) of the full stack (wavefront.cuh).
//
// What it computes: K3<inc>'s reverse sweep, product and collapse
// (adjoint.cuh), with the forward diagonal p taken from a window buffer
// instead of the full stack. When the descending walk over p enters window
// w (diagonals w W .. w W + W - 1), the block copies the stored pair into
// the buffer's rows 0 and 1 and recomputes rows 2 .. (top of the window) -
// w W from the increment grid, one diagonal per barrier, every cell in the
// forward's op order (the same scheme on the same three neighbours and the
// same increment), so each recomputed diagonal is the forward's bit for bit
// and K8's cotangent equals K3<inc>'s bit for bit. The walk then reads the
// buffer's rows in descending order.
//
// Where the window lives. One diagonal is R + 1 values: 32.7 KB in double
// at R = 4,092 (length 1024, dyadic 2). Shared memory (227 KB a block)
// holds the ring of three (98 KB) and three more diagonals at most, and a
// second block per SM would be gone. So the window is a per-block scratch
// in device memory, W x (R + 1) values allocated by the wrapper, written
// and read by the same block within W diagonals of the walk. At W = 8 one
// wave of 132 blocks touches 132 x 8 x 32.7 KB = 34.5 MB, inside the 50 MB
// L2. The scratch pointer is neither const nor __restrict__: the block
// reads what it wrote, so the loads must not take the non-coherent
// read-only path.
//
// What bounds it on the H100: as K3<inc>, a barrier per reverse diagonal
// plus the product and collapse, and on top the recompute: one more
// forward sweep of arithmetic and W - 2 barriers per window. In exchange the
// stack K2-sparse writes and K8 reads is W / 2 times smaller than K2-stack's
// (67 MB a pair in double at R = C = 4,092 and W = 8, against 268 MB), so a
// chunk of pairs whose full stacks would not fit the stack budget in
// enough pairs to fill the card does.
#include "adjoint.cuh"

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

}  // namespace sigkernel

extern "C" {

// inc: (P, Mb, Nb); sparse: (P, 2 ckpt_pairs(R, C, W), R + 1) from
// sk_inc_sparse_*; scratch: (P, W, R + 1), any contents; ct: (P, Mb, Nb),
// zeroed. R = min(Mb, Nb) f, C = max(Mb, Nb) f, W >= 2.
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

}  // extern "C"
