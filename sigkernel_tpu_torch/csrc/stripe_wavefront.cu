// K7: one stripe of a refined grid too tall for one block, swept from a
// north boundary row by the band-pipelined wavefront (band_sweep.cuh): many
// blocks a pair.
//
// Replaces the TPU kernels
//   sigkernel_tpu/ops/pallas_blocked.py::_stripe_kernel       (bottom row)
//   sigkernel_tpu/ops/pallas_blocked.py::_stripe_kernel_df    (its df twin)
//   sigkernel_tpu/ops/pallas_blocked.py::_stripe_kernel_grid  (K7-stack)
//   sigkernel_tpu/ops/pallas_blocked.py::_stripe_kernel_grid_df
// The df (hi/lo f32) kernels existed for a chip without f64; here they are
// the double instance of one template.
//
// What it computes. K2's recurrence over refined rows row0 .. row0 + rows -
// 1 of the pair's solve frame (rows: the shorter refined side, so a stripe
// spans all C columns), with row 0 taken from the north boundary bd (P, C +
// 1), the bottom row of the stripe above, and the stripe's own bottom row
// written to bottom (P, C + 1). The increments are the pair's base grid (P,
// Mb, Nb), refined by an index shift and the exact 1 / f^2 as in K2, zero
// past the frame's rows (the striped adjoint pads the last stripe with zero
// rows, which copy rows exactly), and with flip reversed along both axes
// (the reverse problem's stripe, which the striped adjoint needs, read from
// the forward grid). Stripes of one pair run one launch after another on one
// stream: stripe s needs stripe s - 1's bottom row.
//
// K7-stack also writes the stripe's stack (rows + C + 1, rows + 1) in
// K2-stack's layout, row 0 holding bd, for the striped adjoint's product
// (adjoint_collapse.cu, the boundary instance).
//
// What bounds it on the H100. The sweep has rows x C cells whose chain of
// dependences is one anti-diagonal deep per step, so one block a pair (the
// earlier design: 16 blocks on 132 SMs for 16 pairs, a barrier a diagonal)
// ran at ~680x its bound. Here a pair is ceil(rows / 128) bands, one block
// each (2,432 blocks for 16 pairs at 19,368 rows), each warp's 32 rows pipelined
// one step behind the warp above, so the card is full and no barrier sits
// on a diagonal; what is left is the per-cell arithmetic and shuffles,
// bound by instruction throughput over the resident warps, and by the
// latency of each warp's increment reads, plus the pipeline's fill of one
// chunk of 32 columns a warp. The kernel holds nothing of the stripe in
// shared memory, so no row count bounds it; the global scratch (one row of C
// + 1 values a band) and the stack bound the memory. The stripe heights
// stay as the routes set them (cuda_blocked.stripe_rows, adjoint_rows).
#include "band_sweep.cuh"

namespace sigkernel {

template <typename T, int kMode>
int launch_stripe(const void* inc, const void* bd, void* bottom, void* stack,
                  void* scratch, void* counters, int64_t P, int Mb, int Nb,
                  int f, int row0, int rows, int nbands, int flip, int naive,
                  int device, void* stream) {
  if (nbands != band_count(rows) || P * nbands >= (int64_t(1) << 31)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  band_stripe<T, kMode><<<static_cast<unsigned>(P * nbands), kBandRows, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      GridSource<T>{static_cast<const T*>(inc)}, static_cast<const T*>(bd),
      static_cast<T*>(bottom), static_cast<T*>(stack),
      static_cast<T*>(scratch), static_cast<int*>(counters), nullptr, P,
      nbands, Mb, Nb, f, row0, rows, flip, naive);
  return cudaGetLastError();
}

}  // namespace sigkernel

extern "C" {

// inc: (P, Mb, Nb); bd, bottom: (P, C + 1) with C = max(Mb, Nb) f; the
// stripe is refined frame rows row0 .. row0 + rows - 1 (row0 a multiple of
// f); stack (K7-stack only): (P, rows + C + 1, rows + 1); scratch: (P,
// nbands - 1, C + 1) values; counters: P * nbands + 1 zeroed ints; nbands =
// ceil(rows / 128).
int sk_stripe_f32(const void* inc, const void* bd, void* bottom,
                  void* scratch, void* counters, int64_t P, int Mb, int Nb,
                  int f, int row0, int rows, int nbands, int flip, int naive,
                  int device, void* stream) {
  return sigkernel::launch_stripe<float, sigkernel::kBandBottom>(
      inc, bd, bottom, nullptr, scratch, counters, P, Mb, Nb, f, row0, rows,
      nbands, flip, naive, device, stream);
}

int sk_stripe_f64(const void* inc, const void* bd, void* bottom,
                  void* scratch, void* counters, int64_t P, int Mb, int Nb,
                  int f, int row0, int rows, int nbands, int flip, int naive,
                  int device, void* stream) {
  return sigkernel::launch_stripe<double, sigkernel::kBandBottom>(
      inc, bd, bottom, nullptr, scratch, counters, P, Mb, Nb, f, row0, rows,
      nbands, flip, naive, device, stream);
}

int sk_stripe_stack_f32(const void* inc, const void* bd, void* bottom,
                        void* stack, void* scratch, void* counters, int64_t P,
                        int Mb, int Nb, int f, int row0, int rows, int nbands,
                        int flip, int naive, int device, void* stream) {
  return sigkernel::launch_stripe<float, sigkernel::kBandStack>(
      inc, bd, bottom, stack, scratch, counters, P, Mb, Nb, f, row0, rows,
      nbands, flip, naive, device, stream);
}

int sk_stripe_stack_f64(const void* inc, const void* bd, void* bottom,
                        void* stack, void* scratch, void* counters, int64_t P,
                        int Mb, int Nb, int f, int row0, int rows, int nbands,
                        int flip, int naive, int device, void* stream) {
  return sigkernel::launch_stripe<double, sigkernel::kBandStack>(
      inc, bd, bottom, stack, scratch, counters, P, Mb, Nb, f, row0, rows,
      nbands, flip, naive, device, stream);
}

}  // extern "C"
