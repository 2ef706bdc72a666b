// The band-pipelined wavefront: one stripe of a refined grid swept by many
// blocks per pair, each sweep held in registers, with no block-wide barrier
// per diagonal. K7 (stripe_wavefront.cu) is its first user; wavefront.cuh's
// `sweep` (one block a pair, a barrier a diagonal) stays for K1, K2, K3, K5,
// K6 and K8.
//
// Decomposition. The stripe's rows 1 .. rows (row 0 is the north boundary
// bd) are cut into bands of kBandRows = 128 rows, one block of four warps a
// band, one row a lane: lane t of warp w in band b owns row i = 128 b +
// 32 w + t + 1. The last band may be short, and a warp whose rows all lie
// past `rows` returns at once. Blocks: P * ceil(rows / 128).
//
// Inside a warp. Lane t sweeps its row along the warp's skewed diagonals:
// at step s it computes column c = s - t, so the 32 lanes of one step lie on
// one anti-diagonal of the grid. It keeps the west value K[i][c-1] and the
// north-west K[i-1][c-1] in registers and takes the north K[i-1][c] from
// lane t - 1 by __shfl_up_sync (what lane t - 1 computed one step before);
// lane 0 takes it from the warp above through a hand-off (below). Each cell
// is scheme(K[i-1][c-1], K[i-1][c], K[i][c-1], u) with the operands and
// the op order of the plain sweep, so every value is bit-equal to it.
//
// Hand-offs carry a warp's last row to the warp below, in chunks of kChunk =
// 32 columns (one value a lane of the consumer), each published by a
// counter that the producing lane raises after a fence:
//   - between the warps of a block, a ring of kRingChunks chunks in shared
//     memory; the consumer raises `consumed` after it loaded a chunk, and
//     the producer waits on it before it overwrites a slot (back-pressure;
//     safe, as the warps of one block are resident together);
//   - between bands, a whole row in global scratch, (P, nbands - 1, C + 1),
//     and one progress counter per (pair, band); no back-pressure, so a band
//     never waits on one below it;
//   - band 0's first warp reads bd, which is ready; the warp holding row
//     `rows` writes the stripe's bottom row (bottom[0] = 1, the west
//     corner).
// The consumer polls with volatile loads and __nanosleep, fences, and reads
// the values with volatile loads (never __ldg: the read-only path may hold a
// stale line).
//
// Forward progress whatever the scheduler does. Each block takes a ticket
// (atomicAdd on a counter the wrapper zeroes before every launch) and maps
// it band-major, band = t / P, pair = t % P, so the band it waits on holds a
// smaller ticket: its block has started and waits only on smaller tickets
// in turn. blockIdx is not used, so nothing assumes the order in which
// blocks start, and any number of blocks (more than are resident) is safe.
//
// Increments. Lane t reads its row's base value once per base cell and
// keeps it for the f refined columns of that cell, with the next one
// prefetched into a register: StripeGrid's arithmetic (zero past the
// frame's R rows, both axes reversed with flip, transposed when Mb > Nb),
// exact 1 / f^2 scaling.
//
// The stack (kStack) is K2-stack's layout for the stripe: stack[p (rows +
// 1) + i] = K[i][p - i], written in full. The lanes of one step share the
// diagonal p = i + c, so their stores are neighbouring addresses. Each
// warp also writes its rows' fixed entries (0 before column 0, 1 at it, 0
// past column C), and band 0's first warp row 0 (bd, then 0).
#pragma once

#include "wavefront.cuh"

namespace sigkernel {

constexpr int kBandWarps = 4;
constexpr int kBandRows = 32 * kBandWarps;
constexpr int kChunk = 32;
constexpr int kRingChunks = 8;
constexpr int kRing = kChunk * kRingChunks;
constexpr unsigned kFullMask = 0xffffffffu;

template <typename T>
struct BandShared {
  T ring[kBandWarps - 1][kRing];
  int ready[kBandWarps - 1];     // chunks warp w has published to warp w + 1
  int consumed[kBandWarps - 1];  // chunks warp w + 1 has loaded
  int ticket;
};

// A hand-off that never comes (a broken kernel, not a slow one: the longest
// real wait is the pipeline's fill, well under a millisecond) traps after
// about 2^34 cycles (~9 s at 1.98 GHz), so the launch fails and the wrapper
// raises instead of the card hanging.
constexpr long long kWaitCycles = 1ll << 34;

__device__ __forceinline__ void wait_for(const volatile int* counter,
                                         int at_least) {
  if (*counter >= at_least) return;
  const long long t0 = clock64();
  while (*counter < at_least) {
    __nanosleep(64);
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

inline int band_count(int rows) { return (rows + kBandRows - 1) / kBandRows; }

// Sweep one stripe (see above). inc: the pairs' base grids (P, Mb, Nb); bd,
// bottom: (P, C + 1); stack: (P, rows + C + 1, rows + 1) with kStack;
// scratch: (P, nbands - 1, C + 1); counters: P * nbands progress counters
// then the ticket, all zero at launch.
template <typename T, bool kStack>
__global__ void __launch_bounds__(kBandRows)
band_stripe(const T* __restrict__ inc, const T* __restrict__ bd,
            T* __restrict__ bottom, T* __restrict__ stack, T* scratch,
            int* counters, int64_t P, int nbands, int Mb, int Nb, int f,
            int row0, int rows, int flip, int naive) {
  __shared__ BandShared<T> sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kBandWarps - 1) {
    sh.ready[threadIdx.x] = 0;
    sh.consumed[threadIdx.x] = 0;
  }
  if (threadIdx.x == 0) sh.ticket = atomicAdd(counters + P * nbands, 1);
  __syncthreads();  // the only block-wide barrier
  const int64_t ticket = sh.ticket;
  const int band = static_cast<int>(ticket / P);
  const int64_t pair = ticket % P;
  const int i0 = band * kBandRows + warp * 32 + 1;  // the warp's first row
  if (i0 > rows) return;  // past the stripe: nobody waits on this warp

  const int transpose = Mb > Nb;
  const int R = (transpose ? Nb : Mb) * f;
  const int C = (transpose ? Mb : Nb) * f;
  const int Cb = C / f;
  const int i = i0 + lane;
  const bool live = i <= rows;
  const T* bd_p = bd + pair * (C + 1);

  // this row's base increments, in the order the sweep meets them
  const T* g = inc + pair * static_cast<int64_t>(Mb) * Nb;
  int r = flip ? rows - i : i - 1;
  r += row0;
  const bool has_inc = live && r < R;
  const int ra = has_inc ? r / f : 0;
  const T scale = T(1) / T(f * f);
  auto base = [&](int q) -> T {
    if (!has_inc || q >= Cb) return T(0);
    const int cb = flip ? Cb - 1 - q : q;
    const int64_t at = transpose ? static_cast<int64_t>(cb) * Nb + ra
                                 : static_cast<int64_t>(ra) * Nb + cb;
    return __ldg(g + at) * scale;
  };

  // where the north values come from: bd, the ring of the warp above, or
  // the global row of the band above
  const volatile T* src;
  const volatile int* src_ready = nullptr;
  bool src_ring = false;
  if (warp > 0) {
    src = sh.ring[warp - 1];
    src_ready = sh.ready + warp - 1;
    src_ring = true;
  } else if (band > 0) {
    src = scratch + (pair * (nbands - 1) + band - 1) * (C + 1);
    src_ready = counters + pair * nbands + band - 1;
  } else {
    src = bd_p;
  }
  // where this warp's last row goes: the bottom row, the ring, the global row
  const int bottom_lane = rows - i0 < 32 ? rows - i0 : -1;
  const int out_lane = bottom_lane >= 0 ? bottom_lane : 31;
  const bool out_ring = bottom_lane < 0 && warp < kBandWarps - 1;
  T* out = bottom_lane >= 0 ? bottom + pair * (C + 1)
           : out_ring ? nullptr
                      : scratch + (pair * (nbands - 1) + band) * (C + 1);
  int* out_ready = bottom_lane >= 0 || out_ring
                       ? nullptr : counters + pair * nbands + band;
  if (lane == bottom_lane) out[0] = T(1);

  T* stk = kStack ? stack + pair * stack_elems(rows, C) : nullptr;
  const int64_t stride = rows + 1;
  if constexpr (kStack) {
    for (int p = 0; p <= i0 + 31; ++p) {  // left of and at column 0
      if (live && p <= i) stk[p * stride + i] = p == i ? T(1) : T(0);
    }
    for (int p = i0 + C + 1; p <= rows + C; ++p) {  // past column C
      if (live && p > i + C) stk[p * stride + i] = T(0);
    }
    if (band == 0 && warp == 0) {
      for (int p = lane; p <= rows + C; p += 32) {
        stk[p * stride] = p <= C ? bd_p[p] : T(0);
      }
    }
  }

  T cur = T(1);                         // K[i][c - 1]; column 0 is 1
  T nw = i == 1 ? bd_p[0] : T(1);       // K[i - 1][c - 1] (lane 0's start)
  T up = T(0);                          // lane j: north of column s + j
  T u = base(0), u_next = base(1);
  int q = 0, m = 0;                     // base column, refined within it
  for (int s = 1; s <= C + 31; ++s) {
    const int j = (s - 1) & (kChunk - 1);
    if (j == 0 && s <= C) {  // uniform: the next chunk of north values
      const int k = (s - 1) / kChunk;
      if (src_ready != nullptr) {
        wait_for(src_ready, k + 1);
        if (src_ring) __threadfence_block(); else __threadfence();
      }
      const int c = s + lane;
      up = c <= C ? (src_ring ? src[(c - 1) & (kRing - 1)] : src[c]) : T(0);
      if (src_ring) {
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          *(volatile int*)(sh.consumed + warp - 1) = k + 1;
        }
      }
    }
    const T from_up = __shfl_sync(kFullMask, up, j);
    T n = __shfl_up_sync(kFullMask, cur, 1);
    if (lane == 0) n = from_up;
    const int c = s - lane;
    if (c >= 1 && c <= C) {
      const T v = scheme(nw, n, cur, u, naive != 0);
      cur = v;
      if (++m == f) {
        m = 0;
        ++q;
        u = u_next;
        u_next = base(q + 1);
      }
      if constexpr (kStack) {
        if (live) stk[static_cast<int64_t>(i + c) * stride + i] = v;
      }
      if (lane == out_lane) {
        const int k = (c - 1) / kChunk;
        const bool last = (c & (kChunk - 1)) == 0 || c == C;
        if (out_ring) {
          volatile T* ring = sh.ring[warp];
          if (((c - 1) & (kChunk - 1)) == 0 && k >= kRingChunks) {
            wait_for(sh.consumed + warp, k - kRingChunks + 1);
          }
          ring[(c - 1) & (kRing - 1)] = v;
          if (last) {
            __threadfence_block();
            *(volatile int*)(sh.ready + warp) = k + 1;
          }
        } else {
          *(volatile T*)(out + c) = v;
          if (last && out_ready != nullptr) {
            __threadfence();
            *(volatile int*)out_ready = k + 1;
          }
        }
      }
    }
    nw = n;
  }
}

}  // namespace sigkernel
