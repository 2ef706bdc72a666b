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
// (sigkernel_tpu/ops/df_prep.py::rbf_dd_vjp, pairwise layout.) The kernels
// write the per-pair dx, dy and d sigma; the wrapper scatters dx, dy onto X
// and Y over ii, jj.
//
// What bounds it on the H100: by the bytes, reading ct once (P (M-1)(N-1)
// values); in fact the instructions each cell takes: its exact division
// and exp (about 60 double operations a cell in all, ~125 instructions),
// which W must keep to stay bit for bit the plain version's. The TPU kernel
// reads ct once and keeps the dd-transpose, the distances and W out of
// HBM; so does this one, in registers, in one pass over the cells:
// - One block of kVjpWarps warps a (pair, band of H rows). A lane owns kC
//   columns of a chunk of the band (column chunk + warp 32 kC + k 32 +
//   lane), so a warp's loads of a row are 32 neighbouring values, and walks
//   the band's rows down, carrying ct's north and north-west values from
//   the row above in registers and taking the west one from its neighbour
//   lane (__shfl_sync; lane 0 from lane 31 of the 32 columns to the left,
//   or for the warp's first column the halo it loads itself). The band's
//   first row loads its north halo. The rows are copied by cp.async into a
//   ring in shared memory kVjpStages rows ahead, no registers held while
//   in flight. With kC = 4 a row's fixed costs (its loads, the shuffles,
//   the reduce-scatter below, the x point) are spread over 4 cells a lane.
// - Each W is computed once, in the earlier kernel's expression and op
//   order (sqdist's, sk_exp, non-contracted add/sub/mul): W is bit for bit
//   that kernel's and the plain version's; only the order of the sums
//   differs from theirs, and it is fixed:
//   * a lane's column sums (colsum W, sum_m W x_m) and its E * D stay in
//     registers over the band, serial in m;
//   * a row's sums (rowsum W, sum_n W y_n): a lane's kC columns serially,
//     then the warp's lanes by the pairs of a halving tree (lanes l and l ^
//     16, then l ^ 8, ... l ^ 1), as a reduce-scatter: each lane trades
//     half of what it holds a level, so the D + 1 sums of a row cost about
//     D + 4 shuffles, not 5 (D + 1); then the warps in order and the chunks
//     in order, in shared memory. A block owns its band's rows across all
//     N columns, so it writes their dx itself.
//   * across blocks, no atomics: each band writes its column partials to a
//     scratch (pairs, bands, D + 1, N) and its E * D to es (pairs, bands +
//     1); rbf_dd_vjp_combine adds the bands in order, forms dy and the
//     pair's E * D, and rbf_dd_vjp_sigma adds the pairs (a lane its pairs
//     in order, then the halving tree over the warp). Two
//     launches on one input are equal bit for bit, and
//     ops/incvjp.py::rbf_dd_vjp_pairs_tiled_plain emulates this order.
// - D <= kVjpRegD: the y points, their norms and the sums live in
//   registers, one instance a D. Past it, any D (rbf_dd_vjp_wide): a lane
//   owns one column, the band's W (each computed once) goes to shared
//   memory, and the products over D run from there in chunks of kVjpRegD
//   dims, x_m and y_n read through __ldg, in the same summation order.
// No bound on D: the wide kernel's shared memory is H (kVjpThreads + 1)
// values, and the wrapper halves H until it fits.
#include "band_sweep.cuh"
#include "rbf_gen.cuh"

namespace sigkernel {

constexpr int kVjpWarps = 8;
constexpr int kVjpThreads = 32 * kVjpWarps;
constexpr int kVjpRegD = 8;     // the widest D held in registers
constexpr int kVjpStages = 4;   // rows of ct in flight a warp
constexpr unsigned kVjpFull = 0xffffffffu;

// columns a lane owns in a chunk: 4 with registers (the row's overhead, its
// loads, shuffles and reduce-scatter, spread over 4 cells), 1 in the wide
// kernel
template <int kD>
__host__ __device__ constexpr int vjp_lane_cols() { return kD > 0 ? 4 : 1; }

// the smallest power of 2 >= v, and the log2 of a power of 2
__host__ __device__ constexpr int vjp_pow2(int v) {
  return v <= 1 ? 1 : 2 * vjp_pow2((v + 1) / 2);
}
__host__ __device__ constexpr int vjp_log2(int v) {
  return v <= 1 ? 0 : 1 + vjp_log2(v / 2);
}

// One value from global to shared memory by cp.async, or a 0 (no read)
// where ok is false: ct's zero padding.
template <typename T>
__device__ __forceinline__ void copy_async_or_zero(T* dst, const T* src,
                                                   bool ok) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(to), "l"(src), "n"(sizeof(T)),
                  "r"(ok ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

// One row of ct as a warp holds it: a lane's kC values c[a, n_k], and
// lane 0's halo c[a, n_0 - 1] (n_0: the warp's first column).
template <typename T, int kC>
struct CtRow {
  T v[kC];
  T halo;

  // the west neighbours c[a, n_k - 1]: lane l - 1's value; lane 0 takes
  // lane 31's of k - 1 (which the rotation of k - 1 handed it), or the halo
  __device__ __forceinline__ void west(T (&w)[kC], int lane) const {
    T prev = halo;
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const T rot = __shfl_sync(kVjpFull, v[k], (lane + 31) & 31);
      w[k] = lane ? rot : prev;
      prev = rot;
    }
  }
};

// A warp's rows of ct, kVjpStages rows ahead of the one it computes,
// copied by cp.async into its ring in shared memory (no registers held
// while in flight; zero outside ct's (Mb, Nb) grid): a slot holds a row's
// kC values a lane (column n_0 + k 32 + lane) and lane 0's halo. Each lane
// copies and reads only its own values, so no barrier; a slot is refilled
// after its row's values have been used.
template <typename T, int kC>
struct CtRing {
  static constexpr int kSlot = 32 * kC + 1;
  T* ring;  // [kVjpStages][kSlot]
  const T* c;
  int Mb, Nb, n0, lane;

  // row a into slot s, unless a >= end; one commit group either way
  __device__ __forceinline__ void fetch(int a, int s, int end) const {
    if (a < end) {
      T* to = ring + s * kSlot;
      const bool row = a >= 0 && a < Mb;
      const T* from = c + static_cast<int64_t>(row ? a : 0) * Nb;
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int b = n0 + k * 32 + lane;
        const bool ok = row && b < Nb;
        copy_async_or_zero(to + k * 32 + lane, ok ? from + b : c, ok);
      }
      if (lane == 0) {
        const bool ok = row && n0 > 0 && n0 - 1 < Nb;
        copy_async_or_zero(to + 32 * kC, ok ? from + n0 - 1 : c, ok);
      }
    }
    commit_async();
  }

  // the row in slot s, once its copies have landed
  __device__ __forceinline__ CtRow<T, kC> take(int s) const {
    wait_async<kVjpStages - 1>();
    const T* at = ring + s * kSlot;
    CtRow<T, kC> r;
#pragma unroll
    for (int k = 0; k < kC; ++k) r.v[k] = at[k * 32 + lane];
    r.halo = lane == 0 ? at[32 * kC] : T(0);
    return r;
  }

  // the kVjpStages rows from m0 - 1 (the north halo) on, up to end
  __device__ __forceinline__ void start(int m0, int end) const {
#pragma unroll 1
    for (int s = 0; s < kVjpStages; ++s) fetch(m0 - 1 + s, s, end);
  }
};

// One cell's W and E * D from ct's four values around it, the squared
// norms and the dot product of its two points: ((c + c_nw) - c_w) - c_n,
// the op order of double_difference over the zero-padded ct, and sqdist's
// (sx + sy) - 2 dot.
template <typename T>
struct VjpCell {
  T W, ED;
};

template <typename T>
__device__ __forceinline__ VjpCell<T> vjp_cell(T c, T c_nw, T c_w, T c_n,
                                               T sx, T sy, T dot, T sigma,
                                               T neg_inv_sigma) {
  const T dG = sub(sub(add(c, c_nw), c_w), c_n);
  const T dist = sub(add(sx, sy), mul(T(2), dot));
  const T G = sk_exp(-dist / sigma);
  const T E = mul(dG, G);
  return {mul(E, neg_inv_sigma), mul(E, dist)};
}

// The warp's sums of V values (V a power of 2) by the pairs of a halving
// tree, lanes l and l ^ S for S = 16, 8, ..., 1. While a lane holds n > 1
// values it keeps one half (the upper one where its bit S is set) and
// trades the other for its partner's copy of the kept half; holding one, it
// adds its partner's. Value i's sum ends on the lanes whose top log2(V)
// bits read i, in v[0], in the same tree as a butterfly of value i alone
// (IEEE addition commutes).
template <int kN, int kS, typename T, int V>
__device__ __forceinline__ void vjp_scatter(T (&v)[V], int lane) {
  if constexpr (kS > 0) {
    if constexpr (kN > 1) {
      constexpr int h = kN / 2;
      const bool up = lane & kS;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const T send = up ? v[i] : v[i + h];
        const T keep = up ? v[i + h] : v[i];
        v[i] = add(keep, __shfl_xor_sync(kVjpFull, send, kS));
      }
      vjp_scatter<h, kS / 2>(v, lane);
    } else {
      v[0] = add(v[0], __shfl_xor_sync(kVjpFull, v[0], kS));
      vjp_scatter<1, kS / 2>(v, lane);
    }
  }
}

template <typename T>
__device__ __forceinline__ T vjp_warp_sum(T v) {
  T a[1] = {v};
  vjp_scatter<1, 16>(a, 0);
  return a[0];
}

// The block's E * D: each lane's, the halving tree over the warp, the warps
// in order; written by thread 0.
template <typename T>
__device__ __forceinline__ void vjp_band_es(T es, T* esw, T* out) {
  es = vjp_warp_sum(es);
  if ((threadIdx.x & 31) == 0) esw[threadIdx.x >> 5] = es;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = T(0);
    for (int w = 0; w < kVjpWarps; ++w) t = add(t, esw[w]);
    *out = t;
  }
}

// D = kD <= kVjpRegD. Shared memory: rowpart [H][warps][kD + 1] (a warp's
// row sums: rowsum, then sum_n W y_n), rowacc [H][kD + 1] (the band's, over
// the chunks so far), esw [warps], then the warps' CtRings. Two blocks an
// SM up to kD = 4 (at most 128 registers a thread); wider, the registers
// are left to the compiler.
template <typename T, int kD>
__global__ void __launch_bounds__(kVjpThreads, kD <= 4 ? 2 : 1)
rbf_dd_vjp_band(const T* __restrict__ X, const T* __restrict__ Y,
                const int64_t* __restrict__ ii,
                const int64_t* __restrict__ jj, const T* __restrict__ ct,
                T* __restrict__ dx, T* __restrict__ part, T* __restrict__ es,
                int M, int N, int D, int H, int nb, T sigma) {
  constexpr int kC = vjp_lane_cols<kD>();
  constexpr int kSpan = 32 * kC, kCols = kSpan * kVjpWarps;
  constexpr int kV = vjp_pow2(kD + 1), kL = vjp_log2(kV);
  constexpr int kR = kD + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* rowpart = reinterpret_cast<T*>(smem);
  T* rowacc = rowpart + static_cast<int64_t>(H) * kVjpWarps * kR;
  T* esw = rowacc + static_cast<int64_t>(H) * kR;
  T* rings = esw + kVjpWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p = blockIdx.x / nb;
  const int b = static_cast<int>(blockIdx.x % nb);
  const int m0 = b * H, m1 = min(M, m0 + H), rows = m1 - m0;
  const int Mb = M - 1, Nb = N - 1;
  const T* x = X + ii[p] * M * kD;
  const T* y = Y + jj[p] * N * kD;
  const T* c = ct + p * Mb * Nb;
  const T neg_inv_sigma = T(-1) / sigma;
  T es_lane = T(0);
  for (int nc = 0; nc < N; nc += kCols) {
    int n[kC];
    T yv[kC][kD], sy[kC], cs[kC], cx[kC][kD];
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      n[k] = nc + warp * kSpan + k * 32 + lane;
      sy[k] = T(0);
      cs[k] = T(0);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        yv[k][d] = n[k] < N ? __ldg(y + static_cast<int64_t>(n[k]) * kD + d)
                            : T(0);
        sy[k] = add(sy[k], mul(yv[k][d], yv[k][d]));
        cx[k][d] = T(0);
      }
    }
    using Ring = CtRing<T, kC>;
    const Ring ring{rings + warp * kVjpStages * Ring::kSlot, c, Mb, Nb,
                    n[0] - lane, lane};
    ring.start(m0, m1);
    T cn[kC], cnw[kC];  // ct north and north-west of the row being computed
    {
      const CtRow<T, kC> north = ring.take(0);
      north.west(cnw, lane);
#pragma unroll
      for (int k = 0; k < kC; ++k) cn[k] = north.v[k];
      ring.fetch(m0 - 1 + kVjpStages, 0, m1);
    }
    for (int m = m0, slot = 1; m < m1; ++m) {
      const CtRow<T, kC> here = ring.take(slot);
      T cw[kC];
      here.west(cw, lane);
      T xm[kD], sx = T(0);
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        xm[d] = __ldg(x + static_cast<int64_t>(m) * kD + d);
        sx = add(sx, mul(xm[d], xm[d]));
      }
      T v[kV];  // the lane's row sums: rowsum, then sum_n W y_n
#pragma unroll
      for (int i = 0; i < kV; ++i) v[i] = T(0);
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        T dot = T(0);
#pragma unroll
        for (int d = 0; d < kD; ++d) dot = add(dot, mul(xm[d], yv[k][d]));
        const VjpCell<T> e = vjp_cell(here.v[k], cnw[k], cw[k], cn[k], sx,
                                      sy[k], dot, sigma, neg_inv_sigma);
        cs[k] = add(cs[k], e.W);
        es_lane = add(es_lane, e.ED);
        v[0] = add(v[0], e.W);
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          cx[k][d] = add(cx[k][d], mul(e.W, xm[d]));
          v[1 + d] = add(v[1 + d], mul(e.W, yv[k][d]));
        }
        cn[k] = here.v[k];
        cnw[k] = cw[k];
      }
      ring.fetch(m + kVjpStages, slot, m1);
      slot = slot + 1 == kVjpStages ? 0 : slot + 1;
      vjp_scatter<kV, 16>(v, lane);
      const int i = lane >> (5 - kL);
      if ((lane & ((32 >> kL) - 1)) == 0 && i < kR) {
        rowpart[(static_cast<int64_t>(m - m0) * kVjpWarps + warp) * kR + i] =
            v[0];
      }
    }
    T* q = part + (p * nb + b) * kR * N;
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      if (n[k] < N) {
        q[n[k]] = cs[k];
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          q[static_cast<int64_t>(1 + d) * N + n[k]] = cx[k][d];
        }
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * kR; e += kVjpThreads) {
      const int r = e / kR, i = e % kR;
      T t = nc ? rowacc[e] : T(0);
      for (int w = 0; w < kVjpWarps; ++w) {
        t = add(t, rowpart[(r * kVjpWarps + w) * kR + i]);
      }
      rowacc[e] = t;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < rows * kD; e += kVjpThreads) {
    const int r = e / kD, d = e % kD;
    const int64_t at = static_cast<int64_t>(m0 + r) * kD + d;
    dx[p * M * kD + at] = mul(T(2), sub(mul(rowacc[r * kR], x[at]),
                                        rowacc[r * kR + 1 + d]));
  }
  vjp_band_es(es_lane, esw, es + p * (nb + 1) + b);
}

// Any D. Shared memory: Wt [H][kVjpThreads + 1] (the band's W of the
// chunk, a row padded by one value), rs [H] (the band's rowsum W), esw
// [warps], then the warps' CtRings; the sums sum_n W y_n gather in dx
// itself.
template <typename T>
__global__ void __launch_bounds__(kVjpThreads)
rbf_dd_vjp_wide(const T* __restrict__ X, const T* __restrict__ Y,
                const int64_t* __restrict__ ii,
                const int64_t* __restrict__ jj, const T* __restrict__ ct,
                T* __restrict__ dx, T* __restrict__ part, T* __restrict__ es,
                int M, int N, int D, int H, int nb, T sigma) {
  constexpr int kStride = kVjpThreads + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Wt = reinterpret_cast<T*>(smem);
  T* rs = Wt + static_cast<int64_t>(H) * kStride;
  T* esw = rs + H;
  T* rings = esw + kVjpWarps;
  const int lane = threadIdx.x & 31, col = threadIdx.x;
  const int64_t p = blockIdx.x / nb;
  const int b = static_cast<int>(blockIdx.x % nb);
  const int m0 = b * H, m1 = min(M, m0 + H), rows = m1 - m0;
  const int Mb = M - 1, Nb = N - 1, R = D + 1;
  const T* x = X + ii[p] * M * D;
  const T* y = Y + jj[p] * N * D;
  const T* c = ct + p * Mb * Nb;
  const T neg_inv_sigma = T(-1) / sigma;
  T* out = dx + p * M * D;
  T es_lane = T(0);
  for (int nc = 0; nc < N; nc += kVjpThreads) {
    const int n[1] = {nc + col};
    const bool valid = n[0] < N;
    const T* yn = y + static_cast<int64_t>(n[0]) * D;
    T sy = T(0), cs = T(0);
    if (valid) {
      for (int d = 0; d < D; ++d) {
        const T v = __ldg(yn + d);
        sy = add(sy, mul(v, v));
      }
    }
    using Ring = CtRing<T, 1>;
    const Ring ring{rings + (col >> 5) * kVjpStages * Ring::kSlot, c, Mb, Nb,
                    n[0] - lane, lane};
    ring.start(m0, m1);
    T cn[1], cnw[1];
    {
      const CtRow<T, 1> north = ring.take(0);
      north.west(cnw, lane);
      cn[0] = north.v[0];
      ring.fetch(m0 - 1 + kVjpStages, 0, m1);
    }
    for (int m = m0, slot = 1; m < m1; ++m) {
      const CtRow<T, 1> here = ring.take(slot);
      T cw[1];
      here.west(cw, lane);
      const T* xm = x + static_cast<int64_t>(m) * D;
      T sx = T(0), dot = T(0);
      for (int d = 0; d < D; ++d) {
        const T xv = __ldg(xm + d);
        sx = add(sx, mul(xv, xv));
        dot = add(dot, mul(xv, valid ? __ldg(yn + d) : T(0)));
      }
      const VjpCell<T> e = vjp_cell(here.v[0], cnw[0], cw[0], cn[0], sx, sy,
                                    dot, sigma, neg_inv_sigma);
      cs = add(cs, e.W);
      es_lane = add(es_lane, e.ED);
      Wt[(m - m0) * kStride + col] = e.W;
      cn[0] = here.v[0];
      cnw[0] = cw[0];
      ring.fetch(m + kVjpStages, slot, m1);
      slot = slot + 1 == kVjpStages ? 0 : slot + 1;
    }
    __syncthreads();
    // the column's sums over the band: colsum W, then sum_m W x_m,
    // kVjpRegD dims a pass, each serial in m
    T* q = part + (p * nb + b) * R * N + n[0];
    if (valid) q[0] = cs;
    for (int d0 = 0; d0 < D; d0 += kVjpRegD) {
      T acc[kVjpRegD];
#pragma unroll
      for (int j = 0; j < kVjpRegD; ++j) acc[j] = T(0);
      for (int r = 0; r < rows; ++r) {
        const T w = Wt[r * kStride + col];
        const T* xr = x + static_cast<int64_t>(m0 + r) * D + d0;
#pragma unroll
        for (int j = 0; j < kVjpRegD; ++j) {
          if (d0 + j < D) acc[j] = add(acc[j], mul(w, __ldg(xr + j)));
        }
      }
      if (valid) {
#pragma unroll
        for (int j = 0; j < kVjpRegD; ++j) {
          if (d0 + j < D) q[static_cast<int64_t>(1 + d0 + j) * N] = acc[j];
        }
      }
    }
    // the rows' sums, entry (r, i): i < D sum_n W y_n[i], i = D rowsum W;
    // in rbf_dd_vjp_band's order: a lane's column, the halving tree over
    // the warp's 32 lanes, the warps in order, the chunks in order
    for (int e = threadIdx.x; e < rows * R; e += kVjpThreads) {
      const int r = e / R, i = e % R;
      T* acc = i < D ? out + static_cast<int64_t>(m0 + r) * D + i : rs + r;
      T t = nc ? *acc : T(0);
      for (int w = 0; w < kVjpWarps; ++w) {
        T v[32];
#pragma unroll
        for (int l = 0; l < 32; ++l) {
          const int nn = nc + w * 32 + l;
          const T wv = Wt[r * kStride + w * 32 + l];
          const T yv = (i < D && nn < N)
                           ? __ldg(y + static_cast<int64_t>(nn) * D + i)
                           : T(0);
          v[l] = add(T(0), i < D ? mul(wv, yv) : wv);
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
          for (int l = 0; l < s; ++l) v[l] = add(v[l], v[l + s]);
        }
        t = add(t, v[0]);
      }
      *acc = t;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < rows * D; e += kVjpThreads) {
    const int r = e / D;
    const int64_t at = static_cast<int64_t>(m0) * D + e;
    out[at] = mul(T(2), sub(mul(rs[r], x[at]), out[at]));
  }
  vjp_band_es(es_lane, esw, es + p * (nb + 1) + b);
}

// dy and the pair's E * D: the bands' partials added in order. A thread a
// column n of a pair; the pair's first thread adds its bands' E * D into
// es[p, nb].
template <typename T>
__global__ void rbf_dd_vjp_combine(const T* __restrict__ Y,
                                   const int64_t* __restrict__ jj,
                                   const T* __restrict__ part,
                                   T* __restrict__ dy, T* __restrict__ es,
                                   int N, int D, int nb, int tiles) {
  const int64_t p = blockIdx.x / tiles;
  const int n = static_cast<int>(blockIdx.x % tiles) * blockDim.x +
                threadIdx.x;
  if (n == 0) {
    T t = T(0);
    for (int b = 0; b < nb; ++b) t = add(t, es[p * (nb + 1) + b]);
    es[p * (nb + 1) + nb] = t;
  }
  if (n >= N) return;
  const int64_t R = D + 1;
  const T* q = part + p * nb * R * N + n;
  const T* yn = Y + (jj[p] * N + n) * D;
  T cs = T(0);
  for (int b = 0; b < nb; ++b) cs = add(cs, q[b * R * N]);
  T* out = dy + (p * N + n) * D;
  for (int d = 0; d < D; ++d) {
    T acc = T(0);
    for (int b = 0; b < nb; ++b) acc = add(acc, q[(b * R + 1 + d) * N]);
    out[d] = mul(T(2), sub(mul(cs, yn[d]), acc));
  }
}

// d sigma = (the pairs' E * D) / sigma^2, one warp: lane l adds pairs l,
// l + 32, ... in order, then the halving tree over the lanes
template <typename T>
__global__ void rbf_dd_vjp_sigma(const T* __restrict__ es,
                                 T* __restrict__ out, int64_t P, int nb,
                                 T sigma) {
  T t = T(0);
  for (int64_t p = threadIdx.x; p < P; p += 32) {
    t = add(t, es[p * (nb + 1) + nb]);
  }
  t = vjp_warp_sum(t);
  if (threadIdx.x == 0) out[0] = t / mul(sigma, sigma);
}

template <typename T>
using VjpKernel = void (*)(const T*, const T*, const int64_t*,
                           const int64_t*, const T*, T*, T*, T*, int, int,
                           int, int, int, T);

template <typename T>
VjpKernel<T> vjp_kernel(int D) {
  switch (D) {
    case 1: return rbf_dd_vjp_band<T, 1>;
    case 2: return rbf_dd_vjp_band<T, 2>;
    case 3: return rbf_dd_vjp_band<T, 3>;
    case 4: return rbf_dd_vjp_band<T, 4>;
    case 5: return rbf_dd_vjp_band<T, 5>;
    case 6: return rbf_dd_vjp_band<T, 6>;
    case 7: return rbf_dd_vjp_band<T, 7>;
    case 8: return rbf_dd_vjp_band<T, 8>;
    default: return rbf_dd_vjp_wide<T>;
  }
}

// the main kernel's shared memory (ops/incvjp.py::_smem_bytes mirrors it)
template <typename T>
size_t vjp_smem(int D, int H) {
  const size_t h = static_cast<size_t>(H);
  const int lane_cols =
      D <= kVjpRegD ? vjp_lane_cols<1>() : vjp_lane_cols<0>();
  const size_t rings = kVjpWarps * kVjpStages * (32 * lane_cols + 1);
  if (D <= kVjpRegD) {
    return sizeof(T) * (h * (kVjpWarps + 1) * (D + 1) + kVjpWarps + rings);
  }
  return sizeof(T) * (h * (kVjpThreads + 1) + h + kVjpWarps + rings);
}

// Pairs in launches of `chunk` (part holds chunk pairs' partials): per
// launch the band kernel, then the combine; then d sigma over all P pairs.
template <typename T>
int launch_vjp(const void* X, const void* Y, const void* ii, const void* jj,
               const void* ct, void* dx, void* dy, void* part, void* es,
               void* dsigma, int64_t P, int M, int N, int D, double sigma,
               int H, int64_t chunk, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const VjpKernel<T> kernel = vjp_kernel<T>(D);
  const size_t smem = vjp_smem<T>(D, H);
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T sg = static_cast<T>(sigma);
  const int nb = (M + H - 1) / H;
  const int combine_threads = 128;
  const int tiles = (N + combine_threads - 1) / combine_threads;
  const int64_t cells = static_cast<int64_t>(M - 1) * (N - 1);
  for (int64_t p0 = 0; p0 < P; p0 += chunk) {
    const int64_t n = P - p0 < chunk ? P - p0 : chunk;
    const int64_t* i0 = static_cast<const int64_t*>(ii) + p0;
    const int64_t* j0 = static_cast<const int64_t*>(jj) + p0;
    T* es0 = static_cast<T*>(es) + p0 * (nb + 1);
    kernel<<<static_cast<unsigned>(n * nb), kVjpThreads, smem, s>>>(
        static_cast<const T*>(X), static_cast<const T*>(Y), i0, j0,
        static_cast<const T*>(ct) + p0 * cells,
        static_cast<T*>(dx) + p0 * M * D, static_cast<T*>(part), es0, M, N,
        D, H, nb, sg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    rbf_dd_vjp_combine<T><<<static_cast<unsigned>(n * tiles),
                            combine_threads, 0, s>>>(
        static_cast<const T*>(Y), j0, static_cast<const T*>(part),
        static_cast<T*>(dy) + p0 * N * D, es0, N, D, nb, tiles);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  rbf_dd_vjp_sigma<T><<<1, 32, 0, s>>>(static_cast<const T*>(es),
                                      static_cast<T*>(dsigma), P, nb, sg);
  return cudaGetLastError();
}

}  // namespace sigkernel

extern "C" {

// X (A, M, D), Y (B, N, D), ii/jj (P,) int64, ct (P, M-1, N-1); out: dx
// (P, M, D), dy (P, N, D), dsigma (1,); scratch: part (chunk, ceil(M / H),
// D + 1, N), es (P, ceil(M / H) + 1). H: the band's rows; chunk: pairs a
// launch.
int sk_rbf_dd_vjp_f32(const void* X, const void* Y, const void* ii,
                      const void* jj, const void* ct, void* dx, void* dy,
                      void* part, void* es, void* dsigma, int64_t P, int M,
                      int N, int D, double sigma, int H, int64_t chunk,
                      int device, void* stream) {
  return sigkernel::launch_vjp<float>(X, Y, ii, jj, ct, dx, dy, part, es,
                                      dsigma, P, M, N, D, sigma, H, chunk,
                                      device, stream);
}

int sk_rbf_dd_vjp_f64(const void* X, const void* Y, const void* ii,
                      const void* jj, const void* ct, void* dx, void* dy,
                      void* part, void* es, void* dsigma, int64_t P, int M,
                      int N, int D, double sigma, int H, int64_t chunk,
                      int device, void* stream) {
  return sigkernel::launch_vjp<double>(X, Y, ii, jj, ct, dx, dy, part, es,
                                       dsigma, P, M, N, D, sigma, H, chunk,
                                       device, stream);
}

}  // extern "C"
