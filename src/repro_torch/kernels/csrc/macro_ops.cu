// The four tile-DAG macro ops of tiled QR (GEQRT, LARFB, TSQRT, SSRFB) and
// the persistent megakernel that runs a whole schedule of them, as
// hand-written CUDA kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by repro_torch/kernels/macro_ops.py.
//
// Each macro op is a copy of the task's tiles into dynamic shared memory
// and one __device__ __noinline__ compute function (geqrt_compute, ...)
// that a CTA of kThreads threads runs there, writing its outputs back in
// place.  A wavefront kernel's carve-up is its operands then the compute's
// scratch; its size in elements is the op's MacroOp.smem_elems in
// macro_ops.py, which the launch passes.  The
// workspace is the (p, q, nb, nb) tile array, row-major inside a tile;
// d_t is (r, nb, nb), d_taus (r, nb), t_t (p, r, nb, nb), t_taus
// (p, r, nb) with r = min(p, q).  Two lowerings call the same bodies, so
// the same machine code computes every task and the two agree bitwise:
//
//  * wavefront kernels (geqrt_kernel, ...): one launch per (level, kind),
//    one CTA per task; task b reads its (k, i, j) from idx[3 b .. 3 b + 2],
//    an int32 array the engine uploads once per tile grid;
//  * the megakernel (megakernel_kernel, megakernel_batched_kernel): one
//    cooperative launch per factorization (or per stack of them) walks the
//    engine's task table level by level.  Each CTA takes a contiguous run
//    of the level's tasks — of every slice of the stack, in the batched
//    kernel — keeping reused tiles and prefetching the next task's, and a
//    grid-wide barrier separates the levels.
//
// The tasks of one level run concurrently in both lowerings.  Their writes
// are disjoint (asserted when the engine builds its index arrays and
// table), and no task reads what another task of its level writes, with
// one exception: LARFB(k, j) reads the strictly-lower V1 of the diagonal
// tile (k, k) while TSQRT(k, i) of the same level rewrites that tile.
// TSQRT therefore writes back only the diagonal tile's upper triangle
// (diagonal included) and never touches V1; no second barrier per level
// is needed.  Global loads go through L2 only (__ldcg) so that a tile
// written on another SM at an earlier level is never read stale from L1.
//
// The megakernel raises rather than degrades: a grid that cannot be
// resident at once (cudaLaunchCooperativeKernel refuses it) returns the
// CUDA error, and the wrapper raises.
//
// No tensor cores: an fp32 product there is TF32, which would miss the
// conformance bar.  Every product is an FMA loop on the CUDA cores, so the
// compute bound is the FP32 (or FP64) SIMT rate.
//
// Each C entry returns the CUDA error of its launch; the Python wrapper
// raises when it is not 0.

#include "macro_ops.cuh"

namespace repro {

// ---------------------------------------------------------------------------
// GEQRT — replaces src/repro/kernels/macro_ops.py: geqrt_wavefront_kernel
// (launched by src/repro/core/engine.py: _dispatch_geqrt).
//
// Bound: at nb = 32 one task is ~1.7 nb^3 = 55 kFLOP on 12 KB, under a
// microsecond at the card's rates; what bounds it is the column loop's
// latency: nb sequential steps, each a reduction, the reflector and a
// rank-1 update, and then T's nb-step recurrence.  The main path runs one
// task per launch, so the task's latency is the launch's time, and in the
// megakernel the level's.
// Design: the tile goes to shared memory once and back once.  At nb <= 32
// (the main path) the column loop keeps the tile in registers across the
// CTA, 4 rows a thread, with one barrier per column (geqrt_columns32):
// with the MHT reordering a column is one reduction, the tail norm and
// w = tau v^T A come out of the same sums, the reflector coefficients come
// from the SFU (reflector_coeffs_fast: the IEEE square root and divides
// are subroutine calls on the column's chain), and the same sums give the
// Gram matrix of V, so T's recurrence (form_t_reg: a lane per row of T,
// no barrier per step) starts right after the loop.  Past 32 columns the
// loop runs on warp 0 over shared memory (geqrt_columns_smem), then
// gram_t and form_t.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T lane_slot(const T (&s)[kSlots], int j) {
  T own = T(0);
#pragma unroll
  for (int t = 0; t < kSlots; ++t)
    if (t == (j >> 5)) own = s[t];
  return __shfl_sync(0xffffffffu, own, j & 31);
}

// The column loop of GEQRT on warp 0 for tiles past 32 columns: A (nb x nb,
// pitch nb) -> R on and above the diagonal, V strictly below it; taus[j]
// out.  The tile stays in shared memory, lane c owning columns c, c + 32,
// ...; every lane forms s_c = sum_{r > j} x_r A[r][c] against the
// broadcast column x (conflict-free), lane j's s_j is the tail's squared
// norm, and w_c = tau (A[j][c] + s_c / denom).
template <typename T>
__device__ __forceinline__ void geqrt_columns_smem(T* A, T* taus, int nb) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < nb; ++j) {
    T s[kSlots], w[kSlots];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int c = lane + 32 * t;
      T acc = T(0);
      if (c >= j && c < nb)
#pragma unroll 4
        for (int r = j + 1; r < nb; ++r) acc += A[r * nb + j] * A[r * nb + c];
      s[t] = acc;
    }
    T beta, tau, denom;
    reflector_coeffs(A[j * nb + j], lane_slot(s, j), &beta, &tau, &denom);
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int c = lane + 32 * t;
      w[t] = c > j && c < nb ? tau * (A[j * nb + c] + s[t] / denom) : T(0);
    }
    __syncwarp();  // every lane has read column j and row j
    for (int r = j + 1 + lane; r < nb; r += 32) A[r * nb + j] /= denom;
    if (lane == 0) {
      A[j * nb + j] = beta;
      taus[j] = tau;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int c = lane + 32 * t;
      if (c > j && c < nb) {
        A[j * nb + c] -= w[t];
#pragma unroll 4
        for (int r = j + 1; r < nb; ++r) A[r * nb + c] -= A[r * nb + j] * w[t];
      }
    }
    __syncwarp();
  }
}


// The column loops for nb <= 32 run on the whole CTA with the tile in
// registers: warp w holds rows w, w + 8, w + 16, w + 24, lane c column c
// (rows and columns past nb are zeros, which change no sum).  Per column
// j, each thread shuffles its four rows' x_r from lane j and forms its
// part of s_c = sum x_r A[r][c] (lane j's s_j is the tail's squared
// norm); the warps' parts meet in shared memory `xch`, double-buffered by
// column parity, behind the one CTA barrier of the column; every thread
// sums them in the same order and so computes identical coefficients, and
// w_c = tau (A[j][c] + s_c / denom) needs no second reduction.  The update
// is a_c[r] -= x_r (w_c / denom); column j keeps x unscaled until the
// end, when it becomes v = x / denom, the reference's rounding of V.
// xch holds 2 x (kWarps x 32 partials + a 32-wide pivot row) and the 32
// denominators: kXchElems.
constexpr int kXchElems = 2 * (kWarps * 32 + 32) + 32;

template <typename T>
__device__ __forceinline__ T pick4(const T (&a)[4], int k) {
  T x = a[0];
  if (k == 1) x = a[1];
  if (k == 2) x = a[2];
  if (k == 3) x = a[3];
  return x;
}

template <typename T>
__device__ __forceinline__ void geqrt_columns32(T* A, T* Gt, T* taus,
                                                T* xch, int nb) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* dens = xch + 2 * (kWarps * 32 + 32);
  T own_rden = T(1);  // 1 / denom of this lane's column, once factored
  T a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = warp + 8 * k;
    a[k] = r < nb && lane < nb ? A[r * nb + lane] : T(0);
  }
  for (int j = 0; j < nb; ++j) {
    T* red = xch + (j & 1) * (kWarps * 32 + 32);
    T* prow = red + kWarps * 32;
    T x[4];
    T part = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = __shfl_sync(kAll, a[k], j);
      part = fma_(x[k], warp + 8 * k > j ? a[k] : T(0), part);
    }
    red[warp * 32 + lane] = part;
    if (warp == (j & 7)) prow[lane] = pick4(a, j >> 3);
    __syncthreads();
    T s0 = T(0), s1 = T(0), t0 = T(0), t1 = T(0);
#pragma unroll
    for (int h = 0; h < kWarps; h += 2) {
      s0 += red[h * 32 + lane];
      s1 += red[(h + 1) * 32 + lane];
      t0 += red[h * 32 + j];
      t1 += red[(h + 1) * 32 + j];
    }
    const T s = s0 + s1;
    T beta, tau, denom, rden;
    reflector_coeffs_fast(prow[j], t0 + t1, &beta, &tau, &denom, &rden);
    // y_c = v_j^T A[:, c]; for c < j, y_c / denom_c is the Gram entry
    // G[c][j] of the unit-lower V (column c holds x_c, unscaled).
    const T y = prow[lane] + quot(s, denom, rden);
    const T w = lane > j ? tau * y : T(0);
    const T wd = quot(w, denom, rden);
    if (warp == 0 && lane < j) Gt[j * nb + lane] = y * own_rden;
    if (lane == j) own_rden = rden;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = warp + 8 * k;
      if (r > j)
        a[k] = fma_(-x[k], wd, a[k]);
      else if (r == j)
        a[k] = lane == j ? beta : a[k] - w;
    }
    if (threadIdx.x == 0) {
      taus[j] = tau;
      dens[j] = denom;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = warp + 8 * k;
    if (r < nb && lane < nb)
      A[r * nb + lane] = r > lane ? a[k] / dens[lane] : a[k];
  }
}

// The task bodies come in two halves: the operands' copy into shared memory
// (the caller's: a wavefront kernel copies and waits, the megakernel
// prefetches one task ahead and keeps reused tiles) and the compute, a
// __noinline__ function that every lowering calls on the operands in
// shared memory, so the same machine code computes every task.  The
// compute functions take element offsets into the dynamic shared memory
// (operands and a scratch region, each nb x nb tile nn elements) and
// write their outputs to global memory in place.
template <typename T>
__device__ __forceinline__ T* smem_at(int off) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw) + off;
}

// Scratch of the GEQRT/TSQRT compute: the transposed Gram matrix (pitch
// nb), T (pitch nb + 1), taus and the column exchange (nb <= 32).
template <typename T>
__device__ __noinline__ void geqrt_compute(int o_a, int o_s, T* ws, T* d_t,
                                           T* d_taus, int k, int q, int nb) {
  const int nn = nb * nb;
  T* A = smem_at<T>(o_a);   // the tile, pitch nb
  T* Gt = smem_at<T>(o_s);  // transposed Gram matrix
  T* Tm = Gt + nn;          // T, pitch nb + 1
  T* taus = Tm + nb * (nb + 1);
  T* xch = taus + nb;       // column exchange, nb <= 32

  T* tile = ws + ((size_t)k * q + k) * nn;
  if (nb <= 32) {
    geqrt_columns32(A, Gt, taus, xch, nb);
  } else {
    if (threadIdx.x < 32) geqrt_columns_smem(A, taus, nb);
    __syncthreads();
    gram_t(A, Gt, nb, true);
  }
  __syncthreads();
  if (nb > 32)
    form_t(Gt, taus, Tm, nb);
  else if (threadIdx.x < 32)
    form_t_reg(Gt, taus, Tm, nb);
  __syncthreads();
  store_tile(tile, A, nn);
  store_t(d_t + (size_t)k * nn, Tm, nb);
  store_tile(d_taus + (size_t)k * nb, taus, nb);
}

// Shared memory of the wavefront kernels: the kind's operand tiles in
// order from offset 0, its scratch after them (MacroOp.smem_elems).
template <typename T>
__global__ void __launch_bounds__(kThreads)
geqrt_kernel(T* ws, T* d_t, T* d_taus, const int* idx, int q, int nb) {
  const int nn = nb * nb, k = idx[3 * blockIdx.x];
  copy_tile_async(smem_at<T>(0), ws + ((size_t)k * q + k) * nn, nn);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  geqrt_compute(0, nn, ws, d_t, d_taus, k, q, nb);
}

// ---------------------------------------------------------------------------
// LARFB — replaces src/repro/kernels/macro_ops.py: larfb_wavefront_kernel
// (launched by src/repro/core/engine.py: _dispatch_larfb).
//
// Bound: 3 nb^3 FLOP on 4 nb^2 elements moved, about 6 FLOP per byte in
// fp32 at nb = 32, under the card's 20 FLOP/byte ridge: memory-bound on
// paper; in practice one task is three dependent nb-term product passes,
// and its latency is what a megakernel level waits for.
// Design: C = C - V (T^T (V^T C)) as three register-blocked passes over
// shared memory (rows_times): each thread carries a block of independent
// sums that share its loads, so the passes run at the rate of the FMAs
// instead of one load per term.  The intermediates never leave shared
// memory.  V is the unit-lower V1 with explicit zeros above the diagonal,
// so the sums run over whole rows.
// ---------------------------------------------------------------------------
// One product pass over nb x nb shared-memory operands: every output
// s(i, c) = sum_k X(i, k) Y[k][c], X(i, k) = X[k][i] when kXt, else
// X[i][k], is one FMA chain over k = 0, 1, ..., nb - 1 from zero, and
// emit(i, c, s) takes each result.  The chain is the same in both forms
// below, so every result is too.
//
// nb a multiple of 4 (the main path): each thread forms a 2 x 4 block —
// rows 2 rp, 2 rp + 1, columns 4 cg..4 cg + 3 — from one 16-byte load of
// Y and one 8-byte load of X a step (kXt; else one 16-byte load of each
// of X's two rows per four steps): two shared-memory loads per eight FMAs,
// where a load per FMA made the pass bound by the shared-memory pipe.
// A warp's Y loads cover whole rows (conflict-free) and its X loads are
// broadcasts.  Other nb: thread (a0, c) forms rows a0, a0 + G, ... in
// blocks of kRowBlock with a broadcast X load per FMA.
constexpr int kRowBlock = 4;

template <bool kXt, typename T, typename Emit>
__device__ __forceinline__ void rows_times(const T* X, const T* Y, int nb,
                                           Emit emit) {
  if ((nb & 3) == 0) {
    const int cgs = nb >> 2;
    for (int item = threadIdx.x; item < cgs * (nb >> 1); item += blockDim.x) {
      const int rp = item / cgs, c0 = (item - rp * cgs) * 4, r0 = 2 * rp;
      T acc[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[u][j] = T(0);
      for (int k0 = 0; k0 < nb; k0 += 4) {
        T xr[2][4];
        if (kXt) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            xr[0][kk] = X[(k0 + kk) * nb + r0];
            xr[1][kk] = X[(k0 + kk) * nb + r0 + 1];
          }
        } else {
          ld4(X + r0 * nb + k0, xr[0]);
          ld4(X + (r0 + 1) * nb + k0, xr[1]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          T y[4];
          ld4(Y + (k0 + kk) * nb + c0, y);
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[u][j] = fma_(xr[u][kk], y[j], acc[u][j]);
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) emit(r0 + u, c0 + j, acc[u][j]);
    }
    return;
  }
  const int g = blockDim.x / nb;
  const int a0 = threadIdx.x / nb, c = threadIdx.x - a0 * nb;
  if (a0 >= g) return;
  for (int ib = a0; ib < nb; ib += kRowBlock * g) {
    int row[kRowBlock];
    T acc[kRowBlock];
#pragma unroll
    for (int u = 0; u < kRowBlock; ++u) {
      const int i = ib + u * g;
      row[u] = i < nb ? i : nb - 1;  // rows past nb repeat the last, unused
      acc[u] = T(0);
    }
#pragma unroll 4
    for (int k = 0; k < nb; ++k) {
      const T y = Y[k * nb + c];
#pragma unroll
      for (int u = 0; u < kRowBlock; ++u)
        acc[u] = fma_(kXt ? X[k * nb + row[u]] : X[row[u] * nb + k], y, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowBlock; ++u)
      if (ib + u * g < nb) emit(ib + u * g, c, acc[u]);
  }
}

// V arrives as the raw diagonal tile (k, k) and becomes the unit-lower V1
// in place (idempotent, so a reused V passes through unchanged); T and C
// are read only; the scratch holds W1 and W2.
template <typename T>
__device__ __noinline__ void larfb_compute(int o_v, int o_t, int o_c, int o_s,
                                           T* ws, int k, int j, int q,
                                           int nb) {
  const int nn = nb * nb;
  T* V = smem_at<T>(o_v);
  const T* Tm = smem_at<T>(o_t);
  const T* C = smem_at<T>(o_c);
  T* W1 = smem_at<T>(o_s);
  T* W2 = W1 + nn;

  T* tile = ws + ((size_t)k * q + j) * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    if (r <= c) V[e] = r == c ? T(1) : T(0);
  }
  __syncthreads();
  rows_times<true>(V, C, nb, [&](int a, int c, T s) { W1[a * nb + c] = s; });
  __syncthreads();
  rows_times<true>(Tm, W1, nb, [&](int a, int c, T s) { W2[a * nb + c] = s; });
  __syncthreads();
  rows_times<false>(V, W2, nb, [&](int r, int c, T s) {
    tile[r * nb + c] = C[r * nb + c] - s;
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
larfb_kernel(T* ws, const T* d_t, const int* idx, int q, int nb) {
  const int nn = nb * nb, k = idx[3 * blockIdx.x], j = idx[3 * blockIdx.x + 2];
  copy_tile_async(smem_at<T>(0), ws + ((size_t)k * q + k) * nn, nn);
  copy_tile_async(smem_at<T>(nn), d_t + (size_t)k * nn, nn);
  copy_tile_async(smem_at<T>(2 * nn), ws + ((size_t)k * q + j) * nn, nn);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  larfb_compute(0, nn, 2 * nn, 3 * nn, ws, k, j, q, nb);
}

// ---------------------------------------------------------------------------
// TSQRT — replaces src/repro/kernels/macro_ops.py: tsqrt_wavefront_kernel
// (launched by src/repro/core/engine.py: _dispatch_tsqrt).
//
// Bound: ~3.3 nb^3 FLOP on 5 nb^2 elements, again far under a microsecond
// at the card's rates; like GEQRT the task is bound by its sequential
// column loop and T recurrence, and every level of the schedule's
// critical path waits for one.
// Design: GEQRT's, with [e_j; v2_j] reflectors (tsqrt_columns32 at nb <=
// 32, tsqrt_columns_smem past it): a step touches only row j of the
// triangle and the sub tile, which becomes V2 in place.  The triangle is
// factored in the upper part of the diagonal tile's shared copy, and only
// that upper triangle is written back: the GEQRT V1 below the diagonal
// stays as it is in global memory, where a LARFB of the same level may be
// reading it (and LARFB and Q formation read it later).
// ---------------------------------------------------------------------------
// The column loop of TSQRT on warp 0, tiles past 32 columns: D and A in
// shared memory, lane c owning columns c, c + 32, ...
template <typename T>
__device__ __forceinline__ void tsqrt_columns_smem(T* D, T* A, T* taus,
                                                   int nb) {
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < nb; ++j) {
    T s[kSlots], w[kSlots];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int c = lane + 32 * t;
      T acc = T(0);
      if (c >= j && c < nb)
#pragma unroll 4
        for (int r = 0; r < nb; ++r) acc += A[r * nb + j] * A[r * nb + c];
      s[t] = acc;
    }
    T beta, tau, denom;
    reflector_coeffs(D[j * nb + j], lane_slot(s, j), &beta, &tau, &denom);
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int c = lane + 32 * t;
      w[t] = c > j && c < nb ? tau * (D[j * nb + c] + s[t] / denom) : T(0);
    }
    __syncwarp();
    for (int r = lane; r < nb; r += 32) A[r * nb + j] /= denom;
    if (lane == 0) {
      D[j * nb + j] = beta;
      taus[j] = tau;
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int c = lane + 32 * t;
      if (c > j && c < nb) {
        D[j * nb + c] -= w[t];
#pragma unroll 4
        for (int r = 0; r < nb; ++r) A[r * nb + c] -= A[r * nb + j] * w[t];
      }
    }
    __syncwarp();
  }
}


// TSQRT's column loop for nb <= 32, on the whole CTA: GEQRT's scheme on
// the sub tile, with the pivot row read from the triangle D in shared
// memory.  Row j of D is read by every thread during column j, so warp 0
// writes its new values after the next column's barrier.
template <typename T>
__device__ __forceinline__ void tsqrt_columns32(T* D, T* A, T* Gt, T* taus,
                                                T* xch, int nb) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* dens = xch + 2 * (kWarps * 32 + 32);
  T own_rden = T(1);  // 1 / denom of this lane's column, once factored
  T a[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = warp + 8 * k;
    a[k] = r < nb && lane < nb ? A[r * nb + lane] : T(0);
  }
  T pending = T(0);  // warp 0: D[j - 1][lane], written after the barrier
  for (int j = 0; j < nb; ++j) {
    T* red = xch + (j & 1) * (kWarps * 32 + 32);
    T x[4];
    T part = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = __shfl_sync(kAll, a[k], j);
      part = fma_(x[k], a[k], part);
    }
    red[warp * 32 + lane] = part;
    __syncthreads();
    if (warp == 0 && j > 0 && lane >= j - 1 && lane < nb)
      D[(j - 1) * nb + lane] = pending;
    T s0 = T(0), s1 = T(0), t0 = T(0), t1 = T(0);
#pragma unroll
    for (int h = 0; h < kWarps; h += 2) {
      s0 += red[h * 32 + lane];
      s1 += red[(h + 1) * 32 + lane];
      t0 += red[h * 32 + j];
      t1 += red[(h + 1) * 32 + j];
    }
    const T s = s0 + s1;
    const T d = lane >= j && lane < nb ? D[j * nb + lane] : T(0);
    T beta, tau, denom, rden;
    reflector_coeffs_fast(D[j * nb + j], t0 + t1, &beta, &tau, &denom, &rden);
    const T y = quot(s, denom, rden);  // c < j: y_c / denom_c = G[c][j]
    const T w = lane > j ? tau * (d + y) : T(0);
    const T wd = quot(w, denom, rden);
    if (warp == 0 && lane < j) Gt[j * nb + lane] = y * own_rden;
    if (lane == j) own_rden = rden;
#pragma unroll
    for (int k = 0; k < 4; ++k) a[k] = fma_(-x[k], wd, a[k]);
    pending = lane == j ? beta : d - w;
    if (threadIdx.x == 0) {
      taus[j] = tau;
      dens[j] = denom;
    }
  }
  __syncthreads();
  if (warp == 0 && lane >= nb - 1 && lane < nb) D[(nb - 1) * nb + lane] = pending;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = warp + 8 * k;
    if (r < nb && lane < nb) A[r * nb + lane] = a[k] / dens[lane];
  }
}

// D is the diagonal tile (k, k), A the sub tile (i, k) (-> V2), both
// factored in place; the scratch as GEQRT's.
template <typename T>
__device__ __noinline__ void tsqrt_compute(int o_d, int o_a, int o_s, T* ws,
                                           T* t_t, T* t_taus, int k, int i,
                                           int p, int q, int nb) {
  const int nn = nb * nb;
  const int r_steps = p < q ? p : q;
  T* D = smem_at<T>(o_d);   // diagonal tile, pitch nb
  T* A = smem_at<T>(o_a);   // sub tile -> V2, pitch nb
  T* Gt = smem_at<T>(o_s);  // transposed Gram matrix
  T* Tm = Gt + nn;          // T, pitch nb + 1
  T* taus = Tm + nb * (nb + 1);
  T* xch = taus + nb;       // column exchange, nb <= 32

  T* diag = ws + ((size_t)k * q + k) * nn;
  T* sub = ws + ((size_t)i * q + k) * nn;
  if (nb <= 32) {
    tsqrt_columns32(D, A, Gt, taus, xch, nb);
  } else {
    if (threadIdx.x < 32) tsqrt_columns_smem(D, A, taus, nb);
    __syncthreads();
    gram_t(A, Gt, nb, false);
  }
  __syncthreads();
  if (nb > 32)
    form_t(Gt, taus, Tm, nb);
  else if (threadIdx.x < 32)
    form_t_reg(Gt, taus, Tm, nb);
  __syncthreads();

  const size_t slot = (size_t)i * r_steps + k;
  for (int r = threadIdx.x >> 5; r < nb; r += blockDim.x >> 5)
    for (int c = r + (threadIdx.x & 31); c < nb; c += 32)
      diag[r * nb + c] = D[r * nb + c];
  store_tile(sub, A, nn);
  store_t(t_t + slot * nn, Tm, nb);
  store_tile(t_taus + slot * nb, taus, nb);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tsqrt_kernel(T* ws, T* t_t, T* t_taus, const int* idx, int p, int q, int nb) {
  const int nn = nb * nb, k = idx[3 * blockIdx.x], i = idx[3 * blockIdx.x + 1];
  copy_tile_async(smem_at<T>(0), ws + ((size_t)k * q + k) * nn, nn);
  copy_tile_async(smem_at<T>(nn), ws + ((size_t)i * q + k) * nn, nn);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  tsqrt_compute(0, nn, 2 * nn, ws, t_t, t_taus, k, i, p, q, nb);
}

// ---------------------------------------------------------------------------
// SSRFB — replaces src/repro/kernels/macro_ops.py: ssrfb_wavefront_kernel
// (launched by src/repro/core/engine.py: _dispatch_ssrfb).
//
// Bound: 5 nb^3 FLOP on 6 nb^2 elements moved, about 7 FLOP per byte in
// fp32 at nb = 32: memory-bound by the roofline, and the kernel that
// carries the main path's work (up to 1,113 tasks in one launch on the
// 64 x 64 grid, enough CTAs to fill the 132 SMs several times over); in
// the megakernel a level also waits for its slowest SSRFB.
// Design: W = T^T (C_k + V2^T C_i), C_k -= W, C_i -= V2 W as LARFB's
// register-blocked passes over shared memory, each tile read from and
// written to global memory once.
// ---------------------------------------------------------------------------
// V2 and T are read only (a reused pair passes through unchanged); C_k and
// C_i are read from shared memory and their updates written to global
// memory; the scratch holds W and W2.
template <typename T>
__device__ __noinline__ void ssrfb_compute(int o_v, int o_t, int o_ck,
                                           int o_ci, int o_s, T* ws, int k,
                                           int i, int j, int q, int nb) {
  const int nn = nb * nb;
  const T* V2 = smem_at<T>(o_v);
  const T* Tm = smem_at<T>(o_t);
  const T* Ck = smem_at<T>(o_ck);
  const T* Ci = smem_at<T>(o_ci);
  T* W = smem_at<T>(o_s);
  T* W2 = W + nn;

  T* tile_k = ws + ((size_t)k * q + j) * nn;
  T* tile_i = ws + ((size_t)i * q + j) * nn;
  rows_times<true>(V2, Ci, nb, [&](int a, int c, T s) {
    W[a * nb + c] = Ck[a * nb + c] + s;
  });
  __syncthreads();
  rows_times<true>(Tm, W, nb, [&](int a, int c, T s) { W2[a * nb + c] = s; });
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) tile_k[e] = Ck[e] - W2[e];
  rows_times<false>(V2, W2, nb, [&](int r, int c, T s) {
    tile_i[r * nb + c] = Ci[r * nb + c] - s;
  });
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssrfb_kernel(T* ws, const T* t_t, const int* idx, int p, int q, int nb) {
  const int nn = nb * nb, r_steps = p < q ? p : q;
  const int k = idx[3 * blockIdx.x], i = idx[3 * blockIdx.x + 1],
            j = idx[3 * blockIdx.x + 2];
  copy_tile_async(smem_at<T>(0), ws + ((size_t)i * q + k) * nn, nn);
  copy_tile_async(smem_at<T>(nn), t_t + ((size_t)i * r_steps + k) * nn, nn);
  copy_tile_async(smem_at<T>(2 * nn), ws + ((size_t)k * q + j) * nn, nn);
  copy_tile_async(smem_at<T>(3 * nn), ws + ((size_t)i * q + j) * nn, nn);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  ssrfb_compute(0, nn, 2 * nn, 3 * nn, 4 * nn, ws, k, i, j, q, nb);
}

// ---------------------------------------------------------------------------
// Megakernel — replaces src/repro/core/engine.py: megakernel_kernel (with
// _megakernel_step and _op_copies; launched by _dispatch_megakernel) and
// megakernel_batched_kernel (launched by _dispatch_megakernel_batched).
//
// The task table is the engine's megakernel_task_table: int32 rows of
// kTableCols columns, nslots rows per level, (kind, k, i, j) in columns
// 0..3, the level's tasks first and kNoop rows after them, and the
// reference's chains in columns 10..15: FETCHED / PREFETCH mark the
// one-ahead pairs (every slot and its successor), REUSE0..2 an operand
// tile the slot shares with its predecessor, REUSET the block reflector.
// The reference walks it as a sequential grid on one TPU core; here every
// level's tasks run on concurrent CTAs — in the batched kernel the tasks
// of all `batch` slices of the stacked state, work item w = (slice
// w / n, slot w % n) — and a grid barrier follows each level.  Every
// slice replays the same table, so a slice's result is the single run's,
// bit for bit.
//
// Bound: the whole factorization is ~5 nb^3 FLOP per SSRFB and the
// workspace read and written once (6.6 us of FP32 work at 640^2), but the
// schedule is a chain of levels with a grid barrier after each, and
// almost every level holds a GEQRT or a TSQRT, so a call takes about
// levels x (the slowest CTA's share of a level + the barrier).  On the
// stack a level holds thousands of tasks over a few hundred resident
// CTAs, and a task's serial copy-in, barrier, passes and store leave the
// SM idle unless its loads overlap another task's arithmetic.
// Design: one launch instead of ~3 per level removes the launch gaps.
// Each CTA walks a contiguous run of its level's work list (`runs`, from
// the engine: balanced over the grid, a same-(k, i) SSRFB group kept
// whole where that costs little balance), so consecutive tasks of one
// slice meet on one CTA: where the table's REUSE columns say the next
// task reads the same V tile (REUSE0) or block reflector (REUSET), and it
// is a LARFB after a LARFB or an SSRFB after an SSRFB, the CTA keeps the
// tile in shared memory.  Every other operand of the next task streams
// into a second buffer by cp.async while this task computes (the
// reference's one-ahead double buffer); a CTA whose double buffers do not
// fit (nb = 64 fp64) runs one buffer, reuse without prefetch.
// ---------------------------------------------------------------------------
constexpr int kTableCols = 16;
constexpr int kNoop = 4;
constexpr int kColReuse0 = 12;
constexpr int kColReuseT = 15;
// Resident CTAs per SM the batched megakernel is compiled for (the
// register cap __launch_bounds__ sets): uncapped, the walk's state and the
// calls' saved registers take the register file of one CTA, and a
// stack's levels hold work for many more CTAs than the SMs (3 read faster
// than 1, 2 and 4 on the (60, 576, 576) stack).  The single megakernel keeps
// no cap: its levels hold at most a CTA per SM, and the cap slows the
// GEQRT/TSQRT chain that sets its level time.
constexpr int kMegaMinBlocks = 3;

// Shared memory of a megakernel CTA (macro_ops.megakernel_launch_smem):
// four operand slots (V / D / A tile, T, C / C_k / sub tile, C_i), each
// `stages` tiles, then the largest compute scratch (2 nn + 2 nb +
// kXchElems).  Slot o, buffer b at (o * stages + b) * nn.

// Copy a task's operands into the buffers `buf` of its slots, skipping a
// reused V (slot 0) and T (slot 1).  The caller commits.
template <typename T>
__device__ __forceinline__ void copy_operands(int kind, int k, int i, int j,
                                              const T* wsb, const T* dtb,
                                              const T* ttb, int q, int r,
                                              int nb, int stages,
                                              const int (&buf)[4], bool keep_v,
                                              bool keep_t) {
  const int nn = nb * nb;
  auto slot = [&](int o) { return smem_at<T>((o * stages + buf[o]) * nn); };
  auto tile = [&](int row, int col) { return wsb + ((size_t)row * q + col) * nn; };
  switch (kind) {
    case 0:
      copy_tile_async(slot(0), tile(k, k), nn);
      break;
    case 1:
      if (!keep_v) copy_tile_async(slot(0), tile(k, k), nn);
      if (!keep_t) copy_tile_async(slot(1), dtb + (size_t)k * nn, nn);
      copy_tile_async(slot(2), tile(k, j), nn);
      break;
    case 2:
      copy_tile_async(slot(0), tile(k, k), nn);
      copy_tile_async(slot(2), tile(i, k), nn);
      break;
    case 3:
      if (!keep_v) copy_tile_async(slot(0), tile(i, k), nn);
      if (!keep_t) copy_tile_async(slot(1), ttb + ((size_t)i * r + k) * nn, nn);
      copy_tile_async(slot(2), tile(k, j), nn);
      copy_tile_async(slot(3), tile(i, j), nn);
      break;
    default:
      break;
  }
}

template <typename T>
__device__ __forceinline__ void megakernel_walk(
    T* ws, T* d_t, T* d_taus, T* t_t, T* t_taus, const int* tab,
    const int* runs, int nlevels, int nslots, int batch, int p, int q, int nb,
    int stages, unsigned int* barrier) {
  const int nn = nb * nb;
  const int r = p < q ? p : q;
  const size_t s_ws = (size_t)p * q * nn, s_dt = (size_t)r * nn,
               s_dtaus = (size_t)r * nb, s_tt = (size_t)p * r * nn,
               s_ttaus = (size_t)p * r * nb;
  const int o_s = 4 * stages * nn;
  // The runs carry, per (level, CTA), the run's [start, end), the level's
  // task count, the table slot of the run's first task and that task's
  // (kind, k, i, j), so a level needs no table scan and no dependent load:
  // the next level's are read while this level's first tiles arrive.
  const int4* run4 = reinterpret_cast<const int4*>(runs);
  int4 run = __ldg(run4 + 2 * (size_t)blockIdx.x);
  int4 first = __ldg(run4 + 2 * (size_t)blockIdx.x + 1);
  for (int lv = 0; lv < nlevels; ++lv) {
    const int* rows = tab + (size_t)lv * nslots * kTableCols;
    const int w0 = run.x, w1 = run.y, ntasks = run.z;
    int cur[4] = {0, 0, 0, 0};
    if (w0 < w1) {
      const int b = w0 / ntasks;
      copy_operands(first.x, first.y, first.z, first.w, ws + b * s_ws,
                    d_t + b * s_dt, t_t + b * s_tt, q, r, nb, stages, cur,
                    false, false);
      cp_async_commit();
    }
    if (lv + 1 < nlevels) {
      const size_t nxt = 2 * ((size_t)(lv + 1) * gridDim.x + blockIdx.x);
      run = __ldg(run4 + nxt);
      first = __ldg(run4 + nxt + 1);
    }
    // The kind is uniform across the CTA, so the bodies' __syncthreads
    // are reached by every thread.
    for (int w = w0; w < w1; ++w) {
      const int b = w / ntasks;
      const int* row = rows + (w - b * ntasks) * kTableCols;
      const int kind = __ldg(row), k = __ldg(row + 1), i = __ldg(row + 2),
                j = __ldg(row + 3);
      cp_async_wait<0>();
      __syncthreads();  // this task's operands are in shared memory
      // The next task of the run: which operands it keeps, and (with two
      // buffers) the copy of the others, in flight during this task.
      int nxt[4] = {cur[0], cur[1], cur[2], cur[3]};
      int nkind = kNoop, nk = 0, ni = 0, nj = 0, nbb = 0;
      bool keep_v = false, keep_t = false;
      if (w + 1 < w1) {
        nbb = (w + 1) / ntasks;
        const int* nrow = rows + (w + 1 - nbb * ntasks) * kTableCols;
        nkind = __ldg(nrow);
        nk = __ldg(nrow + 1);
        ni = __ldg(nrow + 2);
        nj = __ldg(nrow + 3);
        const bool chain = nbb == b && nkind == kind && (kind == 1 || kind == 3);
        keep_v = chain && __ldg(nrow + kColReuse0) != 0;
        keep_t = chain && __ldg(nrow + kColReuseT) != 0;
        if (stages == 2) {
          for (int o = 0; o < 4; ++o) nxt[o] = cur[o] ^ 1;
          if (keep_v) nxt[0] = cur[0];
          if (keep_t) nxt[1] = cur[1];
          copy_operands(nkind, nk, ni, nj, ws + nbb * s_ws, d_t + nbb * s_dt,
                        t_t + nbb * s_tt, q, r, nb, stages, nxt, keep_v,
                        keep_t);
          cp_async_commit();
        }
      }
      T* wsb = ws + b * s_ws;
      auto at = [&](int o) { return (o * stages + cur[o]) * nn; };
      switch (kind) {
        case 0:
          geqrt_compute(at(0), o_s, wsb, d_t + b * s_dt, d_taus + b * s_dtaus,
                        k, q, nb);
          break;
        case 1:
          larfb_compute(at(0), at(1), at(2), o_s, wsb, k, j, q, nb);
          break;
        case 2:
          tsqrt_compute(at(0), at(2), o_s, wsb, t_t + b * s_tt,
                        t_taus + b * s_ttaus, k, i, p, q, nb);
          break;
        case 3:
          ssrfb_compute(at(0), at(1), at(2), at(3), o_s, wsb, k, i, j, q, nb);
          break;
        default:
          break;
      }
      __syncthreads();  // this task's buffers and the scratch are free
      if (w + 1 < w1 && stages == 1) {
        copy_operands(nkind, nk, ni, nj, ws + nbb * s_ws, d_t + nbb * s_dt,
                      t_t + nbb * s_tt, q, r, nb, stages, nxt, keep_v, keep_t);
        cp_async_commit();
      }
      for (int o = 0; o < 4; ++o) cur[o] = nxt[o];
    }
    if (lv + 1 < nlevels) grid_barrier(barrier, gridDim.x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
megakernel_kernel(T* ws, T* d_t, T* d_taus, T* t_t, T* t_taus,
                  const int* tab, const int* runs, int nlevels, int nslots,
                  int batch, int p, int q, int nb, int stages,
                  unsigned int* barrier) {
  megakernel_walk(ws, d_t, d_taus, t_t, t_taus, tab, runs, nlevels, nslots,
                  1, p, q, nb, stages, barrier);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMegaMinBlocks)
megakernel_batched_kernel(T* ws, T* d_t, T* d_taus, T* t_t, T* t_taus,
                          const int* tab, const int* runs, int nlevels,
                          int nslots, int batch, int p, int q, int nb,
                          int stages, unsigned int* barrier) {
  megakernel_walk(ws, d_t, d_taus, t_t, t_taus, tab, runs, nlevels, nslots,
                  batch, p, q, nb, stages, barrier);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
static int launch(int kind, void* ws, void* aux0, void* aux1, const int* idx,
                  int ntasks, int p, int q, int nb, size_t bytes,
                  cudaStream_t stream) {
  T* w = static_cast<T*>(ws);
  cudaError_t err = cudaSuccess;
  switch (kind) {
    case 0:
      err = prepare(geqrt_kernel<T>, bytes);
      if (err == cudaSuccess)
        geqrt_kernel<T><<<ntasks, kThreads, bytes, stream>>>(
            w, static_cast<T*>(aux0), static_cast<T*>(aux1), idx, q, nb);
      break;
    case 1:
      err = prepare(larfb_kernel<T>, bytes);
      if (err == cudaSuccess)
        larfb_kernel<T><<<ntasks, kThreads, bytes, stream>>>(
            w, static_cast<const T*>(aux0), idx, q, nb);
      break;
    case 2:
      err = prepare(tsqrt_kernel<T>, bytes);
      if (err == cudaSuccess)
        tsqrt_kernel<T><<<ntasks, kThreads, bytes, stream>>>(
            w, static_cast<T*>(aux0), static_cast<T*>(aux1), idx, p, q, nb);
      break;
    default:
      err = prepare(ssrfb_kernel<T>, bytes);
      if (err == cudaSuccess)
        ssrfb_kernel<T><<<ntasks, kThreads, bytes, stream>>>(
            w, static_cast<const T*>(aux0), idx, p, q, nb);
      break;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The megakernel's grid is chosen by the engine (macro_ops.py), from
// this query: CTAs per SM at this shared-memory size and the CTAs that can
// be resident at once (a cooperative launch needs all of them resident
// for the grid barrier), the most a launch may take.
template <typename T>
static int megakernel_resident(bool batched, size_t bytes, int* per_sm,
                               int* resident) {
  auto kernel = batched ? megakernel_batched_kernel<T> : megakernel_kernel<T>;
  long total = 0;
  cudaError_t err = resident_ctas(kernel, bytes, &total);
  *resident = (int)total;
  int sms = 0, dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *per_sm = sms > 0 ? (int)(total / sms) : 0;
  return (int)err;
}

template <typename T>
static int launch_megakernel(bool batched, void* ws, void* d_t, void* d_taus,
                             void* t_t, void* t_taus, const int* tab,
                             const int* runs, int nlevels, int nslots,
                             int batch, int p, int q, int nb, int stages,
                             int grid, unsigned int* barrier, size_t bytes,
                             cudaStream_t stream, int* grid_out) {
  auto kernel = batched ? megakernel_batched_kernel<T> : megakernel_kernel<T>;
  if (grid_out != nullptr) *grid_out = 0;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (grid_out != nullptr) *grid_out = grid;
  T* a0 = static_cast<T*>(ws);
  T* a1 = static_cast<T*>(d_t);
  T* a2 = static_cast<T*>(d_taus);
  T* a3 = static_cast<T*>(t_t);
  T* a4 = static_cast<T*>(t_taus);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &tab, &runs, &nlevels, &nslots,
                  &batch, &p, &q, &nb, &stages, &barrier};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static int dispatch_megakernel(bool batched, void* ws, void* d_t,
                               void* d_taus, void* t_t, void* t_taus,
                               const void* tab, const void* runs, int nlevels,
                               int nslots, int batch, int p, int q, int nb,
                               int stages, int grid, int is_double,
                               int smem_bytes, void* barrier, void* stream,
                               int* grid_out) {
  if (nb < 1 || nb > 32 * kSlots || stages < 1 || stages > 2)
    return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tab);
  const int* rn = static_cast<const int*>(runs);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? launch_megakernel<double>(batched, ws, d_t, d_taus, t_t, t_taus,
                                         tb, rn, nlevels, nslots, batch, p, q,
                                         nb, stages, grid, bar, bytes, s,
                                         grid_out)
             : launch_megakernel<float>(batched, ws, d_t, d_taus, t_t, t_taus,
                                        tb, rn, nlevels, nslots, batch, p, q,
                                        nb, stages, grid, bar, bytes, s,
                                        grid_out);
}

static int dispatch(int kind, void* ws, void* aux0, void* aux1, const void* idx,
                    int ntasks, int p, int q, int nb, int is_double,
                    int smem_bytes, void* stream) {
  if (nb < 1 || nb > 32 * kSlots) return (int)cudaErrorInvalidValue;
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? launch<double>(kind, ws, aux0, aux1, ix, ntasks, p, q, nb, bytes, s)
             : launch<float>(kind, ws, aux0, aux1, ix, ntasks, p, q, nb, bytes, s);
}

}  // namespace repro

extern "C" {

// Uniform signature: (workspace, aux0, aux1, idx, ntasks, p, q, nb,
// is_double, smem_bytes, stream).  aux0/aux1 are d_t/d_taus (GEQRT),
// d_t/- (LARFB), t_t/t_taus (TSQRT), t_t/- (SSRFB).  smem_bytes is the
// dynamic shared memory per CTA: the caller computes it from the
// kernel's layout (MacroOp.smem_elems in macro_ops.py), so the size the
// budget checks read and the size launched are one number.
int repro_geqrt(void* ws, void* a0, void* a1, const void* idx, int n, int p,
                int q, int nb, int is_double, int smem_bytes, void* stream) {
  return repro::dispatch(0, ws, a0, a1, idx, n, p, q, nb, is_double,
                         smem_bytes, stream);
}

int repro_larfb(void* ws, void* a0, void* a1, const void* idx, int n, int p,
                int q, int nb, int is_double, int smem_bytes, void* stream) {
  return repro::dispatch(1, ws, a0, a1, idx, n, p, q, nb, is_double,
                         smem_bytes, stream);
}

int repro_tsqrt(void* ws, void* a0, void* a1, const void* idx, int n, int p,
                int q, int nb, int is_double, int smem_bytes, void* stream) {
  return repro::dispatch(2, ws, a0, a1, idx, n, p, q, nb, is_double,
                         smem_bytes, stream);
}

int repro_ssrfb(void* ws, void* a0, void* a1, const void* idx, int n, int p,
                int q, int nb, int is_double, int smem_bytes, void* stream) {
  return repro::dispatch(3, ws, a0, a1, idx, n, p, q, nb, is_double,
                         smem_bytes, stream);
}

// Megakernel entries: (ws, d_t, d_taus, t_t, t_taus, table, runs,
// nlevels, nslots, batch, p, q, nb, stages, grid, is_double, smem_bytes,
// barrier, stream, grid_out).  The state pointers are a single (p, q, ...)
// state for repro_megakernel (batch must be 1) and a stacked (batch, p,
// q, ...) state for repro_megakernel_batched; table is the engine's int32
// (nlevels * nslots, 16) task table on the device; runs the int32
// (nlevels, grid, 8) [start, end, level's task count, first task's slot,
// its kind, k, i, j] of each CTA's run of each level's work list
// (engine.megakernel_runs); stages the operand buffers per slot (1
// or 2); grid at most the resident CTAs (repro_megakernel_resident);
// barrier is one zeroed uint32 on the device, the grid barrier's counter;
// *grid_out receives the number of CTAs launched (0 if none could be).
int repro_megakernel(void* ws, void* d_t, void* d_taus, void* t_t,
                     void* t_taus, const void* tab, const void* runs,
                     int nlevels, int nslots, int batch, int p, int q, int nb,
                     int stages, int grid, int is_double, int smem_bytes,
                     void* barrier, void* stream, int* grid_out) {
  if (batch != 1) return (int)cudaErrorInvalidValue;
  return repro::dispatch_megakernel(false, ws, d_t, d_taus, t_t, t_taus, tab,
                                    runs, nlevels, nslots, 1, p, q, nb, stages,
                                    grid, is_double, smem_bytes, barrier,
                                    stream, grid_out);
}

int repro_megakernel_batched(void* ws, void* d_t, void* d_taus, void* t_t,
                             void* t_taus, const void* tab, const void* runs,
                             int nlevels, int nslots, int batch, int p, int q,
                             int nb, int stages, int grid, int is_double,
                             int smem_bytes, void* barrier, void* stream,
                             int* grid_out) {
  return repro::dispatch_megakernel(true, ws, d_t, d_taus, t_t, t_taus, tab,
                                    runs, nlevels, nslots, batch, p, q, nb,
                                    stages, grid, is_double, smem_bytes,
                                    barrier, stream, grid_out);
}

// (batched, is_double, smem_bytes, per_sm_out, resident_out): the
// megakernel's CTAs per SM and resident CTAs at this shared-memory size.
int repro_megakernel_resident(int batched, int is_double, int smem_bytes,
                              int* per_sm, int* resident) {
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? repro::megakernel_resident<double>(batched != 0, bytes, per_sm,
                                                  resident)
             : repro::megakernel_resident<float>(batched != 0, bytes, per_sm,
                                                 resident);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
