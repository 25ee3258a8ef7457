// The four tile-DAG macro ops of tiled QR (GEQRT, LARFB, TSQRT, SSRFB) and
// the persistent megakernel that runs a whole schedule of them, as
// hand-written CUDA kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by repro_torch/kernels/macro_ops.py.
//
// Each macro op is one __device__ __noinline__ task body (geqrt_task, ...):
// a CTA of kThreads threads copies the task's tiles into dynamic shared
// memory, works there, and writes its outputs back in place.  Each body's
// carve-up of that memory is at its top; its size in elements is the op's
// MacroOp.smem_elems in macro_ops.py, which the launch passes.  The
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
//    engine's task table level by level.  Its CTAs stride over the level's
//    tasks — of every slice of the stack, in the batched kernel — and a
//    grid-wide barrier separates the levels.  It takes the largest body's
//    shared memory.
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

template <typename T>
__device__ __noinline__ void geqrt_task(T* ws, T* d_t, T* d_taus, int k,
                                        int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  T* A = reinterpret_cast<T*>(smem_raw);  // the tile, pitch nb
  T* Gt = A + nn;                         // transposed Gram matrix
  T* Tm = Gt + nn;                        // T, pitch nb + 1
  T* taus = Tm + nb * (nb + 1);
  T* xch = taus + nb;                     // column exchange, nb <= 32

  T* tile = ws + ((size_t)k * q + k) * nn;
  load_tile(A, tile, nn);
  __syncthreads();
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
geqrt_kernel(T* ws, T* d_t, T* d_taus, const int* idx, int q, int nb) {
  geqrt_task(ws, d_t, d_taus, idx[3 * blockIdx.x], q, nb);
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
// shared memory (rows_times): each thread carries kRowBlock independent
// sums that share every load of the right operand, so the passes run at
// the rate of the loads instead of one load latency per term.  The
// intermediates never leave shared memory.  V is the unit-lower V1 with
// explicit zeros above the diagonal, so the sums run over whole rows.
// ---------------------------------------------------------------------------
constexpr int kRowBlock = 4;

// One product pass over nb x nb shared-memory operands: thread (a0, c),
// c = tid % nb, a0 = tid / nb < G = blockDim.x / nb, forms the outputs
// (i, c) for the rows i = a0, a0 + G, ... in blocks of kRowBlock, each
// s = sum_k X(i, k) Y[k][c] with X(i, k) = X[k][i] when kXt, else X[i][k];
// emit(i, c, s) takes each result.  Within a warp c runs over consecutive
// addresses and X is one or two broadcast words: conflict-free.
template <bool kXt, typename T, typename Emit>
__device__ __forceinline__ void rows_times(const T* X, const T* Y, int nb,
                                           Emit emit) {
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

template <typename T>
__device__ __noinline__ void larfb_task(T* ws, const T* d_t, int k, int j,
                                        int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  T* V = reinterpret_cast<T*>(smem_raw);
  T* Tm = V + nn;
  T* C = Tm + nn;
  T* W1 = C + nn;
  T* W2 = W1 + nn;

  const T* diag = ws + ((size_t)k * q + k) * nn;
  T* tile = ws + ((size_t)k * q + j) * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    V[e] = r > c ? __ldcg(diag + e) : (r == c ? T(1) : T(0));
  }
  load_tile(Tm, d_t + (size_t)k * nn, nn);
  load_tile(C, tile, nn);
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
  larfb_task(ws, d_t, idx[3 * blockIdx.x], idx[3 * blockIdx.x + 2], q, nb);
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

template <typename T>
__device__ __noinline__ void tsqrt_task(T* ws, T* t_t, T* t_taus, int k,
                                        int i, int p, int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  const int r_steps = p < q ? p : q;
  T* D = reinterpret_cast<T*>(smem_raw);  // diagonal tile, pitch nb
  T* A = D + nn;                          // sub tile -> V2, pitch nb
  T* Gt = A + nn;                         // transposed Gram matrix
  T* Tm = Gt + nn;                        // T, pitch nb + 1
  T* taus = Tm + nb * (nb + 1);
  T* xch = taus + nb;                     // column exchange, nb <= 32

  T* diag = ws + ((size_t)k * q + k) * nn;
  T* sub = ws + ((size_t)i * q + k) * nn;
  load_tile(D, diag, nn);
  load_tile(A, sub, nn);
  __syncthreads();
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
  tsqrt_task(ws, t_t, t_taus, idx[3 * blockIdx.x], idx[3 * blockIdx.x + 1],
             p, q, nb);
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
template <typename T>
__device__ __noinline__ void ssrfb_task(T* ws, const T* t_t, int k, int i,
                                        int j, int p, int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  const int r_steps = p < q ? p : q;
  T* V2 = reinterpret_cast<T*>(smem_raw);
  T* Tm = V2 + nn;
  T* Ck = Tm + nn;
  T* Ci = Ck + nn;
  T* W = Ci + nn;
  T* W2 = W + nn;

  T* tile_k = ws + ((size_t)k * q + j) * nn;
  T* tile_i = ws + ((size_t)i * q + j) * nn;
  load_tile(V2, ws + ((size_t)i * q + k) * nn, nn);
  load_tile(Tm, t_t + ((size_t)i * r_steps + k) * nn, nn);
  load_tile(Ck, tile_k, nn);
  load_tile(Ci, tile_i, nn);
  __syncthreads();
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
  ssrfb_task(ws, t_t, idx[3 * blockIdx.x], idx[3 * blockIdx.x + 1],
             idx[3 * blockIdx.x + 2], p, q, nb);
}

// ---------------------------------------------------------------------------
// Megakernel — replaces src/repro/core/engine.py: megakernel_kernel (with
// _megakernel_step and _op_copies; launched by _dispatch_megakernel) and
// megakernel_batched_kernel (launched by _dispatch_megakernel_batched).
//
// The task table is the engine's megakernel_task_table: int32 rows of
// kTableCols columns, nslots rows per level, (kind, k, i, j) in columns
// 0..3, the level's tasks first and kNoop rows after them.  The reference
// walks it as a sequential grid on one TPU core; here every level's tasks
// run on concurrent CTAs — in the batched kernel the tasks of all `batch`
// slices of the stacked state, work item w = (slice w / n, slot w % n) —
// and a grid barrier follows each level.  Every slice replays the same
// table, so a slice's result is the single run's, bit for bit.  The
// reference's one-ahead prefetch and REUSE columns are not read: each
// task loads its tiles itself.
//
// Bound: the whole factorization is ~5 nb^3 FLOP per SSRFB and the
// workspace read and written once (6.6 us of FP32 work at 640^2), but the
// schedule is a chain of levels with a grid barrier after each, and
// almost every level holds a GEQRT or a TSQRT, so a call takes about
// levels x (the slowest task of a level + the barrier).
// Design: one launch instead of ~3 per level removes the launch gaps; the
// batched kernel fills the card with the tasks of many slices per level;
// and the GEQRT/TSQRT bodies, which set the level time, run their column
// loops warp-synchronously with no CTA barrier per column (above).
// ---------------------------------------------------------------------------
constexpr int kTableCols = 16;
constexpr int kNoop = 4;

template <typename T>
__device__ __forceinline__ void megakernel_walk(
    T* ws, T* d_t, T* d_taus, T* t_t, T* t_taus, const int* tab,
    int nlevels, int nslots, int batch, int p, int q, int nb,
    unsigned int* barrier) {
  const int nn = nb * nb;
  const int r = p < q ? p : q;
  const size_t s_ws = (size_t)p * q * nn, s_dt = (size_t)r * nn,
               s_dtaus = (size_t)r * nb, s_tt = (size_t)p * r * nn,
               s_ttaus = (size_t)p * r * nb;
  for (int lv = 0; lv < nlevels; ++lv) {
    const int* rows = tab + (size_t)lv * nslots * kTableCols;
    int ntasks = 0;  // the level's tasks precede its kNoop rows
    for (int s0 = 0; s0 < nslots; s0 += blockDim.x) {
      const int s = s0 + threadIdx.x;
      ntasks += __syncthreads_count(s < nslots &&
                                    __ldg(rows + s * kTableCols) != kNoop);
    }
    // The kind is uniform across the CTA, so the bodies' __syncthreads
    // are reached by every thread.
    for (int w = blockIdx.x; w < batch * ntasks; w += gridDim.x) {
      const int b = w / ntasks;
      const int* row = rows + (w - b * ntasks) * kTableCols;
      const int kind = __ldg(row), k = __ldg(row + 1), i = __ldg(row + 2),
                j = __ldg(row + 3);
      T* wsb = ws + b * s_ws;
      switch (kind) {
        case 0:
          geqrt_task(wsb, d_t + b * s_dt, d_taus + b * s_dtaus, k, q, nb);
          break;
        case 1:
          larfb_task(wsb, d_t + b * s_dt, k, j, q, nb);
          break;
        case 2:
          tsqrt_task(wsb, t_t + b * s_tt, t_taus + b * s_ttaus, k, i, p, q, nb);
          break;
        case 3:
          ssrfb_task(wsb, t_t + b * s_tt, k, i, j, p, q, nb);
          break;
        default:
          break;
      }
      __syncthreads();  // the next task reuses this CTA's shared memory
    }
    if (lv + 1 < nlevels) grid_barrier(barrier, gridDim.x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
megakernel_kernel(T* ws, T* d_t, T* d_taus, T* t_t, T* t_taus,
                  const int* tab, int nlevels, int nslots, int batch, int p,
                  int q, int nb, unsigned int* barrier) {
  megakernel_walk(ws, d_t, d_taus, t_t, t_taus, tab, nlevels, nslots, 1, p,
                  q, nb, barrier);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
megakernel_batched_kernel(T* ws, T* d_t, T* d_taus, T* t_t, T* t_taus,
                          const int* tab, int nlevels, int nslots, int batch,
                          int p, int q, int nb, unsigned int* barrier) {
  megakernel_walk(ws, d_t, d_taus, t_t, t_taus, tab, nlevels, nslots, batch,
                  p, q, nb, barrier);
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

// Grid of a megakernel launch: as many CTAs as can be resident at once at
// this shared-memory size (a cooperative launch needs all of them resident
// for the grid barrier), capped at the largest level's work.  0 when not
// one CTA fits, or the device cannot launch cooperatively.
template <typename K>
static cudaError_t megakernel_grid(K kernel, size_t bytes, long work,
                                   int* grid) {
  *grid = 0;
  long resident = 0;
  const cudaError_t err = resident_ctas(kernel, bytes, &resident);
  if (err != cudaSuccess) return err;
  *grid = (int)(work < resident ? work : resident);
  return cudaSuccess;
}

template <typename T>
static int launch_megakernel(bool batched, void* ws, void* d_t, void* d_taus,
                             void* t_t, void* t_taus, const int* tab,
                             int nlevels, int nslots, int batch, int p, int q,
                             int nb, unsigned int* barrier, size_t bytes,
                             cudaStream_t stream, int* grid_out) {
  auto kernel = batched ? megakernel_batched_kernel<T> : megakernel_kernel<T>;
  int grid = 0;
  cudaError_t err = megakernel_grid(kernel, bytes, (long)batch * nslots, &grid);
  if (grid_out != nullptr) *grid_out = grid;
  if (err != cudaSuccess) return (int)err;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  T* a0 = static_cast<T*>(ws);
  T* a1 = static_cast<T*>(d_t);
  T* a2 = static_cast<T*>(d_taus);
  T* a3 = static_cast<T*>(t_t);
  T* a4 = static_cast<T*>(t_taus);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &tab, &nlevels, &nslots, &batch,
                  &p, &q, &nb, &barrier};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static int dispatch_megakernel(bool batched, void* ws, void* d_t,
                               void* d_taus, void* t_t, void* t_taus,
                               const void* tab, int nlevels, int nslots,
                               int batch, int p, int q, int nb, int is_double,
                               int smem_bytes, void* barrier, void* stream,
                               int* grid_out) {
  if (nb < 1 || nb > 32 * kSlots) return (int)cudaErrorInvalidValue;
  const int* tb = static_cast<const int*>(tab);
  unsigned int* bar = static_cast<unsigned int*>(barrier);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? launch_megakernel<double>(batched, ws, d_t, d_taus, t_t, t_taus,
                                         tb, nlevels, nslots, batch, p, q, nb,
                                         bar, bytes, s, grid_out)
             : launch_megakernel<float>(batched, ws, d_t, d_taus, t_t, t_taus,
                                        tb, nlevels, nslots, batch, p, q, nb,
                                        bar, bytes, s, grid_out);
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

// Megakernel entries: (ws, d_t, d_taus, t_t, t_taus, table, nlevels,
// nslots, batch, p, q, nb, is_double, smem_bytes, barrier, stream,
// grid_out).  The state pointers are a single (p, q, ...) state for
// repro_megakernel (batch must be 1) and a stacked (batch, p, q, ...)
// state for repro_megakernel_batched; table is the engine's int32
// (nlevels * nslots, 16) task table on the device; barrier is one
// zeroed uint32 on the device, the grid barrier's counter; *grid_out
// receives the number of CTAs launched (0 if none could be).
int repro_megakernel(void* ws, void* d_t, void* d_taus, void* t_t,
                     void* t_taus, const void* tab, int nlevels, int nslots,
                     int batch, int p, int q, int nb, int is_double,
                     int smem_bytes, void* barrier, void* stream,
                     int* grid_out) {
  if (batch != 1) return (int)cudaErrorInvalidValue;
  return repro::dispatch_megakernel(false, ws, d_t, d_taus, t_t, t_taus, tab,
                                    nlevels, nslots, 1, p, q, nb, is_double,
                                    smem_bytes, barrier, stream, grid_out);
}

int repro_megakernel_batched(void* ws, void* d_t, void* d_taus, void* t_t,
                             void* t_taus, const void* tab, int nlevels,
                             int nslots, int batch, int p, int q, int nb,
                             int is_double, int smem_bytes, void* barrier,
                             void* stream, int* grid_out) {
  return repro::dispatch_megakernel(true, ws, d_t, d_taus, t_t, t_taus, tab,
                                    nlevels, nslots, batch, p, q, nb,
                                    is_double, smem_bytes, barrier, stream,
                                    grid_out);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
