// The four tile-DAG macro ops of tiled QR (GEQRT, LARFB, TSQRT, SSRFB), the
// two updates that form Q from the factored tiles (QLARFB, QSSRFB), and the
// persistent megakernel that runs a whole schedule of them, as hand-written
// CUDA kernels for Hopper (sm_90a), with a plain C interface loaded through
// ctypes by repro_torch/kernels/macro_ops.py.
//
// Each task is a copy of its operand tiles into dynamic shared memory and
// one __device__ __noinline__ compute function (geqrt_compute, ...) that a
// CTA of kThreads threads runs there, writing its outputs back in place.
// The workspace is the (p, q, nb, nb) tile array, row-major inside a tile;
// d_t is (r, nb, nb), d_taus (r, nb), t_t (p, r, nb, nb), t_taus
// (p, r, nb) with r = min(p, q); Q forms in a second tile workspace E,
// (p, qe, nb, nb).  A stack of `batch` such states lies contiguous, slice
// after slice, so each field's slice stride follows from p, q, qe and nb
// (make_walk).  Every lowering calls the same bodies, so the same machine
// code computes every task and the lowerings agree bitwise:
//
//  * GEQRT and TSQRT wavefront kernels (geqrt_kernel, tsqrt_kernel): one
//    launch per (level, kind) for the whole stack, one CTA per (slice,
//    task); task x reads its (k, i, j) from idx[3 x .. 3 x + 2], an int32
//    array the engine uploads once and every slice shares;
//  * the update walk (walk_kernel): one launch per (level, kind) for the
//    LARFB, SSRFB, QLARFB and QSSRFB batches of the whole stack, a
//    persistent grid of the CTAs that fit the card at once, each walking a
//    contiguous run of the level's tasks, slice by slice (walk_run);
//  * the megakernel (megakernel_kernel, megakernel_batched_kernel): one
//    cooperative launch per factorization, per Q formation, or per stack
//    of them, walks the engine's task table level by level, each CTA a
//    contiguous run of every level — the same walk_run — and a grid-wide
//    barrier separates the levels.
//
// The tasks of one level run concurrently in every lowering.  Their writes
// are disjoint (asserted when the engine builds its index arrays and
// tables), and no task reads what another task of its level writes, with
// one exception: LARFB(k, j) reads the strictly-lower V1 of the diagonal
// tile (k, k) while TSQRT(k, i) of the same level rewrites that tile.
// TSQRT therefore writes back only the diagonal tile's upper triangle
// (diagonal included) and never touches V1; no second barrier per level
// is needed.  Global loads go through L2 only (__ldcg, cp.async.cg and the
// bulk copies) so that a tile written on another SM at an earlier level is
// never read stale from L1.
//
// The megakernel raises rather than degrades: a grid that cannot be
// resident at once (cudaLaunchCooperativeKernel refuses it) returns the
// CUDA error, and the wrapper raises.
//
// The update bodies' products: fp64 on the tensor cores as DMMA
// (mma.sync m8n8k4.f64, whose FMAs are IEEE fp64; the tiles are 32 x 32,
// under wgmma's 64 rows), fp32 as register-blocked FMA passes on the CUDA
// cores.  3xTF32 (each operand split hi + lo by cvt.rna.tf32, three
// m16n8k8 products) met the fp32 accuracy bound with room to spare but ran
// slower than the FMA passes at these tiles (PERF.md §6, PR 16), and one
// pass of TF32 misses the bound.  Tiles the fragments do not divide run
// the FMA passes in fp64 too.  GEQRT and TSQRT are column loops on the
// CUDA cores.
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
// order from offset 0, its scratch after them (MacroOp.smem_elems).  CTA
// c of a launch over a stack runs task c % n of slice c / n; the slice's
// fields start at 64-bit offsets (a large stack's fields pass 2^31
// bytes).
template <typename T>
__global__ void __launch_bounds__(kThreads)
geqrt_kernel(T* ws, T* d_t, T* d_taus, const int* idx, int n, int p, int q,
             int nb) {
  const int nn = nb * nb, b = blockIdx.x / n;
  const int k = idx[3 * (blockIdx.x - b * n)];
  const size_t r = p < q ? p : q;
  ws += b * ((size_t)p * q * nn);
  d_t += b * (r * nn);
  d_taus += b * (r * nb);
  copy_tile_async(smem_at<T>(0), ws + ((size_t)k * q + k) * nn, nn);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  geqrt_compute(0, nn, ws, d_t, d_taus, k, q, nb);
}

// ---------------------------------------------------------------------------
// LARFB — replaces src/repro/kernels/macro_ops.py: larfb_wavefront_kernel
// (launched by src/repro/core/engine.py: _dispatch_larfb); QLARFB is its
// update with T for T^T, the diagonal step of src/repro/core/tilegraph.py:
// _form_q_tiled.
//
// Bound: 3 nb^3 FLOP on 4 nb^2 elements moved, about 6 FLOP per byte in
// fp32 at nb = 32, under the card's ridge: memory-bound on paper; one task
// is three dependent nb-term product passes, so a batch is bound by how
// well the copies of the next tasks hide behind the passes of this one.
// Design: C = C - V (T' (V^T C)), T' = T^T (factorization) or T (Q), as
// three product passes (tile_product: DMMA in fp64, FMA in fp32) over
// shared memory; the walk (walk_run) keeps V and T across a same-k run
// and brings the next task's C in while this one computes.  V is the
// unit-lower V1 with explicit zeros above the diagonal, so the sums run
// over whole rows.
// ---------------------------------------------------------------------------

// Row pitch of the update bodies' operand tiles in shared memory: for the
// fp64 tiles the DMMA products take (nb a multiple of 8, up to 64: past it
// the padded buffers would crowd the budget), nb + 4, a pitch of 4 mod 16
// doubles that puts the fragment loads in distinct banks; else nb (the
// FMA passes' loads are conflict-free at nb, and such a tile arrives as
// one bulk copy).  macro_ops.operand_pitch in Python is the same rule.
template <typename T>
__host__ __device__ __forceinline__ int operand_pitch(int nb) {
  if (sizeof(T) == 4) return nb;
  return nb % 8 == 0 && nb <= 64 ? nb + 4 : nb;
}

// One FMA product pass over nb x nb shared-memory operands at pitch nb
// (fp32 tiles and the fp64 tiles DMMA does not take): every output
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

// The fp64 tensor-core product (DMMA, mma.sync m8n8k4).  Warp w takes the
// 8 x 8 output blocks w, w + 8, ... of the tile, K in steps of 4.
// Fragment element (row g = lane / 4, column t = lane % 4) of A is
// X(r0 + g, k0 + t), of B Y[k0 + t][c0 + g]: at the padded pitch every
// fragment load falls in distinct banks.  The accumulator elements are
// (g, 2 t) and (g, 2 t + 1).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// DMMA: two accumulators take alternate K steps (two independent chains)
// and are added last.
template <bool kXt, typename Emit>
__device__ __forceinline__ void mma_product(const double* X, const double* Y,
                                            int p, int nb, Emit emit) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nt = nb >> 3, blocks = nt * nt;
  for (int blk = threadIdx.x >> 5; blk < blocks; blk += blockDim.x >> 5) {
    const int r0 = (blk / nt) * 8, c0 = (blk % nt) * 8;
    double acc[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    for (int k0 = 0; k0 < nb; k0 += 8) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int k = k0 + 4 * s + t;
        const double a = kXt ? X[k * p + r0 + g] : X[(r0 + g) * p + k];
        mma_f64(acc[s], a, Y[k * p + c0 + g]);
      }
    }
    emit(r0 + g, c0 + 2 * t, acc[0][0] + acc[1][0]);
    emit(r0 + g, c0 + 2 * t + 1, acc[0][1] + acc[1][1]);
  }
}

// One product pass of an update body over operands at pitch p
// (operand_pitch): DMMA where the fragments divide an fp64 tile, else the
// FMA passes (p is nb there).
template <bool kXt, typename T, typename Emit>
__device__ __forceinline__ void tile_product(const T* X, const T* Y, int p,
                                             int nb, Emit emit) {
  if constexpr (sizeof(T) == 8) {
    if (nb % 8 == 0) {
      mma_product<kXt>(X, Y, p, nb, emit);
      return;
    }
  }
  rows_times<kXt>(X, Y, nb, emit);
}

// The task bodies take their operands at element offsets into the dynamic
// shared memory (see smem_at) and write their outputs to global memory.
// V arrives as the raw diagonal tile (k, k) and becomes the unit-lower V1
// in place (idempotent, so a reused V passes through unchanged); T and C
// are read only; the scratch holds W1 and W2; `out` is C's tile in global
// memory (the workspace's for LARFB, E's for QLARFB).  All at pitch
// operand_pitch(nb) in shared memory, nb in global memory.
template <bool kQ, typename T>
__device__ __noinline__ void larfb_compute(int o_v, int o_t, int o_c, int o_s,
                                           T* out, int nb) {
  const int pitch = operand_pitch<T>(nb);
  T* V = smem_at<T>(o_v);
  const T* Tm = smem_at<T>(o_t);
  const T* C = smem_at<T>(o_c);
  T* W1 = smem_at<T>(o_s);
  T* W2 = W1 + nb * pitch;
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    if (r <= c) V[r * pitch + c] = r == c ? T(1) : T(0);
  }
  __syncthreads();
  tile_product<true>(V, C, pitch, nb,
                     [&](int a, int c, T s) { W1[a * pitch + c] = s; });
  __syncthreads();
  tile_product<!kQ>(Tm, W1, pitch, nb,
                    [&](int a, int c, T s) { W2[a * pitch + c] = s; });
  __syncthreads();
  tile_product<false>(V, W2, pitch, nb, [&](int r, int c, T s) {
    out[r * nb + c] = C[r * pitch + c] - s;
  });
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
tsqrt_kernel(T* ws, T* t_t, T* t_taus, const int* idx, int n, int p, int q,
             int nb) {
  const int nn = nb * nb, b = blockIdx.x / n, x = blockIdx.x - b * n;
  const int k = idx[3 * x], i = idx[3 * x + 1];
  const size_t r = p < q ? p : q;
  ws += b * ((size_t)p * q * nn);
  t_t += b * ((size_t)p * r * nn);
  t_taus += b * ((size_t)p * r * nb);
  copy_tile_async(smem_at<T>(0), ws + ((size_t)k * q + k) * nn, nn);
  copy_tile_async(smem_at<T>(nn), ws + ((size_t)i * q + k) * nn, nn);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  tsqrt_compute(0, nn, 2 * nn, ws, t_t, t_taus, k, i, p, q, nb);
}

// ---------------------------------------------------------------------------
// SSRFB — replaces src/repro/kernels/macro_ops.py: ssrfb_wavefront_kernel
// (launched by src/repro/core/engine.py: _dispatch_ssrfb); QSSRFB is its
// update with T for T^T, a TSQRT-pair step of src/repro/core/tilegraph.py:
// _form_q_tiled.
//
// Bound: 5 nb^3 FLOP on 6 nb^2 elements moved, about 7 FLOP per byte in
// fp32 at nb = 32: memory-bound by the roofline, and the kernel that
// carries the main path's work (up to 1,113 tasks in one launch on the
// 64 x 64 grid); in the megakernel the stack's levels are SSRFB
// throughput.
// Design: W = T' (C_k + V2^T C_i), C_k -= W, C_i -= V2 W as three product
// passes (DMMA in fp64, FMA in fp32); C_k's update leaves in the second
// pass's epilogue.  The walk keeps V2 and T across a same-(k, i) run and
// brings the next task's C_k and C_i in while this one computes; every
// tile is read from and written to global memory once.
// ---------------------------------------------------------------------------
// V2 and T are read only (a reused pair passes through unchanged); C_k and
// C_i are read from shared memory and their updates written to `out_k` /
// `out_i` in global memory; the scratch holds W and W2.
template <bool kQ, typename T>
__device__ __noinline__ void ssrfb_compute(int o_v, int o_t, int o_ck,
                                           int o_ci, int o_s, T* out_k,
                                           T* out_i, int nb) {
  const int pitch = operand_pitch<T>(nb);
  const T* V2 = smem_at<T>(o_v);
  const T* Tm = smem_at<T>(o_t);
  const T* Ck = smem_at<T>(o_ck);
  const T* Ci = smem_at<T>(o_ci);
  T* W = smem_at<T>(o_s);
  T* W2 = W + nb * pitch;
  tile_product<true>(V2, Ci, pitch, nb, [&](int a, int c, T s) {
    W[a * pitch + c] = Ck[a * pitch + c] + s;
  });
  __syncthreads();
  tile_product<!kQ>(Tm, W, pitch, nb, [&](int a, int c, T s) {
    W2[a * pitch + c] = s;
    out_k[a * nb + c] = Ck[a * pitch + c] - s;
  });
  __syncthreads();
  tile_product<false>(V2, W2, pitch, nb, [&](int r, int c, T s) {
    out_i[r * nb + c] = Ci[r * pitch + c] - s;
  });
}

// ---------------------------------------------------------------------------
// The walk: the megakernels and the update-walk kernel — replaces
// src/repro/core/engine.py: megakernel_kernel (with _megakernel_step and
// _op_copies; launched by _dispatch_megakernel) and
// megakernel_batched_kernel (launched by _dispatch_megakernel_batched);
// walk_kernel carries the LARFB / SSRFB wavefront batches (above) and the
// Q formation's, which the reference computes in jnp
// (src/repro/core/tilegraph.py: _form_q_tiled).
//
// The task table is the engine's megakernel_task_table (or
// q_megakernel_task_table): int32 rows of kTableCols columns, nslots rows
// per level, (kind, k, i, j) in columns 0..3, the level's tasks first and
// kNoop rows after them.  The reference walks it as a sequential grid on
// one TPU core; here every level's tasks run on concurrent CTAs — in the
// batched kernel the tasks of all `batch` slices of the stacked state,
// work item w = (slice w / n, slot w % n) — and a grid barrier follows
// each level.  Every slice replays the same table, so a slice's result is
// the single run's, bit for bit.
//
// Bound: a factorization is ~5 nb^3 FLOP per SSRFB and the workspace read
// and written once (6.6 us of FP32 work at 640^2), but the schedule is a
// chain of levels with a grid barrier after each, so a call takes about
// levels x (the slowest CTA's share of a level + the barrier).  On a stack
// a level holds thousands of tasks over a few hundred resident CTAs, and a
// task's copy-in, passes and store leave the SM idle unless its loads
// overlap another task's arithmetic.
// Design (walk_run): each CTA walks a contiguous run of its level's work
// list — `runs` from the engine for the megakernel (balanced over the
// grid, a same-(k, i) SSRFB group kept whole where that costs little
// balance), an even split for walk_kernel — so consecutive tasks of one
// slice meet on one CTA.  An update after an update of the same kind with
// the same V tile and block reflector (same k for LARFB, same (k, i) for
// SSRFB) keeps both in shared memory.  Every other operand of the next
// task comes in while the current one computes, into a second buffer (a
// CTA whose double buffers do not fit runs one buffer: reuse, no
// prefetch), completing on an mbarrier (issue_copies): a tile stored at
// its own pitch as one bulk asynchronous copy (cp.async.bulk), an fp64
// update tile row by row into the DMMA products' padded pitch.
// ---------------------------------------------------------------------------
constexpr int kTableCols = 16;
constexpr int kNoop = 4;
constexpr int kQLarfb = 5;
constexpr int kQSsrfb = 6;
// The kinds an instantiation of the walk runs (bit k: table kind k): the
// factorization's table, Q formation's, or one wavefront batch's kind.
// Compiling out the other bodies' calls keeps their stack frames out of
// the kernel (the column loops' frames cost every update task of a walk
// that could call them; PERF.md §6, PR 16).
constexpr unsigned kFactorKinds = 0xFu;
constexpr unsigned kQKinds = (1u << kQLarfb) | (1u << kQSsrfb);
// Resident CTAs per SM the batched megakernel is compiled for (the
// register cap __launch_bounds__ sets): uncapped, the walk's state and the
// calls' saved registers take the register file of one CTA, and a
// stack's levels hold work for many more CTAs than the SMs (3 read faster
// than 1, 2 and 4 on the (60, 576, 576) stack).  The single megakernel keeps
// no cap: its levels hold at most a CTA per SM, and the cap slows the
// GEQRT/TSQRT chain that sets its level time.
constexpr int kMegaMinBlocks = 3;

// Bulk copies (cp.async.bulk) into shared memory, completing their bytes
// on an mbarrier (macro_ops.cuh) that one thread has armed with them; the
// walk's barriers expect one arrival from every thread of the CTA.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
}

// Arm the current phase of `bar` with `bytes` more (no arrival).
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Order this thread's generic-proxy accesses before the async proxy's:
// every thread fences its shared-memory writes (the bodies write their
// operand buffers and scratch, which later bulk copies overwrite) before
// the barrier that frees them; the thread that issues the bulk copies
// fences all state spaces, since they read global memory that other CTAs
// wrote.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}

// What a walk reads and writes: the factor state, E (Q formation), the
// slice strides of a stacked state, and the carve-up of shared memory —
// four operand slots (V / D / A tile, T, C / C_k / sub tile, C_i) of
// `stages` buffers of `slot` elements each, slot o buffer b at
// (o * stages + b) * slot, then the compute scratch.
template <typename T>
struct Walk {
  T* ws;
  T* d_t;
  T* d_taus;
  T* t_t;
  T* t_taus;
  T* e;
  int p, q, qe, nb, stages, slot;
  size_t s_ws, s_dt, s_dtaus, s_tt, s_ttaus, s_e;
  bool bulk;  // bulk copies: 16-byte rows and bases; else warp 0 loads
};

template <typename T>
__device__ __forceinline__ Walk<T> make_walk(T* ws, T* d_t, T* d_taus,
                                             T* t_t, T* t_taus, T* e, int p,
                                             int q, int qe, int nb,
                                             int stages) {
  const size_t nn = (size_t)nb * nb, r = p < q ? p : q;
  auto al = [](const void* x) { return ((size_t)x & 15) == 0; };
  Walk<T> st;
  st.ws = ws; st.d_t = d_t; st.d_taus = d_taus; st.t_t = t_t;
  st.t_taus = t_taus; st.e = e;
  st.p = p; st.q = q; st.qe = qe; st.nb = nb; st.stages = stages;
  st.slot = nb * operand_pitch<T>(nb);
  st.s_ws = (size_t)p * q * nn; st.s_dt = r * nn; st.s_dtaus = r * nb;
  st.s_tt = (size_t)p * r * nn; st.s_ttaus = (size_t)p * r * nb;
  st.s_e = (size_t)p * qe * nn;
  st.bulk = (nb * sizeof(T)) % 16 == 0 && al(ws) && al(d_t) && al(t_t) &&
            al(e);
  return st;
}

__host__ __device__ __forceinline__ bool is_update(int kind) {
  return kind == 1 || kind == 3 || kind == kQLarfb || kind == kQSsrfb;
}

// The global tiles of a task's operand slots (nullptr: unused).  An
// update's outputs are its slots 2 and 3 (C / C_k, C_i) in place.
template <typename T>
__device__ __forceinline__ void task_tiles(const Walk<T>& st, int b, int4 t,
                                           T* (&src)[4]) {
  const size_t nn = (size_t)st.nb * st.nb;
  const int r = st.p < st.q ? st.p : st.q, k = t.y, i = t.z, j = t.w;
  T* ws = st.ws + b * st.s_ws;
  T* e = st.e + b * st.s_e;
  T* dt = st.d_t + b * st.s_dt;
  T* tt = st.t_t + b * st.s_tt;
  auto tile = [&](int row, int col) { return ws + ((size_t)row * st.q + col) * nn; };
  auto etile = [&](int row, int col) { return e + ((size_t)row * st.qe + col) * nn; };
  src[0] = src[1] = src[2] = src[3] = nullptr;
  switch (t.x) {
    case 0:
      src[0] = tile(k, k);
      break;
    case 1:
      src[0] = tile(k, k); src[1] = dt + k * nn; src[2] = tile(k, j);
      break;
    case 2:
      src[0] = tile(k, k); src[2] = tile(i, k);
      break;
    case 3:
      src[0] = tile(i, k); src[1] = tt + ((size_t)i * r + k) * nn;
      src[2] = tile(k, j); src[3] = tile(i, j);
      break;
    case kQLarfb:
      src[0] = tile(k, k); src[1] = dt + k * nn; src[2] = etile(k, j);
      break;
    case kQSsrfb:
      src[0] = tile(i, k); src[1] = tt + ((size_t)i * r + k) * nn;
      src[2] = etile(k, j); src[3] = etile(i, j);
      break;
    default:
      break;
  }
}

// Every thread: copy a task's operands into the buffers of its slots
// (bit o of `buf`: slot o's buffer), skipping a kept V (slot 0) and T (slot 1), completing on `bar`
// (one arrival per thread per task).  A tile that lands at its own pitch
// nb (GEQRT's and TSQRT's, and the updates' where operand_pitch is nb)
// goes as one bulk copy (cp.async.bulk) that thread 0 issues, its bytes
// armed on the barrier; an update tile at the padded pitch goes row by
// row as 16-byte cp.async copies spread over the CTA, each thread's
// arrival triggered when its copies land (cp.async.mbarrier.arrive): one
// bulk copy per row was bound by the copy engine's issue rate for such
// small copies (PERF.md §6, PR 16).  Without 16-byte rows and bases the
// threads load synchronously.
template <typename T>
__device__ __forceinline__ void issue_copies(const Walk<T>& st,
                                             T* const (&src)[4], unsigned buf,
                                             bool keep, bool update,
                                             unsigned long long* bar) {
  const int nb = st.nb, nn = nb * nb;
  const int pitch = update ? operand_pitch<T>(nb) : nb;
  const bool whole = st.bulk && pitch == nb;
  auto dst = [&](int o) {
    return smem_at<T>((o * st.stages + ((buf >> o) & 1)) * st.slot);
  };
  if (whole) {
    if (threadIdx.x == 0) {
      unsigned bytes = 0;
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (src[o] != nullptr && !(keep && o < 2)) bytes += nn * sizeof(T);
      fence_proxy_async();
      mbar_expect_tx(bar, bytes);
#pragma unroll
      for (int o = 0; o < 4; ++o)
        if (src[o] != nullptr && !(keep && o < 2))
          bulk_copy(dst(o), src[o], nn * sizeof(T), bar);
    }
    mbar_arrive(bar);
    return;
  }
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    if (src[o] == nullptr || (keep && o < 2)) continue;
    T* d = dst(o);
    if (st.bulk) {
      constexpr int kPer = 16 / sizeof(T);
      const int cpr = nb / kPer;  // 16-byte chunks a row
      for (int x = threadIdx.x; x < nb * cpr; x += blockDim.x) {
        const int r = x / cpr, c = (x - r * cpr) * kPer;
        cp_async16(d + r * pitch + c, src[o] + r * nb + c);
      }
    } else {
      for (int x = threadIdx.x; x < nn; x += blockDim.x)
        d[(x / nb) * pitch + x % nb] = __ldcg(src[o] + x);
    }
  }
  if (st.bulk)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
  else
    mbar_arrive(bar);
}

// The task sources of a walk: a level of the task table (kind from the
// row) or a wavefront batch's (k, i, j) index rows (one kind), item w
// being task w % n of slice w / n either way.
struct TableTasks {
  const int* rows;
  int n;
  __device__ __forceinline__ int4 operator()(int w, int* b) const {
    *b = w / n;
    const int* row = rows + (w - *b * n) * kTableCols;
    return make_int4(__ldg(row), __ldg(row + 1), __ldg(row + 2), __ldg(row + 3));
  }
};

struct IndexTasks {
  const int* idx;
  int kind, n;
  __device__ __forceinline__ int4 operator()(int w, int* b) const {
    *b = w / n;
    const int* row = idx + 3 * (w - *b * n);
    return make_int4(kind, __ldg(row), __ldg(row + 1), __ldg(row + 2));
  }
};

// One CTA's run [w0, w1) of a level.  The run's first kRunStage tasks
// are read into shared memory at its start (`stage`), so no task waits on
// a global load of the next one.  Every task waits for its operands on
// the mbarrier of its parity (`count` counts the CTA's tasks, `phase`
// holds each barrier's next parity); the next task's copies go out before
// this one computes (two buffers) or after it (one); the kind is uniform
// across the CTA, so the bodies' barriers are reached by every thread.
// `st` lies in shared memory and the tiles' addresses are recomputed
// from it, so little of the walk's state is live across the bodies'
// calls (which would save it to the stack).
constexpr int kRunStage = 32;

struct Staged {
  int4 task[kRunStage];
  int slice[kRunStage];
};

template <unsigned kKinds, typename T, typename Tasks>
__device__ __forceinline__ void walk_run(const Walk<T>& st, const Tasks& tasks,
                                         int w0, int w1,
                                         unsigned long long* bars,
                                         unsigned& count, unsigned& phase,
                                         Staged& stage) {
  if (w0 >= w1) return;
  __syncthreads();  // the previous run's staged tasks are read
  for (int x = threadIdx.x; x < w1 - w0 && x < kRunStage; x += blockDim.x)
    stage.task[x] = tasks(w0 + x, &stage.slice[x]);
  __syncthreads();
  auto task_at = [&](int w, int* b) {
    if (w - w0 < kRunStage) {
      *b = stage.slice[w - w0];
      return stage.task[w - w0];
    }
    return tasks(w, b);
  };
  unsigned cur = 0;  // bit o: the buffer that holds slot o's operand
  int b;
  int4 t = task_at(w0, &b);
  {
    T* src[4];
    task_tiles(st, b, t, src);
    issue_copies(st, src, cur, false, is_update(t.x), bars + (count & 1));
  }
  for (int w = w0; w < w1; ++w) {
    const unsigned par = count & 1;
    mbar_wait(bars + par, (phase >> par) & 1);
    phase ^= 1u << par;
    unsigned nxt = cur;
    int nb_ = b;
    int4 n = t;
    bool keep = false;
    const bool more = w + 1 < w1;
    if (more) {
      n = task_at(w + 1, &nb_);
      const bool same_vt = n.y == t.y && (n.x == 1 || n.x == kQLarfb || n.z == t.z);
      keep = nb_ == b && n.x == t.x && is_update(t.x) && same_vt;
      if (st.stages == 2) {
        nxt = cur ^ (keep ? 0xCu : 0xFu);  // a kept V and T stay put
        T* nsrc[4];
        task_tiles(st, nb_, n, nsrc);
        issue_copies(st, nsrc, nxt, keep, is_update(n.x), bars + ((count + 1) & 1));
      }
    }
    {
      T* src[4];
      task_tiles(st, b, t, src);
      const int o_s = 4 * st.stages * st.slot;
      auto at = [&](int o) { return (o * st.stages + ((cur >> o) & 1)) * st.slot; };
      switch (t.x) {
        case 0:
          if constexpr ((kKinds >> 0) & 1)
            geqrt_compute(at(0), o_s, st.ws + b * st.s_ws,
                          st.d_t + b * st.s_dt, st.d_taus + b * st.s_dtaus,
                          t.y, st.q, st.nb);
          break;
        case 1:
          if constexpr ((kKinds >> 1) & 1)
            larfb_compute<false>(at(0), at(1), at(2), o_s, src[2], st.nb);
          break;
        case 2:
          if constexpr ((kKinds >> 2) & 1)
            tsqrt_compute(at(0), at(2), o_s, st.ws + b * st.s_ws,
                          st.t_t + b * st.s_tt, st.t_taus + b * st.s_ttaus,
                          t.y, t.z, st.p, st.q, st.nb);
          break;
        case 3:
          if constexpr ((kKinds >> 3) & 1)
            ssrfb_compute<false>(at(0), at(1), at(2), at(3), o_s, src[2],
                                 src[3], st.nb);
          break;
        case kQLarfb:
          if constexpr ((kKinds >> kQLarfb) & 1)
            larfb_compute<true>(at(0), at(1), at(2), o_s, src[2], st.nb);
          break;
        case kQSsrfb:
          if constexpr ((kKinds >> kQSsrfb) & 1)
            ssrfb_compute<true>(at(0), at(1), at(2), at(3), o_s, src[2],
                                src[3], st.nb);
          break;
        default:
          break;
      }
    }
    fence_proxy_async_shared();
    __syncthreads();  // this task's buffers and the scratch are free
    if (more && st.stages == 1) {
      T* nsrc[4];
      task_tiles(st, nb_, n, nsrc);
      issue_copies(st, nsrc, nxt, keep, is_update(n.x), bars + ((count + 1) & 1));
    }
    cur = nxt;
    t = n;
    b = nb_;
    ++count;
  }
}

// The walk's two mbarriers, each expecting an arrival from every thread.
__device__ __forceinline__ void walk_barriers_init(unsigned long long* bars) {
  if (threadIdx.x == 0)
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(bars + i)), "r"(kThreads)
                   : "memory");
  __syncthreads();
}

template <unsigned kKinds, typename T>
__device__ __forceinline__ void megakernel_walk(const Walk<T>& st,
                                                const int* tab,
                                                const int* runs, int nlevels,
                                                int nslots,
                                                unsigned int* barrier) {
  __shared__ unsigned long long bars[2];
  __shared__ Staged stage;
  walk_barriers_init(bars);  // also publishes `st`
  unsigned count = 0, phase = 0;
  // The runs carry, per (level, CTA), the run's [start, end) and the
  // level's task count (and the run's first task, which the walk reads
  // from the table); the next level's are read while this level's run
  // goes.
  const int4* run4 = reinterpret_cast<const int4*>(runs);
  int4 run = __ldg(run4 + 2 * (size_t)blockIdx.x);
  for (int lv = 0; lv < nlevels; ++lv) {
    const TableTasks tasks{tab + (size_t)lv * nslots * kTableCols, run.z};
    const int w0 = run.x, w1 = run.y;
    if (lv + 1 < nlevels)
      run = __ldg(run4 + 2 * ((size_t)(lv + 1) * gridDim.x + blockIdx.x));
    walk_run<kKinds>(st, tasks, w0, w1, bars, count, phase, stage);
    if (lv + 1 < nlevels) {
      // This level's global writes reach the next level's bulk copies.
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      grid_barrier(barrier, gridDim.x);
    }
  }
}

template <typename T, unsigned kKinds>
__global__ void __launch_bounds__(kThreads)
megakernel_kernel(T* ws, T* d_t, T* d_taus, T* t_t, T* t_taus, T* e,
                  const int* tab, const int* runs, int nlevels, int nslots,
                  int p, int q, int qe, int nb, int stages,
                  unsigned int* barrier) {
  __shared__ Walk<T> st;
  if (threadIdx.x == 0)
    st = make_walk(ws, d_t, d_taus, t_t, t_taus, e, p, q, qe, nb, stages);
  megakernel_walk<kKinds>(st, tab, runs, nlevels, nslots, barrier);
}

template <typename T, unsigned kKinds>
__global__ void __launch_bounds__(kThreads, kMegaMinBlocks)
megakernel_batched_kernel(T* ws, T* d_t, T* d_taus, T* t_t, T* t_taus, T* e,
                          const int* tab, const int* runs, int nlevels,
                          int nslots, int p, int q, int qe, int nb,
                          int stages, unsigned int* barrier) {
  __shared__ Walk<T> st;
  if (threadIdx.x == 0)
    st = make_walk(ws, d_t, d_taus, t_t, t_taus, e, p, q, qe, nb, stages);
  megakernel_walk<kKinds>(st, tab, runs, nlevels, nslots, barrier);
}

// Resident CTAs per SM the update walk is compiled for (the register cap
// __launch_bounds__ sets): three in fp32, two in fp64, whose
// double-buffered padded slots fit two an SM.  Of one to four fp32 CTAs
// an SM, three ran a 2,048^2 SSRFB batch fastest (more spilled, fewer
// left the SM idle; PERF.md §6, PR 16).
template <typename T>
constexpr int kWalkMinBlocks = sizeof(T) == 4 ? 3 : 2;

// One wavefront batch of updates of kind kKind (LARFB, SSRFB, QLARFB or
// QSSRFB; `aux` is d_t or t_t) over every slice of a stack: a persistent
// grid, CTA c walking items [c N / G, (c + 1) N / G) of the N = batch x n
// items in slice-major order (item w: index row w % n of slice w / n), so
// a run's same-k tasks stay together inside a slice and keep their V and T
// (walk_run keeps nothing across a slice boundary).
template <typename T, int kKind>
__global__ void __launch_bounds__(kThreads, kWalkMinBlocks<T>)
walk_kernel(T* ws, T* aux, T* e, const int* idx, int n, int batch, int p,
            int q, int qe, int nb, int stages) {
  __shared__ unsigned long long bars[2];
  __shared__ Staged stage;
  __shared__ Walk<T> st;
  constexpr bool kLarfb = kKind == 1 || kKind == kQLarfb;
  if (threadIdx.x == 0)
    st = make_walk<T>(ws, kLarfb ? aux : nullptr, nullptr,
                      kLarfb ? nullptr : aux, nullptr, e, p, q, qe, nb, stages);
  walk_barriers_init(bars);  // also publishes `st`
  const long long total = (long long)batch * n;
  const int w0 = (int)(blockIdx.x * total / gridDim.x);
  const int w1 = (int)((blockIdx.x + 1) * total / gridDim.x);
  unsigned count = 0, phase = 0;
  walk_run<(1u << kKind)>(st, IndexTasks{idx, kKind, n}, w0, w1, bars, count,
                          phase, stage);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Work items of a launch over `batch` slices of `n` tasks: at most one
// int's worth (the kernels index items, and a CTA's, in int).
static bool items_fit(int n, int batch) {
  return n >= 0 && batch >= 1 && (long long)n * batch <= 0x7fffffffLL;
}

template <typename T>
static int launch(int kind, void* ws, void* aux0, void* aux1, const int* idx,
                  int ntasks, int batch, int p, int q, int nb, size_t bytes,
                  cudaStream_t stream) {
  T* w = static_cast<T*>(ws);
  const int grid = ntasks * batch;
  cudaError_t err = cudaSuccess;
  if (kind == 0) {
    err = prepare(geqrt_kernel<T>, bytes);
    if (err == cudaSuccess)
      geqrt_kernel<T><<<grid, kThreads, bytes, stream>>>(
          w, static_cast<T*>(aux0), static_cast<T*>(aux1), idx, ntasks, p, q,
          nb);
  } else {
    err = prepare(tsqrt_kernel<T>, bytes);
    if (err == cudaSuccess)
      tsqrt_kernel<T><<<grid, kThreads, bytes, stream>>>(
          w, static_cast<T*>(aux0), static_cast<T*>(aux1), idx, ntasks, p, q,
          nb);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The update walk's grid: the CTAs that fit the card at once at this
// shared-memory size (the occupancy query of the kind's instantiation,
// cached per kind, size and device), at most one per work item.
template <typename T>
static int launch_walk(int kind, void* ws, void* aux, void* e, const int* idx,
                       int n, int batch, int p, int q, int qe, int nb,
                       int stages, size_t bytes, cudaStream_t stream,
                       int* grid_out) {
  static size_t cached_bytes[8] = {};
  static int cached_dev[8] = {-1, -1, -1, -1, -1, -1, -1, -1};
  static long cached_resident[8] = {};
  auto kernel = kind == 1   ? walk_kernel<T, 1>
                : kind == 3 ? walk_kernel<T, 3>
                : kind == kQLarfb ? walk_kernel<T, kQLarfb>
                                  : walk_kernel<T, kQSsrfb>;
  *grid_out = 0;
  cudaError_t err = prepare(kernel, bytes);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess &&
      (bytes != cached_bytes[kind] || dev != cached_dev[kind])) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      cached_bytes[kind] = bytes;
      cached_dev[kind] = dev;
      cached_resident[kind] = (long)per_sm * sms;
    }
  }
  if (err != cudaSuccess) return (int)err;
  const long resident = cached_resident[kind];
  const long items = (long)n * batch;
  const int grid = (int)(items < resident ? items : resident);
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<T*>(ws), static_cast<T*>(aux), static_cast<T*>(e), idx, n,
      batch, p, q, qe, nb, stages);
  *grid_out = grid;
  return (int)cudaGetLastError();
}

// The megakernel instantiation: batched or not, over the factorization's
// table or Q formation's.
template <typename T>
static auto megakernel_fn(bool batched, bool q) {
  return batched ? (q ? megakernel_batched_kernel<T, kQKinds>
                      : megakernel_batched_kernel<T, kFactorKinds>)
                 : (q ? megakernel_kernel<T, kQKinds>
                      : megakernel_kernel<T, kFactorKinds>);
}

// The megakernel's grid is chosen by the engine (macro_ops.py), from
// this query: CTAs per SM at this shared-memory size and the CTAs that can
// be resident at once (a cooperative launch needs all of them resident
// for the grid barrier), the most a launch may take.
template <typename T>
static int megakernel_resident(bool batched, bool q, size_t bytes,
                               int* per_sm, int* resident) {
  long total = 0;
  cudaError_t err = resident_ctas(megakernel_fn<T>(batched, q), bytes, &total);
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
                             void* t_t, void* t_taus, void* e, const int* tab,
                             const int* runs, int nlevels, int nslots, int p,
                             int q, int qe, int nb, int stages, int grid,
                             unsigned int* barrier, size_t bytes,
                             cudaStream_t stream, int* grid_out) {
  auto kernel = megakernel_fn<T>(batched, e != nullptr);
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
  T* a5 = static_cast<T*>(e);
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &tab, &runs, &nlevels,
                  &nslots, &p, &q, &qe, &nb, &stages, &barrier};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                    dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

static int dispatch_megakernel(bool batched, void* ws, void* d_t,
                               void* d_taus, void* t_t, void* t_taus, void* e,
                               const void* tab, const void* runs, int nlevels,
                               int nslots, int p, int q, int qe, int nb,
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
                                         e, tb, rn, nlevels, nslots, p, q, qe,
                                         nb, stages, grid, bar, bytes, s,
                                         grid_out)
             : launch_megakernel<float>(batched, ws, d_t, d_taus, t_t, t_taus,
                                        e, tb, rn, nlevels, nslots, p, q, qe,
                                        nb, stages, grid, bar, bytes, s,
                                        grid_out);
}

static int dispatch(int kind, void* ws, void* aux0, void* aux1, const void* idx,
                    int ntasks, int batch, int p, int q, int nb, int is_double,
                    int smem_bytes, void* stream) {
  if (nb < 1 || nb > 32 * kSlots || !items_fit(ntasks, batch))
    return (int)cudaErrorInvalidValue;
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double ? launch<double>(kind, ws, aux0, aux1, ix, ntasks, batch, p,
                                    q, nb, bytes, s)
                   : launch<float>(kind, ws, aux0, aux1, ix, ntasks, batch, p,
                                   q, nb, bytes, s);
}

}  // namespace repro

extern "C" {

// GEQRT / TSQRT: (workspace, aux0, aux1, idx, ntasks, batch, p, q, nb,
// is_double, smem_bytes, stream).  aux0/aux1 are d_t/d_taus (GEQRT),
// t_t/t_taus (TSQRT); the state is a stack of `batch` contiguous slices
// (1: a single state), each running the ntasks index rows.  smem_bytes is
// the dynamic shared memory per CTA: the caller computes it from the
// kernel's layout (MacroOp.smem_elems in macro_ops.py), so the size the
// budget checks read and the size launched are one number.
int repro_geqrt(void* ws, void* a0, void* a1, const void* idx, int n,
                int batch, int p, int q, int nb, int is_double, int smem_bytes,
                void* stream) {
  return repro::dispatch(0, ws, a0, a1, idx, n, batch, p, q, nb, is_double,
                         smem_bytes, stream);
}

int repro_tsqrt(void* ws, void* a0, void* a1, const void* idx, int n,
                int batch, int p, int q, int nb, int is_double, int smem_bytes,
                void* stream) {
  return repro::dispatch(2, ws, a0, a1, idx, n, batch, p, q, nb, is_double,
                         smem_bytes, stream);
}

// The update walk: (kind, ws, aux, e, idx, ntasks, batch, p, q, qe, nb,
// stages, is_double, smem_bytes, stream, grid_out) for kind 1 (LARFB, aux
// = d_t), 3 (SSRFB, aux = t_t), 5 (QLARFB, d_t) or 6 (QSSRFB, t_t); e is
// the (p, qe, nb, nb) Q workspace (unused by LARFB / SSRFB); the state and
// e are stacks of `batch` contiguous slices (1: a single state), each
// running the ntasks index rows; stages the operand buffers per slot (1
// or 2); *grid_out receives the CTAs launched.
int repro_walk(int kind, void* ws, void* aux, void* e, const void* idx, int n,
               int batch, int p, int q, int qe, int nb, int stages,
               int is_double, int smem_bytes, void* stream, int* grid_out) {
  if (!repro::is_update(kind) || nb < 1 || nb > 32 * repro::kSlots ||
      stages < 1 || stages > 2 || !repro::items_fit(n, batch))
    return (int)cudaErrorInvalidValue;
  const int* ix = static_cast<const int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? repro::launch_walk<double>(kind, ws, aux, e, ix, n, batch, p, q,
                                          qe, nb, stages, bytes, s, grid_out)
             : repro::launch_walk<float>(kind, ws, aux, e, ix, n, batch, p, q,
                                         qe, nb, stages, bytes, s, grid_out);
}

// Megakernel entries: (ws, d_t, d_taus, t_t, t_taus, e, table, runs,
// nlevels, nslots, batch, p, q, qe, nb, stages, grid, is_double,
// smem_bytes, barrier, stream, grid_out).  The state pointers are a
// single (p, q, ...) state for repro_megakernel (batch must be 1) and a
// stacked (batch, p, q, ...) state for repro_megakernel_batched; e is the
// (p, qe, nb, nb) Q workspace (stacked likewise) the Q table's tasks
// update (the factorization's table does not read it); table is the
// engine's int32 (nlevels * nslots, 16) task table on the device; runs
// the int32 (nlevels, grid, 8) [start, end, level's task count, first
// task's slot, its kind, k, i, j] of each CTA's run of each level's work
// list (engine.megakernel_runs); stages the operand buffers per slot (1
// or 2); grid at most the resident CTAs (repro_megakernel_resident, q
// set for a Q table: a non-null e selects Q formation's instantiation);
// barrier is one zeroed uint32 on the device, the grid barrier's counter;
// *grid_out receives the number of CTAs launched (0 if none could be).
int repro_megakernel(void* ws, void* d_t, void* d_taus, void* t_t,
                     void* t_taus, void* e, const void* tab, const void* runs,
                     int nlevels, int nslots, int batch, int p, int q, int qe,
                     int nb, int stages, int grid, int is_double,
                     int smem_bytes, void* barrier, void* stream,
                     int* grid_out) {
  if (batch != 1) return (int)cudaErrorInvalidValue;
  return repro::dispatch_megakernel(false, ws, d_t, d_taus, t_t, t_taus, e,
                                    tab, runs, nlevels, nslots, p, q, qe, nb,
                                    stages, grid, is_double, smem_bytes,
                                    barrier, stream, grid_out);
}

int repro_megakernel_batched(void* ws, void* d_t, void* d_taus, void* t_t,
                             void* t_taus, void* e, const void* tab,
                             const void* runs, int nlevels, int nslots,
                             int batch, int p, int q, int qe, int nb,
                             int stages, int grid, int is_double,
                             int smem_bytes, void* barrier, void* stream,
                             int* grid_out) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  return repro::dispatch_megakernel(true, ws, d_t, d_taus, t_t, t_taus, e,
                                    tab, runs, nlevels, nslots, p, q, qe, nb,
                                    stages, grid, is_double, smem_bytes,
                                    barrier, stream, grid_out);
}

// (batched, q, is_double, smem_bytes, per_sm_out, resident_out): the
// megakernel's CTAs per SM and resident CTAs at this shared-memory size,
// for the factorization's instantiation or (q) Q formation's.
int repro_megakernel_resident(int batched, int q, int is_double,
                              int smem_bytes, int* per_sm, int* resident) {
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? repro::megakernel_resident<double>(batched != 0, q != 0, bytes,
                                                  per_sm, resident)
             : repro::megakernel_resident<float>(batched != 0, q != 0, bytes,
                                                 per_sm, resident);
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
