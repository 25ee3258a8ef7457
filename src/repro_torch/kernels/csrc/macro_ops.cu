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
// Bound: at nb = 32 one task is ~1.7 nb^3 = 55 kFLOP on 12 KB, but the
// column loop is sequential — nb steps, each a warp-reduced tail norm,
// the reflector, w = tau v^T A and a rank-1 update, three barriers apart —
// so a task is latency-bound and the main path runs one task per launch.
// Design: the tile stays in shared memory for the whole column loop and
// the T recurrence, so global memory is touched once in and once out.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __noinline__ void geqrt_task(T* ws, T* d_t, T* d_taus, int k,
                                        int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  T* A = reinterpret_cast<T*>(smem_raw);
  T* G = A + nn;
  T* Tm = G + nn;
  T* v = Tm + nn;
  T* w = v + nb;
  T* taus = w + nb;
  T* coef = taus + nb;  // beta, tau, denom

  T* tile = ws + ((size_t)k * q + k) * nn;
  load_tile(A, tile, nn);
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    column_reflector(A, nb, j, j + 1, A[j * nb + j], coef);
    __syncthreads();
    const T tau = coef[1];
    const T denom = coef[2];
    for (int r = threadIdx.x; r < nb; r += blockDim.x)
      v[r] = r < j ? T(0) : (r == j ? T(1) : A[r * nb + j] / denom);
    __syncthreads();
    for (int c = j + 1 + threadIdx.x; c < nb; c += blockDim.x) {
      T s = T(0);
      for (int r = j; r < nb; ++r) s += v[r] * A[r * nb + c];
      w[c] = tau * s;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int r = e / nb, c = e % nb;
      if (c > j && r >= j) {
        A[e] -= v[r] * w[c];
      } else if (c == j && r >= j) {
        A[e] = r == j ? coef[0] : v[r];
      }
    }
    if (threadIdx.x == 0) taus[j] = tau;
    __syncthreads();
  }

  // Gram matrix of the unit-lower V: for c < i,
  // G[c][i] = V[i][c] + sum_{r > i} V[r][c] V[r][i].
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int c = e / nb, i = e % nb;
    if (c < i) {
      T s = A[i * nb + c];
      for (int r = i + 1; r < nb; ++r) s += A[r * nb + c] * A[r * nb + i];
      G[e] = s;
    }
  }
  __syncthreads();
  form_t(G, taus, Tm, nb);

  store_tile(tile, A, nn);
  store_tile(d_t + (size_t)k * nn, Tm, nn);
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
// paper, launch-bound in practice (at most 63 tasks per launch on the
// 64 x 64 grid).  Design: C = C - V (T^T (V^T C)) as three FMA loops over
// shared memory, one output element per thread per pass; the
// intermediates never leave shared memory.  The products with V run over
// its unit-lower support only; T is applied in full, as the reference
// computes it, so any T gives the reference's result.
// ---------------------------------------------------------------------------
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

  for (int e = threadIdx.x; e < nn; e += blockDim.x) {  // W1 = V^T C
    const int a = e / nb, c = e % nb;
    T s = T(0);
    for (int r = a; r < nb; ++r) s += V[r * nb + a] * C[r * nb + c];
    W1[e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {  // W2 = T^T W1
    const int a = e / nb, c = e % nb;
    T s = T(0);
    for (int b = 0; b < nb; ++b) s += Tm[b * nb + a] * W1[b * nb + c];
    W2[e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {  // C -= V W2
    const int r = e / nb, c = e % nb;
    T s = T(0);
    for (int a = 0; a <= r; ++a) s += V[r * nb + a] * W2[a * nb + c];
    tile[e] = C[e] - s;
  }
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
// Bound: like GEQRT, a sequential column loop (nb steps of norm, reflector,
// w = tau (R[j,:] + v2^T A), rank-1 update) then the stacked T recurrence:
// latency-bound per task; the 64 x 64 grid launches at most 21 at once.
// Design: the reflectors are [e_j; v2_j], so a step touches only row j of
// the triangle and the whole sub tile.  The triangle is factored in place
// in the upper part of the diagonal tile's shared copy, and only that
// upper triangle is written back: the GEQRT V1 below the diagonal stays
// as it is in global memory, where a LARFB of the same level may be
// reading it (and LARFB and Q formation read it later).
// ---------------------------------------------------------------------------
template <typename T>
__device__ __noinline__ void tsqrt_task(T* ws, T* t_t, T* t_taus, int k,
                                        int i, int p, int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  const int r_steps = p < q ? p : q;
  T* D = reinterpret_cast<T*>(smem_raw);
  T* A = D + nn;
  T* V2 = A + nn;
  T* G = V2 + nn;
  T* Tm = G + nn;
  T* w = Tm + nn;
  T* taus = w + nb;
  T* coef = taus + nb;

  T* diag = ws + ((size_t)k * q + k) * nn;
  T* sub = ws + ((size_t)i * q + k) * nn;
  load_tile(D, diag, nn);
  load_tile(A, sub, nn);
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    column_reflector(A, nb, j, 0, D[j * nb + j], coef);
    __syncthreads();
    const T tau = coef[1];
    const T denom = coef[2];
    for (int r = threadIdx.x; r < nb; r += blockDim.x)
      V2[r * nb + j] = A[r * nb + j] / denom;
    __syncthreads();
    for (int c = j + 1 + threadIdx.x; c < nb; c += blockDim.x) {
      T s = T(0);
      for (int r = 0; r < nb; ++r) s += V2[r * nb + j] * A[r * nb + c];
      w[c] = tau * (D[j * nb + c] + s);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < nn; e += blockDim.x) {
      const int r = e / nb, c = e % nb;
      if (c > j) A[e] -= V2[r * nb + j] * w[c];
    }
    for (int c = j + 1 + threadIdx.x; c < nb; c += blockDim.x)
      D[j * nb + c] -= w[c];
    if (threadIdx.x == 0) {
      D[j * nb + j] = coef[0];
      taus[j] = tau;
    }
    __syncthreads();
  }

  // Gram matrix of [I; V2]: for c < i, G[c][i] = sum_r V2[r][c] V2[r][i].
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int c = e / nb, i2 = e % nb;
    if (c < i2) {
      T s = T(0);
      for (int r = 0; r < nb; ++r) s += V2[r * nb + c] * V2[r * nb + i2];
      G[e] = s;
    }
  }
  __syncthreads();
  form_t(G, taus, Tm, nb);

  const size_t slot = (size_t)i * r_steps + k;
  for (int e = threadIdx.x; e < nn; e += blockDim.x)
    if (e / nb <= e % nb) diag[e] = D[e];
  store_tile(sub, V2, nn);
  store_tile(t_t + slot * nn, Tm, nn);
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
// 64 x 64 grid, enough CTAs to fill the 132 SMs several times over).
// Design: W = T^T (C_k + V2^T C_i), C_k -= W, C_i -= V2 W as FMA passes over
// shared memory, each tile read from and written to global memory once.
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

  for (int e = threadIdx.x; e < nn; e += blockDim.x) {  // W = Ck + V2^T Ci
    const int a = e / nb, c = e % nb;
    T s = T(0);
    for (int r = 0; r < nb; ++r) s += V2[r * nb + a] * Ci[r * nb + c];
    W[e] = Ck[e] + s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {  // W2 = T^T W
    const int a = e / nb, c = e % nb;
    T s = T(0);
    for (int b = 0; b < nb; ++b) s += Tm[b * nb + a] * W[b * nb + c];
    W2[e] = s;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    T s = T(0);
    for (int a = 0; a < nb; ++a) s += V2[r * nb + a] * W2[a * nb + c];
    tile_k[e] = Ck[e] - W2[e];
    tile_i[e] = Ci[e] - s;
  }
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
// workspace read and written once; but each level is a barrier, and the
// GEQRT/TSQRT column loops of the critical path are sequential, so a call
// is latency-bound by levels x the slowest task of each.  Design: one
// launch instead of ~3 per level removes the launch gaps; the batched
// kernel fills the card with the tasks of many slices per level.
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
