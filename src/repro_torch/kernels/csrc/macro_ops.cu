// The four tile-DAG macro ops of tiled QR (GEQRT, LARFB, TSQRT, SSRFB) as
// hand-written CUDA kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by repro_torch/kernels/macro_ops.py.
//
// Launch shape (all four): one CTA of kThreads threads per task of the
// launch's batch.  Task b reads its (k, i, j) from idx[3 b .. 3 b + 2],
// an int32 array the engine uploads once per tile grid.  The workspace is
// the (p, q, nb, nb) tile array, row-major inside a tile; d_t is
// (r, nb, nb), d_taus (r, nb), t_t (p, r, nb, nb), t_taus (p, r, nb) with
// r = min(p, q).  Every task copies its tiles into dynamic shared memory,
// works there, and writes its outputs back in place.  Each kernel's
// carve-up of that memory is at its top; its size in elements is the
// kernel's MacroOp.smem_elems in macro_ops.py, which the launch passes.  The CTAs of one
// launch run concurrently: the engine only batches tasks of one wavefront
// level, whose writes are disjoint (asserted when it builds idx) and whose
// reads never touch another task's writes, save LARFB's read of the
// strictly-lower V1 of a diagonal tile whose upper triangle a TSQRT of the
// same level rewrites — the engine launches LARFB first on one stream.
//
// No tensor cores: an fp32 product there is TF32, which would miss the
// conformance bar.  Every product is an FMA loop on the CUDA cores, so the
// compute bound is the FP32 (or FP64) SIMT rate.
//
// Each C entry returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not 0.

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
__global__ void __launch_bounds__(kThreads)
geqrt_kernel(T* ws, T* d_t, T* d_taus, const int* idx, int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  T* A = reinterpret_cast<T*>(smem_raw);
  T* G = A + nn;
  T* Tm = G + nn;
  T* v = Tm + nn;
  T* w = v + nb;
  T* taus = w + nb;
  T* coef = taus + nb;  // beta, tau, denom

  const int k = idx[3 * blockIdx.x];
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
__global__ void __launch_bounds__(kThreads)
larfb_kernel(T* ws, const T* d_t, const int* idx, int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  T* V = reinterpret_cast<T*>(smem_raw);
  T* Tm = V + nn;
  T* C = Tm + nn;
  T* W1 = C + nn;
  T* W2 = W1 + nn;

  const int k = idx[3 * blockIdx.x];
  const int j = idx[3 * blockIdx.x + 2];
  const T* diag = ws + ((size_t)k * q + k) * nn;
  T* tile = ws + ((size_t)k * q + j) * nn;
  for (int e = threadIdx.x; e < nn; e += blockDim.x) {
    const int r = e / nb, c = e % nb;
    V[e] = r > c ? diag[e] : (r == c ? T(1) : T(0));
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

// ---------------------------------------------------------------------------
// TSQRT — replaces src/repro/kernels/macro_ops.py: tsqrt_wavefront_kernel
// (launched by src/repro/core/engine.py: _dispatch_tsqrt).
//
// Bound: like GEQRT, a sequential column loop (nb steps of norm, reflector,
// w = tau (R[j,:] + v2^T A), rank-1 update) then the stacked T recurrence:
// latency-bound per task; the 64 x 64 grid launches at most 21 at once.
// Design: the reflectors are [e_j; v2_j], so a step touches only row j of
// the triangle and the whole sub tile.  The triangle is factored in place
// in the upper part of the diagonal tile's shared copy, which leaves the
// GEQRT V1 below the diagonal untouched for the merged write-back (LARFB
// and Q formation read it later).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
tsqrt_kernel(T* ws, T* t_t, T* t_taus, const int* idx, int p, int q, int nb) {
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

  const int k = idx[3 * blockIdx.x];
  const int i = idx[3 * blockIdx.x + 1];
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
  store_tile(diag, D, nn);
  store_tile(sub, V2, nn);
  store_tile(t_t + slot * nn, Tm, nn);
  store_tile(t_taus + slot * nb, taus, nb);
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
__global__ void __launch_bounds__(kThreads)
ssrfb_kernel(T* ws, const T* t_t, const int* idx, int p, int q, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nn = nb * nb;
  const int r_steps = p < q ? p : q;
  T* V2 = reinterpret_cast<T*>(smem_raw);
  T* Tm = V2 + nn;
  T* Ck = Tm + nn;
  T* Ci = Ck + nn;
  T* W = Ci + nn;
  T* W2 = W + nn;

  const int k = idx[3 * blockIdx.x];
  const int i = idx[3 * blockIdx.x + 1];
  const int j = idx[3 * blockIdx.x + 2];
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

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename K>
static cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

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

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
