// Device helpers shared by the four tile-DAG macro-op kernels of
// macro_ops.cu: the LAPACK reflector coefficients, warp reductions,
// tile copies between global and shared memory, and the DLARFT
// recurrence that forms a block reflector T from a Gram matrix.
//
// Every kernel runs one CTA of kThreads threads per task, holds its
// nb x nb tiles in dynamic shared memory, and accumulates in its element
// type (float or double), which is the reference's promote(dtype, fp32).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace repro {

constexpr int kThreads = 256;

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return ::sqrt(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (beta, tau, denom) from the pivot x0 and the squared tail norm, with
// v = x / denom below the pivot.  An exactly zero tail gives tau = 0 and
// beta = x0: zero-padded rows and columns factor to exact identities.
template <typename T>
__device__ __forceinline__ void reflector_coeffs(T x0, T tail2, T* beta_val,
                                                 T* tau, T* denom) {
  const T norm = sqrt_(x0 * x0 + tail2);
  const T beta = x0 >= T(0) ? -norm : norm;
  const bool degen = tail2 == T(0);
  *denom = degen ? T(1) : x0 - beta;
  *tau = degen ? T(0) : (beta - x0) / (beta == T(0) ? T(1) : beta);
  *beta_val = degen ? x0 : beta;
}

// Sum of src[r * nb + col]^2 over rows [r0, nb), by warp 0; lane 0 turns
// it into reflector coefficients stored at coef[0..2] = (beta, tau, denom).
// The caller synchronises before reading coef.
template <typename T>
__device__ __forceinline__ void column_reflector(const T* src, int nb, int col,
                                                 int r0, T x0, T* coef) {
  if (threadIdx.x < 32) {
    T s = T(0);
    for (int r = r0 + threadIdx.x; r < nb; r += 32) {
      const T x = src[r * nb + col];
      s += x * x;
    }
    s = warp_sum(s);
    if (threadIdx.x == 0) reflector_coeffs(x0, s, &coef[0], &coef[1], &coef[2]);
  }
}

template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

template <typename T>
__device__ __forceinline__ void store_tile(T* dst, const T* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// DLARFT (forward, columnwise): T upper triangular with T[i][i] = tau_i and
// T[0:i, i] = -tau_i * T[0:i, 0:i] G[0:i, i], one column per step.  Only
// the strictly upper part of G (G[c * nb + i], c < i, the Gram matrix of
// the reflectors) is read.  Ends synchronised.
template <typename T>
__device__ void form_t(const T* G, const T* taus, T* Tm, int nb) {
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) Tm[e] = T(0);
  __syncthreads();
  for (int i = 0; i < nb; ++i) {
    const T tau = taus[i];
    for (int r = threadIdx.x; r < i; r += blockDim.x) {
      T s = T(0);
      for (int c = r; c < i; ++c) s += Tm[r * nb + c] * G[c * nb + i];
      Tm[r * nb + i] = -tau * s;
    }
    if (threadIdx.x == 0) Tm[i * nb + i] = tau;
    __syncthreads();
  }
}

}  // namespace repro
