// Device helpers shared by the tile-DAG macro-op kernels of macro_ops.cu:
// the LAPACK reflector coefficients, warp reductions, tile copies between
// global and shared memory, the DLARFT recurrence that forms a block
// reflector T from a Gram matrix, the grid-wide (and group-wide) barrier
// of cooperative launches, and the host helpers that size them.
//
// Every kernel runs CTAs of kThreads threads that hold their operands in
// dynamic shared memory and accumulate in the element type (float or
// double), which is the reference's promote(dtype, fp32).  Included by
// macro_ops.cu, mht_panel.cu and wy_trailing.cu.
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

// Global loads go through L2 only (ld.global.cg): in the megakernel a
// tile one SM wrote at level L is read by another SM at level L + 1, and
// an L1 line from an earlier read would be stale.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = __ldcg(src + e);
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

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Barrier of n CTAs of a cooperative launch (every CTA resident): the
// whole grid, or one group of CTAs that shares a counter.  One 32-bit
// counter, zero before the launch: the leader adds 2^31 - (n - 1) and
// every other CTA adds 1, so the top bit flips exactly when all n CTAs
// have arrived and the low 31 bits are zero again afterwards.  The fences
// publish the CTA's global writes before its arrival and order the reads
// after the barrier behind the other CTAs' writes.  A wait of more than
// kBarrierTimeoutNs (a level takes milliseconds) traps, so a broken
// barrier fails the launch instead of hanging the card.
constexpr unsigned long long kBarrierTimeoutNs = 10000000000ull;

__device__ __forceinline__ void group_barrier(unsigned int* arrived,
                                              unsigned int n, bool leader) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = leader ? 0x80000000u - (n - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(arrived, add);
    const unsigned long long start = global_ns();
    while (((old ^ *(volatile unsigned int*)arrived) & 0x80000000u) == 0) {
      __nanosleep(32);
      if (global_ns() - start > kBarrierTimeoutNs) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void grid_barrier(unsigned int* arrived,
                                             unsigned int nblocks) {
  group_barrier(arrived, nblocks, blockIdx.x == 0);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
static cudaError_t prepare(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// CTAs of `kernel` (kThreads threads, `bytes` of dynamic shared memory) that
// can be resident at once on the current device: the most a cooperative
// launch may take.  Fails with cudaErrorNotSupported where the device
// cannot launch cooperatively.
template <typename K>
static cudaError_t resident_ctas(K kernel, size_t bytes, long* resident) {
  *resident = 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = prepare(kernel, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  *resident = (long)per_sm * sms;
  return cudaSuccess;
}

}  // namespace repro
