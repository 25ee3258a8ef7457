// Device helpers shared by the tile-DAG macro-op kernels of macro_ops.cu:
// the LAPACK reflector coefficients, warp reductions, tile copies between
// global and shared memory, the Gram matrix of a tile's reflectors and the
// DLARFT recurrence that forms a block reflector T from it, the grid-wide
// (and group-wide) barrier of cooperative launches, and the host helpers
// that size them.
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
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return ::sqrt(x); }

__device__ __forceinline__ float fma_(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_(double a, double b, double c) {
  return ::fma(a, b, c);
}

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

// reflector_coeffs and rden = 1 / denom, for the column loops' critical
// path.  In fp32 the square root and the reciprocals come from the SFU
// (rsqrt.approx and rcp.approx) and are refined in registers: a Newton
// step each, a residual correction of the square root, and of tau's
// quotient, so each result is within about an ulp of the IEEE one.  The
// IEEE operations are subroutine calls, slow links of a chain that every
// column waits for.  An exactly zero tail still gives tau = 0, beta = x0
// and denom = rden = 1.  fp64 keeps the IEEE operations.
__device__ __forceinline__ float quot(float a, float b, float rb) {
  const float q = a * rb;  // a / b, corrected by its residual
  return fmaf(fmaf(-q, b, a), rb, q);
}

__device__ __forceinline__ double quot(double a, double b, double rb) {
  return a / b;
}

__device__ __forceinline__ void reflector_coeffs_fast(float x0, float tail2,
                                                      float* beta_val,
                                                      float* tau, float* denom,
                                                      float* rden) {
  const float n2 = fmaf(x0, x0, tail2);
  float rs;
  asm("rsqrt.approx.f32 %0, %1;" : "=f"(rs) : "f"(n2));
  rs = rs * fmaf(-0.5f * n2 * rs, rs, 1.5f);
  float norm = n2 * rs;
  norm = fmaf(0.5f * rs, fmaf(-norm, norm, n2), norm);
  const float beta = x0 >= 0.f ? -norm : norm;
  const bool degen = tail2 == 0.f;
  const float d = degen ? 1.f : x0 - beta;
  const float b = degen ? 1.f : beta;
  float rd, rb;
  asm("rcp.approx.f32 %0, %1;" : "=f"(rd) : "f"(d));
  asm("rcp.approx.f32 %0, %1;" : "=f"(rb) : "f"(b));
  rd = fmaf(rd, fmaf(-d, rd, 1.f), rd);
  rb = fmaf(rb, fmaf(-b, rb, 1.f), rb);
  *denom = d;
  *rden = rd;
  *tau = degen ? 0.f : quot(-d, b, rb);
  *beta_val = degen ? x0 : beta;
}

__device__ __forceinline__ void reflector_coeffs_fast(double x0, double tail2,
                                                      double* beta_val,
                                                      double* tau,
                                                      double* denom,
                                                      double* rden) {
  reflector_coeffs(x0, tail2, beta_val, tau, denom);
  *rden = 1.0 / *denom;
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

// Four consecutive elements as 16-byte accesses (two for double); the
// address on a 16-byte boundary.
__device__ __forceinline__ void ld4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}

__device__ __forceinline__ void ld4(const double* p, double (&o)[4]) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  o[0] = x.x; o[1] = x.y; o[2] = y.x; o[3] = y.y;
}

__device__ __forceinline__ void st4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void st4(double* p, const double (&o)[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(o[2], o[3]);
}

// Asynchronous copies global -> shared (cp.async).  The 16-byte form
// caches in L2 only (.cg), like __ldcg; the element form (.ca) is for
// data no other CTA of the launch writes.  A thread's copies complete at
// its cp_async_wait(); a barrier after it publishes them to the CTA.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy n contiguous elements global -> shared, L2 only: 16-byte cp.async
// where both ends and the size allow it, else synchronous __ldcg loads.
// The caller commits, waits and synchronises.
template <typename T>
__device__ __forceinline__ void copy_tile_async(T* dst, const T* src, int n) {
  const bool vec = ((((size_t)dst) | ((size_t)src)) & 15) == 0 &&
                   (n * sizeof(T)) % 16 == 0;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    for (int e = threadIdx.x * kPer; e < n; e += blockDim.x * kPer)
      cp_async16(dst + e, src + e);
  } else {
    load_tile(dst, src, n);
  }
}

// Most columns a lane owns in the warp-synchronous column loops
// (c = lane + 32 t, t < kSlots): tiles up to nb = 128.
constexpr int kSlots = 4;

// Gram matrix of a tile's reflectors, transposed so that every read and
// write is conflict-free: Gt[i * nb + c] = sum_{r >= r0(i)} V[r][c] V[r][i]
// for c < i, with V the nb-row tile A at pitch nb.  `unit`: V is unit lower
// (GEQRT: the r = i term is A[i][c] * 1 and the sum runs over r > i); else
// every row counts (TSQRT's V2).  Warp w takes i = w, w + 8, ...; lane c
// reads A[r][c] (consecutive) against the broadcast A[r][i].
template <typename T>
__device__ __forceinline__ void gram_t(const T* A, T* Gt, int nb, bool unit) {
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < nb; i += blockDim.x >> 5) {
    for (int c = lane; c < i; c += 32) {
      T s = unit ? A[i * nb + c] : T(0);
#pragma unroll 4
      for (int r = unit ? i + 1 : 0; r < nb; ++r)
        s += A[r * nb + c] * A[r * nb + i];
      Gt[i * nb + c] = s;
    }
  }
}

// DLARFT (forward, columnwise): T upper triangular with T[i][i] = tau_i and
// T[0:i, i] = -tau_i * T[0:i, 0:i] G[0:i, i].  Row r of T depends only on
// row r itself (T[r][i] needs T[r][c], c < i), so thread r forms its row
// alone, with no barrier between steps: Tm at pitch nb + 1 (odd, so the
// threads' rows fall in distinct banks) against the broadcast column
// Gt[i][.] of the transposed Gram matrix.  The sum starts at the warp's
// first row; T[r][c] is zero for c < r, so the extra terms add zeros.
// The caller synchronises before reading Tm.
template <typename T>
__device__ __forceinline__ void form_t(const T* Gt, const T* taus, T* Tm,
                                       int nb) {
  const int pitch = nb + 1;
  const int c0 = threadIdx.x & ~31;
  for (int r = threadIdx.x; r < nb; r += blockDim.x) {
    T* row = Tm + r * pitch;
    for (int c = 0; c < nb; ++c) row[c] = c == r ? taus[r] : T(0);
    for (int i = r + 1; i < nb; ++i) {
      const T* g = Gt + i * nb;
      T s = T(0);
#pragma unroll 4
      for (int c = c0; c < i; ++c) s += row[c] * g[c];
      row[i] = -taus[i] * s;
    }
  }
}

// Global copy of Tm (pitch nb + 1) at pitch nb, a warp per row.
template <typename T>
__device__ __forceinline__ void store_t(T* dst, const T* Tm, int nb) {
  for (int r = threadIdx.x >> 5; r < nb; r += blockDim.x >> 5)
    for (int c = threadIdx.x & 31; c < nb; c += 32)
      dst[r * nb + c] = Tm[r * (nb + 1) + c];
}

// form_t for nb <= 32, on warp 0: lane r keeps row r of T in registers,
// the loops over i and c unrolled (static register indices) against the
// broadcast Gt[i][c]; two partial sums per step shorten its chain.
template <typename T>
__device__ __forceinline__ void form_t_reg(const T* Gt, const T* taus, T* Tm,
                                           int nb) {
  const int lane = threadIdx.x & 31;
  T t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i >= nb) break;
    T s0 = T(0), s1 = T(0);
#pragma unroll
    for (int c = 0; c < i; ++c) {
      const T g = Gt[i * nb + c];
      if (c & 1) s1 = fma_(t[c], g, s1); else s0 = fma_(t[c], g, s0);
    }
    const T tau = taus[i];
    t[i] = lane < i ? -tau * (s0 + s1) : (lane == i ? tau : T(0));
  }
  if (lane < nb) {
#pragma unroll
    for (int c = 0; c < 32; ++c)
      if (c < nb) Tm[lane * (nb + 1) + c] = t[c];
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// mbarriers: one thread arms a phase with the bytes it expects (one
// arrival), asynchronous copies or remote stores complete them, and every
// thread waits on the phase.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// The one arrival of a phase, with the bytes it will receive.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
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

// Wait for phase `parity` of `bar` to complete (every expected byte has
// landed); acquire at cluster scope, which also covers stores from a
// cluster's peers; traps after kBarrierTimeoutNs, as group_barrier does.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  const unsigned long long start = global_ns();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (global_ns() - start > kBarrierTimeoutNs) __trap();
  }
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
