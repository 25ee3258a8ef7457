// The paper's fused MHT panel factorization (DGEQR2HT) as a hand-written
// CUDA kernel for Hopper (sm_90a), with a plain C interface loaded through
// ctypes by repro_torch/kernels/mht_panel.py.
//
// Replaces src/repro/kernels/mht_panel.py: mht_panel_kernel (launched by
// mht_panel_pallas; wrapper src/repro/kernels/ops.py: mht_panel).
//
// What it computes, per (m, b) panel of a stack, column j pivoting at row j
// (the wrapper passes the rows from the first pivot down): for the
// kf = min(m, b) pivot columns, the LAPACK reflector (beta, tau, v) of the
// column's tail, w = tau v^T A over the columns after j, A -= v w, and the
// packed column (beta at the pivot, v below it).  Every column after j is
// updated, those past kf on a wide panel too.  In place; taus[j] out.
//
// Design.  The TPU kernel holds the whole panel in 8 MiB of VMEM; one H100
// CTA has 227 KB of shared memory, a (1,700, 32) fp32 panel at most.  So a
// panel's rows are split over a group of `groups` CTAs, each holding its
// `rows`-row block for all b columns in shared memory for the whole column
// loop: the panel is read from global memory once and written once.  Per
// column, each CTA reduces its part of the tail's squared norm (the pivot
// comes from the CTA that holds it); after a group barrier every CTA sums
// the parts in the same order and computes identical coefficients; each
// CTA then reduces its part of v^T A, and after a second barrier sums the
// parts and updates its rows.  With one CTA per panel the barriers are
// __syncthreads and the parts stay in shared memory.  The launch is
// cooperative: groups of CTAs are resident together, each group walks the
// stack's panels s = group, group + ngroups, ... with its own barrier
// counter, so a stack of any size is one launch.
//
// Bound: 2 m b^2 - 2/3 b^3 FLOP on m b elements read and written once, ~10
// FLOP per fp32 byte at b = 32: compute-bound on paper.  In practice it is
// latency-bound: b sequential columns, each two CTA-wide reductions and
// (with several CTAs) two group barriers apart; the per-CTA work of a
// column is a few hundred FMAs a thread.
//
// Accumulation in the element type (float or double); no tensor cores (an
// fp32 product there is TF32, which misses the conformance bar).

#include "macro_ops.cuh"

namespace repro {

constexpr int kWarps = kThreads / 32;

// Sum of one value per thread over the CTA, in a fixed order (lanes, then
// warps); every thread gets the result.  `red` holds kWarps partials.
template <typename T>
__device__ __forceinline__ T block_sum(T x, T* red) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  T s = T(0);
  for (int h = 0; h < kWarps; ++h) s += red[h];
  __syncthreads();
  return s;
}

// Shared memory (the carve-up kernels/mht_panel.py's layout() sizes):
//   A     rows x pitch   the CTA's row block, pitch = b | 1 (odd, so a
//                        column's elements fall in distinct banks)
//   v     rows           the current reflector on those rows
//   red   kWarps x b     per-warp partials of v^T A (and of the norm)
//   w     b              tau v^T A
//   coef  8              beta, tau, denom
// Global scratch `part`: per CTA, b + 2 slots (pivot, tail norm part, v^T A
// parts), read by the CTA's group after each barrier.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mht_panel_kernel(T* a, long long a_bs, int lda, int m, int b, int kf,
                 T* taus, int batch, int groups, int rows, T* part,
                 unsigned int* barriers) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = b | 1;
  T* A = reinterpret_cast<T*>(smem_raw);
  T* v = A + (size_t)rows * pitch;
  T* red = v + rows;
  T* w = red + (size_t)kWarps * b;
  T* coef = w + b;

  const int g = blockIdx.x % groups;
  const int grp = blockIdx.x / groups;
  const int ngroups = gridDim.x / groups;
  const int r_lo = g * rows;
  const int nr = max(0, min(rows, m - r_lo));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = b + 2;
  T* gpart = part + (size_t)grp * groups * slot;
  T* mine = gpart + (size_t)g * slot;
  unsigned int* bar = barriers + grp;

  for (int s = grp; s < batch; s += ngroups) {
    T* pan = a + (size_t)s * a_bs + (size_t)r_lo * lda;
    for (int e = threadIdx.x; e < nr * b; e += blockDim.x) {
      const int r = e / b, c = e - r * b;
      A[r * pitch + c] = __ldcg(pan + (size_t)r * lda + c);
    }
    __syncthreads();

    for (int j = 0; j < kf; ++j) {
      // Local rows at or below the pivot row start at r0.
      const int r0 = min(nr, max(0, j - r_lo));
      // (1) this CTA's part of the tail's squared norm.
      T t2 = T(0);
      for (int r = r0 + threadIdx.x; r < nr; r += blockDim.x) {
        if (r_lo + r > j) {
          const T x = A[r * pitch + j];
          t2 += x * x;
        }
      }
      t2 = block_sum(t2, red);
      if (groups == 1) {
        if (threadIdx.x == 0)
          reflector_coeffs(A[j * pitch + j], t2, &coef[0], &coef[1], &coef[2]);
      } else {
        if (threadIdx.x == 0) {
          const bool owner = j >= r_lo && j < r_lo + nr;
          mine[0] = owner ? A[(j - r_lo) * pitch + j] : T(0);
          mine[1] = t2;
        }
        group_barrier(bar, groups, g == 0);
        if (threadIdx.x == 0) {
          T tail2 = T(0);
          for (int h = 0; h < groups; ++h)
            tail2 += __ldcg(gpart + (size_t)h * slot + 1);
          const T x0 = __ldcg(gpart + (size_t)(j / rows) * slot);
          reflector_coeffs(x0, tail2, &coef[0], &coef[1], &coef[2]);
        }
      }
      __syncthreads();
      const T beta = coef[0], tau = coef[1], denom = coef[2];

      // (2) v on this CTA's rows.
      for (int r = threadIdx.x; r < nr; r += blockDim.x) {
        const int gr = r_lo + r;
        v[r] = gr < j ? T(0) : (gr == j ? T(1) : A[r * pitch + j] / denom);
      }
      __syncthreads();

      // (3) this CTA's part of v^T A over the columns after j: a lane per
      // column, a warp per row residue, then the warps' sums in order.
      for (int c = j + 1 + lane; c < b; c += 32) {
        T acc = T(0);
        for (int r = r0 + warp; r < nr; r += kWarps) acc += v[r] * A[r * pitch + c];
        red[warp * b + c] = acc;
      }
      __syncthreads();
      for (int c = j + 1 + threadIdx.x; c < b; c += blockDim.x) {
        T acc = T(0);
        for (int h = 0; h < kWarps; ++h) acc += red[h * b + c];
        if (groups == 1)
          w[c] = tau * acc;
        else
          mine[2 + c] = acc;
      }
      if (groups > 1) {
        group_barrier(bar, groups, g == 0);
        for (int c = j + 1 + threadIdx.x; c < b; c += blockDim.x) {
          T acc = T(0);
          for (int h = 0; h < groups; ++h)
            acc += __ldcg(gpart + (size_t)h * slot + 2 + c);
          w[c] = tau * acc;
        }
      }
      __syncthreads();

      // (4) the fused rank-1 update of the columns after j on the rows at
      // or below the pivot (v is zero above it), then the packed column j.
      const int nt = b - j - 1;
      if (nt > 0) {
        for (int e = threadIdx.x; e < (nr - r0) * nt; e += blockDim.x) {
          const int r = r0 + e / nt, c = j + 1 + e % nt;
          A[r * pitch + c] -= v[r] * w[c];
        }
      }
      for (int r = r0 + threadIdx.x; r < nr; r += blockDim.x)
        A[r * pitch + j] = r_lo + r == j ? beta : v[r];
      if (g == 0 && threadIdx.x == 0) taus[(size_t)s * b + j] = tau;
      __syncthreads();
    }

    for (int e = threadIdx.x; e < nr * b; e += blockDim.x) {
      const int r = e / b, c = e - r * b;
      pan[(size_t)r * lda + c] = A[r * pitch + c];
    }
    __syncthreads();
  }
}

// Groups of `groups` CTAs, as many as can be resident at once (a group's
// barrier needs all its CTAs running), at most one per panel.  One CTA per
// panel needs no barrier, so that launch is an ordinary one of `batch` CTAs.
template <typename T>
static int launch_mht_panel(void* a, long long a_bs, int lda, int m, int b,
                            int kf, void* taus, int batch, int groups,
                            int rows, void* part, void* barriers, size_t bytes,
                            cudaStream_t stream, int* grid_out) {
  auto kernel = mht_panel_kernel<T>;
  *grid_out = 0;
  long ngroups = batch;
  cudaError_t err;
  if (groups == 1) {
    err = prepare(kernel, bytes);
  } else {
    long resident = 0;
    err = resident_ctas(kernel, bytes, &resident);
    if (resident / groups < ngroups) ngroups = resident / groups;
  }
  if (err != cudaSuccess) return (int)err;
  if (ngroups < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = (int)ngroups * groups;
  *grid_out = grid;
  T* pa = static_cast<T*>(a);
  T* pt = static_cast<T*>(taus);
  T* pp = static_cast<T*>(part);
  unsigned int* pb = static_cast<unsigned int*>(barriers);
  if (groups == 1) {
    mht_panel_kernel<T><<<grid, kThreads, bytes, stream>>>(
        pa, a_bs, lda, m, b, kf, pt, batch, groups, rows, pp, pb);
  } else {
    void* args[] = {&pa, &a_bs, &lda, &m, &b, &kf, &pt, &batch, &groups,
                    &rows, &pp, &pb};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                      dim3(kThreads), args, bytes, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

// (a, a_batch_stride, lda, m, b, kf, taus, batch, groups, rows, part,
//  barriers, is_double, smem_bytes, stream, grid_out).  a: `batch` panels
// of m x b, row stride lda, batch stride a_batch_stride (elements), unit
// column stride, factored in place; taus: batch x b, zeroed, kf written per
// panel; part: batch * groups * (b + 2) elements of scratch (groups > 1);
// barriers: batch zeroed uint32 counters; smem_bytes: the layout's size
// per CTA (kernels/mht_panel.py: layout); *grid_out: CTAs launched.
int repro_mht_panel(void* a, long long a_bs, int lda, int m, int b, int kf,
                    void* taus, int batch, int groups, int rows, void* part,
                    void* barriers, int is_double, int smem_bytes, void* stream,
                    int* grid_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? repro::launch_mht_panel<double>(a, a_bs, lda, m, b, kf, taus,
                                               batch, groups, rows, part,
                                               barriers, bytes, s, grid_out)
             : repro::launch_mht_panel<float>(a, a_bs, lda, m, b, kf, taus,
                                              batch, groups, rows, part,
                                              barriers, bytes, s, grid_out);
}

}  // extern "C"
