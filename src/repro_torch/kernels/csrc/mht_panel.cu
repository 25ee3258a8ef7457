// The paper's fused MHT panel factorization (DGEQR2HT) as hand-written
// CUDA kernels for Hopper (sm_90a), with a plain C interface loaded through
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
// Bound: 2 m b^2 - 2/3 b^3 FLOP on m b elements read and written once:
// 0.3 us of HBM traffic for a (4096, 32) fp32 panel.  What bounds it is
// latency: b sequential columns, each a reduction over all m rows whose
// result every row's update needs.  The TPU kernel holds the whole panel
// in 8 MiB of VMEM; one H100 CTA has 227 KB of shared memory, so a tall
// panel's rows are split over several CTAs, and the per-column exchange
// between them is the cost to cut.
//
// Design, two paths, chosen by kernels/mht_panel.py: layout() from the
// shape alone:
//
//  * cluster (mht_panel_cluster_kernel), every panel one thread block
//    cluster holds (up to 16 CTAs on neighbouring SMs): each CTA keeps its
//    row block in shared memory for the whole column loop, and the CTAs
//    exchange partials through distributed shared memory with one hardware
//    cluster barrier per column.  The MHT reordering makes that one
//    exchange: right after its update for column j, a CTA makes one local
//    pass that yields its partials for column j + 1 (the tail's squared
//    norm, s_c = x^T A[:, c] over the later columns, and the pivot row
//    from the CTA that owns it); every CTA sums its peers' partials in rank
//    order, so all compute identical coefficients, and forms
//    w_c = tau (A[j][c] + s_c / denom) with no second reduction.  The
//    partial slots are double-buffered by column parity, so one barrier
//    per column is safe.  Warps own rows and lanes columns, so a lane's
//    loads are consecutive (conflict-free) against a broadcast v_r, with
//    no per-element index arithmetic.  One cluster per panel: an ordinary
//    launch for a stack of any size.
//  * group (mht_panel_kernel), panels taller than a cluster holds: the
//    rows are split over a group of CTAs of one cooperative launch that
//    meet at two global-atomic group barriers per column; each group walks
//    the stack's panels.
//
// Accumulation in the element type (float or double); no tensor cores (an
// fp32 product there is TF32, which misses the conformance bar).

#include <cooperative_groups.h>

#include "macro_ops.cuh"

namespace repro {

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

// Most CTAs in a cluster: Hopper's non-portable cluster size
// (kernels/mht_panel.py: MAX_CLUSTER).
constexpr int kMaxCluster = 16;

// Shared memory of the cluster kernel (layout()'s "cluster" carve-up):
//   A     rows x pitch   the CTA's row block, pitch = b | 1 (odd, so a
//                        thread per row reads column j conflict-free)
//   red   kWarps x b     per-warp partials of s_c
//   nrm   kWarps         per-warp partials of the tail's squared norm
//   slot  2 x 2b         the published partials by column parity: the
//                        CTA's sums s_c (s_j = the tail norm), then the
//                        pivot row (written by its owner only)
//   tot   b              the cluster's sums, in rank order
//   piv   b              the pivot row
//   w     b              tau v^T A
template <typename T>
__global__ void __launch_bounds__(kThreads)
mht_panel_cluster_kernel(T* a, long long a_bs, int lda, int m, int b, int kf,
                         T* taus, int rows) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int pitch = b | 1;
  T* A = reinterpret_cast<T*>(smem_raw);
  T* red = A + (size_t)rows * pitch;
  T* nrm = red + (size_t)kWarps * b;
  T* slot = nrm + kWarps;
  T* tot = slot + 4 * b;
  T* piv = tot + b;
  T* w = piv + b;

  const int s = blockIdx.x / cs;
  const int r_lo = g * rows;
  const int nr = max(0, min(rows, m - r_lo));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* pan = a + (size_t)s * a_bs + (size_t)r_lo * lda;
  for (int r = warp; r < nr; r += kWarps)
    for (int c = lane; c < b; c += 32)
      A[r * pitch + c] = __ldcg(pan + (size_t)r * lda + c);
  for (int c = threadIdx.x; c < b; c += blockDim.x) w[c] = T(0);
  __syncthreads();

  // j = -1 is the pass that yields column 0's partials: no reflector, so
  // v = 0 and w = 0, and the update leaves every element as it is.
  T beta = T(0), denom = T(1), rden = T(1);
  for (int j = -1; j < kf; ++j) {
    if (j >= 0) {
      // (1) the cluster's partials for column j, summed in rank order.
      const T* part = slot + (j & 1) * 2 * b;
      const int owner = j / rows;
      for (int c = j + threadIdx.x; c < b; c += blockDim.x) {
        T peer[kMaxCluster];  // every load in flight before the sum
#pragma unroll
        for (int h = 0; h < kMaxCluster; ++h)
          peer[h] = h < cs ? cluster.map_shared_rank(part, h)[c] : T(0);
        const T pv = cluster.map_shared_rank(part + b, owner)[c];
        T acc = T(0);
#pragma unroll
        for (int h = 0; h < kMaxCluster; ++h) acc += peer[h];
        tot[c] = acc;
        piv[c] = pv;
      }
      __syncthreads();
      T tau;
      reflector_coeffs_fast(piv[j], tot[j], &beta, &tau, &denom, &rden);
      for (int c = j + 1 + threadIdx.x; c < b; c += blockDim.x)
        w[c] = tau * (piv[c] + quot(tot[c], denom, rden));
      if (g == 0 && threadIdx.x == 0) taus[(size_t)s * b + j] = tau;
      __syncthreads();
    }
    const bool next = j + 1 < kf;  // column j + 1 pivots: publish partials

    // (2) a thread per row: v and the packed column j, the updated column
    // j + 1 and its part of the tail's squared norm.
    const T wn = j + 1 < b ? w[j + 1] : T(0);
    T n2 = T(0);
    for (int r = threadIdx.x; r < nr; r += blockDim.x) {
      const int gr = r_lo + r;
      if (gr < j) continue;
      T v = T(0);
      if (j >= 0) {
        v = gr == j ? T(1) : quot(A[r * pitch + j], denom, rden);
        A[r * pitch + j] = gr == j ? beta : v;
      }
      if (j + 1 < b) {
        const T x = fma_(-v, wn, A[r * pitch + j + 1]);
        A[r * pitch + j + 1] = x;
        if (gr > j + 1) n2 += x * x;
      }
    }
    n2 = warp_sum(n2);
    if (lane == 0) nrm[warp] = n2;
    __syncthreads();

    // (3) a warp per row, a lane per column after j + 1: the rank-1 update
    // and, in the same pass, s_c = sum_{r > j + 1} x_r A[r][c] against the
    // broadcast updated column x = A[:, j + 1].
    const int r0 = min(nr, max(0, j - r_lo));
    for (int c = j + 2 + lane; c < b; c += 32) {
      const T wc = w[c];
      T acc = T(0);
      for (int r = r0 + warp; r < nr; r += kWarps) {
        const int gr = r_lo + r;
        const T v = j < 0 ? T(0) : (gr == j ? T(1) : A[r * pitch + j]);
        const T y = fma_(-v, wc, A[r * pitch + c]);
        A[r * pitch + c] = y;
        if (gr > j + 1) acc += A[r * pitch + j + 1] * y;
      }
      red[warp * b + c] = acc;
    }
    if (!next) break;
    __syncthreads();

    // (4) publish column j + 1's partials, then the one cluster barrier.
    T* out = slot + ((j + 1) & 1) * 2 * b;
    const int pr = j + 1 - r_lo;
    for (int c = j + 1 + threadIdx.x; c < b; c += blockDim.x) {
      T acc = T(0);
      for (int h = 0; h < kWarps; ++h)
        acc += c == j + 1 ? nrm[h] : red[h * b + c];
      out[c] = acc;
      if (pr >= 0 && pr < nr) out[b + c] = A[pr * pitch + c];
    }
    cluster.sync();
  }
  __syncthreads();
  for (int r = warp; r < nr; r += kWarps)
    for (int c = lane; c < b; c += 32)
      pan[(size_t)r * lda + c] = A[r * pitch + c];
  cluster.sync();  // peers may still read this CTA's last partials
}

// One cluster of `cluster` CTAs per panel, grid = batch x cluster: an
// ordinary launch.  Raises (returns the error) where the device cannot
// hold one such cluster.
template <typename T>
static int launch_mht_panel_cluster(void* a, long long a_bs, int lda, int m,
                                    int b, int kf, void* taus, int batch,
                                    int cluster, int rows, size_t bytes,
                                    cudaStream_t stream, int* grid_out) {
  auto kernel = mht_panel_cluster_kernel<T>;
  *grid_out = 0;
  if (cluster < 1 || cluster > kMaxCluster) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(kernel, bytes);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  *grid_out = batch * cluster;
  T* pa = static_cast<T*>(a);
  T* pt = static_cast<T*>(taus);
  err = cudaLaunchKernelEx(&cfg, kernel, pa, a_bs, lda, m, b, kf, pt, rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
// (a, a_batch_stride, lda, m, b, kf, taus, batch, cluster, rows,
//  is_double, smem_bytes, stream, grid_out): the cluster path, one cluster
// of `cluster` CTAs of `rows` rows per panel; the other arguments as above.
int repro_mht_panel_cluster(void* a, long long a_bs, int lda, int m, int b,
                            int kf, void* taus, int batch, int cluster,
                            int rows, int is_double, int smem_bytes,
                            void* stream, int* grid_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? repro::launch_mht_panel_cluster<double>(
                   a, a_bs, lda, m, b, kf, taus, batch, cluster, rows, bytes,
                   s, grid_out)
             : repro::launch_mht_panel_cluster<float>(
                   a, a_bs, lda, m, b, kf, taus, batch, cluster, rows, bytes,
                   s, grid_out);
}

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
