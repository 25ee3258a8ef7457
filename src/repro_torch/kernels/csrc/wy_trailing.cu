// The blocked QR trailing update C <- C - V (T^T (V^T C)) as hand-written
// CUDA kernels for Hopper (sm_90a), with a plain C interface loaded through
// ctypes by repro_torch/kernels/wy_trailing.py.
//
// Replaces src/repro/kernels/wy_trailing.py: wy_trailing_kernel (launched
// by wy_trailing_pallas; wrapper src/repro/kernels/ops.py: wy_trailing).
// Runs every trailing update of blocked MHT QR (geqrf_ht, the TSQR leaves
// and merges) and, with T transposed, every panel step of Q formation.
//
// Bound: 4 m k n + 2 k^2 n FLOP on (m k + k^2 + 2 m n) elements moved:
// ~8 FLOP per fp32 byte at k = 32, under the FP32 ridge (20 FLOP per
// byte): memory-bound on paper, C read once and written once.
//
// Design, two layouts, chosen by kernels/wy_trailing.py: layout() from the
// shape alone:
//
//  * cluster (wy_trailing_cluster_kernel), wherever a thread block cluster
//    of at most 16 CTAs holds a column tile's rows: a work item is
//    (matrix s, kBn-column tile of C), and the G CTAs of a cluster split
//    its rows.  Each CTA holds its rows of V in shared memory for a run
//    of items of one matrix and brings each item's C slab in by cp.async.
//    Pass 1 forms the CTA's part of W = V^T C, each thread an 8 x 4 block
//    of W over a quarter of half the rows (three 16-byte shared loads per
//    32 FMAs), the quarters summed by shuffles, the halves in shared
//    memory; each four-column block of the part is pushed (st.async) into
//    the shared memory of the block's owner, CTA b % G, completing on an
//    mbarrier there.  The owner sums its blocks over the G parts in rank
//    order (the cluster sum of mht_panel_cluster_kernel, so every CTA
//    gets the same W), forms their X = T^T W and pushes it into every
//    CTA; each CTA then writes its rows of C - V X.  Items are pipelined:
//    the previous item's pass 2 runs while this one's parts travel, and
//    the C slab, free once pass 1 has read it, takes the next item's C
//    meanwhile (pass 2 reads C again, an L2 hit).  A CTA waits only on its
//    own mbarriers for the bytes it needs; V is read once per run.
//    layout() sizes the CTAs for two an SM where it can, so one cluster's
//    waits overlap another's passes.  No device scratch.  (Measured on the
//    way there, H100 80GB HBM3, 700 W, PERF.md: every CTA pulling all of
//    W from its peers moved 16x the bytes over the cluster's network, and
//    two cluster barriers an item, each waiting on the release of remote
//    stores, cost more than the passes.)
//  * streaming (wy_trailing_kernel), C taller than 16 CTAs hold: each
//    warp streams its own rows through a double-buffered cp.async ring in
//    shared memory, twice (W, then C - V X), with no CTA-wide barrier
//    between rows; where the column tiles are fewer than the resident
//    CTAs, a tile's rows are split over a group of CTAs that add their
//    parts of W at a global group barrier (a cooperative launch).
//
// Accumulation in the element type (float or double); no tensor cores (an
// fp32 product there is TF32, which misses the conformance bar).

#include <cooperative_groups.h>

#include "macro_ops.cuh"

namespace repro {

constexpr int kBn = 32;     // columns of C per work item
constexpr int kKb = 32;     // reflectors per register block (streaming)
constexpr int kRowsW = 8;   // rows a warp stages at a time (streaming)
constexpr int kTrailWarps = kThreads / 32;
constexpr int kStride = kTrailWarps * kRowsW;  // rows a CTA's warps cover
constexpr int kMinRows = kStride;              // fewest rows a split takes
constexpr int kMaxTrailCluster = 16;           // Hopper's non-portable size
// Row pitch padding of the cluster layout's slabs: a pitch of 4 mod 32
// words puts pass 1's four row groups in distinct banks.
constexpr int kPad = 4;

// ---------------------------------------------------------------------------
// cluster layout
// ---------------------------------------------------------------------------
//
// Pushes into a peer's shared memory by st.async, each completing its
// bytes on an mbarrier in the receiving CTA; the receiver arms the barrier
// with the bytes it expects and waits on its phase.  No cluster barrier
// and no release fence sits between a pass and the next (the mbarrier
// helpers are in macro_ops.cuh).

// The address `a` of this CTA's shared memory in CTA `rank`'s.
__device__ __forceinline__ unsigned peer_u32(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void push(unsigned raddr, float x, unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(raddr), "r"(__float_as_uint(x)), "r"(rbar)
      : "memory");
}

__device__ __forceinline__ void push(unsigned raddr, double x, unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(raddr), "l"(__double_as_longlong(x)), "r"(rbar)
      : "memory");
}

// Four consecutive elements in one push (16 bytes for float, 2 x 16 for
// double); raddr on a 16-byte boundary.
__device__ __forceinline__ void push4(unsigned raddr, const float (&x)[4],
                                      unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(raddr),
      "r"(__float_as_uint(x[0])), "r"(__float_as_uint(x[1])),
      "r"(__float_as_uint(x[2])), "r"(__float_as_uint(x[3])), "r"(rbar)
      : "memory");
}

__device__ __forceinline__ void push4(unsigned raddr, const double (&x)[4],
                                      unsigned rbar) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], "
        "{%1, %2}, [%3];\n" ::"r"(raddr + 16 * h),
        "l"(__double_as_longlong(x[2 * h])),
        "l"(__double_as_longlong(x[2 * h + 1])), "r"(rbar)
        : "memory");
}

// Shared memory (kernels/wy_trailing.py: layout(), "cluster"), with
// kp = k rounded up to 4, pv = kp + kPad, pc = kBn + kPad, `rows` (a
// multiple of 8) the CTA's share of a tile's rows, and ncm = 4 ceil(8 / G)
// the most columns of W and X a CTA owns (the four columns 4 b..4 b + 3
// belong to CTA b % G, so a part travels in 16-byte pushes):
//   bars  4 x 8 bytes        mbarriers of recv and X, by item parity
//   V     rows x pv          the CTA's V rows (zero past m and past k)
//   C     rows x pc          the C slab of the item in pass 1
//   recv  2 x G x kp x ncm   every CTA's part of W on the owned columns,
//                            by item parity
//   Wc    kp x ncm           their sum, in rank order
//   X     2 x kp x kBn       T^T W, every column (from its owner), by item
//                            parity; during pass 1 the second row half's
//                            part of W
//   Ts    k x k (to 4)       T of the current matrix
//
// The items of a cluster's run are pipelined: item i's pass 1 and the
// push of its parts of W; the previous item's pass 2 (its X has landed);
// the wait for item i's parts, the owners' sums and the push of X_i; then
// item i + 1's pass 1, and so on.  A CTA waits only for the bytes it
// needs, on its own mbarriers.  The pipeline drains where the run moves
// to another matrix (V and T change).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wy_trailing_cluster_kernel(const T* v, long long v_bs, int ldv, const T* t,
                           T* c, long long c_bs, int ldc, int m, int n, int k,
                           int batch, int rows) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int g = (int)cluster.block_rank();
  const int kp = (k + 3) & ~3, pv = kp + kPad, pc = kBn + kPad;
  constexpr int kBlocks = kBn / 4;  // four-column blocks of a tile
  const int ncm = 4 * ((kBlocks + G - 1) / G);
  const int rsz = G * kp * ncm, xsz = kp * kBn;
  unsigned long long* rbar = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* xbar = rbar + 2;
  T* Vs = reinterpret_cast<T*>(smem_raw + 32);
  T* Cs = Vs + (size_t)rows * pv;
  T* recv = Cs + (size_t)rows * pc;
  T* Wc = recv + 2 * (size_t)rsz;
  T* X = Wc + kp * ncm;
  T* Ts = X + 2 * xsz;
  const int own = (kBlocks - g + G - 1) / G;  // blocks this CTA owns
  const unsigned recv_bytes = (unsigned)(G * kp * 4 * own * sizeof(T));
  const unsigned x_bytes = (unsigned)(kp * kBn * sizeof(T));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_lo = g * rows;
  const int nr = max(0, min(rows, m - row_lo));
  const int tiles = (n + kBn - 1) / kBn;
  const long items = (long)batch * tiles;
  const long ncl = gridDim.x / G, cl = blockIdx.x / G;
  const long i0 = cl * items / ncl, i1 = (cl + 1) * items / ncl;
  // 16-byte copies, loads and stores where every row of the operand
  // starts on a 16-byte boundary; element ones otherwise (a column view).
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_c = ((size_t)c & 15) == 0 && ldc % kVec == 0 &&
                     c_bs % kVec == 0;
  const bool vec_v = ((size_t)v & 15) == 0 && ldv % kVec == 0 &&
                     v_bs % kVec == 0 && k % kVec == 0;

  auto load_v = [&](int s) {
    const T* vs = v + (size_t)s * v_bs + (size_t)row_lo * ldv;
    if (vec_v) {
      const int cpr = kp / kVec;
      for (int e = tid; e < rows * cpr; e += kThreads) {
        const int r = e / cpr, a = (e - r * cpr) * kVec;
        T* dst = Vs + r * pv + a;
        if (r < nr) {
          cp_async16(dst, vs + (size_t)r * ldv + a);
        } else {
#pragma unroll
          for (int u = 0; u < kVec; ++u) dst[u] = T(0);
        }
      }
    } else {
      for (int e = tid; e < rows * kp; e += kThreads) {
        const int r = e / kp, a = e - r * kp;
        T* dst = Vs + r * pv + a;
        if (r < nr && a < k) cp_async_elem(dst, vs + (size_t)r * ldv + a);
        else *dst = T(0);
      }
    }
    const T* ts = t + (size_t)s * k * k;
    for (int e = tid; e < k * k; e += kThreads) cp_async_elem(Ts + e, ts + e);
  };
  auto load_c = [&](long item) {
    const int s = (int)(item / tiles);
    const int c0 = (int)(item - (long)s * tiles) * kBn;
    const int nc = min(kBn, n - c0);
    const T* cs = c + (size_t)s * c_bs + (size_t)row_lo * ldc + c0;
    if (vec_c) {
      constexpr int cpr = kBn / kVec;
      for (int e = tid; e < rows * cpr; e += kThreads) {
        const int r = e / cpr, cc = (e - r * cpr) * kVec;
        T* dst = Cs + r * pc + cc;
        const T* src = cs + (size_t)r * ldc + cc;
        if (r < nr && cc + kVec <= nc) {
          cp_async16(dst, src);
        } else {
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            if (r < nr && cc + u < nc) cp_async_elem(dst + u, src + u);
            else dst[u] = T(0);
          }
        }
      }
    } else {
      for (int e = tid; e < rows * kBn; e += kThreads) {
        const int r = e / kBn, cc = e - r * kBn;
        T* dst = Cs + r * pc + cc;
        if (r < nr && cc < nc) cp_async_elem(dst, cs + (size_t)r * ldc + cc);
        else *dst = T(0);
      }
    }
  };

  // Pass 2 of `item`: thread (rb, cb) writes rows 4 rb..4 rb + 3, columns
  // 4 cb..4 cb + 3 of C - V X.  Its C comes from global memory (L2: pass
  // 1 brought it in), every row loaded before the products so that the
  // loads' latency overlaps them.  (Eight rows a thread read slower on the
  // TSQR leaves, whose 384 rows a CTA split unevenly over the threads.)
  auto pass2 = [&](long item) {
    const int s = (int)(item / tiles);
    const int c0 = (int)(item - (long)s * tiles) * kBn;
    const int nc = min(kBn, n - c0);
    const T* Xi = X + ((item - i0) & 1) * xsz;
    const int cb = tid & 7;
    T* cs = c + (size_t)s * c_bs + (size_t)row_lo * ldc + c0;
    const bool full = vec_c && 4 * cb + 4 <= nc;
    for (int r0 = 4 * (tid >> 3); r0 < nr; r0 += 4 * (kThreads / 8)) {
      T ci[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const T* row = cs + (size_t)(r0 + i) * ldc + 4 * cb;
        if (r0 + i < nr && full) {
          ld4(row, ci[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ci[i][j] = r0 + i < nr && 4 * cb + j < nc ? row[j] : T(0);
        }
      }
      T acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
#pragma unroll 2
      for (int a = 0; a < kp; a += 4) {
        T va[4][4], xa[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ld4(Vs + (r0 + i) * pv + a, va[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) ld4(Xi + (a + q) * kBn + 4 * cb, xa[q]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fma_(va[i][q], xa[q][j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r0 + i >= nr) break;
        T* row = cs + (size_t)(r0 + i) * ldc + 4 * cb;
#pragma unroll
        for (int j = 0; j < 4; ++j) ci[i][j] -= acc[i][j];
        if (full) {
          st4(row, ci[i]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (4 * cb + j < nc) row[j] = ci[i][j];
        }
      }
    }
  };

  if (tid == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(rbar + b);
      mbar_init(xbar + b);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every CTA runs, its barriers set, before a peer pushes
  if (i0 < i1) {
    load_v((int)(i0 / tiles));
    load_c(i0);
    cp_async_commit();
  }
  long pend = -1;          // the item whose pass 2 waits for its X
  unsigned rph = 0, xph = 0;  // phase parity of each barrier, bit per parity
  for (long it = i0; it < i1; ++it) {
    const int s = (int)(it / tiles);
    const int par = (int)((it - i0) & 1);
    if (pend >= 0 && pend / tiles != s) {
      // Another matrix: drain the pipeline before V and T change.
      const int pp = (int)((pend - i0) & 1);
      mbar_wait(xbar + pp, (xph >> pp) & 1);
      xph ^= 1u << pp;
      pass2(pend);
      pend = -1;
      __syncthreads();
      load_v(s);
      load_c(it);
      cp_async_commit();
    }
    if (tid == 0) {  // arm this item's barriers: its parts, then its X
      mbar_expect(rbar + par, recv_bytes);
      mbar_expect(xbar + par, x_bytes);
    }
    cp_async_wait<0>();
    __syncthreads();

    // Pass 1: this CTA's part of W.  Warp w takes reflectors a0..a0 + 7 of
    // each 32-block (a0 = 8 (w % 4)) over half the rows (w / 4), lane
    // (rg, cb) the columns 4 cb..4 cb + 3 over the half's rows = rg mod 4:
    // three 16-byte shared loads per 32 FMAs.  The four row groups are
    // summed by shuffles, the halves in shared memory, half 0 first, and
    // each sum is pushed to its column's owner.  A quarter warp holds rg
    // 0..3 at cb and cb + 4: with the pitches 4 mod 32 words its loads
    // fall in distinct banks.
    T* rcv = recv + par * (size_t)rsz;
    // X's buffer of this parity is free until the owners push X_it, which
    // needs this CTA's parts of the columns a thread reads from it.
    T* scratch = X + par * xsz;
    for (int ab = 0; ab < kp; ab += 32) {
      const int a0 = ab + 8 * (warp & 3), half = warp >> 2;
      const int rg = lane & 3, cb = ((lane >> 2) & 1) * 4 + (lane >> 3);
      T acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = T(0);
      if (a0 < kp) {
#pragma unroll 2
        for (int r = rg + 4 * half; r < rows; r += 8) {
          T va[2][4], ca[4];
          ld4(Vs + r * pv + a0, va[0]);
          if (a0 + 4 < kp) {
            ld4(Vs + r * pv + a0 + 4, va[1]);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) va[1][i] = T(0);
          }
          ld4(Cs + r * pc + 4 * cb, ca);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fma_(va[i >> 2][i & 3], ca[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 1);
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], 2);
        }
      // Lane rg keeps rows rg and rg + 4 of the warp's eight.
      if (half == 1 && a0 < kp) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if ((i & 3) == rg && a0 + i < kp)
            st4(scratch + (a0 + i) * kBn + 4 * cb, acc[i]);
      }
      __syncthreads();
      if (half == 0 && a0 < kp) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if ((i & 3) != rg || a0 + i >= kp) continue;
          T other[4];
          ld4(scratch + (a0 + i) * kBn + 4 * cb, other);
#pragma unroll
          for (int j = 0; j < 4; ++j) other[j] += acc[i][j];
          const int h = cb % G;  // block cb's owner, its block cb / G
          push4(peer_u32(smem_u32(rcv + ((size_t)g * kp + a0 + i) * ncm + 4 * (cb / G)), h),
                other, peer_u32(smem_u32(rbar + par), h));
        }
      }
      __syncthreads();
    }
    // The C slab is read: the next item's streams in meanwhile.
    if (it + 1 < i1 && (it + 1) / tiles == s) {
      load_c(it + 1);
      cp_async_commit();
    }
    if (pend >= 0) {  // the previous item's X has landed: its pass 2
      const int pp = (int)((pend - i0) & 1);
      mbar_wait(xbar + pp, (xph >> pp) & 1);
      xph ^= 1u << pp;
      pass2(pend);
    }
    mbar_wait(rbar + par, (rph >> par) & 1);  // every part of W is here
    rph ^= 1u << par;

    // This CTA's columns of W, summed in rank order, and their X = T^T W,
    // written into every CTA of the cluster.
    // A thread takes one (reflector a, owned block jb): four columns.
    for (int e = tid; e < kp * own; e += kThreads) {
      const int a = e / own, jb = e - a * own;
      T part[kMaxTrailCluster][4];
#pragma unroll
      for (int h = 0; h < kMaxTrailCluster; ++h)
        if (h < G) ld4(rcv + ((size_t)h * kp + a) * ncm + 4 * jb, part[h]);
      T sum[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
      for (int h = 0; h < kMaxTrailCluster; ++h)
        if (h < G)
#pragma unroll
          for (int j = 0; j < 4; ++j) sum[j] += part[h][j];
      st4(Wc + a * ncm + 4 * jb, sum);
    }
    __syncthreads();
    T* Xi = X + par * xsz;
    for (int e = tid; e < kp * own; e += kThreads) {
      const int a = e / own, jb = e - a * own, b4 = 4 * (g + jb * G);
      T sum[4] = {T(0), T(0), T(0), T(0)};
      if (a < k) {
#pragma unroll 4
        for (int q = 0; q < k; ++q) {
          const T tq = Ts[q * k + a];
          T wq[4];
          ld4(Wc + q * ncm + 4 * jb, wq);
#pragma unroll
          for (int j = 0; j < 4; ++j) sum[j] += tq * wq[j];
        }
      }
      const unsigned xa = smem_u32(Xi + a * kBn + b4), xb = smem_u32(xbar + par);
      for (int h = 0; h < G; ++h) push4(peer_u32(xa, h), sum, peer_u32(xb, h));
    }
    pend = it;
  }
  if (pend >= 0) {
    const int pp = (int)((pend - i0) & 1);
    mbar_wait(xbar + pp, (xph >> pp) & 1);
    pass2(pend);
  }
  cluster.sync();  // no CTA leaves while a peer's pushes may target it
}

// One cluster of `cluster` CTAs per run of items, as many clusters as can
// be resident at once (the occupancy query), at most one per item: an
// ordinary launch.  Returns the error where the device cannot hold one
// such cluster.
template <typename T>
static int launch_wy_trailing_cluster(const void* v, long long v_bs, int ldv,
                                      const void* t, void* c, long long c_bs,
                                      int ldc, int m, int n, int k, int batch,
                                      int cluster, int rows, size_t bytes,
                                      cudaStream_t stream, int* grid_out) {
  auto kernel = wy_trailing_cluster_kernel<T>;
  *grid_out = 0;
  if (cluster < 1 || cluster > kMaxTrailCluster || rows % 8)
    return (int)cudaErrorInvalidValue;
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
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorLaunchOutOfResources;
  const long items = (long)batch * ((n + kBn - 1) / kBn);
  const int nclusters = (int)(items < fit ? items : fit);
  cfg.gridDim = dim3((unsigned)(nclusters * cluster));
  *grid_out = nclusters * cluster;
  const T* pv = static_cast<const T*>(v);
  const T* pt = static_cast<const T*>(t);
  T* pc = static_cast<T*>(c);
  err = cudaLaunchKernelEx(&cfg, kernel, pv, v_bs, ldv, pt, pc, c_bs, ldc, m,
                           n, k, batch, rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// streaming layout
// ---------------------------------------------------------------------------
//
// Shared memory (kernels/wy_trailing.py: smem_bytes):
//   S  kTrailWarps x kKb x kBn   each warp's ring of two staging buffers
//                                (kRowsW rows of V, then of C) while
//                                streaming, the warps' partial sums of W
//                                after pass 1
//   W  k x kBn, X k x kBn, Ts k x k.
// Work item: (matrix s, column tile c0) of C, split over a group of
// `splits` CTAs by rows, CTA g taking rows [g rows_per, (g + 1) rows_per).
// Each warp streams its own rows, kRowsW at a time, with no CTA-wide
// barrier between them: while it computes on one ring buffer, the next
// rows arrive in the other by cp.async.  Pass 1 sums a block of kKb
// reflectors of W = V^T C in registers (lane l holds column l, a
// broadcast V read per FMA); the warps' sums are added in a fixed order,
// and with splits > 1 each CTA's W goes to `part` (two slots, by the
// parity of the group's work item) and, after a group barrier, every CTA
// of the group sums the parts in the same order.  Pass 2: lane l holds
// column l of X's block in registers and subtracts its rows of V X.

// Stage rows rb..rb + nrw - 1 of V's reflectors ab..ab + kb - 1 (and of
// C's columns, `want_c`) into a warp's ring buffer: V at pitch kKb, C after
// it at pitch kBn, zero past the rows, the reflectors and the columns.
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* v, int ldv,
                                           const T* c, int ldc, int rb,
                                           int nrw, int ab, int kb, int nc,
                                           bool want_c) {
  const int lane = threadIdx.x & 31;
  T* cb = buf + kRowsW * kKb;
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    const bool row = i < nrw;
    if (row && lane < kb)
      cp_async_elem(buf + i * kKb + lane, v + (size_t)(rb + i) * ldv + ab + lane);
    else
      buf[i * kKb + lane] = T(0);
    if (want_c) {
      if (row && lane < nc)
        cp_async_elem(cb + i * kBn + lane, c + (size_t)(rb + i) * ldc + lane);
      else
        cb[i * kBn + lane] = T(0);
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wy_trailing_kernel(const T* v, long long v_bs, int ldv, const T* t, T* c,
                   long long c_bs, int ldc, int m, int n, int k, int batch,
                   int splits, int rows_per, T* part,
                   unsigned int* barriers) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* S = reinterpret_cast<T*>(smem_raw);
  T* W = S + kTrailWarps * kKb * kBn;
  T* X = W + (size_t)k * kBn;
  T* Ts = X + (size_t)k * kBn;

  constexpr int kBuf = kRowsW * (kKb + kBn);  // one ring buffer
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* ring = S + warp * 2 * kBuf;
  const int g = blockIdx.x % splits;
  const int grp = blockIdx.x / splits;
  const int ngroups = gridDim.x / splits;
  const int r_lo = g * rows_per;
  const int r_hi = min(m, r_lo + rows_per);
  const int col_tiles = (n + kBn - 1) / kBn;
  const size_t wsize = (size_t)k * kBn;
  const int nab = (k + kKb - 1) / kKb;
  const int first = r_lo + warp * kRowsW;   // this warp's first row
  const int nblk = first < r_hi ? (r_hi - first + kStride - 1) / kStride : 0;
  unsigned int* bar = barriers + grp;
  int parity = 0;

  for (int item = grp; item < batch * col_tiles; item += ngroups) {
    const int s = item / col_tiles;
    const int c0 = (item - s * col_tiles) * kBn;
    const int nc = min(kBn, n - c0);
    const T* vs = v + (size_t)s * v_bs;
    T* cs = c + (size_t)s * c_bs + c0;
    const T* ts = t + (size_t)s * k * k;
    for (int e = threadIdx.x; e < k * k; e += blockDim.x) Ts[e] = __ldcg(ts + e);

    // Pass 1: W = V^T C on this CTA's rows, one block of kKb reflectors
    // at a time, the warp's row blocks through the ring.
    for (int ab = 0; ab < k; ab += kKb) {
      const int kb = min(kKb, k - ab);
      T acc[kKb];
#pragma unroll
      for (int a = 0; a < kKb; ++a) acc[a] = T(0);
      if (nblk > 0)
        stage_rows(ring, vs, ldv, cs, ldc, first, min(kRowsW, r_hi - first),
                   ab, kb, nc, true);
      for (int b = 0; b < nblk; ++b) {
        T* buf = ring + (b & 1) * kBuf;
        if (b + 1 < nblk) {
          const int nxt = first + (b + 1) * kStride;
          stage_rows(ring + ((b + 1) & 1) * kBuf, vs, ldv, cs, ldc, nxt,
                     min(kRowsW, r_hi - nxt), ab, kb, nc, true);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncwarp();
        const T* cb = buf + kRowsW * kKb;
#pragma unroll
        for (int i = 0; i < kRowsW; ++i) {
          const T cv = cb[i * kBn + lane];
#pragma unroll
          for (int a = 0; a < kKb; ++a) acc[a] += buf[i * kKb + a] * cv;
        }
        __syncwarp();
      }
      __syncthreads();  // every warp is done with its ring
#pragma unroll
      for (int a = 0; a < kKb; ++a) S[(warp * kKb + a) * kBn + lane] = acc[a];
      __syncthreads();
      for (int e = threadIdx.x; e < kb * kBn; e += blockDim.x) {
        const int a = e / kBn, cc = e - a * kBn;
        T sum = T(0);
        for (int h = 0; h < kTrailWarps; ++h) sum += S[(h * kKb + a) * kBn + cc];
        W[(ab + a) * kBn + cc] = sum;
      }
      __syncthreads();
    }
    if (splits > 1) {
      T* slots = part + ((size_t)(grp * 2 + parity) * splits) * wsize;
      for (size_t e = threadIdx.x; e < wsize; e += blockDim.x)
        slots[g * wsize + e] = W[e];
      group_barrier(bar, splits, g == 0);
      for (size_t e = threadIdx.x; e < wsize; e += blockDim.x) {
        T sum = T(0);
        for (int h = 0; h < splits; ++h) sum += __ldcg(slots + h * wsize + e);
        W[e] = sum;
      }
      parity ^= 1;
      __syncthreads();
    }

    // X = T^T W.
    for (int e = threadIdx.x; e < k * kBn; e += blockDim.x) {
      const int a = e / kBn, cc = e - a * kBn;
      T sum = T(0);
      for (int q = 0; q < k; ++q) sum += Ts[q * k + a] * W[q * kBn + cc];
      X[e] = sum;
    }
    __syncthreads();

    // Pass 2: C -= V X on this CTA's rows; step st is row block st / nab,
    // reflector block st % nab (C staged with the first).
    const int steps = nblk * nab;
    if (steps > 0)
      stage_rows(ring, vs, ldv, cs, ldc, first, min(kRowsW, r_hi - first), 0,
                 min(kKb, k), nc, true);
    T cv[kRowsW], acc[kRowsW];
    for (int st = 0; st < steps; ++st) {
      const int rb = first + (st / nab) * kStride;
      const int ab = (st % nab) * kKb;
      const int kb = min(kKb, k - ab);
      T* buf = ring + (st & 1) * kBuf;
      if (st + 1 < steps) {
        const int rn = first + ((st + 1) / nab) * kStride;
        const int an = ((st + 1) % nab) * kKb;
        stage_rows(ring + ((st + 1) & 1) * kBuf, vs, ldv, cs, ldc, rn,
                   min(kRowsW, r_hi - rn), an, min(kKb, k - an), nc, an == 0);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      if (ab == 0) {
#pragma unroll
        for (int i = 0; i < kRowsW; ++i) {
          cv[i] = buf[kRowsW * kKb + i * kBn + lane];
          acc[i] = T(0);
        }
      }
      T xr[kKb];
#pragma unroll
      for (int a = 0; a < kKb; ++a)
        xr[a] = a < kb ? X[(ab + a) * kBn + lane] : T(0);
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) {
#pragma unroll
        for (int a = 0; a < kKb; ++a) acc[i] += buf[i * kKb + a] * xr[a];
      }
      if (ab + kKb >= k) {
        const int nrw = min(kRowsW, r_hi - rb);
#pragma unroll
        for (int i = 0; i < kRowsW; ++i)
          if (i < nrw && lane < nc)
            cs[(size_t)(rb + i) * ldc + lane] = cv[i] - acc[i];
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

// The work items are the stack's column tiles.  Where they are fewer than
// the CTAs that can be resident at once, each is split by rows over a
// group of as many CTAs as keep every group resident (a group's barrier
// needs all its CTAs running), each taking at least kMinRows rows; the
// launch is then cooperative.  Otherwise an ordinary launch of one CTA
// per item.  *splits_out receives the split.
template <typename T>
static int launch_wy_trailing(const void* v, long long v_bs, int ldv,
                              const void* t, void* c, long long c_bs, int ldc,
                              int m, int n, int k, int batch, void* part,
                              void* barriers, size_t bytes, cudaStream_t stream,
                              int* grid_out, int* splits_out) {
  auto kernel = wy_trailing_kernel<T>;
  *grid_out = 0;
  const long items = (long)batch * ((n + kBn - 1) / kBn);
  long resident = 0;
  cudaError_t err = resident_ctas(kernel, bytes, &resident);
  if (err != cudaSuccess) return (int)err;
  long split = resident / (items > 0 ? items : 1);
  const long most = (m + kMinRows - 1) / kMinRows;
  if (split > most) split = most;
  int splits = split > 1 ? (int)split : 1;
  int rows_per = (m + splits - 1) / splits;
  *splits_out = splits;
  const int grid = (int)items * splits;
  *grid_out = grid;
  const T* pv = static_cast<const T*>(v);
  const T* pt = static_cast<const T*>(t);
  T* pc = static_cast<T*>(c);
  T* pp = static_cast<T*>(part);
  unsigned int* pb = static_cast<unsigned int*>(barriers);
  if (splits == 1) {
    wy_trailing_kernel<T><<<grid, kThreads, bytes, stream>>>(
        pv, v_bs, ldv, pt, pc, c_bs, ldc, m, n, k, batch, splits, rows_per,
        pp, pb);
  } else {
    void* args[] = {&pv, &v_bs, &ldv, &pt, &pc, &c_bs, &ldc, &m, &n, &k,
                    &batch, &splits, &rows_per, &pp, &pb};
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                      dim3(kThreads), args, bytes, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" {

// (v, v_batch_stride, ldv, t, c, c_batch_stride, ldc, m, n, k, batch,
//  part, barriers, is_double, smem_bytes, stream, grid_out, splits_out):
// the streaming layout.  v: batch x m x k, c: batch x m x n (updated in
// place), each with unit column stride and the given row and batch
// strides (elements); t: batch x k x k contiguous; part: 2 * k * 32
// elements of scratch per resident CTA; barriers: one zeroed uint32 per
// column tile of the stack; smem_bytes: the per-CTA size
// (kernels/wy_trailing.py: smem_bytes); *grid_out, *splits_out:
// CTAs launched and CTAs per column tile.
int repro_wy_trailing(const void* v, long long v_bs, int ldv, const void* t,
                      void* c, long long c_bs, int ldc, int m, int n, int k,
                      int batch, void* part, void* barriers, int is_double,
                      int smem_bytes, void* stream, int* grid_out,
                      int* splits_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? repro::launch_wy_trailing<double>(v, v_bs, ldv, t, c, c_bs, ldc,
                                                 m, n, k, batch, part,
                                                 barriers, bytes, s, grid_out,
                                                 splits_out)
             : repro::launch_wy_trailing<float>(v, v_bs, ldv, t, c, c_bs, ldc,
                                                m, n, k, batch, part, barriers,
                                                bytes, s, grid_out,
                                                splits_out);
}

// (v, v_batch_stride, ldv, t, c, c_batch_stride, ldc, m, n, k, batch,
//  cluster, rows, is_double, smem_bytes, stream, grid_out): the cluster
// layout, clusters of `cluster` CTAs of `rows` rows (a multiple of 8); the
// other arguments as above, no scratch.  smem_bytes:
// kernels/wy_trailing.py: layout().
int repro_wy_trailing_cluster(const void* v, long long v_bs, int ldv,
                              const void* t, void* c, long long c_bs, int ldc,
                              int m, int n, int k, int batch, int cluster,
                              int rows, int is_double, int smem_bytes,
                              void* stream, int* grid_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = (size_t)smem_bytes;
  return is_double
             ? repro::launch_wy_trailing_cluster<double>(
                   v, v_bs, ldv, t, c, c_bs, ldc, m, n, k, batch, cluster,
                   rows, bytes, s, grid_out)
             : repro::launch_wy_trailing_cluster<float>(
                   v, v_bs, ldv, t, c, c_bs, ldc, m, n, k, batch, cluster,
                   rows, bytes, s, grid_out);
}

}  // extern "C"
