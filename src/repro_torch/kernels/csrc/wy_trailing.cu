// The blocked QR trailing update C <- C - V (T^T (V^T C)) as a hand-written
// CUDA kernel for Hopper (sm_90a), with a plain C interface loaded through
// ctypes by repro_torch/kernels/wy_trailing.py.
//
// Replaces src/repro/kernels/wy_trailing.py: wy_trailing_kernel (launched
// by wy_trailing_pallas; wrapper src/repro/kernels/ops.py: wy_trailing).
// Runs every trailing update of blocked MHT QR (geqrf_ht, the TSQR leaves
// and merges) and, with T transposed, every panel step of Q formation.
//
// Design.  The TPU kernel broadcasts all of V (m, k) to every column-tile
// program; at (6144, 32) fp32 V alone is 768 KiB, more than a CTA's shared
// memory.  Here a work item is one (matrix, kBn-column tile of C), owned
// by a CTA (or a group of them), which streams V's and C's rows twice:
// pass 1 accumulates W = V^T C (k x kBn), then X = T^T W, and pass 2
// writes C - V X.  W and X never leave shared memory; C is read twice and
// written once, V read twice per tile (from L2 after the first tile).
// The warps stream their own rows with no CTA-wide barrier between them,
// so one warp's loads overlap another's arithmetic, and the sums of a
// block of kKb reflectors live in registers.  Where the stack's column
// tiles are fewer than the CTAs the card holds at once (a 4064-column
// trailing matrix has 127), a tile's rows are split over a group of CTAs
// that add their parts of W at a group barrier (a cooperative launch, as
// in mht_panel.cu).
//
// Bound: 4 m k n + 2 k^2 n FLOP on (m k + k^2 + 2 m n) elements moved:
// ~8 FLOP per fp32 byte at k = 32, under the FP32 ridge (20 FLOP per
// byte): memory-bound on paper.  Few trailing columns (e.g. 160 on a
// stack of 576-row matrices) give short work items.
//
// Accumulation in the element type; no tensor cores.

#include "macro_ops.cuh"

namespace repro {

constexpr int kBn = 32;     // columns of C per work item (a lane each)
constexpr int kKb = 32;     // reflectors per register block
constexpr int kRowsW = 8;   // rows a warp takes at a time
constexpr int kTrailWarps = kThreads / 32;
constexpr int kStride = kTrailWarps * kRowsW;  // rows a CTA's warps cover
constexpr int kMinRows = kStride;              // fewest rows a split takes

// Shared memory (kernels/wy_trailing.py: smem_bytes):
//   S  kTrailWarps x kKb x kBn   each warp's staged V rows (kRowsW x kKb
//                                at its start) while streaming, the warps'
//                                partial sums of W after pass 1
//   W  k x kBn, X k x kBn, Ts k x k.
// Work item: (matrix s, column tile c0) of C, split over a group of
// `splits` CTAs by rows, CTA g taking rows [g rows_per, (g + 1) rows_per).
// Each warp streams its own rows, kRowsW at a time, with no CTA-wide
// barrier between them, so the warps' loads and arithmetic overlap.  A
// warp stages the rows' V in its part of S (one element per lane per row)
// and keeps C's in registers (lane l holds column l).  Pass 1 sums a block
// of kKb reflectors of W = V^T C in registers (a broadcast V read per
// FMA, no C read); the warps' sums are added in a fixed order, and with
// splits > 1 each CTA's W goes to `part` (two slots, by the parity of the
// group's work item) and, after a group barrier, every CTA of the group
// sums the parts in the same order.  Pass 2: lane l holds column l of X's
// block in registers and subtracts its rows of V X.
template <typename T>
__device__ __forceinline__ void stage_rows(T* Sw, T* cv, const T* v, int ldv,
                                           const T* c, int ldc, int rb,
                                           int nrw, int ab, int kb, int nc,
                                           bool want_c) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kRowsW; ++i) {
    const bool row = i < nrw;
    Sw[i * kKb + lane] =
        row && lane < kb ? __ldcg(v + (size_t)(rb + i) * ldv + ab + lane) : T(0);
    if (want_c)
      cv[i] = row && lane < nc ? __ldcg(c + (size_t)(rb + i) * ldc + lane) : T(0);
  }
  __syncwarp();
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

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* Sw = S + warp * kRowsW * kKb;
  const int g = blockIdx.x % splits;
  const int grp = blockIdx.x / splits;
  const int ngroups = gridDim.x / splits;
  const int r_lo = g * rows_per;
  const int r_hi = min(m, r_lo + rows_per);
  const int col_tiles = (n + kBn - 1) / kBn;
  const size_t wsize = (size_t)k * kBn;
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

    // Pass 1: W = V^T C on this CTA's rows.
    for (int ab = 0; ab < k; ab += kKb) {
      const int kb = min(kKb, k - ab);
      T acc[kKb];
#pragma unroll
      for (int a = 0; a < kKb; ++a) acc[a] = T(0);
      for (int rb = r_lo + warp * kRowsW; rb < r_hi; rb += kStride) {
        T cv[kRowsW];
        stage_rows(Sw, cv, vs, ldv, cs, ldc, rb, min(kRowsW, r_hi - rb), ab,
                   kb, nc, true);
#pragma unroll
        for (int i = 0; i < kRowsW; ++i) {
#pragma unroll
          for (int a = 0; a < kKb; ++a) acc[a] += Sw[i * kKb + a] * cv[i];
        }
        __syncwarp();
      }
      __syncthreads();  // every warp is done with its staging area
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

    // Pass 2: C -= V X on this CTA's rows.
    for (int rb = r_lo + warp * kRowsW; rb < r_hi; rb += kStride) {
      const int nrw = min(kRowsW, r_hi - rb);
      T cv[kRowsW], acc[kRowsW];
#pragma unroll
      for (int i = 0; i < kRowsW; ++i) acc[i] = T(0);
      for (int ab = 0; ab < k; ab += kKb) {
        const int kb = min(kKb, k - ab);
        stage_rows(Sw, cv, vs, ldv, cs, ldc, rb, nrw, ab, kb, nc, ab == 0);
        T xr[kKb];
#pragma unroll
        for (int a = 0; a < kKb; ++a)
          xr[a] = a < kb ? X[(ab + a) * kBn + lane] : T(0);
#pragma unroll
        for (int i = 0; i < kRowsW; ++i) {
#pragma unroll
          for (int a = 0; a < kKb; ++a) acc[i] += Sw[i * kKb + a] * xr[a];
        }
        __syncwarp();
      }
#pragma unroll
      for (int i = 0; i < kRowsW; ++i)
        if (i < nrw && lane < nc)
          cs[(size_t)(rb + i) * ldc + lane] = cv[i] - acc[i];
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
//  part, barriers, is_double, smem_bytes, stream, grid_out, splits_out).
// v: batch x m x k, c: batch x m x n (updated in place), each with unit
// column stride and the given row and batch strides (elements); t: batch
// x k x k contiguous; part: 2 * k * 32 elements of scratch per resident
// CTA; barriers: one zeroed uint32 per column tile of the stack;
// smem_bytes: the per-CTA size (kernels/wy_trailing.py: smem_bytes);
// *grid_out, *splits_out: CTAs launched and CTAs per column tile.
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

}  // extern "C"
