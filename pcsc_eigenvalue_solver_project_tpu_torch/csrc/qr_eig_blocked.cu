// Blocked shifted Givens QR sweeps for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/qr_eig_blocked.py:
//   B13 _qr_blocked_kernel (:63), reached through qr_eig_blocked_planes,
//       _step_pallas and _step_pallas_q -> qr_eig_blocked_sweeps
// on float2 and double2 ((re, im) in (.x, .y), the four-FMA product).
//
// Each sweep on the active window [lo, hi) of the Hessenberg H (that of B8,
// qr_kernels.cu): the shift mu (Wilkinson's from the trailing active 2x2, or
// the caller's schedule: sweep s takes shifts[s % n_shifts]); H - mu I on the
// window; the left rotations k = lo .. hi-2 in blocks of bs (block i owns
// b = lo + i bs .. e - 1 with e = min(b + bs, hi - 1), its rows are b .. e);
// then the right rotations block by block in order (consecutive blocks share
// column e); + mu I; the deflation scan into the new hi and lo.
//
// What bounds it on this card, and what the design does about it:
//  * The rotations form a serial chain: rotation k is formed from column k
//    after rotation k - 1 has been applied. B8 runs the whole sweep in one
//    block, so every rotation rewrites a row pair of length n on one SM, and
//    a sweep costs O(n^2) time on one SM of 132. Here the chain touches only
//    a (bs + 1) x (bs + 2) window per block in shared memory (window_kernel,
//    one block, one barrier per rotation: the thread that owns column k + 1
//    forms rotation k + 1, as in B8), and the block's rotations are
//    accumulated into U_b ((bs + 1) x (bs + 1), from I), which is kept in
//    device memory for the right pass (not rebuilt from coefficients).
//  * The O(n) work per rotation becomes products that run on every SM, written
//    by hand (FMA in the working precision, no tensor cores, so no TF32):
//    slab_kernel, rows b .. e times columns e + 1 .. col_end := U_b * slab
//    (col_end = hi for eigenvalues, n in Schur mode), a block per 32 columns;
//    right_kernel, rows 0 .. min(e + 2, n) - 1 times columns b .. e :=
//    . * U_b^H, and in Schur mode Q's columns b .. e over all n rows, a block
//    per 32 rows. A full-window sweep moves about 4 n^2 elements of H (8 n^2
//    with Q, whose columns and H's slabs run through all n) and does (bs + 1)
//    complex multiply-adds per element touched: bytes-bound at bs <= 64, so
//    the chain of n rotations behind barriers, plus the launches, bound it.
//  * Launches: per sweep one window and one slab launch per block, one right
//    launch per block and one boundary launch (3 nblk + 1). hi and lo live on
//    the device; the host reads them before each chunk of about
//    launches_per_read launches (as B10 reads its flag) and enqueues the
//    chunk's sweeps with the nblk of the hi it read, and every kernel returns
//    at once when its block lies past the live window or the iteration is
//    done (the TPU kernel's pl.when(bi < nblk)). The chunk bounds the
//    launches wasted after convergence. A persistent kernel or a CUDA graph
//    of a sweep is later work.
//  * boundary_kernel, one block between sweeps: adds the shift back, runs the
//    deflation scan (a parallel reduction over the subdiagonal), counts the
//    sweep, sets done, and for the next sweep forms the shift and subtracts
//    it on the new window.
// The left window reaches column b - 1 (for b = lo that is the deflated
// subdiagonal entry H[lo, lo - 1]) and the right pass row e + 1, so that a
// sweep touches what B8's touches but for exact zeros; eigenvalues-only mode
// never updates a column at or beyond hi. The TPU's 120/136/256 window
// shapes, 128-lane padding, 8/128-aligned anchoring and diagonal caches are
// VMEM layout and have no counterpart; no row or column outside [0, n) is
// ever read.
//
// Plain C interface for ctypes: the entry point selects the device, launches
// on the caller's stream and returns the first CUDA error (0 on success),
// checked after every launch.

#include "eig_common.cuh"

namespace {

constexpr int kMaxBlock = 64;         // largest bs (rotations per block)
constexpr int kWinThreads = 96;       // window_kernel: thread j owns window column j
constexpr int kProdThreads = 256;     // slab_kernel, right_kernel
constexpr int kSlabCols = 32;         // slab_kernel: columns per block
constexpr int kRightRows = 32;        // right_kernel: rows per block
constexpr int kRowGroups = kProdThreads / 32;
constexpr int kSlabRowsPerThread = (kMaxBlock + 1 + kRowGroups - 1) / kRowGroups;
constexpr int kRightColsPerThread = (kMaxBlock + 1 + 31) / 32;
constexpr int kBoundaryThreads = 1024;
static_assert(kWinThreads >= kMaxBlock + 2, "a thread per window column");
static_assert(kRightRows % kRowGroups == 0, "right_kernel row groups");

// Device state (int32): the active window, the sweeps done in this call, and
// whether the iteration has ended.
enum State { kHi = 0, kLo = 1, kSweeps = 2, kDone = 3 };

// Block bi of the current sweep: rows b .. e, live while b < hi - 1.
struct Block {
  int b, e;
  bool live;
};

__device__ __forceinline__ Block block_of(const int* st, int bi, int bs) {
  const int hi = st[kHi], b = st[kLo] + bi * bs;
  return {b, min(b + bs, hi - 1), st[kDone] == 0 && b < hi - 1};
}

// (a) The block's left rotations on its window, rows b .. e times columns
// c0 = max(b - 1, 0) .. e, in shared memory, accumulated into U_b, which is
// written to U (stride bs + 1).
template <typename T>
__global__ void __launch_bounds__(kWinThreads)
window_kernel(T* __restrict__ H, T* __restrict__ U, int64_t n, const int* __restrict__ st, int bi,
              int bs) {
  using O = Ops<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T s_g[2][2];  // rotations k (even/odd slot): g00, g01
  const Block blk = block_of(st, bi, bs);
  if (!blk.live) return;
  const int b = blk.b, m = blk.e - b + 1, c0 = b > 0 ? b - 1 : 0, wc = blk.e - c0 + 1;
  const int ws = bs + 2, us = bs + 1, t = threadIdx.x;
  T* W = reinterpret_cast<T*>(smem);  // m x wc, stride ws
  T* Us = W + (bs + 1) * ws;          // m x m, stride us
  for (int i = t; i < m * wc; i += blockDim.x)
    W[(i / wc) * ws + i % wc] = H[(b + i / wc) * n + c0 + i % wc];
  for (int i = t; i < m * m; i += blockDim.x)
    Us[(i / m) * us + i % m] = i / m == i % m ? O::one() : O::zero();
  __syncthreads();
  if (t == 0) givens(W[b - c0], W[ws + b - c0], s_g[0]);
  __syncthreads();
  for (int r = 0; r + 1 < m; ++r) {  // rotation k = b + r on local rows r, r + 1
    const T g00 = s_g[r & 1][0], g01 = s_g[r & 1][1];
    if (t < wc) {
      rotate_pair(g00, g01, &W[r * ws + t], &W[(r + 1) * ws + t]);
      if (c0 + t == b + r + 1 && r + 2 < m)  // the owner of column k + 1 forms rotation k + 1
        givens(W[(r + 1) * ws + t], W[(r + 2) * ws + t], s_g[(r + 1) & 1]);
    }
    if (t < m) rotate_pair(g00, g01, &Us[r * us + t], &Us[(r + 1) * us + t]);
    __syncthreads();
  }
  for (int i = t; i < m * wc; i += blockDim.x)
    H[(b + i / wc) * n + c0 + i % wc] = W[(i / wc) * ws + i % wc];
  T* Ub = U + static_cast<int64_t>(bi) * us * us;
  for (int i = t; i < m * m; i += blockDim.x) Ub[(i / m) * us + i % m] = Us[(i / m) * us + i % m];
}

// (b) The left slab: rows b .. e times columns e + 1 .. col_end - 1 := U_b *
// slab, 32 columns per block; thread (group g, lane x) forms rows g, g + 8, ...
// of column x.
template <typename T>
__global__ void __launch_bounds__(kProdThreads)
slab_kernel(T* __restrict__ H, const T* __restrict__ U, int64_t n, const int* __restrict__ st,
            int bi, int bs, int schur) {
  using O = Ops<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Block blk = block_of(st, bi, bs);
  if (!blk.live) return;
  const int64_t col_end = schur ? n : st[kHi];
  const int64_t j0 = blk.e + 1 + static_cast<int64_t>(blockIdx.x) * kSlabCols;
  if (j0 >= col_end) return;
  const int b = blk.b, m = blk.e - b + 1, us = bs + 1, t = threadIdx.x;
  const int x = t % 32, g = t / 32;
  T* Us = reinterpret_cast<T*>(smem);  // m x m, stride us
  T* S = Us + us * us;                 // m x 32
  const T* Ub = U + static_cast<int64_t>(bi) * us * us;
  for (int i = t; i < m * m; i += blockDim.x) Us[(i / m) * us + i % m] = Ub[(i / m) * us + i % m];
  for (int i = t; i < m * kSlabCols; i += blockDim.x) {
    const int r = i / kSlabCols, c = i % kSlabCols;
    S[i] = j0 + c < col_end ? H[(b + r) * n + j0 + c] : O::zero();
  }
  __syncthreads();
  T acc[kSlabRowsPerThread];
#pragma unroll
  for (int q = 0; q < kSlabRowsPerThread; ++q) acc[q] = O::zero();
  for (int c = 0; c < m; ++c) {
    const T s = S[c * kSlabCols + x];
#pragma unroll
    for (int q = 0; q < kSlabRowsPerThread; ++q)
      if (g + q * kRowGroups < m) acc[q] = O::madd(acc[q], Us[(g + q * kRowGroups) * us + c], s);
  }
  if (j0 + x < col_end) {
#pragma unroll
    for (int q = 0; q < kSlabRowsPerThread; ++q)
      if (g + q * kRowGroups < m) H[(b + g + q * kRowGroups) * n + j0 + x] = acc[q];
  }
}

// (c) The right pass of block bi: columns b .. e := . * U_b^H on H's rows
// 0 .. min(e + 2, n) - 1 (blocks 0 .. h_tiles - 1) and, when Q is given, on
// all of Q's rows (the blocks after). 32 rows per block; thread (group g,
// lane x) forms rows g, g + 8, g + 16, g + 24 of columns x, x + 32, x + 64.
template <typename T>
__global__ void __launch_bounds__(kProdThreads)
right_kernel(T* __restrict__ H, T* __restrict__ Q, const T* __restrict__ U, int64_t n,
             const int* __restrict__ st, int bi, int bs, int h_tiles) {
  using O = Ops<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Block blk = block_of(st, bi, bs);
  if (!blk.live) return;
  const bool on_q = static_cast<int>(blockIdx.x) >= h_tiles;
  T* M = on_q ? Q : H;
  const int64_t r0 = static_cast<int64_t>(on_q ? blockIdx.x - h_tiles : blockIdx.x) * kRightRows;
  const int64_t row_end = on_q || blk.e + 2 > n ? n : blk.e + 2;
  if (r0 >= row_end) return;
  const int b = blk.b, m = blk.e - b + 1, us = bs + 1, t = threadIdx.x;
  const int x = t % 32, g = t / 32;
  T* Ut = reinterpret_cast<T*>(smem);  // Ut[j][c] = conj(U_b[c][j]), stride us
  T* C = Ut + us * us;                 // kRightRows x m, stride us
  const T* Ub = U + static_cast<int64_t>(bi) * us * us;
  for (int i = t; i < m * m; i += blockDim.x)
    Ut[(i % m) * us + i / m] = O::conj(Ub[(i / m) * us + i % m]);
  for (int i = t; i < kRightRows * m; i += blockDim.x) {
    const int r = i / m, c = i % m;
    C[r * us + c] = r0 + r < row_end ? M[(r0 + r) * n + b + c] : O::zero();
  }
  __syncthreads();
  constexpr int kRows = kRightRows / kRowGroups;
  T acc[kRows][kRightColsPerThread];
#pragma unroll
  for (int p = 0; p < kRows; ++p)
#pragma unroll
    for (int q = 0; q < kRightColsPerThread; ++q) acc[p][q] = O::zero();
  for (int j = 0; j < m; ++j) {
    T u[kRightColsPerThread];
#pragma unroll
    for (int q = 0; q < kRightColsPerThread; ++q)
      u[q] = x + 32 * q < m ? Ut[j * us + x + 32 * q] : O::zero();
#pragma unroll
    for (int p = 0; p < kRows; ++p) {
      const T c = C[(g + p * kRowGroups) * us + j];
#pragma unroll
      for (int q = 0; q < kRightColsPerThread; ++q) acc[p][q] = O::madd(acc[p][q], c, u[q]);
    }
  }
#pragma unroll
  for (int p = 0; p < kRows; ++p) {
    const int64_t row = r0 + g + p * kRowGroups;
#pragma unroll
    for (int q = 0; q < kRightColsPerThread; ++q)
      if (row < row_end && x + 32 * q < m) M[row * n + b + x + 32 * q] = acc[p][q];
  }
}

// (d) Between sweeps, one block. Unless `first`: returns at once when done;
// else adds the sweep's shift back on [lo, hi) and counts the sweep. Then the
// deflation scan into hi and lo, done = hi <= 1 or sweeps >= max_sweeps, and
// if not done the next shift (schedule or Wilkinson) is formed, stored in mu
// and subtracted on the new window.
template <typename T>
__global__ void __launch_bounds__(kBoundaryThreads)
boundary_kernel(T* __restrict__ H, int64_t n, int* __restrict__ st, T* __restrict__ mu,
                const T* __restrict__ shifts, int n_shifts, int max_sweeps,
                typename Ops<T>::Real tol, int first) {
  using O = Ops<T>;
  __shared__ int sh[2];
  __shared__ T s_mu;
  const int t = threadIdx.x, nt = blockDim.x;
  int hi = static_cast<int>(n), sweeps = 0;
  if (!first) {
    if (st[kDone]) return;
    hi = st[kHi];
    const T m = *mu;
    for (int i = st[kLo] + t; i < hi; i += nt) H[i * n + i] = O::add(H[i * n + i], m);
    sweeps = st[kSweeps] + 1;
  }
  deflate_and_lo(H, n, hi, tol, sh);
  hi = sh[0] + 2;
  const int lo = sh[1] + 1;
  const bool done = hi <= 1 || sweeps >= max_sweeps;
  if (!done) {
    if (t == 0) s_mu = n_shifts > 0 ? shifts[sweeps % n_shifts] : wilkinson_shift(H, n, hi);
    __syncthreads();
    for (int i = lo + t; i < hi; i += nt) H[i * n + i] = O::sub(H[i * n + i], s_mu);
  }
  if (t == 0) {
    st[kHi] = hi;
    st[kLo] = lo;
    st[kSweeps] = sweeps;
    st[kDone] = done ? 1 : 0;
    if (!done) *mu = s_mu;
  }
}

template <typename T>
__global__ void diagonal_kernel(const T* __restrict__ H, T* __restrict__ eig, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) eig[i] = H[i * n + i];
}

template <typename T>
int run_sweeps(T* h, T* q, T* ubuf, T* eig, int* st, T* mu, const T* shifts, int n_shifts,
               int64_t n, int max_sweeps, double tol, int bs, int launches_per_read,
               cudaStream_t s) {
  using R = typename Ops<T>::Real;
  const R rtol = static_cast<R>(tol);
  const int us = bs + 1;
  const int win_smem = static_cast<int>(sizeof(T)) * us * (bs + 2 + us);
  const int slab_smem = static_cast<int>(sizeof(T)) * us * (us + kSlabCols);
  const int right_smem = static_cast<int>(sizeof(T)) * us * (us + kRightRows);
  cudaFuncSetAttribute(window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, win_smem);
  cudaFuncSetAttribute(slab_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, slab_smem);
  cudaFuncSetAttribute(right_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, right_smem);
  if (int rc = last_error()) return rc;
  boundary_kernel<T><<<1, kBoundaryThreads, 0, s>>>(h, n, st, mu, shifts, n_shifts, max_sweeps,
                                                    rtol, 1);
  if (int rc = last_error()) return rc;
  for (int queued = 0;;) {
    int state[4];
    cudaMemcpyAsync(state, st, sizeof(state), cudaMemcpyDeviceToHost, s);
    if (int rc = last_error()) return rc;
    if (int rc = static_cast<int>(cudaStreamSynchronize(s))) return rc;
    if (state[kDone] || queued >= max_sweeps) break;
    const int hi = state[kHi];  // an upper bound of the live hi for the chunk: it never grows
    const int nblk = (hi - 2) / bs + 1;  // blocks of [0, hi - 1), a bound for [lo, hi - 1)
    int sweeps = launches_per_read / (3 * nblk + 1);
    sweeps = sweeps < 1 ? 1 : (sweeps > max_sweeps - queued ? max_sweeps - queued : sweeps);
    const int64_t col_end = q != nullptr ? n : hi;
    const unsigned h_tiles = blocks_for(hi + 1 < n ? hi + 1 : n, kRightRows);
    const unsigned q_tiles = q != nullptr ? blocks_for(n, kRightRows) : 0;
    for (int sw = 0; sw < sweeps; ++sw) {
      for (int bi = 0; bi < nblk; ++bi) {
        window_kernel<T><<<1, kWinThreads, win_smem, s>>>(h, ubuf, n, st, bi, bs);
        if (int rc = last_error()) return rc;
        // the slab starts at e + 1 >= bi * bs + 2
        const int64_t slab_cols = col_end - static_cast<int64_t>(bi) * bs - 2;
        if (slab_cols > 0) {
          slab_kernel<T><<<blocks_for(slab_cols, kSlabCols), kProdThreads, slab_smem, s>>>(
              h, ubuf, n, st, bi, bs, q != nullptr);
          if (int rc = last_error()) return rc;
        }
      }
      for (int bi = 0; bi < nblk; ++bi) {
        right_kernel<T><<<h_tiles + q_tiles, kProdThreads, right_smem, s>>>(h, q, ubuf, n, st, bi,
                                                                          bs, h_tiles);
        if (int rc = last_error()) return rc;
      }
      boundary_kernel<T><<<1, kBoundaryThreads, 0, s>>>(h, n, st, mu, shifts, n_shifts,
                                                        max_sweeps, rtol, 0);
      if (int rc = last_error()) return rc;
    }
    queued += sweeps;
  }
  diagonal_kernel<T><<<blocks_for(n, kThreads), kThreads, 0, s>>>(h, eig, n);
  return last_error();
}

}  // namespace

extern "C" {

// B13: blocked shifted Givens sweeps on the complex Hessenberg h (n x n, in
// place) until hi <= 1 or max_sweeps sweeps; q (nullable: eigenvalues only)
// is multiplied by the right rotations and h's slabs run through all n
// columns (Schur mode). eig = diag(h); state = {hi, lo, sweeps, done}
// (int32); mu one scalar; ubuf ceil((n - 1) / bs) (bs + 1)^2 scalars; shifts
// (nullable) n_shifts scalars, sweep s shifting by shifts[s % n_shifts]
// instead of Wilkinson's. The host reads the state once per chunk of about
// launches_per_read launches.
int qr_eig_blocked_sweeps(int dtype, int device, void* h, void* q, void* ubuf, void* eig,
                          void* state, void* mu, const void* shifts, int n_shifts, long long n,
                          int max_sweeps, double tol, int bs, int launches_per_read,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (bs < 1 || bs > kMaxBlock || launches_per_read < 1 || n_shifts < 0 || n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QRB_ARGS(T) static_cast<T*>(h), static_cast<T*>(q), static_cast<T*>(ubuf),          \
                    static_cast<T*>(eig), static_cast<int*>(state), static_cast<T*>(mu),      \
                    static_cast<const T*>(shifts), n_shifts, n, max_sweeps, tol, bs,          \
                    launches_per_read, s
  switch (dtype) {
    case kC64: return run_sweeps<float2>(QRB_ARGS(float2));
    case kC128: return run_sweeps<double2>(QRB_ARGS(double2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QRB_ARGS
}

}  // extern "C"
