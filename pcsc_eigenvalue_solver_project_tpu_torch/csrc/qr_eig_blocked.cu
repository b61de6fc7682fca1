// Blocked Givens QR sweeps for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   B13 _qr_blocked_kernel (pcsc_eigenvalue_solver_project_tpu/ops/pallas/
//       qr_eig_blocked.py:63), reached through qr_eig_blocked_planes,
//       _step_pallas and _step_pallas_q -> qr_eig_blocked_sweeps, on float2
//       and double2 ((re, im) in (.x, .y), the four-FMA product);
//   B10 _qr_parity_kernel (pcsc_eigenvalue_solver_project_tpu/ops/pallas/
//       qr_kernels.py:797) -> qr_eig_blocked_sweeps in parity mode, on float,
//       double, float2 and double2 (a real matrix takes real rotations).
//
// Parity mode (B10) is the reference's unshifted QR iteration H := R Q with
// H = Q R on the Hessenberg matrix it is given. On a Hessenberg matrix each
// Householder reflector of that QR has two nonzero entries: it is a Givens
// rotation times a diagonal unitary. So the Givens sweep below, with no
// shift and the window [0, n) every sweep whatever the subdiagonal holds,
// gives D^H H D of the Householder iterate for a diagonal unitary D, and
// diag(H), |H|, max|H[i+1, i]| and ||H||_F, all that the stop test and the
// result read, do not change under D. A sweep is then n - 1 rotations,
// O(n^2), where the Householder QR and the product R Q are O(n^3). After each
// sweep every block sums its row tiles of the upper-Hessenberg part
// (parity_partials: sum |H|^2, max |H[i+1, i]|^2, one fixed order), and
// every block adds the partials in tile order and takes the same decision:
// converged when max|H[i+1, i]| <= tol (1 + ||H||_F) in the working
// precision, done then or after max_sweeps sweeps; block 0 stores the count,
// the flags and maxsub for the host. A zero pivot pair gives the identity
// rotation (givens()), as the Householder step's tail-zero skip does.
//
// Each sweep on the active window [lo, hi) of the Hessenberg H (that of B8,
// qr_kernels.cu): the shift mu (Wilkinson's from the trailing active 2x2, or
// the caller's schedule: sweep s takes shifts[s % n_shifts]); H - mu I on the
// window; the left rotations k = lo .. hi-2 in blocks of bs (block i owns
// b_i = lo + i bs .. e_i - 1 with e_i = min(b_i + bs, hi - 1), its rows are
// b_i .. e_i, and b_{i+1} = e_i); each block's rotations accumulated into
// U_i ((bs + 1)^2, from I) and applied to the block's rows beyond the window
// (the slab, columns e_i + 1 .. col_end - 1: col_end = hi for eigenvalues, n
// in Schur mode); the right rotations block by block (rows 0 .. e_i + 1 times
// columns b_i .. e_i := . U_i^H, and in Schur mode Q's columns); + mu I; the
// deflation scan into the new hi and lo.
//
// What bounds it on this card, and what the design does about it. The
// rotations form a serial chain: rotation k is formed from column k after
// rotation k - 1. Everything else is short, wide products that depend on the
// chain only through the U_i. So one cooperative launch runs a chunk of
// sweeps on a grid no larger than the card holds at once:
//  * Block 0 runs the chain. For block i it rotates the window (rows b_i ..
//    e_i, columns max(b_i - 1, 0) .. e_i, in shared memory) in ONE warp: a
//    lane owns window column lane (and lane + 32 at bs > 30, lane + 64 at
//    bs > 62: each slot costs the warp a rotation's worth of instructions),
//    carries its current row in registers and streams the next from shared
//    memory; the lane that owns the next pivot column hands its rotated entry
//    to the warp by __shfl_sync, and every lane forms the same rotation from
//    it, with no block barrier. The same warp accumulates U_i (lane l its
//    columns l + 32 s) and writes its rows as they finish; the other seven
//    warps prefetch the next window and the rows of the look-ahead by
//    cp.async. (The rotation keeps B8's correctly
//    rounded 1 / sqrt: an rsqrtf estimate with one Newton step, faster in a
//    microbenchmark, left the non-symmetric 2048 solve's eigenvalues 13x
//    further from numpy's.)
//    The window needs one entry range that the sweep has written: row b_i
//    over columns e_{i-1} + 1 .. e_i, the last row of slab i - 1 there (its
//    look-ahead). The chain computes it itself, U_{i-1}'s last row times
//    those columns, right after window i - 1, keeps the columns' original
//    row in `side` for the slab, and publishes U_{i-1} and a flag only then.
//    Its one wait: row b_{i-1} over those columns is slab i - 2's output, so
//    it waits for slab i - 2 on the column tiles there, which had a whole
//    window's time to finish.
//  * Blocks 1 .. nslab own fixed 32-column tiles of the slabs; each takes
//    the blocks in order, waits for U_j's flag, applies U_j to its tiles
//    (skipping the look-ahead entries, whose input row comes from `side`),
//    and publishes a per-tile count of slabs done. The remaining blocks own
//    fixed 32-row tiles of the right passes, on H (each waits for every
//    window that reaches row e_j + 1 and for the slabs on columns b_j .. e_j)
//    and in Schur mode on Q (each waits only for U_j). No one waits for a
//    right pass. Tasks wait on flags and counts by ld.acquire.gpu and publish
//    them by st.release.gpu; flags carry the launch's sweep number, so sweep
//    s + 1 never reads one of sweep s. Data another block wrote is read
//    through L2 (__ldcg). Every output entry is written by one thread in a
//    fixed order, with no atomics in any sum: T and Q repeat bit for bit.
//    ops/qr_eig_blocked.py::_sweep_tasks is this dependency graph in
//    PyTorch, run in random orders on the CPU.
//  * Between sweeps a grid barrier; block 0 adds the shift back, runs the
//    deflation scan, counts the sweep, sets done, forms the next shift
//    (schedule or Wilkinson) and subtracts it; a second grid barrier. The
//    launch runs until done or its sweep budget, and the host reads the
//    state once a launch.
//  * Products: FMA in the working precision (no tensor cores, so no TF32).
//    A full-window sweep moves about 4 n^2 elements of H (8 n^2 with Q) at
//    (bs + 1) complex multiply-adds each, so the workers, spread over the
//    card, keep pace with the chain, which bounds the sweep: n rotations,
//    each a shuffle, a rotation of a few columns and a square root.
// Eigenvalues-only mode never updates a column at or beyond hi. The TPU's
// 120/136/256 window shapes, 128-lane padding, 8/128-aligned anchoring and
// diagonal caches are VMEM layout and have no counterpart; no row or column
// outside [0, n) is ever read.
//
// Plain C interface for ctypes: the entry point selects the device, launches
// on the caller's stream and returns the first CUDA error (0 on success),
// checked after every launch.

#include <cooperative_groups.h>

#include "eig_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlock = 64;       // largest bs (rotations per block)
constexpr int kSweepThreads = 256;  // every block of the grid
constexpr int kSlabCols = 32;       // columns a slab tile
constexpr int kRightRows = 32;      // rows a right-pass tile
// Sweeps a launch at most (SWEEPS_PER_LAUNCH of ops/qr_eig_blocked.py): on
// the H100 the budget moved the non-symmetric 2048 solve by 1.3% from 8 to
// 8192 sweeps (PERF.md); it bounds the sweeps past convergence a host waits
// for before it reads the state.
constexpr int kSweepsPerLaunch = 256;
constexpr int kRowGroups = kSweepThreads / 32;
constexpr int kSlabRowsPerThread = (kMaxBlock + 1 + kRowGroups - 1) / kRowGroups;
constexpr int kRightColsPerThread = (kMaxBlock + 1 + 31) / 32;
constexpr int kRightRowsPerThread = kRightRows / kRowGroups;
static_assert(kRightRows % kRowGroups == 0, "right-pass row groups");

// Device state (int32): the active window, the sweeps done in this call,
// whether the iteration has ended, and (parity mode) whether it converged.
enum State { kHi = 0, kLo = 1, kSweeps = 2, kDone = 3, kConv = 4 };

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Every thread of the block past *p >= target.
__device__ __forceinline__ void wait_for(const unsigned* p, unsigned target) {
  if (threadIdx.x == 0)
    while (ld_acquire(p) < target) {
    }
  __syncthreads();
}

// *p = v once every thread's writes before the call are visible on the card.
__device__ __forceinline__ void publish(unsigned* p, unsigned v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) st_release(p, v);
}

// What every block of the launch reads.
template <typename T>
struct Sweep {
  T* h;
  T* q;          // null: eigenvalues only
  T* u;          // the U_i, (bs + 1)^2 each
  T* side;       // n: row e_i's original entries over its look-ahead columns
  T* eig;
  int* st;
  T* mu;
  const T* shifts;
  unsigned* flags;  // n U flags, then a slab count per column tile
  typename Ops<T>::Real* part;  // parity mode: 2 partials a row tile, then maxsub
  int parity;
  int n_shifts;
  int64_t n;
  int max_sweeps;
  typename Ops<T>::Real tol;
  int bs;
  int budget;     // sweeps this launch at most
  int first;      // the call's first launch: the initial scan and shift
  int nslab;      // slab blocks (1 .. nslab); the rest take the right passes
};

// |H[c+1, c]| <= tol * max(|H[c, c]| + |H[c+1, c+1]|, 1), read through L2
// (negligible() of eig_common.cuh: the entries were written by other blocks).
template <typename T>
__device__ __forceinline__ bool negligible_cg(const T* H, int64_t n, int c,
                                              typename Ops<T>::Real tol) {
  using O = Ops<T>;
  using R = typename O::Real;
  const R scale = dsqrt(O::abs2(__ldcg(&H[c * n + c]))) + dsqrt(O::abs2(__ldcg(&H[(c + 1) * n + c + 1])));
  return dsqrt(O::abs2(__ldcg(&H[(c + 1) * n + c]))) <= tol * (scale > R(1) ? scale : R(1));
}

// deflate_and_lo() of eig_common.cuh through L2: sh[0] + 2 is the new hi,
// sh[1] + 1 the new lo.
template <typename T>
__device__ void deflate_and_lo_cg(const T* H, int64_t n, int hi, typename Ops<T>::Real tol,
                                  int* sh) {
  if (threadIdx.x == 0) sh[0] = sh[1] = -1;
  __syncthreads();
  int best = -1;
  for (int c = threadIdx.x; c < hi - 1; c += blockDim.x)
    if (!negligible_cg(H, n, c, tol)) best = c;
  if (best >= 0) atomicMax(&sh[0], best);
  __syncthreads();
  const int new_hi = sh[0] + 2;
  best = -1;
  for (int c = threadIdx.x; c < new_hi - 1; c += blockDim.x)
    if (negligible_cg(H, n, c, tol)) best = c;
  if (best >= 0) atomicMax(&sh[1], best);
  __syncthreads();
}

// Between sweeps (block 0): unless `first`, adds the sweep's shift back on
// [lo, hi) and counts the sweep. Then the deflation scan into hi and lo,
// done = hi <= 1 or sweeps >= max_sweeps, and if not done the next shift
// (schedule or Wilkinson), stored in mu and subtracted on the new window.
template <typename T>
__device__ void boundary(const Sweep<T>& a, bool first, int* sh, T* s_mu) {
  using O = Ops<T>;
  T* H = a.h;
  const int64_t n = a.n;
  const int t = threadIdx.x, nt = blockDim.x;
  int hi = static_cast<int>(n), sweeps = 0;
  if (!first) {
    hi = a.st[kHi];
    const T m = *a.mu;
    for (int i = a.st[kLo] + t; i < hi; i += nt) H[i * n + i] = O::add(__ldcg(&H[i * n + i]), m);
    sweeps = a.st[kSweeps] + 1;
  }
  __syncthreads();
  deflate_and_lo_cg(H, n, hi, a.tol, sh);
  hi = sh[0] + 2;
  const int lo = sh[1] + 1;
  const bool done = hi <= 1 || sweeps >= a.max_sweeps;
  if (!done) {
    if (t == 0) {
      if constexpr (O::kComplex) {
        T corner[4];  // the trailing active 2 x 2
        for (int k = 0; k < 4; ++k) corner[k] = __ldcg(&H[(hi - 2 + k / 2) * n + hi - 2 + k % 2]);
        *s_mu = a.n_shifts > 0 ? a.shifts[sweeps % a.n_shifts] : wilkinson_shift(corner, 2, 2);
      } else {  // real data runs in parity mode only
        *s_mu = O::zero();
      }
    }
    __syncthreads();
    for (int i = lo + t; i < hi; i += nt) H[i * n + i] = O::sub(__ldcg(&H[i * n + i]), *s_mu);
  }
  __syncthreads();
  if (t == 0) {
    a.st[kHi] = hi;
    a.st[kLo] = lo;
    a.st[kSweeps] = sweeps;
    a.st[kDone] = done ? 1 : 0;
    if (!done) *a.mu = *s_mu;
  }
}

// Parity mode, on the call's first launch (block 0): the whole window and no
// sweep done; done at once without a budget.
template <typename T>
__device__ void parity_start(const Sweep<T>& a) {
  if (threadIdx.x == 0) {
    a.st[kHi] = static_cast<int>(a.n);
    a.st[kLo] = 0;
    a.st[kSweeps] = 0;
    a.st[kDone] = a.max_sweeps <= 0 ? 1 : 0;
    a.st[kConv] = 0;
    a.part[2 * tiles_of(a.n, kRightRows)] = 0;
  }
}

// Parity mode, after a sweep: the block's row tiles r = blockIdx.x,
// + gridDim.x, ... of the stop test: part[2 r] = the sum of |H[i, j]|^2 over
// the tile's rows i and j >= i - 1, part[2 r + 1] = the max of
// |H[i, i - 1]|^2 over them. Each thread sums its entries in a fixed order
// and block_reduce adds the threads in a fixed tree.
template <typename T>
__device__ void parity_partials(const Sweep<T>& a, typename Ops<T>::Real* red) {
  using O = Ops<T>;
  using R = typename O::Real;
  const int64_t n = a.n;
  const int tiles = tiles_of(n, kRightRows);
  for (int r = blockIdx.x; r < tiles; r += gridDim.x) {
    R sum = 0, sub = 0;
    const int64_t i1 = (r + 1) * static_cast<int64_t>(kRightRows) < n ? (r + 1) * kRightRows : n;
    for (int64_t i = static_cast<int64_t>(r) * kRightRows; i < i1; ++i) {
      const int64_t j0 = i > 0 ? i - 1 : 0;
      for (int64_t j = j0 + threadIdx.x; j < n; j += blockDim.x) {
        const R m = O::abs2(__ldcg(&a.h[i * n + j]));
        sum += m;
        if (j == i - 1) sub = m > sub ? m : sub;
      }
    }
    sum = block_reduce(sum, red, false);
    sub = block_reduce(sub, red, true);
    if (threadIdx.x == 0) {
      a.part[2 * r] = sum;
      a.part[2 * r + 1] = sub;
    }
  }
}

// Parity mode, after parity_partials and a grid barrier (every block, the
// same decision): the partials added in tile order, converged when maxsub
// <= tol (1 + ||H||_F), done then or at max_sweeps. Block 0 stores the
// sweeps, done, converged and maxsub.
template <typename T>
__device__ bool parity_decide(const Sweep<T>& a, int sweeps, int* flag) {
  using R = typename Ops<T>::Real;
  if (threadIdx.x == 0) {
    const int tiles = tiles_of(a.n, kRightRows);
    R fro2 = 0, sub2 = 0;
    for (int r = 0; r < tiles; ++r) {
      fro2 += __ldcg(&a.part[2 * r]);
      const R m = __ldcg(&a.part[2 * r + 1]);
      sub2 = m > sub2 ? m : sub2;
    }
    const R maxsub = dsqrt(sub2);
    const bool conv = maxsub <= a.tol * (R(1) + dsqrt(fro2));
    const bool done = conv || sweeps >= a.max_sweeps;
    *flag = done ? 1 : 0;
    if (blockIdx.x == 0) {
      a.st[kSweeps] = sweeps;
      a.st[kDone] = done ? 1 : 0;
      a.st[kConv] = conv ? 1 : 0;
      a.part[2 * tiles] = maxsub;
    }
  }
  __syncthreads();
  const bool done = *flag != 0;
  __syncthreads();  // flag is written again after the next sweep
  return done;
}

// Block 0: the chain of sweep s (launch-relative).
template <typename T, int kSlots>
__device__ void chain(const Sweep<T>& a, const Blocks& B, unsigned s, unsigned char* smem) {
  using O = Ops<T>;
  T* H = a.h;
  const int64_t n = a.n;
  const int bs = a.bs, us = bs + 1, ws = bs + 2, t = threadIdx.x;
  T* Wb[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + us * ws};
  T* X = Wb[1] + us * ws;   // us x bs: rows b_i .. e_i over the look-ahead columns
  T* Ul = X + us * bs;      // U_i's last row
  unsigned* uflag = a.flags;
  const unsigned* tile_done = a.flags + n;
  const unsigned seq0 = s * static_cast<unsigned>(n + 1);
  {  // window 0 as it stands
    const int b = B.b(0), e = B.e(0), c0 = b > 0 ? b - 1 : 0, m = e - b + 1, wc = e - c0 + 1;
    for (int i = t; i < m * wc; i += blockDim.x)
      cp_async_elem<sizeof(T)>(&Wb[0][(i / wc) * ws + i % wc], &H[(b + i / wc) * n + c0 + i % wc],
                               true);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  for (int i = 0; i < B.count; ++i) {
    T* W = Wb[i & 1];
    T* Wn = Wb[(i + 1) & 1];
    const int b = B.b(i), e = B.e(i), c0 = b > 0 ? b - 1 : 0;
    const int m = e - b + 1, wc = e - c0 + 1;
    const bool ahead = i + 1 < B.count;
    const int e2 = ahead ? B.e(i + 1) : e, la = e2 - e;  // look-ahead columns e + 1 .. e2
    T* Ui = a.u + static_cast<int64_t>(i) * us * us;
    // (a) the rotations and U_i; the next window's rows and the look-ahead's
    if (t < 32) {
      rotate_window<T, kSlots>(W, ws, m, wc, b - c0, Ui, Ul, us);
    } else if (ahead) {
      const int f = t - 32, nf = blockDim.x - 32;
      const int b2 = B.b(i + 1), c2 = b2 - 1, m2 = e2 - b2 + 1, wc2 = e2 - c2 + 1;
      for (int k = f; k < (m2 - 1) * wc2; k += nf)  // window i + 1's rows b2 + 1 .. e2
        cp_async_elem<sizeof(T)>(&Wn[(1 + k / wc2) * ws + k % wc2],
                                 &H[(b2 + 1 + k / wc2) * n + c2 + k % wc2], true);
      for (int k = f; k < (m - 1) * la; k += nf)  // rows b + 1 .. e over e + 1 .. e2
        cp_async_elem<sizeof(T)>(&X[(1 + k / la) * bs + k % la],
                                 &H[(b + 1 + k / la) * n + e + 1 + k % la], true);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    // (b) window i to H, and the look-ahead's side row
    for (int k = t; k < m * wc; k += blockDim.x)
      H[(b + k / wc) * n + c0 + k % wc] = W[(k / wc) * ws + k % wc];
    if (ahead && t < 2) Wn[t] = W[(m - 1) * ws + wc - 2 + t];  // row e over e - 1, e
    for (int k = t; ahead && k < la; k += blockDim.x)  // row e's original entries, for slab i
      a.side[e + 1 + k] = X[(m - 1) * bs + k];
    // (c) the look-ahead of window i + 1: row e over e + 1 .. e2 after slab
    // i - 1 (row b there), times U_i's last row
    if (ahead) {
      if (i > 0) {
        if (t == 0)
          for (int tile = (e + 1) / kSlabCols; tile <= e2 / kSlabCols; ++tile)
            while (ld_acquire(&tile_done[tile]) < seq0 + i) {
            }
      }
      __syncthreads();
      for (int k = t; k < la; k += blockDim.x) X[k] = __ldcg(&H[b * n + e + 1 + k]);
      __syncthreads();
      for (int k = t; k < la; k += blockDim.x) {
        T acc = O::zero();
        for (int r = 0; r < m; ++r) acc = O::madd(acc, Ul[r], X[r * bs + k]);
        Wn[2 + k] = acc;
      }
    }
    publish(&uflag[i], s + 1);
  }
}

// Blocks 1 .. nslab: the slabs on column tiles t = w, w + nslab, ...
template <typename T>
__device__ void slab_worker(const Sweep<T>& a, const Blocks& B, unsigned s, int w,
                            unsigned char* smem) {
  using O = Ops<T>;
  T* H = a.h;
  const int64_t n = a.n;
  const int us = a.bs + 1, t = threadIdx.x, x = t % 32, g = t / 32;
  const int col_end = a.q != nullptr ? static_cast<int>(n) : B.hi;
  const int tiles = tiles_of(n, kSlabCols);
  T* Us = reinterpret_cast<T*>(smem);  // m x m, stride us
  T* S = Us + us * us;                 // m x kSlabCols
  const unsigned seq0 = s * static_cast<unsigned>(n + 1);
  unsigned* tile_done = a.flags + n;
  for (int j = 0; j < B.count; ++j) {
    const int b = B.b(j), e = B.e(j), m = e - b + 1;
    const int la_end = j + 1 < B.count ? B.e(j + 1) : e;  // look-ahead columns e + 1 .. la_end
    bool loaded = false;
    for (int tile = w; tile < tiles; tile += a.nslab) {
      const int t0 = tile * kSlabCols;
      const bool empty = t0 + kSlabCols - 1 <= e || t0 >= col_end;
      const bool was_empty = j > 0 && (t0 + kSlabCols - 1 <= B.e(j - 1) || t0 >= col_end);
      if (empty) {  // for good: later blocks start further right
        if (!was_empty) publish(&tile_done[tile], seq0 + B.count);
        continue;
      }
      if (!loaded) {
        wait_for(&a.flags[j], s + 1);
        const T* Uj = a.u + static_cast<int64_t>(j) * us * us;
        for (int k = t; k < m * m; k += blockDim.x)
          cp_async_elem<sizeof(T)>(&Us[(k / m) * us + k % m], &Uj[(k / m) * us + k % m], true);
        loaded = true;
      }
      const int c1 = t0 > e + 1 ? t0 : e + 1;
      const int c2 = t0 + kSlabCols < col_end ? t0 + kSlabCols : col_end;
      for (int k = t; k < m * kSlabCols; k += blockDim.x) {
        const int r = k / kSlabCols, c = c1 + k % kSlabCols;
        const T* src = r == m - 1 && c <= la_end ? &a.side[c] : &H[(b + r) * n + c];
        cp_async_elem<sizeof(T)>(&S[k], c < c2 ? src : H, c < c2);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      T acc[kSlabRowsPerThread];
#pragma unroll
      for (int p = 0; p < kSlabRowsPerThread; ++p) acc[p] = O::zero();
      for (int c = 0; c < m; ++c) {
        const T v = S[c * kSlabCols + x];
#pragma unroll
        for (int p = 0; p < kSlabRowsPerThread; ++p)
          if (g + p * kRowGroups < m) acc[p] = O::madd(acc[p], Us[(g + p * kRowGroups) * us + c], v);
      }
      const int col = c1 + x;
      if (col < c2) {
#pragma unroll
        for (int p = 0; p < kSlabRowsPerThread; ++p) {
          const int r = g + p * kRowGroups;
          if (r < m && !(r == m - 1 && col <= la_end)) H[(b + r) * n + col] = acc[p];
        }
      }
      publish(&tile_done[tile], seq0 + j + 1);
    }
    if (loaded) __syncthreads();  // Us is read again for the next block
  }
}

// One right-pass tile: rows r0 .. r1 - 1 of M times columns b .. b + m - 1
// := . U^H, with U (stride us) in shared memory.
template <typename T>
__device__ void right_tile(T* M, int64_t n, int64_t r0, int64_t r1, int b, int m, int us,
                           const T* Us, T* C) {
  using O = Ops<T>;
  const int t = threadIdx.x, x = t % 32, g = t / 32;
  for (int k = t; k < kRightRows * m; k += blockDim.x) {
    const int r = k / m, c = k % m;
    const bool valid = r0 + r < r1;
    cp_async_elem<sizeof(T)>(&C[r * us + c], valid ? &M[(r0 + r) * n + b + c] : M, valid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  T acc[kRightRowsPerThread][kRightColsPerThread];
#pragma unroll
  for (int p = 0; p < kRightRowsPerThread; ++p)
#pragma unroll
    for (int q = 0; q < kRightColsPerThread; ++q) acc[p][q] = O::zero();
  for (int j = 0; j < m; ++j) {
    T u[kRightColsPerThread];
#pragma unroll
    for (int q = 0; q < kRightColsPerThread; ++q)
      u[q] = x + 32 * q < m ? O::conj(Us[(x + 32 * q) * us + j]) : O::zero();  // U^H[j][.]
#pragma unroll
    for (int p = 0; p < kRightRowsPerThread; ++p) {
      const T c = C[(g + p * kRowGroups) * us + j];
#pragma unroll
      for (int q = 0; q < kRightColsPerThread; ++q) acc[p][q] = O::madd(acc[p][q], c, u[q]);
    }
  }
#pragma unroll
  for (int p = 0; p < kRightRowsPerThread; ++p) {
    const int64_t row = r0 + g + p * kRowGroups;
#pragma unroll
    for (int q = 0; q < kRightColsPerThread; ++q)
      if (row < r1 && x + 32 * q < m) M[row * n + b + x + 32 * q] = acc[p][q];
  }
  __syncthreads();  // C is refilled by the next tile
}

// Blocks nslab + 1 ..: the right passes on row tiles w, w + nright, ... of H
// and, in Schur mode, of Q.
template <typename T>
__device__ void right_worker(const Sweep<T>& a, const Blocks& B, unsigned s, int w, int nright,
                             unsigned char* smem) {
  const int64_t n = a.n;
  const int us = a.bs + 1, t = threadIdx.x;
  T* Us = reinterpret_cast<T*>(smem);  // m x m, stride us
  T* C = Us + us * us;                 // kRightRows x m, stride us
  const int tiles = tiles_of(n, kRightRows);
  const unsigned seq0 = s * static_cast<unsigned>(n + 1);
  const unsigned* tile_done = a.flags + n;
  for (int j = 0; j < B.count; ++j) {
    const int b = B.b(j), e = B.e(j), m = e - b + 1;
    const int64_t row_end = e + 2 < n ? e + 2 : n;
    const bool on_q = a.q != nullptr && w < tiles;
    const bool on_h = w * kRightRows < row_end;
    if (!on_q && !on_h) continue;
    wait_for(&a.flags[j], s + 1);
    const T* Uj = a.u + static_cast<int64_t>(j) * us * us;
    for (int k = t; k < m * m; k += blockDim.x)  // waited for by right_tile
      cp_async_elem<sizeof(T)>(&Us[(k / m) * us + k % m], &Uj[(k / m) * us + k % m], true);
    if (on_q)
      for (int tile = w; tile < tiles; tile += nright)
        right_tile(a.q, n, static_cast<int64_t>(tile) * kRightRows,
                   static_cast<int64_t>(tile + 1) * kRightRows < n ? (tile + 1) * kRightRows : n,
                   b, m, us, Us, C);
    if (on_h) {
      wait_for(&a.flags[B.reach(j)], s + 1);
      if (j > 0 && t == 0)
        for (int tile = b / kSlabCols; tile <= e / kSlabCols; ++tile)
          while (ld_acquire(&tile_done[tile]) < seq0 + j) {
          }
      __syncthreads();
      for (int tile = w; static_cast<int64_t>(tile) * kRightRows < row_end; tile += nright)
        right_tile(a.h, n, static_cast<int64_t>(tile) * kRightRows,
                   (tile + 1) * kRightRows < row_end ? (tile + 1) * kRightRows : row_end, b, m, us,
                   Us, C);
    }
  }
}

template <typename T, int kSlots>
__global__ void __launch_bounds__(kSweepThreads, 1) sweeps_kernel(Sweep<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int sh[2];
  __shared__ T s_mu;
  __shared__ typename Ops<T>::Real red[32];
  const int64_t n = a.n;
  const int64_t nflags = n + tiles_of(n, kSlabCols);
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < nflags;
       k += static_cast<int64_t>(gridDim.x) * blockDim.x)
    a.flags[k] = 0;
  if (blockIdx.x == 0 && a.first) {
    if (a.parity)
      parity_start(a);
    else
      boundary(a, true, sh, &s_mu);
  }
  grid.sync();
  bool done = __ldcg(&a.st[kDone]) != 0;
  int sweeps = __ldcg(&a.st[kSweeps]);  // parity mode: every block counts
  for (int s = 0; s < a.budget && !done; ++s) {
    const int hi = __ldcg(&a.st[kHi]), lo = __ldcg(&a.st[kLo]);
    const Blocks B{lo, hi, a.bs, (hi - 1 - lo + a.bs - 1) / a.bs};
    const int w = static_cast<int>(blockIdx.x);
    if (w == 0) {
      if (B.count > 0) chain<T, kSlots>(a, B, static_cast<unsigned>(s), smem);
    } else if (w <= a.nslab) {
      slab_worker(a, B, static_cast<unsigned>(s), w - 1, smem);
    } else {
      right_worker(a, B, static_cast<unsigned>(s), w - 1 - a.nslab,
                   static_cast<int>(gridDim.x) - 1 - a.nslab, smem);
    }
    grid.sync();
    if (a.parity) {
      parity_partials(a, red);
      grid.sync();
      done = parity_decide(a, ++sweeps, sh);
    } else {
      if (w == 0) boundary(a, false, sh, &s_mu);
      grid.sync();
      done = __ldcg(&a.st[kDone]) != 0;
    }
  }
  if (done)
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * blockDim.x)
      a.eig[i] = __ldcg(&a.h[i * n + i]);
}

// Shared memory of a block: the chain's two windows, the look-ahead rows and
// U_i's last row, or a worker's U and tile.
template <typename T>
int smem_bytes(int bs) {
  const int us = bs + 1;
  const int chain = static_cast<int>(sizeof(T)) * (2 * us * (bs + 2) + us * bs + us);
  const int worker = static_cast<int>(sizeof(T)) * us * (us + kSlabCols);
  return chain > worker ? chain : worker;
}

template <typename T, int kSlots>
int capacity(int bs, int* blocks) {
  const int smem = smem_bytes<T>(bs);
  if (int rc = allow_dynamic_smem<sweeps_kernel<T, kSlots>>(smem_bytes<T>(kMaxBlock))) return rc;
  int device = 0, sms = 0, per_sm = 0;
  if (cudaError_t err = cudaGetDevice(&device)) return static_cast<int>(err);
  if (cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))
    return static_cast<int>(err);
  if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sweeps_kernel<T, kSlots>, kSweepThreads, smem))
    return static_cast<int>(err);
  blocks[0] = per_sm * sms;
  blocks[1] = sms;
  return 0;
}

template <typename T, int kSlots>
int run_sweeps(Sweep<T> a, int grid_req, long long* launches, cudaStream_t s) {
  int cap[2];
  if (int rc = capacity<T, kSlots>(a.bs, cap)) return rc;
  const int64_t n = a.n;
  const int tiles = tiles_of(n, kSlabCols);
  const int rows = tiles_of(n, kRightRows);
  const int wanted = 1 + tiles + rows * (a.q != nullptr ? 2 : 1);
  const int grid = grid_req > 0 ? grid_req : (wanted < cap[1] ? wanted : cap[1]);
  if (grid < 3) return static_cast<int>(cudaErrorInvalidValue);  // chain, slab, right pass
  if (grid > cap[0]) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // the slab blocks' share of the workers: slabs and H's right passes move
  // the same entries, Q's right passes twice as many, but the chain waits
  // only for slabs
  const int workers = grid - 1;
  int nslab = a.q != nullptr ? workers / 3 : workers / 2;
  nslab = nslab < 1 ? 1 : (nslab > workers - 1 ? workers - 1 : nslab);
  a.nslab = nslab;
  // sequence numbers s (n + 1) + j + 1 stay below 2^32
  const int64_t cap_sweeps = (int64_t{1} << 32) / (n + 1) - 1;
  a.budget = kSweepsPerLaunch < cap_sweeps ? kSweepsPerLaunch : static_cast<int>(cap_sweeps);
  const int smem = smem_bytes<T>(a.bs);
  for (a.first = 1;; a.first = 0) {
    void* args[] = {&a};
    cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(sweeps_kernel<T, kSlots>),
                                                  dim3(grid), dim3(kSweepThreads), args, smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    int done = 0;
    cudaMemcpyAsync(&done, a.st + kDone, sizeof(done), cudaMemcpyDeviceToHost, s);
    if (int rc = last_error()) return rc;
    if (int rc = static_cast<int>(cudaStreamSynchronize(s))) return rc;
    if (done) return 0;
  }
}

// Columns a lane of the chain's warp carries: the window is bs + 2 wide.
template <typename T>
int dispatch_slots(Sweep<T> a, int grid, long long* launches, cudaStream_t s) {
  if (a.bs + 2 <= 32) return run_sweeps<T, 1>(a, grid, launches, s);
  if (a.bs + 2 <= 64) return run_sweeps<T, 2>(a, grid, launches, s);
  return run_sweeps<T, 3>(a, grid, launches, s);
}

template <typename T>
int dispatch_capacity(int bs, int* blocks) {
  if (bs + 2 <= 32) return capacity<T, 1>(bs, blocks);
  if (bs + 2 <= 64) return capacity<T, 2>(bs, blocks);
  return capacity<T, 3>(bs, blocks);
}

}  // namespace

extern "C" {

// B13: blocked shifted Givens sweeps on the complex Hessenberg h (n x n, in
// place) until hi <= 1 or max_sweeps sweeps; q (nullable: eigenvalues only)
// is multiplied by the right rotations and h's slabs run through all n
// columns (Schur mode). eig = diag(h); state = {hi, lo, sweeps, done,
// converged} (int32); mu one scalar; ubuf ceil((n - 1) / bs) (bs + 1)^2
// scalars; side n scalars; flags n + ceil(n / 32) uint32; shifts (nullable)
// n_shifts scalars, sweep s shifting by shifts[s % n_shifts] instead of
// Wilkinson's. With parity != 0, B10: unshifted sweeps on the whole window
// (q and shifts null) until max|h[i+1, i]| <= tol (1 + ||h||_F) or
// max_sweeps sweeps, real or complex h; part holds 2 ceil(n / 32) + 1 reals
// and ends with the last maxsub. Cooperative launches of one block an SM
// (fewer when the tiles are fewer), each of at most kSweepsPerLaunch sweeps;
// the host reads the state after each and counts them in *launches. A grid
// > 0 sets the launch's size instead, for tests: under 3 or more than the
// card holds at once fails.
int qr_eig_blocked_sweeps(int dtype, int device, void* h, void* q, void* ubuf, void* side,
                          void* flags, void* eig, void* state, void* mu, const void* shifts,
                          int n_shifts, long long n, int max_sweeps, double tol, int bs, int grid,
                          int parity, void* part, long long* launches, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *launches = 0;
  if (n <= 0) return 0;
  if (bs < 1 || bs > kMaxBlock || n_shifts < 0 || grid < 0 || n >= (1LL << 31) ||
      (parity && (q != nullptr || n_shifts > 0 || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QRB_SWEEP(T)                                                                        \
  Sweep<T>{static_cast<T*>(h), static_cast<T*>(q), static_cast<T*>(ubuf),                  \
           static_cast<T*>(side), static_cast<T*>(eig), static_cast<int*>(state),           \
           static_cast<T*>(mu), static_cast<const T*>(shifts), static_cast<unsigned*>(flags), \
           static_cast<typename Ops<T>::Real*>(part), parity ? 1 : 0, n_shifts, n,          \
           max_sweeps, static_cast<typename Ops<T>::Real>(tol), bs, 1, 1, 1}
  switch (dtype) {
    case kF32:
      if (!parity) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_slots<float>(QRB_SWEEP(float), grid, launches, s);
    case kF64:
      if (!parity) return static_cast<int>(cudaErrorInvalidValue);
      return dispatch_slots<double>(QRB_SWEEP(double), grid, launches, s);
    case kC64: return dispatch_slots<float2>(QRB_SWEEP(float2), grid, launches, s);
    case kC128: return dispatch_slots<double2>(QRB_SWEEP(double2), grid, launches, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QRB_SWEEP
}

// The blocks B13's (or B10's) cooperative launch can hold at once (out[0])
// and the card's SMs (out[1]), for the dtype and block size.
int qr_eig_blocked_capacity(int dtype, int device, int bs, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bs < 1 || bs > kMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case kF32: return dispatch_capacity<float>(bs, out);
    case kF64: return dispatch_capacity<double>(bs, out);
    case kC64: return dispatch_capacity<float2>(bs, out);
    case kC128: return dispatch_capacity<double2>(bs, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
