// The dense QR eigenvalue stack for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/qr_kernels.py:
//   B8  _qr_eig_kernel (:293)       -> qr_eig_givens: qr_eig_kernel
//   B9  _qr_decompose_kernel (:756) -> qr_householder: blocked compact-WY
//                                      QR, qr_panel_kernel and the tiled GEMM
//                                      of eig_common.cuh
//   B10 _qr_parity_kernel (:797)    -> qr_parity_sweeps: the B9 steps,
//                                      gemm_kernel (H := R Q), parity_end_kernel
// for float, double, and complex float2/double2 ((re, im) in (.x, .y), the
// four-FMA product). B8 runs in complex arithmetic only, as on the TPU.
// B7 (_hessenberg_kernel, :55) is one cluster kernel of its own, in
// hessenberg_cluster.cu; the three-launch column step that it ran here
// (reflector_kernel, left_update_kernel, right_update_kernel) stays for B10.
//
// What bounds them, and what the design does about it:
//  * B10's inner steps (the unblocked B9 column step with pivot row k and
//    the update on Q) are n column steps, each O(n^2) and bound
//    by one read and write of the trailing matrix: ~1-4 MB per step at
//    n = 512, which stays in the 50 MB L2. At that size a step is a few
//    microseconds of memory work, so the chain of launches bounds it. Each
//    column is three launches enqueued by the C entry with no host read:
//    one block forms the reflector v and its factor (2, or 0 for the
//    tail-zero and degenerate skips) on the device; the left update is
//    column-parallel (a block owns 32 columns, forms w = v^H M for them and
//    updates them: no grid-wide dependency); the right update is
//    row-parallel (a warp owns a row, forms u = M v for it and updates it).
//    A cooperative persistent kernel with grid-wide barriers would save the
//    launch gaps; B10 moves onto the blocked B9 instead (ROADMAP).
//  * B9 is blocked: three launches per column (1536 at n = 512, ~3 us each,
//    a launch floor of ~4.6 ms against 8/3 n^3 flops) become, per panel of
//    nb columns, one panel kernel, a Gram product G = V^H V, one kernel that
//    forms T, Y = V T and Z = V T^H from it, and two products for the
//    trailing columns (a split-K W = Y^H C, whose depth n - k0 would leave a
//    plain tiled GEMM a handful of blocks, and C -= V W); and two per panel
//    for Q, accumulated backward after the last panel (4/3 n^3 flops where
//    the forward product costs 2 n^3). QR is one-sided, so a panel needs no
//    product with the trailing matrix while it is factored: one block of
//    1024 threads holds the (n - k0) x nb panel in shared memory (64 KB at
//    n = 512, nb = 32 in float; a panel that does not fit is read and
//    written through L2), a warp per column. Its serial floor is one barrier
//    a column (the next column's reflector is formed by the warp that owns
//    it), and its throughput the shared-memory traffic of the column
//    updates; T's inner products and Y and Z run on the grid instead.
//  * B8's rotations depend on each other in sequence, so one block runs the
//    whole solve, as the TPU kernel does. The left pass costs one barrier
//    per rotation: the thread that owns column k+1 forms rotation k+1 from
//    the value it has just written and puts it in shared memory. The right
//    pass needs no barrier: each thread applies all rotations of the sweep
//    to its own rows, carrying the rotated column in a register. H (2 MB
//    at n = 512 in complex64) stays in L2. Latency of the dependent steps
//    bounds it.
//  * B10 is about a full QR plus an n^3 product per sweep over hundreds of
//    sweeps, so it uses the whole card: the B9 steps as grid-wide kernels,
//    a tiled shared-memory GEMM (full FMA, no tensor cores, so no TF32), and
//    a one-block reduction for max|H[i,i-1]| and ||H||_F. The counter and
//    the flags stay on the device; every launch returns at once when `done`
//    is set, and the host reads `done` once per chunk of sweeps.
// No out-of-range row or column is ever read: every loop is bounded by n.
//
// Plain C interface for ctypes: each entry point selects the device,
// launches on the caller's stream and returns the first CUDA error (0 on
// success), checked after every launch.

#include "eig_common.cuh"

namespace {

constexpr int kTileCols = 32;               // left update: columns per block
constexpr int kTileRows = kThreads / 32;    // left update: row lanes per block
constexpr int kEigThreads = 512;            // B8: the one block
constexpr int kGemmTile = 32;
constexpr int kReduceThreads = 1024;
constexpr int kPanelThreads = 1024;         // B9: the one block of a panel
constexpr int kFactorThreads = 1024;        // B9: T (a warp a row), Y and Z
constexpr int kMaxQRPanel = 64;             // B9: largest panel width
constexpr int kPanelSmem = 220 * 1024;      // B9: dynamic shared memory of a panel (227 KB
                                            // a block, less the static part)

// B10 device state (doubles): sweeps done, converged, done, last maxsub.
enum ParityState { kIt = 0, kConverged = 1, kDone = 2, kMaxsub = 3 };

__device__ __forceinline__ bool stopped(const double* state) {
  return state != nullptr && state[kDone] != 0.0;
}

// ---- the Householder column step (B10) ----------------------------

// From column k of the n x n matrix M with pivot row s (s = k in B10's QR
// steps): v[0..n) = the unit reflector, zero above row s, and
// v[n] = its factor, 2, or 0 when the column is zero below the pivot
// (tail-zero skip) or the reflector degenerates (||v|| = 0). The sign is
// the pivot's phase x0/|x0|, 1 when x0 = 0 (qr_kernels.py:97-130).
template <typename T>
__global__ void __launch_bounds__(kThreads)
reflector_kernel(const T* __restrict__ M, int64_t n, int64_t k, int64_t s,
                 T* __restrict__ v, const double* __restrict__ state) {
  using O = Ops<T>;
  using R = typename O::Real;
  if (stopped(state)) return;
  __shared__ R red[32];
  __shared__ R s_vinv;
  __shared__ T s_vs;
  R nrm2 = 0, tail2 = 0;
  for (int64_t i = s + threadIdx.x; i < n; i += blockDim.x) {
    const R m = O::abs2(M[i * n + k]);
    nrm2 += m;
    if (i > s) tail2 += m;
  }
  nrm2 = block_reduce(nrm2, red, false);
  tail2 = block_reduce(tail2, red, false);
  if (threadIdx.x == 0) {
    const T x0 = M[s * n + k];
    const R m0 = dsqrt(O::abs2(x0));
    const T sign = m0 > R(0) ? O::divr(x0, m0) : O::one();
    const T vs = O::madd(x0, sign, O::make(dsqrt(nrm2), R(0)));  // x0 - alpha
    const R vn2 = tail2 + O::abs2(vs);
    const bool degenerate = vn2 == R(0);
    s_vinv = R(1) / dsqrt(degenerate ? R(1) : vn2);
    s_vs = vs;
    v[n] = O::make(tail2 == R(0) || degenerate ? R(0) : R(2), R(0));
  }
  __syncthreads();
  const R vinv = s_vinv;
  for (int64_t i = threadIdx.x; i < n; i += blockDim.x) {
    const T x = i < s ? O::zero() : (i == s ? s_vs : M[i * n + k]);
    v[i] = O::scale(x, vinv);
  }
}

// M[i, j] -= f v[i] w[j] with w[j] = sum_i conj(v[i]) M[i, j], on rows >= s
// (v is zero above) and columns >= k (qr_kernels.py:123, :141-142). A block
// owns 32 columns and all their rows, so w needs no grid-wide step.
// f v[i] w[j] == v[i] (f w[j]) exactly: f is 0 or 2.
template <typename T>
__global__ void __launch_bounds__(kThreads)
left_update_kernel(T* __restrict__ M, int64_t n, int64_t k, int64_t s,
                   const T* __restrict__ v, const double* __restrict__ state) {
  using O = Ops<T>;
  if (stopped(state)) return;
  __shared__ T part[kTileRows][kTileCols];
  const int tx = threadIdx.x % kTileCols, ty = threadIdx.x / kTileCols;
  const int64_t j = k + static_cast<int64_t>(blockIdx.x) * kTileCols + tx;
  T w = O::zero();
  if (j < n)
    for (int64_t i = s + ty; i < n; i += kTileRows) w = O::madd(w, O::conj(v[i]), M[i * n + j]);
  part[ty][tx] = w;
  __syncthreads();
  if (ty == 0) {
    for (int r = 1; r < kTileRows; ++r) w = O::madd(w, O::one(), part[r][tx]);
    part[0][tx] = O::scale(w, O::re(v[n]));
  }
  __syncthreads();
  const T fw = part[0][tx];
  if (j < n)
    for (int64_t i = s + ty; i < n; i += kTileRows) M[i * n + j] = O::msub(M[i * n + j], v[i], fw);
}

// M[i, j] -= f u[i] conj(v[j]) with u[i] = sum_j M[i, j] v[j], on all rows
// and columns >= s (B10: the accumulated Q). A warp owns a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
right_update_kernel(T* __restrict__ Mm, int64_t n, int64_t s, const T* __restrict__ v,
                    const double* __restrict__ state) {
  using O = Ops<T>;
  if (stopped(state)) return;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= n) return;
  T* __restrict__ M = Mm + row * n;
  T u = O::zero();
  for (int64_t j = s + lane; j < n; j += 32) u = O::madd(u, M[j], v[j]);
  const T fu = O::scale(warp_allsum(u), O::re(v[n]));
  for (int64_t j = s + lane; j < n; j += 32) M[j] = O::msub(M[j], fu, O::conj(v[j]));
}

// One column step: reflector from column k with pivot row s, left update of
// `left` (rows >= s, columns >= k), right update of `right` on columns >= s.
template <typename T>
int column_step(T* left, T* right, int64_t n, int64_t k, int64_t s, T* v, const double* state,
                cudaStream_t st) {
  reflector_kernel<T><<<1, kThreads, 0, st>>>(left, n, k, s, v, state);
  if (int rc = last_error()) return rc;
  left_update_kernel<T><<<blocks_for(n - k, kTileCols), kThreads, 0, st>>>(left, n, k, s, v, state);
  if (int rc = last_error()) return rc;
  right_update_kernel<T><<<blocks_for(n, kThreads / 32), kThreads, 0, st>>>(right, n, s, v, state);
  return last_error();
}

// ---- B9: blocked compact-WY Householder QR ---------------------------------

// The reflector of column x (pivot at local row j, below it tail2 =
// sum |x_i|^2) with reflector_kernel's rule: the phase sign x0/|x0| (1 when
// x0 = 0), factor 2, or 0 for the tail-zero and degenerate skips; stores
// x0 + sign ||x|| (the pivot of v before scaling), 1 / ||v||, the factor
// and R's diagonal entry (-sign ||x||, or x0 when skipped).
template <typename T>
__device__ __forceinline__ void panel_reflector(T x0, typename Ops<T>::Real tail2, T* vs,
                                                typename Ops<T>::Real* vinv,
                                                typename Ops<T>::Real* f, T* diag) {
  using O = Ops<T>;
  using R = typename O::Real;
  const R a0 = O::abs2(x0), m0 = dsqrt(a0), nrm = dsqrt(tail2 + a0);
  const T sign = m0 > R(0) ? O::divr(x0, m0) : O::one();
  const T v0 = O::madd(x0, sign, O::make(nrm, R(0)));
  const R vn2 = tail2 + O::abs2(v0);
  const bool degenerate = vn2 == R(0), skip = tail2 == R(0) || degenerate;
  *vs = v0;
  *vinv = R(1) / dsqrt(degenerate ? R(1) : vn2);
  *f = skip ? R(0) : R(2);
  *diag = skip ? x0 : O::scale(sign, -nrm);
}

// Factors the m x jn panel R[k0:, k0:k0+jn] (m = n - k0) in one block,
// column by column with reflector_kernel's rule at pivot row k = k0 + j
// (panel_reflector; v of unit norm and zero above the pivot), each
// reflector applied at once to the panel's later columns. The panel is held
// column-major (ld m) in dynamic shared memory when it fits (`in_smem`),
// else in the global scratch Pg, read and written through L2. Writes the
// panel's R columns (exact zeros below the diagonal), rows k0: of the
// panel's columns of V (n x n, zeros above each pivot), the factors f_j
// (tau, as scalars of T's type) and zeros into the Gram matrix G (jn x jn)
// that wy_product adds to. T, Y = V T and Z = V T^H are formed by
// wy_factor_kernel from G = V^H V.
//
// One barrier a column. Warp w owns columns w and w + 32. At step j the
// owner of each later column applies reflector j to it, reading v_j where
// it lies (column j, already normalised in place); the owner of column
// j + 1 also sums its new |x|^2 below the pivot, forms that reflector and
// normalises v_{j+1} in place (look-ahead), so no block-wide reduction
// stands on the critical path. The column loops are bound by instruction
// issue, so they carry nothing but a load, a multiply-add and a store.
template <typename T>
__global__ void __launch_bounds__(kPanelThreads)
qr_panel_kernel(T* __restrict__ Rm, T* __restrict__ V, T* __restrict__ tau, T* __restrict__ G,
                T* __restrict__ Pg, int64_t n, int64_t k0, int jn, int in_smem) {
  using O = Ops<T>;
  using R = typename O::Real;
  extern __shared__ __align__(16) unsigned char panel_smem[];
  T* P = in_smem ? reinterpret_cast<T*>(panel_smem) : Pg;  // m x jn, column-major
  __shared__ T s_diag[kMaxQRPanel];
  __shared__ R s_f[kMaxQRPanel];
  const int m = static_cast<int>(n - k0);
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  // (i, j) of element e = i jn + j, stepped by nt without a division a step
  const int di = nt / jn, dj = nt - di * jn;
  for (int i = t / jn, j = t % jn; i < m; i += di, j += dj) {  // coalesced along R's rows
    if (j >= jn) {
      j -= jn;
      ++i;
      if (i >= m) break;
    }
    P[j * m + i] = Rm[(k0 + i) * n + k0 + j];
  }
  for (int e = t; e < jn * jn; e += nt) G[e] = O::zero();
  __syncthreads();
  // column q's reflector from tail2 (its |x|^2 below the pivot), and v_q
  // normalised in place (rows >= q), by the warp that owns column q
  auto pivot = [&](int q, R tail2) {
    T* __restrict__ p = P + q * m;
    for (int off = 16; off > 0; off >>= 1) tail2 += __shfl_xor_sync(0xffffffffu, tail2, off);
    T vs;
    R vinv, f;
    T diag;
    __syncwarp();  // the pivot entry, written by another lane
    panel_reflector(p[q], tail2, &vs, &vinv, &f, &diag);
    __syncwarp();
    for (int i = q + lane; i < m; i += 32) p[i] = O::scale(i == q ? vs : p[i], vinv);
    if (lane == 0) {
      s_f[q] = f;
      s_diag[q] = diag;
    }
  };
  if (warp == 0) {
    R tail2 = 0;
    for (int i = 1 + lane; i < m; i += 32) tail2 += O::abs2(P[i]);
    pivot(0, tail2);
  }
  __syncthreads();
  for (int j = 0; j < jn; ++j) {
    const R f = s_f[j];
    const T* __restrict__ v = P + j * m;  // v_j, unit, zero above row j
    for (int l = warp; l < jn; l += nwarps) {
      if (l <= j) continue;
      // the owner of column j + 1 sums its new |x|^2 below the pivot as it
      // goes, then forms that column's reflector (look-ahead)
      const bool ahead = l == j + 1;
      T* __restrict__ p = P + l * m;
      R tail2 = 0;
      if (f != R(0)) {
        T acc = O::zero();
#pragma unroll 4
        for (int i = j + lane; i < m; i += 32) acc = O::madd(acc, O::conj(v[i]), p[i]);
        const T fw = O::scale(warp_allsum(acc), f);
        if (ahead) {
#pragma unroll 4
          for (int i = j + lane; i < m; i += 32) {
            const T x = O::msub(p[i], v[i], fw);
            p[i] = x;
            if (i > l) tail2 += O::abs2(x);
          }
        } else {
#pragma unroll 4
          for (int i = j + lane; i < m; i += 32) p[i] = O::msub(p[i], v[i], fw);
        }
      } else if (ahead) {
        for (int i = l + 1 + lane; i < m; i += 32) tail2 += O::abs2(p[i]);
      }
      if (ahead) pivot(l, tail2);
    }
    __syncthreads();
  }
  for (int i = t / jn, j = t % jn; i < m; i += di, j += dj) {
    if (j >= jn) {
      j -= jn;
      ++i;
      if (i >= m) break;
    }
    const T p = P[j * m + i];
    const int64_t g = (k0 + i) * n + k0 + j;
    Rm[g] = i < j ? p : (i == j ? s_diag[j] : O::zero());
    V[g] = i < j ? O::zero() : p;
  }
  if (t < jn) tau[t] = O::make(s_f[t], R(0));
  __syncthreads();
}

// T, Y = V T and Z = V T^H of a panel (V: rows k0: of the panel's columns,
// m x jn at ld n), from its Gram matrix G = V^H V and factors tau: T[r, r]
// = tau_r, T[r, j] = -tau_j sum_{r <= l < j} T[r, l] G[l, j], a recurrence
// along each row, so a warp forms a row. Every block forms T (jn steps of a
// warp sum) and then its 64 rows of Y and Z from a tile of V in shared
// memory; its threads also zero the block's share of W (jn x n2) and Wq
// (jn x m), which the WY products add to.
template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
wy_factor_kernel(const T* __restrict__ V, const T* __restrict__ G, const T* __restrict__ tau,
                 T* __restrict__ Y, T* __restrict__ Z, T* __restrict__ W, T* __restrict__ Wq,
                 int64_t n, int64_t m, int jn) {
  using O = Ops<T>;
  extern __shared__ __align__(16) unsigned char factor_smem[];
  const int ld = jn + 1;
  T* Ts = reinterpret_cast<T*>(factor_smem);  // jn x ld
  T* Gs = Ts + jn * ld;                        // jn x ld
  T* Vs = Gs + jn * ld;                        // 64 x ld: rows i0 .. i0 + 63 of V
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * 64;
  const int64_t n2 = m - jn;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + t; e < jn * m;
       e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t r = e / m, c = e - r * m;
    Wq[r * n + c] = O::zero();
    if (c < n2) W[r * n + c] = O::zero();
  }
  for (int e = t; e < jn * jn; e += blockDim.x) {
    Gs[(e / jn) * ld + e % jn] = G[e];
    Ts[(e / jn) * ld + e % jn] = O::zero();
  }
  for (int e = t; e < 64 * jn; e += blockDim.x) {
    const int64_t i = i0 + e / jn;
    Vs[(e / jn) * ld + e % jn] = i < m ? V[i * n + e % jn] : O::zero();
  }
  __syncthreads();
  for (int r = warp; r < jn; r += nwarps) {
    if (lane == 0) Ts[r * ld + r] = tau[r];
    __syncwarp();
    for (int j = r + 1; j < jn; ++j) {
      T acc = O::zero();
      for (int l = r + lane; l < j; l += 32) acc = O::madd(acc, Ts[r * ld + l], Gs[l * ld + j]);
      acc = warp_allsum(acc);
      if (lane == 0) Ts[r * ld + j] = O::scale(acc, -O::re(tau[j]));
      __syncwarp();
    }
  }
  __syncthreads();
  for (int e = t; e < 64 * jn; e += blockDim.x) {
    const int ii = e / jn, j = e % jn;
    const int64_t i = i0 + ii;
    if (i >= m) break;
    T y = O::zero(), z = O::zero();
    const int lmax = i < jn - 1 ? static_cast<int>(i) : jn - 1;  // V[i, l] = 0 for l > i
    for (int l = 0; l <= lmax; ++l) {
      const T vl = Vs[ii * ld + l];
      y = O::madd(y, vl, Ts[l * ld + j]);           // T[l, j], zero for l > j
      z = O::madd(z, vl, O::conj(Ts[j * ld + l]));  // T^H[l, j] = conj(T[j, l]), zero for l < j
    }
    Y[i * n + j] = y;
    Z[i * n + j] = z;
  }
}

// W (+)= A^H B for A (K x M, lda) and B (K x N, ldb), M <= kRows: blocks
// split K into slices of kKSlice rows and add their partial products to W
// atomically (W starts at zero), so that the deep, narrow products of the
// WY updates (M = nb columns, K = n - k0 rows) fill the card. 16-deep
// shared-memory tiles, a (kRows / 16) x 4 register block per thread, full
// FMA in the working precision.
constexpr int kKSlice = 32;

__device__ __forceinline__ void atomic_add(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(double* p, double v) { atomicAdd(p, v); }
__device__ __forceinline__ void atomic_add(float2* p, float2 v) {
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
}
__device__ __forceinline__ void atomic_add(double2* p, double2 v) {
  atomicAdd(&p->x, v.x);
  atomicAdd(&p->y, v.y);
}

template <typename T, int kRows>
__global__ void __launch_bounds__(kGemmThreads)
wy_product_kernel(int64_t K, int M, int64_t N, const T* __restrict__ A, int64_t lda,
                  const T* __restrict__ B, int64_t ldb, T* __restrict__ W, int64_t ldw) {
  using O = Ops<T>;
  constexpr int kRowsPerThread = kRows / 16;
  __shared__ T As[kBK][kRows + 1];
  __shared__ T Bs[kBK][kBN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int64_t k_lo = static_cast<int64_t>(blockIdx.y) * kKSlice;
  const int64_t k_hi = k_lo + kKSlice < K ? k_lo + kKSlice : K;
  T acc[kRowsPerThread][4];
  for (int r = 0; r < kRowsPerThread; ++r)
    for (int c = 0; c < 4; ++c) acc[r][c] = O::zero();
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += kBK) {
    for (int e = threadIdx.x; e < kBK * kRows; e += kGemmThreads) {
      const int kk = e / kRows, i = e % kRows;  // A^H[i, k] = conj(A[k, i]): along A's rows
      const int64_t k = k0 + kk;
      As[kk][i] = k < k_hi && i < M ? O::conj(A[k * lda + i]) : O::zero();
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kGemmThreads) {
      const int kk = e / kBN, j = e % kBN;
      const int64_t k = k0 + kk, c = col0 + j;
      Bs[kk][j] = k < k_hi && c < N ? B[k * ldb + c] : O::zero();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T a[kRowsPerThread], b[4];
      for (int r = 0; r < kRowsPerThread; ++r) a[r] = As[kk][ty + 16 * r];
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
      for (int r = 0; r < kRowsPerThread; ++r)
        for (int c = 0; c < 4; ++c) acc[r][c] = O::madd(acc[r][c], a[r], b[c]);
    }
    __syncthreads();
  }
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = ty + 16 * r;
    if (i >= M) continue;
    for (int c = 0; c < 4; ++c) {
      const int64_t j = col0 + tx + 16 * c;
      if (j < N) atomic_add(W + i * ldw + j, acc[r][c]);
    }
  }
}

template <typename T>
int wy_product(int64_t K, int M, int64_t N, const T* A, int64_t lda, const T* B, int64_t ldb,
               T* W, int64_t ldw, cudaStream_t st) {
  if (M <= 0 || N <= 0 || K <= 0) return 0;
  const dim3 grid(blocks_for(N, kBN), blocks_for(K, kKSlice));
  if (M <= 32) {
    wy_product_kernel<T, 32><<<grid, kGemmThreads, 0, st>>>(K, M, N, A, lda, B, ldb, W, ldw);
  } else {
    wy_product_kernel<T, 64><<<grid, kGemmThreads, 0, st>>>(K, M, N, A, lda, B, ldb, W, ldw);
  }
  return last_error();
}

// B9 by panels of nb columns: each panel factored by qr_panel_kernel; its
// Gram matrix G = V^H V (wy_product) gives T, Y = V T and Z = V T^H
// (wy_factor_kernel); the trailing columns are updated as
// R[k0:, k0+jn:] -= V (Y^H R[k0:, k0+jn:]) (each H_j is Hermitian, so the
// panel's H_{jn-1} ... H_0 is I - V T^H V^H), and, after the last panel,
// Q = H_0 ... H_{kmax-1} is accumulated backward in LAPACK orgqr order:
// Q = I, then for each panel from the last, Q[k0:, k0:] -= V (Z^H Q[k0:, k0:]).
// Each update is one split-K product (wy_product) and one tiled GEMM.
// scratch holds V, Y and Z (n x n each), W (nb x n), one nb x n product per
// panel for Q, an n x nb panel for the case where it does not fit in shared
// memory, and G and tau. *launches counts the kernels.
template <typename T>
int run_householder(const T* a, T* r, T* q, T* scratch, int64_t n, int64_t kmax, int nb,
                    long long* launches, cudaStream_t st) {
  *launches = 0;
  cudaMemcpyAsync(r, a, n * n * sizeof(T), cudaMemcpyDeviceToDevice, st);
  if (int rc = last_error()) return rc;
  eye_kernel<T><<<blocks_for(n * n, kThreads), kThreads, 0, st>>>(q, n);
  if (int rc = last_error()) return rc;
  ++*launches;
  const int64_t panels = (kmax + nb - 1) / nb;
  T* V = scratch;
  T* Y = V + n * n;
  T* Z = Y + n * n;
  T* W = Z + n * n;
  T* Wq = W + nb * n;
  T* Pg = Wq + panels * nb * n;
  T* G = Pg + n * nb;
  T* tau = G + nb * nb;
  if (int rc = allow_dynamic_smem<qr_panel_kernel<T>>(kPanelSmem)) return rc;
  if (int rc = allow_dynamic_smem<wy_factor_kernel<T>>(
          (2 * kMaxQRPanel + 64) * (kMaxQRPanel + 1) * static_cast<int>(sizeof(T))))
    return rc;
  auto counted = [&](int rc, bool launched) {
    if (launched) ++*launches;
    return rc;
  };
  for (int64_t p = 0; p < panels; ++p) {
    const int64_t k0 = p * nb, m = n - k0, off = k0 * n + k0;
    const int jn = static_cast<int>(kmax - k0 < nb ? kmax - k0 : nb);
    const int64_t n2 = m - jn;
    const int64_t whole = m * jn * static_cast<int64_t>(sizeof(T));
    const bool fits = whole <= kPanelSmem;
    qr_panel_kernel<T><<<1, kPanelThreads, fits ? static_cast<int>(whole) : 0, st>>>(
        r, V, tau, G, Pg, n, k0, jn, fits);
    int rc = 0;
    if ((rc = counted(last_error(), true)) ||
        (rc = counted(wy_product<T>(m, jn, jn, V + off, n, V + off, n, G, jn, st), true)))
      return rc;
    const int factor_smem = (2 * jn + 64) * (jn + 1) * static_cast<int>(sizeof(T));
    wy_factor_kernel<T><<<blocks_for(m, 64), kFactorThreads, factor_smem, st>>>(
        V + off, G, tau, Y + off, Z + off, W, Wq + p * nb * n, n, m, jn);
    if ((rc = counted(last_error(), true)) ||
        (rc = counted(wy_product<T>(m, jn, n2, Y + off, n, r + off + jn, n, W, n, st), n2 > 0)) ||
        (rc = counted(gemm<T>(m, n2, jn, V + off, n, kN, W, n, kN, r + off + jn, n, -1.0, true,
                              st), n2 > 0)))
      return rc;
  }
  for (int64_t p = panels - 1; p >= 0; --p) {
    const int64_t k0 = p * nb, m = n - k0, off = k0 * n + k0;
    const int jn = static_cast<int>(kmax - k0 < nb ? kmax - k0 : nb);
    T* Wp = Wq + p * nb * n;
    int rc = 0;
    if ((rc = counted(wy_product<T>(m, jn, m, Z + off, n, q + off, n, Wp, n, st), true)) ||
        (rc = counted(gemm<T>(m, m, jn, V + off, n, kN, Wp, n, kN, q + off, n, -1.0, true, st),
                      true)))
      return rc;
  }
  return 0;
}

// ---- B8 ------------------------------------------------------------------

// Right rotations k in [lo, hi-1) on row `row` of M: columns k, k+1 become
// conj(g00) c_k + conj(g01) c_k1 and -g01 c_k + g00 c_k1, in order, with the
// rotated column k+1 carried in a register.
template <typename T>
__device__ __forceinline__ void rotate_row(T* row, const T* rot, int lo, int hi) {
  using O = Ops<T>;
  T ck = row[lo];
  for (int k = lo; k < hi - 1; ++k) {
    const T g00 = rot[2 * k], g01 = rot[2 * k + 1];
    const T ck1 = row[k + 1];
    row[k] = O::madd(O::madd(O::zero(), O::conj(g00), ck), O::conj(g01), ck1);
    ck = O::msub(O::madd(O::zero(), g00, ck1), g01, ck);
  }
  row[hi - 1] = ck;
}

// The whole shifted Givens QR iteration on the complex Hessenberg H (n x n,
// in place) in one block; Q (optional, starts as I) takes the right
// rotations. Writes eig = diag(H) and state = {sweeps, hi}.
template <typename T>
__global__ void __launch_bounds__(kEigThreads)
qr_eig_kernel(T* __restrict__ H, T* __restrict__ Q, T* __restrict__ rot, T* __restrict__ eig,
              int* __restrict__ state, int64_t n, int max_sweeps, typename Ops<T>::Real tol) {
  using O = Ops<T>;
  __shared__ int sh[2];
  __shared__ T s_g[2][2];  // rotations k (even/odd slot): g00, g01
  __shared__ T s_mu;
  const int t = threadIdx.x, nt = blockDim.x;
  deflate_and_lo(H, n, static_cast<int>(n), tol, sh);
  int hi = sh[0] + 2, lo = sh[1] + 1, sweeps = 0;
  while (hi > 1 && sweeps < max_sweeps) {
    if (t == 0) s_mu = wilkinson_shift(H, n, hi);
    __syncthreads();
    const T mu = s_mu;
    for (int i = lo + t; i < hi; i += nt) H[i * n + i] = O::sub(H[i * n + i], mu);
    __syncthreads();
    // left pass: rows k, k+1 over all columns, k = lo .. hi-2
    if (t == 0) {
      givens(H[lo * n + lo], H[(lo + 1) * n + lo], s_g[lo & 1]);
      rot[2 * lo] = s_g[lo & 1][0];
      rot[2 * lo + 1] = s_g[lo & 1][1];
    }
    __syncthreads();
    for (int k = lo; k < hi - 1; ++k) {
      const T g00 = s_g[k & 1][0], g01 = s_g[k & 1][1];
      for (int64_t j = t; j < n; j += nt) {
        T rk = H[k * n + j], nk1 = H[(k + 1) * n + j];
        rotate_pair(g00, g01, &rk, &nk1);
        H[k * n + j] = rk;
        H[(k + 1) * n + j] = nk1;
        if (j == k + 1 && k + 2 < hi) {  // the owner of column k+1 forms rotation k+1
          T* g = s_g[(k + 1) & 1];
          givens(nk1, H[(k + 2) * n + k + 1], g);
          rot[2 * (k + 1)] = g[0];
          rot[2 * (k + 1) + 1] = g[1];
        }
      }
      __syncthreads();
    }
    // right pass: columns k, k+1 over all rows; rows are independent
    for (int64_t i = t; i < n; i += nt) {
      rotate_row(H + i * n, rot, lo, hi);
      if (Q != nullptr) rotate_row(Q + i * n, rot, lo, hi);
    }
    __syncthreads();
    for (int i = lo + t; i < hi; i += nt) H[i * n + i] = O::madd(H[i * n + i], O::one(), mu);
    __syncthreads();
    deflate_and_lo(H, n, hi, tol, sh);
    hi = sh[0] + 2;
    lo = sh[1] + 1;
    ++sweeps;
  }
  for (int64_t i = t; i < n; i += nt) eig[i] = H[i * n + i];
  if (t == 0) {
    state[0] = sweeps;
    state[1] = hi;
  }
}

template <typename T>
int run_eig(const T* h_in, T* h, T* q, T* rot, T* eig, int* state, int64_t n, int max_sweeps,
            double tol, cudaStream_t st) {
  cudaMemcpyAsync(h, h_in, n * n * sizeof(T), cudaMemcpyDeviceToDevice, st);
  if (int rc = last_error()) return rc;
  if (q != nullptr) {
    eye_kernel<T><<<blocks_for(n * n, kThreads), kThreads, 0, st>>>(q, n);
    if (int rc = last_error()) return rc;
  }
  using R = typename Ops<T>::Real;
  qr_eig_kernel<T><<<1, kEigThreads, 0, st>>>(h, q, rot, eig, state, n, max_sweeps,
                                              static_cast<R>(tol));
  return last_error();
}

// ---- B10 -----------------------------------------------------------------

template <typename T>
__global__ void parity_begin_kernel(const T* __restrict__ H, T* __restrict__ R_, T* __restrict__ Q,
                                    int64_t n, const double* __restrict__ state) {
  using O = Ops<T>;
  if (stopped(state)) return;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * n) return;
  R_[e] = H[e];
  Q[e] = e / n == e % n ? O::one() : O::zero();
}

// C = A B for n x n row-major matrices: 32 x 32 output tiles, 32-deep
// shared-memory tiles of A and B, four outputs per thread, FMA in the
// working precision.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C, int64_t n,
            const double* __restrict__ state) {
  using O = Ops<T>;
  if (stopped(state)) return;
  __shared__ T As[kGemmTile][kGemmTile + 1];
  __shared__ T Bs[kGemmTile][kGemmTile + 1];
  constexpr int kRowsPerThread = kGemmTile / (kThreads / kGemmTile);
  const int tx = threadIdx.x % kGemmTile, ty = threadIdx.x / kGemmTile;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kGemmTile;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kGemmTile + tx;
  T acc[kRowsPerThread];
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = O::zero();
  for (int64_t k0 = 0; k0 < n; k0 += kGemmTile) {
    for (int r = ty; r < kGemmTile; r += kThreads / kGemmTile) {
      const int64_t ar = row0 + r, ac = k0 + tx, br = k0 + r;
      As[r][tx] = ar < n && ac < n ? A[ar * n + ac] : O::zero();
      Bs[r][tx] = br < n && col < n ? B[br * n + col] : O::zero();
    }
    __syncthreads();
    for (int kk = 0; kk < kGemmTile; ++kk) {
      const T b = Bs[kk][tx];
      for (int q = 0; q < kRowsPerThread; ++q)
        acc[q] = O::madd(acc[q], As[ty + q * (kThreads / kGemmTile)][kk], b);
    }
    __syncthreads();
  }
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int64_t row = row0 + ty + q * (kThreads / kGemmTile);
    if (row < n && col < n) C[row * n + col] = acc[q];
  }
}

// After a sweep: maxsub = max|H[i+1, i]|, fro = ||H||_F, converged when
// maxsub <= tol (1 + fro) in the working precision (qr_kernels.py:850-853);
// counts the sweep and sets done on convergence or at max_it.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
parity_end_kernel(const T* __restrict__ H, int64_t n, double* __restrict__ state, int max_it,
                  double tol) {
  using O = Ops<T>;
  using R = typename O::Real;
  if (stopped(state)) return;
  __shared__ R red[32];
  R fro2 = 0, sub2 = 0;
  for (int64_t e = threadIdx.x; e < n * n; e += blockDim.x) {
    const R m = O::abs2(H[e]);
    fro2 += m;
    if (e / n == e % n + 1 && m > sub2) sub2 = m;
  }
  fro2 = block_reduce(fro2, red, false);
  sub2 = block_reduce(sub2, red, true);
  if (threadIdx.x == 0) {
    const R maxsub = dsqrt(sub2);
    const bool conv = maxsub <= static_cast<R>(tol) * (R(1) + dsqrt(fro2));
    const double it = state[kIt] + 1.0;
    state[kIt] = it;
    state[kConverged] = conv ? 1.0 : 0.0;
    state[kDone] = conv || it >= max_it ? 1.0 : 0.0;
    state[kMaxsub] = static_cast<double>(maxsub);
  }
}

__global__ void parity_init_kernel(double* state, int max_it) {
  state[kIt] = 0.0;
  state[kConverged] = 0.0;
  state[kDone] = max_it <= 0 ? 1.0 : 0.0;
  state[kMaxsub] = 0.0;
}

template <typename T>
int run_parity(const T* h_in, T* h, T* r, T* q, T* v, double* state, int64_t n, int max_it,
               double tol, int chunk, cudaStream_t st) {
  cudaMemcpyAsync(h, h_in, n * n * sizeof(T), cudaMemcpyDeviceToDevice, st);
  if (int rc = last_error()) return rc;
  parity_init_kernel<<<1, 1, 0, st>>>(state, max_it);
  if (int rc = last_error()) return rc;
  const dim3 gemm_grid(blocks_for(n, kGemmTile), blocks_for(n, kGemmTile));
  for (int queued = 0; queued < max_it;) {
    const int sweeps = chunk < max_it - queued ? chunk : max_it - queued;
    for (int sw = 0; sw < sweeps; ++sw) {
      parity_begin_kernel<T><<<blocks_for(n * n, kThreads), kThreads, 0, st>>>(h, r, q, n, state);
      if (int rc = last_error()) return rc;
      for (int64_t k = 0; k < n; ++k)
        if (int rc = column_step<T>(r, q, n, k, k, v, state, st)) return rc;
      gemm_kernel<T><<<gemm_grid, kThreads, 0, st>>>(r, q, h, n, state);
      if (int rc = last_error()) return rc;
      parity_end_kernel<T><<<1, kReduceThreads, 0, st>>>(h, n, state, max_it, tol);
      if (int rc = last_error()) return rc;
    }
    queued += sweeps;
    double done = 0.0;
    cudaMemcpyAsync(&done, state + kDone, sizeof(double), cudaMemcpyDeviceToHost, st);
    if (int rc = last_error()) return rc;
    if (int rc = static_cast<int>(cudaStreamSynchronize(st))) return rc;
    if (done != 0.0) break;
  }
  return 0;
}

}  // namespace

extern "C" {

// B9: a = q r after kmax Householder column steps, by panels of nb <= 64
// columns. scratch holds 3 n^2 + (ceil(kmax / nb) + 2) nb n + nb^2 + nb
// scalars;
// *launches (host) receives the number of kernels enqueued.
int qr_householder(int dtype, int device, const void* a, void* r, void* q, void* scratch,
                   long long n, long long kmax, int nb, long long* launches, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *launches = 0;
  if (nb < 1 || nb > kMaxQRPanel || kmax < 0 || kmax > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QR_ARGS(T) static_cast<const T*>(a), static_cast<T*>(r), static_cast<T*>(q), \
                   static_cast<T*>(scratch), n, kmax, nb, launches, s
  switch (dtype) {
    case kF32: return run_householder<float>(QR_ARGS(float));
    case kF64: return run_householder<double>(QR_ARGS(double));
    case kC64: return run_householder<float2>(QR_ARGS(float2));
    case kC128: return run_householder<double2>(QR_ARGS(double2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QR_ARGS
}

// B8: shifted Givens QR of the complex Hessenberg h_in into h; eig = its
// diagonal, state = {sweeps, hi} (int32), q (nullable) the Schur vectors.
// rot holds 2 * max(n - 1, 1) scalars.
int qr_eig_givens(int dtype, int device, const void* h_in, void* h, void* q, void* rot, void* eig,
                  void* state, long long n, int max_sweeps, double tol, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QR_ARGS(T) static_cast<const T*>(h_in), static_cast<T*>(h), static_cast<T*>(q), \
                   static_cast<T*>(rot), static_cast<T*>(eig), static_cast<int*>(state), n, \
                   max_sweeps, tol, s
  switch (dtype) {
    case kC64: return run_eig<float2>(QR_ARGS(float2));
    case kC128: return run_eig<double2>(QR_ARGS(double2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QR_ARGS
}

// B10: the parity iteration from h_in into h; r and q are n x n scratch,
// scratch n + 1 scalars, state 4 doubles {it, converged, done, maxsub}.
// Enqueues `chunk` sweeps between two host reads of done.
int qr_parity_sweeps(int dtype, int device, const void* h_in, void* h, void* r, void* q,
                     void* scratch, void* state, long long n, int max_it, double tol, int chunk,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define QR_ARGS(T) static_cast<const T*>(h_in), static_cast<T*>(h), static_cast<T*>(r), \
                   static_cast<T*>(q), static_cast<T*>(scratch), static_cast<double*>(state), n, \
                   max_it, tol, chunk, s
  switch (dtype) {
    case kF32: return run_parity<float>(QR_ARGS(float));
    case kF64: return run_parity<double>(QR_ARGS(double));
    case kC64: return run_parity<float2>(QR_ARGS(float2));
    case kC128: return run_parity<double2>(QR_ARGS(double2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QR_ARGS
}

}  // extern "C"
