// The dense QR stack for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/qr_kernels.py:
//   B8  _qr_eig_kernel (:293)       -> qr_eig_givens: qr_eig_kernel, one block
//   B9  _qr_decompose_kernel (:756) -> qr_householder: blocked compact-WY
//                                      QR, qr_panel_kernel, wy_factor_kernel,
//                                      the deterministic split-K
//                                      wy_slices_kernel and the tiled GEMM of
//                                      eig_common.cuh
// for float, double, and complex float2/double2 ((re, im) in (.x, .y), the
// four-FMA product). B8 runs in complex arithmetic only, as on the TPU.
// B7 (_hessenberg_kernel, :55) is one cluster kernel of its own, in
// hessenberg_cluster.cu; B10 (_qr_parity_kernel, :797) runs as the blocked
// Givens sweeps of qr_eig_blocked.cu in parity mode.
//
// What bounds them, and what the design does about it:
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
//    updates; T's inner products and Y and Z run on the grid instead. The
//    split-K products (wy_product) take tiles only as tall as the panel is
//    wide, write one partial a slice and add them in slice order, with no
//    atomics: R and Q repeat bit for bit.
//  * B8's rotations form a serial chain (rotation k is formed from column k
//    after rotation k - 1), and at the sizes it serves (up to
//    UNBLOCKED_MAX_N, and AED's windows of 64-256 rows) one SM has the
//    arithmetic for the rest. So one block of 16 warps runs the whole solve,
//    B13's sweep (qr_eig_blocked.cu) inside one block: the rotations in
//    blocks of bs, each accumulated into U_i ((bs + 1)^2), with the grid's L2
//    flags replaced by counters in shared memory.
//     - H lives in shared memory where it fits (row stride n | 1, so that a
//       warp reading 32 rows of a column hits 32 banks), else in the output
//       in global memory (the same warps, with the chain's window and the
//       right passes staged through shared memory).
//     - Warp 0 runs the chain: rotate_window of eig_common.cuh, a lane a
//       window column, the next rotation by one shuffle, no block barrier
//       per rotation; then the look-ahead row of the next window (U_i's
//       last row times the rows below, as B13's chain) and one release of a
//       counter. U_i and that row's original entries go to a ring of
//       kEigRing slots; a slot is reused once every worker has finished the
//       block that used it.
//     - Warps 1 .. 15 are workers, each a warp-wide task at a time on a
//       fixed set of tiles of 32 columns (slabs: U_i times the block's rows
//       beyond the window) or 32 rows (right passes: H's rows 0 .. e_i + 1,
//       and Q's, times U_i^H), a lane a column or a row, waiting by acquire
//       loads on the counters, as the tasks of ops/qr_eig_blocked.py's
//       _sweep_tasks wait.
//     - Between sweeps the block adds the shift back, scans for deflation,
//       counts the sweep and forms the next Wilkinson shift: the whole solve
//       is one launch, Q's identity and the copy of H included.
//    Each entry is written by one thread in a fixed order: T and Q repeat
//    bit for bit. The chain bounds a sweep: each rotation is a dependent
//    sequence of a shuffle, a square root and a division. A worker's
//    product costs bs + 1 complex multiply-adds an entry (kIlp outputs at a
//    time, for independent chains), and the chain waits for the slab right
//    of its window, so bs is chosen from n and the dtype (eig_block in
//    ops/qr_kernels.py) to keep the workers within the chain's pace.
// No out-of-range row or column is ever read: every loop is bounded by n.
//
// Plain C interface for ctypes: each entry point selects the device,
// launches on the caller's stream and returns the first CUDA error (0 on
// success), checked after every launch.

#include "eig_common.cuh"

namespace {

constexpr int kPanelThreads = 1024;         // B9: the one block of a panel
constexpr int kFactorThreads = 1024;        // B9: T (a warp a row), Y and Z
constexpr int kMaxQRPanel = 64;             // B9: largest panel width
constexpr int kPanelSmem = 220 * 1024;      // B9: dynamic shared memory of a panel (227 KB
                                            // a block, less the static part)
constexpr int kSplitScratch = 32;           // B9: split-K partials, in nb n scalars
constexpr int kSplitDepth = 32;             // B9: the least depth of a split-K slice

// ---- B9: blocked compact-WY Householder QR ---------------------------------

// The reflector of column x (pivot at local row j, below it tail2 =
// sum |x_i|^2) with the rule of the Pallas kernel (qr_kernels.py:97-130): the
// phase sign x0/|x0| (1 when x0 = 0), factor 2, or 0 for the tail-zero and
// degenerate skips (the column is zero below the pivot, or ||v|| = 0); stores
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
// column by column with panel_reflector's rule at pivot row k = k0 + j
// (panel_reflector; v of unit norm and zero above the pivot), each
// reflector applied at once to the panel's later columns. The panel is held
// column-major (ld m) in dynamic shared memory when it fits (`in_smem`),
// else in the global scratch Pg, read and written through L2. Writes the
// panel's R columns (exact zeros below the diagonal), rows k0: of the
// panel's columns of V (n x n, zeros above each pivot) and the factors f_j
// (tau, as scalars of T's type). T, Y = V T and Z = V T^H are formed by
// wy_factor_kernel from the Gram matrix G = V^H V.
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
qr_panel_kernel(T* __restrict__ Rm, T* __restrict__ V, T* __restrict__ tau, T* __restrict__ Pg,
                int64_t n, int64_t k0, int jn, int in_smem) {
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
// memory.
template <typename T>
__global__ void __launch_bounds__(kFactorThreads)
wy_factor_kernel(const T* __restrict__ V, const T* __restrict__ G, const T* __restrict__ tau,
                 T* __restrict__ Y, T* __restrict__ Z, int64_t n, int64_t m, int jn) {
  using O = Ops<T>;
  extern __shared__ __align__(16) unsigned char factor_smem[];
  const int ld = jn + 1;
  T* Ts = reinterpret_cast<T*>(factor_smem);  // jn x ld
  T* Gs = Ts + jn * ld;                        // jn x ld
  T* Vs = Gs + jn * ld;                        // 64 x ld: rows i0 .. i0 + 63 of V
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nwarps = blockDim.x >> 5;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * 64;
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

// W = A^H B for A (K x M, lda) and B (K x N, ldb), M <= 64: the deep,
// narrow products of the WY updates (M = jn columns, K = n - k0 rows). A
// tile is kRows (16, 32 or 64, the least that holds M) rows by kBN
// columns, so that a panel of 16 or 32 columns computes no rows it does not
// need; K is cut into slices of kSplitDepth or deeper (at most `capacity` /
// (M N) of them), and slice blockIdx.y writes its own M x N partial to
// P + y M N, which sum_slices_kernel (eig_common.cuh) adds in slice order.
// No atomics: the same shapes give the same bits. 16-deep shared-memory
// tiles, a (kRows / 16) x 4 register block per thread, full FMA in the
// working precision.
template <typename T, int kRows>
__global__ void __launch_bounds__(kGemmThreads)
wy_slices_kernel(int64_t K, int M, int64_t N, int64_t kdepth, const T* __restrict__ A,
                 int64_t lda, const T* __restrict__ B, int64_t ldb, T* __restrict__ P) {
  using O = Ops<T>;
  constexpr int kRowsPerThread = kRows / 16;
  __shared__ T As[kBK][kRows + 1];
  __shared__ T Bs[kBK][kBN + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBN;
  const int64_t k_lo = static_cast<int64_t>(blockIdx.y) * kdepth;
  const int64_t k_hi = k_lo + kdepth < K ? k_lo + kdepth : K;
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
  T* __restrict__ part = P + static_cast<int64_t>(blockIdx.y) * M * N;
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = ty + 16 * r;
    if (i >= M) continue;
    for (int c = 0; c < 4; ++c) {
      const int64_t j = col0 + tx + 16 * c;
      if (j < N) part[i * N + j] = acc[r][c];
    }
  }
}

// wy_slices_kernel, then the slices' sum into W: two launches (none when M
// or N is 0). P holds `capacity` >= M N scalars.
template <typename T>
int wy_product(int64_t K, int M, int64_t N, const T* A, int64_t lda, const T* B, int64_t ldb,
               T* W, int64_t ldw, T* P, int64_t capacity, cudaStream_t st) {
  if (M <= 0 || N <= 0) return 0;
  int64_t slices = K / kSplitDepth;
  if (slices > capacity / (M * N)) slices = capacity / (M * N);
  if (slices < 1) slices = 1;
  int64_t kdepth = (K + slices - 1) / slices;
  kdepth = kdepth < kBK ? kBK : (kdepth + kBK - 1) / kBK * kBK;
  slices = K > 0 ? (K + kdepth - 1) / kdepth : 1;
  const dim3 grid(blocks_for(N, kBN), static_cast<unsigned>(slices));
  if (M <= 16)
    wy_slices_kernel<T, 16><<<grid, kGemmThreads, 0, st>>>(K, M, N, kdepth, A, lda, B, ldb, P);
  else if (M <= 32)
    wy_slices_kernel<T, 32><<<grid, kGemmThreads, 0, st>>>(K, M, N, kdepth, A, lda, B, ldb, P);
  else
    wy_slices_kernel<T, 64><<<grid, kGemmThreads, 0, st>>>(K, M, N, kdepth, A, lda, B, ldb, P);
  if (int rc = last_error()) return rc;
  sum_slices_kernel<T><<<blocks_for(M * N, kThreads), kThreads, 0, st>>>(
      M, N, static_cast<int>(slices), P, W, ldw, typename Ops<T>::Real(1), 0);
  return last_error();
}

// B9 by panels of nb columns: each panel factored by qr_panel_kernel; its
// Gram matrix G = V^H V (wy_product) gives T, Y = V T and Z = V T^H
// (wy_factor_kernel); the trailing columns are updated as
// R[k0:, k0+jn:] -= V (Y^H R[k0:, k0+jn:]) (each H_j is Hermitian, so the
// panel's H_{jn-1} ... H_0 is I - V T^H V^H), and, after the last panel,
// Q = H_0 ... H_{kmax-1} is accumulated backward in LAPACK orgqr order:
// Q = I, then for each panel from the last, Q[k0:, k0:] -= V (Z^H Q[k0:, k0:]).
// Each update is one split-K product (wy_product: two launches) and one
// tiled GEMM. scratch holds V, Y and Z (n x n each), W (nb x n), one nb x n
// product per panel for Q, an n x nb panel for the case where it does not
// fit in shared memory, G and tau, and kSplitScratch nb n scalars of split-K
// partials. Every sum runs in a fixed order: R and Q repeat bit for bit.
// *launches counts the kernels.
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
  T* P = tau + nb;
  const int64_t capacity = kSplitScratch * nb * n;
  if (int rc = allow_dynamic_smem<qr_panel_kernel<T>>(kPanelSmem)) return rc;
  if (int rc = allow_dynamic_smem<wy_factor_kernel<T>>(
          (2 * kMaxQRPanel + 64) * (kMaxQRPanel + 1) * static_cast<int>(sizeof(T))))
    return rc;
  auto counted = [&](int rc, int launched) {
    *launches += launched;
    return rc;
  };
  for (int64_t p = 0; p < panels; ++p) {
    const int64_t k0 = p * nb, m = n - k0, off = k0 * n + k0;
    const int jn = static_cast<int>(kmax - k0 < nb ? kmax - k0 : nb);
    const int64_t n2 = m - jn;
    const int64_t whole = m * jn * static_cast<int64_t>(sizeof(T));
    const bool fits = whole <= kPanelSmem;
    qr_panel_kernel<T><<<1, kPanelThreads, fits ? static_cast<int>(whole) : 0, st>>>(
        r, V, tau, Pg, n, k0, jn, fits);
    int rc = 0;
    if ((rc = counted(last_error(), 1)) ||
        (rc = counted(wy_product<T>(m, jn, jn, V + off, n, V + off, n, G, jn, P, capacity, st),
                      2)))
      return rc;
    const int factor_smem = (2 * jn + 64) * (jn + 1) * static_cast<int>(sizeof(T));
    wy_factor_kernel<T><<<blocks_for(m, 64), kFactorThreads, factor_smem, st>>>(
        V + off, G, tau, Y + off, Z + off, n, m, jn);
    if ((rc = counted(last_error(), 1)) ||
        (rc = counted(wy_product<T>(m, jn, n2, Y + off, n, r + off + jn, n, W, n, P, capacity,
                                    st), n2 > 0 ? 2 : 0)) ||
        (rc = counted(gemm<T>(m, n2, jn, V + off, n, kN, W, n, kN, r + off + jn, n, -1.0, true,
                              st), n2 > 0 ? 1 : 0)))
      return rc;
  }
  for (int64_t p = panels - 1; p >= 0; --p) {
    const int64_t k0 = p * nb, m = n - k0, off = k0 * n + k0;
    const int jn = static_cast<int>(kmax - k0 < nb ? kmax - k0 : nb);
    T* Wp = Wq + p * nb * n;
    int rc = 0;
    if ((rc = counted(wy_product<T>(m, jn, m, Z + off, n, q + off, n, Wp, n, P, capacity, st),
                      2)) ||
        (rc = counted(gemm<T>(m, m, jn, V + off, n, kN, Wp, n, kN, q + off, n, -1.0, true, st),
                      1)))
      return rc;
  }
  return 0;
}

// ---- B8 -------------------------------------------------------------------

constexpr int kEigThreads = 512;              // 16 warps: the chain and 15 workers
constexpr int kEigWarps = kEigThreads / 32;
constexpr int kEigRing = 4;                   // slots of U_i and its side row
constexpr int kEigMaxBlock = 16;              // eig_block's largest (ops/qr_kernels.py)
constexpr int kEigTile = 32;                  // slab columns, right-pass rows a task
constexpr int kIlp = 4;                       // outputs a worker lane forms at once
constexpr int kEigSmemBudget = 227 * 1024 - 1024;  // dynamic shared memory, at most

// Where B8's parts live in its dynamic shared memory (offsets in bytes), and
// how its 15 worker warps split: slab warps 1 .. nslab, right passes on H
// nslab + 1 .. nslab + nright, on Q the last nq. ops/qr_kernels.py::
// eig_layout reckons it and hands it to the entry point, which checks its
// order and size.
struct EigLayout {
  int ld;       // H's row stride
  int us, sst;  // U's row stride (bs + 1), a staged row tile's ((bs + 1) | 1)
  int nslab, nright, nq;
  int staged0;  // the first worker warp whose right passes are staged (those after it too)
  int64_t off_ring, off_lrow, off_win, off_stage, off_ints, bytes;
};

__device__ __forceinline__ unsigned ld_acquire_cta(const unsigned* p) {
  unsigned v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(unsigned* p, unsigned v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(a), "r"(v) : "memory");
}

// The calling warp goes on once *p >= target (lane 0 spins).
__device__ __forceinline__ void warp_wait(const unsigned* p, unsigned target) {
  if ((threadIdx.x & 31) == 0)
    while (ld_acquire_cta(p) < target) {
    }
  __syncwarp();
}

// *p = v once the calling warp's writes before the call are visible to the
// block.
__device__ __forceinline__ void warp_publish(unsigned* p, unsigned v) {
  __threadfence_block();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) st_release_cta(p, v);
}

// What every warp of the sweep reads.
template <typename T>
struct EigSweep {
  T* H;             // shared memory, or the output in global memory
  T* Q;             // null: eigenvalues only
  T* ring;          // kEigRing slots: U_i (us x us), then block i's side row (bs)
  T* lrow;          // U_i's last row
  T* win;           // H in global memory only: the chain's two windows, then X
  T* stage;         // the staged workers' row tiles, kEigTile x sst each
  unsigned* chain;      // blocks whose U_i is published
  unsigned* progress;   // per warp: blocks finished
  unsigned* tile_done;  // per column tile: slabs done
  int n, bs, col_end;
  EigLayout L;
  __device__ T* slot(int i) const { return ring + (i % kEigRing) * (L.us * L.us + bs); }
};

// Warp 0: the chain of one sweep (B13's chain<> in one warp; see the header).
// With H on chip each window is rotated in place. With H in global memory
// window i lives in win[i & 1]: its rows below the first, and rows b + 1 ..
// e over the look-ahead columns (X), are fetched by cp.async while window
// i - 1 rotates; its first row is window i - 1's last row over its last two
// columns and the look-ahead, which the chain computes itself.
template <typename T, bool kHSmem>
__device__ __forceinline__ void eig_chain(const EigSweep<T>& a, const Blocks& B) {
  using O = Ops<T>;
  const int lane = threadIdx.x, ld = a.L.ld, us = a.L.us, bs = a.bs, ws = bs + 2;
  T* H = a.H;
  T* Wb[2] = {a.win, a.win + us * ws};
  T* X = a.win + 2 * us * ws;  // us x bs
  if (!kHSmem && B.count > 0) {  // window 0 as it stands
    const int b = B.b(0), e = B.e(0), c0 = b > 0 ? b - 1 : 0, m = e - b + 1, wc = e - c0 + 1;
    for (int k = lane; k < m * wc; k += 32)
      cp_async_elem<sizeof(T)>(&Wb[0][(k / wc) * ws + k % wc],
                               &H[static_cast<int64_t>(b + k / wc) * ld + c0 + k % wc], true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
  }
  for (int i = 0; i < B.count; ++i) {
    const int b = B.b(i), e = B.e(i), c0 = b > 0 ? b - 1 : 0;
    const int m = e - b + 1, wc = e - c0 + 1;
    const bool ahead = i + 1 < B.count;
    const int e2 = ahead ? B.e(i + 1) : e, la = e2 - e;  // look-ahead columns e + 1 .. e2
    T* U = a.slot(i);
    if (i >= kEigRing) {  // the slot's last block, i - kEigRing, done on every worker
      for (int w = 1 + lane; w < kEigWarps; w += 32)
        while (ld_acquire_cta(&a.progress[w]) < static_cast<unsigned>(i - kEigRing + 1)) {
        }
      __syncwarp();
    }
    T* W = kHSmem ? H + b * ld + c0 : Wb[i & 1];
    T* Wn = Wb[(i + 1) & 1];
    if (!kHSmem && ahead) {  // window i + 1's rows e + 1 .. e2; rows b + 1 .. e over e + 1 .. e2
      const int c2 = e - 1, wc2 = la + 2;
      for (int k = lane; k < la * wc2; k += 32)
        cp_async_elem<sizeof(T)>(&Wn[(1 + k / wc2) * ws + k % wc2],
                                 &H[static_cast<int64_t>(e + 1 + k / wc2) * ld + c2 + k % wc2],
                                 true);
      for (int k = lane; k < (m - 1) * la; k += 32)
        cp_async_elem<sizeof(T)>(&X[(1 + k / la) * bs + k % la],
                                 &H[static_cast<int64_t>(b + 1 + k / la) * ld + e + 1 + k % la],
                                 true);
      cp_async_commit();
    }
    rotate_window<T, 1>(W, kHSmem ? ld : ws, m, wc, b - c0, U, a.lrow, us);
    __syncwarp();
    if (!kHSmem)
      for (int k = lane; k < m * wc; k += 32)
        H[static_cast<int64_t>(b + k / wc) * ld + c0 + k % wc] = W[(k / wc) * ws + k % wc];
    if (ahead) {  // the look-ahead of window i + 1: row e over e + 1 .. e2
      if (i > 0) {  // row b there is slab i - 1's output
        for (int tile = (e + 1) / kEigTile + lane; tile <= e2 / kEigTile; tile += 32)
          while (ld_acquire_cta(&a.tile_done[tile]) < static_cast<unsigned>(i)) {
          }
      }
      if (!kHSmem) cp_async_wait<0>();
      __syncwarp();
      if (lane < la) {
        const int64_t c = e + 1 + lane;
        T acc = O::madd(O::zero(), a.lrow[0], H[b * ld + c]);
        for (int r = 1; r < m; ++r)
          acc = O::madd(acc, a.lrow[r], kHSmem ? H[(b + r) * ld + c] : X[r * bs + lane]);
        U[us * us + lane] = kHSmem ? H[e * ld + c] : X[(m - 1) * bs + lane];  // slab i's side row
        H[e * ld + c] = acc;
        if (!kHSmem) Wn[2 + lane] = acc;
      }
      if (!kHSmem && lane < 2) Wn[lane] = W[(m - 1) * ws + wc - 2 + lane];  // row e over e - 1, e
    }
    warp_publish(a.chain, i + 1);
  }
}

// Slab warps: U_j times rows b_j .. e_j over the warp's column tiles beyond
// e_j (below col_end), a lane a column, kIlp rows at a time; the look-ahead
// entries (row e_j over e_j + 1 .. e_{j+1}) are the chain's: there row e_j
// is read from the side row and not written.
template <typename T, int kM>
__device__ __forceinline__ void eig_slabs(const EigSweep<T>& a, const Blocks& B, int w, int nw) {
  using O = Ops<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, ld = a.L.ld, us = a.L.us;
  const int tiles = tiles_of(a.col_end, kEigTile);
  T* H = a.H;
  for (int j = 0; j < B.count; ++j) {
    const int b = B.b(j), e = B.e(j), m = e - b + 1;
    const int la_end = j + 1 < B.count ? B.e(j + 1) : e;
    const T* U = a.slot(j);
    const T* side = U + us * us;
    bool ready = false;
    for (int tile = w; tile < tiles; tile += nw) {
      const int c1 = tile * kEigTile > e + 1 ? tile * kEigTile : e + 1;
      const int c2 = (tile + 1) * kEigTile < a.col_end ? (tile + 1) * kEigTile : a.col_end;
      if (c1 < c2) {
        if (!ready) {
          warp_wait(a.chain, j + 1);
          ready = true;
        }
        const int64_t col = c1 + lane;
        if (col < c2) {
          const bool ahead = col <= la_end;
          T x[kM];
#pragma unroll
          for (int r = 0; r < kM; ++r)
            if (r < m) x[r] = r == m - 1 && ahead ? side[col - e - 1] : H[(b + r) * ld + col];
          const int rows = m - (ahead ? 1 : 0);
          for (int r = 0; r < rows; r += kIlp) {
            T acc[kIlp];
            int rr[kIlp];
#pragma unroll
            for (int p = 0; p < kIlp; ++p) {
              acc[p] = O::zero();
              rr[p] = r + p < rows ? r + p : r;
            }
#pragma unroll
            for (int c = 0; c < kM; ++c)
              if (c < m) {
#pragma unroll
                for (int p = 0; p < kIlp; ++p) acc[p] = O::madd(acc[p], U[rr[p] * us + c], x[c]);
              }
#pragma unroll
            for (int p = 0; p < kIlp; ++p) H[(b + rr[p]) * ld + col] = acc[p];
          }
        }
      }
      warp_publish(&a.tile_done[tile], j + 1);
    }
    warp_publish(&a.progress[warp], j + 1);
  }
}

// Right-pass warps (worker index k) on M (H: rows 0 .. e_j + 1; Q: all
// rows) times columns b_j .. e_j := . U_j^H, on the warp's row tiles, a lane
// a row, kIlp columns at a time. kStaged: M lies in global memory, and a
// tile goes through the warp's slice of shared memory, so that its loads
// and stores run along rows.
template <typename T, int kM, bool kStaged>
__device__ __forceinline__ void eig_rights(const EigSweep<T>& a, const Blocks& B, T* M, bool on_h,
                                           int k, int w, int nw) {
  using O = Ops<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, us = a.L.us, sst = a.L.sst;
  const int64_t ld = on_h ? a.L.ld : a.n;
  T* S = kStaged ? a.stage + (k - (a.L.staged0 - 1)) * kEigTile * sst : nullptr;
  for (int j = 0; j < B.count; ++j) {
    const int b = B.b(j), e = B.e(j), m = e - b + 1;
    const int row_end = on_h ? (e + 2 < a.n ? e + 2 : a.n) : a.n;
    const int tiles = tiles_of(row_end, kEigTile);
    if (w < tiles) {
      warp_wait(a.chain, on_h ? B.reach(j) + 1 : j + 1);
      if (on_h && j > 0) {  // slab j - 1 on the columns b_j .. e_j
        for (int tile = b / kEigTile + lane; tile <= e / kEigTile; tile += 32)
          while (ld_acquire_cta(&a.tile_done[tile]) < static_cast<unsigned>(j)) {
          }
        __syncwarp();
      }
      const T* U = a.slot(j);
      for (int tile = w; tile < tiles; tile += nw) {
        const int r0 = tile * kEigTile;
        const int rows = row_end - r0 < kEigTile ? row_end - r0 : kEigTile;
        if (kStaged) {
          for (int q = lane; q < rows * m; q += 32)
            S[(q / m) * sst + q % m] = M[(r0 + q / m) * ld + b + q % m];
          __syncwarp();
        }
        if (lane < rows) {
          T* row = kStaged ? S + lane * sst : M + (r0 + lane) * ld + b;
          T x[kM];
#pragma unroll
          for (int c = 0; c < kM; ++c)
            if (c < m) x[c] = row[c];
          for (int c2 = 0; c2 < m; c2 += kIlp) {
            T acc[kIlp];
            int cc[kIlp];
#pragma unroll
            for (int p = 0; p < kIlp; ++p) {
              acc[p] = O::zero();
              cc[p] = c2 + p < m ? c2 + p : c2;
            }
#pragma unroll
            for (int c = 0; c < kM; ++c)
              if (c < m) {
#pragma unroll
                for (int p = 0; p < kIlp; ++p)
                  acc[p] = O::madd(acc[p], x[c], O::conj(U[cc[p] * us + c]));
              }
#pragma unroll
            for (int p = 0; p < kIlp; ++p) row[cc[p]] = acc[p];
          }
        }
        if (kStaged) {
          __syncwarp();
          for (int q = lane; q < rows * m; q += 32)
            M[(r0 + q / m) * ld + b + q % m] = S[(q / m) * sst + q % m];
          __syncwarp();
        }
      }
    }
    warp_publish(&a.progress[warp], j + 1);
  }
}

// The whole shifted Givens QR iteration on the complex Hessenberg h_in (n x
// n) in one block: H in shared memory (kHSmem) or in h; Q (optional) from I.
// Writes h = T, eig = diag(T) and state = {sweeps, hi}.
template <typename T, int kM, bool kHSmem>
__global__ void __launch_bounds__(kEigThreads, 1)
qr_eig_kernel(const T* __restrict__ h_in, T* __restrict__ h, T* __restrict__ Q,
              T* __restrict__ eig, int* __restrict__ state, int n, int max_sweeps,
              typename Ops<T>::Real tol, int bs, const EigLayout L) {
  using O = Ops<T>;
  extern __shared__ __align__(16) unsigned char eig_smem[];
  __shared__ int sh[2];
  __shared__ T s_mu;
  EigSweep<T> a;
  a.H = kHSmem ? reinterpret_cast<T*>(eig_smem) : h;
  a.Q = Q;
  a.ring = reinterpret_cast<T*>(eig_smem + L.off_ring);
  a.lrow = reinterpret_cast<T*>(eig_smem + L.off_lrow);
  a.win = reinterpret_cast<T*>(eig_smem + L.off_win);
  a.stage = reinterpret_cast<T*>(eig_smem + L.off_stage);
  a.chain = reinterpret_cast<unsigned*>(eig_smem + L.off_ints);
  a.progress = a.chain + 1;
  a.tile_done = a.progress + kEigWarps;
  a.n = n;
  a.bs = bs;
  a.L = L;
  const int t = threadIdx.x, nt = blockDim.x, warp = t >> 5, ld = L.ld;
  const int counters = 1 + kEigWarps + tiles_of(n, kEigTile);
  T* H = a.H;
  for (int64_t k = t; k < static_cast<int64_t>(n) * n; k += nt) {
    const int64_t i = k / n, j = k - i * n;
    H[i * ld + j] = h_in[k];
    if (Q != nullptr) Q[k] = i == j ? O::one() : O::zero();
  }
  for (int k = t; k < counters; k += nt) a.chain[k] = 0;
  __syncthreads();
  deflate_and_lo(H, ld, n, tol, sh);
  int hi = sh[0] + 2, lo = sh[1] + 1, sweeps = 0;
  while (hi > 1 && sweeps < max_sweeps) {
    if (t == 0) s_mu = wilkinson_shift(H, ld, hi);
    __syncthreads();
    const T mu = s_mu;
    for (int i = lo + t; i < hi; i += nt) H[i * ld + i] = O::sub(H[i * ld + i], mu);
    __syncthreads();
    const Blocks B{lo, hi, bs, (hi - 1 - lo + bs - 1) / bs};
    a.col_end = Q != nullptr ? n : hi;
    const int k = warp - 1;  // the worker index
    if (warp == 0)
      eig_chain<T, kHSmem>(a, B);
    else if (k < L.nslab)
      eig_slabs<T, kM>(a, B, k, L.nslab);
    else if (k < L.nslab + L.nright)
      eig_rights<T, kM, !kHSmem>(a, B, H, true, k, k - L.nslab, L.nright);
    else
      eig_rights<T, kM, true>(a, B, Q, false, k, k - L.nslab - L.nright, L.nq);
    __syncthreads();
    for (int i = lo + t; i < hi; i += nt) H[i * ld + i] = O::add(H[i * ld + i], mu);
    for (int k = t; k < counters; k += nt) a.chain[k] = 0;
    __syncthreads();
    deflate_and_lo(H, ld, hi, tol, sh);
    hi = sh[0] + 2;
    lo = sh[1] + 1;
    ++sweeps;
  }
  for (int i = t; i < n; i += nt) eig[i] = H[static_cast<int64_t>(i) * ld + i];
  if (kHSmem)
    for (int64_t k = t; k < static_cast<int64_t>(n) * n; k += nt) h[k] = H[(k / n) * ld + k % n];
  if (t == 0) {
    state[0] = sweeps;
    state[1] = hi;
  }
}

template <typename T, int kM, bool kHSmem>
int launch_eig(const T* h_in, T* h, T* q, T* eig, int* state, int n, int max_sweeps, double tol,
               int bs, const EigLayout& L, cudaStream_t st) {
  if (int rc = allow_dynamic_smem<qr_eig_kernel<T, kM, kHSmem>>(kEigSmemBudget)) return rc;
  qr_eig_kernel<T, kM, kHSmem><<<1, kEigThreads, static_cast<int>(L.bytes), st>>>(
      h_in, h, q, eig, state, n, max_sweeps, static_cast<typename Ops<T>::Real>(tol), bs, L);
  return last_error();
}

// A worker lane holds one column (row) of the block, bs + 1 entries, in
// registers: kM of 9 or 17.
template <typename T>
int run_eig(const T* h_in, T* h, T* q, T* eig, int* state, int64_t n, int max_sweeps,
            double tol, int bs, int h_smem, const long long* layout, cudaStream_t st) {
  for (int k = 0; k < 7; ++k)
    if (layout[k] < 0 || layout[k] >= (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const EigLayout L{static_cast<int>(layout[0]), static_cast<int>(layout[1]),
                    static_cast<int>(layout[2]), static_cast<int>(layout[3]),
                    static_cast<int>(layout[4]), static_cast<int>(layout[5]),
                    static_cast<int>(layout[6]), layout[7], layout[8], layout[9], layout[10],
                    layout[11], layout[12]};
  const bool ordered = 0 <= L.off_ring && L.off_ring <= L.off_lrow && L.off_lrow <= L.off_win &&
                       L.off_win <= L.off_stage && L.off_stage <= L.off_ints &&
                       L.off_ints < L.bytes && L.bytes <= kEigSmemBudget;
  const bool split = L.nslab >= 1 && L.nright >= 1 && (L.nq > 0) == (q != nullptr) &&
                     L.nslab + L.nright + L.nq == kEigWarps - 1 && L.staged0 >= 1 &&
                     L.staged0 <= kEigWarps;
  if (!ordered || !split || L.us != bs + 1 || L.sst < L.us || L.ld < n || n >= (1 << 30) ||
      (h_smem != 0 && L.off_ring < n * L.ld * static_cast<int64_t>(sizeof(T))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ni = static_cast<int>(n);
#define EIG_ARGS h_in, h, q, eig, state, ni, max_sweeps, tol, bs, L, st
  if (h_smem) return bs < 9 ? launch_eig<T, 9, true>(EIG_ARGS) : launch_eig<T, 17, true>(EIG_ARGS);
  return bs < 9 ? launch_eig<T, 9, false>(EIG_ARGS) : launch_eig<T, 17, false>(EIG_ARGS);
#undef EIG_ARGS
}

}  // namespace

extern "C" {

// B9: a = q r after kmax Householder column steps, by panels of nb <= 64
// columns. scratch holds 3 n^2 + (ceil(kmax / nb) + 2) nb n + nb^2 + nb
// + 32 nb n scalars; *launches (host) receives the number of kernels enqueued.
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
// One launch of one block, with rotations in blocks of bs <= 16; H in shared
// memory when h_smem; layout (host, 13 values in EigLayout's order) is the
// block's dynamic shared memory as ops/qr_kernels.py::eig_layout reckons it.
int qr_eig_givens(int dtype, int device, const void* h_in, void* h, void* q, void* eig,
                  void* state, long long n, int max_sweeps, double tol, int bs, int h_smem,
                  const long long* layout, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (bs < 1 || bs > kEigMaxBlock) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QR_ARGS(T) static_cast<const T*>(h_in), static_cast<T*>(h), static_cast<T*>(q), \
                   static_cast<T*>(eig), static_cast<int*>(state), n, max_sweeps, tol, bs, \
                   h_smem, layout, s
  switch (dtype) {
    case kC64: return run_eig<float2>(QR_ARGS(float2));
    case kC128: return run_eig<double2>(QR_ARGS(double2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QR_ARGS
}

}  // extern "C"
