// Blocked (compact-WY) Householder Hessenberg reduction for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/hessenberg_blocked.py:
//   B11 _hess_blocked_kernel (:97) and the phase-split _hess_panelA_kernel
//       (:667), _hess_panelB_kernel (:1177), _hess_panelC_kernel (:1363)
//       -> hessenberg_blocked on float and double;
//   B12 _hess_panelA_emb_kernel (:963), complex reflectors on the 2n x 2n
//       real embedding -> the same code on float2 and double2. The embedding
//       exists only because the TPU compiler faults on the two-plane kernels
//       at np_ >= 1152; native complex arithmetic does its job here.
//
// Per panel of nb columns starting at k0, with A0 the matrix at the panel's
// start (the order and tau convention of _hess_blocked_kernel):
//  A. for each column j (k = k0 + j, pivot row s = k + 1; V is zero above
//     v0 = k0 + 1; l < j runs over the panel's earlier columns), three
//     launches over the whole grid rebuild the column as the panel's earlier
//     reflectors left it,
//       c = (I - V T^H V^H)(A0 - Z T V^H) e_k,
//     form the reflector v with B7's rules (phase sign x0/|x0|, tau = 0 for
//     the tail-zero and degenerate skips, and then v = 0) and grow the
//     compact-WY factor: V[:, j] = v, Z[:, j] = A0 v, T[:j, j] = -tau T V^H v,
//     T[j, j] = tau:
//       col_update_kernel   c = A0 e_k - Z t1 with t1 = T V^H e_k, and the
//                           tile partials of u = V^H c (rows >= v0);
//       col_reflect_kernel  c -= V t2 with t2 = T^H u (rows >= v0), and the
//                           tile partials of ||c[s:]||^2, ||c[s+1:]||^2 and
//                           w = V[s+1:]^H c[s+1:];
//       col_finish_kernel   the reflector's scalars (vs = x0 + sign ||x||,
//                           tau, vinv = 1 / ||v||), z = vinv A0 x where x is
//                           c with vs at s and zeros above it, v = vinv x,
//                           and (block 0) m = V^H v = vinv (w + conj(V[s]) vs)
//                           and T's column.
//     Blocks of the first two cover tiles of rows and pass partial sums to
//     the next launch through scratch; every block sums the partials itself,
//     in one fixed order, so every block holds the same scalars bit for bit.
//     No atomics: the result is the same from call to call. V and Z are
//     stored transposed (nb x n, a column of V or Z is a contiguous row).
//  B. the trailing update A := (I - V T^H V^H)(A0 - Z T V^H) as tiled GEMMs:
//     P = V^H A0 and G = V^H Y (split-K), Y = Z T, G2 = T^H G, W = T^H P -
//     G2 V^H, A -= Y V^H, A -= V W; then the panel's columns are set to
//     exact zeros below the subdiagonal (the reference's eliminated entries
//     are zeros).
//  C. with Q: Q -= (Q V) T V^H as three GEMMs, Q V by split-K.
//
// What bounds it on this card, and what the design does about it:
//  * Phase A reads the trailing part of A0 once per column (the GEMV in
//    col_finish_kernel, a warp per row): about n^3 / 2 elements over the
//    reduction, 2 n^3 bytes in float, which does not fit in the 50 MB L2
//    beyond n ~ 3500 (float): memory-bound. The rest of a column step reads
//    V and Z (j x n each) and is latency-bound: its sums run over all rows,
//    so they are cut into row tiles over the grid (col_rows: 8-32 rows a
//    block, ~128 blocks from n = 1024 on) rather than run in one block, and
//    the chain is three dependent launches a column. Each kernel issues the
//    loads that wait for nothing first and sums its partials with unrolled
//    loads, so that a launch costs about one or two trips to L2, and each
//    starts while the one before it finishes (programmatic dependent
//    launch; wait_previous() orders the rest), which hides the gap between
//    two launches.
//  * Phase B is ~10/3 n^3 flops in all (real; four times that in complex) as
//    the tiled GEMM of eig_common.cuh (gemm_op_kernel, shared with B9's
//    blocked QR): 64 x 64 output tiles, 16-deep shared-memory tiles, a 4 x 4
//    register block per thread, full FMA in the working precision (no tensor
//    cores, so no TF32). Each operand is read as stored (N), transposed (T),
//    conjugate-transposed (C) or conjugated (J), so no transpose is ever
//    formed.
//    Three of the panel's products are deep and narrow: P = V^H A0 (nb
//    rows, depth n - k0), G = V^H Y (nb x nb) and, with Q, Q V (nb
//    columns). On gemm's grid they leave most SMs idle, each block walking
//    the whole depth; they run as gemm_split (eig_common.cuh): depth
//    slices, each to its own partial, summed in slice order by a second
//    kernel, so that they fill the card and give the same bits every call.
//  * Launches: 3 per column and 11 per panel (15 with Q), 3 (n - 2) +
//    ~11 n / nb in all; the entry point returns the count.
// The TPU's slab windows, 128-lane padding, the monolithic versus
// phase-split choice and the chunking are VMEM workarounds and have no
// counterpart. No row or column outside [0, n) is ever read.
//
// Plain C interface for ctypes: the entry point selects the device, launches
// on the caller's stream and returns the first CUDA error (0 on success),
// checked after every launch.

#include <utility>

#include "eig_common.cuh"

namespace {

constexpr int kMaxPanel = 64;             // largest panel width nb
constexpr int kColThreads = 256;          // every column-step kernel
constexpr int kGemvRows = kColThreads / 32;  // col_finish: a warp per row
constexpr int kColBlocks = 132;           // one block per SM of the H100
constexpr int kMaxIter = kMaxPanel / (kColThreads / 32);  // columns l per thread (G >= 8)
constexpr int kLanes = 8;                 // lanes per output in the panel sums
constexpr int kTriRounds = kMaxPanel / (kColThreads / kLanes);  // outputs per lane group
constexpr int kTriTerms = kMaxPanel / kLanes;                   // terms per lane

// Programmatic dependent launch (Hopper): each column-step kernel but the
// panel's first is launched to start while the one before it finishes. It
// loads what that kernel does not write, then waits for it (all its
// writes visible) before it reads or writes anything that kernel touches;
// once past the wait, it lets the next kernel start. Without the launch
// attribute both are no-ops.
__device__ __forceinline__ void wait_previous() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void start_next() { asm volatile("griddepcontrol.launch_dependents;"); }

// Rows per tile of col_update and col_reflect: 8, 16 or 32, the fewest
// that keep the grid within kColBlocks blocks (n <= 4224), so that the
// partial sums every block adds up stay few (~128 per column l).
inline int col_rows(int64_t n) {
  int rows = 8;
  while (rows < 32 && blocks_for(n, rows) > kColBlocks) rows *= 2;
  return rows;
}

// Sum over the `lanes` lanes of a thread's group (lanes divides 32; a
// group's lanes are contiguous), the same value in each of them. Call with
// every lane of the warp.
template <typename T>
__device__ __forceinline__ T group_sum(T v, int lanes) {
  using O = Ops<T>;
  for (int m = lanes >> 1; m > 0; m >>= 1) v = O::add(v, O::shfl_xor(v, m));
  return v;
}

// out[l] = sum_b P[l * B + b] over b < B for l < count, in a fixed order
// (the same bits in every block): a group of kLanes lanes per l, lane q
// adding b = q, q + kLanes, ... (its loads unrolled, so they are in flight
// together), then a butterfly over the group. Call with the whole block.
template <typename T>
__device__ __forceinline__ void sum_partials(const T* __restrict__ P, int B, int count,
                                             T* out) {
  using O = Ops<T>;
  const int q = threadIdx.x % kLanes;
  for (int l0 = 0; l0 < count; l0 += kColThreads / kLanes) {
    const int l = l0 + threadIdx.x / kLanes;
    T acc = O::zero();
    if (l < count) {
      const T* __restrict__ p = P + static_cast<int64_t>(l) * B;
#pragma unroll 16
      for (int b = q; b < B; b += kLanes) acc = O::add(acc, p[b]);
    }
    acc = group_sum(acc, kLanes);
    if (l < count && q == 0) out[l] = acc;
  }
}

// The entries of the panel's T (j x j, upper triangular) that the lane
// group of l = t / kLanes + 32 p needs for a product with T (upper: row l,
// m >= l) or T^H (column l, m <= l); lane q holds m = q + kLanes e. Loaded
// ahead of use, so that their latency overlaps the other loads.
template <bool kUpper, typename T>
__device__ __forceinline__ void load_tri(const T* __restrict__ Tf, int nb, int j,
                                         T (&tr)[kTriRounds][kTriTerms]) {
  using O = Ops<T>;
  const int q = threadIdx.x % kLanes, g = threadIdx.x / kLanes;
#pragma unroll
  for (int p = 0; p < kTriRounds; ++p)
#pragma unroll
    for (int e = 0; e < kTriTerms; ++e) {
      const int l = g + p * (kColThreads / kLanes), m = q + e * kLanes;
      const bool on = l < j && m < j && (kUpper ? m >= l : m <= l);
      tr[p][e] = on ? (kUpper ? Tf[l * nb + m] : O::conj(Tf[m * nb + l])) : O::zero();
    }
}

// out[l] = sum_m tr(l, m) x[m] for l < j (x in shared memory), in a fixed
// order. Call with the whole block.
template <bool kUpper, typename T>
__device__ __forceinline__ void apply_tri(T (&tr)[kTriRounds][kTriTerms], int j,
                                          const T* x, T* out) {
  using O = Ops<T>;
  const int q = threadIdx.x % kLanes, g = threadIdx.x / kLanes;
#pragma unroll
  for (int p = 0; p < kTriRounds; ++p) {
    if (p * (kColThreads / kLanes) >= j) break;  // the same in every lane
    const int l = g + p * (kColThreads / kLanes);
    T acc = O::zero();
#pragma unroll
    for (int e = 0; e < kTriTerms; ++e) {
      const int m = q + e * kLanes;
      if (l < j && m < j && (kUpper ? m >= l : m <= l)) acc = O::madd(acc, tr[p][e], x[m]);
    }
    acc = group_sum(acc, kLanes);
    if (l < j && q == 0) out[l] = acc;
  }
}

// Thread layout of col_update and col_reflect: block b owns rows
// [b R, b R + R) (R = rows); thread t is row r = t % R of group g = t / R,
// one of G = kColThreads / R groups. A sum over the panel's columns l < j
// is split over the groups (group g takes l = g + q G) and the groups' sums
// are added by a fixed tree in shared memory.

// The sum over the groups of each row's s_part (G a power of two), left in
// the entries of group 0. Call with the whole block.
template <typename T>
__device__ __forceinline__ void sum_groups(T* s_part, int rows) {
  const int t = threadIdx.x, g = t / rows;
  for (int h = kColThreads / rows / 2; h > 0; h >>= 1) {
    if (g < h) s_part[t] = Ops<T>::add(s_part[t], s_part[t + h * rows]);
    __syncthreads();
  }
}

// Launch 1 of column j: t1 = T V^H e_k; c = A0 e_k - Z t1 for the block's
// rows; Pu[l * B + b] = sum over its rows i >= v0 of conj(V[i, l]) c_i.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
col_update_kernel(const T* __restrict__ A, const T* __restrict__ Vt, const T* __restrict__ Zt,
                  const T* __restrict__ Tf, T* __restrict__ c, T* __restrict__ Pu, int64_t n,
                  int nb, int64_t k0, int j, int rows) {
  using O = Ops<T>;
  __shared__ T s_a[kMaxPanel];
  __shared__ T s_t1[kMaxPanel];
  __shared__ T s_part[kColThreads];
  __shared__ T s_c[32];
  const int t = threadIdx.x, r = t % rows, g = t / rows, G = kColThreads / rows;
  const int B = gridDim.x, b = blockIdx.x;
  const int64_t k = k0 + j, v0 = k0 + 1, i = static_cast<int64_t>(b) * rows + r;
  const bool in = i < n;
  // every load that waits for nothing computed here, first
  const T aik = in ? A[i * n + k] : O::zero();
  wait_previous();  // col_finish of column j - 1: V, Z and T's column j - 1; it reads c
  start_next();
  T zr[kMaxIter], vr[kMaxIter];  // Z[i, l], V[i, l] for l = g + q G
#pragma unroll
  for (int q = 0; q < kMaxIter; ++q) {
    const int l = g + q * G;
    zr[q] = in && l < j ? Zt[l * n + i] : O::zero();
    vr[q] = in && l < j ? Vt[l * n + i] : O::zero();
  }
  T tr[kTriRounds][kTriTerms];
  load_tri<true>(Tf, nb, j, tr);
  if (t < j) s_a[t] = O::conj(Vt[t * n + k]);
  __syncthreads();
  apply_tri<true>(tr, j, s_a, s_t1);  // t1 = T V^H e_k
  __syncthreads();
  T acc = O::zero();
#pragma unroll
  for (int q = 0; q < kMaxIter; ++q)
    if (g + q * G < j) acc = O::madd(acc, zr[q], s_t1[g + q * G]);
  s_part[t] = acc;
  __syncthreads();
  sum_groups(s_part, rows);
  if (g == 0 && in) {
    const T x = O::sub(aik, s_part[r]);
    c[i] = x;
    s_c[r] = x;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kMaxIter; ++q) {
    if (q * G >= j) break;  // the same in every lane
    const int l = g + q * G;
    T p = l < j && in && i >= v0 ? O::madd(O::zero(), O::conj(vr[q]), s_c[r]) : O::zero();
    p = group_sum(p, rows);
    if (l < j && r == 0) Pu[l * B + b] = p;
  }
}

// Launch 2 of column j: u = sum of Pu; t2 = T^H u; c -= V t2 for the block's
// rows i >= v0; partials over its rows of w = V[s+1:]^H c[s+1:] (Pw[l * B + b]),
// ||c[s:]||^2 (Pw[nb * B + b]) and ||c[s+1:]||^2 (Pw[(nb + 1) * B + b]).
template <typename T>
__global__ void __launch_bounds__(kColThreads)
col_reflect_kernel(const T* __restrict__ Vt, const T* __restrict__ Tf, T* __restrict__ c,
                   const T* __restrict__ Pu, T* __restrict__ Pw, int64_t n, int nb, int64_t k0,
                   int j, int rows) {
  using O = Ops<T>;
  using R = typename O::Real;
  __shared__ T s_u[kMaxPanel];
  __shared__ T s_t2[kMaxPanel];
  __shared__ T s_part[kColThreads];
  __shared__ T s_c[32];
  const int t = threadIdx.x, r = t % rows, g = t / rows, G = kColThreads / rows;
  const int lane = t & 31, warp = t >> 5;
  const int B = gridDim.x, b = blockIdx.x;
  const int64_t k = k0 + j, s = k + 1, v0 = k0 + 1, i = static_cast<int64_t>(b) * rows + r;
  const bool in = i < n;
  T vr[kMaxIter];  // V[i, l] for l = g + q G
#pragma unroll
  for (int q = 0; q < kMaxIter; ++q) {
    const int l = g + q * G;
    vr[q] = in && l < j ? Vt[l * n + i] : O::zero();
  }
  T tr[kTriRounds][kTriTerms];
  load_tri<false>(Tf, nb, j, tr);
  wait_previous();  // col_update of column j: c and Pu
  start_next();
  const T ci = in ? c[i] : O::zero();
  sum_partials(Pu, B, j, s_u);  // u = V^H c over rows >= v0
  __syncthreads();
  apply_tri<false>(tr, j, s_u, s_t2);  // t2 = T^H u
  __syncthreads();
  T acc = O::zero();
  if (i >= v0) {
#pragma unroll
    for (int q = 0; q < kMaxIter; ++q)
      if (g + q * G < j) acc = O::madd(acc, vr[q], s_t2[g + q * G]);
  }
  s_part[t] = acc;
  __syncthreads();
  sum_groups(s_part, rows);
  if (g == 0 && in) {
    T x = ci;
    if (i >= v0) {
      x = O::sub(x, s_part[r]);
      c[i] = x;
    }
    s_c[r] = x;
  }
  __syncthreads();
  if (warp == 0) {  // rows R <= 32: the tile's rows are lanes 0 .. R - 1 of warp 0
    const int64_t row = static_cast<int64_t>(b) * rows + lane;
    const R a2 = lane < rows && row < n && row >= s ? O::abs2(s_c[lane]) : R(0);
    const R nrm2 = warp_allsum(a2), tail2 = warp_allsum(row > s ? a2 : R(0));
    if (lane == 0) {
      Pw[nb * B + b] = O::make(nrm2, R(0));
      Pw[(nb + 1) * B + b] = O::make(tail2, R(0));
    }
  }
#pragma unroll
  for (int q = 0; q < kMaxIter; ++q) {
    if (q * G >= j) break;  // the same in every lane
    const int l = g + q * G;
    T p = l < j && in && i > s ? O::madd(O::zero(), O::conj(vr[q]), s_c[r]) : O::zero();
    p = group_sum(p, rows);
    if (l < j && r == 0) Pw[l * B + b] = p;
  }
}

// sum_{l > s} a[l] c[l] over a row, a warp's lanes taking every 32nd l.
template <typename T>
__device__ __forceinline__ T row_dot(const T* __restrict__ a, const T* __restrict__ c, int64_t s,
                                     int64_t n) {
  T acc = Ops<T>::zero();
  for (int64_t l = s + 1 + (threadIdx.x & 31); l < n; l += 32) acc = Ops<T>::madd(acc, a[l], c[l]);
  return warp_allsum(acc);
}

// Launch 3 of column j, a warp per row over the grid: the reflector's
// scalars from the partials of launch 2 (the rule of
// hessenberg_blocked.py:216-243, in every block), then for row i
// z_i = vinv (A0[i, s] vs + sum_{l > s} A0[i, l] c_l) into Zt[j] and
// v_i = vinv (0 above s, vs at s, c_i below) into Vt[j]; block 0 also
// grows T: T[:j, j] = -tau T m with m = vinv (w + conj(V[s, :j]) vs),
// T[j, j] = tau. On a skip vinv = 0, so v = z = 0 and T's column is 0.
// Blocks other than 0 stream their rows before they wait for the scalars.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
col_finish_kernel(const T* __restrict__ A, T* __restrict__ Vt, T* __restrict__ Zt,
                  T* __restrict__ Tf, const T* __restrict__ c, const T* __restrict__ Pw,
                  int64_t n, int nb, int64_t k0, int j, int B) {
  using O = Ops<T>;
  using R = typename O::Real;
  __shared__ T s_sums[2];
  __shared__ T s_w[kMaxPanel];
  __shared__ T s_m[kMaxPanel];
  __shared__ T s_tm[kMaxPanel];
  __shared__ T s_vs;
  __shared__ R s_vinv, s_tau;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t s = k0 + j + 1, row = static_cast<int64_t>(blockIdx.x) * kGemvRows + warp;
  const bool in = row < n, first = blockIdx.x == 0;
  const T as = in ? A[row * n + s] : O::zero();
  T tr[kTriRounds][kTriTerms];
  T vts = O::zero();  // V[s, t]
  if (first) {
    load_tri<true>(Tf, nb, j, tr);
    if (t < j) vts = Vt[t * n + s];
  }
  wait_previous();  // col_reflect of column j: c and Pw
  start_next();
  const T x0 = c[s];
  const T crow = in ? c[row] : O::zero();
  T dot = O::zero();
  if (!first && in) dot = row_dot(A + row * n, c, s, n);
  sum_partials(Pw + nb * B, B, 2, s_sums);  // ||c[s:]||^2, ||c[s+1:]||^2
  __syncthreads();
  if (t == 0) {
    const R nrm2 = O::re(s_sums[0]), tail2 = O::re(s_sums[1]);
    const R m0 = dsqrt(O::abs2(x0));
    const T sign = m0 > R(0) ? O::divr(x0, m0) : O::one();
    const T vs = O::madd(x0, sign, O::make(dsqrt(nrm2), R(0)));  // x0 + sign ||x||
    const R vn2 = tail2 + O::abs2(vs);
    const bool skip = tail2 == R(0) || vn2 == R(0);
    s_vs = vs;
    s_tau = skip ? R(0) : R(2);
    s_vinv = skip ? R(0) : R(1) / dsqrt(vn2);
  }
  __syncthreads();
  const T vs = s_vs;
  const R vinv = s_vinv;
  if (first) {
    sum_partials(Pw, B, j, s_w);  // w = V[s+1:]^H c[s+1:]
    __syncthreads();
    if (t < j) s_m[t] = O::scale(O::madd(s_w[t], O::conj(vts), vs), vinv);
    __syncthreads();
    apply_tri<true>(tr, j, s_m, s_tm);
    __syncthreads();
    if (t < j) Tf[t * nb + j] = O::scale(s_tm[t], -s_tau);
    if (t == 0) Tf[j * nb + j] = O::make(s_tau, R(0));
    if (in) dot = row_dot(A + row * n, c, s, n);
  }
  if (in && lane == 0) {
    Zt[j * n + row] = O::scale(O::madd(dot, as, vs), vinv);
    Vt[j * n + row] = O::scale(row < s ? O::zero() : (row == s ? vs : crow), vinv);
  }
}

// A[i, col] = 0 for the panel's columns col in [k0, k0 + jn) and rows i >= col + 2.
template <typename T>
__global__ void zero_below_kernel(T* __restrict__ A, int64_t n, int64_t k0, int jn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * jn) return;
  const int64_t i = e / jn, col = k0 + e % jn;
  if (i >= col + 2) A[i * n + col] = Ops<T>::zero();
}

// The split-K partials of P = V^H A0, G = V^H Y and Q V: gemm_split's
// slices reach kSplitBlocks blocks over at most one 64-row (or 64-column)
// tile strip of n or n - k0 entries, and each slice holds an nb x (n - k0)
// or n x nb partial (G: nb x nb, at most n / 128 slices).
inline int64_t split_capacity(int64_t n, int nb) {
  return (static_cast<int64_t>(kSplitBlocks) * kBM + n) * nb;
}

// Scalars of scratch: Vt, Zt, Y, W, W2 (n x nb each), Tf, G, G2 (nb x nb),
// c (n), the column step's partials Pu (nb x B) and Pw ((nb + 2) x B) with
// B = ceil(n / col_rows(n)) blocks, and the split-K partials.
inline int64_t scratch_size(int64_t n, int nb) {
  const int64_t B = blocks_for(n, col_rows(n));
  return 5 * n * nb + 3 * nb * nb + n + (2 * nb + 2) * B + split_capacity(n, nb);
}

// Launch a column-step kernel of kColThreads threads on `blocks` blocks;
// `chained`: with programmatic stream serialization, so that it may start
// while the column-step kernel before it finishes (its wait_previous()
// orders what matters).
template <typename... Params, typename... Args>
int launch_col(void (*kernel)(Params...), unsigned blocks, bool chained, cudaStream_t st,
               Args&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kColThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = chained ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...));
}

template <typename T>
int run_blocked(const T* a, T* h, T* q, T* scratch, int64_t n, int nb, long long* launches,
                cudaStream_t st) {
  cudaMemcpyAsync(h, a, n * n * sizeof(T), cudaMemcpyDeviceToDevice, st);
  if (int rc = last_error()) return rc;
  auto counted = [&](int rc, int kernels) {
    *launches += kernels;
    return rc;
  };
  if (q != nullptr) {
    eye_kernel<T><<<blocks_for(n * n, kThreads), kThreads, 0, st>>>(q, n);
    if (int rc = counted(last_error(), 1)) return rc;
  }
  const int rows = col_rows(n);
  const int B = static_cast<int>(blocks_for(n, rows));
  T* Vt = scratch;        // nb x n: V^T, row l = reflector l
  T* Zt = Vt + nb * n;    // nb x n: (A0 V)^T; then Q V (n x nb)
  T* Y = Zt + nb * n;     // n x nb: Z T, then (Q V) T
  T* W = Y + n * nb;      // nb x n: P = V^H A0
  T* W2 = W + nb * n;     // nb x n: T^H P - G2 V^H
  T* Tf = W2 + nb * n;    // nb x nb
  T* G = Tf + nb * nb;    // nb x nb: V^H Y
  T* G2 = G + nb * nb;    // nb x nb: T^H G
  T* c = G2 + nb * nb;    // n
  T* Pu = c + n;          // nb x B
  T* Pw = Pu + nb * B;    // (nb + 2) x B
  T* Ps = Pw + (nb + 2) * B;  // split-K partials
  const int64_t cap = split_capacity(n, nb);
  for (int64_t k0 = 0; k0 + 2 < n; k0 += nb) {
    const int jn = static_cast<int>(n - 2 - k0 < nb ? n - 2 - k0 : nb);
    const int64_t s0 = k0 + 1, m = n - s0;  // rows >= s0 carry the reflectors
    const T* Vs = Vt + s0;  // V[s0:, :] as stored: kT reads V, kJ reads V^H
    cudaMemsetAsync(Tf, 0, nb * nb * sizeof(T), st);
    if (int rc = last_error()) return rc;
    for (int j = 0; j < jn; ++j) {  // phase A
      const unsigned gemv_blocks = blocks_for(n, kGemvRows);
      if (int rc = counted(launch_col(col_update_kernel<T>, B, j > 0, st, h, Vt, Zt, Tf, c, Pu, n,
                                      nb, k0, j, rows), 1))
        return rc;
      if (int rc = counted(launch_col(col_reflect_kernel<T>, B, true, st, Vt, Tf, c, Pu, Pw, n, nb,
                                      k0, j, rows), 1))
        return rc;
      if (int rc = counted(launch_col(col_finish_kernel<T>, gemv_blocks, true, st, h, Vt, Zt, Tf,
                                      c, Pw, n, nb, k0, j, B), 1))
        return rc;
    }
    // phase B; columns < k0 of rows >= s0 are zero, so P and W start at k0
    int rc = 0;
    // (P, G and Q V are deep and narrow: split-K, two launches each)
    if ((rc = counted(gemm_split<T>(jn, n - k0, m, Vs, n, kJ, h + s0 * n + k0, n, kN, W + k0, n,
                                    1.0, false, Ps, cap, st), 2)) ||
        (rc = counted(gemm<T>(n, jn, jn, Zt, n, kT, Tf, nb, kN, Y, nb, 1.0, false, st), 1)) ||
        (rc = counted(gemm_split<T>(jn, jn, m, Vs, n, kJ, Y + s0 * nb, nb, kN, G, nb, 1.0, false,
                                    Ps, cap, st), 2)) ||
        (rc = counted(gemm<T>(jn, jn, jn, Tf, nb, kC, G, nb, kN, G2, nb, 1.0, false, st), 1)) ||
        (rc = counted(gemm<T>(jn, n - k0, jn, Tf, nb, kC, W + k0, n, kN, W2 + k0, n, 1.0, false,
                              st), 1)) ||
        (rc = counted(gemm<T>(jn, m, jn, G2, nb, kN, Vs, n, kJ, W2 + s0, n, -1.0, true, st), 1)) ||
        (rc = counted(gemm<T>(n, m, jn, Y, nb, kN, Vs, n, kJ, h + s0, n, -1.0, true, st), 1)) ||
        (rc = counted(gemm<T>(m, n - k0, jn, Vs, n, kT, W2 + k0, n, kN, h + s0 * n + k0, n, -1.0,
                              true, st), 1)))
      return rc;
    zero_below_kernel<T><<<blocks_for(n * jn, kThreads), kThreads, 0, st>>>(h, n, k0, jn);
    if ((rc = counted(last_error(), 1))) return rc;
    T* QV = Zt;  // free once Y = Z T is formed
    if (q != nullptr &&  // phase C
        ((rc = counted(gemm_split<T>(n, jn, m, q + s0, n, kN, Vs, n, kT, QV, nb, 1.0, false, Ps,
                                     cap, st), 2)) ||
         (rc = counted(gemm<T>(n, jn, jn, QV, nb, kN, Tf, nb, kN, Y, nb, 1.0, false, st), 1)) ||
         (rc = counted(gemm<T>(n, m, jn, Y, nb, kN, Vs, n, kJ, q + s0, n, -1.0, true, st), 1))))
      return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// The scalars of scratch that hessenberg_blocked needs for n and nb.
long long hessenberg_blocked_scratch(long long n, int nb) {
  return n > 0 && nb > 0 ? scratch_size(n, nb) : 0;
}

// B11 (B12 on complex data): h = the Hessenberg form of the n x n matrix a,
// by panels of nb <= 64 columns; q (nullable) = the accumulated unitary with
// a = q h q^H. scratch holds hessenberg_blocked_scratch(n, nb) scalars;
// *launches (host) receives the number of kernels enqueued.
int hessenberg_blocked(int dtype, int device, const void* a, void* h, void* q, void* scratch,
                       long long n, int nb, long long* launches, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *launches = 0;
  if (nb < 1 || nb > kMaxPanel) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HB_ARGS(T) static_cast<const T*>(a), static_cast<T*>(h), static_cast<T*>(q), \
                   static_cast<T*>(scratch), n, nb, launches, s
  switch (dtype) {
    case kF32: return run_blocked<float>(HB_ARGS(float));
    case kF64: return run_blocked<double>(HB_ARGS(double));
    case kC64: return run_blocked<float2>(HB_ARGS(float2));
    case kC128: return run_blocked<double2>(HB_ARGS(double2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HB_ARGS
}

}  // extern "C"
