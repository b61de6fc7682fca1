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
//  A. for each column j (k = k0 + j): panel_column_kernel rebuilds the column
//     as the panel's earlier reflectors left it,
//       c = (I - V T^H V^H)(A0 - Z T V^H) e_k,
//     forms the reflector v with B7's rules (phase sign x0/|x0|, tau = 0 for
//     the tail-zero and degenerate skips, and then v = 0), and grows the
//     compact-WY factor: V[:, j] = v, T[:j, j] = -tau T V^H v, T[j, j] = tau;
//     panel_gemv_kernel forms Z[:, j] = A0 v. V and Z are stored transposed
//     (nb x n, a column of V or Z is a contiguous row), so that every access
//     of the column kernel is coalesced.
//  B. the trailing update A := (I - V T^H V^H)(A0 - Z T V^H) as tiled GEMMs:
//     P = V^H A0, Y = Z T, G2 = T^H (V^H Y), W = T^H P - G2 V^H,
//     A -= Y V^H, A -= V W; then the panel's columns are set to exact zeros
//     below the subdiagonal (the reference's eliminated entries are zeros).
//  C. with Q: Q -= (Q V) T V^H as three GEMMs.
//
// What bounds it on this card, and what the design does about it:
//  * Phase A reads the trailing part of A0 once per column (the GEMV): about
//    n^3 / 2 elements over the reduction, 2 n^3 bytes in float, which does
//    not fit in the 50 MB L2 beyond n ~ 3500 (float): memory-bound. A warp
//    owns a row, so each warp reads a contiguous segment. The column kernel
//    is one block (its reductions over rows need no grid-wide step); it reads
//    V and Z, n x nb each, from L2, a warp per column of V for the sums over
//    rows and a thread per row for the updates, coalesced either way.
//  * Phase B is ~10/3 n^3 flops in all (real; four times that in complex) as
//    the tiled GEMM of eig_common.cuh (gemm_op_kernel, shared with B9's
//    blocked QR): 64 x 64 output tiles, 16-deep shared-memory tiles, a 4 x 4
//    register block per thread, full FMA in the working precision (no tensor
//    cores, so no TF32). Each operand is read as stored (N), transposed (T),
//    conjugate-transposed (C) or conjugated (J), so no transpose is ever
//    formed.
//  * Launches: 2 per column and ~12 per panel, ~2n + 12 n/nb in all.
// The TPU's slab windows, 128-lane padding, the monolithic versus
// phase-split choice and the chunking are VMEM workarounds and have no
// counterpart. No row or column outside [0, n) is ever read.
//
// Plain C interface for ctypes: the entry point selects the device, launches
// on the caller's stream and returns the first CUDA error (0 on success),
// checked after every launch.

#include "eig_common.cuh"

namespace {

constexpr int kMaxPanel = 64;      // largest panel width nb
constexpr int kColThreads = 1024;  // panel_column_kernel: one block

// Column j of the panel at k0 (k = k0 + j, pivot row s = k + 1), in one block.
// Vt and Zt (nb x n: row l is column l of V, Z) and Tf (nb x nb) hold the
// panel's columns < j; A is A0. Leaves the column in c and the reflector in
// row j of Vt, and grows Tf.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
panel_column_kernel(const T* __restrict__ A, T* __restrict__ Vt, const T* __restrict__ Zt,
                    T* __restrict__ Tf, T* __restrict__ c, int64_t n, int nb, int64_t k0, int j) {
  using O = Ops<T>;
  using R = typename O::Real;
  __shared__ T s_a[kMaxPanel];
  __shared__ T s_b[kMaxPanel];
  __shared__ R red[32];
  __shared__ T s_vs;
  __shared__ R s_vinv, s_tau;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5, nwarps = nt >> 5;
  const int64_t k = k0 + j, s = k + 1, v0 = k0 + 1;  // V is zero above row v0
  T* __restrict__ v = Vt + j * n;
  // t1 = T V^H e_k
  if (t < j) s_a[t] = O::conj(Vt[t * n + k]);
  __syncthreads();
  if (t < j) {
    T acc = O::zero();
    for (int m = t; m < j; ++m) acc = O::madd(acc, Tf[t * nb + m], s_a[m]);
    s_b[t] = acc;
  }
  __syncthreads();
  // c = A0 e_k - Z t1
  for (int64_t i = t; i < n; i += nt) {
    T x = A[i * n + k];
    for (int l = 0; l < j; ++l) x = O::msub(x, Zt[l * n + i], s_b[l]);
    c[i] = x;
  }
  __syncthreads();
  // u = V^H c, a warp per column of V
  for (int l = warp; l < j; l += nwarps) {
    T acc = O::zero();
    for (int64_t i = v0 + lane; i < n; i += 32) acc = O::madd(acc, O::conj(Vt[l * n + i]), c[i]);
    acc = warp_allsum(acc);
    if (lane == 0) s_a[l] = acc;
  }
  __syncthreads();
  // t2 = T^H u
  if (t < j) {
    T acc = O::zero();
    for (int m = 0; m <= t; ++m) acc = O::madd(acc, O::conj(Tf[m * nb + t]), s_a[m]);
    s_b[t] = acc;
  }
  __syncthreads();
  // c -= V t2
  for (int64_t i = v0 + t; i < n; i += nt) {
    T x = c[i];
    for (int l = 0; l < j; ++l) x = O::msub(x, Vt[l * n + i], s_b[l]);
    c[i] = x;
  }
  __syncthreads();
  // the reflector from c with pivot row s (hessenberg_blocked.py:216-243)
  R nrm2 = 0, tail2 = 0;
  for (int64_t i = s + t; i < n; i += nt) {
    const R m = O::abs2(c[i]);
    nrm2 += m;
    if (i > s) tail2 += m;
  }
  nrm2 = block_reduce(nrm2, red, false);
  tail2 = block_reduce(tail2, red, false);
  if (t == 0) {
    const T x0 = c[s];
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
  const R vinv = s_vinv;
  for (int64_t i = t; i < n; i += nt)
    v[i] = O::scale(i < s ? O::zero() : (i == s ? s_vs : c[i]), vinv);
  __syncthreads();
  // m = V^H v over the earlier columns
  for (int l = warp; l < j; l += nwarps) {
    T acc = O::zero();
    for (int64_t i = s + lane; i < n; i += 32) acc = O::madd(acc, O::conj(Vt[l * n + i]), v[i]);
    acc = warp_allsum(acc);
    if (lane == 0) s_a[l] = acc;
  }
  __syncthreads();
  // T[:j, j] = -tau T m; T[j, j] = tau
  if (t < j) {
    T acc = O::zero();
    for (int m = t; m < j; ++m) acc = O::madd(acc, Tf[t * nb + m], s_a[m]);
    Tf[t * nb + j] = O::scale(acc, -s_tau);
  }
  if (t == 0) Tf[j * nb + j] = O::make(s_tau, R(0));
}

// z[i] = sum_{l >= s} A[i, l] v[l] for every row i (z = row j of Zt); a warp
// owns a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_gemv_kernel(const T* __restrict__ A, const T* __restrict__ v, T* __restrict__ z, int64_t n,
                  int64_t s) {
  using O = Ops<T>;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* __restrict__ a = A + row * n;
  T acc = O::zero();
  for (int64_t l = s + lane; l < n; l += 32) acc = O::madd(acc, a[l], v[l]);
  acc = warp_allsum(acc);
  if (lane == 0) z[row] = acc;
}

// A[i, col] = 0 for the panel's columns col in [k0, k0 + jn) and rows i >= col + 2.
template <typename T>
__global__ void zero_below_kernel(T* __restrict__ A, int64_t n, int64_t k0, int jn) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * jn) return;
  const int64_t i = e / jn, col = k0 + e % jn;
  if (i >= col + 2) A[i * n + col] = Ops<T>::zero();
}

template <typename T>
int run_blocked(const T* a, T* h, T* q, T* scratch, int64_t n, int nb, cudaStream_t st) {
  cudaMemcpyAsync(h, a, n * n * sizeof(T), cudaMemcpyDeviceToDevice, st);
  if (int rc = last_error()) return rc;
  if (q != nullptr) {
    eye_kernel<T><<<blocks_for(n * n, kThreads), kThreads, 0, st>>>(q, n);
    if (int rc = last_error()) return rc;
  }
  T* Vt = scratch;        // nb x n: V^T, row l = reflector l
  T* Zt = Vt + nb * n;    // nb x n: (A0 V)^T; then Q V (n x nb)
  T* Y = Zt + nb * n;     // n x nb: Z T, then (Q V) T
  T* W = Y + n * nb;      // nb x n: P = V^H A0
  T* W2 = W + nb * n;     // nb x n: T^H P - G2 V^H
  T* Tf = W2 + nb * n;    // nb x nb
  T* G = Tf + nb * nb;    // nb x nb: V^H Y
  T* G2 = G + nb * nb;    // nb x nb: T^H G
  T* c = G2 + nb * nb;    // n
  for (int64_t k0 = 0; k0 + 2 < n; k0 += nb) {
    const int jn = static_cast<int>(n - 2 - k0 < nb ? n - 2 - k0 : nb);
    const int64_t s0 = k0 + 1, m = n - s0;  // rows >= s0 carry the reflectors
    const T* Vs = Vt + s0;  // V[s0:, :] as stored: kT reads V, kJ reads V^H
    cudaMemsetAsync(Tf, 0, nb * nb * sizeof(T), st);
    if (int rc = last_error()) return rc;
    for (int j = 0; j < jn; ++j) {  // phase A
      panel_column_kernel<T><<<1, kColThreads, 0, st>>>(h, Vt, Zt, Tf, c, n, nb, k0, j);
      if (int rc = last_error()) return rc;
      panel_gemv_kernel<T><<<blocks_for(n, kThreads / 32), kThreads, 0, st>>>(
          h, Vt + j * n, Zt + j * n, n, k0 + j + 1);
      if (int rc = last_error()) return rc;
    }
    // phase B; columns < k0 of rows >= s0 are zero, so P and W start at k0
    int rc = 0;
    if ((rc = gemm<T>(jn, n - k0, m, Vs, n, kJ, h + s0 * n + k0, n, kN, W + k0, n, 1.0, false, st)) ||
        (rc = gemm<T>(n, jn, jn, Zt, n, kT, Tf, nb, kN, Y, nb, 1.0, false, st)) ||
        (rc = gemm<T>(jn, jn, m, Vs, n, kJ, Y + s0 * nb, nb, kN, G, nb, 1.0, false, st)) ||
        (rc = gemm<T>(jn, jn, jn, Tf, nb, kC, G, nb, kN, G2, nb, 1.0, false, st)) ||
        (rc = gemm<T>(jn, n - k0, jn, Tf, nb, kC, W + k0, n, kN, W2 + k0, n, 1.0, false, st)) ||
        (rc = gemm<T>(jn, m, jn, G2, nb, kN, Vs, n, kJ, W2 + s0, n, -1.0, true, st)) ||
        (rc = gemm<T>(n, m, jn, Y, nb, kN, Vs, n, kJ, h + s0, n, -1.0, true, st)) ||
        (rc = gemm<T>(m, n - k0, jn, Vs, n, kT, W2 + k0, n, kN, h + s0 * n + k0, n, -1.0, true, st)))
      return rc;
    zero_below_kernel<T><<<blocks_for(n * jn, kThreads), kThreads, 0, st>>>(h, n, k0, jn);
    if ((rc = last_error())) return rc;
    T* QV = Zt;  // free once Y = Z T is formed
    if (q != nullptr &&  // phase C
        ((rc = gemm<T>(n, jn, m, q + s0, n, kN, Vs, n, kT, QV, nb, 1.0, false, st)) ||
         (rc = gemm<T>(n, jn, jn, QV, nb, kN, Tf, nb, kN, Y, nb, 1.0, false, st)) ||
         (rc = gemm<T>(n, m, jn, Y, nb, kN, Vs, n, kJ, q + s0, n, -1.0, true, st))))
      return rc;
  }
  return 0;
}

}  // namespace

extern "C" {

// B11 (B12 on complex data): h = the Hessenberg form of the n x n matrix a,
// by panels of nb <= 64 columns; q (nullable) = the accumulated unitary with
// a = q h q^H. scratch holds 5 n nb + 3 nb^2 + n scalars.
int hessenberg_blocked(int dtype, int device, const void* a, void* h, void* q, void* scratch,
                       long long n, int nb, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb < 1 || nb > kMaxPanel) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HB_ARGS(T) static_cast<const T*>(a), static_cast<T*>(h), static_cast<T*>(q), \
                   static_cast<T*>(scratch), n, nb, s
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
