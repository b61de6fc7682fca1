// Eigenvectors of an upper-triangular matrix for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel B14,
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/trisolve_vec.py::_trisolve_kernel
// (:72), for complex float2 and double2 ((re, im) in (.x, .y)).
//
// Column k of Y solves (T - T[k,k] I) y = 0 with y[k] = 1 and zeros below:
//   y[i] = -(sum_{j>i} T[i,j] y[j]) / den,  den = T[i,i] - T[k,k],
// bottom-up, every column at once. The TPU kernel's rules are kept:
//  * the clamp: |den|^2 < eps^2 -> den = eps (:205-212);
//  * the mask: only rows i < k are solved, y[k] = 1 (:214-218);
//  * the rescale: when a new entry of a column exceeds 1e18 in magnitude
//    (max(|re|, |im|)), the column's rows of the current block are scaled by
//    1e-18 and the column's event count rises by one (:220-236); each block
//    records the counts it was written at, rows of lower blocks enter the
//    block's GEMM scaled by 1e-18^(count now - count then) (:152-170), and a
//    last pass brings every block's rows to the final count (:331-337).
//
// What bounds it, and what the design does about it: the rows of a column
// depend on each other in sequence, the columns not at all. Blocks of
// kBlockRows rows are taken bottom-up, two launches each:
//  * below_block_gemm_kernel: the contribution of all rows below the block,
//    racc = T[block, below] Y[below, :], one tiled complex GEMM (32 x 32
//    output tiles in shared memory, FMA in the working precision). Y is upper
//    triangular, so a column tile stops its k loop at its last column. This
//    is the O(n^3) part: ~n^3/6 complex multiply-adds in all, which bounds
//    the kernel by operations at large n.
//  * block_solve_kernel: one thread per column walks the block's rows
//    bottom-up, forming each row's sum over the block's rows already solved
//    (T's row is the same for every thread, so its loads broadcast; Y's loads
//    are coalesced across threads). It is latency-bound: kBlockRows^2 / 2
//    dependent multiply-adds per column and block.
// The TPU's 16-row windows, its column split and its padding are VMEM layout
// and have no counterpart. No row or column outside [0, n) is ever read.
//
// Plain C interface for ctypes: the entry point selects the device, launches
// on the caller's stream and returns the first CUDA error (0 on success),
// checked after every launch.

#include "eig_common.cuh"

namespace {

constexpr int kBlockRows = 64;
constexpr int kTile = 32;
constexpr int kSolveThreads = 128;
constexpr double kBig = 1e18;    // rescale threshold (trisolve_vec.py:58)
constexpr double kSmall = 1e-18;  // rescale factor (:59)

// The factor that brings a row written at `delta` fewer events to the
// current scale (trisolve_vec.py:162-165): 1, 1e-18, 1e-36, else 0.
template <typename R>
__device__ __forceinline__ R event_factor(int delta) {
  return delta <= 0 ? R(1) : delta == 1 ? R(kSmall) : delta == 2 ? R(kSmall) * R(kSmall) : R(0);
}

// racc[r, k] = sum_{j >= e1} T[b1 + r, j] Y[j, k] f(ccur[k] - cnt[j / kBlockRows, k])
// for r < e1 - b1 and k in [e1, n): the rows below the block [b1, e1).
template <typename T>
__global__ void __launch_bounds__(kThreads)
below_block_gemm_kernel(const T* __restrict__ Tm, const T* __restrict__ Y, const int* __restrict__ cnt,
                        const int* __restrict__ ccur, T* __restrict__ racc, int64_t n, int64_t b1,
                        int64_t e1) {
  using O = Ops<T>;
  using R = typename O::Real;
  __shared__ T As[kTile][kTile + 1];
  __shared__ T Bs[kTile][kTile + 1];
  constexpr int kLanes = kThreads / kTile;
  constexpr int kRowsPerThread = kTile / kLanes;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int64_t rows = e1 - b1;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kTile;
  const int64_t col0 = e1 + static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t col = col0 + tx;
  const int64_t k_end = col0 + kTile < n ? col0 + kTile : n;  // Y[j, k] = 0 for j > k
  T acc[kRowsPerThread];
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = O::zero();
  for (int64_t j0 = e1; j0 < k_end; j0 += kTile) {
    for (int r = ty; r < kTile; r += kLanes) {
      const int64_t ar = row0 + r, ac = j0 + tx, br = j0 + r;
      As[r][tx] = ar < rows && ac < n ? Tm[(b1 + ar) * n + ac] : O::zero();
      T b = O::zero();
      if (br < n && col < n)
        b = O::scale(Y[br * n + col], event_factor<R>(ccur[col] - cnt[(br / kBlockRows) * n + col]));
      Bs[r][tx] = b;
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      const T b = Bs[kk][tx];
      for (int q = 0; q < kRowsPerThread; ++q)
        acc[q] = O::madd(acc[q], As[ty + q * kLanes][kk], b);
    }
    __syncthreads();
  }
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int64_t r = row0 + ty + q * kLanes;
    if (r < rows && col < n) racc[r * n + col] = acc[q];
  }
}

// The rows [b1, e1) of every column k >= b1, bottom-up, one thread per
// column; racc holds the rows below (columns >= e1 only). Records the
// column's event count in ccur and cnt[block].
template <typename T>
__global__ void __launch_bounds__(kSolveThreads)
block_solve_kernel(const T* __restrict__ Tm, T* __restrict__ Y, const T* __restrict__ racc,
                   int* __restrict__ cnt, int* __restrict__ ccur, int64_t n, int64_t b1, int64_t e1,
                   typename Ops<T>::Real eps) {
  using O = Ops<T>;
  using R = typename O::Real;
  const int64_t k = b1 + static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const T lam = Tm[k * n + k];
  const int64_t top = k < e1 ? k : e1 - 1;  // rows above k only; rows below k stay 0
  R scale = R(1);
  int events = 0;
  for (int64_t i = top; i >= b1; --i) {
    T y = O::one();
    if (i < k) {
      T r = k >= e1 ? O::scale(racc[(i - b1) * n + k], scale) : O::zero();
      for (int64_t j = i + 1; j <= top; ++j) r = O::madd(r, Tm[i * n + j], Y[j * n + k]);
      T den = O::sub(Tm[i * n + i], lam);
      if (O::abs2(den) < eps * eps) den = O::make(eps, R(0));
      R dd = O::abs2(den);
      if (dd == R(0)) dd = R(1);
      y = O::divr(O::madd(O::zero(), r, O::conj(den)), -dd);  // -(r conj(den)) / |den|^2
    }
    const R mag = fmax(fabs(O::re(y)), fabs(O::im(y)));
    if (mag > R(kBig)) {
      for (int64_t j = i + 1; j <= top; ++j) Y[j * n + k] = O::scale(Y[j * n + k], R(kSmall));
      scale *= R(kSmall);
      ++events;
      y = O::scale(y, R(kSmall));
    }
    Y[i * n + k] = y;
  }
  const int c = ccur[k] + events;
  ccur[k] = c;
  cnt[(b1 / kBlockRows) * n + k] = c;
}

// Y[i, k] *= 1e-18^(cnt[0, k] - cnt[i / kBlockRows, k]): every block's rows at
// the column's final scale (trisolve_vec.py:331-337).
template <typename T>
__global__ void final_scale_kernel(T* __restrict__ Y, const int* __restrict__ cnt, int64_t n) {
  using O = Ops<T>;
  using R = typename O::Real;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * n) return;
  const int64_t i = e / n, k = e % n;
  const int delta = cnt[k] - cnt[(i / kBlockRows) * n + k];
  if (delta != 0) Y[e] = O::scale(Y[e], pow(R(kSmall), R(delta)));
}

template <typename T>
int run_trisolve(const T* t, T* y, T* racc, int* counts, int64_t n, double eps, cudaStream_t st) {
  using R = typename Ops<T>::Real;
  const int64_t nblk = (n + kBlockRows - 1) / kBlockRows;
  int* cnt = counts;               // nblk x n
  int* ccur = counts + nblk * n;   // n
  cudaMemsetAsync(y, 0, n * n * sizeof(T), st);
  if (int rc = last_error()) return rc;
  cudaMemsetAsync(counts, 0, (nblk + 1) * n * sizeof(int), st);
  if (int rc = last_error()) return rc;
  for (int64_t b = nblk - 1; b >= 0; --b) {
    const int64_t b1 = b * kBlockRows, e1 = b1 + kBlockRows < n ? b1 + kBlockRows : n;
    if (e1 < n) {
      const dim3 grid(blocks_for(n - e1, kTile), blocks_for(e1 - b1, kTile));
      below_block_gemm_kernel<T><<<grid, kThreads, 0, st>>>(t, y, cnt, ccur, racc, n, b1, e1);
      if (int rc = last_error()) return rc;
    }
    block_solve_kernel<T><<<blocks_for(n - b1, kSolveThreads), kSolveThreads, 0, st>>>(
        t, y, racc, cnt, ccur, n, b1, e1, static_cast<R>(eps));
    if (int rc = last_error()) return rc;
  }
  final_scale_kernel<T><<<blocks_for(n * n, kThreads), kThreads, 0, st>>>(y, cnt, n);
  return last_error();
}

}  // namespace

extern "C" {

// B14: y = the unnormalised eigenvectors of the upper-triangular complex
// n x n matrix t (column k pairs with t[k, k]); racc holds 64 x n scalars,
// counts (ceil(n / 64) + 1) x n int32.
int trisolve_eigenvectors(int dtype, int device, const void* t, void* y, void* racc, void* counts,
                          long long n, double eps, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TRI_ARGS(T) static_cast<const T*>(t), static_cast<T*>(y), static_cast<T*>(racc), \
                    static_cast<int*>(counts), n, eps, s
  switch (dtype) {
    case kC64: return run_trisolve<float2>(TRI_ARGS(float2));
    case kC128: return run_trisolve<double2>(TRI_ARGS(double2));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TRI_ARGS
}

}  // extern "C"
