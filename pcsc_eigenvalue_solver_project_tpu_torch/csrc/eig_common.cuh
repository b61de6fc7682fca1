// Scalar arithmetic and small helpers shared by the dense kernels
// (qr_kernels.cu, hessenberg_blocked.cu, trisolve_vec.cu, qr_eig_blocked.cu),
// and the tiled GEMM of the compact-WY updates (B9, B11, B12) with its
// deterministic split-K form (B11, B12).
//
// Each kernel is templated on float, double, float2 and double2: complex
// values are (re, im) in (.x, .y), and a complex multiply-add is four FMAs
// in the working precision (no tensor cores, so no TF32).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Scalar-type codes shared with ops/_common.py (DTYPE_CODES).
enum DTypeCode { kF32 = 0, kF64 = 2, kC64 = 3, kC128 = 4 };

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dfma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return fma(a, b, c); }

template <typename R>
struct RealOps {
  using Real = R;
  static __device__ __forceinline__ R zero() { return R(0); }
  static __device__ __forceinline__ R one() { return R(1); }
  static __device__ __forceinline__ R make(R re, R) { return re; }
  static __device__ __forceinline__ R re(R a) { return a; }
  static __device__ __forceinline__ R im(R) { return R(0); }
  static __device__ __forceinline__ R abs2(R a) { return a * a; }
  static __device__ __forceinline__ R conj(R a) { return a; }
  static __device__ __forceinline__ R add(R a, R b) { return a + b; }
  static __device__ __forceinline__ R sub(R a, R b) { return a - b; }
  static __device__ __forceinline__ R scale(R a, R s) { return a * s; }
  static __device__ __forceinline__ R divr(R a, R s) { return a / s; }
  static __device__ __forceinline__ R madd(R acc, R a, R b) { return dfma(a, b, acc); }
  static __device__ __forceinline__ R msub(R acc, R a, R b) { return dfma(-a, b, acc); }
  static __device__ __forceinline__ R shfl_xor(R a, int m) {
    return __shfl_xor_sync(0xffffffffu, a, m);
  }
};

template <typename R, typename C>
struct ComplexOps {
  using Real = R;
  static __device__ __forceinline__ C make(R re, R im) { C c; c.x = re; c.y = im; return c; }
  static __device__ __forceinline__ C zero() { return make(R(0), R(0)); }
  static __device__ __forceinline__ C one() { return make(R(1), R(0)); }
  static __device__ __forceinline__ R re(C a) { return a.x; }
  static __device__ __forceinline__ R im(C a) { return a.y; }
  static __device__ __forceinline__ R abs2(C a) { return a.x * a.x + a.y * a.y; }
  static __device__ __forceinline__ C conj(C a) { return make(a.x, -a.y); }
  static __device__ __forceinline__ C add(C a, C b) { return make(a.x + b.x, a.y + b.y); }
  static __device__ __forceinline__ C sub(C a, C b) { return make(a.x - b.x, a.y - b.y); }
  static __device__ __forceinline__ C scale(C a, R s) { return make(a.x * s, a.y * s); }
  static __device__ __forceinline__ C divr(C a, R s) { return make(a.x / s, a.y / s); }
  // acc + a * b
  static __device__ __forceinline__ C madd(C acc, C a, C b) {
    acc.x = dfma(a.x, b.x, acc.x);
    acc.x = dfma(-a.y, b.y, acc.x);
    acc.y = dfma(a.x, b.y, acc.y);
    acc.y = dfma(a.y, b.x, acc.y);
    return acc;
  }
  // acc - a * b
  static __device__ __forceinline__ C msub(C acc, C a, C b) {
    acc.x = dfma(-a.x, b.x, acc.x);
    acc.x = dfma(a.y, b.y, acc.x);
    acc.y = dfma(-a.x, b.y, acc.y);
    acc.y = dfma(-a.y, b.x, acc.y);
    return acc;
  }
  static __device__ __forceinline__ C shfl_xor(C a, int m) {
    return make(__shfl_xor_sync(0xffffffffu, a.x, m), __shfl_xor_sync(0xffffffffu, a.y, m));
  }
};

template <typename T> struct Ops;
template <> struct Ops<float> : RealOps<float> {};
template <> struct Ops<double> : RealOps<double> {};
template <> struct Ops<float2> : ComplexOps<float, float2> {};
template <> struct Ops<double2> : ComplexOps<double, double2> {};

template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
  using O = Ops<T>;
  for (int m = 16; m > 0; m >>= 1) v = O::add(v, O::shfl_xor(v, m));
  return v;
}

// Block-wide sum (max when take_max) of a real; the result is valid in
// thread 0. `shared` holds at least 32 values.
template <typename R>
__device__ R block_reduce(R v, R* shared, bool take_max) {
  for (int m = 16; m > 0; m >>= 1) {
    const R o = __shfl_xor_sync(0xffffffffu, v, m);
    v = take_max ? (o > v ? o : v) : v + o;
  }
  __syncthreads();  // `shared` may still be read from a previous call
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) shared[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>((blockDim.x + 31) >> 5) ? shared[lane] : R(0);
    for (int m = 16; m > 0; m >>= 1) {
      const R o = __shfl_xor_sync(0xffffffffu, v, m);
      v = take_max ? (o > v ? o : v) : v + o;
    }
  }
  return v;
}

template <typename T>
__global__ void eye_kernel(T* __restrict__ Q, int64_t n) {
  using O = Ops<T>;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < n * n) Q[e] = e / n == e % n ? O::one() : O::zero();
}

// ---- the shifted Givens sweeps (B8 in qr_kernels.cu, B13 in qr_eig_blocked.cu)

// |H[c+1, c]| <= tol * max(|H[c, c]| + |H[c+1, c+1]|, 1)
template <typename T>
__device__ __forceinline__ bool negligible(const T* H, int64_t n, int64_t c,
                                           typename Ops<T>::Real tol) {
  using O = Ops<T>;
  using R = typename O::Real;
  const R scale = dsqrt(O::abs2(H[c * n + c])) + dsqrt(O::abs2(H[(c + 1) * n + c + 1]));
  return dsqrt(O::abs2(H[(c + 1) * n + c])) <= tol * (scale > R(1) ? scale : R(1));
}

// The window update of qr_kernels.py:339-351 (deflate_and_lo): on return
// sh[0] + 2 is the new hi (2 + the last c < hi - 1 with a non-negligible
// subdiagonal, 1 if none) and sh[1] + 1 is lo (1 + the last c < new hi - 1
// with a negligible subdiagonal, 0 if none). Call with all threads after a
// barrier; read sh before the next barrier-separated call.
template <typename T>
__device__ void deflate_and_lo(const T* H, int64_t n, int hi, typename Ops<T>::Real tol, int* sh) {
  if (threadIdx.x == 0) sh[0] = sh[1] = -1;
  __syncthreads();
  int best = -1;
  for (int c = threadIdx.x; c < hi - 1; c += blockDim.x)
    if (!negligible(H, n, c, tol)) best = c;
  if (best >= 0) atomicMax(&sh[0], best);
  __syncthreads();
  const int new_hi = sh[0] + 2;
  best = -1;
  for (int c = threadIdx.x; c < new_hi - 1; c += blockDim.x)
    if (negligible(H, n, c, tol)) best = c;
  if (best >= 0) atomicMax(&sh[1], best);
  __syncthreads();
}

// Givens rotation zeroing b under a: g00 = conj(a)/r, g01 = conj(b)/r with
// r = sqrt(|a|^2 + |b|^2); the identity when r = 0 (qr_kernels.py:405-415).
template <typename T>
__device__ __forceinline__ void givens(T a, T b, T* g) {
  using O = Ops<T>;
  using R = typename O::Real;
  const R r2 = O::abs2(a) + O::abs2(b);
  const bool zero = r2 == R(0);
  const R rinv = R(1) / dsqrt(zero ? R(1) : r2);
  g[0] = zero ? O::one() : O::scale(O::conj(a), rinv);
  g[1] = zero ? O::zero() : O::scale(O::conj(b), rinv);
}

// Rows k, k+1 of a column under the left rotation (g00, g01):
// (g00 x + g01 y, -conj(g01) x + conj(g00) y).
template <typename T>
__device__ __forceinline__ void rotate_pair(T g00, T g01, T* x, T* y) {
  using O = Ops<T>;
  const T rk = *x, rk1 = *y;
  *x = O::madd(O::madd(O::zero(), g00, rk), g01, rk1);
  *y = O::msub(O::madd(O::zero(), O::conj(g00), rk1), O::conj(g01), rk);
}

// Eigenvalue of the trailing active 2x2 [[a, b], [c, d]] nearest d, with
// the complex square root and the pick of qr_kernels.py:366-385.
template <typename T>
__device__ T wilkinson_shift(const T* H, int64_t n, int hi) {
  using O = Ops<T>;
  using R = typename O::Real;
  const T a = H[(hi - 2) * n + hi - 2], b = H[(hi - 2) * n + hi - 1];
  const T c = H[(hi - 1) * n + hi - 2], d = H[(hi - 1) * n + hi - 1];
  const R delr = (a.x - d.x) * R(0.5), deli = (a.y - d.y) * R(0.5);
  const R zr = delr * delr - deli * deli + b.x * c.x - b.y * c.y;
  const R zi = R(2) * delr * deli + b.x * c.y + b.y * c.x;
  const R mz = dsqrt(zr * zr + zi * zi);
  const R pr = (mz + zr) * R(0.5), pi = (mz - zr) * R(0.5);
  const R sqr = dsqrt(pr > R(0) ? pr : R(0));
  const R sqi_mag = dsqrt(pi > R(0) ? pi : R(0));
  const R sqi = zi >= R(0) ? sqi_mag : -sqi_mag;
  const T mu1 = O::make(d.x + delr + sqr, d.y + deli + sqi);
  const T mu2 = O::make(d.x + delr - sqr, d.y + deli - sqi);
  const R m1 = (mu1.x - d.x) * (mu1.x - d.x) + (mu1.y - d.y) * (mu1.y - d.y);
  const R m2 = (mu2.x - d.x) * (mu2.x - d.x) + (mu2.y - d.y) * (mu2.y - d.y);
  return m1 < m2 ? mu1 : mu2;
}

inline unsigned blocks_for(int64_t count, int per_block) {
  return static_cast<unsigned>((count + per_block - 1) / per_block);
}

inline int last_error() { return static_cast<int>(cudaGetLastError()); }

// Raise a kernel's dynamic shared memory limit to `bytes`, once per device
// and kernel (the call is not stream-ordered; doing it once keeps it out of
// CUDA graph captures of the launches).
template <auto Kernel>
int allow_dynamic_smem(int bytes) {
  static bool done[64] = {};
  int device = 0;
  if (cudaError_t err = cudaGetDevice(&device)) return static_cast<int>(err);
  if (device < 64 && done[device]) return 0;
  cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (int rc = last_error()) return rc;
  if (device < 64) done[device] = true;
  return 0;
}

// ---- the tiled GEMM (B11/B12 in hessenberg_blocked.cu, B9 in qr_kernels.cu)

constexpr int kBM = 64, kBN = 64, kBK = 16, kGemmThreads = 256;

// An operand as stored (N), transposed (T), conjugate-transposed (C) or
// conjugated (J).
enum GemmOp { kN = 0, kT = 1, kC = 2, kJ = 3 };

__device__ __forceinline__ bool op_transposed(int op) { return op == kT || op == kC; }

// op(M)[r, c]; ld is M's row stride.
template <typename T>
__device__ __forceinline__ T op_load(const T* M, int64_t ld, int op, int64_t r, int64_t c) {
  const T x = op_transposed(op) ? M[c * ld + r] : M[r * ld + c];
  return op == kC || op == kJ ? Ops<T>::conj(x) : x;
}

// The depth range [kbeg, kend) of the 64 x 64 output tile (blockIdx.y,
// blockIdx.x) of op(A) op(B) into acc (4 x 4 per thread).
template <typename T>
__device__ __forceinline__ void gemm_tile(int64_t M, int64_t N, int64_t kbeg, int64_t kend,
                                          const T* __restrict__ A, int64_t lda, int opa,
                                          const T* __restrict__ B, int64_t ldb, int opb,
                                          T (&As)[kBK][kBM + 1], T (&Bs)[kBK][kBN + 1],
                                          T (&acc)[4][4]) {
  using O = Ops<T>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBN;
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) acc[r][c] = O::zero();
  for (int64_t k0 = kbeg; k0 < kend; k0 += kBK) {
    // neighbouring threads take neighbouring addresses of the stored operand
    for (int q = 0; q < kBK * kBM / kGemmThreads; ++q) {
      const int e = threadIdx.x + q * kGemmThreads;
      const bool ta = op_transposed(opa);
      const int kk = ta ? e / kBM : e % kBK, i = ta ? e % kBM : e / kBK;
      const int64_t r = row0 + i, c = k0 + kk;
      As[kk][i] = r < M && c < kend ? op_load(A, lda, opa, r, c) : O::zero();
    }
    for (int q = 0; q < kBK * kBN / kGemmThreads; ++q) {
      const int e = threadIdx.x + q * kGemmThreads;
      const bool tb = op_transposed(opb);
      const int kk = tb ? e % kBK : e / kBN, j = tb ? e / kBK : e % kBN;
      const int64_t r = k0 + kk, c = col0 + j;
      Bs[kk][j] = r < kend && c < N ? op_load(B, ldb, opb, r, c) : O::zero();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T a[4], b[4];
      for (int r = 0; r < 4; ++r) a[r] = As[kk][ty + 16 * r];
      for (int c = 0; c < 4; ++c) b[c] = Bs[kk][tx + 16 * c];
      for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) acc[r][c] = O::madd(acc[r][c], a[r], b[c]);
    }
    __syncthreads();
  }
}

// C = (accumulate ? C : 0) + alpha op(A) op(B); op(A) is M x K, op(B) K x N.
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_op_kernel(int64_t M, int64_t N, int64_t K, const T* __restrict__ A, int64_t lda, int opa,
            const T* __restrict__ B, int64_t ldb, int opb, T* __restrict__ C, int64_t ldc,
            typename Ops<T>::Real alpha, int accumulate) {
  using O = Ops<T>;
  __shared__ T As[kBK][kBM + 1];
  __shared__ T Bs[kBK][kBN + 1];
  T acc[4][4];
  gemm_tile(M, N, 0, K, A, lda, opa, B, ldb, opb, As, Bs, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBN;
  for (int r = 0; r < 4; ++r) {
    const int64_t i = row0 + ty + 16 * r;
    if (i >= M) continue;
    for (int c = 0; c < 4; ++c) {
      const int64_t j = col0 + tx + 16 * c;
      if (j >= N) continue;
      const T v = O::scale(acc[r][c], alpha);
      C[i * ldc + j] = accumulate ? O::add(C[i * ldc + j], v) : v;
    }
  }
}

template <typename T>
int gemm(int64_t M, int64_t N, int64_t K, const T* A, int64_t lda, int opa, const T* B, int64_t ldb,
         int opb, T* C, int64_t ldc, double alpha, bool accumulate, cudaStream_t st) {
  if (M <= 0 || N <= 0) return 0;
  const dim3 grid(blocks_for(N, kBN), blocks_for(M, kBM));
  gemm_op_kernel<T><<<grid, kGemmThreads, 0, st>>>(M, N, K, A, lda, opa, B, ldb, opb, C, ldc,
                                                static_cast<typename Ops<T>::Real>(alpha),
                                                accumulate ? 1 : 0);
  return last_error();
}

// ---- deterministic split-K (B11/B12's deep, narrow panel products)
//
// A product with few output tiles and a deep K (V^H A0: nb rows; Q V: nb
// columns) leaves most SMs idle on gemm's grid. gemm_split cuts K into S
// slices of at least kSplitMinDepth, so that tiles x S reaches
// kSplitBlocks; slice z writes its own M x N partial (row-major) to scratch
// and sum_slices_kernel adds the partials in slice order 0 .. S - 1. No
// atomics: the same shapes give the same S and the same bits, call after
// call.

constexpr int kSplitBlocks = 2 * 132;  // two blocks per SM of the H100's 132
constexpr int kSplitMinDepth = 128;

// The depth of each slice (a multiple of kBK; the last may be shorter) for
// an M x N x K product whose partials may take `capacity` scalars.
inline int64_t split_depth(int64_t M, int64_t N, int64_t K, int64_t capacity) {
  const int64_t tiles = static_cast<int64_t>(blocks_for(N, kBN)) * blocks_for(M, kBM);
  int64_t slices = (kSplitBlocks + tiles - 1) / tiles;
  if (slices > K / kSplitMinDepth) slices = K / kSplitMinDepth;
  if (slices > capacity / (M * N)) slices = capacity / (M * N);
  if (slices < 1) slices = 1;
  const int64_t depth = (K + slices - 1) / slices;
  return depth < kBK ? kBK : (depth + kBK - 1) / kBK * kBK;
}

// The partial of slice blockIdx.z, depth [z kdepth, min(K, (z + 1) kdepth)),
// into P + z M N (row-major, unscaled).
template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
gemm_slices_kernel(int64_t M, int64_t N, int64_t K, int64_t kdepth, const T* __restrict__ A,
                   int64_t lda, int opa, const T* __restrict__ B, int64_t ldb, int opb,
                   T* __restrict__ P) {
  __shared__ T As[kBK][kBM + 1];
  __shared__ T Bs[kBK][kBN + 1];
  T acc[4][4];
  const int64_t kbeg = static_cast<int64_t>(blockIdx.z) * kdepth;
  const int64_t kend = kbeg + kdepth < K ? kbeg + kdepth : K;
  gemm_tile(M, N, kbeg, kend, A, lda, opa, B, ldb, opb, As, Bs, acc);
  T* __restrict__ part = P + static_cast<int64_t>(blockIdx.z) * M * N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * kBN;
  for (int r = 0; r < 4; ++r) {
    const int64_t i = row0 + ty + 16 * r;
    if (i >= M) continue;
    for (int c = 0; c < 4; ++c) {
      const int64_t j = col0 + tx + 16 * c;
      if (j < N) part[i * N + j] = acc[r][c];
    }
  }
}

// C = (accumulate ? C : 0) + alpha (P_0 + P_1 + ... + P_{S-1}), in that order.
template <typename T>
__global__ void sum_slices_kernel(int64_t M, int64_t N, int slices, const T* __restrict__ P,
                                  T* __restrict__ C, int64_t ldc, typename Ops<T>::Real alpha,
                                  int accumulate) {
  using O = Ops<T>;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= M * N) return;
  T acc = P[e];
  for (int z = 1; z < slices; ++z) acc = O::add(acc, P[z * M * N + e]);
  const int64_t i = e / N, j = e % N;
  const T v = O::scale(acc, alpha);
  C[i * ldc + j] = accumulate ? O::add(C[i * ldc + j], v) : v;
}

// gemm's product by deterministic split-K: two launches (none when M or N
// is 0). P holds `capacity` >= M N scalars of partials.
template <typename T>
int gemm_split(int64_t M, int64_t N, int64_t K, const T* A, int64_t lda, int opa, const T* B,
               int64_t ldb, int opb, T* C, int64_t ldc, double alpha, bool accumulate, T* P,
               int64_t capacity, cudaStream_t st) {
  if (M <= 0 || N <= 0) return 0;
  const int64_t kdepth = split_depth(M, N, K, capacity);
  const int slices = K > 0 ? static_cast<int>((K + kdepth - 1) / kdepth) : 1;
  const dim3 grid(blocks_for(N, kBN), blocks_for(M, kBM), slices);
  gemm_slices_kernel<T><<<grid, kGemmThreads, 0, st>>>(M, N, K, kdepth, A, lda, opa, B, ldb, opb,
                                                       P);
  if (int rc = last_error()) return rc;
  sum_slices_kernel<T><<<blocks_for(M * N, kThreads), kThreads, 0, st>>>(
      M, N, slices, P, C, ldc, static_cast<typename Ops<T>::Real>(alpha), accumulate ? 1 : 0);
  return last_error();
}

}  // namespace
