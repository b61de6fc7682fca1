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
//    (max(|re|, |im|)), the column's rows of the current block and its
//    pending sums are scaled by 1e-18 and the column's event count rises by
//    one (:220-236); each block records the counts it was written at, rows of
//    lower blocks enter the block's product scaled by 1e-18^(count now -
//    count then) (:152-170), and a last pass brings every block's rows to the
//    final count (:331-337).
//
// What bounds it, and what the design does about it. The rows of a column
// depend on each other in sequence, the columns not at all. Blocks of BR
// rows (BlockRows: 128 in float2, 64 in double2) are taken bottom-up, two
// launches each:
//  * below_gemm_kernel: the contribution of the rows below the block,
//    racc = T[block, below] Y[below, :]. This is the O(n^3) part, ~n^3/6
//    complex multiply-adds in all, which bounds the kernel by operations at
//    large n. 64 x 64 output tiles, 4 x 4 a thread in registers, FMA in the
//    working precision (no tensor cores, so no TF32), the T and Y tiles
//    double-buffered in shared memory by cp.async; the event factor is
//    applied to Y's values as they leave shared memory. Y is upper
//    triangular, so a column tile stops its depth at its last column. The
//    block has one row tile of output (two at BR = 128), so the depth is cut
//    into slices of a fixed depth that give the grid about two blocks an SM;
//    each slice writes its own partial (no atomics), and the solve adds them
//    in slice order, so Y repeats bit for bit.
//  * block_solve_kernel: a warp per column. The block's rows are spread over
//    the lanes (BR / 32 a lane) with their pending sums in registers; at
//    step i every lane forms its own row's candidate (clamp, mask, divide)
//    (-r / den, with -1 / den formed before the chain) and the lane that
//    owns row i hands y_i to the warp by __shfl_sync; the
//    1e18 test on it is then the same in every lane; every lane adds
//    T[j, i] y_i to its rows j < i. The block's diagonal BR x BR triangle of
//    T is staged in shared memory once per block of eight column-warps,
//    transposed so that a step reads one contiguous row. The chain of a block
//    is BR steps of multiply + shuffle + FMA, in registers: no round trip
//    through memory. The warps' columns leave through shared memory so that Y
//    is written by rows.
//  * The 2 n / BR launches are chained by programmatic dependent launch, so
//    that a launch's start overlaps the end of the one before (the solve
//    stages its triangle of T before it waits).
// The TPU's 16-row windows, its column split and its padding are VMEM layout
// and have no counterpart. No row or column outside [0, n) is ever read.
//
// Plain C interface for ctypes: the entry point selects the device, launches
// on the caller's stream and returns the first CUDA error (0 on success),
// checked after every launch.

#include "eig_common.cuh"

namespace {

constexpr int kSolveWarps = 8;        // columns a block of block_solve_kernel
constexpr int kTm = 64, kTn = 64, kTk = 16;  // below_gemm_kernel's tile
constexpr int kMaxSlices = 16;        // depth slices of a product, at most
constexpr int kMinSliceDepth = 64;    // rows of Y a slice, at least
// Blocks the slices aim at: two an SM of the H100. A constant, not the
// card's SM count, because the slices fix the order in which Y's sums are
// added: the same Y on every card.
constexpr int kSliceBlocks = 2 * 132;
constexpr double kBig = 1e18;    // rescale threshold (trisolve_vec.py:58)
constexpr double kSmall = 1e-18;  // rescale factor (:59)

// Rows a block, from the sweep over 32, 64 and 128 on the H100 (PERF.md):
// 128 is fastest in float2; double2 takes 64, since its 128-row triangle
// would need 264 KB of shared memory. BLOCK_ROWS of ops/trisolve_vec.py.
template <typename T>
struct BlockRows;
template <>
struct BlockRows<float2> {
  static constexpr int value = 128;
};
template <>
struct BlockRows<double2> {
  static constexpr int value = 64;
};

// The factor that brings a row written at `delta` fewer events to the
// current scale (trisolve_vec.py:162-165): 1, 1e-18, 1e-36, else 0.
template <typename R>
__device__ __forceinline__ R event_factor(int delta) {
  return delta <= 0 ? R(1) : delta == 1 ? R(kSmall) : delta == 2 ? R(kSmall) * R(kSmall) : R(0);
}

// The depth of each slice of the product below the block [b1, e1): a
// multiple of 64 (so that a 16-row step never crosses a block of Y), at
// least kMinSliceDepth, with at most kMaxSlices slices.
inline int64_t slice_depth(int64_t n, int64_t e1, int br) {
  const int64_t depth = n - e1;
  const int64_t tiles = static_cast<int64_t>(blocks_for(n - e1, kTn)) * blocks_for(br, kTm);
  int64_t slices = (kSliceBlocks + tiles - 1) / tiles;
  if (slices > kMaxSlices) slices = kMaxSlices;
  int64_t d = (depth + slices - 1) / slices;
  if (d < kMinSliceDepth) d = kMinSliceDepth;
  return (d + 63) / 64 * 64;
}

// The slices that hold column k's partials: those that start before the
// end of k's column tile (Y[j, k] = 0 for j > k).
__device__ __forceinline__ int slices_of(int64_t k, int64_t n, int64_t e1, int64_t depth) {
  const int64_t c0 = e1 + (k - e1) / kTn * kTn;
  const int64_t k_end = c0 + kTn < n ? c0 + kTn : n;
  return static_cast<int>((k_end - e1 + depth - 1) / depth);
}

// P[z][k][r] = sum over slice z of the depth j >= e1 of
// T[b1 + r, j] Y[j, k] f(ccur[k] - cnt[j / BR, k]), r < BR, k in [e1, n).
template <typename T, int BR>
__global__ void __launch_bounds__(kThreads)
below_gemm_kernel(const T* __restrict__ Tm, const T* __restrict__ Y, const int* __restrict__ cnt,
                  const int* __restrict__ ccur, T* __restrict__ P, int64_t n, int64_t b1,
                  int64_t e1, int64_t depth) {
  using O = Ops<T>;
  using R = typename O::Real;
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // [2][kTm][kTk]
  T* Bs = As + 2 * kTm * kTk;          // [2][kTk][kTn]
  const int t = threadIdx.x, tx = t % 16, ty = t / 16;
  const int64_t col0 = e1 + static_cast<int64_t>(blockIdx.x) * kTn;
  const int row0 = blockIdx.y * kTm;
  const int64_t k_end = col0 + kTn < n ? col0 + kTn : n;  // Y[j, k] = 0 for j > k
  const int64_t kbeg = e1 + static_cast<int64_t>(blockIdx.z) * depth;
  wait_previous();  // Y, the counts and P's last reader
  start_next();
  if (kbeg >= k_end) return;  // the solve reads no partial of this slice here
  const int64_t kend = kbeg + depth < k_end ? kbeg + depth : k_end;
  auto stage = [&](int buf, int64_t k0) {
#pragma unroll
    for (int q = 0; q < kTm * kTk / kThreads; ++q) {
      const int e = t + q * kThreads, r = e / kTk, kk = e % kTk;
      const int64_t j = k0 + kk;
      const bool valid = row0 + r < BR && j < kend;
      cp_async_elem<sizeof(T)>(&As[(buf * kTm + r) * kTk + kk],
                               valid ? Tm + (b1 + row0 + r) * n + j : Tm, valid);
    }
#pragma unroll
    for (int q = 0; q < kTk * kTn / kThreads; ++q) {
      const int e = t + q * kThreads, kk = e / kTn, c = e % kTn;
      const int64_t j = k0 + kk, col = col0 + c;
      const bool valid = j < kend && col < n;
      cp_async_elem<sizeof(T)>(&Bs[(buf * kTk + kk) * kTn + c], valid ? Y + j * n + col : Y,
                               valid);
    }
    cp_async_commit();
  };
  T acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = O::zero();
  R f[4];
  int64_t f_block = -1;
  bool scaled = false;
  stage(0, kbeg);
  int buf = 0;
  for (int64_t k0 = kbeg; k0 < kend; k0 += kTk) {
    if (k0 + kTk < kend) {
      stage(buf ^ 1, k0 + kTk);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (k0 / BR != f_block) {  // the factors of this block of Y's rows
      f_block = k0 / BR;
      bool any = false;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int64_t col = col0 + tx + 16 * c;
        f[c] = col < n ? event_factor<R>(ccur[col] - cnt[f_block * n + col]) : R(1);
        any = any || f[c] != R(1);
      }
      scaled = __any_sync(0xffffffffu, any);
    }
#pragma unroll
    for (int kk = 0; kk < kTk; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[(buf * kTm + ty + 16 * r) * kTk + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        b[c] = Bs[(buf * kTk + kk) * kTn + tx + 16 * c];
        if (scaled) b[c] = O::scale(b[c], f[c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = O::madd(acc[r][c], a[r], b[c]);
    }
    __syncthreads();
    buf ^= 1;
  }
  // out through shared memory, so that P[z][k][r] is written along r
  T* E = reinterpret_cast<T*>(smem);  // [kTn][kTm + 1]
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) E[(tx + 16 * c) * (kTm + 1) + ty + 16 * r] = acc[r][c];
  __syncthreads();
  T* __restrict__ part = P + static_cast<int64_t>(blockIdx.z) * n * BR;
  for (int e = t; e < kTn * kTm; e += kThreads) {
    const int c = e / kTm, r = e % kTm;
    const int64_t col = col0 + c;
    if (row0 + r < BR && col < n) part[col * BR + row0 + r] = E[c * (kTm + 1) + r];
  }
}

// The rows [b1, e1) of every column k >= b1, a warp per column; the
// partials P hold the rows below (columns >= e1 only). Records the column's
// event count in ccur and cnt[block].
template <typename T, int BR>
__global__ void __launch_bounds__(kSolveWarps * 32)
block_solve_kernel(const T* __restrict__ Tm, T* __restrict__ Y, const T* __restrict__ P,
                   int* __restrict__ cnt, int* __restrict__ ccur, int64_t n, int64_t b1,
                   int64_t e1, int64_t depth, typename Ops<T>::Real eps) {
  using O = Ops<T>;
  using R = typename O::Real;
  constexpr int kRows = BR / 32;  // rows a lane: lane + 32 q
  constexpr int kStride = BR + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Td = reinterpret_cast<T*>(smem);  // Td[i][j] = T[b1 + j, b1 + i], j <= i
  T* Ys = Td + BR * kStride;           // [BR][kSolveWarps]
  const int m = static_cast<int>(e1 - b1);
  for (int e = threadIdx.x; e < m * m; e += blockDim.x) {  // T only: before the wait
    const int j = e / m, i = e % m;
    if (j <= i) cp_async_elem<sizeof(T)>(&Td[i * kStride + j], &Tm[(b1 + j) * n + b1 + i], true);
  }
  cp_async_commit();
  wait_previous();  // P, Y and the counts
  start_next();
  cp_async_wait<0>();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t kbase = b1 + static_cast<int64_t>(blockIdx.x) * kSolveWarps;
  const int64_t k = kbase + warp;
  if (k < n) {  // warp-uniform
    const T lam = Tm[k * n + k];
    T acc[kRows], yv[kRows], w[kRows];  // w = -conj(den) / |den|^2 = -1 / den
    const int slices = k >= e1 ? slices_of(k, n, e1, depth) : 0;
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = lane + 32 * q;
      acc[q] = O::zero();
      yv[q] = O::zero();
      for (int z = 0; z < slices && r < m; ++z)  // in slice order
        acc[q] = O::add(acc[q], P[(static_cast<int64_t>(z) * n + k) * BR + r]);
      T den = O::sub(Td[(r < m ? r : 0) * kStride + (r < m ? r : 0)], lam);
      if (O::abs2(den) < eps * eps) den = O::make(eps, R(0));
      R dd = O::abs2(den);
      if (dd == R(0)) dd = R(1);
      w[q] = O::divr(O::conj(den), -dd);
    }
    int events = 0;
#pragma unroll
    for (int li = BR - 1; li >= 0; --li) {
      if (li >= m) continue;
      const int q = li / 32, owner = li % 32;
      const int64_t i = b1 + li;
      T y;
      if (i < k) {  // -r / den, formed by the owner of row i
        const T cand = O::madd(O::zero(), acc[q], w[q]);
        y = O::make(__shfl_sync(0xffffffffu, O::re(cand), owner),
                    __shfl_sync(0xffffffffu, O::im(cand), owner));
      } else {
        y = i == k ? O::one() : O::zero();
      }
      if (fmax(fabs(O::re(y)), fabs(O::im(y))) > R(kBig)) {  // the same in every lane
#pragma unroll
        for (int q2 = 0; q2 < kRows; ++q2) {
          acc[q2] = O::scale(acc[q2], R(kSmall));
          yv[q2] = O::scale(yv[q2], R(kSmall));
        }
        ++events;
        y = O::scale(y, R(kSmall));
      }
      if (lane == owner) yv[q] = y;
#pragma unroll
      for (int q2 = 0; q2 < kRows; ++q2) {  // the block's rows above i
        if (32 * q2 >= li) continue;
        const int r2 = lane + 32 * q2;
        if (r2 < li) acc[q2] = O::madd(acc[q2], Td[li * kStride + r2], y);
      }
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int r = lane + 32 * q;
      if (r < m) Ys[r * kSolveWarps + warp] = yv[q];
    }
    if (lane == 0) {
      const int c = ccur[k] + events;
      ccur[k] = c;
      cnt[(b1 / BR) * n + k] = c;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < m * kSolveWarps; e += blockDim.x) {
    const int r = e / kSolveWarps, w = e % kSolveWarps;
    if (kbase + w < n) Y[(b1 + r) * n + kbase + w] = Ys[e];
  }
}

// Y[i, k] *= 1e-18^(cnt[0, k] - cnt[i / BR, k]): every block's rows at the
// column's final scale (trisolve_vec.py:331-337).
template <typename T>
__global__ void final_scale_kernel(T* __restrict__ Y, const int* __restrict__ cnt, int64_t n,
                                   int br) {
  using O = Ops<T>;
  using R = typename O::Real;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n * n) return;
  const int64_t i = e / n, k = e % n;
  const int delta = cnt[k] - cnt[(i / br) * n + k];
  if (delta != 0) Y[e] = O::scale(Y[e], pow(R(kSmall), R(delta)));
}

template <typename T>
int run_trisolve(const T* t, T* y, T* racc, int* counts, int64_t n, double eps, cudaStream_t st) {
  using R = typename Ops<T>::Real;
  constexpr int BR = BlockRows<T>::value;
  const int64_t nblk = (n + BR - 1) / BR;
  int* cnt = counts;               // nblk x n
  int* ccur = counts + nblk * n;   // n
  const int gemm_smem = static_cast<int>(sizeof(T)) * kTn * (kTm + 1);  // >= the two stages
  const int solve_smem = static_cast<int>(sizeof(T)) * BR * (BR + 1 + kSolveWarps);
  if (int rc = allow_dynamic_smem<below_gemm_kernel<T, BR>>(gemm_smem)) return rc;
  if (int rc = allow_dynamic_smem<block_solve_kernel<T, BR>>(solve_smem)) return rc;
  cudaMemsetAsync(y, 0, n * n * sizeof(T), st);
  if (int rc = last_error()) return rc;
  cudaMemsetAsync(counts, 0, (nblk + 1) * n * sizeof(int), st);
  if (int rc = last_error()) return rc;
  for (int64_t b = nblk - 1; b >= 0; --b) {
    const int64_t b1 = b * BR, e1 = b1 + BR < n ? b1 + BR : n;
    int64_t depth = 1;
    if (e1 < n) {
      depth = slice_depth(n, e1, BR);
      const dim3 grid(blocks_for(n - e1, kTn), blocks_for(BR, kTm),
                      static_cast<unsigned>((n - e1 + depth - 1) / depth));
      if (int rc = launch_chained(below_gemm_kernel<T, BR>, grid, kThreads, gemm_smem, true, st, t,
                                  y, cnt, ccur, racc, n, b1, e1, depth))
        return rc;
    }
    if (int rc = launch_chained(block_solve_kernel<T, BR>, dim3(blocks_for(n - b1, kSolveWarps)),
                                kSolveWarps * 32, solve_smem, true, st, t, y,
                                static_cast<const T*>(racc), cnt, ccur, n, b1, e1, depth,
                                static_cast<R>(eps)))
      return rc;
  }
  final_scale_kernel<T><<<blocks_for(n * n, kThreads), kThreads, 0, st>>>(y, cnt, n, BR);
  return last_error();
}

}  // namespace

extern "C" {

// B14: y = the unnormalised eigenvectors of the upper-triangular complex
// n x n matrix t (column k pairs with t[k, k]), in blocks of
// trisolve_block_rows(dtype) rows; racc holds trisolve_scratch(dtype, n)
// scalars, counts (ceil(n / rows) + 1) x n int32.
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

// The rows a block of trisolve_eigenvectors for the dtype (0 for a dtype
// it does not take).
int trisolve_block_rows(int dtype) {
  return dtype == kC64 ? BlockRows<float2>::value : dtype == kC128 ? BlockRows<double2>::value : 0;
}

// The partials' scratch of trisolve_eigenvectors, in scalars.
long long trisolve_scratch(int dtype, long long n) {
  return static_cast<long long>(kMaxSlices) * trisolve_block_rows(dtype) * (n > 0 ? n : 1);
}

}  // extern "C"
