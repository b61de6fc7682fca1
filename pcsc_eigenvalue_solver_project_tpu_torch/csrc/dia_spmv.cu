// Banded (DIA) sparse matrix-vector products for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/dia_spmv.py:
//   B2  _dia_kernel (:36)             -> dia_rowmajor_kernel on real types
//   B3  _dia_complex_kernel (:73)     -> dia_rowmajor_kernel on float2/double2
//   B1  _dia_il_kernel (:390) and
//       _dia_il_kernel_stream (:535)  -> dia_il_window_kernel
//   B3  on split planes (:73, the SplitComplexDIA entry) and
//   B4  _dia_il_planes_kernel (:577) and
//       _dia_il_planes_kernel_stream (:603)
//                                     -> dia_planes_kernel, row-major and
//                                        interleaved-window index modes
//   B5  _dia_block_kernel (:223), _dia_il_block_kernel (:695) and
//       _dia_il_block_kernel_stream (:558)
//                                     -> dia_block_kernel, the same two modes
//
// What bounds them: bytes. An SpMV over k diagonals of n rows does 2*k*n
// flops and must move k*n*sizeof(val) + 2*n*sizeof(x) bytes (every diagonal
// value once, x once, y once): a fraction of a flop per byte, far below the
// H100's ridge point. So the design spends nothing on arithmetic and keeps
// the memory stream dense:
//   * one thread per output element, neighbouring threads on neighbouring
//     elements, so each warp's load of a diagonal and of x is one coalesced
//     stream;
//   * each diagonal value is read exactly once;
//   * x (or the haloed window w) is re-read by up to k neighbouring rows;
//     those re-reads hit L1/L2, so device memory sees x about once;
//   * the sum stays in a register (f32 for f32 and bf16 diagonals, f64 for
//     f64), and y is written once.
// The TPU mechanics (lane rolls, sublane-residue plans, the (8, 128) tiling,
// the VMEM streaming split) have no counterpart: here a shift by any offset
// is an address, and one kernel serves both TPU variants of B1.
//
// The split-plane kernel (B4, B3 on planes) reads re and im of a diagonal
// entry k*m elements apart and re and im of x one plane apart: no float2
// pairs exist in that layout, so each plane is its own coalesced stream and
// the product is four FMAs into two accumulators. The block kernel (B5)
// multiplies the band by nvec vectors: each thread keeps one accumulator per
// vector of a chunk of up to kChunk vectors in registers and reads its
// diagonal entry once per chunk, so the diagonals, the dominant stream,
// cross device memory ceil(nvec / kChunk) times instead of nvec times. A
// chunk is blockIdx.y; the last one may be ragged.
//
// Plain C interface for ctypes: each entry point selects the device, launches
// on the caller's stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kLanes = 128;

// Stored diagonal value -> accumulation type.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ double2 widen(double2 v) { return v; }

template <typename A>
__device__ __forceinline__ A zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ double zero<double>() { return 0.0; }
template <>
__device__ __forceinline__ float2 zero<float2>() { return make_float2(0.0f, 0.0f); }
template <>
__device__ __forceinline__ double2 zero<double2>() { return make_double2(0.0, 0.0); }

// acc + v * x; complex values carry (re, im) in (.x, .y): four FMAs.
__device__ __forceinline__ float madd(float acc, float v, float x) { return fmaf(v, x, acc); }
__device__ __forceinline__ double madd(double acc, double v, double x) { return fma(v, x, acc); }
__device__ __forceinline__ float2 madd(float2 acc, float2 v, float2 x) {
  acc.x = fmaf(v.x, x.x, acc.x);
  acc.x = fmaf(-v.y, x.y, acc.x);
  acc.y = fmaf(v.x, x.y, acc.y);
  acc.y = fmaf(v.y, x.x, acc.y);
  return acc;
}
__device__ __forceinline__ double2 madd(double2 acc, double2 v, double2 x) {
  acc.x = fma(v.x, x.x, acc.x);
  acc.x = fma(-v.y, x.y, acc.x);
  acc.y = fma(v.x, x.y, acc.y);
  acc.y = fma(v.y, x.x, acc.y);
  return acc;
}

// B2/B3: y[i] = sum_d vals[d, i] * x[i + offsets[d]], with the terms whose
// column i + offsets[d] leaves [0, n) skipped (they are zero by the storage
// convention). vals is (k, n) row-major; all indices are 64-bit.
template <typename V, typename A>
__global__ void __launch_bounds__(kThreads)
dia_rowmajor_kernel(const V* __restrict__ vals, const A* __restrict__ x,
                    const int* __restrict__ offsets, int k, int64_t n,
                    A* __restrict__ y) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  A acc = zero<A>();
  for (int d = 0; d < k; ++d) {
    const int64_t j = i + offsets[d];
    if (j >= 0 && j < n) acc = madd(acc, widen(vals[d * n + i]), x[j]);
  }
  y[i] = acc;
}

// B1: y[s, l] = sum_d vals_il[d, s, l] * w[pr + s + offsets[d], l] on the
// lane-major layout: vals_il is (k, R, 128), w the haloed window
// (R + 2*pr, 128), y is (R, 128). For the flat element e = s*128 + l the
// window element is e + (pr + offsets[d]) * 128, always inside w because
// |offsets[d]| <= pr, so the loop carries no bounds test.
template <typename V, typename A>
__global__ void __launch_bounds__(kThreads)
dia_il_window_kernel(const V* __restrict__ vals, const A* __restrict__ w,
                     const int* __restrict__ offsets, int k, int pr, int64_t m,
                     A* __restrict__ y) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= m) return;
  A acc = zero<A>();
  for (int d = 0; d < k; ++d) {
    const int64_t shift = static_cast<int64_t>(pr + offsets[d]) * kLanes;
    acc = madd(acc, widen(vals[d * m + e]), w[e + shift]);
  }
  y[e] = acc;
}

// Where element e of the output reads its vector: row-major, x[e + off]
// when that column lies in [0, m) (else the term is skipped); interleaved
// window, w[e + (pr + off) * 128], always inside the window.
template <bool kWindow>
__device__ __forceinline__ bool source(int64_t e, int off, int pr, int64_t m, int64_t* j) {
  if (kWindow) {
    *j = e + static_cast<int64_t>(pr + off) * kLanes;
    return true;
  }
  *j = e + off;
  return *j >= 0 && *j < m;
}

// B4 / B3 on planes: vals (2, k, m), x (2, *) with plane stride x_plane,
// y (2, m); real planes (f32, bf16 or f64), the sum in A.
template <typename V, typename A, bool kWindow>
__global__ void __launch_bounds__(kThreads)
dia_planes_kernel(const V* __restrict__ vals, const A* __restrict__ x,
                  const int* __restrict__ offsets, int k, int pr, int64_t m,
                  int64_t x_plane, A* __restrict__ y) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const V* __restrict__ vals_im = vals + static_cast<int64_t>(k) * m;
  A re = zero<A>(), im = zero<A>();
  for (int d = 0; d < k; ++d) {
    int64_t j;
    if (!source<kWindow>(e, offsets[d], pr, m, &j)) continue;
    const A vr = widen(vals[d * m + e]);
    const A vi = widen(vals_im[d * m + e]);
    const A xr = x[j];
    const A xi = x[x_plane + j];
    re = madd(re, vr, xr);
    re = madd(re, -vi, xi);
    im = madd(im, vr, xi);
    im = madd(im, vi, xr);
  }
  y[e] = re;
  y[m + e] = im;
}

constexpr int kChunk = 8;  // vectors per register chunk of the block kernel

// B5: y[v, e] = sum_d vals[d, e] * x[v, source(e, d)] for the vectors v of
// chunk blockIdx.y; x has vector stride x_vec, y is (nvec, m).
template <typename V, typename A, bool kWindow>
__global__ void __launch_bounds__(kThreads)
dia_block_kernel(const V* __restrict__ vals, const A* __restrict__ x,
                 const int* __restrict__ offsets, int k, int pr, int64_t m,
                 int64_t x_vec, int nvec, A* __restrict__ y) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const int c0 = static_cast<int>(blockIdx.y) * kChunk;
  const int count = min(kChunk, nvec - c0);
  const A* __restrict__ xc = x + c0 * x_vec;
  A acc[kChunk];
#pragma unroll
  for (int v = 0; v < kChunk; ++v) acc[v] = zero<A>();
  for (int d = 0; d < k; ++d) {
    int64_t j;
    if (!source<kWindow>(e, offsets[d], pr, m, &j)) continue;
    const A val = widen(vals[d * m + e]);
#pragma unroll
    for (int v = 0; v < kChunk; ++v)
      if (v < count) acc[v] = madd(acc[v], val, xc[v * x_vec + j]);
  }
  A* __restrict__ yc = y + c0 * m;
#pragma unroll
  for (int v = 0; v < kChunk; ++v)
    if (v < count) yc[v * m + e] = acc[v];
}

unsigned grid_for(int64_t count) {
  return static_cast<unsigned>((count + kThreads - 1) / kThreads);
}

template <typename V, typename A>
int launch_rowmajor(const void* vals, const void* x, const void* offsets, int k,
                    int64_t n, void* y, cudaStream_t stream) {
  dia_rowmajor_kernel<V, A><<<grid_for(n), kThreads, 0, stream>>>(
      static_cast<const V*>(vals), static_cast<const A*>(x),
      static_cast<const int*>(offsets), k, n, static_cast<A*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename A>
int launch_il_window(const void* vals, const void* w, const void* offsets, int k,
                     int pr, int64_t m, void* y, cudaStream_t stream) {
  dia_il_window_kernel<V, A><<<grid_for(m), kThreads, 0, stream>>>(
      static_cast<const V*>(vals), static_cast<const A*>(w),
      static_cast<const int*>(offsets), k, pr, m, static_cast<A*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename A>
int launch_planes(int window, const void* vals, const void* x, const void* offsets, int k,
                  int pr, int64_t m, int64_t x_plane, void* y, cudaStream_t stream) {
  auto kernel = window ? dia_planes_kernel<V, A, true> : dia_planes_kernel<V, A, false>;
  kernel<<<grid_for(m), kThreads, 0, stream>>>(
      static_cast<const V*>(vals), static_cast<const A*>(x),
      static_cast<const int*>(offsets), k, pr, m, x_plane, static_cast<A*>(y));
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename A>
int launch_block(int window, const void* vals, const void* x, const void* offsets, int k,
                 int pr, int64_t m, int64_t x_vec, int nvec, void* y, cudaStream_t stream) {
  auto kernel = window ? dia_block_kernel<V, A, true> : dia_block_kernel<V, A, false>;
  const dim3 grid(grid_for(m), static_cast<unsigned>((nvec + kChunk - 1) / kChunk));
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(vals), static_cast<const A*>(x),
      static_cast<const int*>(offsets), k, pr, m, x_vec, nvec, static_cast<A*>(y));
  return static_cast<int>(cudaGetLastError());
}

// Stored-type codes shared with ops/dia_spmv.py (_DTYPE_CODES).
enum DTypeCode { kF32 = 0, kBF16 = 1, kF64 = 2, kC64 = 3, kC128 = 4 };

}  // namespace

extern "C" {

// Row-major banded SpMV (B2, and B3 for the complex codes). The output type
// is the accumulation type: f32 for f32/bf16, f64, complex64, complex128.
int dia_rowmajor_spmv(int dtype, int device, const void* vals, const void* x,
                      const void* offsets, int k, long long n, void* y,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_rowmajor<float, float>(vals, x, offsets, k, n, y, s);
    case kBF16: return launch_rowmajor<__nv_bfloat16, float>(vals, x, offsets, k, n, y, s);
    case kF64: return launch_rowmajor<double, double>(vals, x, offsets, k, n, y, s);
    case kC64: return launch_rowmajor<float2, float2>(vals, x, offsets, k, n, y, s);
    case kC128: return launch_rowmajor<double2, double2>(vals, x, offsets, k, n, y, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Interleaved banded SpMV from a haloed window (B1); m = R * 128 outputs.
int dia_il_window_spmv(int dtype, int device, const void* vals, const void* w,
                       const void* offsets, int k, int pr, long long m, void* y,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_il_window<float, float>(vals, w, offsets, k, pr, m, y, s);
    case kBF16: return launch_il_window<__nv_bfloat16, float>(vals, w, offsets, k, pr, m, y, s);
    case kF64: return launch_il_window<double, double>(vals, w, offsets, k, pr, m, y, s);
    case kC64: return launch_il_window<float2, float2>(vals, w, offsets, k, pr, m, y, s);
    case kC128: return launch_il_window<double2, double2>(vals, w, offsets, k, pr, m, y, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Split-plane complex SpMV (B4 with window = 1 on the interleaved layout,
// m = R * 128; B3's planes entry with window = 0, m = n). Real plane types
// only; the output is the accumulation type.
int dia_planes_spmv(int dtype, int device, const void* vals, const void* x,
                    const void* offsets, int k, int pr, long long m, long long x_plane,
                    int window, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_planes<float, float>(window, vals, x, offsets, k, pr, m, x_plane, y, s);
    case kBF16:
      return launch_planes<__nv_bfloat16, float>(window, vals, x, offsets, k, pr, m, x_plane, y, s);
    case kF64: return launch_planes<double, double>(window, vals, x, offsets, k, pr, m, x_plane, y, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Banded block SpMM (B5): nvec vectors of stride x_vec; window as above.
int dia_block_spmm(int dtype, int device, const void* vals, const void* x,
                   const void* offsets, int k, int pr, long long m, long long x_vec, int nvec,
                   int window, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m <= 0 || nvec <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_block<float, float>(window, vals, x, offsets, k, pr, m, x_vec, nvec, y, s);
    case kBF16:
      return launch_block<__nv_bfloat16, float>(window, vals, x, offsets, k, pr, m, x_vec, nvec,
                                                y, s);
    case kF64:
      return launch_block<double, double>(window, vals, x, offsets, k, pr, m, x_vec, nvec, y, s);
    case kC64:
      return launch_block<float2, float2>(window, vals, x, offsets, k, pr, m, x_vec, nvec, y, s);
    case kC128:
      return launch_block<double2, double2>(window, vals, x, offsets, k, pr, m, x_vec, nvec, y,
                                            s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* dia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
