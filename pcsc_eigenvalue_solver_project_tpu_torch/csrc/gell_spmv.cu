// General (unstructured) sparse matrix-vector product for NVIDIA Hopper
// (sm_90a): y = A x over a row-sorted CSR pack, duplicates summed.
//
// Replaces the Pallas TPU kernels of
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/gell_spmv.py:
//   B6      _gell_kernel (:356, via _gell_tiles_pallas :397)
//                                   -> gell_real_kernel, and gell_complex_kernel
//                                      on native complex vectors
//   B6 cpx  _gell_kernel_cpx (:367, via _gell_tiles_pallas_cpx :428)
//                                   -> gell_complex_kernel in planes mode
//
// The TPU pack (lane buckets, the segment word with its suffix-scan mask
// bits, the int8 inverse permutation, the transposed x, the chunk lists and
// the COO spill tail) exists for the TPU's 128-lane gather and its VMEM.
// None of it is carried over: here a gather is an address, so the pack is
// plain CSR (indptr, indices, values) built from the same COO, on the host
// or on the card (ops/gell_spmv.py::pack_gell).
//
// What bounds it: bytes. Each stored entry does one multiply-add (four for
// complex data) and must move its value and its column index; x and y move
// once each. That is a fraction of a flop per byte, far below the H100's
// ridge point, so the design keeps the entry streams dense and spends
// nothing on arithmetic:
//   * a group of G lanes (G = 4, 8, 16 or 32, the smallest power of two at
//     or above the mean row length) handles one row, so a row's indices and
//     values are read by neighbouring lanes in one coalesced stream, and
//     each is read exactly once;
//   * each lane strides over the row's entries by G and gathers x[col]
//     through the read-only cache (__ldg); x is re-read by every row that
//     holds the column, and those re-reads hit L2 (x at 1M columns in f32 is
//     4 MB, the L2 holds 50 MB), though every 4-byte gather still moves a
//     32-byte sector;
//   * the sum stays in a register (f32 for f32 and bf16 values, f64 for f64
//     and complex128), the group reduces it with __shfl_down_sync, and its
//     first lane writes y[row] once.
// Every lane of a warp reaches the shuffles, the lanes of rows past the end
// with a zero sum, so the full mask is always right. Entry offsets are int64
// from the first add on: indptr holds up to 2^31 - 1 entries, and a row
// that starts within G of that would wrap an int32 start + lane.
//
// Long rows (real values). One group a row leaves a hub row's entries to G
// lanes: a Graph 500 SCALE-26 graph has a row of 1,004,611 entries, ~31,000
// gathers a lane on one warp, and 313,912 rows of more than 1024 entries
// that hold 55% of its entries. Their gathers reach all of x (268 MB, 5x the
// L2) and miss it. So the pack cuts its long rows into chunks, one block a
// chunk, in the same launch (ops/gell_spmv.py's GELLSplit, built with the
// pack, which sets the threshold, the chunk size and the windows): a chunk
// holds entries of one row within one window of columns, and the chunks run
// window by window, so the blocks resident at once gather from one window
// of x, not from all of it:
//   * the chunk blocks take the lowest blockIdx values, block b chunk
//     order[b]; the group-per-row blocks follow and skip the rows longer
//     than long_row;
//   * a chunk block sums its entries (each thread every kThreads-th entry
//     in order, then the warps' shuffle trees and the 8 warp sums in
//     order), writes one partial to its chunk's slot, fences, and counts
//     itself in the row's counter;
//   * the block that arrives last sums the row's partials in chunk order,
//     which is entry order, writes y[row] and sets the counter back to 0 for
//     the next call.
// The order of every sum is fixed, so y repeats bit for bit whatever order
// the blocks run in; y takes no atomics and is never zero-filled. A pack
// with no long row launches the group-per-row blocks alone. Calls that share
// a split run in stream order (its counters and partials are the pack's).
//
// Complex values are (re, im) pairs of f32, bf16 or f64. In native mode x and
// y are complex64/complex128 tensors, read as float2/double2; in planes mode
// x is (2, n_cols) real planes x_plane elements apart and y is (2, n_rows).
//
// Plain C interface for ctypes: the entry point selects the device, launches
// on the caller's stream and returns cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// Stored value -> accumulation type.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

// The (re, im) pair of entry k, widened.
__device__ __forceinline__ void load_pair(const float* __restrict__ v, int64_t k, float* re,
                                          float* im) {
  const float2 p = reinterpret_cast<const float2*>(v)[k];
  *re = p.x;
  *im = p.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* __restrict__ v, int64_t k,
                                          float* re, float* im) {
  const __nv_bfloat162 p = reinterpret_cast<const __nv_bfloat162*>(v)[k];
  *re = __low2float(p);
  *im = __high2float(p);
}
__device__ __forceinline__ void load_pair(const double* __restrict__ v, int64_t k, double* re,
                                          double* im) {
  const double2 p = reinterpret_cast<const double2*>(v)[k];
  *re = p.x;
  *im = p.y;
}

__device__ __forceinline__ float madd(float v, float x, float acc) { return fmaf(v, x, acc); }
__device__ __forceinline__ double madd(double v, double x, double acc) { return fma(v, x, acc); }

template <typename A>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

// Sum over the G lanes of a group (G divides 32); lane 0 of the group holds it.
template <int G, typename A>
__device__ __forceinline__ A group_sum(A v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off, G);
  return v;
}

// The group's row and the lane's place in it.
template <int G>
__device__ __forceinline__ int64_t group_row() {
  return static_cast<int64_t>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
}

// The long rows of a pack and their chunks (ops/gell_spmv.py::GELLSplit);
// n_chunks = 0: none. A row is long above long_row entries. Chunk c belongs to long row i = chunk_row[c], row
// rows[i], whose chunks are [first[i], first[i + 1]), in entry order; it
// runs from entry chunk_start[c] to the next chunk's start (the row's end
// for its last). Block b runs chunk order[b]. partials holds one
// accumulator a chunk.
struct Split {
  int64_t n_chunks, long_row;
  const int* rows;
  const int* first;
  const int* chunk_row;
  const int64_t* chunk_start;
  const int* order;
  int* counters;
  void* partials;
};

// Chunk order[blockIdx.x] of a long row: its partial, and y[row] from the
// block that arrives last.
template <typename V, typename A>
__device__ __forceinline__ void long_row_chunk(const int* __restrict__ indptr,
                                               const int* __restrict__ indices,
                                               const V* __restrict__ vals,
                                               const A* __restrict__ x, A* __restrict__ y,
                                               const Split& s) {
  __shared__ A sums[kThreads];
  __shared__ bool last;
  const int c = s.order[blockIdx.x];
  const int i = s.chunk_row[c];
  const int row = s.rows[i];
  const int lo = s.first[i], hi = s.first[i + 1];
  const int64_t end = c + 1 < hi ? s.chunk_start[c + 1] : static_cast<int64_t>(indptr[row + 1]);
  A acc = A(0);
#pragma unroll 4
  for (int64_t k = s.chunk_start[c] + threadIdx.x; k < end; k += kThreads)
    acc = madd(widen(vals[k]), __ldg(x + indices[k]), acc);
  acc = group_sum<32>(acc);
  if ((threadIdx.x & 31) == 0) sums[threadIdx.x / 32] = acc;
  __syncthreads();
  A* partials = static_cast<A*>(s.partials);
  if (threadIdx.x == 0) {
    A part = A(0);
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) part += sums[w];
    partials[c] = part;
    __threadfence();  // the partial is in L2 before the count says so
    last = atomicAdd(s.counters + i, 1) == hi - lo - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The row's partials, kThreads at a time through shared memory, summed in
  // chunk order; __ldcg reads L2, where the other blocks wrote them.
  A total = A(0);
  for (int b = lo; b < hi; b += kThreads) {
    const int m = min(kThreads, hi - b);
    if (threadIdx.x < m) sums[threadIdx.x] = __ldcg(partials + b + threadIdx.x);
    __syncthreads();
    if (threadIdx.x == 0)
      for (int k = 0; k < m; ++k) total += sums[k];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    y[row] = total;
    s.counters[i] = 0;
  }
}

// B6, real values: y[r] = sum_{k in row r} vals[k] * x[indices[k]], a group
// of G lanes a row. kSplit: blocks [0, s.n_chunks) are the long rows'
// chunks, and the groups after them skip the long rows; without it (a pack
// with no long row) the launch is the groups alone.
template <typename V, typename A, int G, bool kSplit>
__global__ void __launch_bounds__(kThreads)
gell_real_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                 const V* __restrict__ vals, const A* __restrict__ x, int64_t n_rows,
                 A* __restrict__ y, const Split s) {
  int64_t block = blockIdx.x;
  if constexpr (kSplit) {
    if (block < s.n_chunks) {
      long_row_chunk<V, A>(indptr, indices, vals, x, y, s);
      return;
    }
    block -= s.n_chunks;
  }
  const int64_t row = block * (kThreads / G) + threadIdx.x / G;
  const int lane = threadIdx.x & (G - 1);
  A acc = A(0);
  bool mine = row < n_rows;
  if (mine) {
    const int64_t begin = indptr[row], end = indptr[row + 1];
    if constexpr (kSplit) mine = end - begin <= s.long_row;
    if (mine)
      for (int64_t k = begin + lane; k < end; k += G)
        acc = madd(widen(vals[k]), __ldg(x + indices[k]), acc);
  }
  acc = group_sum<G>(acc);
  if (lane == 0 && mine) y[row] = acc;
}

// B6 on complex values, four FMAs per entry. kPlanes: x is (2, n_cols) real
// planes x_plane apart and y (2, n_rows); else x and y are interleaved
// (re, im) pairs, native complex tensors.
template <typename V, typename A, int G, bool kPlanes>
__global__ void __launch_bounds__(kThreads)
gell_complex_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                    const V* __restrict__ vals, const A* __restrict__ x, int64_t x_plane,
                    int64_t n_rows, A* __restrict__ y) {
  using A2 = typename Vec2<A>::type;
  const int64_t row = group_row<G>();
  const int lane = threadIdx.x & (G - 1);
  A re = A(0), im = A(0);
  if (row < n_rows) {
    const int64_t end = indptr[row + 1];
    for (int64_t k = static_cast<int64_t>(indptr[row]) + lane; k < end; k += G) {
      A vr, vi, xr, xi;
      load_pair(vals, k, &vr, &vi);
      const int col = indices[k];
      if constexpr (kPlanes) {
        xr = __ldg(x + col);
        xi = __ldg(x + x_plane + col);
      } else {
        const A2 xv = __ldg(reinterpret_cast<const A2*>(x) + col);
        xr = xv.x;
        xi = xv.y;
      }
      re = madd(vr, xr, re);
      re = madd(-vi, xi, re);
      im = madd(vr, xi, im);
      im = madd(vi, xr, im);
    }
  }
  re = group_sum<G>(re);
  im = group_sum<G>(im);
  if (lane == 0 && row < n_rows) {
    if constexpr (kPlanes) {
      y[row] = re;
      y[n_rows + row] = im;
    } else {
      A2 out;
      out.x = re;
      out.y = im;
      reinterpret_cast<A2*>(y)[row] = out;
    }
  }
}

// Modes shared with ops/gell_spmv.py (_MODE_CODES).
enum Mode { kModeReal = 0, kModeComplex = 1, kModePlanes = 2 };

template <int G, typename V, typename A>
int launch(int mode, const int* indptr, const int* indices, const void* vals, const void* x,
           int64_t x_plane, int64_t n_rows, void* y, const Split& split, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>((n_rows * G + kThreads - 1) / kThreads);
  const V* v = static_cast<const V*>(vals);
  const A* xa = static_cast<const A*>(x);
  A* ya = static_cast<A*>(y);
  switch (mode) {
    case kModeReal:
      if (split.n_chunks > 0)
        gell_real_kernel<V, A, G, true>
            <<<grid + static_cast<unsigned>(split.n_chunks), kThreads, 0, s>>>(
                indptr, indices, v, xa, n_rows, ya, split);
      else
        gell_real_kernel<V, A, G, false><<<grid, kThreads, 0, s>>>(indptr, indices, v, xa,
                                                                   n_rows, ya, split);
      break;
    case kModeComplex:
      gell_complex_kernel<V, A, G, false><<<grid, kThreads, 0, s>>>(indptr, indices, v, xa, 0,
                                                                    n_rows, ya);
      break;
    case kModePlanes:
      gell_complex_kernel<V, A, G, true><<<grid, kThreads, 0, s>>>(indptr, indices, v, xa,
                                                                   x_plane, n_rows, ya);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename A>
int launch_group(int group, int mode, const int* indptr, const int* indices, const void* vals,
                 const void* x, int64_t x_plane, int64_t n_rows, void* y, const Split& split,
                 cudaStream_t s) {
#define LAUNCH(G) launch<G, V, A>(mode, indptr, indices, vals, x, x_plane, n_rows, y, split, s)
  switch (group) {
    case 4: return LAUNCH(4);
    case 8: return LAUNCH(8);
    case 16: return LAUNCH(16);
    case 32: return LAUNCH(32);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAUNCH
}

// Value-type codes shared with ops/gell_spmv.py (those of csrc/dia_spmv.cu).
enum DTypeCode { kF32 = 0, kBF16 = 1, kF64 = 2 };

}  // namespace

extern "C" {

// What a pack's launches share, set once per pack and entry by
// ops/gell_spmv.py (its _CSRArgs, the same fields in the same order), so that
// a call passes five arguments through ctypes, not twenty. From n_chunks
// on, the pack's long rows (Split; n_chunks = 0 and null pointers: none,
// and always so outside real mode).
struct GellCSRArgs {
  int dtype, device, mode, group;
  long long n_rows;
  const void* indptr;
  const void* indices;
  const void* values;
  long long n_chunks, long_row;
  const void* long_rows;
  const void* long_first;
  const void* chunk_row;
  const void* chunk_start;
  const void* chunk_order;
  void* counters;
  void* partials;
};

// General sparse SpMV (B6). dtype is the type of the stored values (of each
// half of a complex pair); x and y have the accumulation type: f32 for f32
// and bf16 values, f64 for f64 (complex: complex64 / complex128 in native
// mode, f32 / f64 planes in planes mode). group is the lanes per row.
int gell_csr_spmv(const GellCSRArgs* a, const void* x, long long x_plane, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->n_rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(a->indptr);
  const int* ix = static_cast<const int*>(a->indices);
  Split split{0, 0, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
  if (a->mode == kModeReal && a->n_chunks > 0)
    split = Split{a->n_chunks, a->long_row, static_cast<const int*>(a->long_rows),
                  static_cast<const int*>(a->long_first), static_cast<const int*>(a->chunk_row),
                  static_cast<const int64_t*>(a->chunk_start),
                  static_cast<const int*>(a->chunk_order), static_cast<int*>(a->counters),
                  a->partials};
#define CSR_ARGS a->group, a->mode, ip, ix, a->values, x, x_plane, a->n_rows, y, split, s
  switch (a->dtype) {
    case kF32: return launch_group<float, float>(CSR_ARGS);
    case kBF16: return launch_group<__nv_bfloat16, float>(CSR_ARGS);
    case kF64: return launch_group<double, double>(CSR_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CSR_ARGS
}

}  // extern "C"
