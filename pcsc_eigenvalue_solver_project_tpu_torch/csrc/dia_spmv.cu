// Banded (DIA) sparse matrix-vector products for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/dia_spmv.py:
//   B2  _dia_kernel (:36)             -> dia_rowmajor_kernel on real types
//   B3  _dia_complex_kernel (:73)     -> dia_rowmajor_kernel on float2/double2
//   B1  _dia_il_kernel (:390) and
//       _dia_il_kernel_stream (:535)  -> dia_il_window_kernel
//       and, for the power loop, dia_il_window_kernel_power (the
//       product and the step's vector work in one launch) with its
//       one-block power_finish_kernel
//   B3  on split planes (:73, the SplitComplexDIA entry) and
//   B4  _dia_il_planes_kernel (:577) and
//       _dia_il_planes_kernel_stream (:603)
//                                     -> dia_planes_kernel, row-major and
//                                        interleaved-window index modes
//   B5  _dia_block_kernel (:223), _dia_il_block_kernel (:695) and
//       _dia_il_block_kernel_stream (:558)
//                                     -> dia_block_staged_kernel (x tiles in
//                                        shared memory), or dia_block_kernel
//                                        for bands too wide for a tile; the
//                                        same two modes
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
// the product is four FMAs into two accumulators. The block kernels (B5)
// multiply the band by nvec vectors: each thread keeps its accumulators for
// a chunk of up to kChunk vectors in registers and reads its diagonal
// entries once per chunk, so the diagonals, the dominant stream, cross
// device memory ceil(nvec / kChunk) times instead of nvec times. A chunk is
// blockIdx.y; the last one may be ragged. The staged kernel (below) keeps
// the chunk's x in shared memory, since reading it k times through L1, at
// unaligned addresses, is what bounded the first port (PERF.md).
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

// B1's power-step form: one iteration of the power method on the
// interleaved layout, the product and the vector work of the step in one
// launch. The pair zz (2, R, 128) holds the products z; the step reads
// z = zz[src] and the scale s = 1/||z|| (1 where z is zero), writes
// z_new = A (s z) to zz[1 - src] once, and leaves each block's partial sums
// of x_new . z_new and z_new . z_new, x_new = s z, in partials (2, blocks).
// The host passes the halves as pointers: src is the step's parity, which
// is the carry's cur whenever the step runs (cur flips with every kept
// iterate, and once one is not kept none runs again). As kernel arguments
// the halves' addresses are uniform across the grid; a read of cur by each
// thread before its first load cost a quarter of the step's speed on the
// H100 (PERF.md). The halo is read from z itself, predicated: row r + off
// outside [0, R) is row r + off -+ R of lane l -+ 1, zero past lane 0 or
// 127 (the window _il_window builds for dia_il_window_kernel, without
// building it); the selects keep every load unconditional. A block of 256
// threads takes kPowerRows rows, a thread lanes l and l + 64 of its row, so
// that a diagonal's index arithmetic, the same for the two, serves both (a
// thread an element ran ~4% slower). After done, or with a zero z pending
// (the next finish's breakdown), the step reads the flags and writes
// nothing. The sums run in a fixed order, so a step repeats bit for bit.
constexpr int kCtlK = 0, kCtlDone = 1, kCtlInitialized = 2, kCtlConverged = 3, kCtlUsed = 4,
              kCtlCur = 5, kCtlZero = 6;  // ctl, int32 (ops/dia_spmv.py: CTL_*)
constexpr int kScS = 0, kScSx = 1, kScLam = 2;  // sc, float32 (SC_*)
constexpr int kPowerRows = kThreads / (kLanes / 2);  // rows a block (POWER_BLOCK / 128)

template <typename V>
__global__ void __launch_bounds__(kThreads)
dia_il_window_kernel_power(const V* __restrict__ vals, const float* __restrict__ z,
                           float* __restrict__ out, const int* __restrict__ offsets, int k,
                           int64_t rows, const int* __restrict__ ctl,
                           const float* __restrict__ sc, float* __restrict__ partials) {
  if (ctl[kCtlDone] | ctl[kCtlZero]) return;
  const float s = sc[kScS];
  const int64_t m = rows * kLanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kPowerRows + threadIdx.x / 64;
  const int lane = threadIdx.x % 64;  // and lane + 64
  float acc0 = 0.0f, acc1 = 0.0f, p = 0.0f, q = 0.0f;
  if (row < rows) {
    const int64_t e = row * kLanes + lane;
    const int64_t wrap = m - 1;  // from row r + off -+ R of lane l to lane l -+ 1
    const V* v = vals + e;
#pragma unroll 9
    for (int d = 0; d < k; ++d) {
      const int off = __ldg(offsets + d);
      const int64_t r = row + off;
      const bool lo = r < 0, hi = r >= rows;
      const int64_t j = e + static_cast<int64_t>(off) * kLanes + (lo ? wrap : (hi ? -wrap : 0));
      const bool in0 = !(lo && lane == 0), in1 = !(hi && lane == 63);
      const float x0 = __ldg(z + (in0 ? j : e));
      const float x1 = __ldg(z + (in1 ? j + 64 : e));
      acc0 = fmaf(widen(v[0]), in0 ? x0 * s : 0.0f, acc0);
      acc1 = fmaf(widen(v[64]), in1 ? x1 * s : 0.0f, acc1);
      v += m;
    }
    out[e] = acc0;
    out[e + 64] = acc1;
    p = __ldg(z + e) * s * acc0 + __ldg(z + e + 64) * s * acc1;
    q = acc0 * acc0 + acc1 * acc1;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    p += __shfl_down_sync(0xffffffffu, p, o);
    q += __shfl_down_sync(0xffffffffu, q, o);
  }
  __shared__ float warp_p[kThreads / 32], warp_q[kThreads / 32];
  if (threadIdx.x % 32 == 0) {
    warp_p[threadIdx.x / 32] = p;
    warp_q[threadIdx.x / 32] = q;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sp = 0.0f, sq = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) {
      sp += warp_p[w];
      sq += warp_q[w];
    }
    partials[blockIdx.x] = sp;
    partials[gridDim.x + blockIdx.x] = sq;
  }
}

// The power step's scalar finish, one block: sums the step's partials in a
// fixed order (each thread a strided run in double, by fours where the
// count allows, then a tree), then
// updates the loop's carry as solvers/power.py::power_carry_loop's body
// does. Nothing after done. A zero z pending is the breakdown: k and used
// advance, done is set, nothing is kept. Else lambda_new = x_new . z_new,
// converged by is_close_relative (the difference and the scale in float32,
// tol in float64, after the first kept iterate), the kept x becomes
// s * zz[cur] (sx = s), cur flips to the new z, and s becomes 1/||z_new||
// (1, with the zero flag, where z_new is zero). init = 1 finishes the
// product A x0 of the start: only x = 1 * x0, cur, s and the zero flag.
constexpr int kFinishThreads = 1024;

__global__ void __launch_bounds__(kFinishThreads)
power_finish_kernel(const float* __restrict__ partials, int64_t blocks, int* __restrict__ ctl,
                    float* __restrict__ sc, double tol, int init) {
  const int t = threadIdx.x;
  if (ctl[kCtlDone]) return;
  if (ctl[kCtlZero] && !init) {
    if (t == 0) {
      ctl[kCtlK] += 1;
      ctl[kCtlUsed] = ctl[kCtlK];
      ctl[kCtlDone] = 1;
    }
    return;
  }
  double p = 0.0, q = 0.0;
  if (blocks % 4 == 0) {  // 16-byte loads, 8 in flight a thread
    const float4* p4 = reinterpret_cast<const float4*>(partials);
    const float4* q4 = reinterpret_cast<const float4*>(partials + blocks);
#pragma unroll 4
    for (int64_t b = t; b < blocks / 4; b += kFinishThreads) {
      const float4 a = p4[b], c = q4[b];
      p += (static_cast<double>(a.x) + a.y) + (static_cast<double>(a.z) + a.w);
      q += (static_cast<double>(c.x) + c.y) + (static_cast<double>(c.z) + c.w);
    }
  } else {
    for (int64_t b = t; b < blocks; b += kFinishThreads) {
      p += partials[b];
      q += partials[blocks + b];
    }
  }
  __shared__ double sum_p[kFinishThreads], sum_q[kFinishThreads];
  sum_p[t] = p;
  sum_q[t] = q;
  __syncthreads();
  for (int h = kFinishThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      sum_p[t] += sum_p[t + h];
      sum_q[t] += sum_q[t + h];
    }
    __syncthreads();
  }
  if (t != 0) return;
  if (!init) {
    const float lam_new = static_cast<float>(sum_p[0]);
    const float diff = fabsf(lam_new - sc[kScLam]);
    const float scale = 1.0f + fabsf(lam_new);
    const int conv = ctl[kCtlInitialized] && static_cast<double>(diff) <= tol * scale;
    ctl[kCtlK] += 1;
    ctl[kCtlUsed] = ctl[kCtlK];
    ctl[kCtlInitialized] = 1;
    ctl[kCtlConverged] |= conv;
    ctl[kCtlDone] = conv;
    sc[kScLam] = lam_new;
  }
  const float norm = static_cast<float>(sqrt(sum_q[0]));
  sc[kScSx] = sc[kScS];
  ctl[kCtlCur] = 1 - ctl[kCtlCur];
  ctl[kCtlZero] = norm == 0.0f;
  sc[kScS] = norm == 0.0f ? 1.0f : 1.0f / norm;
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

constexpr int kChunk = 8;  // vectors per register chunk of the block kernels

// B5, the direct route (bands too wide for the staged kernel's tile):
// y[v, e] = sum_d vals[d, e] * x[v, source(e, d)] for the vectors v of chunk
// blockIdx.y, a thread a row, x read through L1/L2. Vector v's element j
// lies at x[v * xv + j * xi] and y's at y[v * yv + e * yi] (window mode:
// xi = yi = 1, j the flat window index; kUnit when xi = yi = 1).
template <typename V, typename A, bool kWindow, bool kUnit>
__global__ void __launch_bounds__(kThreads)
dia_block_kernel(const V* __restrict__ vals, const A* __restrict__ x,
                 const int* __restrict__ offsets, int k, int pr, int64_t m, int64_t xv,
                 int64_t xi, int64_t yv, int64_t yi, int nvec, A* __restrict__ y) {
  if (kUnit) xi = yi = 1;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= m) return;
  const int c0 = static_cast<int>(blockIdx.y) * kChunk;
  const int count = min(kChunk, nvec - c0);
  const A* __restrict__ xc = x + c0 * xv;
  A acc[kChunk];
#pragma unroll
  for (int v = 0; v < kChunk; ++v) acc[v] = zero<A>();
  for (int d = 0; d < k; ++d) {
    int64_t j;
    if (!source<kWindow>(e, offsets[d], pr, m, &j)) continue;
    const A val = widen(vals[d * m + e]);
#pragma unroll
    for (int v = 0; v < kChunk; ++v)
      if (v < count) acc[v] = madd(acc[v], val, xc[v * xv + j * xi]);
  }
  A* __restrict__ yc = y + c0 * yv;
#pragma unroll
  for (int v = 0; v < kChunk; ++v)
    if (v < count) yc[v * yv + e * yi] = acc[v];
}

// B5, the staged route. A block of 256 threads owns a tile of rows and
// stages x of its chunk of vectors over the rows the tile's band reaches,
// [tile + min offset, tile + max offset + rows), in shared memory, by
// coalesced loads that zero what lies outside the vector. Each thread then
// computes kRows consecutive rows (16 bytes of A: 4 in float, 2 in double
// and complex float, 1 in complex double) of every vector of the chunk:
//  * row-major: the tile is 256 kRows consecutive rows; the thread's rows
//    are consecutive in memory, so it reads each diagonal with one 16-byte
//    load (8 bytes for bf16) where n is a multiple of kRows; x is held at
//    padded positions (one spare element after every 128 bytes), so that
//    the threads of a warp, kRows elements apart, hit distinct banks;
//  * interleaved window: the tile is 32 lanes by 8 kRows sublanes; the
//    thread's rows are kRows consecutive sublanes of one lane, and x is held
//    as [sublane][32 lanes], so a warp reads 32 consecutive words.
// For each diagonal the thread keeps, per vector, a register window of the
// kRows x values its rows read: when the offset is the previous one plus 1
// (a band's consecutive diagonals) the window moves by one and one new value
// is read from shared memory, else all kRows are. So each x element is read
// about (k + kRows - 1) / kRows times from shared memory, not k times through
// L1, and each diagonal crosses device memory once per chunk of 8 vectors.
// Terms whose column leaves the matrix (row-major) read a zeroed x and, in
// the tiles at either end, a zeroed value. blockIdx.x is the tile (window: tile * 4 + lane slab),
// blockIdx.y the chunk of vectors. x's element (v, position p) is at
// x[v * xv + p * xi] (window: xi = 128, plus the lane), y's likewise.
template <typename A>
struct Staged {
  static constexpr int kRows = static_cast<int>(16 / sizeof(A));
  static constexpr int kPeriod = 128 / static_cast<int>(sizeof(A));  // row-major padding
  static constexpr int kSpan = kThreads * kRows;  // row-major tile, rows
  static constexpr int kSub = (kThreads / 32) * kRows;  // window tile, sublanes
};

constexpr int kSlabLanes = 32;  // window tile, lanes
constexpr int kStages = 8;      // diagonals' values in flight: the shared-memory ring

__host__ __device__ constexpr int64_t padded(int64_t p, int period) { return p + p / period; }

// Elements of A a chunk's vector takes in the staged kernel's shared memory.
template <typename A>
__host__ __device__ int64_t staged_vector_elems(bool window, int span) {
  using S = Staged<A>;
  if (window) return static_cast<int64_t>(S::kSub + span) * kSlabLanes;
  return padded(S::kSpan + span, S::kPeriod) + 1;
}

// Where the ring of stored values starts in the staged kernel's shared
// memory: after the x tile of a chunk of min(nvec, 8) vectors, on 16 bytes.
template <typename A>
__host__ __device__ int64_t staged_ring_offset(bool window, int span, int nvec) {
  const int64_t tile = staged_vector_elems<A>(window, span) * (nvec < kChunk ? nvec : kChunk) *
                       static_cast<int64_t>(sizeof(A));
  return (tile + 15) / 16 * 16;
}

template <typename V, int kR>
struct alignas(sizeof(V) * kR) RowPack {
  V v[kR];
};

// The chunk's kChunk values at one position where the vectors are adjacent
// (an (n, nvec) block), moved by 16-byte loads and stores.
template <typename A>
struct alignas(16) ChunkPack {
  A v[kChunk];
};

// What the staged kernel may move by 16-byte loads and stores (decided by
// its launcher from the shapes, strides and alignment).
enum StagedVector { kVecVals = 1, kVecRows = 2, kVecChunk = 4 };

// An asynchronous copy of kBytes (4, 8 or 16) from global to shared memory,
// and the group bookkeeping that waits for them.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(kBytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <typename V, typename A, bool kWindow>
__global__ void __launch_bounds__(kThreads, 2)
dia_block_staged_kernel(const V* __restrict__ vals, const A* __restrict__ x,
                        const int* __restrict__ offsets, int k, int omin, int span, int pr,
                        int64_t len, int64_t x_len, int64_t xv, int64_t xi, int64_t yv,
                        int64_t yi, int nvec, int vec, A* __restrict__ y) {
  using S = Staged<A>;
  constexpr int kR = S::kRows;
  extern __shared__ __align__(16) unsigned char block_smem[];
  A* xs = reinterpret_cast<A*>(block_smem);
  const int c0 = static_cast<int>(blockIdx.y) * kChunk;
  const int count = min(kChunk, nvec - c0);
  const int t = threadIdx.x;
  const int64_t vs = staged_vector_elems<A>(kWindow, span);
  // the tile: its first position along the strip, and (window) its lanes
  const int64_t tile = kWindow ? blockIdx.x / (kLanes / kSlabLanes) : blockIdx.x;
  const int64_t l0 = kWindow ? (blockIdx.x % (kLanes / kSlabLanes)) * kSlabLanes : 0;
  const int64_t p0 = tile * (kWindow ? S::kSub : S::kSpan);
  // x's first staged position (window: a window sublane, pr above the output's)
  const int64_t q0 = p0 + omin + (kWindow ? pr : 0);
  const int positions = (kWindow ? S::kSub : S::kSpan) + span;
  const A* __restrict__ xc = x + c0 * xv;

  // the thread's rows: positions p0 + r0 + [0, kR) of strip lane l0 + lane
  const int lane = kWindow ? t % kSlabLanes : 0;
  const int r0 = (kWindow ? t / kSlabLanes : t) * kR;
  const int64_t row_stride = kWindow ? kLanes : 1;  // between consecutive positions
  const int64_t e0 = (p0 + r0) * row_stride + l0 + lane;  // the first row's flat index
  const int64_t m = kWindow ? len * kLanes : len;         // rows of a diagonal
  const bool full = p0 + r0 + kR <= len;
  // row-major tiles whose band reaches past either end of the vector skip
  // those terms (the old kernel's rule), by a zeroed value
  const bool edge = !kWindow && (p0 + omin < 0 || p0 + S::kSpan - 1 + omin + span >= len);

  // the rows' stored values of the next kStages - 1 diagonals are in flight
  // (cp.async into this thread's own slot of a ring in shared memory, so no
  // barrier guards it) while one is in use; each diagonal is one copy group
  using Slot = RowPack<V, kR>;
  Slot* ring = reinterpret_cast<Slot*>(block_smem + staged_ring_offset<A>(kWindow, span, nvec)) +
               t;  // stage p at ring[p * kThreads]
  auto fetch = [&](int d) {
    Slot* slot = ring + (d % kStages) * kThreads;
    const V* vd = vals + d * m + e0;
    if (!kWindow && (vec & kVecVals) && full) {
      cp_async<sizeof(Slot)>(slot, vd);
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (p0 + r0 + r >= len) {
          slot->v[r] = V{};
        } else if constexpr (sizeof(V) >= 4) {
          cp_async<sizeof(V)>(&slot->v[r], vd + r * row_stride);
        } else {
          slot->v[r] = vd[r * row_stride];
        }
      }
    }
  };
#pragma unroll
  for (int p = 0; p + 1 < kStages; ++p) {
    if (p < k) fetch(p);
    cp_async_commit();
  }

  // stage x: element (v, position q0 + i) of the chunk, in memory order
  // (32-bit indices: a tile holds at most a few hundred thousand elements)
  auto stage = [&](int v, int i, int lane) {
    const int64_t q = q0 + i;
    xs[v * vs + (kWindow ? i * kSlabLanes + lane : padded(i, S::kPeriod))] =
        q >= 0 && q < x_len ? xc[v * xv + q * xi + l0 + lane] : zero<A>();
  };
  const bool chunk_packs = !kWindow && (vec & kVecChunk) && count == kChunk;
  if (kWindow || xi == 1) {
    const int per_vector = positions * (kWindow ? kSlabLanes : 1);
    for (int v = 0; v < count; ++v)
      for (int g = t; g < per_vector; g += kThreads)
        stage(v, kWindow ? g / kSlabLanes : g, kWindow ? g % kSlabLanes : 0);
  } else if (chunk_packs) {  // a position's 8 values in 16-byte loads
    for (int i = t; i < positions; i += kThreads) {
      const int64_t q = q0 + i;
      ChunkPack<A> pack;
      if (q >= 0 && q < x_len) {
        pack = *reinterpret_cast<const ChunkPack<A>*>(xc + q * xi);
      } else {
#pragma unroll
        for (int v = 0; v < kChunk; ++v) pack.v[v] = zero<A>();
      }
#pragma unroll
      for (int v = 0; v < kChunk; ++v) xs[v * vs + padded(i, S::kPeriod)] = pack.v[v];
    }
  } else {  // the vectors of a position are adjacent (xv == 1)
    const unsigned c = static_cast<unsigned>(count);
    for (unsigned g = t; g < c * positions; g += kThreads) stage(g % c, g / c, 0);
  }
  __syncthreads();

  A acc[kChunk][kR], win[kChunk][kR];
#pragma unroll
  for (int v = 0; v < kChunk; ++v)
#pragma unroll
    for (int r = 0; r < kR; ++r) acc[v][r] = zero<A>();
  int prev = 0;
  for (int d = 0; d < k; ++d) {
    if (d + kStages - 1 < k) fetch(d + kStages - 1);  // into the slot diagonal d - 1 left
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // diagonal d's group is in
    const Slot raw = ring[(d % kStages) * kThreads];
    const int off = __ldg(offsets + d);
    A val[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) val[r] = widen(raw.v[r]);
    if (edge) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int64_t col = p0 + r0 + r + off;
        if (col < 0 || col >= len) val[r] = zero<A>();
      }
    }
    // the window of x for this offset: positions r0 + r + off - omin
    const int base = r0 + off - omin;
    const bool slide = d > 0 && off == prev + 1;
    prev = off;
#pragma unroll
    for (int v = 0; v < kChunk; ++v) {
      if (v >= count) continue;
      const A* xv_s = xs + v * vs;
      if (slide) {
#pragma unroll
        for (int r = 0; r + 1 < kR; ++r) win[v][r] = win[v][r + 1];
        const int i = base + kR - 1;
        win[v][kR - 1] = xv_s[kWindow ? i * kSlabLanes + lane : padded(i, S::kPeriod)];
      } else {
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int i = base + r;
          win[v][r] = xv_s[kWindow ? i * kSlabLanes + lane : padded(i, S::kPeriod)];
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[v][r] = madd(acc[v][r], val[r], win[v][r]);
    }
  }
  cp_async_wait<0>();
  A* __restrict__ yc = y + c0 * yv;
  if (chunk_packs) {  // a row's 8 values in 16-byte stores
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (p0 + r0 + r >= len) continue;
      ChunkPack<A> pack;
#pragma unroll
      for (int v = 0; v < kChunk; ++v) pack.v[v] = acc[v][r];
      *reinterpret_cast<ChunkPack<A>*>(yc + (p0 + r0 + r) * yi) = pack;
    }
    return;
  }
#pragma unroll
  for (int v = 0; v < kChunk; ++v) {
    if (v >= count) continue;
    if (!kWindow && (vec & kVecRows) && full) {  // the thread's rows in one 16-byte store
      RowPack<A, kR> pack;
#pragma unroll
      for (int r = 0; r < kR; ++r) pack.v[r] = acc[v][r];
      *reinterpret_cast<RowPack<A, kR>*>(yc + v * yv + p0 + r0) = pack;
      continue;
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (p0 + r0 + r < len) yc[v * yv + (p0 + r0 + r) * yi + (kWindow ? l0 + lane : 0)] = acc[v][r];
  }
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

template <typename V>
int launch_il_power(const void* vals, void* zz, int src, const void* offsets, int k,
                    int64_t rows, const void* ctl, const void* sc, void* partials,
                    cudaStream_t stream) {
  if (src != 0 && src != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t m = rows * kLanes;
  const unsigned blocks = static_cast<unsigned>((rows + kPowerRows - 1) / kPowerRows);
  dia_il_window_kernel_power<V><<<blocks, kThreads, 0, stream>>>(
      static_cast<const V*>(vals), static_cast<const float*>(zz) + src * m,
      static_cast<float*>(zz) + (1 - src) * m, static_cast<const int*>(offsets), k, rows,
      static_cast<const int*>(ctl), static_cast<const float*>(sc), static_cast<float*>(partials));
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

// The staged kernel's dynamic shared memory: the x tile of a chunk of
// min(8, nvec) vectors, each staged_vector_elems elements, then the ring of
// kStages diagonals' stored values, 16 bytes of A's rows a thread.
template <typename V, typename A>
int64_t staged_smem(bool window, int span, int nvec) {
  return staged_ring_offset<A>(window, span, nvec) +
         static_cast<int64_t>(kStages) * kThreads * sizeof(RowPack<V, Staged<A>::kRows>);
}

constexpr int kStagedSmemBudget = 160 * 1024;

template <typename V, typename A>
int launch_block(int window, int staged, const void* vals, const void* x, const void* offsets,
                 int k, int omin, int omax, int pr, int64_t len, int64_t x_len, int64_t xv,
                 int64_t xi, int64_t yv, int64_t yi, int nvec, int64_t smem, void* y,
                 cudaStream_t stream) {
  const unsigned chunks = static_cast<unsigned>((nvec + kChunk - 1) / kChunk);
  const int64_t m = window ? len * kLanes : len;
  if (!staged) {
    auto kernel = xi == 1 && yi == 1
        ? (window ? dia_block_kernel<V, A, true, true> : dia_block_kernel<V, A, false, true>)
        : (window ? dia_block_kernel<V, A, true, false> : dia_block_kernel<V, A, false, false>);
    kernel<<<dim3(grid_for(m), chunks), kThreads, 0, stream>>>(
        static_cast<const V*>(vals), static_cast<const A*>(x),
        static_cast<const int*>(offsets), k, pr, m, xv, xi, yv, yi, nvec, static_cast<A*>(y));
    return static_cast<int>(cudaGetLastError());
  }
  using S = Staged<A>;
  const int span = omax - omin;
  if (span < 0 || smem != staged_smem<V, A>(window, span, nvec) || smem > kStagedSmemBudget ||
      (window && (xi != kLanes || yi != kLanes)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = window ? dia_block_staged_kernel<V, A, true> : dia_block_staged_kernel<V, A, false>;
  static bool allowed[64][2] = {};  // once per device: out of CUDA graph captures
  int device = 0;
  cudaGetDevice(&device);
  if (device >= 64 || !allowed[device][window]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStagedSmemBudget);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    if (device < 64) allowed[device][window] = true;
  }
  const int64_t tiles = window ? (len + S::kSub - 1) / S::kSub * (kLanes / kSlabLanes)
                               : (len + S::kSpan - 1) / S::kSpan;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int64_t elem = static_cast<int64_t>(sizeof(A));
  const int vec = window ? 0
      : (len % S::kRows == 0 && aligned(vals) ? kVecVals : 0) |
        (yi == 1 && len % S::kRows == 0 && aligned(y) ? kVecRows : 0) |
        (xv == 1 && yv == 1 && xi * elem % 16 == 0 && yi * elem % 16 == 0 && aligned(x) &&
                 aligned(y) ? kVecChunk : 0);
  kernel<<<dim3(static_cast<unsigned>(tiles), chunks), kThreads, smem, stream>>>(
      static_cast<const V*>(vals), static_cast<const A*>(x), static_cast<const int*>(offsets), k,
      omin, span, pr, len, x_len, xv, xi, yv, yi, nvec, vec, static_cast<A*>(y));
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

// B1's power step on the interleaved layout: float32 (dtype kF32) or bf16
// (kBF16) diagonals (k, R, 128), the float32 pair zz (2, R, 128) read from
// half src (0 or 1), the carry ctl (int32) and sc (float32), partials
// (2, ceil(R / 4)).
int dia_il_power_step(int dtype, int device, const void* vals, void* zz, int src,
                      const void* offsets, int k, long long rows, const void* ctl,
                      const void* sc, void* partials, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_il_power<float>(vals, zz, src, offsets, k, rows, ctl, sc, partials, s);
    case kBF16:
      return launch_il_power<__nv_bfloat16>(vals, zz, src, offsets, k, rows, ctl, sc, partials,
                                            s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The power step's scalar finish: one block over the step's partials.
int dia_il_power_finish(int device, const void* partials, long long blocks, void* ctl, void* sc,
                        double tol, int init, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  power_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), blocks, static_cast<int*>(ctl),
      static_cast<float*>(sc), tol, init);
  return static_cast<int>(cudaGetLastError());
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

// Banded block SpMM (B5). Row-major (window = 0): len = n rows, x's
// element (v, j) at x[v * xv + j * xi] for j in [0, x_len = n), y's (v, i)
// at y[v * yv + i * yi]. Interleaved window (window = 1): len = R sublanes,
// x the haloed windows (nvec, R + 2 pr, 128) with xv their vector stride,
// x_len = R + 2 pr; y (nvec, R, 128) with yv its vector stride; xi = yi = 128
// on the staged route, 1 on the direct one. staged picks the staged kernel
// (smem its dynamic shared memory, which must be what this file reckons) or
// the direct one; omin and omax are the least and greatest offsets.
int dia_block_spmm(int dtype, int device, const void* vals, const void* x, const void* offsets,
                   int k, int omin, int omax, int pr, long long len, long long x_len,
                   long long xv, long long xi, long long yv, long long yi, int nvec, int window,
                   int staged, long long smem, void* y, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (len <= 0 || nvec <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLOCK_ARGS window, staged, vals, x, offsets, k, omin, omax, pr, len, x_len, xv, xi, yv, yi, \
                   nvec, smem, y, s
  switch (dtype) {
    case kF32: return launch_block<float, float>(BLOCK_ARGS);
    case kBF16: return launch_block<__nv_bfloat16, float>(BLOCK_ARGS);
    case kF64: return launch_block<double, double>(BLOCK_ARGS);
    case kC64: return launch_block<float2, float2>(BLOCK_ARGS);
    case kC128: return launch_block<double2, double2>(BLOCK_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BLOCK_ARGS
}

const char* dia_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
