// General sparse SpMV over x windows staged in shared memory, for NVIDIA
// Hopper (sm_90a): the windowed route of B6 (ops/gell_spmv.py picks it or
// the CSR route of gell_spmv.cu per pack, by the rule in its docstring).
//
// Replaces, with gell_spmv.cu, the Pallas TPU kernels of
// pcsc_eigenvalue_solver_project_tpu/ops/pallas/gell_spmv.py:
//   B6      _gell_kernel (:356)      -> gell_window_kernel, real or native
//                                       complex mode
//   B6 cpx  _gell_kernel_cpx (:367)  -> gell_window_kernel, planes mode
// The TPU kernel never gathered x from HBM: it staged x in 16384-column
// chunks in VMEM and visited only the chunks a tile touches (chunk_ids,
// _gather_chunks). This is that design on the H100's shared memory.
//
// The pack (ops/gell_spmv.py::window_layout): rows are cut into ranges of R
// rows (about one range per SM that a cluster launch can hold), columns into
// windows of W columns (W x the bytes of an x element <= 64 KB). Inside a
// range the entries are ordered by (window, row, column); each carries one
// 32-bit word, local row << 16 | local column, and its value, so a stored
// entry is 8 bytes in f32 as in CSR. Ranges are grouped into clusters of
// 1, 2 or 4; each cluster has the union of the windows its ranges touch,
// and for every (union window, range) the range's first entry there.
//
// What bounds it: bytes. Where CSR gathers one 32-byte L2 sector for each
// 4- or 8-byte x value (two on planes), here each block stages the x
// windows its cluster touches into shared memory with TMA bulk copies
// (cp.async.bulk, completion on an mbarrier), and every gather of x is a
// shared-memory load. In a cluster of c blocks each block issues 1/c of a
// window as one copy multicast to all c blocks, so x moves from L2 once per
// cluster, not once per block. The copies are double-buffered: window u+1
// is in flight while the block works on window u (three or four buffers of
// smaller windows were slower, PERF.md). A block barrier per window makes the few plain-loaded edge words visible; between blocks of
// a cluster, each block arrives on an "empty" mbarrier of every peer when
// it is done with a buffer, and a peer waits on its own before it refills
// that buffer, so no cluster-wide barrier stands between two windows.
// The entry streams (word, value) are read once, coalesced, a chunk ahead
// in registers. Per-row partial sums live in shared memory: a warp's 32
// consecutive entries are reduced by runs of equal local row with a
// segmented shuffle scan, and each run makes one shared-memory add (an
// atomic one only for the runs at either end of the warp's entries, which
// may share a row with another warp), so a local pattern's 33-entry rows
// do not serialise on one address. y of
// the range is written once, coalesced, at the end.
//
// Complex values are (re, im) pairs; native mode reads float2/double2
// windows of x, planes mode two windows (re and im) where they lie, a plane
// stride apart, with no copy to a complex tensor. A bulk copy needs 16-byte
// aligned addresses and sizes, so each window is placed in its buffer at the
// source address's offset modulo 16: the aligned body goes by bulk copy, the
// few 4-byte words before and after it by plain loads. No entry, row or
// column outside the matrix is read.
//
// Plain C interface for ctypes: each entry point selects the device,
// launches on the caller's stream and returns the first CUDA error (0 on
// success).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // one block a range
constexpr int kUnroll = 4;      // entries a thread holds per chunk
constexpr int kChunk = kThreads * kUnroll;
constexpr int kStages = 2;                     // x window buffers
constexpr int kSmemBudget = 227 * 1024 - 1024;  // dynamic; the rest is static

// Modes and value codes shared with ops/gell_spmv.py (those of gell_spmv.cu).
enum Mode { kModeReal = 0, kModeComplex = 1, kModePlanes = 2 };
enum DTypeCode { kF32 = 0, kBF16 = 1, kF64 = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// The one arrival of a phase, expecting `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// bytes from global src to shared dst of this block, or of every block in
// `mask` of the cluster (same offsets), completing on `bar` there.
template <int kCluster>
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  if constexpr (kCluster == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
  } else {
    const uint16_t mask = (1u << kCluster) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;\n"
        ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "h"(mask) : "memory");
  }
}

// One arrival on `bar` at the same offset in block `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               ::"r"(remote) : "memory");
}

// A window of `bytes` at `src` is staged at buf + src % 16, so that its
// 16-byte aligned body [b0, b1) lands on 16-byte aligned shared memory.
struct Span {
  uint32_t pad, head, body, tail_from;
  __device__ Span(const char* src, uint32_t bytes) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t b0 = (a + 15) & ~uintptr_t(15), b1 = (a + bytes) & ~uintptr_t(15);
    pad = static_cast<uint32_t>(a & 15);
    body = b1 > b0 ? static_cast<uint32_t>(b1 - b0) : 0;
    head = body > 0 ? static_cast<uint32_t>(b0 - a) : bytes;
    tail_from = body > 0 ? static_cast<uint32_t>(b1 - a) : bytes;
  }
};

// The body of a window goes by kPieces bulk copies; the block of rank r
// issues pieces [r, r + 1) * kPieces / kCluster, thread q of it piece
// r * kPieces / kCluster + q, each multicast to the whole cluster.
constexpr int kPieces = 4;

template <int kCluster>
__device__ __forceinline__ void issue_body(char* buf, const char* src, const Span& sp,
                                           uint64_t* bar, int rank, int q) {
  const uint32_t per = ((sp.body + kPieces - 1) / kPieces + 15) & ~15u;
  const uint32_t lo = (rank * (kPieces / kCluster) + q) * per;
  const uint32_t hi = lo + per < sp.body ? lo + per : sp.body;
  if (hi > lo) bulk_copy<kCluster>(buf + sp.pad + sp.head + lo, src + sp.head + lo, hi - lo, bar);
}

// The words before and after the body, by plain loads into this block's buffer.
__device__ __forceinline__ void copy_edges(char* buf, const char* src, const Span& sp,
                                           uint32_t bytes) {
  const uint32_t words = sp.head / 4 + (bytes - sp.tail_from) / 4;
  for (uint32_t w = threadIdx.x; w < words; w += blockDim.x) {
    const uint32_t off = w < sp.head / 4 ? 4 * w : sp.tail_from + 4 * (w - sp.head / 4);
    *reinterpret_cast<uint32_t*>(buf + sp.pad + off) =
        __ldg(reinterpret_cast<const uint32_t*>(src + off));
  }
}

__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

// Stored value -> accumulation type.
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename V>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 widen2(float2 p) { return p; }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 widen2(__nv_bfloat162 p) {
    return make_float2(__low2float(p), __high2float(p));
  }
};
template <>
struct Pair<double> {
  using type = double2;
  static __device__ __forceinline__ double2 widen2(double2 p) { return p; }
};

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

// Inclusive sum of p over the lanes of this lane's run (lanes from the run's
// head `start` to this lane).
template <typename A>
__device__ __forceinline__ A run_scan(A p, int lane, int start) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const A q = __shfl_up_sync(0xffffffffu, p, off);
    if (lane - off >= start) p += q;
  }
  return p;
}

// One block per range, kCluster ranges a cluster. x (and, in planes mode,
// its im plane x_plane elements further) has n_cols columns; y has n_rows
// rows (planes: (2, n_rows)). Row g of the cluster's union rows
// [uptr[cl], uptr[cl + 1]) names window uwin[g] (the last row is a
// sentinel) and uoff[g * kCluster + rank] the range's first entry there.
template <typename V, typename A, int kMode, int kCluster>
__global__ void __launch_bounds__(kThreads)
gell_window_kernel(const uint32_t* __restrict__ words, const V* __restrict__ vals,
                   const A* __restrict__ x, int64_t x_plane, int64_t n_rows, int64_t n_cols,
                   int R, int W, const int* __restrict__ uptr,
                   const int* __restrict__ uwin, const int* __restrict__ uoff,
                   A* __restrict__ y) {
  constexpr bool kCplx = kMode != kModeReal;
  constexpr int E = kMode == kModeComplex ? 2 * sizeof(A) : sizeof(A);  // bytes a plane element
  constexpr int kPlanes = kMode == kModePlanes ? 2 : 1;
  using A2 = typename Vec2<A>::type;
  using VP = typename Pair<V>::type;
  extern __shared__ __align__(16) char smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  const int plane_bytes = ((W * E + 15) & ~15) + 16;
  const int stage_bytes = kPlanes * plane_bytes;
  A* acc_re = reinterpret_cast<A*>(smem + kStages * stage_bytes);
  A* acc_im = acc_re + R;
  const int t = threadIdx.x, lane = t & 31;
  const int rank = kCluster == 1 ? 0 : static_cast<int>(cg::this_cluster().block_rank());
  const int cl = blockIdx.x / kCluster;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  for (int i = t; i < R; i += kThreads) {
    acc_re[i] = A(0);
    if constexpr (kCplx) acc_im[i] = A(0);
  }
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kCluster == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();  // barriers ready before any copy or arrival lands
  }

  const int g0 = uptr[cl], g1 = uptr[cl + 1] - 1;  // union windows [g0, g1); g1 the sentinel
  // plane p of window row g: its source and bytes
  auto source = [&](int g, int p) {
    const int64_t c0 = static_cast<int64_t>(uwin[g]) * W;
    return reinterpret_cast<const char*>(p == 0 ? x : x + x_plane) + c0 * E;
  };
  auto plane_len = [&](int g) {
    const int64_t c0 = static_cast<int64_t>(uwin[g]) * W;
    return static_cast<uint32_t>((n_cols - c0 < W ? n_cols - c0 : W) * E);
  };
  // window row g into stage s: thread 0 expects the body bytes of every
  // plane, threads q < kPieces / kCluster issue this block's pieces once
  // every block of the cluster has released the stage (its use `use`)
  auto issue = [&](int g, int s, int use) {
    if (t >= kPieces / kCluster) return;
    if (kCluster > 1 && use > 0) mbar_wait(&empty[s], static_cast<uint32_t>((use - 1) & 1));
    uint32_t body = 0;
    for (int p = 0; p < kPlanes; ++p) {
      const Span sp(source(g, p), plane_len(g));
      body += sp.body;
      issue_body<kCluster>(smem + s * stage_bytes + p * plane_bytes, source(g, p), sp, &full[s],
                           rank, t);
    }
    if (t == 0) mbar_expect(&full[s], body);
  };

  const int64_t e_end = uoff[g1 * kCluster + rank];
  int64_t base = g0 < g1 ? uoff[g0 * kCluster + rank] : e_end;
  uint32_t cw[kUnroll], nw[kUnroll];
  VP cp[kUnroll], np[kUnroll];  // complex pairs
  V cv[kUnroll], nv[kUnroll];   // real values
  auto load = [&](int64_t b, uint32_t* w, V* v, VP* p) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t e = b + k * kThreads + t;
      if (e < e_end) {
        w[k] = __ldg(words + e);
        if constexpr (kCplx) {
          p[k] = __ldg(reinterpret_cast<const VP*>(vals) + e);
        } else {
          v[k] = __ldg(vals + e);
        }
      }
    }
  };
  load(base, cw, cv, cp);
  load(base + kChunk, nw, nv, np);
  if (g0 < g1) issue(g0, 0, 0);

  for (int g = g0; g < g1; ++g) {
    const int s = (g - g0) % kStages;
    char* buf = smem + s * stage_bytes;
    mbar_wait(&full[s], static_cast<uint32_t>(((g - g0) / kStages) & 1));
    for (int p = 0; p < kPlanes; ++p)
      copy_edges(buf + p * plane_bytes, source(g, p), Span(source(g, p), plane_len(g)),
                 plane_len(g));
    __syncthreads();  // the edges are in, and every thread is past window g - 1
    if (g > g0 && kCluster > 1 && t == 0)  // window g - 1's stage is free here
      for (int cta = 0; cta < kCluster; ++cta)
        mbar_arrive_cluster(&empty[(g - 1 - g0) % kStages], cta);
    if (g + 1 < g1) issue(g + 1, (g + 1 - g0) % kStages, (g + 1 - g0) / kStages);
    const A* xr = reinterpret_cast<const A*>(
        buf + Span(source(g, 0), plane_len(g)).pad);
    const A* xi = reinterpret_cast<const A*>(
        buf + plane_bytes + (kPlanes == 2 ? Span(source(g, 1), plane_len(g)).pad : 0));
    const A2* xc = reinterpret_cast<const A2*>(xr);
    const int64_t lo = uoff[g * kCluster + rank], hi = uoff[(g + 1) * kCluster + rank];
    while (base < hi) {
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t e = base + k * kThreads + t;
        const bool valid = e >= lo && e < hi;
        const uint32_t word = cw[k];
        const int lr = valid ? static_cast<int>(word >> 16) : -1 - lane;  // unique when invalid
        const int lc = static_cast<int>(word & 0xffffu);
        A pre = A(0), pim = A(0);
        if (valid) {
          if constexpr (kMode == kModeReal) {
            pre = widen(cv[k]) * xr[lc];
          } else {
            const auto v = Pair<V>::widen2(cp[k]);
            A ar, ai;
            if constexpr (kMode == kModeComplex) {
              const A2 xv = xc[lc];
              ar = xv.x;
              ai = xv.y;
            } else {
              ar = xr[lc];
              ai = xi[lc];
            }
            pre = madd(-v.y, ai, v.x * ar);
            pim = madd(v.y, ar, v.x * ai);
          }
        }
        // runs of equal local row among the warp's 32 consecutive entries
        const int prev = __shfl_up_sync(0xffffffffu, lr, 1);
        const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != lr);
        const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
        const bool last = lane == 31 || ((heads >> (lane + 1)) & 1u);
        if (heads != 0xffffffffu) {
          pre = run_scan(pre, lane, start);
          if constexpr (kCplx) pim = run_scan(pim, lane, start);
        }
        if (valid && last) {
          // the window's entries are sorted by row, so only a run at either
          // end of the warp's 32 entries may share its row with another warp:
          // those add atomically, the others (one lane each) plainly
          if (start == 0 || lane == 31) {
            atomicAdd(acc_re + lr, pre);
            if constexpr (kCplx) atomicAdd(acc_im + lr, pim);
          } else {
            acc_re[lr] += pre;
            if constexpr (kCplx) acc_im[lr] += pim;
          }
        }
      }
      if (base + kChunk > hi) break;  // the chunk runs on into the next window
      base += kChunk;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        cw[k] = nw[k];
        cv[k] = nv[k];
        cp[k] = np[k];
      }
      load(base + kChunk, nw, nv, np);
    }
  }
  if constexpr (kCluster > 1) cg::this_cluster().sync();  // no block leaves while a peer may
                                                          // still arrive on its barriers
  __syncthreads();  // every run's add is in (and, with no window, the zeros)
  for (int i = t; i < R; i += kThreads) {
    const int64_t row = row0 + i;
    if (row >= n_rows) break;
    if constexpr (kMode == kModeReal) {
      y[row] = acc_re[i];
    } else if constexpr (kMode == kModePlanes) {
      y[row] = acc_re[i];
      y[n_rows + row] = acc_im[i];
    } else {
      A2 out;
      out.x = acc_re[i];
      out.y = acc_im[i];
      reinterpret_cast<A2*>(y)[row] = out;
    }
  }
}

template <typename V, typename A, int kMode>
int smem_bytes(int R, int W) {
  constexpr int E = kMode == kModeComplex ? 2 * sizeof(A) : sizeof(A);
  const int plane_bytes = ((W * E + 15) & ~15) + 16;
  return kStages * (kMode == kModePlanes ? 2 : 1) * plane_bytes +
         R * static_cast<int>(sizeof(A)) * (kMode == kModeReal ? 1 : 2);
}

template <typename V, typename A, int kMode, int kCluster>
int launch(const void* words, const void* vals, const void* x, int64_t x_plane, int64_t n_rows,
           int64_t n_cols, int R, int W, int n_ranges, const int* uptr,
           const int* uwin, const int* uoff, void* y, cudaStream_t s) {
  auto kernel = gell_window_kernel<V, A, kMode, kCluster>;
  const int smem = smem_bytes<V, A, kMode>(R, W);
  if (smem > kSmemBudget || n_ranges % kCluster != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool allowed[64] = {};  // once per device: out of CUDA graph captures
  int device = 0;
  cudaGetDevice(&device);
  if (device >= 64 || !allowed[device]) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (cudaError_t err = cudaGetLastError()) return static_cast<int>(err);
    if (device < 64) allowed[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_ranges);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint32_t*>(words), static_cast<const V*>(vals),
      static_cast<const A*>(x), x_plane, n_rows, n_cols, R, W, uptr, uwin, uoff,
      static_cast<A*>(y));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename V, typename A, int kMode>
int launch_cluster(int cluster, const void* words, const void* vals, const void* x,
                   int64_t x_plane, int64_t n_rows, int64_t n_cols, int R, int W, int n_ranges,
                   const int* uptr, const int* uwin, const int* uoff, void* y, cudaStream_t s) {
#define WIN_ARGS words, vals, x, x_plane, n_rows, n_cols, R, W, n_ranges, uptr, uwin, uoff, y, s
  switch (cluster) {
    case 1: return launch<V, A, kMode, 1>(WIN_ARGS);
    case 2: return launch<V, A, kMode, 2>(WIN_ARGS);
    case 4: return launch<V, A, kMode, 4>(WIN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIN_ARGS
}

template <typename V, typename A>
int launch_mode(int mode, int cluster, const void* words, const void* vals, const void* x,
                int64_t x_plane, int64_t n_rows, int64_t n_cols, int R, int W, int n_ranges,
                const int* uptr, const int* uwin, const int* uoff, void* y, cudaStream_t s) {
#define WIN_ARGS cluster, words, vals, x, x_plane, n_rows, n_cols, R, W, n_ranges, uptr, uwin, \
                 uoff, y, s
  switch (mode) {
    case kModeReal: return launch_cluster<V, A, kModeReal>(WIN_ARGS);
    case kModeComplex: return launch_cluster<V, A, kModeComplex>(WIN_ARGS);
    case kModePlanes: return launch_cluster<V, A, kModePlanes>(WIN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIN_ARGS
}

}  // namespace

extern "C" {

// What a windowed pack's launches share, set once per pack and entry by
// ops/gell_spmv.py (its _WindowArgs, the same fields in the same order).
struct GellWindowArgs {
  int dtype, device, mode, cluster, R, W;
  long long n_rows, n_cols, n_ranges;
  const void* words;
  const void* values;
  const void* uptr;
  const void* uwin;
  const void* uoff;
};

// The windowed route of B6. dtype is the stored values' type (of each half
// of a complex pair); x and y have the accumulation type, as in
// gell_csr_spmv. n_ranges blocks of R rows, `cluster` of them a cluster,
// two buffers of W columns of x; the layout arrays as
// ops/gell_spmv.py::window_layout builds them.
int gell_window_spmv(const GellWindowArgs* a, const void* x, long long x_plane, void* y,
                     void* stream) {
  cudaError_t err = cudaSetDevice(a->device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a->n_rows <= 0 || a->n_ranges <= 0) return 0;
  if (a->R < 1 || a->R > 65536 || a->W < 1 || a->W > 65536 || a->n_ranges > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* up = static_cast<const int*>(a->uptr);
  const int* uw = static_cast<const int*>(a->uwin);
  const int* uo = static_cast<const int*>(a->uoff);
#define WIN_ARGS a->mode, a->cluster, a->words, a->values, x, x_plane, a->n_rows, a->n_cols, a->R, \
                 a->W, static_cast<int>(a->n_ranges), up, uw, uo, y, s
  switch (a->dtype) {
    case kF32: return launch_mode<float, float>(WIN_ARGS);
    case kBF16: return launch_mode<__nv_bfloat16, float>(WIN_ARGS);
    case kF64: return launch_mode<double, double>(WIN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WIN_ARGS
}

// Clusters of `cluster` blocks of the windowed kernel (real mode, f32, at
// the largest shared memory a block may take) that the device runs at once:
// the pack sizes its ranges so that one wave holds them all.
int gell_window_capacity(int device, int cluster, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBudget;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(cluster * 1024);
#define CAP(C)                                                                               \
  do {                                                                                       \
    auto kernel = gell_window_kernel<float, float, kModeReal, C>;                            \
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget); \
    err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);                            \
  } while (0)
  switch (cluster) {
    case 1: CAP(1); break;
    case 2: CAP(2); break;
    case 4: CAP(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CAP
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

}  // extern "C"
