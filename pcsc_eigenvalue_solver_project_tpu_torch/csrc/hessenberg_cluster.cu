// The unblocked Householder Hessenberg reduction (B7) for NVIDIA Hopper
// (sm_90a): one launch of one thread-block cluster.
//
// Replaces the Pallas TPU kernel _hessenberg_kernel
// (pcsc_eigenvalue_solver_project_tpu/ops/pallas/qr_kernels.py:55, called at
// :237 with Q and :250 without), which holds the whole matrix in VMEM and
// loops over the columns inside one kernel. H = Q^H A Q, and Q when asked,
// for float, double, float2 and double2 ((re, im) in (.x, .y)).
//
// What bounds it: latency. 10/3 n^3 flops are a few microseconds of the
// card's arithmetic at n = 512, but the n - 2 column steps depend on each
// other, and each step needs a sum over the whole matrix twice (w = v^H M for
// the left update, u = M v for the right). Three launches a step (the chain
// this replaced) cost ~3 us each, 4.5 ms at n = 512. Here the whole reduction
// is one launch of kC = 16 (or 8) blocks of 512 threads forming one
// cluster, and the matrix stays on chip:
//  * block r owns the columns j = r, r + kC, r + 2 kC, ... of H (cyclic, so
//    that every block keeps work as the active columns shrink), held
//    column-major in its shared memory when they fit (to n = 912 in float,
//    628 in double and complex float, 432 in complex double), else in a
//    global slab that stays in the 50 MB L2; and the rows [r w, (r + 1) w)
//    of Q, w = ceil(n / kC), in what shared memory is left, else in place in
//    q;
//  * every block holds the same reflector v_k. Step k (pivot row s = k + 1):
//    each block left-updates its own columns j >= k, where w_j = v^H M[:, j]
//    is a sum down one column, a warp's; forms its partial of u = M v over
//    its own columns j >= s, a thread a row; and the owner of column k + 1
//    publishes that column as it now stands. Then one cluster barrier,
//    split: between the arrival and the wait each block updates its rows of
//    Q, where (Q v)_i is a sum along one row, a warp's. After it, every
//    block reads the kC partials of u in rank order (distributed shared
//    memory, cluster.map_shared_rank; the same bits in every block, no
//    atomics), right-updates its own columns, and forms column k + 1 after
//    step k from the published column and u, and from it v_{k+1}, the same
//    in every block: no second barrier to hand v_{k+1} round.
// A step is thus one cluster barrier and a chain of dependent shared-memory
// passes and remote loads; their latency, not the card's rates, bounds it.
// The partials and the published column are double-buffered by the parity of
// k: a block writes step k + 2's only after step k + 1's barrier, which every
// block passes only when it has read step k's. A final barrier keeps every
// block resident until no peer reads its shared memory. Every sum runs in a
// fixed order, so H and Q repeat bit for bit from call to call. The
// reflectors follow reflector_kernel's rule (qr_kernels.cu): the sign is the
// pivot's phase (1 when x0 = 0), v has unit norm and is zero above the
// pivot, the factor is 2, or 0 for the tail-zero and degenerate skips.
//
// Shared memory of a block (elements of T; hessenberg_cluster_smem):
// 6 (n + 1) for the two partials of u, the two published columns, v and the
// block's copy of column k + 1, then the H slab (w n) and the Q rows (w n)
// where they fit. ops/qr_kernels.py::hessenberg_cluster_plan reckons the
// same layout and picks the cluster size by cudaOccupancyMaxActiveClusters
// (hessenberg_cluster_capacity).
//
// Plain C interface for ctypes: each entry point selects the device,
// launches on the caller's stream and returns the first CUDA error (0 on
// success).

#include <cooperative_groups.h>

#include "eig_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kHessThreads = 512;
constexpr int kHessWarps = kHessThreads / 32;
constexpr int kHessSmemBudget = 227 * 1024 - 1024;  // dynamic; the rest is static

int64_t hessenberg_cluster_smem(int64_t n, int64_t width, int h_smem, int q_smem,
                                int64_t elem) {
  return elem * (6 * (n + 1) + (h_smem ? width * n : 0) + (q_smem ? width * n : 0));
}

// Every thread's rows of the unit reflector of `col` with pivot row s, into
// out[s..n) (zero above s is implied), and out[n] = its factor (thread 0): 2,
// or 0 when the column is zero below the pivot or the reflector
// degenerates. tail2 = sum_{i > s} |col_i|^2, the same in every thread, and
// ||x||^2 = tail2 + |x0|^2. Every thread forms the same scalars.
template <typename T>
__device__ void write_reflector(const T* col, int64_t n, int64_t s,
                                typename Ops<T>::Real tail2, T* out) {
  using O = Ops<T>;
  using R = typename O::Real;
  const T x0 = col[s];
  const R a0 = O::abs2(x0), m0 = dsqrt(a0);
  const T sign = m0 > R(0) ? O::divr(x0, m0) : O::one();
  const T vs = O::madd(x0, sign, O::make(dsqrt(tail2 + a0), R(0)));  // x0 - alpha
  const R vn2 = tail2 + O::abs2(vs);
  const bool degenerate = vn2 == R(0);
  const R vinv = R(1) / dsqrt(degenerate ? R(1) : vn2);
  for (int64_t i = s + threadIdx.x; i < n; i += kHessThreads)
    out[i] = O::scale(i == s ? vs : col[i], vinv);
  if (threadIdx.x == 0) out[n] = O::make(tail2 == R(0) || degenerate ? R(0) : R(2), R(0));
}

// The block's sum of the threads' parts, the same in every thread and in
// every block (lanes by a butterfly, then the warps in order). red holds
// kHessWarps values; the caller's next barrier protects it.
template <typename R>
__device__ R block_sum(R part, R* red) {
  for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(0xffffffffu, part, m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  R sum = 0;
  for (int w = 0; w < kHessWarps; ++w) sum += red[w];
  return sum;
}

// The first of the block's local columns (global column lj * kC + rank)
// whose global column is >= j.
template <int kC>
__device__ __forceinline__ int64_t first_local(int64_t j, int rank) {
  return j <= rank ? 0 : (j - rank + kC - 1) / kC;
}

// The two halves of a cluster barrier: what a thread wrote before arriving
// is seen by every thread of the cluster that has waited.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One cluster of kC blocks reduces the n x n matrix a into h (and q). The H
// slab is in shared memory when kHS, else in slabs (kC * width * n
// elements); Q's rows in shared memory when q_smem, else in q.
template <typename T, int kC, bool kHS>
__global__ void __launch_bounds__(kHessThreads, 1)
hessenberg_cluster_kernel(const T* __restrict__ a, T* __restrict__ h, T* __restrict__ q,
                          T* __restrict__ slabs, int n, int width, int q_smem) {
  using O = Ops<T>;
  using R = typename O::Real;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ __align__(16) unsigned char hess_smem[];
  __shared__ R red[kHessWarps];
  T* part = reinterpret_cast<T*>(hess_smem);  // 2 x n: this block's partial of u, by k's parity
  T* pubcol = part + 2 * n;    // 2 x n: column k + 1 after its left update, from its owner
  T* v = pubcol + 2 * n;       // n + 1: the reflector v_k, v[n] its factor
  T* col = v + (n + 1);        // n: column k + 1 after step k, every block's own copy
  T* spare = part + 6 * (n + 1);
  T* H = kHS ? spare : slabs + static_cast<int64_t>(rank) * width * n;  // column lj at H + lj n
  if (kHS) spare += width * n;
  const int row0 = rank * width < n ? rank * width : n;
  const int qrows = n - row0 < width ? n - row0 : width;
  T* Q = q == nullptr ? nullptr : (q_smem ? spare : q + static_cast<int64_t>(row0) * n);
  const int ncols = rank < n ? (n - rank + kC - 1) / kC : 0;

  for (int e = tid; e < ncols * n; e += kHessThreads)
    H[e] = a[static_cast<int64_t>(e % n) * n + (e / n) * kC + rank];
  if (Q != nullptr)
    for (int e = tid; e < qrows * n; e += kHessThreads)
      Q[e] = row0 + e / n == e % n ? O::one() : O::zero();
  if (n > 2) {  // every block forms v_0 from column 0 of a
    R tail = 0;
    for (int i = tid; i < n; i += kHessThreads) {
      col[i] = a[static_cast<int64_t>(i) * n];
      if (i > 1) tail += O::abs2(col[i]);
    }
    const R tail2 = block_sum(tail, red);
    write_reflector(col, n, 1, tail2, v);
  }
  __syncthreads();

  for (int k = 0; k + 2 < n; ++k) {
    const int s = k + 1;
    const R f = O::re(v[n]);
    T* part_k = part + (k & 1) * n;
    T* pubcol_k = pubcol + (k & 1) * n;
    const bool ahead = k + 3 < n;  // a step k + 1 follows, with v_{k+1} from column k + 1
    const int lk = first_local<kC>(k, rank), ls = first_local<kC>(s, rank);
    // left update of the own columns j >= k, a warp a column
    for (int t = lk + warp; t < ncols; t += kHessWarps) {
      T* c = H + t * n;
      T w = O::zero();
#pragma unroll 4
      for (int i = s + lane; i < n; i += 32) w = O::madd(w, O::conj(v[i]), c[i]);
      const T fw = O::scale(warp_allsum(w), f);
#pragma unroll 4
      for (int i = s + lane; i < n; i += 32) c[i] = O::msub(c[i], v[i], fw);
    }
    __syncthreads();
    // this block's partial of u over its columns j >= s, a thread a row;
    // the owner of column k + 1 publishes that column as it stands
    const T* own_next = ahead && (k + 1) % kC == rank ? H + ((k + 1) / kC) * n : nullptr;
    for (int i = tid; i < n; i += kHessThreads) {
      T acc = O::zero();
#pragma unroll 4
      for (int lj = ls; lj < ncols; ++lj) acc = O::madd(acc, H[lj * n + i], v[lj * kC + rank]);
      part_k[i] = acc;
      if (own_next != nullptr) pubcol_k[i] = own_next[i];
    }
    cluster_arrive();
    // Q's rows with v_k while the peers arrive, a warp a row
    for (int il = warp; il < (Q != nullptr ? qrows : 0); il += kHessWarps) {
      T* row = Q + static_cast<int64_t>(il) * n;
      T u = O::zero();
      for (int j = s + lane; j < n; j += 32) u = O::madd(u, row[j], v[j]);
      const T fu = O::scale(warp_allsum(u), f);
      for (int j = s + lane; j < n; j += 32) row[j] = O::msub(row[j], fu, O::conj(v[j]));
    }
    cluster_wait();
    // u in rank order (the kC loads in flight together); the right update
    // of the own columns j >= s; and, from the published column, column
    // k + 1 after step k and its tail's norm
    const T* next = cluster.map_shared_rank(pubcol_k, static_cast<int>((k + 1) % kC));
    const T vn = O::conj(v[s]);  // column k + 1 is column s
    R tail = 0;
    for (int i = tid; i < n; i += kHessThreads) {
      T parts[kC];
#pragma unroll
      for (int p = 0; p < kC; ++p) parts[p] = cluster.map_shared_rank(part_k, p)[i];
      const T nexti = ahead ? next[i] : O::zero();  // loaded ahead of the stores below
      T u = O::zero();
#pragma unroll
      for (int p = 0; p < kC; ++p) u = O::add(u, parts[p]);
      const T fu = O::scale(u, f);
#pragma unroll 4
      for (int lj = ls; lj < ncols; ++lj)
        H[lj * n + i] = O::msub(H[lj * n + i], fu, O::conj(v[lj * kC + rank]));
      if (ahead) {
        const T c = O::msub(nexti, fu, vn);
        col[i] = c;
        if (i > s + 1) tail += O::abs2(c);
      }
    }
    if (ahead) {  // v_{k+1}, the same in every block
      const R tail2 = block_sum(tail, red);
      write_reflector(col, n, s + 1, tail2, v);
    }
    __syncthreads();
  }

  for (int e = tid; e < ncols * n; e += kHessThreads)
    h[static_cast<int64_t>(e % n) * n + (e / n) * kC + rank] = H[e];
  if (Q != nullptr && q_smem)
    for (int e = tid; e < qrows * n; e += kHessThreads) q[static_cast<int64_t>(row0) * n + e] = Q[e];
  cluster_arrive();  // no block leaves while a peer may still read its shared memory
  cluster_wait();
}

template <typename T, int kC, bool kHS>
cudaError_t allow_cluster() {
  auto kernel = hessenberg_cluster_kernel<T, kC, kHS>;
  static bool allowed[64] = {};  // once per device: out of CUDA graph captures
  int device = 0;
  cudaGetDevice(&device);
  if (device < 64 && allowed[device]) return cudaSuccess;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHessSmemBudget);
  if (kC > 8) cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess && device < 64) allowed[device] = true;
  return err;
}

cudaLaunchConfig_t cluster_config(int cluster, int64_t smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kHessThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int kC, bool kHS>
int launch_hessenberg(const void* a, void* h, void* q, void* slabs, int n, int width,
                      int q_smem, int64_t smem, cudaStream_t s) {
  if (cudaError_t err = allow_cluster<T, kC, kHS>()) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(kC, smem, s, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, hessenberg_cluster_kernel<T, kC, kHS>, static_cast<const T*>(a), static_cast<T*>(h),
      static_cast<T*>(q), static_cast<T*>(slabs), n, width, q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hessenberg_cluster(int cluster, const void* a, void* h, void* q, void* slabs, int n,
                              int width, int h_smem, int q_smem, int64_t smem, cudaStream_t s) {
#define HESS_LAUNCH(C, HS) launch_hessenberg<T, C, HS>(a, h, q, slabs, n, width, q_smem, smem, s)
  switch (cluster) {
    case 8: return h_smem ? HESS_LAUNCH(8, true) : HESS_LAUNCH(8, false);
    case 16: return h_smem ? HESS_LAUNCH(16, true) : HESS_LAUNCH(16, false);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HESS_LAUNCH
}

// The two H placements take the same registers and static shared memory:
// the query asks the shared-memory one.
template <typename T, int kC>
int max_clusters(int64_t smem, int* clusters) {
  if (cudaError_t err = allow_cluster<T, kC, true>()) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(kC, smem, nullptr, attr);
  cudaError_t err = cudaOccupancyMaxActiveClusters(
      clusters, hessenberg_cluster_kernel<T, kC, true>, &cfg);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}

template <typename T>
int capacity(int cluster, int64_t smem, int* clusters) {
  switch (cluster) {
    case 8: return max_clusters<T, 8>(smem, clusters);
    case 16: return max_clusters<T, 16>(smem, clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A cluster of kC blocks that does nothing but `iters` cluster barriers: what
// one barrier of the reduction's steps costs on this card.
template <int kC>
__global__ void __launch_bounds__(kHessThreads, 1) cluster_barrier_kernel(int iters) {
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = 0; i < iters; ++i) cluster.sync();
}

}  // namespace

extern "C" {

// B7: h = the Hessenberg form of the n x n matrix a; q (nullable) = the
// accumulated unitary with a = q h q^H. One cluster of `cluster` (8 or 16)
// blocks; the H slab in shared memory when h_smem, else in `slabs`
// (cluster * width * n scalars), Q's rows in shared memory when q_smem, else
// in q; smem the dynamic shared memory that ops/qr_kernels.py reckoned,
// which must be what this file reckons.
int qr_hessenberg(int dtype, int device, const void* a, void* h, void* q, void* slabs,
                  long long n, int cluster, int h_smem, int q_smem, long long smem,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  if (cluster <= 0 || n >= (1LL << 31) / 32) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t width = (n + cluster - 1) / cluster;
  const int elem = dtype == kF32 ? 4 : (dtype == kC128 ? 16 : 8);
  if (smem != hessenberg_cluster_smem(n, width, h_smem, q_smem, elem) || smem > kHessSmemBudget ||
      (!h_smem && slabs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HESS_ARGS cluster, a, h, q, slabs, static_cast<int>(n), static_cast<int>(width), h_smem, \
                  q_smem, smem, s
  switch (dtype) {
    case kF32: return launch_hessenberg_cluster<float>(HESS_ARGS);
    case kF64: return launch_hessenberg_cluster<double>(HESS_ARGS);
    case kC64: return launch_hessenberg_cluster<float2>(HESS_ARGS);
    case kC128: return launch_hessenberg_cluster<double2>(HESS_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HESS_ARGS
}

// Clusters of `cluster` blocks of B7's kernel for dtype, with smem bytes of
// dynamic shared memory each, that the device runs at once (0: none fits).
int hessenberg_cluster_capacity(int dtype, int device, int cluster, long long smem,
                                int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *clusters = 0;
  if (smem < 0 || smem > kHessSmemBudget) return 0;
  switch (dtype) {
    case kF32: return capacity<float>(cluster, smem, clusters);
    case kF64: return capacity<double>(cluster, smem, clusters);
    case kC64: return capacity<float2>(cluster, smem, clusters);
    case kC128: return capacity<double2>(cluster, smem, clusters);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One cluster of `cluster` (8 or 16) blocks of B7's 512 threads running `iters`
// cluster barriers, on the caller's stream.
int cluster_barrier_probe(int device, int cluster, int iters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 0, static_cast<cudaStream_t>(stream),
                                                attr);
  switch (cluster) {
    case 8: err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel<8>, iters); break;
    case 16:
      cudaFuncSetAttribute(cluster_barrier_kernel<16>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      err = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel<16>, iters);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
