// k-NN danger gating kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; cbf_tpu_torch/ops/knn.py builds and loads this file).
//
// Contract (knn_fused and knn_stream, = cbf_tpu/ops/pallas_knn.py
// knn_neighbors; knn_banded computes it over y-sorted rows and a window of
// columns per row block, see its note):
//   in : x (N, 2) float32 row-major, r2 = float32(radius)^2, k <= kMaxK
//   out: idx (N, k) int32 — the k nearest in-radius neighbours, nearest
//        first, ties to the lower column index, 0 on empty slots;
//        dist (N, k) float32 — their distances, +inf on empty slots;
//        nearest (N,) float32 — nearest-any distance (self excluded);
//        count (N,) int32 — in-radius candidates, 0 < d^2 < r2.
//
// Bit-exactness with the plain PyTorch versions: every step of
// d^2 = dx*dx + dy*dy is rounded on its own (__fsub_rn/__fmul_rn/
// __fadd_rn, and the build passes --fmad=false), because a contracted FMA
// would move d^2 by an ulp, flip eligibility at the radius and reorder
// near-ties. Square roots are IEEE (__fsqrt_rn); no --use_fast_math.
//
// What bounds them on an H100: per ordered pair ~8 f32 operations
// (2 sub, 2 mul, 1 add, 1 min, 2 compares) against ~8 bytes of output per
// (row, slot) — N = 4096 is 0.13 GOP against 0.33 MB, so the compute side
// of the roofline is the bound. The data sheet's 67 TFLOP/s f32 counts an
// FMA as two operations; with --fmad=false these kernels issue none, so
// each operation takes one FP32 lane slot (~33.5 T/s): ~4 us at N = 4096,
// and a launch (~3-5 us) is of the same order. Neither kernel touches
// device memory in its inner loop: coordinates sit in shared memory and
// the running top-k in registers.

#include <algorithm>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxK = 16;      // must match ops/knn.py KNN_MAX_K
constexpr int kThreads = 128;  // stream kernels: rows per block
constexpr int kCtile = 512;    // stream kernels: columns staged per step
constexpr int kRtile = 256;    // banded: rows sharing one window (RTILE)
static_assert(kRtile % kThreads == 0, "a block's rows share one window");
constexpr int kFusedRows = 32;  // fused: query rows per block (one warp)
constexpr int kFusedSegs = 8;   // fused: column segments, one warp each
constexpr int kFusedThreads = kFusedRows * kFusedSegs;
constexpr int kUnroll = 4;      // columns whose d^2 are formed together

__device__ __forceinline__ float pair_d2(float px, float py, float qx,
                                         float qy) {
  const float dx = __fsub_rn(px, qx);
  const float dy = __fsub_rn(py, qy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Sorted insertion into a register top-k. The new entry goes in front of
// the first strictly larger key, i.e. after every equal one: callers
// offer columns in increasing order, so ties keep the lower index first —
// the order of the TPU kernel's k first-minimizer passes.
template <int K>
__device__ __forceinline__ void topk_insert(float (&bd)[K], int (&bi)[K],
                                            float d, int j) {
  bool shift = false;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (shift || d < bd[s]) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = d;
      bi[s] = j;
      d = td;
      j = ti;
      shift = true;
    }
  }
}

template <int K>
__device__ __forceinline__ void consider(float d2, int j, int i, float r2,
                                         float (&bd)[K], int (&bi)[K],
                                         float& nearest, int& count) {
  if (j != i) nearest = fminf(nearest, d2);
  if (d2 < r2 && d2 > 0.0f) {
    ++count;
    if (d2 < bd[K - 1]) topk_insert<K>(bd, bi, d2, j);
  }
}

// Columns [col_base, col_base + w) staged at pts[0, w), in increasing
// order. kUnroll distances are formed before any is considered: they are
// independent, so their shared-memory loads and arithmetic overlap, while
// the (rarely taken) insertions still see the columns in order.
template <int K>
__device__ __forceinline__ void scan_columns(
    const float2* pts, int w, int col_base, int i, float px, float py,
    float r2, float (&bd)[K], int (&bi)[K], float& nearest, int& count) {
  int jj = 0;
  for (; jj + kUnroll <= w; jj += kUnroll) {
    float d2[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float2 q = pts[jj + u];  // same address across the warp
      d2[u] = pair_d2(px, py, q.x, q.y);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      consider<K>(d2[u], col_base + jj + u, i, r2, bd, bi, nearest, count);
  }
  for (; jj < w; ++jj) {
    const float2 q = pts[jj];
    consider<K>(pair_d2(px, py, q.x, q.y), col_base + jj, i, r2, bd, bi,
                nearest, count);
  }
}

// Merge one sorted partial (keys pd, ids pi, from columns above every column
// already merged) into a running top-k: equal keys land after the running
// ones, i.e. on the lower column index.
template <int K>
__device__ __forceinline__ void merge_partial(float (&bd)[K], int (&bi)[K],
                                              const float* pd,
                                              const int* pi, int stride) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const float d = pd[t * stride];
    if (d < bd[K - 1]) topk_insert<K>(bd, bi, d, pi[t * stride]);
  }
}

template <int K>
__device__ __forceinline__ void write_row(int i, const float (&bd)[K],
                                          const int (&bi)[K], float nearest,
                                          int count, int* idx, float* dist,
                                          float* near_out, int* count_out) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    idx[i * K + s] = bi[s];
    dist[i * K + s] = __fsqrt_rn(bd[s]);
  }
  near_out[i] = __fsqrt_rn(nearest);
  count_out[i] = count;
}

// knn_fused — replaces cbf_tpu/ops/pallas_knn.py:_knn_kernel.
// The TPU kernel forms a (128, N) d^2 slab per tile in VMEM and runs k
// masked min-passes over it. Here nothing is materialized: a block owns
// 32 query rows and stages all N coordinates in shared memory (8 bytes
// each, 64 KB at N = 8192, hence the opt-in above 48 KB). Its 8 warps
// split the columns into 8 contiguous segments; each thread scans its
// row's segment once, in increasing column order, keeping nearest, count
// and the top-k in registers (one pass instead of the TPU's k + 2). The
// segment partials meet in shared memory and the first warp merges them
// in segment order, so ties still land on the lower column. The column
// split is what feeds the card: at N = 4096 a thread-per-row layout gives
// 32 blocks of 4 warps (100 of 132 SMs idle, one warp per scheduler, no
// latency hidden); this one gives 128 blocks of 8 warps, each scanning
// N/8 columns. The ragged last block masks itself; no padding.
template <int K>
__global__ void __launch_bounds__(kFusedThreads)
    knn_fused_kernel(const float* __restrict__ x, int n, float r2,
                     int* __restrict__ idx, float* __restrict__ dist,
                     float* __restrict__ nearest, int* __restrict__ count) {
  extern __shared__ float2 pts[];  // n coordinates, then the partials
  float* part_d = reinterpret_cast<float*>(pts + n);  // [K][threads]
  int* part_i = reinterpret_cast<int*>(part_d + K * kFusedThreads);
  float* part_near = reinterpret_cast<float*>(part_i + K * kFusedThreads);
  int* part_cnt = reinterpret_cast<int*>(part_near + kFusedThreads);
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    pts[j] = make_float2(x[2 * j], x[2 * j + 1]);
  __syncthreads();
  const int r = threadIdx.x % kFusedRows;
  const int seg = threadIdx.x / kFusedRows;
  const int i = blockIdx.x * kFusedRows + r;
  const int seg_len = (n + kFusedSegs - 1) / kFusedSegs;
  const int c0 = min(n, seg * seg_len);
  const int c1 = min(n, c0 + seg_len);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }
  float near = CUDART_INF_F;
  int cnt = 0;
  if (i < n) {
    const float2 p = pts[i];
    scan_columns<K>(pts + c0, c1 - c0, c0, i, p.x, p.y, r2, bd, bi, near,
                    cnt);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    part_d[s * kFusedThreads + threadIdx.x] = bd[s];
    part_i[s * kFusedThreads + threadIdx.x] = bi[s];
  }
  part_near[threadIdx.x] = near;
  part_cnt[threadIdx.x] = cnt;
  __syncthreads();
  if (seg != 0 || i >= n) return;
  for (int g = 1; g < kFusedSegs; ++g) {
    const int t = g * kFusedRows + r;
    near = fminf(near, part_near[t]);
    cnt += part_cnt[t];
    merge_partial<K>(bd, bi, part_d + t, part_i + t, kFusedThreads);
  }
  write_row<K>(i, bd, bi, near, cnt, idx, dist, nearest, count);
}

// knn_stream — replaces cbf_tpu/ops/pallas_knn.py:_knn_kernel_blocked /
// _stream_step. The TPU kernel carries a running top-k from one column
// block to the next along a sequential grid axis; Hopper blocks run in no
// order, so that carry cannot cross blocks. Design: split the columns
// into S contiguous ranges (a whole number of CTILE tiles each), one block
// per (row block, range). Inside a block the CTILE tiles stream through
// shared memory and each thread keeps its row's running top-k in
// registers (the TPU's carry, now a loop inside the block). The (N, S, k)
// squared partials then meet in a second kernel that merges them range by
// range: later ranges hold higher columns, and the insertion puts equal
// keys after earlier ones, so ties land on the lower column index exactly
// as the TPU merge's first-slot rule does. S is chosen here (split_plan)
// to put ~4 blocks per SM on the card whatever N is; the partials cost
// 8*k bytes per (row, range) of device memory, ~0.3 MB per range at
// N = 4096, k = 8.
//
// Columns [c0, c1) (block-uniform) stream through shared memory in kCtile
// tiles; each live thread folds them into its row's running top-k, and
// writes its (row, range) partial.
template <int K>
__device__ __forceinline__ void scan_range_to_partial(
    const float* __restrict__ x, int n, float r2, int c0, int c1, int s,
    int splits, float* __restrict__ part_d2, int* __restrict__ part_idx,
    float* __restrict__ part_near, int* __restrict__ part_cnt) {
  __shared__ float2 tile[kCtile];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float px = live ? x[2 * i] : 0.0f;
  const float py = live ? x[2 * i + 1] : 0.0f;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = CUDART_INF_F;
    bi[t] = 0;
  }
  float near = CUDART_INF_F;
  int cnt = 0;
  for (int t0 = c0; t0 < c1; t0 += kCtile) {
    const int w = min(kCtile, c1 - t0);
    __syncthreads();  // the previous tile is fully consumed
    for (int jj = threadIdx.x; jj < w; jj += blockDim.x)
      tile[jj] = make_float2(x[2 * (t0 + jj)], x[2 * (t0 + jj) + 1]);
    __syncthreads();
    if (live) scan_columns<K>(tile, w, t0, i, px, py, r2, bd, bi, near, cnt);
  }
  if (!live) return;
  const size_t row = static_cast<size_t>(i) * splits + s;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    part_d2[row * K + t] = bd[t];
    part_idx[row * K + t] = bi[t];
  }
  part_near[row] = near;
  part_cnt[row] = cnt;
}

template <int K>
__global__ void __launch_bounds__(kThreads) knn_stream_partial_kernel(
    const float* __restrict__ x, int n, float r2, int cols_per_split,
    int splits, float* __restrict__ part_d2, int* __restrict__ part_idx,
    float* __restrict__ part_near, int* __restrict__ part_cnt) {
  const int c0 = blockIdx.y * cols_per_split;
  scan_range_to_partial<K>(x, n, r2, c0, min(n, c0 + cols_per_split),
                           blockIdx.y, splits, part_d2, part_idx, part_near,
                           part_cnt);
}

// knn_banded — replaces cbf_tpu/ops/pallas_knn.py:_knn_kernel_banded (the
// banded use of _stream_step). The caller sorts the rows by y, so each
// 256-row block's in-radius candidates lie in one contiguous window of
// sorted columns, [starts[block], starts[block] + window), which the
// caller finds with searchsorted (ops/knn.py). The TPU gathered every
// window ahead of the kernel (XLA dynamic_slice), only because
// scalar-prefetch index maps hung Mosaic; here a block reads its own
// window start from device memory and streams the window straight from
// the sorted coordinates, so no (row blocks, window) copy exists. It is
// knn_stream with the column range cut to the window: the window is split
// into S ranges of whole tiles (split_plan over the window's tiles), each
// range scanned in order into a partial, and the same merge kernel folds
// the ranges in order — ties keep the lower sorted column, as
// _stream_step's running-slot rule does. Self is excluded by sorted index
// and columns past n (the TPU's padding) are never read. Work is
// O(N * window): at N = 65536 and a 4-tile window, 134 M pairs, ~8 f32
// operations each, which bounds it by operations (~0.03 ms at the non-FMA
// issue rate) as the other two kernels are.
template <int K>
__global__ void __launch_bounds__(kThreads) knn_banded_partial_kernel(
    const float* __restrict__ xs, int n, float r2,
    const int* __restrict__ starts, int window, int cols_per_split,
    int splits, float* __restrict__ part_d2, int* __restrict__ part_idx,
    float* __restrict__ part_near, int* __restrict__ part_cnt) {
  const int start = starts[blockIdx.x * kThreads / kRtile];
  const int c0 = start + blockIdx.y * cols_per_split;
  const int c1 = min(min(n, start + window), c0 + cols_per_split);
  scan_range_to_partial<K>(xs, n, r2, c0, c1, blockIdx.y, splits, part_d2,
                           part_idx, part_near, part_cnt);
}

// Folds the (N, S, k) partials of knn_stream or knn_banded range by range.
template <int K>
__global__ void __launch_bounds__(kThreads) knn_stream_merge_kernel(
    int n, int splits, const float* __restrict__ part_d2,
    const int* __restrict__ part_idx, const float* __restrict__ part_near,
    const int* __restrict__ part_cnt, int* __restrict__ idx,
    float* __restrict__ dist, float* __restrict__ nearest,
    int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = CUDART_INF_F;
    bi[t] = 0;
  }
  float near = CUDART_INF_F;
  int cnt = 0;
  for (int s = 0; s < splits; ++s) {
    const size_t row = static_cast<size_t>(i) * splits + s;
    near = fminf(near, part_near[row]);
    cnt += part_cnt[row];
    merge_partial<K>(bd, bi, part_d2 + row * K, part_idx + row * K, 1);
  }
  write_row<K>(i, bd, bi, near, cnt, idx, dist, nearest, count);
}

template <int K>
cudaError_t launch_fused(const float* x, int n, float r2, int* idx,
                         float* dist, float* nearest, int* count,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float2) * static_cast<size_t>(n) +
                      kFusedThreads * (K * (sizeof(float) + sizeof(int)) +
                                       sizeof(float) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_fused_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n + kFusedRows - 1) / kFusedRows;
  knn_fused_kernel<K><<<blocks, kFusedThreads, smem, stream>>>(
      x, n, r2, idx, dist, nearest, count);
  return cudaGetLastError();
}

// A column split on the current device: S ranges of whole kCtile tiles
// out of ``col_tiles``, as many as put ~4 blocks on each SM (at least one
// range, at most one per tile). knn_stream splits all N columns, knn_banded
// each row block's window.
cudaError_t split_plan(int n, int col_tiles, int* cols_per_split,
                       int* splits) {
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int row_blocks = (n + kThreads - 1) / kThreads;
  const int want =
      std::min(col_tiles, std::max(1, (4 * sms + row_blocks - 1) / row_blocks));
  const int tiles_per_split = (col_tiles + want - 1) / want;
  *cols_per_split = tiles_per_split * kCtile;
  *splits = (col_tiles + tiles_per_split - 1) / tiles_per_split;
  return cudaSuccess;
}

cudaError_t stream_plan(int n, int* cols_per_split, int* splits) {
  return split_plan(n, (n + kCtile - 1) / kCtile, cols_per_split, splits);
}

template <int K>
cudaError_t launch_merge(int n, int splits, const float* part_d2,
                         const int* part_idx, const float* part_near,
                         const int* part_cnt, int* idx, float* dist,
                         float* nearest, int* count, cudaStream_t stream) {
  const cudaError_t e = cudaGetLastError();  // the partial launch
  if (e != cudaSuccess) return e;
  knn_stream_merge_kernel<K><<<(n + kThreads - 1) / kThreads, kThreads, 0,
                               stream>>>(n, splits, part_d2, part_idx,
                                         part_near, part_cnt, idx, dist,
                                         nearest, count);
  return cudaGetLastError();
}

// ``splits`` is the range count the caller sized the partials for; it must
// be the plan's.
template <int K>
cudaError_t launch_stream(const float* x, int n, float r2, int splits,
                          float* part_d2, int* part_idx, float* part_near,
                          int* part_cnt, int* idx, float* dist,
                          float* nearest, int* count, cudaStream_t stream) {
  int cols_per_split = 0;
  int planned = 0;
  const cudaError_t e = stream_plan(n, &cols_per_split, &planned);
  if (e != cudaSuccess) return e;
  if (planned != splits) return cudaErrorInvalidValue;
  const int row_blocks = (n + kThreads - 1) / kThreads;
  knn_stream_partial_kernel<K><<<dim3(row_blocks, splits), kThreads, 0,
                                 stream>>>(x, n, r2, cols_per_split, splits,
                                           part_d2, part_idx, part_near,
                                           part_cnt);
  return launch_merge<K>(n, splits, part_d2, part_idx, part_near, part_cnt,
                         idx, dist, nearest, count, stream);
}

// ``w`` window tiles per 256-row block; ``splits`` as for launch_stream.
template <int K>
cudaError_t launch_banded(const float* xs, int n, float r2,
                          const int* starts, int w, int splits,
                          float* part_d2, int* part_idx, float* part_near,
                          int* part_cnt, int* idx, float* dist,
                          float* nearest, int* count, cudaStream_t stream) {
  int cols_per_split = 0;
  int planned = 0;
  const cudaError_t e = split_plan(n, w, &cols_per_split, &planned);
  if (e != cudaSuccess) return e;
  if (planned != splits) return cudaErrorInvalidValue;
  const int row_blocks = (n + kThreads - 1) / kThreads;
  knn_banded_partial_kernel<K><<<dim3(row_blocks, splits), kThreads, 0,
                                 stream>>>(xs, n, r2, starts, w * kCtile,
                                           cols_per_split, splits, part_d2,
                                           part_idx, part_near, part_cnt);
  return launch_merge<K>(n, splits, part_d2, part_idx, part_near, part_cnt,
                         idx, dist, nearest, count, stream);
}

}  // namespace

#define KNN_K_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

extern "C" {

// Returns a cudaError_t code (0 = launched); the wrapper raises otherwise.
int knn_fused_launch(const float* x, int n, float r2, int k, int* idx,
                     float* dist, float* nearest, int* count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KNN_FUSED_CASE(KV) \
  case KV:                 \
    return launch_fused<KV>(x, n, r2, idx, dist, nearest, count, st);
  switch (k) {
    KNN_K_CASES(KNN_FUSED_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef KNN_FUSED_CASE
}

// knn_stream's column split for N on the current device; the caller
// sizes the (N, splits, k) partials from it.
int knn_stream_plan(int n, int* cols_per_split, int* splits) {
  return stream_plan(n, cols_per_split, splits);
}

int knn_stream_launch(const float* x, int n, float r2, int k, int splits,
                      float* part_d2, int* part_idx, float* part_near,
                      int* part_cnt, int* idx, float* dist, float* nearest,
                      int* count, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KNN_STREAM_CASE(KV)                                                \
  case KV:                                                                 \
    return launch_stream<KV>(x, n, r2, splits, part_d2, part_idx, part_near, \
                             part_cnt, idx, dist, nearest, count, st);
  switch (k) {
    KNN_K_CASES(KNN_STREAM_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef KNN_STREAM_CASE
}

// knn_banded's window split for N rows and a ``w``-tile window on the
// current device; the caller sizes the (N, splits, k) partials from it.
int knn_banded_plan(int n, int w, int* cols_per_split, int* splits) {
  if (w < 1) return cudaErrorInvalidValue;
  return split_plan(n, w, cols_per_split, splits);
}

// xs (N, 2) float32 in y-sorted order; starts int32, one per 256-row block
// of the padded rows: the first sorted column of the block's window of
// w * 512 columns. Outputs are in sorted order, column ids sorted indices.
int knn_banded_launch(const float* xs, int n, float r2, int k,
                      const int* starts, int w, int splits, float* part_d2,
                      int* part_idx, float* part_near, int* part_cnt,
                      int* idx, float* dist, float* nearest, int* count,
                      void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KNN_BANDED_CASE(KV)                                                   \
  case KV:                                                                    \
    return launch_banded<KV>(xs, n, r2, starts, w, splits, part_d2, part_idx, \
                             part_near, part_cnt, idx, dist, nearest, count,  \
                             st);
  switch (k) {
    KNN_K_CASES(KNN_BANDED_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef KNN_BANDED_CASE
}

int knn_max_k() { return kMaxK; }

}  // extern "C"
