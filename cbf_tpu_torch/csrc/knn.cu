// k-NN danger gating kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; cbf_tpu_torch/ops/knn.py builds and loads this file).
//
// Contract (knn_fused and knn_stream, = cbf_tpu/ops/pallas_knn.py
// knn_neighbors; knn_banded computes it over y-sorted rows and a window of
// columns per row block, see its note):
//   in : x (N, 2) float32 row-major, r2 = float32(radius)^2, k <= kMaxK
//        (knn_fused and knn_stream: B members of N rows, (B, N, 2), each
//        member's rows scanned against its own columns only — the member
//        is a grid dimension and every pointer steps by the member's
//        stride, which is what jax.vmap makes of one pallas_call); they
//        also take an optional device array ``radius`` of B float32 radii,
//        one per member, in place of the host r2: member b forms its own
//        r2 = __fmul_rn(radius[b], radius[b]), the TPU kernels'
//        float32(radius) ** 2 read from SMEM (pallas_knn.py:90), so one
//        launch serves B members at B radii (jax.vmap of the traced-config
//        step); a null pointer keeps the host r2;
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
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxK = 16;      // must match ops/knn.py KNN_MAX_K
constexpr int kThreads = 128;  // banded partials, merges: rows per block
constexpr int kCtile = 512;    // banded partials: columns staged per step
constexpr int kRtile = 256;    // banded: rows sharing one window (RTILE)
static_assert(kRtile % kThreads == 0, "a block's rows share one window");
constexpr int kBandBlock = kRtile > kCtile ? kRtile : kCtile;  // row padding
constexpr int kUnroll = 4;      // columns whose d^2 are formed together
constexpr int kFusedR = 4;      // fused: rows per warp, held in registers
constexpr int kFusedHalves = 2; // fused: column halves per row group
constexpr int kFusedWarps = 8;  // fused: warps per block
constexpr int kFusedGroups = kFusedWarps / kFusedHalves;  // row groups
constexpr int kFusedBlockRows = kFusedGroups * kFusedR;
constexpr int kFusedStages = 4; // fused: cp.async groups per column half
constexpr int kFusedUnroll = 2; // fused: 32-column steps loaded together
constexpr int kStreamPiece = 32;  // stream: 32-column steps per half per stage
constexpr int kStreamStages = 2;  // stream: ring stages in shared memory
// stream: ranges are whole units of columns, so every range starts on a
// column that is a multiple of 4 (the self step) and even (16-byte pairs).
constexpr int kStreamUnit = 512;
constexpr int kPlanK = 8;       // stream: the k whose residency sizes the
                                // plan (the swarm's Config.k_neighbors)
constexpr double kWaveFill = 0.9;  // stream: least acceptable last-wave fill
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInfBits = 0x7f800000u;  // +inf; d^2 >= +0 orders as bits
static_assert(32 % kFusedR == 0, "a warp's rows share one 32-column step");
static_assert(kFusedHalves == 2 && 2 * kMaxK <= 32,
              "the half merge holds one candidate per lane");

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

// -- knn_fused ---------------------------------------------------------------
//
// knn_fused — replaces cbf_tpu/ops/pallas_knn.py:_knn_kernel.
// The TPU kernel forms a (128, N) d^2 slab per tile in VMEM and runs k
// masked min-passes over it. Here nothing is materialized. A warp owns
// kFusedR (4) query rows, held in registers alike in all its lanes, and
// one half of the columns; lane l takes the columns l, l + 32, ... of that
// half, so one shared-memory load feeds four independent pair_d2 chains
// and the warp's 32 loads are 32 neighbouring float2 (no broadcast, no
// bank conflict). Each lane keeps nearest, count and a top-k per row in
// registers, its columns arriving in increasing order. Most pairs are out
// of radius: their step is the four d^2, four fminf and one compare of the
// four rows' minimum; only a column within radius of some row enters the
// insertion branch. The self column of the warp's rows lies in one
// 32-column step, the only step that tests column == row.
//
// The top-k order is lexicographic in (d^2, column): ties to the lower
// column, the TPU's first-minimizer rule. So the lanes' lists meet by k
// warp minima of that key (two redux.sync each, the winner pops its head),
// and the two halves' lists then by k more, with one candidate per lane;
// the scan order across lanes and halves does not matter.
//
// Occupancy: a block holds 4 row groups x 2 halves = 8 warps and 16 rows,
// so N = 4096 launches 256 blocks, 2048 warps, ~16 per SM (~4 per
// scheduler) on the 132 SMs, each with 4-row ILP. The block stages all N
// coordinates (8 bytes each, 64 KB at N = 8192, the opt-in above 48 KB)
// with cp.async in kFusedStages groups, each holding the next piece of
// both halves, and scans piece g as soon as group g has landed. Columns
// past N read as +inf: never eligible, never nearest.

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most ``pending`` committed groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}
static_assert(kFusedStages <= 4 && kStreamStages >= 2 && kStreamStages <= 5,
              "cp_async_wait covers 4 groups");

// Copy columns [c0, c1) of x to pts (c0 even): 16-byte column pairs when x
// is 16-byte aligned, else single columns.
__device__ __forceinline__ void stage_columns(float2* pts, const float* x,
                                              int c0, int c1, bool aligned16) {
  if (c1 <= c0) return;
  if (aligned16) {
    for (int p = c0 / 2 + threadIdx.x; p < c1 / 2; p += blockDim.x)
      cp_async16(pts + 2 * p, x + 4 * p);
    if ((c1 & 1) && threadIdx.x == 0) cp_async8(pts + c1 - 1, x + 2 * (c1 - 1));
  } else {
    for (int j = c0 + threadIdx.x; j < c1; j += blockDim.x)
      cp_async8(pts + j, x + 2 * j);
  }
}

// One column j against the warp's kFusedR rows i0 + r. kSelf: the step
// that holds the rows' own columns, the only one that must skip self.
template <int K, bool kSelf>
__device__ __forceinline__ void fused_step(
    float2 q, int j, int i0, const float (&px)[kFusedR],
    const float (&py)[kFusedR], float r2, float (&bd)[kFusedR][K],
    int (&bi)[kFusedR][K], float (&near)[kFusedR], int (&cnt)[kFusedR]) {
  float d[kFusedR];
#pragma unroll
  for (int r = 0; r < kFusedR; ++r) d[r] = pair_d2(px[r], py[r], q.x, q.y);
#pragma unroll
  for (int r = 0; r < kFusedR; ++r)
    if (!kSelf || j != i0 + r) near[r] = fminf(near[r], d[r]);
  float m = d[0];
#pragma unroll
  for (int r = 1; r < kFusedR; ++r) m = fminf(m, d[r]);
  if (m < r2) {  // rare: the column is within radius of some row
#pragma unroll
    for (int r = 0; r < kFusedR; ++r) {
      if (d[r] < r2 && d[r] > 0.0f) {
        ++cnt[r];
        if (d[r] < bd[r][K - 1]) topk_insert<K>(bd[r], bi[r], d[r], j);
      }
    }
  }
}

// Steps [s0, s1) of 32 columns each: step t is pts[32 t, 32 t + 32), lane's
// column col0 + 32 t + lane; the self step t_self split out; kFusedUnroll
// steps' loads issued together. knn_fused passes all N columns and col0 0,
// knn_stream one ring stage and the column of its first slot.
template <int K>
__device__ __forceinline__ void fused_run(
    const float2* pts, int col0, int s0, int s1, int lane, int i0,
    const float (&px)[kFusedR], const float (&py)[kFusedR], float r2,
    float (&bd)[kFusedR][K], int (&bi)[kFusedR][K], float (&near)[kFusedR],
    int (&cnt)[kFusedR]) {
  int t = s0;
  for (; t + kFusedUnroll <= s1; t += kFusedUnroll) {
    float2 q[kFusedUnroll];
#pragma unroll
    for (int u = 0; u < kFusedUnroll; ++u) q[u] = pts[32 * (t + u) + lane];
#pragma unroll
    for (int u = 0; u < kFusedUnroll; ++u)
      fused_step<K, false>(q[u], col0 + 32 * (t + u) + lane, i0, px, py, r2,
                           bd, bi, near, cnt);
  }
  for (; t < s1; ++t)
    fused_step<K, false>(pts[32 * t + lane], col0 + 32 * t + lane, i0, px,
                         py, r2, bd, bi, near, cnt);
}

template <int K>
__device__ __forceinline__ void fused_scan(
    const float2* pts, int col0, int s0, int s1, int t_self, int lane, int i0,
    const float (&px)[kFusedR], const float (&py)[kFusedR], float r2,
    float (&bd)[kFusedR][K], int (&bi)[kFusedR][K], float (&near)[kFusedR],
    int (&cnt)[kFusedR]) {
  fused_run<K>(pts, col0, s0, min(s1, max(s0, t_self)), lane, i0, px, py, r2,
               bd, bi, near, cnt);
  if (t_self >= s0 && t_self < s1)
    fused_step<K, true>(pts[32 * t_self + lane], col0 + 32 * t_self + lane,
                        i0, px, py, r2, bd, bi, near, cnt);
  fused_run<K>(pts, col0, min(s1, max(s0, t_self + 1)), s1, lane, i0, px, py,
               r2, bd, bi, near, cnt);
}

// The warp's k smallest (d^2, column) keys, one candidate list per lane
// (sorted; +inf marks the end). Lane t receives slot t (+inf/0 if empty).
template <int K>
__device__ __forceinline__ void warp_topk(float (&bd)[K], int (&bi)[K],
                                          int lane, float& out_d,
                                          int& out_i) {
  out_d = CUDART_INF_F;
  out_i = 0;
  for (int t = 0; t < K; ++t) {
    const unsigned hb = __float_as_uint(bd[0]);
    const unsigned m = __reduce_min_sync(kFull, hb);
    if (m == kInfBits) break;  // every list is empty
    const unsigned c = __reduce_min_sync(
        kFull, hb == m ? static_cast<unsigned>(bi[0]) : kFull);
    if (lane == t) {
      out_d = __uint_as_float(m);
      out_i = static_cast<int>(c);
    }
    if (hb == m && static_cast<unsigned>(bi[0]) == c) {  // this lane won
#pragma unroll
      for (int s = 0; s + 1 < K; ++s) {
        bd[s] = bd[s + 1];
        bi[s] = bi[s + 1];
      }
      bd[K - 1] = CUDART_INF_F;
      bi[K - 1] = 0;
    }
  }
}

// The warp's kFusedR rows i0 + r (rows past n: row n - 1's coordinates,
// computed and never written) and their empty running state.
template <int K>
__device__ __forceinline__ void load_rows(
    const float* __restrict__ x, int n, int i0, float (&px)[kFusedR],
    float (&py)[kFusedR], float (&bd)[kFusedR][K], int (&bi)[kFusedR][K],
    float (&near)[kFusedR], int (&cnt)[kFusedR]) {
#pragma unroll
  for (int r = 0; r < kFusedR; ++r) {
    const int i = min(i0 + r, n - 1);
    px[r] = x[2 * i];
    py[r] = x[2 * i + 1];
    near[r] = CUDART_INF_F;
    cnt[r] = 0;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[r][s] = CUDART_INF_F;
      bi[r][s] = 0;
    }
  }
}

// Merge slots of the block's second half: per row slot (kFusedGroups x
// kFusedR of them) its k keys and ids, its nearest d^2 and count.
template <int K>
struct HalfMerge {
  static constexpr int kSlots = kFusedGroups * kFusedR;
  float d[kSlots * K];
  int i[kSlots * K];
  float near[kSlots];
  int cnt[kSlots];
};

// The end of a scan over one block's columns: each warp's lane lists meet
// by k warp minima, then half 1's row lists reach half 0's through shared
// memory (hm) and meet them by k more, one candidate per lane. Half 0 gets
// true, lane t < K holding slot t of row r's list in (od[r], oi[r]), every
// lane the row's nearest d^2 (nd[r]) and count (nc[r]); half 1 gets false
// and has nothing left to write.
template <int K>
__device__ __forceinline__ bool merge_block_lists(
    int half, int group, int lane, float (&bd)[kFusedR][K],
    int (&bi)[kFusedR][K], const float (&near)[kFusedR],
    const int (&cnt)[kFusedR], HalfMerge<K>* hm, float (&od)[kFusedR],
    int (&oi)[kFusedR], float (&nd)[kFusedR], int (&nc)[kFusedR]) {
  float md[kFusedR];
  int mi[kFusedR], c_tot[kFusedR];
  unsigned nb[kFusedR];
#pragma unroll
  for (int r = 0; r < kFusedR; ++r) {
    c_tot[r] = __reduce_add_sync(kFull, cnt[r]);
    nb[r] = __reduce_min_sync(kFull, __float_as_uint(near[r]));
    warp_topk<K>(bd[r], bi[r], lane, md[r], mi[r]);
  }
  const int slot = group * kFusedR;
  if (half == 1) {
#pragma unroll
    for (int r = 0; r < kFusedR; ++r) {
      if (lane < K) {
        hm->d[(slot + r) * K + lane] = md[r];
        hm->i[(slot + r) * K + lane] = mi[r];
      }
      if (lane == 0) {
        hm->near[slot + r] = __uint_as_float(nb[r]);
        hm->cnt[slot + r] = c_tot[r];
      }
    }
  }
  __syncthreads();
  if (half == 1) return false;
#pragma unroll
  for (int r = 0; r < kFusedR; ++r) {
    // Lanes [0, K) hold this half's slots, lanes [K, 2K) the other's.
    float cd = md[r];
    int ci = mi[r];
    if (lane >= K && lane < 2 * K) {
      cd = hm->d[(slot + r) * K + lane - K];
      ci = hm->i[(slot + r) * K + lane - K];
    }
    od[r] = CUDART_INF_F;
    oi[r] = 0;
    for (int t = 0; t < K; ++t) {
      const unsigned hb = __float_as_uint(cd);
      const unsigned m = __reduce_min_sync(kFull, hb);
      if (m == kInfBits) break;
      const unsigned c = __reduce_min_sync(
          kFull, hb == m ? static_cast<unsigned>(ci) : kFull);
      if (lane == t) {
        od[r] = __uint_as_float(m);
        oi[r] = static_cast<int>(c);
      }
      if (hb == m && static_cast<unsigned>(ci) == c) cd = CUDART_INF_F;
    }
    nd[r] = fminf(__uint_as_float(nb[r]), hm->near[slot + r]);
    nc[r] = c_tot[r] + hm->cnt[slot + r];
  }
  return true;
}

// Row r of half 0's merged lists as the kernels' outputs (rows < n only).
template <int K>
__device__ __forceinline__ void write_merged_rows(
    int i0, int n, int lane, const float (&od)[kFusedR],
    const int (&oi)[kFusedR], const float (&nd)[kFusedR],
    const int (&nc)[kFusedR], int* __restrict__ idx, float* __restrict__ dist,
    float* __restrict__ nearest, int* __restrict__ count) {
#pragma unroll
  for (int r = 0; r < kFusedR; ++r) {
    const int i = i0 + r;
    if (i >= n) continue;
    if (lane < K) {
      idx[i * K + lane] = oi[r];
      dist[i * K + lane] = __fsqrt_rn(od[r]);
    }
    if (lane == 0) {
      nearest[i] = __fsqrt_rn(nd[r]);
      count[i] = nc[r];
    }
  }
}

// A member's squared radius from the radius array: one load and one
// correctly rounded f32 multiply, jnp.asarray(radius, jnp.float32) ** 2.
__device__ __forceinline__ float member_r2(const float* __restrict__ radius,
                                           size_t member) {
  const float r = radius[member];
  return __fmul_rn(r, r);
}

template <int K>
__global__ void __launch_bounds__(kFusedWarps * 32)
    knn_fused_kernel(const float* __restrict__ x, int n, float r2,
                     const float* __restrict__ radius,
                     int aligned16, int* __restrict__ idx,
                     float* __restrict__ dist, float* __restrict__ nearest,
                     int* __restrict__ count) {
  // 32 * steps columns, then the second half's merge slots.
  extern __shared__ __align__(16) float2 pts[];
  const size_t member = blockIdx.y;
  if (radius != nullptr) r2 = member_r2(radius, member);
  x += 2 * n * member;
  idx += K * n * member;
  dist += K * n * member;
  nearest += n * member;
  count += n * member;
  const int steps = (n + 31) / 32;
  HalfMerge<K>* hm = reinterpret_cast<HalfMerge<K>*>(pts + 32 * steps);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp % kFusedGroups;
  const int half = warp / kFusedGroups;
  const int half_steps = (steps + 1) / 2;
  const int piece = (half_steps + kFusedStages - 1) / kFusedStages;

  for (int j = n + threadIdx.x; j < 32 * steps; j += blockDim.x)
    pts[j] = make_float2(CUDART_INF_F, CUDART_INF_F);
  for (int g = 0; g < kFusedStages; ++g) {
    for (int h = 0; h < kFusedHalves; ++h) {
      const int h0 = h * half_steps;
      const int h1 = h == 0 ? half_steps : steps;
      stage_columns(pts, x, min(n, 32 * min(h1, h0 + g * piece)),
                    min(n, 32 * min(h1, h0 + (g + 1) * piece)),
                    aligned16 != 0);
    }
    cp_async_commit();
  }

  const int i0 = (blockIdx.x * kFusedGroups + group) * kFusedR;
  float px[kFusedR], py[kFusedR], near[kFusedR];
  int cnt[kFusedR];
  float bd[kFusedR][K];
  int bi[kFusedR][K];
  load_rows<K>(x, n, i0, px, py, bd, bi, near, cnt);
  const int h0 = half * half_steps;
  const int h1 = half == 0 ? half_steps : steps;
  for (int g = 0; g < kFusedStages; ++g) {
    cp_async_wait(kFusedStages - 1 - g);
    __syncthreads();  // group g of every thread, and the +inf tail, landed
    fused_scan<K>(pts, 0, min(h1, h0 + g * piece),
                  min(h1, h0 + (g + 1) * piece), i0 / 32, lane, i0, px, py,
                  r2, bd, bi, near, cnt);
  }

  float od[kFusedR], nd[kFusedR];
  int oi[kFusedR], nc[kFusedR];
  if (merge_block_lists<K>(half, group, lane, bd, bi, near, cnt, hm, od, oi,
                           nd, nc))
    write_merged_rows<K>(i0, n, lane, od, oi, nd, nc, idx, dist, nearest,
                         count);
}

// knn_stream — replaces cbf_tpu/ops/pallas_knn.py:_knn_kernel_blocked /
// _stream_step. The TPU kernel carries a running top-k from one column
// block to the next along a sequential grid axis; Hopper blocks run in no
// order, so that carry cannot cross blocks. The columns are split into S
// contiguous ranges, one block per (16-row block, range); the (N, S, k)
// squared partials then meet in knn_stream_merge_kernel, which folds them
// range by range: later ranges hold higher columns and the insertion puts
// equal keys after earlier ones, so ties land on the lower column index, as
// the TPU merge's first-slot rule does. Where the plan yields one range
// (S = 1) the partial kernel writes the outputs itself (__fsqrt_rn) and
// the merge is not launched.
//
// What bounds it: operations. At N = 16384 it is 268 M ordered pairs, ~8
// f32 operations each, ~0.064 ms at the non-FMA issue rate; the outputs
// are 1.2 MB. Inside a block it is knn_fused's register-tiled scan over a
// column range instead of all N columns, which answers the three things the
// one-row-per-thread scan (scan_range_to_partial, kept for knn_banded) lost
// its time to:
// - one d^2 chain per shared load: a warp owns kFusedR (4) rows in
//   registers, and lane l takes columns l + 32 t of its half of the range,
//   so one conflict-free load feeds four independent d^2 chains (~8 issued
//   instructions per pair against ~11);
// - a top-k test after every pair: an out-of-radius step is four d^2, four
//   fminf and one compare of the four rows' minimum, and only the warp's own
//   32-column step tests column == row;
// - staging with no overlap: a ring of kStreamStages (2) cp.async stages
//   in shared memory, each a piece of kStreamPiece (32) steps of both
//   halves (32 KB in all, whatever N is: MAX_N_BLOCKED's 2 MB of
//   coordinates fit in no SM). Each half stages and scans its own slots: a
//   warp scans stage g while stage g + 1 is in flight, and one named
//   barrier of the half's 4 warps per stage both publishes it and frees
//   the slot the next copy overwrites. Per-stage work (the barrier, the
//   copies, the scan's set-up) is paid once per kStreamPiece steps, which
//   is why the stages are this large and the halves sync apart: both
//   measured faster on the H100 than 8-step stages under one block-wide
//   __syncthreads. Columns at or past the range's end (or N) read as +inf:
//   never eligible, never nearest.
// A block is 8 warps: 4 row groups x 2 column halves of its range. Each
// lane keeps its columns' top-k in increasing column order, so its list is
// lexicographic in (d^2, column); the lane lists meet by k warp minima of
// that key and the halves by k more (merge_block_lists, as knn_fused), and
// lanes < k write the row's range partial, coalesced. Every block reads its
// range's coordinates from L2: (N / 16) x N x 8 bytes in all, 128 MB per
// call at N = 16384, which the ring keeps off the critical path.
//
// The plan (stream_plan): S is the smallest range count whose grid of
// (N / 16) x S blocks fills its last wave of resident blocks (from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor on the k = kPlanK
// instance) to kWaveFill or more; ranges are whole kStreamUnit columns.
// At N >= 4096 that is one range on an H100 (1024 blocks at N = 16384,
// 3.9 waves of 2 x 132), so the main path launches the partial kernel
// alone; below it, ranges split the columns until the card is filled.

// Stage g of one half's ring, by that half's own kHalfThreads threads:
// steps g P .. g P + P - 1 (P = kStreamPiece) of the half (range steps
// [h0, h0 + h_steps)) to dst[32 p + l], column c0 + 32 (h0 + g P + p) + l
// (c0 even). A thread copies every kHalfThreads-th 16-byte column pair;
// only a range's last step takes the column-by-column path, where columns
// at or past c1 read +inf. Steps past the half's end are left alone (never
// scanned). Kept this lean because it runs once per stage in every thread.
constexpr int kHalfThreads = kFusedGroups * 32;
__device__ __forceinline__ void stage_piece(
    float2* dst, const float* __restrict__ x, int c0, int c1, int h0,
    int h_steps, int g, bool aligned16) {
  for (int p = threadIdx.x % kHalfThreads; p < kStreamPiece * 16;
       p += kHalfThreads) {
    const int t = g * kStreamPiece + p / 16;  // the pair's half step
    if (t >= h_steps) break;
    const int c = c0 + 32 * (h0 + t) + 2 * (p % 16);
    if (aligned16 && c + 1 < c1) {
      cp_async16(dst + 2 * p, x + 2 * c);
      continue;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (c + u < c1) {
        cp_async8(dst + 2 * p + u, x + 2 * (c + u));
      } else {
        dst[2 * p + u] = make_float2(CUDART_INF_F, CUDART_INF_F);
      }
    }
  }
}

// The halves stage and scan their own ring slots, so each syncs only its
// own kHalfThreads threads (named barrier 1 + half; 0 is __syncthreads).
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + half), "r"(kHalfThreads)
               : "memory");
}

// One block: rows [16 bx, 16 bx + 16) against range s = by, columns
// [c0, c1). S = 1 writes the outputs; S > 1 the (row, range) partials.
template <int K>
__global__ void __launch_bounds__(kFusedWarps * 32) knn_stream_partial_kernel(
    const float* __restrict__ x, int n, float r2,
    const float* __restrict__ radius, int cols_per_split,
    int splits, int aligned16, float* __restrict__ part_d2,
    int* __restrict__ part_idx, float* __restrict__ part_near,
    int* __restrict__ part_cnt, int* __restrict__ idx,
    float* __restrict__ dist, float* __restrict__ nearest,
    int* __restrict__ count) {
  __shared__ __align__(16) float2
      ring[kStreamStages][kFusedHalves][kStreamPiece * 32];
  __shared__ HalfMerge<K> hm;
  const size_t member = blockIdx.z;
  if (radius != nullptr) r2 = member_r2(radius, member);
  x += 2 * n * member;
  if (splits > 1) {
    part_d2 += K * splits * n * member;
    part_idx += K * splits * n * member;
    part_near += splits * n * member;
    part_cnt += splits * n * member;
  } else {
    idx += K * n * member;
    dist += K * n * member;
    nearest += n * member;
    count += n * member;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = warp % kFusedGroups;
  const int half = warp / kFusedGroups;
  const int s = blockIdx.y;
  const int c0 = s * cols_per_split;
  const int c1 = min(n, c0 + cols_per_split);
  const int steps = (c1 - c0 + 31) / 32;
  const int half_steps = (steps + 1) / 2;
  const int h0 = half * half_steps;  // this half's first range step
  const int h_steps = (half == 0 ? half_steps : steps) - h0;
  const int pieces = (h_steps + kStreamPiece - 1) / kStreamPiece;
  const bool a16 = aligned16 != 0;
  for (int g = 0; g + 1 < kStreamStages; ++g) {
    if (g < pieces)
      stage_piece(ring[g][half], x, c0, c1, h0, h_steps, g, a16);
    cp_async_commit();  // empty groups too: the wait counts stay uniform
  }

  const int i0 = (blockIdx.x * kFusedGroups + group) * kFusedR;
  float px[kFusedR], py[kFusedR], near[kFusedR];
  int cnt[kFusedR];
  float bd[kFusedR][K];
  int bi[kFusedR][K];
  load_rows<K>(x, n, i0, px, py, bd, bi, near, cnt);
  // The half step that holds the rows' own columns: i0 and c0 are multiples
  // of 4, so the four lie in one 32-column step. Far below 0 if none does.
  const int t_self = i0 >= c0 && i0 < c1 ? (i0 - c0) / 32 - h0 : -(1 << 30);
  for (int g = 0; g < pieces; ++g) {
    cp_async_wait(kStreamStages - 2);
    // Stage g landed for each thread of the half, and each of its warps is
    // done with stage g - 1, whose slot the next copy takes.
    half_sync(half);
    const int next = g + kStreamStages - 1;
    if (next < pieces)
      stage_piece(ring[next % kStreamStages][half], x, c0, c1, h0, h_steps,
                  next, a16);
    cp_async_commit();
    const int base = g * kStreamPiece;
    fused_scan<K>(ring[g % kStreamStages][half], c0 + 32 * (h0 + base), 0,
                  min(kStreamPiece, h_steps - base), t_self - base, lane, i0,
                  px, py, r2, bd, bi, near, cnt);
  }

  float od[kFusedR], nd[kFusedR];
  int oi[kFusedR], nc[kFusedR];
  if (!merge_block_lists<K>(half, group, lane, bd, bi, near, cnt, &hm, od,
                            oi, nd, nc))
    return;
  if (splits == 1) {
    write_merged_rows<K>(i0, n, lane, od, oi, nd, nc, idx, dist, nearest,
                         count);
    return;
  }
#pragma unroll
  for (int r = 0; r < kFusedR; ++r) {
    const int i = i0 + r;
    if (i >= n) continue;
    const size_t row = static_cast<size_t>(i) * splits + s;
    if (lane < K) {
      part_d2[row * K + lane] = od[r];
      part_idx[row * K + lane] = oi[r];
    }
    if (lane == 0) {
      part_near[row] = nd[r];
      part_cnt[row] = nc[r];
    }
  }
}

// knn_banded's window partials (below), one row per thread: columns
// [c0, c1) (block-uniform) stream through shared memory in kCtile tiles;
// each live thread folds them into its row's running top-k, and writes
// its (row, range) partial.
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

// knn_banded — replaces cbf_tpu/ops/pallas_knn.py:_knn_kernel_banded (the
// banded use of _stream_step). The caller sorts the rows by y (the one
// library op left on this path, torch.argsort, as the TPU's XLA sort sits
// outside its kernel), so each 256-row block's in-radius candidates lie in
// one contiguous window of sorted columns, [starts[block], starts[block] +
// window). The whole call is then three launches:
//
// 1. knn_band_prologue_kernel: one block per 256-row block gathers its rows
//    to float32 in sorted order and finds the block's window start and
//    overflow flag (below);
// 2. knn_banded_partial_kernel: the one-row-per-thread range scan
//    (scan_range_to_partial) with the column range cut to the window, 128
//    rows per block. The TPU gathered every window ahead of the kernel (XLA
//    dynamic_slice), only because scalar-prefetch index maps hung Mosaic;
//    here a block reads its own window start from device memory and
//    streams the window straight from the sorted coordinates. The window is
//    split into S ranges of whole tiles (split_plan over the window's
//    tiles), each range scanned in order into a partial. Self is excluded
//    by sorted index and columns past n (the TPU's padding) are never read;
// 3. knn_banded_merge_kernel: the stream merge, folding the ranges in order
//    (ties keep the lower sorted column, as _stream_step's running-slot rule
//    does), then writing sorted row i straight to agent order[i], its ids
//    mapped through order — the unsort the TPU did with an inverse
//    permutation and gathers.
//
// Work is O(N * window): at N = 65536 and a 4-tile window, 134 M pairs,
// ~8 f32 operations each, which bounds it by operations (~0.03 ms at the
// non-FMA issue rate) as the other two kernels are.
//
// Member axis (what jax.vmap makes of the pallas_call): B swarms of N rows,
// (B, N, 2), each sorted by the caller along its own rows (one batched
// torch.argsort). Each of the three launches takes the member as its last
// grid dimension and steps every pointer by the member's stride, so a
// member's rows see only its own window starts and sorted columns; the
// window split (split_plan) counts the row blocks of all members.
template <int K>
__global__ void __launch_bounds__(kThreads) knn_banded_partial_kernel(
    const float* __restrict__ xs, int n, int band_blocks, float r2,
    const int* __restrict__ starts, int window, int cols_per_split,
    int splits, float* __restrict__ part_d2, int* __restrict__ part_idx,
    float* __restrict__ part_near, int* __restrict__ part_cnt) {
  const size_t member = blockIdx.z;
  xs += 2 * n * member;
  starts += band_blocks * member;
  part_d2 += K * splits * n * member;
  part_idx += K * splits * n * member;
  part_near += splits * n * member;
  part_cnt += splits * n * member;
  const int start = starts[blockIdx.x * kThreads / kRtile];
  const int c0 = start + blockIdx.y * cols_per_split;
  const int c1 = min(min(n, start + window), c0 + cols_per_split);
  scan_range_to_partial<K>(xs, n, r2, c0, c1, blockIdx.y, splits, part_d2,
                           part_idx, part_near, part_cnt);
}

// The y of sorted row ``row`` as the window search sees it: float32 of the
// input's y, or the padding rows' 2e6 (pallas_knn._pad_coords).
template <typename T>
__device__ __forceinline__ float sorted_y(const T* x, const long long* order,
                                          int n, int row) {
  return row < n ? static_cast<float>(x[2 * order[row] + 1]) : 2.0e6f;
}

// torch.searchsorted over the sorted float32 ys[0, n), by one warp: the
// count of ys below v (left side), or at or below v (kRight). Each round
// the 32 lanes probe evenly spaced rows of [lo, hi); the probes that hold
// form a prefix, which narrows the range ~32x, so N = 65536 takes 4 rounds
// of two dependent loads (order, then x) instead of 17.
template <typename T, bool kRight>
__device__ __forceinline__ int warp_search(const T* x, const long long* order,
                                           int n, float v, int lane) {
  int lo = 0;
  int hi = n;  // the answer lies in [lo, hi]
  while (hi > lo) {
    const int stride = (hi - lo + 31) / 32;
    const int p = lo + lane * stride;
    bool below = false;
    if (p < hi) {
      const float y = sorted_y(x, order, n, p);
      below = kRight ? y <= v : y < v;
    }
    const int t = __popc(__ballot_sync(kFull, below));
    if (t == 0) break;  // ys[lo] is not below: the answer is lo
    hi = min(hi, lo + t * stride);  // the first probe that did not hold
    lo += (t - 1) * stride + 1;     // past the last probe that did
  }
  return lo;
}

// band_setup's window search (ops/knn.py), per 256-row block b of the
// padded sorted order: lo = searchsorted(ys[:n], ys[row0] - r), hi =
// searchsorted(ys[:n], ys[row_end] + r, right), each +- one float32
// rounding; starts[b] = clamp(lo, 0, n_pad - wlen); block_overflow[b] =
// hi > starts[b] + wlen. Warps 0 and 1 search lo and hi side by side while
// all 256 threads gather the block's rows.
template <typename T>
__global__ void __launch_bounds__(kRtile) knn_band_prologue_kernel(
    const T* __restrict__ x, const long long* __restrict__ order, int n,
    int n_pad, int wlen, float r, float* __restrict__ xs,
    int* __restrict__ starts, bool* __restrict__ block_overflow) {
  __shared__ int lo_hi[2];
  const size_t member = blockIdx.y;
  x += 2 * n * member;
  order += n * member;
  xs += 2 * n * member;
  starts += gridDim.x * member;
  block_overflow += gridDim.x * member;
  const int row0 = blockIdx.x * kRtile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = row0 + threadIdx.x;
  if (i < n) {
    const long long o = order[i];
    xs[2 * i] = static_cast<float>(x[2 * o]);
    xs[2 * i + 1] = static_cast<float>(x[2 * o + 1]);
  }
  if (warp == 0) {
    const float v = __fsub_rn(sorted_y(x, order, n, row0), r);
    const int lo = warp_search<T, false>(x, order, n, v, lane);
    if (lane == 0) lo_hi[0] = lo;
  } else if (warp == 1) {
    const int row_end = min(row0 + kRtile, n) - 1;
    const float v = __fadd_rn(sorted_y(x, order, n, row_end), r);
    const int hi = warp_search<T, true>(x, order, n, v, lane);
    if (lane == 0) lo_hi[1] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int start = min(max(lo_hi[0], 0), n_pad - wlen);
    starts[blockIdx.x] = start;
    block_overflow[blockIdx.x] = lo_hi[1] > start + wlen;
  }
}

// Row i's (N, S, k) partials folded range by range.
template <int K>
__device__ __forceinline__ void fold_partials(
    int i, int splits, const float* __restrict__ part_d2,
    const int* __restrict__ part_idx, const float* __restrict__ part_near,
    const int* __restrict__ part_cnt, float (&bd)[K], int (&bi)[K],
    float& near, int& cnt) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = CUDART_INF_F;
    bi[t] = 0;
  }
  near = CUDART_INF_F;
  cnt = 0;
  for (int s = 0; s < splits; ++s) {
    const size_t row = static_cast<size_t>(i) * splits + s;
    near = fminf(near, part_near[row]);
    cnt += part_cnt[row];
    merge_partial<K>(bd, bi, part_d2 + row * K, part_idx + row * K, 1);
  }
}

// Merges knn_stream's partials, or knn_banded's in sorted order.
template <int K>
__global__ void __launch_bounds__(kThreads) knn_stream_merge_kernel(
    int n, int splits, const float* __restrict__ part_d2,
    const int* __restrict__ part_idx, const float* __restrict__ part_near,
    const int* __restrict__ part_cnt, int* __restrict__ idx,
    float* __restrict__ dist, float* __restrict__ nearest,
    int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t member = blockIdx.y;
  part_d2 += K * splits * n * member;
  part_idx += K * splits * n * member;
  part_near += splits * n * member;
  part_cnt += splits * n * member;
  idx += K * n * member;
  dist += K * n * member;
  nearest += n * member;
  count += n * member;
  float bd[K];
  int bi[K];
  float near;
  int cnt;
  fold_partials<K>(i, splits, part_d2, part_idx, part_near, part_cnt, bd, bi,
                   near, cnt);
  write_row<K>(i, bd, bi, near, cnt, idx, dist, nearest, count);
}

// Merges knn_banded's partials of sorted row i and writes them to agent
// a = order[i]: ids through order (an empty slot's 0 becomes order[0]),
// the row block's overflow flag beside them.
template <int K>
__global__ void __launch_bounds__(kThreads) knn_banded_merge_kernel(
    int n, int splits, const float* __restrict__ part_d2,
    const int* __restrict__ part_idx, const float* __restrict__ part_near,
    const int* __restrict__ part_cnt, const long long* __restrict__ order,
    int band_blocks, const bool* __restrict__ block_overflow,
    int* __restrict__ idx, float* __restrict__ dist,
    float* __restrict__ nearest, bool* __restrict__ overflow,
    int* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t member = blockIdx.y;
  part_d2 += K * splits * n * member;
  part_idx += K * splits * n * member;
  part_near += splits * n * member;
  part_cnt += splits * n * member;
  order += n * member;
  block_overflow += band_blocks * member;
  idx += K * n * member;
  dist += K * n * member;
  nearest += n * member;
  overflow += n * member;
  count += n * member;
  float bd[K];
  int bi[K];
  float near;
  int cnt;
  fold_partials<K>(i, splits, part_d2, part_idx, part_near, part_cnt, bd, bi,
                   near, cnt);
  const long long a = order[i];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    idx[a * K + s] = static_cast<int>(order[bi[s]]);
    dist[a * K + s] = __fsqrt_rn(bd[s]);
  }
  nearest[a] = __fsqrt_rn(near);
  count[a] = cnt;
  overflow[a] = block_overflow[i / kRtile];
}

// One launch for ``members`` members of n rows (B = 1: the single swarm).
// 16-byte staging needs every member's first column 16-byte aligned.
int aligned16_of(const float* x, int members, int n) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         (members == 1 || n % 2 == 0);
}

template <int K>
cudaError_t launch_fused(const float* x, int members, int n, float r2,
                         const float* radius, int* idx, float* dist,
                         float* nearest, int* count, cudaStream_t stream) {
  const size_t steps = (static_cast<size_t>(n) + 31) / 32;
  const size_t smem = sizeof(float2) * 32 * steps + sizeof(HalfMerge<K>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn_fused_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (n + kFusedBlockRows - 1) / kFusedBlockRows;
  const int aligned16 = aligned16_of(x, members, n);
  knn_fused_kernel<K><<<dim3(blocks, members), kFusedWarps * 32, smem,
                        stream>>>(
      x, n, r2, radius, aligned16, idx, dist, nearest, count);
  return cudaGetLastError();
}

// knn_banded's window split on the current device: S ranges of whole
// kCtile tiles out of ``col_tiles``, as many as put ~4 blocks of kThreads
// rows on each SM over all ``members`` (at least one range, at most one
// per tile).
cudaError_t split_plan(int members, int n, int col_tiles,
                       int* cols_per_split, int* splits) {
  int dev = 0;
  int sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long row_blocks =
      static_cast<long long>(members) * ((n + kThreads - 1) / kThreads);
  const int want = static_cast<int>(std::min<long long>(
      col_tiles, std::max<long long>(1, (4 * sms + row_blocks - 1) /
                                             row_blocks)));
  const int tiles_per_split = (col_tiles + want - 1) / want;
  *cols_per_split = tiles_per_split * kCtile;
  *splits = (col_tiles + tiles_per_split - 1) / tiles_per_split;
  return cudaSuccess;
}

// Resident knn_stream blocks on the current device, all SMs together: SMs x
// the k = kPlanK instance's blocks per SM. Asked once per device.
cudaError_t stream_slots(long long* slots) {
  constexpr int kMaxDevices = 64;
  static long long cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *slots = cached[dev];
    return cudaSuccess;
  }
  int sms = 0;
  int per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, knn_stream_partial_kernel<kPlanK>, kFusedWarps * 32, 0);
  if (e != cudaSuccess) return e;
  *slots = static_cast<long long>(sms) * std::max(1, per_sm);
  if (dev < kMaxDevices) cached[dev] = *slots;
  return cudaSuccess;
}

// knn_stream's column split: the fewest ranges of whole kStreamUnit columns
// whose grid fills its last wave of resident blocks to kWaveFill (else the
// best-filled split), at least one range, at most one per unit.
cudaError_t stream_plan(int n, int* cols_per_split, int* splits) {
  if (n < 1) return cudaErrorInvalidValue;
  long long slots = 0;
  const cudaError_t e = stream_slots(&slots);
  if (e != cudaSuccess) return e;
  const long long row_blocks = (n + kFusedBlockRows - 1) / kFusedBlockRows;
  const int units = (n + kStreamUnit - 1) / kStreamUnit;
  int best = units;  // units per range
  double best_fill = -1.0;
  for (int want = 1; want <= units; ++want) {
    const int per = (units + want - 1) / want;
    if ((units + per - 1) / per != want) continue;  // not a split of its own
    const double waves = static_cast<double>(row_blocks * want) / slots;
    const double fill = waves / std::ceil(waves);
    if (fill > best_fill) {
      best_fill = fill;
      best = per;
    }
    if (fill >= kWaveFill) break;
  }
  *cols_per_split = best * kStreamUnit;
  *splits = (units + best - 1) / best;
  return cudaSuccess;
}

template <int K>
cudaError_t launch_merge(int members, int n, int splits, const float* part_d2,
                         const int* part_idx, const float* part_near,
                         const int* part_cnt, int* idx, float* dist,
                         float* nearest, int* count, cudaStream_t stream) {
  const cudaError_t e = cudaGetLastError();  // the partial launch
  if (e != cudaSuccess) return e;
  knn_stream_merge_kernel<K><<<dim3((n + kThreads - 1) / kThreads, members),
                               kThreads, 0, stream>>>(n, splits, part_d2,
                                                      part_idx,
                                         part_near, part_cnt, idx, dist,
                                         nearest, count);
  return cudaGetLastError();
}

// ``splits`` is the range count the caller sized the partials for; it must
// be the plan's. With one range the partials are not used (may be null).
template <int K>
cudaError_t launch_stream(const float* x, int members, int n, float r2,
                          const float* radius, int splits,
                          float* part_d2, int* part_idx, float* part_near,
                          int* part_cnt, int* idx, float* dist,
                          float* nearest, int* count, cudaStream_t stream) {
  int cols_per_split = 0;
  int planned = 0;
  const cudaError_t e = stream_plan(n, &cols_per_split, &planned);
  if (e != cudaSuccess) return e;
  if (planned != splits) return cudaErrorInvalidValue;
  const int row_blocks = (n + kFusedBlockRows - 1) / kFusedBlockRows;
  const int aligned16 = aligned16_of(x, members, n);
  knn_stream_partial_kernel<K><<<dim3(row_blocks, splits, members),
                                 kFusedWarps * 32, 0, stream>>>(
      x, n, r2, radius, cols_per_split, splits, aligned16, part_d2, part_idx,
      part_near, part_cnt, idx, dist, nearest, count);
  if (splits == 1) return cudaGetLastError();
  return launch_merge<K>(members, n, splits, part_d2, part_idx, part_near,
                         part_cnt, idx, dist, nearest, count, stream);
}

// Rows padded to whole RTILE and CTILE blocks (ops/knn.py _band_pad).
int band_pad(int n) {
  return std::max(kBandBlock, (n + kBandBlock - 1) / kBandBlock * kBandBlock);
}

// ``w`` window tiles per 256-row block; ``splits`` as for launch_stream.
// Every member's rows scan its own window of its own sorted columns: the
// member is the grid's z dimension, and each pointer steps by the
// member's stride (starts: one per 256-row block of the padded rows).
template <int K>
cudaError_t launch_banded_partials(const float* xs, int members, int n,
                                   float r2, const int* starts, int w,
                                   int splits, float* part_d2, int* part_idx,
                                   float* part_near, int* part_cnt,
                                   cudaStream_t stream) {
  int cols_per_split = 0;
  int planned = 0;
  const cudaError_t e = split_plan(members, n, w, &cols_per_split, &planned);
  if (e != cudaSuccess) return e;
  if (planned != splits) return cudaErrorInvalidValue;
  const int row_blocks = (n + kThreads - 1) / kThreads;
  knn_banded_partial_kernel<K><<<dim3(row_blocks, splits, members), kThreads,
                                 0, stream>>>(
      xs, n, band_pad(n) / kRtile, r2, starts, w * kCtile, cols_per_split,
      splits, part_d2, part_idx, part_near, part_cnt);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_banded(const float* xs, int members, int n, float r2,
                          const int* starts, int w, int splits,
                          float* part_d2, int* part_idx, float* part_near,
                          int* part_cnt, int* idx, float* dist,
                          float* nearest, int* count, cudaStream_t stream) {
  const cudaError_t e = launch_banded_partials<K>(
      xs, members, n, r2, starts, w, splits, part_d2, part_idx, part_near,
      part_cnt, stream);
  if (e != cudaSuccess) return e;
  return launch_merge<K>(members, n, splits, part_d2, part_idx, part_near,
                         part_cnt, idx, dist, nearest, count, stream);
}

cudaError_t launch_band_prologue(const void* x, int x_f64,
                                 const long long* order, int members, int n,
                                 int w, float r, float* xs, int* starts,
                                 bool* block_overflow, cudaStream_t stream) {
  const int n_pad = band_pad(n);
  if (n < 1 || w < 1 || w * kCtile > n_pad) return cudaErrorInvalidValue;
  const dim3 grid(n_pad / kRtile, members);
  if (x_f64) {
    knn_band_prologue_kernel<double><<<grid, kRtile, 0, stream>>>(
        static_cast<const double*>(x), order, n, n_pad, w * kCtile, r, xs,
        starts, block_overflow);
  } else {
    knn_band_prologue_kernel<float><<<grid, kRtile, 0, stream>>>(
        static_cast<const float*>(x), order, n, n_pad, w * kCtile, r, xs,
        starts, block_overflow);
  }
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_banded_agents(const void* x, int x_f64,
                                 const long long* order, int members, int n,
                                 float r, float r2, int w, int splits,
                                 float* xs, int* starts, bool* block_overflow,
                                 float* part_d2, int* part_idx,
                                 float* part_near, int* part_cnt, int* idx,
                                 float* dist, float* nearest, bool* overflow,
                                 int* count, cudaStream_t stream) {
  cudaError_t e = launch_band_prologue(x, x_f64, order, members, n, w, r, xs,
                                       starts, block_overflow, stream);
  if (e != cudaSuccess) return e;
  e = launch_banded_partials<K>(xs, members, n, r2, starts, w, splits,
                                part_d2, part_idx, part_near, part_cnt,
                                stream);
  if (e != cudaSuccess) return e;
  knn_banded_merge_kernel<K><<<dim3((n + kThreads - 1) / kThreads, members),
                               kThreads, 0, stream>>>(
      n, splits, part_d2, part_idx, part_near, part_cnt, order,
      band_pad(n) / kRtile, block_overflow, idx, dist, nearest, overflow,
      count);
  return cudaGetLastError();
}

}  // namespace

#define KNN_K_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

extern "C" {

// Returns a cudaError_t code (0 = launched); the wrapper raises otherwise.
// ``members`` >= 1 members of n rows each, one launch (x (B, N, 2));
// ``radius``: null (every member at the host r2) or B device radii.
int knn_fused_launch(const float* x, int members, int n, float r2,
                     const float* radius, int k, int* idx, float* dist,
                     float* nearest, int* count, void* stream) {
  if (members < 1 || members > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KNN_FUSED_CASE(KV)                                               \
  case KV:                                                               \
    return launch_fused<KV>(x, members, n, r2, radius, idx, dist, nearest, \
                            count, st);
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

// As knn_fused_launch; the partials are (B, N, splits, k) and (B, N, splits).
int knn_stream_launch(const float* x, int members, int n, float r2,
                      const float* radius, int k,
                      int splits, float* part_d2, int* part_idx,
                      float* part_near, int* part_cnt, int* idx, float* dist,
                      float* nearest, int* count, void* stream) {
  if (members < 1 || members > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KNN_STREAM_CASE(KV)                                                 \
  case KV:                                                                  \
    return launch_stream<KV>(x, members, n, r2, radius, splits, part_d2,    \
                             part_idx,                                      \
                             part_near, part_cnt, idx, dist, nearest, count, \
                             st);
  switch (k) {
    KNN_K_CASES(KNN_STREAM_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef KNN_STREAM_CASE
}

// knn_banded's window split for ``members`` members of N rows and a
// ``w``-tile window on the current device; the caller sizes the
// (B, N, splits, k) partials from it.
int knn_banded_plan(int members, int n, int w, int* cols_per_split,
                    int* splits) {
  if (w < 1 || members < 1 || members > 65535) return cudaErrorInvalidValue;
  return split_plan(members, n, w, cols_per_split, splits);
}

// xs (B, N, 2) float32, each member's rows in its y-sorted order; starts
// (B, n_pad / 256) int32: the first sorted column of each 256-row block's
// window of w * 512 columns. Outputs (B, N, ...) in sorted order, column
// ids sorted indices of the member.
int knn_banded_launch(const float* xs, int members, int n, float r2, int k,
                      const int* starts, int w, int splits, float* part_d2,
                      int* part_idx, float* part_near, int* part_cnt,
                      int* idx, float* dist, float* nearest, int* count,
                      void* stream) {
  if (members < 1 || members > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KNN_BANDED_CASE(KV)                                                   \
  case KV:                                                                    \
    return launch_banded<KV>(xs, members, n, r2, starts, w, splits, part_d2,  \
                             part_idx, part_near, part_cnt, idx, dist,        \
                             nearest, count, st);
  switch (k) {
    KNN_K_CASES(KNN_BANDED_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef KNN_BANDED_CASE
}

// x (B, N, 2) float32 (x_f64 = 0) or float64 (1), order (B, N) the stable
// y-sort of each member's rows (int64, indices within the member). Writes
// band_setup's xs (B, N, 2) float32 in sorted order, and per member and
// 256-row block of the padded rows the window start (int32) and overflow
// flag (bool) for a w-tile window.
int knn_band_prologue_launch(const void* x, int x_f64, const long long* order,
                             int members, int n, int w, float r, float* xs,
                             int* starts, bool* block_overflow,
                             void* stream) {
  if (members < 1 || members > 65535) return cudaErrorInvalidValue;
  return launch_band_prologue(x, x_f64, order, members, n, w, r, xs, starts,
                              block_overflow, static_cast<cudaStream_t>(stream));
}

// The whole banded call after the sort: prologue, window partials and the
// merge into agent order (idx, dist, nearest, overflow, count), for B
// members in one launch of each (B = 1: the single swarm). xs, starts and
// block_overflow are the prologue's scratch, as for
// knn_band_prologue_launch; splits as for knn_banded_launch.
int knn_banded_agents_launch(const void* x, int x_f64, const long long* order,
                             int members, int n, float r, float r2, int k,
                             int w, int splits, float* xs, int* starts,
                             bool* block_overflow, float* part_d2,
                             int* part_idx, float* part_near, int* part_cnt,
                             int* idx, float* dist, float* nearest,
                             bool* overflow, int* count, void* stream) {
  if (members < 1 || members > 65535) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define KNN_AGENTS_CASE(KV)                                                   \
  case KV:                                                                    \
    return launch_banded_agents<KV>(x, x_f64, order, members, n, r, r2, w,    \
                                    splits, xs, starts, block_overflow,       \
                                    part_d2, part_idx, part_near, part_cnt,   \
                                    idx, dist, nearest, overflow, count, st);
  switch (k) {
    KNN_K_CASES(KNN_AGENTS_CASE)
    default:
      return cudaErrorInvalidValue;
  }
#undef KNN_AGENTS_CASE
}

int knn_max_k() { return kMaxK; }

}  // extern "C"
