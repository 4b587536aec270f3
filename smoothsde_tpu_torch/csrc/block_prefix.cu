// Exclusive cross-block prefix (suffix when `reverse`) of per-block total
// elements, segmented per response dim: kernel K2.
//
// Replaces the TPU kernel smoothsde_tpu/ops/ctcrw_fused.py:
// _block_prefix_pallas (and, for the square-root elements, the JAX
// package's phase 2 `jax.lax.associative_scan`, ops/scan_utils.py:195).
// Plain PyTorch version: block_prefix_plain in
// smoothsde_tpu_torch/ops/ctcrw_fused.py.
//
// Input and output are (E::N, d * NB): component c of block b of dim dd
// at [c][dd * NB + b]. The element type E carries its combine, always
// called as combine(first, second) in SCAN order: for the filtering
// element (_combine2) scan order is time order; for the smoothing
// element (_combine2_rev(acc, new)) the scan runs backwards in time and
// the accumulator (the later segment in time) comes first. Every level
// of the scans below keeps that order: the first argument is the earlier
// in scan order. Templated on E: instantiated for the CTCRW elements
// (Elem14 forward, Smooth9 reverse), the scalar-state BM_SSM / OU_SSM
// elements (Elem5 forward, Smooth3 reverse; csrc/diag_common.cuh) and the
// square-root elements (Sqrt14, Sqrt5 forward; csrc/sqrt_common.cuh).
//
// What bounds it on the H100. The function reads each total once and
// writes each prefix once: 2 * E::N * d * NB values, 7.0 MB for Elem14
// and Sqrt14 and 4.5 MB for Smooth9 at 1M steps, d = 2, f32 (NB =
// 31,250), 2.1 and 1.3 us at the card's 3.35 TB/s. Its ~NB * d combines
// cost little for the moment-form elements (Elem14 ~150 flops);
// Sqrt14's combine is ~650 SASS instructions with 8 square roots and 16
// divisions on one dependent chain, so there the number of combines an
// element goes through and the length of each CUDA block's chain of
// them set the time.
//
// Two designs; the entry point (SSDE_PREFIX_ENTRY) picks one by element
// type at compile time.
//
// 1. Reduce / carry / rescan, for Elem14, Smooth9, Elem5, Smooth3: three
// kernels launched by one C entry point on the caller's stream. A tile
// is kPrefixTile = 256 consecutive blocks (in scan order) of one dim, one
// per thread.
//   a. block_prefix_reduce_kernel, grid (ntiles, d): thread j loads block
//      tile * 256 + j (NB - 1 - that when reverse; identity past NB), the
//      CUDA block scans its tile (warp scans with __shfl_up_sync per
//      component, then a scan of the 8 warp totals through shared
//      memory) and writes the tile total to the scratch (E::N, d*ntiles).
//   b. block_prefix_carry_kernel, grid (d): one CUDA block per dim turns
//      its ntiles tile totals into exclusive tile prefixes in place,
//      256 at a time with a carry (ntiles = 123 at NB = 31,250).
//   c. block_prefix_rescan_kernel, grid (ntiles, d): each tile scans
//      again and writes out = combine(tile prefix, in-tile exclusive).
// Against the one-block-per-dim design it replaced (0.92 / 0.52 ms for
// Elem14 / Smooth9 at the size above) it spreads over d * ntiles CUDA
// blocks (246), each element goes through at most 5 + 3 + 2 combines a
// pass, and a warp's load of one component is 32 neighbouring values.
// Shared memory is static, E::N * 8 values; no kernel spills. Measured on
// an H100 SXM (700 W) at the size above, f32, device time per call:
// Elem14 22 us (reduce 7.3, carry 7.6, rescan 9.1), Smooth9 10 us; at
// d = 2 and d = 1, NB = 31,250 (the OU_SSM and BM_SSM fits) Elem5
// 8.5 / 8.0 us and Smooth3 5.6 / 5.3 us: ~2.5 us a kernel whatever the
// combine, ~10x the HBM bound.
//
// 2. The run design, for Sqrt14 and Sqrt5 (`sqrt2` / `sqrt1`). Design 1
// puts an element through ~13 combines (a full block scan in the reduce
// only to keep the tile total, another in the rescan, and the carry's
// chain of ~10 in one CUDA block per dim while the other SMs idle) and
// inlines nine copies of the combine in a kernel; with Sqrt14 that took
// 83.5 us (reduce 25.1, carry 28.0, rescan 30.5) at 5a's shape. Here a
// tile is kRunTile = kRunThreads * kRun = 128 * 4 blocks and thread t
// owns the run of kRun consecutive blocks t * kRun ..:
//   a. block_prefix_runs_kernel, grid (ntiles, d): the tile is loaded
//      coalesced (a warp reads 32 neighbouring values of a component)
//      into shared memory, each thread composes its run (kRun - 1
//      combines), the CUDA block scans the 128 run totals, and the
//      kernel writes each thread's exclusive prefix within the tile and
//      the tile total to the scratch;
//   b. block_prefix_runs_rescan_kernel, grid (ntiles, d): each CUDA block
//      composes, in order, the totals of the tiles before its own
//      (ordered_reduce: at most a few hundred at the port's sizes, 61 at
//      5a), seeds each thread with combine(tile prefix, its exclusive
//      prefix) and walks the run (kRun - 1 combines), writing through
//      shared memory so that the stores coalesce too.
// About 2.7 combines an element in all, from ~13; two launches; no
// single-block phase; every loop that combines is kept rolled, so a
// kernel holds 3-4 copies of the combine. The association depends on NB
// and the geometry only: two calls give the same bits. In f32 the
// divisions of the combine are BranchFreeDiv (no FCHK slow-path branch;
// the same bits as `/` on these operands) and ssqrt / sdiv are selects
// (sqrt_common.cuh); f64 keeps `/`. Shared memory: the tile, E::N *
// (kRunTile + kRunTile / 32) values, dynamic (59 KB for Sqrt14 in f64,
// above 48 KB only after cudaFuncSetAttribute). Measured on an H100 SXM
// (700 W), NB = 31,250, d = 2, device time per call: Sqrt14 19.4 us in
// f32 (runs 9.6, rescan 9.8; 83 us before) and 71 us in f64 (135
// before), Sqrt5 8.2 / 11.8 us (12.4 / 16.9 before). Runs of 2 or 8,
// 64 or 256 threads, the run's prefixes kept for a one-level walk, or a
// tree over the run timed the same or slower (PERF.md §6).

#include "ctcrw_common.cuh"
#include "diag_common.cuh"
#include "sqrt_common.cuh"

namespace ssde {

constexpr int kPrefixTile = 256;  // blocks per tile = threads per CUDA block
constexpr int kPrefixWarps = kPrefixTile / 32;

// x of lane (lane - k) of the warp; a lane below k gets its own x.
template <typename T, typename E>
__device__ __forceinline__ E shfl_up(const E& x, int k) {
  T v[E::N];
  x.store(v, 1);
#pragma unroll
  for (int c = 0; c < E::N; ++c) v[c] = __shfl_up_sync(0xffffffffu, v[c], k);
  E r;
  r.load(v, 1);
  return r;
}

// Inclusive scan over the first W lanes of a warp, lane order = scan
// order (Hillis-Steele; the shifted value is the earlier one). Every lane
// of the warp must call it.
template <int W, typename T, typename E>
__device__ __forceinline__ E warp_inclusive(E x, int lane) {
#pragma unroll
  for (int k = 1; k < W; k <<= 1) {
    const E y = shfl_up<T>(x, k);
    if (lane >= k) x = E::combine(y, x);
  }
  return x;
}

// Exclusive scan of one element per thread over a CUDA block of
// kPrefixTile threads, thread order = scan order. Returns the thread's
// exclusive prefix (identity in thread 0) and sets `total` to the block's
// composition in every thread. Every thread of the block must call it.
template <typename T, typename E>
__device__ E block_exclusive(const E& x, E& total) {
  __shared__ T wsum[E::N * kPrefixWarps];  // [c][warp]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const E inc = warp_inclusive<32, T>(x, lane);
  const E ex = shfl_up<T>(inc, 1);
  if (lane == 31) inc.store(wsum + w, kPrefixWarps);
  __syncthreads();
  if (w == 0) {  // inclusive scan of the warp totals, in place
    E s = E::identity();
    if (lane < kPrefixWarps) s.load(wsum + lane, kPrefixWarps);
    s = warp_inclusive<kPrefixWarps, T>(s, lane);
    if (lane < kPrefixWarps) s.store(wsum + lane, kPrefixWarps);
  }
  __syncthreads();
  E seed = E::identity();  // the warps before this one
  if (w > 0) seed.load(wsum + w - 1, kPrefixWarps);
  total.load(wsum + kPrefixWarps - 1, kPrefixWarps);
  __syncthreads();  // wsum is free again for the next call
  return lane == 0 ? seed : E::combine(seed, ex);
}

// Block `s` (scan order) of dim dd, or identity past NB.
template <typename T, typename E>
__device__ __forceinline__ E load_block(const T* __restrict__ totals, int dd,
                                        int s, int NB, int reverse,
                                        long long& lane) {
  lane = (long long)dd * NB + (reverse ? NB - 1 - s : s);
  E x = E::identity();
  if (s < NB) x.load(totals + lane, (long long)gridDim.y * NB);
  return x;
}

template <typename T, typename E>
__global__ void __launch_bounds__(kPrefixTile)
    block_prefix_reduce_kernel(const T* __restrict__ totals,
                               T* __restrict__ tiles, int NB, int ntiles,
                               int reverse) {
  const int tile = blockIdx.x, dd = blockIdx.y;
  long long lane;
  const E x = load_block<T, E>(totals, dd, tile * kPrefixTile + threadIdx.x,
                               NB, reverse, lane);
  E total;
  block_exclusive<T>(x, total);
  if (threadIdx.x == 0)
    total.store(tiles + (long long)dd * ntiles + tile,
                (long long)gridDim.y * ntiles);
}

template <typename T, typename E>
__global__ void __launch_bounds__(kPrefixTile)
    block_prefix_carry_kernel(T* __restrict__ tiles, int ntiles) {
  const long long stride = (long long)gridDim.x * ntiles;
  T* row = tiles + (long long)blockIdx.x * ntiles;
  E carry = E::identity();
  for (int t0 = 0; t0 < ntiles; t0 += kPrefixTile) {
    const int t = t0 + threadIdx.x;
    E x = E::identity();
    if (t < ntiles) x.load(row + t, stride);
    E total;
    const E ex = block_exclusive<T>(x, total);
    // each thread rewrites only the slot it read
    if (t < ntiles) E::combine(carry, ex).store(row + t, stride);
    carry = E::combine(carry, total);
  }
}

template <typename T, typename E>
__global__ void __launch_bounds__(kPrefixTile)
    block_prefix_rescan_kernel(const T* __restrict__ totals,
                               const T* __restrict__ tiles,
                               T* __restrict__ out, int NB, int ntiles,
                               int reverse) {
  const int tile = blockIdx.x, dd = blockIdx.y;
  const int s = tile * kPrefixTile + threadIdx.x;
  long long lane;
  const E x = load_block<T, E>(totals, dd, s, NB, reverse, lane);
  E total;
  const E ex = block_exclusive<T>(x, total);
  if (s < NB) {
    E seed;  // the tiles before this one
    seed.load(tiles + (long long)dd * ntiles + tile,
              (long long)gridDim.y * ntiles);
    E::combine(seed, ex).store(out + lane, (long long)gridDim.y * NB);
  }
}

// tiles: scratch of E::N * d * ntiles values, ntiles = ceil(NB / 256);
// the caller passes ntiles so that a scratch sized for another tile
// is refused instead of overrun.
template <typename T, typename E>
int launch_block_prefix(const T* totals, T* out, T* tiles, int d, int NB,
                        int ntiles, int reverse, void* stream) {
  if (d < 1 || NB < 1 || ntiles != (NB + kPrefixTile - 1) / kPrefixTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(ntiles, d);
  block_prefix_reduce_kernel<T, E><<<grid, kPrefixTile, 0, st>>>(
      totals, tiles, NB, ntiles, reverse);
  block_prefix_carry_kernel<T, E><<<d, kPrefixTile, 0, st>>>(tiles, ntiles);
  block_prefix_rescan_kernel<T, E><<<grid, kPrefixTile, 0, st>>>(
      totals, tiles, out, NB, ntiles, reverse);
  SSDE_RETURN_LAUNCH_STATUS();
}

// ---- the run design, for element types whose combine is expensive ----
//
// Sqrt14 and Sqrt5 (sqrt2 / sqrt1). A tile is kRunTile = kRunThreads *
// kRun consecutive blocks (scan order) of one dim; thread t owns the run
// of kRun blocks t * kRun .. t * kRun + kRun - 1 of its tile.
constexpr int kRunThreads = 128;  // threads per CUDA block
constexpr int kRun = 4;           // consecutive blocks per thread
constexpr int kRunTile = kRunThreads * kRun;
constexpr int kRunWarps = kRunThreads / 32;
// shared-memory slot of tile position i: one pad slot every 32, so that a
// warp's reads of its threads' j-th run element (stride kRun = 4) fall in
// 32 different f32 banks
constexpr int kRunSlots = kRunTile + kRunTile / 32;
__device__ __forceinline__ int run_slot(int i) { return i + (i >> 5); }

// The run design's combine: f32 divisions branch-free (f64 keeps `/`).
template <typename E>
__device__ __forceinline__ E run_combine(const E& a, const E& b) {
  return E::template combine<BranchFreeDiv>(a, b);
}

// x of lane (lane + k) of the warp; a lane above 31 - k gets its own x.
template <typename T, typename E>
__device__ __forceinline__ E shfl_down(const E& x, int k) {
  T v[E::N];
  x.store(v, 1);
#pragma unroll
  for (int c = 0; c < E::N; ++c)
    v[c] = __shfl_down_sync(0xffffffffu, v[c], k);
  E r;
  r.load(v, 1);
  return r;
}

// The tile's blocks of dim dd into sh ([c][run_slot(i)], identity past
// NB): load k of thread t reads tile position k * kRunThreads + t, so a
// warp reads 32 neighbouring values of one component.
template <typename T, typename E>
__device__ __forceinline__ void load_tile(const T* __restrict__ totals,
                                          T* sh, int dd, int tile, int NB,
                                          int reverse) {
  const long long cs = (long long)gridDim.y * NB;
  const T* base = totals + (long long)dd * NB;
  T id[E::N];
  E::identity().store(id, 1);
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int i = k * kRunThreads + threadIdx.x;
    const int s = tile * kRunTile + i;
    const long long b = reverse ? NB - 1 - s : s;
#pragma unroll
    for (int c = 0; c < E::N; ++c)
      sh[c * kRunSlots + run_slot(i)] = s < NB ? base[c * cs + b] : id[c];
  }
}

// sh back to out, the blocks below NB; the mirror of load_tile.
template <typename T, typename E>
__device__ __forceinline__ void store_tile(const T* sh, T* __restrict__ out,
                                           int dd, int tile, int NB,
                                           int reverse) {
  const long long cs = (long long)gridDim.y * NB;
  T* base = out + (long long)dd * NB;
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    const int i = k * kRunThreads + threadIdx.x;
    const int s = tile * kRunTile + i;
    if (s >= NB) continue;
    const long long b = reverse ? NB - 1 - s : s;
#pragma unroll
    for (int c = 0; c < E::N; ++c)
      base[c * cs + b] = sh[c * kRunSlots + run_slot(i)];
  }
}

// Exclusive scan of one element per thread over the kRunThreads threads,
// thread order = scan order (warp Hillis-Steele scans, then a scan of the
// kRunWarps warp totals in warp 0). Returns the thread's exclusive prefix
// (identity in thread 0) and sets `total` to the composition of all.
// Every thread must call it.
template <typename T, typename E>
__device__ E run_block_exclusive(const E& x, E& total) {
  __shared__ T wsum[E::N * kRunWarps];  // [c][warp]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  E inc = x;
#pragma unroll 1
  for (int k = 1; k < 32; k <<= 1) {
    const E y = shfl_up<T>(inc, k);
    if (lane >= k) inc = run_combine(y, inc);
  }
  const E ex = shfl_up<T>(inc, 1);
  if (lane == 31) inc.store(wsum + w, kRunWarps);
  __syncthreads();
  if (w == 0) {  // inclusive scan of the warp totals, in place
    E s = E::identity();
    if (lane < kRunWarps) s.load(wsum + lane, kRunWarps);
#pragma unroll 1
    for (int k = 1; k < kRunWarps; k <<= 1) {
      const E y = shfl_up<T>(s, k);
      if (lane >= k) s = run_combine(y, s);
    }
    if (lane < kRunWarps) s.store(wsum + lane, kRunWarps);
  }
  __syncthreads();
  total.load(wsum + kRunWarps - 1, kRunWarps);
  if (w == 0) return lane == 0 ? E::identity() : ex;
  E seed;  // the warps before this one
  seed.load(wsum + w - 1, kRunWarps);
  return lane == 0 ? seed : run_combine(seed, ex);
}

// The composition, in order, of the n > 0 elements p[k * 1] (k < n,
// component stride cs): the tile totals before a tile. Thread t combines
// its ceil(n / kRunThreads) consecutive ones, each warp its threads' in a
// tree (shfl_down), and every thread the warps' in order; the association
// depends on n alone, so every call gives the same bits. Every thread
// must call it; all get the result.
template <typename T, typename E>
__device__ E ordered_reduce(const T* __restrict__ p, int n, long long cs) {
  __shared__ T wsum[E::N * kRunWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int per = (n + kRunThreads - 1) / kRunThreads;
  const int used = (n + per - 1) / per;  // threads that hold elements
  const int k0 = threadIdx.x * per;
  E acc = E::identity();
  if (k0 < n) {
    acc.load(p + k0, cs);
    const int k1 = min(k0 + per, n);
#pragma unroll 1
    for (int k = k0 + 1; k < k1; ++k) {
      E x;
      x.load(p + k, cs);
      acc = run_combine(acc, x);
    }
  }
  const int wn = min(32, used - w * 32);  // this warp's such threads
#pragma unroll 1
  for (int k = 1; k < wn; k <<= 1) {      // lane i: i .. i + 2k - 1
    const E y = shfl_down<T>(acc, k);
    if (lane + k < wn) acc = run_combine(acc, y);
  }
  if (lane == 0 && wn > 0) acc.store(wsum + w, kRunWarps);
  __syncthreads();
  E r;
  r.load(wsum, kRunWarps);
#pragma unroll 1
  for (int q = 1; q * 32 < used; ++q) {
    E x;
    x.load(wsum + q, kRunWarps);
    r = run_combine(r, x);
  }
  __syncthreads();  // wsum is free again
  return r;
}

// Scratch (E::N, d * ntiles * (kRunThreads + 1)): the tile totals
// [c][dd * ntiles + tile], then each thread's exclusive prefix within its
// tile [c][d * ntiles + (dd * ntiles + tile) * kRunThreads + t].
__device__ __forceinline__ long long run_scratch_stride(int ntiles) {
  return (long long)gridDim.y * ntiles * (kRunThreads + 1);
}

// Pass 1, grid (ntiles, d): each thread composes its run (kRun - 1
// combines), the CUDA block scans the runs' totals; writes the tile total
// and every thread's exclusive prefix within the tile.
template <typename T, typename E>
__global__ void __launch_bounds__(kRunThreads)
    block_prefix_runs_kernel(const T* __restrict__ totals,
                             T* __restrict__ scratch, int NB, int ntiles,
                             int reverse) {
  extern __shared__ __align__(16) unsigned char run_smem[];
  T* sh = reinterpret_cast<T*>(run_smem);
  const int tile = blockIdx.x, dd = blockIdx.y;
  load_tile<T, E>(totals, sh, dd, tile, NB, reverse);
  __syncthreads();
  const int i0 = threadIdx.x * kRun;
  E acc;
  acc.load(sh + run_slot(i0), kRunSlots);
#pragma unroll 1
  for (int j = 1; j < kRun; ++j) {
    E x;
    x.load(sh + run_slot(i0 + j), kRunSlots);
    acc = run_combine(acc, x);
  }
  E total;
  const E ex = run_block_exclusive<T>(acc, total);
  const long long cs = run_scratch_stride(ntiles);
  const long long t_idx = (long long)dd * ntiles + tile;
  ex.store(scratch + (long long)gridDim.y * ntiles + t_idx * kRunThreads +
               threadIdx.x,
           cs);
  if (threadIdx.x == 0) total.store(scratch + t_idx, cs);
}

// Pass 2, grid (ntiles, d): the tile's prefix is the ordered composition
// of the tile totals before it (ordered_reduce; no single-block carry
// pass); each thread seeds its run with combine(tile prefix, its
// exclusive prefix) and walks it (kRun - 1 combines), writing every
// block's exclusive prefix.
template <typename T, typename E>
__global__ void __launch_bounds__(kRunThreads)
    block_prefix_runs_rescan_kernel(const T* __restrict__ totals,
                                    const T* __restrict__ scratch,
                                    T* __restrict__ out, int NB, int ntiles,
                                    int reverse) {
  extern __shared__ __align__(16) unsigned char run_smem[];
  T* sh = reinterpret_cast<T*>(run_smem);
  const int tile = blockIdx.x, dd = blockIdx.y;
  const long long cs = run_scratch_stride(ntiles);
  const long long t_idx = (long long)dd * ntiles + tile;
  load_tile<T, E>(totals, sh, dd, tile, NB, reverse);
  E pre;  // this thread's exclusive prefix within the tile
  pre.load(scratch + (long long)gridDim.y * ntiles + t_idx * kRunThreads +
               threadIdx.x,
           cs);
  if (tile > 0) {  // the same branch for the whole CUDA block
    const E seed = ordered_reduce<T, E>(scratch + (long long)dd * ntiles,
                                        tile, cs);
    pre = threadIdx.x == 0 ? seed : run_combine(seed, pre);
  }
  __syncthreads();  // the tile is in sh
  const int i0 = threadIdx.x * kRun;
  const int s0 = tile * kRunTile + i0;
#pragma unroll 1
  for (int j = 0; j < kRun; ++j) {
    E x;
    x.load(sh + run_slot(i0 + j), kRunSlots);
    pre.store(sh + run_slot(i0 + j), kRunSlots);
    if (j + 1 < kRun && s0 + j + 1 < NB) pre = run_combine(pre, x);
  }
  __syncthreads();
  store_tile<T, E>(sh, out, dd, tile, NB, reverse);
}

// scratch: E::N * d * cols values, cols = ntiles * (kRunThreads + 1),
// ntiles = ceil(NB / kRunTile); the caller passes cols, so that a scratch
// sized for another geometry is refused instead of overrun.
template <typename T, typename E>
int launch_block_prefix_runs(const T* totals, T* out, T* scratch, int d,
                             int NB, int cols, int reverse, void* stream) {
  const int ntiles = NB > 0 ? (NB + kRunTile - 1) / kRunTile : 0;
  if (d < 1 || NB < 1 || cols != ntiles * (kRunThreads + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bytes = static_cast<int>(sizeof(T)) * E::N * kRunSlots;
  if (bytes > 48 * 1024) {  // f64 Sqrt14: 59,136 bytes
    cudaError_t e = cudaFuncSetAttribute(
        block_prefix_runs_kernel<T, E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(block_prefix_runs_rescan_kernel<T, E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(ntiles, d);
  block_prefix_runs_kernel<T, E><<<grid, kRunThreads, bytes, st>>>(
      totals, scratch, NB, ntiles, reverse);
  block_prefix_runs_rescan_kernel<T, E><<<grid, kRunThreads, bytes, st>>>(
      totals, scratch, out, NB, ntiles, reverse);
  SSDE_RETURN_LAUNCH_STATUS();
}

}  // namespace ssde

#define SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, KIND, E, LAUNCH)                      \
  extern "C" int ssde_block_prefix_##KIND##_##SUFFIX(                          \
      const T* totals, T* out, T* tiles, int d, int NB, int ntiles,            \
      int reverse, void* stream) {                                             \
    return ssde::LAUNCH<T, ssde::E<T>>(totals, out, tiles, d, NB, ntiles,      \
                                       reverse, stream);                       \
  }

// the moment-form elements: reduce / carry / rescan; the square-root
// ones: the run design
#define SSDE_PREFIX_ENTRY(T, SUFFIX)                                         \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, filter, Elem14, launch_block_prefix)      \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, smooth, Smooth9, launch_block_prefix)     \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, diag_filter, Elem5, launch_block_prefix)  \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, diag_smooth, Smooth3, launch_block_prefix) \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, sqrt2, Sqrt14, launch_block_prefix_runs)  \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, sqrt1, Sqrt5, launch_block_prefix_runs)

SSDE_PREFIX_ENTRY(float, f32)
SSDE_PREFIX_ENTRY(double, f64)
