// Exclusive cross-block prefix (suffix when `reverse`) of per-block total
// elements, segmented per response dim: kernel K2.
//
// Replaces the TPU kernel smoothsde_tpu/ops/ctcrw_fused.py:
// _block_prefix_pallas. Plain PyTorch version: block_prefix_plain in
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
// and 4.5 MB for Smooth9 at 1M steps, d = 2, f32 (NB = 31,250), 2.1 and
// 1.3 us at the card's 3.35 TB/s; its ~NB * d combines (~150 flops each
// for Elem14) are ~0.1 us at 67 TFLOP/s. So bytes bound it, and at this
// size the latency of the launches more than either.
//
// Design: reduce, then scan, then rescan, three kernels launched by one
// C entry point on the caller's stream. A tile is kPrefixTile = 256
// consecutive blocks (in scan order) of one dim, one per thread.
//   1. block_prefix_reduce_kernel, grid (ntiles, d): thread j loads block
//      tile * 256 + j (NB - 1 - that when reverse; identity past NB), the
//      CUDA block scans its tile (warp scans with __shfl_up_sync per
//      component, then a scan of the 8 warp totals through shared
//      memory) and writes the tile total to the scratch (E::N, d*ntiles).
//   2. block_prefix_carry_kernel, grid (d): one CUDA block per dim turns
//      its ntiles tile totals into exclusive tile prefixes in place,
//      256 at a time with a carry (ntiles = 123 at NB = 31,250).
//   3. block_prefix_rescan_kernel, grid (ntiles, d): each tile scans
//      again and writes out = combine(tile prefix, in-tile exclusive).
// What this does about the faults of the one-block-per-dim design it
// replaces (0.92 / 0.52 ms for Elem14 / Smooth9 at the size above):
//   - it spread over d SMs only: now d * ntiles CUDA blocks (246 at
//     that size) over the 132 SMs;
//   - each thread ran a serial chain of ~2 * NB / 512 + 9 combines: now
//     each element goes through at most 5 + 3 + 2 combines per pass;
//   - thread t read block t * chunk + i, 32 cache lines per warp load:
//     now a warp's load of one component is 32 neighbouring values.
// Shared memory is static, E::N * 8 values (896 bytes for Elem14 in f64);
// no kernel spills (the f64 Elem14 carry uses 152 registers).
// Measured on an H100 SXM (700 W) at the size above, f32, device time per
// call: Elem14 22 us (reduce 7.3, carry 7.6, rescan 9.1), Smooth9 10 us;
// at d = 2 and d = 1, NB = 31,250 (the OU_SSM and BM_SSM fits) Elem5
// 8.5 / 8.0 us and Smooth3 5.6 / 5.3 us. Launch latency and the carry's
// single CUDA block per dim now bound it, ~10x the HBM bound.

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

}  // namespace ssde

#define SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, KIND, E)                              \
  extern "C" int ssde_block_prefix_##KIND##_##SUFFIX(                          \
      const T* totals, T* out, T* tiles, int d, int NB, int ntiles,            \
      int reverse, void* stream) {                                             \
    return ssde::launch_block_prefix<T, ssde::E<T>>(totals, out, tiles, d, NB, \
                                                    ntiles, reverse, stream);  \
  }

#define SSDE_PREFIX_ENTRY(T, SUFFIX)                     \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, filter, Elem14)       \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, smooth, Smooth9)      \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, diag_filter, Elem5)   \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, diag_smooth, Smooth3) \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, sqrt2, Sqrt14)        \
  SSDE_PREFIX_ENTRY_ONE(T, SUFFIX, sqrt1, Sqrt5)

SSDE_PREFIX_ENTRY(float, f32)
SSDE_PREFIX_ENTRY(double, f64)
