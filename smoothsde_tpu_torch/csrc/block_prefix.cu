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
// the accumulator (the later segment in time) comes first. Templated on
// E: instantiated for the CTCRW elements (Elem14 forward, Smooth9
// reverse) and the scalar-state BM_SSM / OU_SSM elements (Elem5 forward,
// Smooth3 reverse; csrc/diag_common.cuh).
//
// Design. One CUDA block of 512 threads per response dim. Thread t
// composes a contiguous chunk of ceil(NB / 512) blocks sequentially,
// the 512 chunk totals go through a Hillis-Steele inclusive scan in
// shared memory (9 rounds), and each thread rescans its chunk seeded
// with the exclusive prefix of the chunks before it.
//
// What bounds it on the H100. The data are small (NB * 14 values per
// dim, 1.75 MB at NB = 31,250 in f32), so HBM bytes do not matter. Each
// thread runs ~2 * NB / 512 + 9 dependent combines, and only d SMs work.
// Measured on an H100 SXM (700 W) at 1M steps, d = 2, f32: 0.92 ms
// (filter, 14-comp) and 0.52 ms (smoother, 9-comp), the slowest kernels
// of the path. Thread t reads blocks t * chunk + i, so a warp's load
// touches 32 cache lines per component, and the 512 threads' lines
// (~0.9 MB) do not stay in L1 between iterations: the chunk passes wait
// on L2 at every step. Shared memory holds E::N * 512 values: 57 KB for
// the 14-comp element in f64, above the 48 KB default, so the launch
// raises the kernel's dynamic shared memory limit first (20 KB for Elem5
// in f64 would not need it; the launch path is the same for every E).

#include "ctcrw_common.cuh"
#include "diag_common.cuh"

namespace ssde {

constexpr int kPrefixThreads = 512;

template <typename T, typename E>
__global__ void __launch_bounds__(kPrefixThreads)
    block_prefix_kernel(const T* __restrict__ totals, T* __restrict__ out,
                        int NB, int lanes, int reverse) {
  extern __shared__ unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);  // [E::N][kPrefixThreads]
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * NB;
  const int chunk = (NB + kPrefixThreads - 1) / kPrefixThreads;
  const int s0 = min(t * chunk, NB);
  const int s1 = min(s0 + chunk, NB);
  auto lane_of = [&](int s) { return base + (reverse ? NB - 1 - s : s); };

  // (i) this thread's chunk total, in scan order
  E acc = E::identity();
  for (int s = s0; s < s1; ++s) {
    E x;
    x.load(totals + lane_of(s), lanes);
    acc = E::combine(acc, x);
  }
  acc.store(sm + t, kPrefixThreads);
  __syncthreads();

  // (ii) Hillis-Steele inclusive scan over the chunk totals
  for (int k = 1; k < kPrefixThreads; k <<= 1) {
    E cur, prev;
    cur.load(sm + t, kPrefixThreads);
    if (t >= k) prev.load(sm + t - k, kPrefixThreads);
    __syncthreads();
    if (t >= k) {
      cur = E::combine(prev, cur);
      cur.store(sm + t, kPrefixThreads);
    }
    __syncthreads();
  }

  // (iii) rescan the chunk seeded with the exclusive chunk prefix
  E carry = E::identity();
  if (t > 0) carry.load(sm + t - 1, kPrefixThreads);
  for (int s = s0; s < s1; ++s) {
    const long long lane = lane_of(s);
    carry.store(out + lane, lanes);
    E x;
    x.load(totals + lane, lanes);
    carry = E::combine(carry, x);
  }
}

template <typename T, typename E>
int launch_block_prefix(const T* totals, T* out, int d, int NB, int reverse,
                        void* stream) {
  const int smem = static_cast<int>(sizeof(T) * E::N * kPrefixThreads);
  cudaError_t err = cudaFuncSetAttribute(
      block_prefix_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  block_prefix_kernel<T, E><<<d, kPrefixThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      totals, out, NB, d * NB, reverse);
  SSDE_RETURN_LAUNCH_STATUS();
}

}  // namespace ssde

#define SSDE_PREFIX_ENTRY(T, SUFFIX)                                           \
  extern "C" int ssde_block_prefix_filter_##SUFFIX(                            \
      const T* totals, T* out, int d, int NB, int reverse, void* stream) {     \
    return ssde::launch_block_prefix<T, ssde::Elem14<T>>(totals, out, d, NB,   \
                                                         reverse, stream);     \
  }                                                                            \
  extern "C" int ssde_block_prefix_smooth_##SUFFIX(                            \
      const T* totals, T* out, int d, int NB, int reverse, void* stream) {     \
    return ssde::launch_block_prefix<T, ssde::Smooth9<T>>(totals, out, d, NB,  \
                                                          reverse, stream);    \
  }                                                                            \
  extern "C" int ssde_block_prefix_diag_filter_##SUFFIX(                       \
      const T* totals, T* out, int d, int NB, int reverse, void* stream) {     \
    return ssde::launch_block_prefix<T, ssde::Elem5<T>>(totals, out, d, NB,    \
                                                        reverse, stream);      \
  }                                                                            \
  extern "C" int ssde_block_prefix_diag_smooth_##SUFFIX(                       \
      const T* totals, T* out, int d, int NB, int reverse, void* stream) {     \
    return ssde::launch_block_prefix<T, ssde::Smooth3<T>>(totals, out, d, NB,  \
                                                          reverse, stream);    \
  }

SSDE_PREFIX_ENTRY(float, f32)
SSDE_PREFIX_ENTRY(double, f64)
