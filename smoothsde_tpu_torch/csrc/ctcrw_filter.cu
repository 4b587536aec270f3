// CTCRW forward filter over the shared par-space stack: kernels K1a
// (block totals) and K1b (prefix-seeded rescan: filtered moments and
// per-lane log-likelihood partials).
//
// Replaces the TPU kernel smoothsde_tpu/ops/ctcrw_fused.py:
// fused_filter_par (its two pallas_calls, totals_kernel and
// scan_kernel). Plain PyTorch versions: filter_totals_plain and
// filter_scan_plain in smoothsde_tpu_torch/ops/ctcrw_fused.py.
//
// Design. One thread owns one lane (a contiguous block of L steps of one
// response dim) and walks its steps in order, rebuilding each step's
// entering CTCRW transition from the previous slot's par (carried in
// registers, seeded from the boundary rows `bd`), forming the 14-comp
// filtering element and composing it into its carry; K1b takes each
// step's predictive log-likelihood term from the carry before the step
// and writes its filtered moments after it. The stack is (L, rows,
// lanes), so at every step a warp reads 32 neighbouring values of each
// row (coalesced). The rows of step l + 1 are loaded while step l
// computes, and every division of the element math, the chain's four
// divisions by its determinant included, is BranchFreeDiv
// (csrc/ctcrw_common.cuh): the quotient of `/`, bit for bit on these
// operands, without the branch to its slow path.
//
// What bounds it on the H100. Per lane-step K1a reads 8 of the 10 stack
// rows and K1b reads 8 and writes 5 moments: at 1M steps, d = 2, f32
// (config 5a: 62,500 lanes of L = 32) that is 69 MB and 109 MB, 20.5 and
// 32.5 us at 3.35 TB/s. The arithmetic of a step is ~450 instructions per
// lane (three exp, an expm1, the two Taylor polynomials of psi and phi,
// 12 divisions in K1a and 13 in K1b, the 14-comp combine), issued by at
// most 16 warps per SM at this size: the walk is bound by issuing them,
// not by the bytes. Measured on an H100 SXM (700 W) at config 5a
// (tile_sweep.py, CUDA events per launch; PERF.md §6): f32 K1a 40.1, K1b
// 47.7 us; f64 86.1, 89.3 us (the walk with `/` and no prefetch: 50.6,
// 58.5; 89.7, 103.9). Tried and slower (PERF.md §6): the backward
// kernels' staged chunks (2-step chunks on 2 threads per lane, rows
// staged by cp.async, the carry on one thread) ran 50.3 / 57.9 us in f32
// and 115 / 132 in f64: staging and the shared-memory hand-off add ~50%
// more instructions than the extra warps hide. Registers (ptxas), f32: K1a
// 71, K1b 63 (f64: 128, 110); no shared memory, no spill; with
// kK1MinBlocks = 4 all 489 CUDA blocks of config 5a are resident at once
// in f32 and f64. Outputs: those of the walk with `/`, bit for bit.

#include "ctcrw_common.cuh"

namespace ssde {

// Lanes (one thread each) per CUDA block, CUDA blocks per SM asked of
// ptxas, and division (smoothsde_tpu_torch/tile_sweep.py times variants
// of these three lines).
constexpr int kK1Threads = 128;
constexpr int kK1MinBlocks = 4;
using K1Div = BranchFreeDiv;

template <typename T>
struct StepRows {
  T lt, ln, dtv, mu, y, upd, rst, live;
};

template <typename T>
__device__ __forceinline__ StepRows<T> read_rows(const T* __restrict__ stack,
                                                 int l, int t, int lanes) {
  const T* row = stack + (long long)l * kParRows * lanes + t;
  StepRows<T> s;
  s.lt = row[0];
  s.ln = row[(long long)lanes];
  s.dtv = row[2LL * lanes];
  s.mu = row[3LL * lanes];
  s.y = row[6LL * lanes];
  s.upd = row[7LL * lanes];
  s.rst = row[8LL * lanes];
  s.live = row[9LL * lanes];
  return s;
}

// Transition entering step l from the previous slot's par; identity when
// the previous slot was a track start or l is padding.
template <typename T>
__device__ __forceinline__ ParTerms<T> entering_terms(const StepRows<T>& s,
                                                      const T pv[5]) {
  const T Rm = T(1) - s.live * (T(1) - pv[4]);
  return par_terms<T, K1Div>(pv[0], pv[1], pv[2], pv[3], Rm);
}

template <typename T>
__device__ __forceinline__ void carry_par(const StepRows<T>& s, T pv[5]) {
  pv[0] = s.lt; pv[1] = s.ln; pv[2] = s.dtv; pv[3] = s.mu; pv[4] = s.rst;
}

template <typename T>
__global__ void __launch_bounds__(kK1Threads, kK1MinBlocks)
    filter_totals_kernel(const T* __restrict__ stack, const T* __restrict__ bd,
                         const T* __restrict__ hp, T p0_pos, T p0_vel,
                         T* __restrict__ totals, int L, int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const T h = hp[0];
  T pv[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) pv[i] = bd[(long long)i * lanes + t];
  Elem14<T> c = Elem14<T>::identity();
  StepRows<T> nxt = read_rows(stack, 0, t, lanes);
  for (int l = 0; l < L; ++l) {
    const StepRows<T> s = nxt;
    if (l + 1 < L) nxt = read_rows(stack, l + 1, t, lanes);  // in flight
    const ParTerms<T> w = entering_terms(s, pv);
    const Elem14<T> e = elem_from_vals<T, K1Div>(w, s.y, s.rst, s.upd,
                                                 p0_pos, p0_vel, h);
    c = Elem14<T>::template combine<K1Div>(c, e);
    carry_par(s, pv);
  }
  c.store(totals + t, lanes);
}

template <typename T>
__global__ void __launch_bounds__(kK1Threads, kK1MinBlocks)
    filter_scan_kernel(const T* __restrict__ stack, const T* __restrict__ bd,
                       const T* __restrict__ prefix, const T* __restrict__ hp,
                       T p0_pos, T p0_vel, T* __restrict__ moments,
                       T* __restrict__ llk, int L, int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const T h = hp[0];
  T pv[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) pv[i] = bd[(long long)i * lanes + t];
  Elem14<T> c;
  c.load(prefix + t, lanes);
  T acc = T(0);
  StepRows<T> nxt = read_rows(stack, 0, t, lanes);
  for (int l = 0; l < L; ++l) {
    const StepRows<T> s = nxt;
    if (l + 1 < L) nxt = read_rows(stack, l + 1, t, lanes);  // in flight
    const ParTerms<T> w = entering_terms(s, pv);
    const Elem14<T> e = elem_from_vals<T, K1Div>(w, s.y, s.rst, s.upd,
                                                 p0_pos, p0_vel, h);
    // BEFORE absorbing step l
    acc = acc + pred_llk<T, K1Div>(c, w, s.y, s.upd, h);
    c = Elem14<T>::template combine<K1Div>(c, e);
    T* m = moments + (long long)l * kMomRows * lanes + t;
    m[0] = c.b0;
    m[(long long)lanes] = c.b1;
    m[2LL * lanes] = c.C00;
    m[3LL * lanes] = c.C01;
    m[4LL * lanes] = c.C11;
    carry_par(s, pv);
  }
  llk[t] = acc;
}

inline dim3 k1_grid(int lanes) {
  return dim3((lanes + kK1Threads - 1) / kK1Threads);
}

}  // namespace ssde

#define SSDE_FILTER_ENTRY(T, SUFFIX)                                          \
  extern "C" int ssde_ctcrw_filter_totals_##SUFFIX(                           \
      const T* stack, const T* bd, const T* h, double p0_pos, double p0_vel,  \
      T* totals, int L, int lanes, void* stream) {                            \
    ssde::filter_totals_kernel<T>                                             \
        <<<ssde::k1_grid(lanes), ssde::kK1Threads, 0,                         \
           static_cast<cudaStream_t>(stream)>>>(stack, bd, h, T(p0_pos),      \
                                                T(p0_vel), totals, L, lanes); \
    SSDE_RETURN_LAUNCH_STATUS();                                              \
  }                                                                           \
  extern "C" int ssde_ctcrw_filter_scan_##SUFFIX(                             \
      const T* stack, const T* bd, const T* prefix, const T* h,               \
      double p0_pos, double p0_vel, T* moments, T* llk, int L, int lanes,     \
      void* stream) {                                                         \
    ssde::filter_scan_kernel<T><<<ssde::k1_grid(lanes), ssde::kK1Threads, 0,  \
                                  static_cast<cudaStream_t>(stream)>>>(       \
        stack, bd, prefix, h, T(p0_pos), T(p0_vel), moments, llk, L, lanes);  \
    SSDE_RETURN_LAUNCH_STATUS();                                              \
  }

SSDE_FILTER_ENTRY(float, f32)
SSDE_FILTER_ENTRY(double, f64)

extern "C" const char* ssde_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
