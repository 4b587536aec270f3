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
// filtering element and composing it into its carry. The stack is
// (L, rows, lanes), so at every step a warp reads 32 neighbouring values
// of each row (coalesced).
//
// What bounds it on the H100. Per lane-step K1a reads 8 of the 10 stack
// rows and K1b reads 8 and writes 5 moments: at 1M steps, d = 2, f32
// (2M lane-steps) that is 64 MB and 104 MB, 19 and 31 us at the card's
// 3.35 TB/s. The serial chain is L = 32 dependent 14-comp combines per
// thread (~150 flops, three divisions each), plus ~60 flops and three
// exp/expm1 of transition terms that do not depend on the carry and
// overlap it. Measured on an H100 SXM (700 W) at that size: K1a 49 us
// (1.3 TB/s), K1b 55 us (1.9 TB/s), 40-57% of the HBM peak with 62,500
// threads, so bytes bound them more than the chain does. The simple
// design spends no shared memory: one coalesced pass over the stack per
// kernel, the carry in registers.

#include "ctcrw_common.cuh"

namespace ssde {

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
  return par_terms(pv[0], pv[1], pv[2], pv[3], Rm);
}

template <typename T>
__device__ __forceinline__ void carry_par(const StepRows<T>& s, T pv[5]) {
  pv[0] = s.lt; pv[1] = s.ln; pv[2] = s.dtv; pv[3] = s.mu; pv[4] = s.rst;
}

template <typename T>
__global__ void __launch_bounds__(128)
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
  for (int l = 0; l < L; ++l) {
    const StepRows<T> s = read_rows(stack, l, t, lanes);
    const ParTerms<T> w = entering_terms(s, pv);
    const Elem14<T> e = elem_from_vals(w, s.y, s.rst, s.upd, p0_pos, p0_vel, h);
    c = Elem14<T>::combine(c, e);
    carry_par(s, pv);
  }
  c.store(totals + t, lanes);
}

template <typename T>
__global__ void __launch_bounds__(128)
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
  for (int l = 0; l < L; ++l) {
    const StepRows<T> s = read_rows(stack, l, t, lanes);
    const ParTerms<T> w = entering_terms(s, pv);
    const Elem14<T> e = elem_from_vals(w, s.y, s.rst, s.upd, p0_pos, p0_vel, h);
    acc = acc + pred_llk(c, w, s.y, s.upd, h);  // BEFORE absorbing step l
    c = Elem14<T>::combine(c, e);
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

}  // namespace ssde

#define SSDE_FILTER_ENTRY(T, SUFFIX)                                          \
  extern "C" int ssde_ctcrw_filter_totals_##SUFFIX(                           \
      const T* stack, const T* bd, const T* h, double p0_pos, double p0_vel,  \
      T* totals, int L, int lanes, void* stream) {                            \
    ssde::filter_totals_kernel<T>                                             \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                          \
           static_cast<cudaStream_t>(stream)>>>(stack, bd, h, T(p0_pos),      \
                                                T(p0_vel), totals, L, lanes); \
    SSDE_RETURN_LAUNCH_STATUS();                                              \
  }                                                                           \
  extern "C" int ssde_ctcrw_filter_scan_##SUFFIX(                             \
      const T* stack, const T* bd, const T* prefix, const T* h,               \
      double p0_pos, double p0_vel, T* moments, T* llk, int L, int lanes,     \
      void* stream) {                                                         \
    ssde::filter_scan_kernel<T><<<ssde::grid_for(lanes), ssde::kThreads, 0,   \
                                  static_cast<cudaStream_t>(stream)>>>(       \
        stack, bd, prefix, h, T(p0_pos), T(p0_vel), moments, llk, L, lanes);  \
    SSDE_RETURN_LAUNCH_STATUS();                                              \
  }

SSDE_FILTER_ENTRY(float, f32)
SSDE_FILTER_ENTRY(double, f64)

extern "C" const char* ssde_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
