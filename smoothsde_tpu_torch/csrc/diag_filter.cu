// Scalar-state (BM_SSM / OU_SSM) forward filter over the forward stack:
// kernels D1a (block totals of the 5-comp filtering elements) and D1b
// (prefix-seeded rescan: filtered moments b, C and per-lane predictive
// log-likelihood partials).
//
// Replaces the TPU kernel smoothsde_tpu/ops/diag_fused.py: _diag_fwd (its
// two pallas_calls, totals_kernel and scan_kernel). Plain PyTorch
// versions: diag_filter_totals_plain and diag_filter_scan_plain in
// smoothsde_tpu_torch/ops/diag_fused.py.
//
// Design. One thread owns one lane (a contiguous block of L steps of one
// response dim) and walks its steps in order: each step's element comes
// from its own stack slot (t, q, c of the entering transition, y and the
// reset / update masks), so no carry besides the element is needed. The
// stack is (L, 6, lanes), so at every step a warp reads 32 neighbouring
// values of each row (coalesced).
//
// What bounds it on the H100. Per lane-step D1a reads 6 values and does
// one scalar combine (~15 flops, two divisions with the element); D1b
// also writes 2 moments and takes one log. At 1M steps, d = 2, f32 (2M
// lane-steps) that is 48 MB and 64 MB, 14 and 19 us at the card's
// 3.35 TB/s; the serial chain of L = 32 dependent combines per thread is
// short, so bytes should bound both. The simple design spends no shared
// memory: one coalesced pass over the stack per kernel, the carry in
// registers.

#include "diag_common.cuh"

namespace ssde {

template <typename T>
struct DiagFwdRow {
  T t, q, c, y, rst, upd;
};

template <typename T>
__device__ __forceinline__ DiagFwdRow<T> read_fwd(const T* __restrict__ stack,
                                                  int l, int i, int lanes) {
  const T* row = stack + (long long)l * kDiagFwdRows * lanes + i;
  DiagFwdRow<T> s;
  s.t = row[0];
  s.q = row[(long long)lanes];
  s.c = row[2LL * lanes];
  s.y = row[3LL * lanes];
  s.rst = row[4LL * lanes];
  s.upd = row[5LL * lanes];
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    diag_filter_totals_kernel(const T* __restrict__ stack,
                              const T* __restrict__ hp, T p0,
                              T* __restrict__ totals, int L, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const T h = hp[0];
  Elem5<T> c = Elem5<T>::identity();
  for (int l = 0; l < L; ++l) {
    const DiagFwdRow<T> s = read_fwd(stack, l, i, lanes);
    c = Elem5<T>::combine(c, elem1(s.t, s.q, s.c, s.y, s.rst, s.upd, h, p0));
  }
  c.store(totals + i, lanes);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    diag_filter_scan_kernel(const T* __restrict__ stack,
                            const T* __restrict__ prefix,
                            const T* __restrict__ hp, T p0,
                            T* __restrict__ moments, T* __restrict__ llk,
                            int L, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const T h = hp[0];
  Elem5<T> c;
  c.load(prefix + i, lanes);
  T acc = T(0);
  for (int l = 0; l < L; ++l) {
    const DiagFwdRow<T> s = read_fwd(stack, l, i, lanes);
    // predictive llk term BEFORE absorbing step l
    const T a_pred = s.t * c.b + s.c;
    const T Pp = s.t * s.t * c.C + s.q;
    const T F = Pp + h;
    const T u = s.y - a_pred;
    acc = acc + s.upd * T(-0.5) * (d_log(F) + u * u / F);
    c = Elem5<T>::combine(c, elem1(s.t, s.q, s.c, s.y, s.rst, s.upd, h, p0));
    T* m = moments + (long long)l * kDiagMomRows * lanes + i;
    m[0] = c.b;
    m[(long long)lanes] = c.C;
  }
  llk[i] = acc;
}

}  // namespace ssde

#define SSDE_DIAG_FILTER_ENTRY(T, SUFFIX)                                      \
  extern "C" int ssde_diag_filter_totals_##SUFFIX(                             \
      const T* stack, const T* h, double p0, T* totals, int L, int lanes,      \
      void* stream) {                                                          \
    ssde::diag_filter_totals_kernel<T>                                         \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                           \
           static_cast<cudaStream_t>(stream)>>>(stack, h, T(p0), totals, L,    \
                                                lanes);                        \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }                                                                            \
  extern "C" int ssde_diag_filter_scan_##SUFFIX(                               \
      const T* stack, const T* prefix, const T* h, double p0, T* moments,      \
      T* llk, int L, int lanes, void* stream) {                                \
    ssde::diag_filter_scan_kernel<T>                                           \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                           \
           static_cast<cudaStream_t>(stream)>>>(stack, prefix, h, T(p0),       \
                                                moments, llk, L, lanes);       \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }

SSDE_DIAG_FILTER_ENTRY(float, f32)
SSDE_DIAG_FILTER_ENTRY(double, f64)
