// CTCRW element-space fused filter and Fisher-identity backward: kernels
// K4a (block totals of the filtering elements), K4b (prefix-seeded rescan:
// filtered moments and per-lane log-likelihood partials), K5a (reverse-time
// block totals of the RTS smoothing elements) and K5b (suffix-seeded
// reverse rescan emitting the element-space score).
//
// Replaces the TPU kernels smoothsde_tpu/ops/ctcrw_fused.py: fused_filter
// (its pallas_calls totals_kernel, :410, and scan_kernel, :525) and
// fused_backward (sm_totals_kernel, :1105, and score_kernel, :1260). Plain
// PyTorch versions: elem_filter_totals_plain, elem_filter_scan_plain,
// elem_smooth_totals_plain and elem_score_scan_plain in
// smoothsde_tpu_torch/ops/ctcrw_fused.py.
//
// Design. The par-space kernels (ctcrw_filter.cu, ctcrw_backward.cu)
// without the par algebra: the transition pieces come precomputed in the
// stacks instead of being rebuilt from (log tau, log nu, dt, mu), so K4 is
// K1 without `par_terms` and its lane-boundary carry, and K5b is K3b
// without the par chain rule. One thread owns one lane (L steps of one
// response dim, L ~ 32), the carry lives in registers, the stacks are
// (L, rows, lanes) so a warp reads 32 neighbouring values of each row:
//
//   forward  (L, 10, lanes): f01 f11 q00 q01 q11 c0 c1 y rst upd
//   backward (L, 12, lanes): fn01 fn11 qn00 qn01 qn11 cn0 cn1 te tvn y upd rst
//
// The element algebra is ctcrw_common.cuh's, shared with the par-space
// kernels.
//
// What bounds it on the H100. Per lane-step K4a reads 10 rows, K4b reads 10
// and writes 5 moments, K5a reads 8 rows and 5 moments, K5b reads 12 rows
// and 5 moments and writes 8 cotangents: at 1M steps, d = 2, f32 (2M
// lane-steps) 80, 120, 104 and 200 MB, 24-60 us at 3.35 TB/s. The serial
// chain per thread is L dependent combines, as in K1 / K3; the per-step
// element build does not depend on the carry and overlaps it. So these
// kernels are bound by HBM bytes, more so than K1 / K3, which rebuild the
// transition from 4 par rows instead of reading 7.

#include "ctcrw_common.cuh"

namespace ssde {

constexpr int kElemFwdRows = 10;
constexpr int kElemBwdRows = 12;
constexpr int kElemCotRows = 8;  // f01 f11 q00 q01 q11 c0 c1 y

// The first 7 rows of either stack: the step's transition.
template <typename T>
__device__ __forceinline__ Trans<T> read_trans(const T* row, int lanes) {
  Trans<T> w;
  w.f01 = row[0];
  w.f11 = row[(long long)lanes];
  w.q00 = row[2LL * lanes];
  w.q01 = row[3LL * lanes];
  w.q11 = row[4LL * lanes];
  w.c0 = row[5LL * lanes];
  w.c1 = row[6LL * lanes];
  return w;
}

template <typename T>
__global__ void __launch_bounds__(128)
    elem_filter_totals_kernel(const T* __restrict__ stack,
                              const T* __restrict__ hp, T p0_pos, T p0_vel,
                              T* __restrict__ totals, int L, int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const T h = hp[0];
  Elem14<T> c = Elem14<T>::identity();
  for (int l = 0; l < L; ++l) {
    const T* row = stack + (long long)l * kElemFwdRows * lanes + t;
    const Trans<T> w = read_trans(row, lanes);
    const Elem14<T> e = elem_from_vals(w, row[7LL * lanes], row[8LL * lanes],
                                       row[9LL * lanes], p0_pos, p0_vel, h);
    c = Elem14<T>::combine(c, e);
  }
  c.store(totals + t, lanes);
}

template <typename T>
__global__ void __launch_bounds__(128)
    elem_filter_scan_kernel(const T* __restrict__ stack,
                            const T* __restrict__ prefix,
                            const T* __restrict__ hp, T p0_pos, T p0_vel,
                            T* __restrict__ moments, T* __restrict__ llk,
                            int L, int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const T h = hp[0];
  Elem14<T> c;
  c.load(prefix + t, lanes);
  T acc = T(0);
  for (int l = 0; l < L; ++l) {
    const T* row = stack + (long long)l * kElemFwdRows * lanes + t;
    const Trans<T> w = read_trans(row, lanes);
    const T y = row[7LL * lanes];
    const T U = row[9LL * lanes];
    acc = acc + pred_llk(c, w, y, U, h);  // BEFORE absorbing step l
    const Elem14<T> e =
        elem_from_vals(w, y, row[8LL * lanes], U, p0_pos, p0_vel, h);
    c = Elem14<T>::combine(c, e);
    T* m = moments + (long long)l * kMomRows * lanes + t;
    m[0] = c.b0;
    m[(long long)lanes] = c.b1;
    m[2LL * lanes] = c.C00;
    m[3LL * lanes] = c.C01;
    m[4LL * lanes] = c.C11;
  }
  llk[t] = acc;
}

// Smoothing element of slot l from the backward stack and the moments;
// G receives the unmasked gain.
template <typename T>
__device__ __forceinline__ Smooth9<T> elem_smooth_step(
    const T* __restrict__ stack, const T* __restrict__ moments, int l, int t,
    int lanes, Trans<T>* w, T G[4]) {
  const T* row = stack + (long long)l * kElemBwdRows * lanes + t;
  const T* m = moments + (long long)l * kMomRows * lanes + t;
  *w = read_trans(row, lanes);
  return smooth_elem(*w, m[0], m[(long long)lanes], m[2LL * lanes],
                     m[3LL * lanes], m[4LL * lanes], row[7LL * lanes], G);
}

template <typename T>
__global__ void __launch_bounds__(128)
    elem_smooth_totals_kernel(const T* __restrict__ stack,
                              const T* __restrict__ moments,
                              T* __restrict__ totals, int L, int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  Smooth9<T> acc = Smooth9<T>::identity();
  for (int l = L - 1; l >= 0; --l) {
    Trans<T> w;
    T G[4];
    const Smooth9<T> e = elem_smooth_step(stack, moments, l, t, lanes, &w, G);
    acc = Smooth9<T>::combine(acc, e);
  }
  acc.store(totals + t, lanes);
}

template <typename T>
__global__ void __launch_bounds__(128)
    elem_score_scan_kernel(const T* __restrict__ stack,
                           const T* __restrict__ moments,
                           const T* __restrict__ suffix,
                           const T* __restrict__ hp, T p0_pos,
                           T* __restrict__ cot, T* __restrict__ hbar, int L,
                           int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const T h = hp[0];
  Smooth9<T> acc;
  acc.load(suffix + t, lanes);
  T ha = T(0);
  for (int l = L - 1; l >= 0; --l) {
    const T* row = stack + (long long)l * kElemBwdRows * lanes + t;
    const T TVn = row[8LL * lanes];
    Trans<T> w;
    T G[4];
    const Smooth9<T> e = elem_smooth_step(stack, moments, l, t, lanes, &w, G);
    const Smooth9<T> nxt = acc;  // smoothed at l + 1
    acc = Smooth9<T>::combine(acc, e);  // smoothed at l
    const TransScore<T> s = transition_score(w, TVn, nxt, acc, G);
    const T yb = obs_score(row[9LL * lanes], acc, row[10LL * lanes],
                           row[11LL * lanes], h, p0_pos, &ha);
    T* c = cot + (long long)l * kElemCotRows * lanes + t;
    c[0] = TVn * s.Fb01;
    c[(long long)lanes] = TVn * s.Fb11;
    c[2LL * lanes] = TVn * s.Qb00;
    c[3LL * lanes] = TVn * s.Qb01;
    c[4LL * lanes] = TVn * s.Qb11;
    c[5LL * lanes] = TVn * s.cb0;
    c[6LL * lanes] = TVn * s.cb1;
    c[7LL * lanes] = yb;
  }
  hbar[t] = ha;
}

}  // namespace ssde

#define SSDE_ELEM_ENTRY(T, SUFFIX)                                             \
  extern "C" int ssde_elem_filter_totals_##SUFFIX(                             \
      const T* stack, const T* h, double p0_pos, double p0_vel, T* totals,     \
      int L, int lanes, void* stream) {                                        \
    ssde::elem_filter_totals_kernel<T>                                         \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                           \
           static_cast<cudaStream_t>(stream)>>>(stack, h, T(p0_pos),           \
                                                T(p0_vel), totals, L, lanes);  \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }                                                                            \
  extern "C" int ssde_elem_filter_scan_##SUFFIX(                               \
      const T* stack, const T* prefix, const T* h, double p0_pos,              \
      double p0_vel, T* moments, T* llk, int L, int lanes, void* stream) {     \
    ssde::elem_filter_scan_kernel<T>                                           \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                           \
           static_cast<cudaStream_t>(stream)>>>(                               \
            stack, prefix, h, T(p0_pos), T(p0_vel), moments, llk, L, lanes);   \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }                                                                            \
  extern "C" int ssde_elem_smooth_totals_##SUFFIX(                             \
      const T* stack, const T* moments, T* totals, int L, int lanes,           \
      void* stream) {                                                          \
    ssde::elem_smooth_totals_kernel<T>                                         \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                           \
           static_cast<cudaStream_t>(stream)>>>(stack, moments, totals, L,     \
                                                lanes);                        \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }                                                                            \
  extern "C" int ssde_elem_score_scan_##SUFFIX(                                \
      const T* stack, const T* moments, const T* suffix, const T* h,           \
      double p0_pos, T* cot, T* hbar, int L, int lanes, void* stream) {        \
    ssde::elem_score_scan_kernel<T>                                            \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                           \
           static_cast<cudaStream_t>(stream)>>>(                               \
            stack, moments, suffix, h, T(p0_pos), cot, hbar, L, lanes);        \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }

SSDE_ELEM_ENTRY(float, f32)
SSDE_ELEM_ENTRY(double, f64)
