// Scalar-state (BM_SSM / OU_SSM) Fisher-identity backward over the
// leaving-row stack: kernels D3a (reverse-time block totals of the 3-comp
// RTS smoothing elements) and D3b (suffix-seeded reverse rescan emitting
// the score cotangents of t, q, c and y, and the h score partials).
//
// Replaces the TPU kernel smoothsde_tpu/ops/diag_fused.py: _diag_bwd (its
// two pallas_calls, sm_totals_kernel and score_kernel). Plain PyTorch
// versions: diag_smooth_totals_plain and diag_score_scan_plain in
// smoothsde_tpu_torch/ops/diag_fused.py.
//
// Design. One thread per lane walks its L steps from last to first. At
// slot l it forms the smoothing element from the filtered moments of the
// forward pass and the transition LEAVING l (tn, qn, cn), and composes
// it outside its accumulator (_comb1_rev). D3b then has the smoothed
// moments at l + 1 (the accumulator before the step) and at l (after
// it), from which the Fisher-identity score of the transition follows in
// closed form: with the sanitized inverse qi = 1 / (TVn q + 1 - TVn) and
// the lag-one covariance Ps1 * G, tbar = qi (E[x1 x] - t E[x^2] - c m),
// cbar = qi r, qbar = (qi E[r^2] qi - qi) / 2, all masked by TVn. The y
// cotangent adds the reset prior's -resid / p0 at track starts. The
// cotangents stay in LEAVING indexing; the gbar scaling, the shift to
// entering indexing and the sums over dims happen outside, in torch.
//
// What bounds it on the H100. D3a reads 4 stack rows and 2 moments per
// lane-step, D3b all 8 rows and the moments and writes 4 cotangents: at
// 1M steps, d = 2, f32 that is 48 MB and 112 MB, 14 and 33 us at
// 3.35 TB/s. The serial chain is L = 32 dependent 3-comp combines (4
// flops) per thread; the element (one division) and the score (~40
// flops, two divisions) do not depend on the carry and overlap it, so
// bytes should bound both.

#include "diag_common.cuh"

namespace ssde {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    diag_smooth_totals_kernel(const T* __restrict__ stack,
                              const T* __restrict__ moments,
                              T* __restrict__ totals, int L, int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  Smooth3<T> acc = Smooth3<T>::identity();
  for (int l = L - 1; l >= 0; --l) {
    const T* row = stack + (long long)l * kDiagBwdRows * lanes + i;
    const T* m = moments + (long long)l * kDiagMomRows * lanes + i;
    T G;
    const Smooth3<T> e =
        smooth_elem1(row[0], row[(long long)lanes], row[2LL * lanes], m[0],
                     m[(long long)lanes], row[3LL * lanes], G);
    acc = Smooth3<T>::combine(acc, e);
  }
  acc.store(totals + i, lanes);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    diag_score_scan_kernel(const T* __restrict__ stack,
                           const T* __restrict__ moments,
                           const T* __restrict__ suffix,
                           const T* __restrict__ hp, T p0,
                           T* __restrict__ cot, T* __restrict__ hbar, int L,
                           int lanes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const T h = hp[0];
  Smooth3<T> acc;
  acc.load(suffix + i, lanes);
  T ha = T(0);
  for (int l = L - 1; l >= 0; --l) {
    const T* row = stack + (long long)l * kDiagBwdRows * lanes + i;
    const T* m = moments + (long long)l * kDiagMomRows * lanes + i;
    const T tn = row[0];
    const T qn = row[(long long)lanes];
    const T cn = row[2LL * lanes];
    const T te = row[3LL * lanes];
    const T TVn = row[4LL * lanes];
    const T y = row[5LL * lanes];
    const T U = row[6LL * lanes];
    const T R = row[7LL * lanes];
    // smoothed at l + 1 is the incoming accumulator
    const T ms1 = acc.g, Ps1 = acc.L;
    T G;
    const Smooth3<T> e =
        smooth_elem1(tn, qn, cn, m[0], m[(long long)lanes], te, G);
    acc = Smooth3<T>::combine(acc, e);
    const T ms = acc.g, Ps = acc.L;  // smoothed at l

    const T qs = TVn * qn + (T(1) - TVn);  // sanitized q inverse
    const T qi = T(1) / qs;
    const T C = Ps1 * G;  // lag-one Cov(x_{l+1}, x_l | y)
    const T Exx = Ps + ms * ms;
    const T Ex2x1 = C + ms1 * ms;
    const T rb = ms1 - tn * ms - cn;
    const T tb = qi * (Ex2x1 - tn * Exx - cn * ms);
    const T cb = qi * rb;
    const T Err = Ps1 + tn * tn * Ps - T(2) * tn * C + rb * rb;
    const T qb = T(0.5) * (qi * Err * qi - qi);
    // obs + prior score at l (reset prior N(y, p0))
    const T resid = y - ms;
    const T yb = U * (-resid / h) + R * (-resid / p0);
    ha = ha + U * (T(0.5) * (resid * resid + Ps) / (h * h) - T(0.5) / h);

    T* c = cot + (long long)l * kDiagCotRows * lanes + i;
    c[0] = TVn * tb;
    c[(long long)lanes] = TVn * qb;
    c[2LL * lanes] = TVn * cb;
    c[3LL * lanes] = yb;
  }
  hbar[i] = ha;
}

}  // namespace ssde

#define SSDE_DIAG_BACKWARD_ENTRY(T, SUFFIX)                                    \
  extern "C" int ssde_diag_smooth_totals_##SUFFIX(                             \
      const T* stack, const T* moments, T* totals, int L, int lanes,           \
      void* stream) {                                                          \
    ssde::diag_smooth_totals_kernel<T>                                         \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                           \
           static_cast<cudaStream_t>(stream)>>>(stack, moments, totals, L,     \
                                                lanes);                        \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }                                                                            \
  extern "C" int ssde_diag_score_scan_##SUFFIX(                                \
      const T* stack, const T* moments, const T* suffix, const T* h,           \
      double p0, T* cot, T* hbar, int L, int lanes, void* stream) {            \
    ssde::diag_score_scan_kernel<T>                                            \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                           \
           static_cast<cudaStream_t>(stream)>>>(stack, moments, suffix, h,     \
                                                T(p0), cot, hbar, L, lanes);   \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }

SSDE_DIAG_BACKWARD_ENTRY(float, f32)
SSDE_DIAG_BACKWARD_ENTRY(double, f64)
