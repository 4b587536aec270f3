// CTCRW Fisher-identity backward over the shared par-space stack:
// kernels K3a (reverse-time block totals of the RTS smoothing elements)
// and K3b (suffix-seeded reverse rescan emitting the score cotangents).
//
// Replaces the TPU kernel smoothsde_tpu/ops/ctcrw_fused.py:
// fused_backward_par (its two pallas_calls, sm_totals_kernel and
// score_kernel). Plain PyTorch versions: smooth_totals_plain and
// score_scan_plain in smoothsde_tpu_torch/ops/ctcrw_fused.py.
//
// Design. One thread per lane walks its L steps from last to first. At
// slot l it rebuilds the transition LEAVING l from the slot's own par,
// forms the 9-comp smoothing element from the filtered moments of the
// forward pass, and composes it outside its accumulator
// (_combine2_rev). K3b then has the smoothed moments at l + 1 (the
// accumulator before the step) and at l (after it), from which the
// Fisher-identity score of the transition and the observation follows
// in closed form, already contracted to (mu, log tau, log nu, y) by the
// analytic chain rule (phi' = em1^2, psi' = em1; the q01 entry counts
// twice, as both off-diagonal Q entries). The gbar scaling and the sums
// over dims happen outside, in torch.
//
// What bounds it on the H100. K3a reads 6 stack rows and the 5 moments
// per lane-step, K3b reads 9 rows and the moments and writes 4
// cotangents: at 1M steps, d = 2, f32 that is 88 MB and 144 MB, 26 and
// 43 us at 3.35 TB/s. The serial chain is L = 32 dependent 9-comp
// combines (~50 flops, no division) per thread; the per-step smoothing
// element (a 2x2 inverse) and, in K3b, ~150 flops of score algebra do
// not depend on the carry and overlap it. Measured on an H100 SXM
// (700 W) at that size: K3a 84 us (1.0 TB/s), K3b 109 us (1.3 TB/s),
// 31-40% of the HBM peak. K3b holds many live values per thread; the
// simple design accepts the register pressure (at most 255 registers at
// 128 threads per block) rather than staging through shared memory.

#include "ctcrw_common.cuh"

namespace ssde {

template <typename T>
__global__ void __launch_bounds__(128)
    smooth_totals_kernel(const T* __restrict__ stack,
                         const T* __restrict__ moments, T* __restrict__ totals,
                         int rows, int L, int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  Smooth9<T> acc = Smooth9<T>::identity();
  for (int l = L - 1; l >= 0; --l) {
    const T* row = stack + (long long)l * rows * lanes + t;
    const T* m = moments + (long long)l * kMomRows * lanes + t;
    const ParTerms<T> w = par_terms(row[0], row[(long long)lanes],
                                    row[2LL * lanes], row[3LL * lanes],
                                    row[8LL * lanes]);
    T G[4];
    const Smooth9<T> e =
        smooth_elem(w, m[0], m[(long long)lanes], m[2LL * lanes],
                    m[3LL * lanes], m[4LL * lanes], row[4LL * lanes], G);
    acc = Smooth9<T>::combine(acc, e);
  }
  acc.store(totals + t, lanes);
}

template <typename T>
__global__ void __launch_bounds__(128)
    score_scan_kernel(const T* __restrict__ stack,
                      const T* __restrict__ moments,
                      const T* __restrict__ suffix, const T* __restrict__ hp,
                      T p0_pos, T* __restrict__ cot, T* __restrict__ hbar,
                      int rows, int L, int lanes) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const T h = hp[0];
  Smooth9<T> acc;
  acc.load(suffix + t, lanes);
  T ha = T(0);
  for (int l = L - 1; l >= 0; --l) {
    const T* row = stack + (long long)l * rows * lanes + t;
    const T* m = moments + (long long)l * kMomRows * lanes + t;
    const T te = row[4LL * lanes];
    const T TVn = row[5LL * lanes];
    const T y = row[6LL * lanes];
    const T U = row[7LL * lanes];
    const T R = row[8LL * lanes];
    // smoothed at l + 1 is the incoming accumulator
    const T ms1_0 = acc.g0, ms1_1 = acc.g1;
    const T Ps1_00 = acc.L00, Ps1_01 = acc.L01, Ps1_11 = acc.L11;
    const ParTerms<T> w = par_terms(row[0], row[(long long)lanes],
                                    row[2LL * lanes], row[3LL * lanes], R);
    T G[4];
    const Smooth9<T> e =
        smooth_elem(w, m[0], m[(long long)lanes], m[2LL * lanes],
                    m[3LL * lanes], m[4LL * lanes], te, G);
    acc = Smooth9<T>::combine(acc, e);
    const T ms0 = acc.g0, ms1 = acc.g1;  // smoothed at l
    const T Ps00 = acc.L00, Ps01 = acc.L01, Ps11 = acc.L11;

    const T f01 = w.f01, f11 = w.f11, c0 = w.c0, c1 = w.c1;
    // sanitized Qn inverse
    const T q00 = TVn * w.q00 + (T(1) - TVn);
    const T q01 = TVn * w.q01;
    const T q11 = TVn * w.q11 + (T(1) - TVn);
    const T det = q00 * q11 - q01 * q01;
    const T qi00 = q11 / det, qi01 = -q01 / det, qi11 = q00 / det;

    // lag-one Cov(x_{l+1}, x_l | y) = P_s_{l+1} G'
    const T C00 = Ps1_00 * G[0] + Ps1_01 * G[1];
    const T C01 = Ps1_00 * G[2] + Ps1_01 * G[3];
    const T C10 = Ps1_01 * G[0] + Ps1_11 * G[1];
    const T C11 = Ps1_01 * G[2] + Ps1_11 * G[3];
    const T Exx01 = Ps01 + ms0 * ms1;
    const T Exx11 = Ps11 + ms1 * ms1;
    const T Ex2x01 = C01 + ms1_0 * ms1;
    const T Ex2x11 = C11 + ms1_1 * ms1;
    // r = m_{l+1} - Fn m_l - cn ; Fn rows (1, f01), (0, f11)
    const T r0 = ms1_0 - (ms0 + f01 * ms1) - c0;
    const T r1 = ms1_1 - f11 * ms1 - c1;

    // Fbar = Qinv (Ex2x1 - Fn Exx - cn m_l'), second column
    const T T01 = Ex2x01 - (Exx01 + f01 * Exx11) - c0 * ms1;
    const T T11 = Ex2x11 - f11 * Exx11 - c1 * ms1;
    const T Fb01 = qi00 * T01 + qi01 * T11;
    const T Fb11 = qi01 * T01 + qi11 * T11;
    // cbar = Qinv r
    const T cb0 = qi00 * r0 + qi01 * r1;
    const T cb1 = qi01 * r0 + qi11 * r1;
    // E[r r'] = P_{l+1} + Fn P_l Fn' - C Fn' - Fn C' + r r'
    const T FP00 = Ps00 + T(2) * f01 * Ps01 + f01 * f01 * Ps11;
    const T FP01 = f11 * (Ps01 + f01 * Ps11);
    const T FP11 = f11 * f11 * Ps11;
    const T CF00 = C00 + f01 * C01;
    const T CF01 = f11 * C01;
    const T CF10 = C10 + f01 * C11;
    const T CF11 = f11 * C11;
    const T E00 = Ps1_00 + FP00 - T(2) * CF00 + r0 * r0;
    const T E01 = Ps1_01 + FP01 - CF01 - CF10 + r0 * r1;
    const T E11 = Ps1_11 + FP11 - T(2) * CF11 + r1 * r1;
    // Qbar = 0.5 (Qinv Errt Qinv - Qinv)
    const T A00 = qi00 * E00 + qi01 * E01;
    const T A01 = qi00 * E01 + qi01 * E11;
    const T A10 = qi01 * E00 + qi11 * E01;
    const T A11 = qi01 * E01 + qi11 * E11;
    const T Qb00 = T(0.5) * ((A00 * qi00 + A01 * qi01) - qi00);
    const T Qb01 = T(0.5) * ((A00 * qi01 + A01 * qi11) - qi01);
    const T Qb11 = T(0.5) * ((A10 * qi01 + A11 * qi11) - qi11);

    // ---- par -> (F, Q, c) chain rule, all closed-form ----
    const T u = w.u, e1 = w.e1, m1 = w.m1;
    const T ue1 = u * e1;
    const T dtv = row[2LL * lanes];
    const T mu = row[3LL * lanes];
    const T dg = w.g - dtv * e1;
    const T dq00 = T(2) * w.uq00 - w.s3 * u * m1 * m1;
    const T dq01 = w.uq01 - T(2) * w.s2 * m1 * ue1;
    const T dq11 = T(-2) * w.s1 * ue1 * e1;
    const T dbp = w.bp - dtv * m1;
    // q01 feeds BOTH off-diagonal Q entries in the primal -> 2x
    const T ltb = Fb01 * dg + Fb11 * ue1 + Qb00 * dq00 + T(2) * Qb01 * dq01 +
                  Qb11 * dq11 + (cb0 * dbp - cb1 * ue1) * mu;
    // all Q entries scale as nu^2
    const T lnb = T(2) * (Qb00 * w.uq00 + T(2) * Qb01 * w.uq01 + Qb11 * w.uq11);
    const T mub = cb0 * w.bp + cb1 * w.bv;

    // obs + prior score at l (the reset prior uses p0_pos)
    const T resid = y - ms0;
    const T yb = U * (-resid / h) + R * (-resid / p0_pos);
    const T Ey2 = resid * resid + Ps00;
    ha = ha + U * (T(0.5) * Ey2 / (h * h) - T(0.5) / h);

    T* c = cot + (long long)l * kCotRows * lanes + t;
    c[0] = TVn * mub;
    c[(long long)lanes] = TVn * ltb;
    c[2LL * lanes] = TVn * lnb;
    c[3LL * lanes] = yb;
  }
  hbar[t] = ha;
}

}  // namespace ssde

#define SSDE_BACKWARD_ENTRY(T, SUFFIX)                                         \
  extern "C" int ssde_ctcrw_smooth_totals_##SUFFIX(                            \
      const T* stack, const T* moments, T* totals, int rows, int L, int lanes, \
      void* stream) {                                                          \
    ssde::smooth_totals_kernel<T><<<ssde::grid_for(lanes), ssde::kThreads, 0,  \
                                    static_cast<cudaStream_t>(stream)>>>(      \
        stack, moments, totals, rows, L, lanes);                               \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }                                                                            \
  extern "C" int ssde_ctcrw_score_scan_##SUFFIX(                               \
      const T* stack, const T* moments, const T* suffix, const T* h,           \
      double p0_pos, T* cot, T* hbar, int rows, int L, int lanes,              \
      void* stream) {                                                          \
    ssde::score_scan_kernel<T><<<ssde::grid_for(lanes), ssde::kThreads, 0,     \
                                 static_cast<cudaStream_t>(stream)>>>(         \
        stack, moments, suffix, h, T(p0_pos), cot, hbar, rows, L, lanes);      \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }

SSDE_BACKWARD_ENTRY(float, f32)
SSDE_BACKWARD_ENTRY(double, f64)
