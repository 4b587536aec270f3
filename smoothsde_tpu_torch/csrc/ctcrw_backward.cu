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
    const ParTerms<T> w = par_terms(row[0], row[(long long)lanes],
                                    row[2LL * lanes], row[3LL * lanes], R);
    T G[4];
    const Smooth9<T> e =
        smooth_elem(w, m[0], m[(long long)lanes], m[2LL * lanes],
                    m[3LL * lanes], m[4LL * lanes], te, G);
    const Smooth9<T> nxt = acc;  // smoothed at l + 1
    acc = Smooth9<T>::combine(acc, e);  // smoothed at l
    const TransScore<T> sc = transition_score<T>(w, TVn, nxt, acc, G);
    const T Fb01 = sc.Fb01, Fb11 = sc.Fb11, cb0 = sc.cb0, cb1 = sc.cb1;
    const T Qb00 = sc.Qb00, Qb01 = sc.Qb01, Qb11 = sc.Qb11;

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
    const T yb = obs_score(y, acc, U, R, h, p0_pos, &ha);

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
