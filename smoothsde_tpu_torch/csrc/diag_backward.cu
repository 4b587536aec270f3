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
// The math. Walking a lane from its last step to its first, slot l forms
// the smoothing element from the filtered moments of the forward pass
// and the transition LEAVING l (tn, qn, cn), and composes it outside the
// accumulator (_comb1_rev). D3b then has the smoothed moments at l + 1
// (the accumulator before the step) and at l (after it), from which the
// Fisher-identity score of the transition follows in closed form: with
// the sanitized inverse qi = 1 / (TVn q + 1 - TVn) and the lag-one
// covariance Ps1 * G, tbar = qi (E[x1 x] - t E[x^2] - c m), cbar = qi r,
// qbar = (qi E[r^2] qi - qi) / 2, all masked by TVn. The y cotangent adds
// the reset prior's -resid / p0 at track starts. The cotangents stay in
// LEAVING indexing; the gbar scaling, the shift to entering indexing and
// the sums over dims happen outside, in torch.
//
// What bounds them on the H100. D3a reads 4 stack rows and 2 moments per
// lane-step, D3b all 8 rows and the moments and writes 4 cotangents: at
// 1M steps, d = 2, f32 (the OU_SSM fit: 62,500 lanes of L = 32) that is
// 49 and 113 MB, 14.6 and 33.7 us at 3.35 TB/s: bytes, if enough loads
// are in flight.
//
// D3a, first written as one thread per lane, each step waiting on its own
// rows, was latency-bound: 30.7 us at d = 2 and 27.6 at d = 1 for half
// the bytes (f32, events, cold). Now it runs D1a's segments in reverse
// time: each lane's steps are cut into kD3aSegs segments of consecutive
// steps, one thread each (a warp = 32 neighbouring lanes of one segment);
// each thread walks its segment from its last step to its first with the
// earlier step's rows in flight and composes the segment's total from the
// identity; the lane's first thread composes the totals from shared
// memory, the last segment first and each earlier one applied outside
// (as _comb1_rev). f32 moves in its last bits. Measured (H100 SXM,
// 700 W; tile_sweep.py, same call as the parent; PERF.md §6): f32 30.7 ->
// 21.6 us at d = 2, 27.6 -> 11.9 at d = 1 (in the chain, profiler: 30.3
// -> 20.5, 26.8 -> 10.8); f64 40.9 -> 36.1 and 32.3 -> 19.7. Registers
// 40 (f64 62), 12 (f64 8) CUDA blocks an SM. Not kept: the walk with the
// earlier rows in flight alone (25.3 / 21.5 us), 2 segments (20.2 /
// 14.4: faster at d = 2, slower at d = 1), 8 (21.0 / 12.7), 64 lanes a
// block (21.8 / 11.9), 2 and 8 segments of 64 lanes (20.1 / 14.6, 21.3 /
// 12.9).
//
// D3b, first written as one thread per lane with each step loading its
// own rows and then computing, was bound by latency, not bytes: 83.9 us at
// d = 2 and 71.4 at d = 1 for half the bytes (PERF.md §6), with ~15 warps
// an SM (7 at d = 1), each waiting on one step's 10 loads at a time. Now
// the rows of step l - 1 are loaded while step l computes: 88.9 -> 46.3
// us at d = 2 and 82.2 -> 31.2 at d = 1, f32; f64 113.5 -> 78.1 and 94.8
// -> 47.0 (CUDA events, inputs read cold, on an H100 SXM at 700 W;
// tile_sweep.py, PERF.md §6). Registers (ptxas): 40 (f64 78), no spill
// (the old walk: 40 with a spill). Outputs: the old walk's, bit for bit.
// Measured and not kept (same section): several threads per lane (each
// lane's steps in 2, 4 or 8 segments, a totals pass, an exclusive suffix
// scan over the segments seeded with K2's suffix, a rescan; the segment's
// element inputs held in registers between the passes or loaded again)
// was faster only at d = 1 in f32 (25.8 vs 31.2 us), no faster at d = 2
// (46.8-52.7 vs 47.0) and slower in f64 (99-174 vs 78.4); loading 2-4
// steps ahead, 64 lanes a block or a register cap for 8 blocks an SM
// were no faster; ctcrw_common.cuh's BranchFreeDiv in every division was
// 0-3% slower than `/`.

#include "diag_common.cuh"

namespace ssde {

// D3a's geometry: segments (threads) per lane and lanes per CUDA block
// (smoothsde_tpu_torch/tile_sweep.py times variants of these two lines).
constexpr int kD3aSegs = 4;
constexpr int kD3aLanes = 32;
constexpr int kD3aThreads = kD3aSegs * kD3aLanes;

// The rows of one step that D3a's element needs.
template <typename T>
struct DiagSmRow {
  T tn, qn, cn, te, mf, Pf;
};

template <typename T>
__device__ __forceinline__ DiagSmRow<T> read_sm(
    const T* __restrict__ stack, const T* __restrict__ moments, int l, int i,
    int lanes) {
  const T* row = stack + (long long)l * kDiagBwdRows * lanes + i;
  const T* m = moments + (long long)l * kDiagMomRows * lanes + i;
  DiagSmRow<T> r;
  r.tn = row[0];
  r.qn = row[(long long)lanes];
  r.cn = row[2LL * lanes];
  r.te = row[3LL * lanes];
  r.mf = m[0];
  r.Pf = m[(long long)lanes];
  return r;
}

// Thread t of a CUDA block walks segment t / kD3aLanes of lane t %
// kD3aLanes from its last step to its first, the earlier step's rows in
// flight: a warp reads 32 neighbouring lanes of one step. The lane's
// first thread composes the segments' totals, the last segment first
// (each earlier one applied outside, as _comb1_rev).
template <typename T>
__global__ void __launch_bounds__(kD3aThreads)
    diag_smooth_totals_kernel(const T* __restrict__ stack,
                              const T* __restrict__ moments,
                              T* __restrict__ totals, int L, int lanes) {
  __shared__ T part[Smooth3<T>::N * kD3aThreads];  // [comp][segment][lane]
  const int j = threadIdx.x % kD3aLanes, s = threadIdx.x / kD3aLanes;
  const int i = blockIdx.x * kD3aLanes + j;
  int lo, hi;
  segment_of<kD3aSegs>(s, L, lo, hi);
  Smooth3<T> acc = Smooth3<T>::identity();
  if (i < lanes && lo < hi) {
    DiagSmRow<T> nxt = read_sm(stack, moments, hi - 1, i, lanes);
    for (int l = hi - 1; l >= lo; --l) {
      const DiagSmRow<T> r = nxt;
      if (l > lo) nxt = read_sm(stack, moments, l - 1, i, lanes);  // in flight
      T G;
      acc = Smooth3<T>::combine(
          acc, smooth_elem1(r.tn, r.qn, r.cn, r.mf, r.Pf, r.te, G));
    }
  }
  acc.store(part + s * kD3aLanes + j, kD3aThreads);
  __syncthreads();
  if (s == 0 && i < lanes) {
    acc.load(part + (kD3aSegs - 1) * kD3aLanes + j, kD3aThreads);
    for (int k = kD3aSegs - 2; k >= 0; --k) {
      Smooth3<T> e;
      e.load(part + k * kD3aLanes + j, kD3aThreads);
      acc = Smooth3<T>::combine(acc, e);
    }
    acc.store(totals + i, lanes);
  }
}

template <typename T>
struct DiagBwdRow {
  T tn, qn, cn, te, TVn, y, U, R, mf, Pf;
};

template <typename T>
__device__ __forceinline__ DiagBwdRow<T> read_bwd(
    const T* __restrict__ stack, const T* __restrict__ moments, int l, int i,
    int lanes) {
  const T* row = stack + (long long)l * kDiagBwdRows * lanes + i;
  const T* m = moments + (long long)l * kDiagMomRows * lanes + i;
  DiagBwdRow<T> r;
  r.tn = row[0];
  r.qn = row[(long long)lanes];
  r.cn = row[2LL * lanes];
  r.te = row[3LL * lanes];
  r.TVn = row[4LL * lanes];
  r.y = row[5LL * lanes];
  r.U = row[6LL * lanes];
  r.R = row[7LL * lanes];
  r.mf = m[0];
  r.Pf = m[(long long)lanes];
  return r;
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
  DiagBwdRow<T> nxt;
  if (L > 0) nxt = read_bwd(stack, moments, L - 1, i, lanes);
  for (int l = L - 1; l >= 0; --l) {
    const DiagBwdRow<T> r = nxt;
    if (l > 0) nxt = read_bwd(stack, moments, l - 1, i, lanes);  // in flight
    // smoothed at l + 1 is the incoming accumulator
    const T ms1 = acc.g, Ps1 = acc.L;
    T G;
    const Smooth3<T> e =
        smooth_elem1(r.tn, r.qn, r.cn, r.mf, r.Pf, r.te, G);
    acc = Smooth3<T>::combine(acc, e);
    const T ms = acc.g, Ps = acc.L;  // smoothed at l
    const T tn = r.tn, cn = r.cn;

    const T qs = r.TVn * r.qn + (T(1) - r.TVn);  // sanitized q inverse
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
    const T resid = r.y - ms;
    const T yb = r.U * (-resid / h) + r.R * (-resid / p0);
    ha = ha + r.U * (T(0.5) * (resid * resid + Ps) / (h * h) - T(0.5) / h);

    T* c = cot + (long long)l * kDiagCotRows * lanes + i;
    c[0] = r.TVn * tb;
    c[(long long)lanes] = r.TVn * qb;
    c[2LL * lanes] = r.TVn * cb;
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
        <<<(lanes + ssde::kD3aLanes - 1) / ssde::kD3aLanes,                    \
           ssde::kD3aThreads, 0, static_cast<cudaStream_t>(stream)>>>(         \
            stack, moments, totals, L, lanes);                                 \
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
