// CTCRW Fisher-identity backward over the shared par-space stack:
// kernels K3a (reverse-time block totals of the RTS smoothing elements)
// and K3b (suffix-seeded reverse rescan emitting the score cotangents).
//
// Replaces the TPU kernel smoothsde_tpu/ops/ctcrw_fused.py:
// fused_backward_par (its two pallas_calls, sm_totals_kernel and
// score_kernel). Plain PyTorch versions: smooth_totals_plain and
// score_scan_plain in smoothsde_tpu_torch/ops/ctcrw_fused.py.
//
// What they compute. Each lane walks its L steps from last to first. At
// slot l the transition LEAVING l is rebuilt from the slot's own par, the
// 9-comp smoothing element is formed from the filtered moments of the
// forward pass, and it is composed outside the accumulator
// (_combine2_rev). K3a stores the lane's composition. K3b starts from the
// lane's exclusive suffix (K2); the accumulator before step l holds the
// smoothed moments at l + 1, after it those at l, from which the
// Fisher-identity score of the transition and the observation follows in
// closed form, contracted to (mu, log tau, log nu, y) by the analytic
// chain rule (phi' = em1^2, psi' = em1; the q01 entry counts twice, as
// both off-diagonal Q entries). The gbar scaling and the sums over dims
// happen outside, in torch.
//
// What bounds them on the H100. K3a reads 6 stack rows and the 5 moments
// per lane-step, K3b reads 9 rows and the moments and writes 4
// cotangents: at 1M steps, d = 2, f32 (config 5a: 62,500 lanes of
// L = 32) that is 90 MB and 147 MB, 27 and 44 us at 3.35 TB/s. Only the
// 9-comp combine (~50 flops, no division) depends on the carry; the rest
// of a step (the transition from par: three exp, an expm1, seven
// divisions; the element's 2x2 inverse: three; K3b's score: seven more)
// does not.
//
// Design. One CUDA block owns kK3Tile consecutive lanes and walks their
// steps from last to first in chunks of kK3Steps steps, with one thread
// per (step, lane) item of a chunk (kK3Steps threads per lane):
//   - staging: each thread copies its item's stack rows and moments into
//     shared memory with cp.async (csrc/async_ring.cuh), double
//     buffered: chunk k + 1's copies are in flight while the block
//     computes on chunk k;
//   - element phase: each thread forms its item's smoothing element into
//     shared memory (K3b keeps the item's transition terms and RTS gain
//     in registers for its score);
//   - chain phase: one thread per lane composes the chunk's elements into
//     its carry, in the order of the walk it replaces (so the f32
//     rounding of the carry does not move); K3b stages the smoothed
//     moments after each step;
//   - score phase (K3b): each thread forms its item's transition and
//     observation scores from the staged smoothed moments at l + 1 and l,
//     writes the cotangents, and stages its h term, which the chain
//     thread adds in step order.
// The element math divides with BranchFreeDiv (csrc/ctcrw_common.cuh):
// the quotient of `/`, bit for bit on these operands, without the branch
// to its slow path.
// What this does about the one-thread-per-lane walk it replaced (f32,
// config 5a: K3a 90 us, K3b 112 us, 30% and 39% of the HBM bound):
//   1. each of a step's divisions (10 in K3a, 17 in K3b) sat behind its
//      own branch and convergence barrier, one thread per lane running
//      them in series (SASS: 14 and 20 such regions in the loop; with
//      --use_fast_math the same walk ran in 49 and 64 us): now the
//      divisions are branch-free and a chunk's items run on kK3Steps
//      threads per lane;
//   2. each step's loads waited behind the chain: now a chunk's rows are
//      in flight during the chunk before;
//   3. K3b's score sat in the chain's thread: now the chain thread holds
//      the carry, and the score runs on all threads after it.
// Registers (ptxas), shared memory and resident CUDA blocks per SM, f32:
// K3a 56, 15.9 KB, 9; K3b 63, 23.3 KB, 8 (the walk replaced: 48 and 64
// registers); no spill. All 977 CUDA blocks of config 5a are resident at
// once. f64: 84 / 128 registers, 31.7 / 46.6 KB, 5 / 4 blocks (two
// waves). Measured on an H100 SXM (700 W) at config 5a (k3_sweep.py, CUDA
// events per launch): f32 K3a 42.9 us, K3b 65.1 us (63% and 67% of the
// HBM bound); f64 92.8 and 144.2 us (the walk replaced: 102.8, 144.8).
// Of that, the branch-free division gives K3a 53.8 -> 42.9 and K3b 81.8
// -> 65.1 us; one step per chunk on one thread per lane is as fast in
// f32 (41.7, 61.7) and slower in f64 (102.7, 159.3). The outputs of K3a
// are those of the walk replaced, bit for bit; K3b's per-step scores
// differ from its in the last bits (the compiler contracts the score's
// products into fma differently), its carry does not.

#include "async_ring.cuh"
#include "ctcrw_common.cuh"

namespace ssde {

// Tile geometry and division (smoothsde_tpu_torch/k3_sweep.py times
// variants of these four lines).
constexpr int kK3Tile = 64;       // lanes per CUDA block
constexpr int kK3Steps = 2;       // steps per chunk
constexpr int kK3MinBlocks = 8;   // f32 CUDA blocks per SM asked of ptxas
using K3Div = BranchFreeDiv;
constexpr int kK3Threads = kK3Steps * kK3Tile;  // one per (step, lane)
// ptxas caps the registers so that kK3MinBlocks CUDA blocks fit on an SM
// (f64: half as many)
template <typename T>
struct K3Occupancy {
  static constexpr int kMinBlocks =
      sizeof(T) == 4 ? kK3MinBlocks : (kK3MinBlocks + 1) / 2;
};

// Staged rows of an item: K3a takes stack rows 0-4 and 8, K3b rows 0-8;
// then the 5 moments.
enum { kLt, kLn, kDtv, kMu, kTe };
constexpr int kARst = 5, kAMom = 6, kARows = kAMom + kMomRows;
constexpr int kBTvn = 5, kBY = 6, kBUpd = 7, kBRst = 8, kBMom = 9;
constexpr int kBRows = kBMom + kMomRows;

// Shared memory of one CUDA block, in values of T: two buffers of staged
// rows ([row][item]), the elements ([9][item]); for K3b the smoothed
// moments ([5][slot][lane], kK3Steps + 1 slots: slot 0 is the carry
// entering the chunk) and the h terms ([item]).
constexpr int kASmem = (2 * kARows + Smooth9<float>::N) * kK3Threads;
constexpr int kBSmem = (2 * kBRows + Smooth9<float>::N + 1) * kK3Threads +
                       kMomRows * (kK3Steps + 1) * kK3Tile;

// This thread's copies of its item (step l, lane) into buf[r * kK3Threads].
template <int ROWS, typename T>
__device__ __forceinline__ void stage_k3(T* buf, const T* stack,
                                         const T* moments, int rows, int l,
                                         int lane, int lanes) {
  constexpr int rst = ROWS == kARows ? kARst : kBRst;  // rows before rst
  stage_item(buf, kK3Threads, stack, rows, 0, rst, l, lane, lanes);
  stage_item(buf + rst * kK3Threads, kK3Threads, stack, rows, 8, 1, l, lane,
             lanes);
  stage_item(buf + (rst + 1) * kK3Threads, kK3Threads, moments, kMomRows, 0,
             kMomRows, l, lane, lanes);
  cp_async_commit();
}

// The transition terms and smoothing element of a staged item (x[r *
// kK3Threads] = its row r); G receives the unmasked RTS gain.
template <int RST, int MOM, typename T>
__device__ __forceinline__ Smooth9<T> staged_elem(const T* x,
                                                  ParTerms<T>& w, T G[4]) {
  constexpr int N = kK3Threads;
  w = par_terms<T, K3Div>(x[kLt * N], x[kLn * N], x[kDtv * N], x[kMu * N],
                          x[RST * N]);
  return smooth_elem<T, K3Div>(w, x[MOM * N], x[(MOM + 1) * N],
                               x[(MOM + 2) * N], x[(MOM + 3) * N],
                               x[(MOM + 4) * N], x[kTe * N], G);
}

template <typename T>
__global__ void __launch_bounds__(kK3Threads, K3Occupancy<T>::kMinBlocks)
    smooth_totals_kernel(const T* __restrict__ stack,
                         const T* __restrict__ moments, T* __restrict__ totals,
                         int rows, int L, int lanes) {
  extern __shared__ __align__(16) unsigned char k3_smem[];
  T* ring = reinterpret_cast<T*>(k3_smem);
  T* elem = ring + 2 * kARows * kK3Threads;
  const int t = threadIdx.x, j = t / kK3Tile;  // item: step j of the chunk
  const int lane = blockIdx.x * kK3Tile + t % kK3Tile;
  const int nc = (L + kK3Steps - 1) / kK3Steps;
  Smooth9<T> acc = Smooth9<T>::identity();
  stage_k3<kARows>(ring + t, stack, moments, rows, L - 1 - j, lane, lanes);
  for (int k = 0; k < nc; ++k) {
    const int l = L - 1 - k * kK3Steps - j;
    const int nk = min(kK3Steps, L - k * kK3Steps);
    const T* x = ring + (k & 1) * kARows * kK3Threads + t;
    cp_async_wait_all();
    if (k + 1 < nc)
      stage_k3<kARows>(ring + ((k + 1) & 1) * kARows * kK3Threads + t, stack,
                       moments, rows, l - kK3Steps, lane, lanes);
    ParTerms<T> w;
    T G[4];
    staged_elem<kARst, kAMom>(x, w, G).store(elem + t, kK3Threads);
    __syncthreads();
    if (t < kK3Tile) {  // chain phase
      for (int s = 0; s < nk; ++s) {
        Smooth9<T> e;
        e.load(elem + s * kK3Tile + t, kK3Threads);
        acc = Smooth9<T>::combine(acc, e);
      }
    }
    __syncthreads();  // elem is free again
  }
  if (t < kK3Tile && lane < lanes) acc.store(totals + lane, lanes);
}

// Smoothed moments (g, L) of an accumulator, staged [c][slot][lane].
template <typename T>
__device__ __forceinline__ void put_moments(T* sm, int slot, int i,
                                            const Smooth9<T>& a) {
  constexpr int R = (kK3Steps + 1) * kK3Tile;
  T* p = sm + slot * kK3Tile + i;
  p[0] = a.g0; p[R] = a.g1; p[2 * R] = a.L00; p[3 * R] = a.L01;
  p[4 * R] = a.L11;
}

template <typename T>
__device__ __forceinline__ Smooth9<T> get_moments(const T* sm, int slot,
                                                  int i) {
  constexpr int R = (kK3Steps + 1) * kK3Tile;
  const T* p = sm + slot * kK3Tile + i;
  Smooth9<T> a = Smooth9<T>::identity();  // E is not read by the scores
  a.g0 = p[0]; a.g1 = p[R]; a.L00 = p[2 * R]; a.L01 = p[3 * R];
  a.L11 = p[4 * R];
  return a;
}

// The transition score contracted by the par -> (F, Q, c) chain rule,
// all closed-form: (mu, log tau, log nu) cotangents before the TVn mask.
template <typename T>
__device__ __forceinline__ void par_chain_rule(const ParTerms<T>& w,
                                               const TransScore<T>& sc, T dtv,
                                               T mu, T* mub, T* ltb,
                                               T* lnb) {
  const T u = w.u, e1 = w.e1, m1 = w.m1;
  const T ue1 = u * e1;
  const T dg = w.g - dtv * e1;
  const T dq00 = T(2) * w.uq00 - w.s3 * u * m1 * m1;
  const T dq01 = w.uq01 - T(2) * w.s2 * m1 * ue1;
  const T dq11 = T(-2) * w.s1 * ue1 * e1;
  const T dbp = w.bp - dtv * m1;
  // q01 feeds BOTH off-diagonal Q entries in the primal -> 2x
  *ltb = sc.Fb01 * dg + sc.Fb11 * ue1 + sc.Qb00 * dq00 +
         T(2) * sc.Qb01 * dq01 + sc.Qb11 * dq11 +
         (sc.cb0 * dbp - sc.cb1 * ue1) * mu;
  // all Q entries scale as nu^2
  *lnb = T(2) * (sc.Qb00 * w.uq00 + T(2) * sc.Qb01 * w.uq01 +
                 sc.Qb11 * w.uq11);
  *mub = sc.cb0 * w.bp + sc.cb1 * w.bv;
}

template <typename T>
__global__ void __launch_bounds__(kK3Threads, K3Occupancy<T>::kMinBlocks)
    score_scan_kernel(const T* __restrict__ stack,
                      const T* __restrict__ moments,
                      const T* __restrict__ suffix, const T* __restrict__ hp,
                      T p0_pos, T* __restrict__ cot, T* __restrict__ hbar,
                      int rows, int L, int lanes) {
  extern __shared__ __align__(16) unsigned char k3_smem[];
  constexpr int N = kK3Threads;
  T* ring = reinterpret_cast<T*>(k3_smem);
  T* elem = ring + 2 * kBRows * N;
  T* hterm = elem + Smooth9<T>::N * N;
  T* sm = hterm + N;
  const int t = threadIdx.x, j = t / kK3Tile, i = t % kK3Tile;
  const int lane = blockIdx.x * kK3Tile + i;
  const bool chain = t < kK3Tile;
  const int nc = (L + kK3Steps - 1) / kK3Steps;
  const T h = hp[0];
  Smooth9<T> acc = Smooth9<T>::identity();
  if (chain && lane < lanes) acc.load(suffix + lane, lanes);
  T ha = T(0);
  stage_k3<kBRows>(ring + t, stack, moments, rows, L - 1 - j, lane, lanes);
  for (int k = 0; k < nc; ++k) {
    const int l = L - 1 - k * kK3Steps - j;
    const int nk = min(kK3Steps, L - k * kK3Steps);
    const T* x = ring + (k & 1) * kBRows * N + t;
    cp_async_wait_all();
    if (k + 1 < nc)
      stage_k3<kBRows>(ring + ((k + 1) & 1) * kBRows * N + t, stack,
                       moments, rows, l - kK3Steps, lane, lanes);
    ParTerms<T> w;
    T G[4];
    staged_elem<kBRst, kBMom>(x, w, G).store(elem + t, N);
    __syncthreads();
    if (chain) {  // chain phase
      if (k > 0) {  // the previous (full) chunk's h terms, in step order
        for (int s = 0; s < kK3Steps; ++s) ha = ha + hterm[s * kK3Tile + t];
      }
      put_moments(sm, 0, t, acc);  // smoothed after the chunk
      for (int s = 0; s < nk; ++s) {
        Smooth9<T> e;
        e.load(elem + s * kK3Tile + t, N);
        acc = Smooth9<T>::combine(acc, e);
        put_moments(sm, s + 1, t, acc);
      }
    }
    __syncthreads();
    // score phase: item (l, lane), smoothed at l + 1 in slot j, at l in
    // slot j + 1
    const T dtv = x[kDtv * N], mu = x[kMu * N], TVn = x[kBTvn * N];
    const T y = x[kBY * N], U = x[kBUpd * N], R = x[kBRst * N];
    const Smooth9<T> cur = get_moments(sm, j + 1, i);
    const TransScore<T> sc =
        transition_score<T, K3Div>(w, TVn, get_moments(sm, j, i), cur, G);
    T mub, ltb, lnb;
    par_chain_rule(w, sc, dtv, mu, &mub, &ltb, &lnb);
    // obs + prior score at l (the reset prior uses p0_pos); U is 0 or 1,
    // so the staged U * (...) adds to ha as it did inside one walk
    T hl = T(0);
    const T yb = obs_score<T, K3Div>(y, cur, U, R, h, p0_pos, &hl);
    hterm[t] = hl;
    if (l >= 0 && lane < lanes) {
      T* c = cot + (long long)l * kCotRows * lanes + lane;
      c[0] = TVn * mub;
      c[(long long)lanes] = TVn * ltb;
      c[2LL * lanes] = TVn * lnb;
      c[3LL * lanes] = yb;
    }
  }
  __syncthreads();
  if (chain && lane < lanes) {
    const int nk = L - (nc - 1) * kK3Steps;  // the last chunk's steps
    for (int s = 0; s < nk; ++s) ha = ha + hterm[s * kK3Tile + t];
    hbar[lane] = ha;
  }
}

// Launch over ceil(lanes / kK3Tile) CUDA blocks with `values` of T of
// dynamic shared memory, raising the kernel's limit first when that is
// above the default 48 KB.
template <typename T, typename K, typename... Args>
int launch_k3(K kernel, int values, int lanes, void* stream, Args... args) {
  const int bytes = values * static_cast<int>(sizeof(T));
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(lanes + kK3Tile - 1) / kK3Tile, kK3Threads, bytes,
           static_cast<cudaStream_t>(stream)>>>(args...);
  SSDE_RETURN_LAUNCH_STATUS();
}

}  // namespace ssde

#define SSDE_BACKWARD_ENTRY(T, SUFFIX)                                         \
  extern "C" int ssde_ctcrw_smooth_totals_##SUFFIX(                            \
      const T* stack, const T* moments, T* totals, int rows, int L, int lanes, \
      void* stream) {                                                          \
    return ssde::launch_k3<T>(ssde::smooth_totals_kernel<T>, ssde::kASmem,    \
                              lanes, stream, stack, moments, totals, rows, L, \
                              lanes);                                          \
  }                                                                            \
  extern "C" int ssde_ctcrw_score_scan_##SUFFIX(                               \
      const T* stack, const T* moments, const T* suffix, const T* h,           \
      double p0_pos, T* cot, T* hbar, int rows, int L, int lanes,              \
      void* stream) {                                                          \
    return ssde::launch_k3<T>(ssde::score_scan_kernel<T>, ssde::kBSmem,       \
                              lanes, stream, stack, moments, suffix, h,       \
                              T(p0_pos), cot, hbar, rows, L, lanes);          \
  }

SSDE_BACKWARD_ENTRY(float, f32)
SSDE_BACKWARD_ENTRY(double, f64)
