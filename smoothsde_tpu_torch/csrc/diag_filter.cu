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
// The stack is (L, 6, lanes): each step's element comes from its own
// slot (t, q, c of the entering transition, y and the reset / update
// masks), so no carry besides the element is needed, and a warp reading
// 32 neighbouring lanes of one row is coalesced.
//
// What bounds them on the H100. Per lane-step D1a reads 6 values and does
// one 5-comp combine (~15 flops) with the element (three divisions); D1b
// also writes 2 moments and takes one log. At 1M steps, d = 2, f32 (the
// OU_SSM fit: 62,500 lanes of L = 32) that is 49 and 66 MB, 14.7 and 19.6
// us at the card's 3.35 TB/s: bytes, if enough loads are in flight. The
// segment totals D1a hands D1b in f32 (below) are the design's own
// traffic on top: 3.75 MB written and read, 1.1 us each way.
//
// D1a, first written as one thread per lane walking its 32 steps, was
// bound by latency, not bytes: 38.1 us at d = 2 and 36.9 at d = 1 for
// half the bytes, ~1.15 us a step whatever the lane count (PERF.md §6).
// Each step waited on its own rows, and the ~15 warps
// an SM held at d = 2 (7 at d = 1) kept too few loads in flight to cover
// the HBM latency. Now each lane's steps are cut into kD1Segs segments of
// consecutive steps, one thread each: kD1Segs times the warps and loads
// in flight, a chain of 32 / kD1Segs steps. Each thread loads its next
// step's rows while the current one computes and composes its segment's
// total from the identity; the block's threads leave their totals in
// shared memory, and the lane's first thread combines them in time order
// (earlier segment on the left) and stores the lane's total. A warp
// holds 32 neighbouring lanes of one segment, so every load stays
// coalesced, and the hand-off takes one barrier. The associativity of
// the combine makes the total the walk's up to rounding: f32 moves in
// its last bits. Measured on an H100 SXM (700 W; CUDA events, inputs read
// cold; tile_sweep.py, PERF.md §6), f32: 38.1 -> 22.4 us at d = 2, 35.5 ->
// 12.1 at d = 1; f64 47.9 -> 39.8 and 41.6 -> 23.5. Registers (ptxas):
// 40 (f64 70), no spill, 12 (f64 7) CUDA blocks of 128 threads an SM.
// Not kept: the walk with the next rows in flight alone (25.5 / 21.5 us),
// 2 segments (20.4 / 14.5), 8 segments (22.7 / 14.1), 64 lanes a block
// (23.0 / 12.1), a register cap for 8 blocks an SM (spills in f64),
// loading 2-4 steps ahead (no faster), ctcrw_common.cuh's BranchFreeDiv
// in place of `/` (the same time).
//
// D1b, the same one-thread walk, was latency-bound too: 34.8 us at d = 2
// and 29.5 at d = 1 (f32, events, cold; 19.6 in the forward chain, where
// it finds part of the 24 MB stack in the L2 after D1a). In f32 it now
// runs D1a's segments: D1a also stores the totals of each lane's first
// kD1Segs - 1 segments, 60 B a lane, so D1b forms no seeds of its own
// (the second pass that lost for D3b), and D1b's segment s starts from
// the lane's prefix composed with segments 0 .. s - 1 in time order,
// walks its steps with the next rows in flight, and the lane's
// first thread sums the segments' llk partials. Moments and llk move in
// f32's last bits. Measured (H100 SXM, 700 W; tile_sweep.py, same call
// as the parent; PERF.md §6), f32: 34.8 -> 30.8 us at d = 2, 29.5 -> 17.0
// at d = 1 (in the chain, profiler: 30.1 -> 26.7, 19.6 -> 10.8); D1a
// +1.5 / +0.7 us for the store (+0.3 / +0.4 in the chain), its totals
// unchanged. Registers: 42, 10 CUDA blocks an SM. Not kept: the walk with
// the next rows in flight alone (32.1 / 25.6), 2 segments (26.8 / 18.1),
// 8 (38.8 / 24.3), 64 lanes a block (31.2 / 17.1). In f64 the segments
// were slower than the walk at d = 2 (57.9 against 50.2; the parent
// 53.9): 68 registers leave 7 CUDA blocks an SM, and the walk's 128-lane
// blocks already fill the card. So D1b walks in f64 (kD1bSegs), 53.9 ->
// 50.2 and 40.4 -> 33.0 us with the parent's bits, and D1a stores
// nothing there.

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

// D1a's and D1b's geometry: segments (threads) per lane and lanes per
// CUDA block (smoothsde_tpu_torch/tile_sweep.py times variants of these
// two lines).
constexpr int kD1Segs = 4;
constexpr int kD1Lanes = 32;
constexpr int kD1Threads = kD1Segs * kD1Lanes;
// D1b's segments per lane by working type: D1a's kD1Segs in f32, seeded
// from the totals D1a leaves; one in f64, the walk, which measured faster
// there (the head note). D1b's CUDA block holds kD1Threads threads either
// way. ssde_diag_filter_segs_f32 / _f64 hand the count to the wrappers,
// which size the scratch by it.
template <typename T>
constexpr int kD1bSegs = sizeof(T) == 4 ? kD1Segs : 1;

// Thread t of a CUDA block walks segment t / kD1Lanes of lane t %
// kD1Lanes: a warp reads 32 neighbouring lanes of one step. Where D1b
// runs segments, each one but the last also leaves its total in seg
// (kD1Segs - 1, 5, lanes): the seeds of D1b's segments.
template <typename T>
__global__ void __launch_bounds__(kD1Threads)
    diag_filter_totals_kernel(const T* __restrict__ stack,
                              const T* __restrict__ hp, T p0,
                              T* __restrict__ totals, T* __restrict__ seg,
                              int L, int lanes) {
  __shared__ T part[Elem5<T>::N * kD1Threads];  // [component][segment][lane]
  const int j = threadIdx.x % kD1Lanes, s = threadIdx.x / kD1Lanes;
  const int i = blockIdx.x * kD1Lanes + j;
  int lo, hi;
  segment_of<kD1Segs>(s, L, lo, hi);
  Elem5<T> c = Elem5<T>::identity();
  if (i < lanes && lo < hi) {
    const T h = hp[0];
    DiagFwdRow<T> nxt = read_fwd(stack, lo, i, lanes);
    for (int l = lo; l < hi; ++l) {
      const DiagFwdRow<T> r = nxt;
      if (l + 1 < hi) nxt = read_fwd(stack, l + 1, i, lanes);  // in flight
      c = Elem5<T>::combine(c, elem1(r.t, r.q, r.c, r.y, r.rst, r.upd, h, p0));
    }
  }
  if (kD1bSegs<T> > 1 && s < kD1Segs - 1 && i < lanes)
    c.store(seg + (long long)s * Elem5<T>::N * lanes + i, lanes);
  c.store(part + s * kD1Lanes + j, kD1Threads);
  __syncthreads();
  if (s == 0 && i < lanes) {  // the segments' totals in time order
    for (int k = 1; k < kD1Segs; ++k) {
      Elem5<T> y;
      y.load(part + k * kD1Lanes + j, kD1Threads);
      c = Elem5<T>::combine(c, y);
    }
    c.store(totals + i, lanes);
  }
}

// D1b: thread t rescans segment s = t / (kD1Threads / S) of lane t %
// (kD1Threads / S), S = kD1bSegs<T>, from the lane's exclusive prefix
// composed with the totals of the lane's earlier segments (seg, from
// D1a), in time order. It writes its steps' moments; the lane's first
// thread sums the segments' llk partials in segment order.
template <typename T>
__global__ void __launch_bounds__(kD1Threads)
    diag_filter_scan_kernel(const T* __restrict__ stack,
                            const T* __restrict__ prefix,
                            const T* __restrict__ seg,
                            const T* __restrict__ hp, T p0,
                            T* __restrict__ moments, T* __restrict__ llk,
                            int L, int lanes) {
  constexpr int S = kD1bSegs<T>, kLanes = kD1Threads / S;
  __shared__ T part[kD1Threads];  // llk partials [segment][lane]
  const int j = threadIdx.x % kLanes, s = threadIdx.x / kLanes;
  const int i = blockIdx.x * kLanes + j;
  int lo, hi;
  segment_of<S>(s, L, lo, hi);
  T acc = T(0);
  if (i < lanes && lo < hi) {
    const T h = hp[0];
    DiagFwdRow<T> nxt = read_fwd(stack, lo, i, lanes);
    Elem5<T> c;
    c.load(prefix + i, lanes);
    for (int k = 0; k < s; ++k) {
      Elem5<T> y;
      y.load(seg + (long long)k * Elem5<T>::N * lanes + i, lanes);
      c = Elem5<T>::combine(c, y);
    }
    for (int l = lo; l < hi; ++l) {
      const DiagFwdRow<T> r = nxt;
      if (l + 1 < hi) nxt = read_fwd(stack, l + 1, i, lanes);  // in flight
      // predictive llk term BEFORE absorbing step l
      const T a_pred = r.t * c.b + r.c;
      const T Pp = r.t * r.t * c.C + r.q;
      const T F = Pp + h;
      const T u = r.y - a_pred;
      acc = acc + r.upd * T(-0.5) * (d_log(F) + u * u / F);
      c = Elem5<T>::combine(c, elem1(r.t, r.q, r.c, r.y, r.rst, r.upd, h, p0));
      T* m = moments + (long long)l * kDiagMomRows * lanes + i;
      m[0] = c.b;
      m[(long long)lanes] = c.C;
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (s == 0 && i < lanes) {
    for (int k = 1; k < S; ++k) acc = acc + part[k * kLanes + j];
    llk[i] = acc;
  }
}

}  // namespace ssde

// seg: scratch of (kD1bSegs<T> - 1) * 5 * lanes values; the wrappers read
// the count from ssde_diag_filter_segs_<suffix>.
#define SSDE_DIAG_FILTER_ENTRY(T, SUFFIX)                                      \
  extern "C" int ssde_diag_filter_segs_##SUFFIX() {                            \
    return ssde::kD1bSegs<T>;                                                  \
  }                                                                            \
  extern "C" int ssde_diag_filter_totals_##SUFFIX(                             \
      const T* stack, const T* h, double p0, T* totals, T* seg, int L,         \
      int lanes, void* stream) {                                               \
    ssde::diag_filter_totals_kernel<T>                                         \
        <<<(lanes + ssde::kD1Lanes - 1) / ssde::kD1Lanes, ssde::kD1Threads, 0, \
           static_cast<cudaStream_t>(stream)>>>(stack, h, T(p0), totals, seg,  \
                                                L, lanes);                     \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }                                                                            \
  extern "C" int ssde_diag_filter_scan_##SUFFIX(                               \
      const T* stack, const T* prefix, const T* seg, const T* h, double p0,    \
      T* moments, T* llk, int L, int lanes, void* stream) {                    \
    constexpr int kLanes = ssde::kD1Threads / ssde::kD1bSegs<T>;               \
    ssde::diag_filter_scan_kernel<T>                                           \
        <<<(lanes + kLanes - 1) / kLanes, ssde::kD1Threads, 0,                 \
           static_cast<cudaStream_t>(stream)>>>(stack, prefix, seg, h, T(p0),  \
                                                moments, llk, L, lanes);       \
    SSDE_RETURN_LAUNCH_STATUS();                                               \
  }

SSDE_DIAG_FILTER_ENTRY(float, f32)
SSDE_DIAG_FILTER_ENTRY(double, f64)
