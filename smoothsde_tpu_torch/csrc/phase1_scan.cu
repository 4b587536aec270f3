// Phase 1 of the blocked associative scan: the inclusive scan within each
// lane, written at every step. Kernel K8.
//
// Replaces the TPU kernel smoothsde_tpu/ops/scan_utils.py:
// pallas_phase1_scan (its pallas_call, :81). Plain PyTorch version:
// pallas_phase1_scan_plain in smoothsde_tpu_torch/ops/scan_utils.py.
//
// Input and output are (L, E::N, lanes): component c of step l of lane t at
// [l][c][t]; lane t owns a contiguous run of L steps of one row of the scan
// (the lane layout of ops/ctcrw_fused.py `plan`). The element type E
// carries its combine, called as combine(carry, x) in scan order; with
// `reverse` the lane is walked from its last step to its first (the RTS
// smoother's order), which replaces the flip / scan / flip of the JAX
// package. Instantiated for every element kind of ops/ctcrw_fused.py
// ELEMS: the CTCRW filtering and smoothing elements (Elem14 `_combine2`,
// Smooth9 `_combine2_rev`; ctcrw_common.cuh), the scalar-state ones
// (Elem5 `_comb1`, Smooth3 `_comb1_rev`; diag_common.cuh) and the
// square-root ones (Sqrt14 `_combine_sqrt2`, Sqrt5 `_combine_sqrt1`;
// sqrt_common.cuh). Forward-only, as the JAX kernel (its docstring,
// scan_utils.py:37-39): the wrapper refuses an input that needs a
// gradient.
//
// Design. One thread per lane keeps the running composition in registers
// and walks its L steps: one coalesced load and one coalesced store of the
// element per step, no shared memory. The TPU version tiles lanes onto
// (8, 128) and chunks L by 32 with a VMEM carry across grid steps; here a
// lane's L steps are one loop, so nothing carries between blocks.
//
// What bounds it on the H100. Per lane-step it reads and writes E::N
// values: at 1M steps, d = 2, f32 (2M lane-steps) 224 MB for Elem14 and
// 144 MB for Smooth9, 67 and 43 us at 3.35 TB/s. The serial chain is L
// dependent combines per thread (Elem14: ~150 flops and three divisions;
// Smooth9: ~50 flops), with 62,500 threads in flight at that size. The
// square-root and scalar kinds at the same sizes: Sqrt14 224 MB (67 us;
// its chain ~250 flops, six square roots and ~10 divisions a step, is
// the longest), Sqrt5 and Elem5 80 MB (24 us), Smooth3 48 MB (14 us).
// One thread per lane is the simple design; a lane's dependent chain
// of divisions and square roots may keep it from its bound, which the
// card's measurement says (PERF.md).

#include "ctcrw_common.cuh"
#include "diag_common.cuh"
#include "sqrt_common.cuh"

namespace ssde {

template <typename T, typename E>
__global__ void __launch_bounds__(128)
    phase1_scan_kernel(const T* __restrict__ in, T* __restrict__ out, int L,
                       int lanes, int reverse) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= lanes) return;
  const long long step = (long long)E::N * lanes;
  E c = E::identity();
  for (int s = 0; s < L; ++s) {
    const int l = reverse ? L - 1 - s : s;
    E x;
    x.load(in + l * step + t, lanes);
    c = E::combine(c, x);
    c.store(out + l * step + t, lanes);
  }
}

}  // namespace ssde

#define SSDE_PHASE1_ENTRY(T, SUFFIX, NAME, ELEM)                            \
  extern "C" int ssde_phase1_scan_##NAME##_##SUFFIX(                        \
      const T* in, T* out, int L, int lanes, int reverse, void* stream) {   \
    ssde::phase1_scan_kernel<T, ssde::ELEM<T>>                              \
        <<<ssde::grid_for(lanes), ssde::kThreads, 0,                        \
           static_cast<cudaStream_t>(stream)>>>(in, out, L, lanes, reverse); \
    SSDE_RETURN_LAUNCH_STATUS();                                            \
  }

SSDE_PHASE1_ENTRY(float, f32, filter, Elem14)
SSDE_PHASE1_ENTRY(double, f64, filter, Elem14)
SSDE_PHASE1_ENTRY(float, f32, smooth, Smooth9)
SSDE_PHASE1_ENTRY(double, f64, smooth, Smooth9)
SSDE_PHASE1_ENTRY(float, f32, diag_filter, Elem5)
SSDE_PHASE1_ENTRY(double, f64, diag_filter, Elem5)
SSDE_PHASE1_ENTRY(float, f32, diag_smooth, Smooth3)
SSDE_PHASE1_ENTRY(double, f64, diag_smooth, Smooth3)
SSDE_PHASE1_ENTRY(float, f32, sqrt2, Sqrt14)
SSDE_PHASE1_ENTRY(double, f64, sqrt2, Sqrt14)
SSDE_PHASE1_ENTRY(float, f32, sqrt1, Sqrt5)
SSDE_PHASE1_ENTRY(double, f64, sqrt1, Sqrt5)
