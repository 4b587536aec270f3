// Square-root (Cholesky-form) filtering elements for the phase-1 scan K8
// and the cross-block prefix K2.
//
// Device mirror of smoothsde_tpu_torch/ops/kalman_sqrt.py `_combine_sqrt2`
// (Sqrt14: state dim 2, the CTCRW dims) and `_combine_sqrt1` (Sqrt5: state
// dim 1, BM_SSM / OU_SSM), ports of the JAX package's
// ops/kalman_sqrt.py. Templated on the working type T (float or double);
// the operation order follows the plain version, so f64 agrees with it to
// a few ulp (the compiler may fuse a multiply and an add). Sqrt14 and
// Sqrt5 have the interface of Elem14 / Elem5 (N, identity, load, store,
// combine(earlier, later)), so K8 and K2 instantiate their kernels on them.
//
// Components in the order of ops/ctcrw_fused.py ELEMS: Sqrt14 = A (4:
// a00 a01 a10 a11), b (2), U (3: l00 l10 l11, C = U U'), eta (2), Z (3,
// J = Z Z'); Sqrt5 = A, b, u, eta, z.
//
// Padding and masked elements carry exact zero factors, so every square
// root and division that can see a zero goes through ssqrt / sdiv
// (ops/kalman_sqrt.py `_ssqrt`, `_sdiv`): sqrt of a non-positive value is
// 0, a / 0 is 0. Both are selects, as the plain version's torch.where:
// the argument is replaced before the square root or the division (by 1,
// a value that takes neither's slow path) and the result after, so no
// branch depends on the data. The combine's own 2x2 Cholesky factors are
// of I + K'K, never below 1, and take the plain sqrt and division.
//
// Division policy. combine<D> divides with D (csrc/ctcrw_common.cuh):
// IeeeDiv, the `/` operator, by default (K8), BranchFreeDiv in K2
// (csrc/block_prefix.cu): in f32 the correctly rounded quotient without
// `/`'s FCHK slow-path branch, the same bits for a normal nonzero
// denominator. Every denominator here is one: sdiv selects 1 for an exact
// zero, a denominator of sdiv is a square root of a sum of squares (never
// below sqrt of the least denormal, ~4e-23 in f32: normal) and the
// combine's own are Cholesky factors >= 1. f64 keeps `/` under either.
// Sqrt14's combine has 8 square roots and 16 divisions on a dependent
// chain sqrt -> / -> sqrt -> / -> tria24 (sqrt -> 4 / -> sqrt), ~650
// SASS instructions in f32; Sqrt5's one division and three square
// roots, ~110.
//
// K2 takes these elements through its run design (block_prefix.cu,
// design 2: runs of 4 blocks a thread, two passes, no single-block
// carry), not the reduce / carry / rescan design of the moment-form
// elements, whose ~13 combines an element cost Sqrt14 83.5 us. Measured
// on an H100 SXM (700 W) at NB = 31,250, d = 2, device time per call:
// Sqrt14 19.4 us f32, 71 us f64; Sqrt5 8.2 / 11.8 us. With the selects
// and BranchFreeDiv its f32 kernels hold no FCHK and 38-53 BSSY (the
// square roots' own range checks) against 96-132 FCHK and 303-413 BSSY
// before.
#pragma once

#include "ctcrw_common.cuh"

namespace ssde {

template <typename T>
__device__ __forceinline__ T ssqrt(T x) {
  const bool pos = x > T(0);
  const T r = sqrt(pos ? x : T(1));
  return pos ? r : T(0);
}

template <typename D, typename T>
__device__ __forceinline__ T sdiv(T a, T b) {
  const bool nz = b != T(0);
  const T q = D::div(a, nz ? b : T(1));
  return nz ? q : T(0);
}

// Closed-form LQ of the 2 x 4 row block [x; y]: the lower-triangular
// (l00, l10, l11) with [x; y][x; y]' = L L' (ops/kalman_sqrt._tria24).
template <typename D, typename T>
__device__ __forceinline__ void tria24(const T x[4], const T y[4], T& l00,
                                       T& l10, T& l11) {
  l00 = ssqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3]);
  T q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = sdiv<D>(x[i], l00);
  l10 = y[0] * q[0] + y[1] * q[1] + y[2] * q[2] + y[3] * q[3];
  T w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = y[i] - l10 * q[i];
  l11 = ssqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + w[3] * w[3]);
}

template <typename T>
struct Sqrt14 {
  static constexpr int N = 14;
  T a00, a01, a10, a11, b0, b1, u00, u10, u11, e0, e1, z00, z10, z11;

  __device__ static Sqrt14 identity() {
    Sqrt14 r;
    r.a00 = T(1); r.a01 = T(0); r.a10 = T(0); r.a11 = T(1);
    r.b0 = T(0); r.b1 = T(0);
    r.u00 = T(0); r.u10 = T(0); r.u11 = T(0);
    r.e0 = T(0); r.e1 = T(0);
    r.z00 = T(0); r.z10 = T(0); r.z11 = T(0);
    return r;
  }
  __device__ void load(const T* p, long long s) {
    a00 = p[0]; a01 = p[s]; a10 = p[2 * s]; a11 = p[3 * s];
    b0 = p[4 * s]; b1 = p[5 * s];
    u00 = p[6 * s]; u10 = p[7 * s]; u11 = p[8 * s];
    e0 = p[9 * s]; e1 = p[10 * s];
    z00 = p[11 * s]; z10 = p[12 * s]; z11 = p[13 * s];
  }
  __device__ void store(T* p, long long s) const {
    p[0] = a00; p[s] = a01; p[2 * s] = a10; p[3 * s] = a11;
    p[4 * s] = b0; p[5 * s] = b1;
    p[6 * s] = u00; p[7 * s] = u10; p[8 * s] = u11;
    p[9 * s] = e0; p[10 * s] = e1;
    p[11 * s] = z00; p[12 * s] = z10; p[13 * s] = z11;
  }
  // x covers the earlier steps, y the later ones (_combine_sqrt2(e1, e2)).
  template <typename D = IeeeDiv>
  __device__ static Sqrt14 combine(const Sqrt14& x, const Sqrt14& y) {
    const T p00 = x.u00, p10 = x.u10, p11 = x.u11;  // U1
    const T w00 = y.z00, w10 = y.z10, w11 = y.z11;  // Z2
    // K = U1' Z2
    const T k00 = p00 * w00 + p10 * w10;
    const T k01 = p10 * w11;
    const T k10 = p11 * w10;
    const T k11 = p11 * w11;
    // Lt = chol(I + K'K); V = Z2 Lt^{-T}; W = U1 K Lt^{-T}
    const T t00 = sqrt(T(1) + k00 * k00 + k10 * k10);
    const T t10 = D::div(k00 * k01 + k10 * k11, t00);
    const T t11 = sqrt(T(1) + k01 * k01 + k11 * k11 - t10 * t10);
    const T iu00 = D::div(T(1), t00);
    const T iu01 = D::div(-t10, t00 * t11);
    const T iu11 = D::div(T(1), t11);
    const T V00 = w00 * iu00, V01 = w00 * iu01;
    const T V10 = w10 * iu00, V11 = w10 * iu01 + w11 * iu11;
    const T uk00 = p00 * k00, uk01 = p00 * k01;
    const T uk10 = p10 * k00 + p11 * k10, uk11 = p10 * k01 + p11 * k11;
    const T W00 = uk00 * iu00, W01 = uk00 * iu01 + uk01 * iu11;
    const T W10 = uk10 * iu00, W11 = uk10 * iu01 + uk11 * iu11;

    // (I - W V') v and (I - V W') v
    auto m_apply = [&](T v0, T v1, T& o0, T& o1) {
      const T s0 = V00 * v0 + V10 * v1;
      const T s1 = V01 * v0 + V11 * v1;
      o0 = v0 - (W00 * s0 + W01 * s1);
      o1 = v1 - (W10 * s0 + W11 * s1);
    };
    auto mt_apply = [&](T v0, T v1, T& o0, T& o1) {
      const T s0 = W00 * v0 + W10 * v1;
      const T s1 = W01 * v0 + W11 * v1;
      o0 = v0 - (V00 * s0 + V01 * s1);
      o1 = v1 - (V10 * s0 + V11 * s1);
    };

    Sqrt14 r;
    // A = A2 M A1
    T c00, c01, c10, c11;  // (M A1) column 0 = (c00, c01), column 1 = (c10, c11)
    m_apply(x.a00, x.a10, c00, c01);
    m_apply(x.a01, x.a11, c10, c11);
    r.a00 = y.a00 * c00 + y.a01 * c01;
    r.a01 = y.a00 * c10 + y.a01 * c11;
    r.a10 = y.a10 * c00 + y.a11 * c01;
    r.a11 = y.a10 * c10 + y.a11 * c11;

    // b = A2 M (b1 + U1 (U1' eta2)) + b2
    {
      const T s0 = p00 * y.e0 + p10 * y.e1;
      const T s1 = p11 * y.e1;
      T mt0, mt1;
      m_apply(x.b0 + p00 * s0, x.b1 + p10 * s0 + p11 * s1, mt0, mt1);
      r.b0 = y.a00 * mt0 + y.a01 * mt1 + y.b0;
      r.b1 = y.a10 * mt0 + y.a11 * mt1 + y.b1;
    }
    // eta = A1' M' (eta2 - Z2 (Z2' b1)) + eta1
    {
      const T zb0 = w00 * x.b0 + w10 * x.b1;
      const T zb1 = w11 * x.b1;
      T nq0, nq1;
      mt_apply(y.e0 - w00 * zb0, y.e1 - (w10 * zb0 + w11 * zb1), nq0, nq1);
      r.e0 = x.a00 * nq0 + x.a10 * nq1 + x.e0;
      r.e1 = x.a01 * nq0 + x.a11 * nq1 + x.e1;
    }
    // U = tria([A2 U1 Lh^{-T} | U2]), Lh = chol(I + K K')
    {
      const T h00 = sqrt(T(1) + k00 * k00 + k01 * k01);
      const T h10 = D::div(k00 * k10 + k01 * k11, h00);
      const T h11 = sqrt(T(1) + k10 * k10 + k11 * k11 - h10 * h10);
      const T ju00 = D::div(T(1), h00);
      const T ju01 = D::div(-h10, h00 * h11);
      const T ju11 = D::div(T(1), h11);
      const T y00 = p00 * ju00, y01 = p00 * ju01;
      const T y10 = p10 * ju00, y11 = p10 * ju01 + p11 * ju11;
      const T ay00 = y.a00 * y00 + y.a01 * y10;
      const T ay01 = y.a00 * y01 + y.a01 * y11;
      const T ay10 = y.a10 * y00 + y.a11 * y10;
      const T ay11 = y.a10 * y01 + y.a11 * y11;
      const T r1[4] = {ay00, ay01, y.u00, T(0) * ay00};
      const T r2[4] = {ay10, ay11, y.u10, y.u11};
      tria24<D>(r1, r2, r.u00, r.u10, r.u11);
    }
    // Z = tria([A1' V | Z1])
    {
      const T av00 = x.a00 * V00 + x.a10 * V10;
      const T av01 = x.a00 * V01 + x.a10 * V11;
      const T av10 = x.a01 * V00 + x.a11 * V10;
      const T av11 = x.a01 * V01 + x.a11 * V11;
      const T r1[4] = {av00, av01, x.z00, T(0) * av00};
      const T r2[4] = {av10, av11, x.z10, x.z11};
      tria24<D>(r1, r2, r.z00, r.z10, r.z11);
    }
    return r;
  }
};

template <typename T>
struct Sqrt5 {
  static constexpr int N = 5;
  T A, b, u, e, z;

  __device__ static Sqrt5 identity() {
    Sqrt5 r;
    r.A = T(1); r.b = T(0); r.u = T(0); r.e = T(0); r.z = T(0);
    return r;
  }
  __device__ void load(const T* p, long long s) {
    A = p[0]; b = p[s]; u = p[2 * s]; e = p[3 * s]; z = p[4 * s];
  }
  __device__ void store(T* p, long long s) const {
    p[0] = A; p[s] = b; p[2 * s] = u; p[3 * s] = e; p[4 * s] = z;
  }
  // x covers the earlier steps, y the later ones (_combine_sqrt1(e1, e2)).
  template <typename D = IeeeDiv>
  __device__ static Sqrt5 combine(const Sqrt5& x, const Sqrt5& y) {
    const T k = x.u * y.z;
    const T M = D::div(T(1), T(1) + k * k);
    const T sM = sqrt(M);
    Sqrt5 r;
    r.A = y.A * M * x.A;
    r.b = y.A * M * (x.b + x.u * (x.u * y.e)) + y.b;
    const T au = y.A * x.u * sM;
    r.u = ssqrt(au * au + y.u * y.u);
    r.e = x.A * M * (y.e - y.z * (y.z * x.b)) + x.e;
    const T az = x.A * y.z * sM;
    r.z = ssqrt(az * az + x.z * x.z);
    return r;
  }
};

}  // namespace ssde
