// Element math shared by the scalar-state (BM_SSM / OU_SSM) filter, prefix
// and backward kernels.
//
// Device mirror of the plain PyTorch element math in
// smoothsde_tpu_torch/ops/diag_fused.py (`_elem1`, `_smooth_elem1`) and of
// `_comb1` (ops/kalman_soa.py) and `_comb1_rev` (ops/kalman_smooth.py);
// the JAX package's ops/diag_fused.py `_elem1`, `_comb1`, `_comb1_rev`.
// Templated on the working type T (float or double); operation order
// follows the plain version. Elem5 and Smooth3 have the interface of
// Elem14 / Smooth9 (identity, load, store, combine in scan order), so
// block_prefix.cu instantiates its kernel on them.
#pragma once

#include "ctcrw_common.cuh"

namespace ssde {

// Row layouts of the stacks (L, rows, lanes), ops/diag_fused.py.
constexpr int kDiagFwdRows = 6;  // t q c y rst upd
constexpr int kDiagBwdRows = 8;  // tn qn cn te tvn y upd rst
constexpr int kDiagMomRows = 2;  // b C
constexpr int kDiagCotRows = 4;  // t q c y

// ---- filtering element (A, b, C, eta, J); component order as _comb1

template <typename T>
struct Elem5 {
  static constexpr int N = 5;
  T A, b, C, e, J;

  __device__ static Elem5 identity() {
    Elem5 r;
    r.A = T(1); r.b = T(0); r.C = T(0); r.e = T(0); r.J = T(0);
    return r;
  }
  __device__ void load(const T* p, long long s) {
    A = p[0]; b = p[s]; C = p[2 * s]; e = p[3 * s]; J = p[4 * s];
  }
  __device__ void store(T* p, long long s) const {
    p[0] = A; p[s] = b; p[2 * s] = C; p[3 * s] = e; p[4 * s] = J;
  }
  // x covers the earlier steps, y the later ones (_comb1(e1, e2)).
  __device__ static Elem5 combine(const Elem5& x, const Elem5& y) {
    const T M = T(1) / (T(1) + x.C * y.J);
    const T A2M = y.A * M;
    const T A1M = x.A * M;
    Elem5 r;
    r.A = A2M * x.A;
    r.b = A2M * (x.b + x.C * y.e) + y.b;
    r.C = A2M * x.C * y.A + y.C;
    r.e = A1M * (y.e - y.J * x.b) + x.e;
    r.J = A1M * y.J * x.A + x.J;
    return r;
  }
};

// ---- smoothing element (E, g, L); component order as _comb1_rev

template <typename T>
struct Smooth3 {
  static constexpr int N = 3;
  T E, g, L;

  __device__ static Smooth3 identity() {
    Smooth3 r;
    r.E = T(1); r.g = T(0); r.L = T(0);
    return r;
  }
  __device__ void load(const T* p, long long s) {
    E = p[0]; g = p[s]; L = p[2 * s];
  }
  __device__ void store(T* p, long long s) const {
    p[0] = E; p[s] = g; p[2 * s] = L;
  }
  // _comb1_rev(acc, nw): nw is applied OUTSIDE acc. In scan order
  // (reverse time) acc comes first.
  __device__ static Smooth3 combine(const Smooth3& a, const Smooth3& nw) {
    Smooth3 r;
    r.E = nw.E * a.E;
    r.g = nw.E * a.g + nw.g;
    r.L = nw.E * nw.E * a.L + nw.L;
    return r;
  }
};

// Steps [lo, hi) of segment s when a lane's L steps are cut into S
// segments (threads) of ceil(L / S) consecutive steps, the last ones short
// or empty: the rule of D1a, D1b and D3a.
template <int S>
__device__ __forceinline__ void segment_of(int s, int L, int& lo, int& hi) {
  const int len = (L + S - 1) / S;
  lo = min(L, s * len);
  hi = min(L, lo + len);
}

// Filtering element of one step: reset / update / propagate-only select
// over the 0/1 masks R and U (ops/diag_fused._elem1).
template <typename T>
__device__ __forceinline__ Elem5<T> elem1(T t, T q, T c, T y, T R, T U, T h,
                                          T p0) {
  const T S = q + h;
  const T K = q / S;
  const T r = y - c;
  const T prop = (T(1) - R) * (T(1) - U);
  const T updm = (T(1) - R) * U;
  Elem5<T> e;
  e.A = updm * (T(1) - K) * t + prop * t;
  e.b = R * y + updm * (c + K * r) + prop * c;
  e.C = R * p0 + updm * (T(1) - K) * q + prop * q;
  e.e = updm * t * r / S;
  e.J = updm * t * t / S;
  return e;
}

// RTS smoothing element from the filtered moments and the LEAVING
// transition (ops/diag_fused._smooth_elem1); G receives the unmasked gain.
template <typename T>
__device__ __forceinline__ Smooth3<T> smooth_elem1(T tn, T qn, T cn, T mf,
                                                   T Pf, T TE, T& G) {
  const T Pp = tn * tn * Pf + qn;
  G = Pf * tn / Pp;
  const T g = mf - G * (tn * mf + cn);
  const T Lm = Pf - G * G * Pp;
  const T nTE = T(1) - TE;
  Smooth3<T> e;
  e.E = nTE * G;
  e.g = TE * mf + nTE * g;
  e.L = TE * Pf + nTE * Lm;
  return e;
}

}  // namespace ssde
