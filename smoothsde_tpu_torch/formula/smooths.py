"""Penalized smooth bases: thin-plate (tp/ts), cubic regression (cr/cs),
B-splines (bs), and i.i.d. random effects (re).

Host-side (NumPy) trace-time construction, following Wood (2003,
"Thin plate regression splines") and Wood (2017, GAMs in R, ch. 5).
These replace the reference's delegation to mgcv::gam(fit=FALSE)
(reference R/sde.R:396-408). Outputs are static design/penalty
matrices fed to jitted code.

Conventions shared with mgcv (so that the reference's shape contracts
hold, e.g. test_sde.R:53-72):
  - a smooth with basis dimension k contributes k-1 columns after the
    sum-to-zero identifiability constraint is absorbed (re smooths are
    not constrained);
  - every basis column of a smooth is penalized ("random effect" in the
    reference's split); strictly parametric columns are handled by the
    design layer, not here;
  - shrinkage variants (ts/cs) modify the penalty so the null space is
    weakly penalized, making S full rank (required by the proper-prior
    penalty of nllk_sde.hpp:109-119).

Sign/rotation conventions of eigenbases differ from mgcv; the spanned
function space and penalties agree, which is what the estimates depend
on.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_MAX_TP_KNOTS = 2000  # subsample unique covariate values beyond this


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def sum_to_zero_constraint(X: np.ndarray):
    """Orthonormal null-space basis Z of the constraint 1'X b = 0.

    Returns Z (k, k-1) with (1'X) Z = 0; the constrained smooth uses
    columns X Z and penalty Z' S Z (mgcv's centering constraint).
    """
    C = X.sum(axis=0, keepdims=True)  # (1, k)
    # Householder-style: full QR of C' gives Q whose columns 2..k span
    # the null space of C.
    Q, _ = np.linalg.qr(C.T, mode="complete")
    return Q[:, 1:]


def shrinkage_penalty(S: np.ndarray, null_dim: int, eps: float = 1e-1):
    """Modify a rank-deficient penalty so its null space is weakly
    penalized (mgcv's ts/cs shrinkage bases).

    Eigenvalues in the null space are replaced by eps times the smallest
    strictly positive eigenvalue. This makes S full rank so the
    normalized Gaussian prior of nllk_sde.hpp:109-119 is proper and the
    whole term can shrink to zero.
    """
    if null_dim <= 0:
        return S
    w, V = np.linalg.eigh(S)
    # ascending: first null_dim are (numerically) zero
    w = w.copy()
    pos = w[null_dim:]
    floor = eps * pos.min() if pos.size else eps
    w[:null_dim] = floor
    return (V * w) @ V.T


def _place_knots(x: np.ndarray, k: int) -> np.ndarray:
    """Knots at interpolated order statistics of unique values
    (mgcv's place.knots behavior)."""
    u = np.unique(x)
    if len(u) < k:
        raise ValueError(
            f"basis dimension k={k} exceeds number of unique covariate "
            f"values ({len(u)})"
        )
    pos = np.linspace(0, len(u) - 1, k)
    lo = np.floor(pos).astype(int)
    hi = np.ceil(pos).astype(int)
    frac = pos - lo
    return u[lo] * (1 - frac) + u[hi] * frac


# ---------------------------------------------------------------------------
# Smooth basis classes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SmoothBasis:
    """Fitted smooth: evaluation state + penalty.

    X: (n, p) constrained basis at the construction data
    S: (p, p) penalty (possibly full-rank after shrinkage)
    """

    label: str
    X: np.ndarray
    S: np.ndarray
    col_names: list

    @property
    def S_list(self) -> list:
        """Penalty matrices sharing this block's coefficients (one for
        ordinary smooths; one per margin for tensor products)."""
        return [self.S]

    def eval(self, x_new: np.ndarray) -> np.ndarray:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class _TPState:
    knots: np.ndarray  # (K, d) radial basis centers
    shift: np.ndarray  # (d,)
    scale: np.ndarray  # (d,)
    UkZ: np.ndarray  # (K, p_spline) combined eigen + constraint transform
    T_transform: np.ndarray  # maps [E_new UkZ | T_new] -> final columns


class TPSmooth(SmoothBasis):
    """Thin plate regression spline, d in {1, 2}, penalty order m=2
    (Wood 2003).

    eta(r) = r^3/12 (d=1) or r^2 log r / (8 pi) (d=2); basis from the
    leading eigenvectors of the radial matrix E on the (possibly
    subsampled) unique covariate values/pairs, null space = polynomials
    of degree < 2 ({1, x} or {1, x, y}), spline coefficients constrained
    orthogonal to the null space, then the model-level sum-to-zero
    constraint is absorbed. 'ts' applies shrinkage_penalty afterwards.
    The d=2 smooth is isotropic with a SINGLE penalty (mgcv s(x, y)),
    unlike scale-variant tensor products.
    """

    def __init__(self, label, x, k, shrink=False, center=True):
        x = np.asarray(x, float)
        if x.ndim == 1:
            x = x[:, None]
        d = x.shape[1]
        if d not in (1, 2):
            raise ValueError("tp basis supports 1 or 2 covariates")
        u = np.unique(x, axis=0)
        M = d + 1  # null-space dim for m=2
        if k < M + 1:
            raise ValueError(f"tp basis needs k >= {M + 1} for d={d}")
        if len(u) > _MAX_TP_KNOTS:
            pos = np.linspace(0, len(u) - 1, _MAX_TP_KNOTS).round().astype(int)
            u = u[pos]
        if len(u) < k:
            raise ValueError(
                f"basis dimension k={k} exceeds number of unique covariate "
                f"values ({len(u)})"
            )
        # standardize for conditioning
        shift = u.mean(axis=0)
        scale = u.std(axis=0) + 1e-300
        us = (u - shift) / scale
        xs = (x - shift) / scale

        E = _tp_eta(_pairdist(us, us), d)
        Tmat = _tp_null_basis(us)  # (K, M)

        w, V = np.linalg.eigh(E)
        order = np.argsort(-np.abs(w))
        w, V = w[order], V[:, order]
        Uk = V[:, :k]  # k leading eigenvectors (by magnitude)
        Dk = w[:k]

        # constrain spline coefficients: T' Uk d = 0 -> d = Zc z
        CT = Tmat.T @ Uk  # (M, k)
        Qc, _ = np.linalg.qr(CT.T, mode="complete")
        Zc = Qc[:, M:]  # (k, k - M)
        UkZ = Uk @ Zc  # (K, k-M): delta = UkZ z

        X_spline = _tp_eta(_pairdist(xs, us), d) @ UkZ
        X_full = np.column_stack([X_spline, _tp_null_basis(xs)])
        # energy = delta' E delta = z' (Zc' diag(Dk) Zc) z
        S_full = np.zeros((k, k))
        S_full[: k - M, : k - M] = Zc.T @ (Dk[:, None] * Zc)

        # absorb the sum-to-zero constraint over the data (center=False
        # keeps the raw basis — tensor-product margins center jointly)
        if center:
            Z = sum_to_zero_constraint(X_full)
        else:
            Z = np.eye(X_full.shape[1])
        X = X_full @ Z
        S = Z.T @ S_full @ Z
        # exact penalty null dim: degree-<2 polynomials (M directions);
        # centering removes the constant -> M - 1 remain
        if shrink:
            S = shrinkage_penalty(S, null_dim=M - 1 if center else M)

        self._state = _TPState(
            knots=u, shift=shift, scale=scale, UkZ=UkZ, T_transform=Z
        )
        super().__init__(
            label=label,
            X=X,
            S=0.5 * (S + S.T),
            col_names=[f"{label}.{i + 1}" for i in range(X.shape[1])],
        )

    def eval(self, x_new):
        st = self._state
        x_new = np.asarray(x_new, float)
        if x_new.ndim == 1:
            x_new = x_new[:, None]
        d = st.knots.shape[1]
        xs = (x_new - st.shift) / st.scale
        us = (st.knots - st.shift) / st.scale
        X_spline = _tp_eta(_pairdist(xs, us), d) @ st.UkZ
        X_full = np.column_stack([X_spline, _tp_null_basis(xs)])
        return X_full @ st.T_transform


def _pairdist(a, b):
    """Euclidean distances between row sets (na, d) x (nb, d)."""
    diff = a[:, None, :] - b[None, :, :]
    return np.sqrt((diff**2).sum(axis=-1))


def _tp_eta(r, d):
    """Thin-plate radial basis for m=2: r^3/12 (d=1),
    r^2 log(r)/(8 pi) (d=2, with eta(0) = 0)."""
    if d == 1:
        return r**3 / 12.0
    with np.errstate(divide="ignore", invalid="ignore"):
        out = r * r * np.log(r) / (8.0 * np.pi)
    return np.where(r > 0, out, 0.0)


def _tp_null_basis(xs):
    """Polynomials of degree < m=2: [1, x] or [1, x, y]."""
    return np.column_stack([np.ones(len(xs)), xs])


def Tmat_eval(xs):
    return _tp_null_basis(np.asarray(xs, float).reshape(len(xs), -1))


@dataclasses.dataclass
class _CRState:
    knots: np.ndarray
    F: np.ndarray  # (k, k): beta -> second derivatives at knots
    Z: np.ndarray  # constraint transform


class CRSmooth(SmoothBasis):
    """Cubic regression spline with knots at covariate quantiles
    (Wood 2017 section 5.3.1). Parameters are function values at the
    knots; penalty is the integrated squared second derivative
    S = D' B^-1 D. Linear extrapolation outside the knot range.
    'cs' applies shrinkage to the 1-dim post-centering null space.
    """

    def __init__(self, label, x, k, shrink=False, center=True, knots=None):
        x = np.asarray(x, float)
        if knots is not None:
            knots = np.sort(np.asarray(knots, float))
            k = len(knots)
        if k < 3:
            raise ValueError("cr basis needs k >= 3")
        if knots is None:
            knots = _place_knots(x, k)
        h = np.diff(knots)
        D = np.zeros((k - 2, k))
        B = np.zeros((k - 2, k - 2))
        for i in range(k - 2):
            D[i, i] = 1.0 / h[i]
            D[i, i + 1] = -1.0 / h[i] - 1.0 / h[i + 1]
            D[i, i + 2] = 1.0 / h[i + 1]
            B[i, i] = (h[i] + h[i + 1]) / 3.0
            if i < k - 3:
                B[i, i + 1] = h[i + 1] / 6.0
                B[i + 1, i] = h[i + 1] / 6.0
        Binv_D = np.linalg.solve(B, D)
        F = np.vstack([np.zeros(k), Binv_D, np.zeros(k)])  # natural BCs
        S_full = D.T @ Binv_D

        X_full = _cr_design(x, knots, F)
        Z = sum_to_zero_constraint(X_full) if center else np.eye(k)
        X = X_full @ Z
        S = Z.T @ S_full @ Z
        if shrink:
            S = shrinkage_penalty(S, null_dim=1 if center else 2)
        self._state = _CRState(knots=knots, F=F, Z=Z)
        super().__init__(
            label=label,
            X=X,
            S=0.5 * (S + S.T),
            col_names=[f"{label}.{i + 1}" for i in range(X.shape[1])],
        )

    def eval(self, x_new):
        st = self._state
        return _cr_design(np.asarray(x_new, float), st.knots, st.F) @ st.Z


def _cr_design(x, knots, F):
    """Evaluate the cr basis (values-at-knots parameterization) at x,
    with linear extrapolation beyond the boundary knots."""
    k = len(knots)
    n = len(x)
    lo, hi = knots[0], knots[-1]
    x_in = np.clip(x, lo, hi)
    j = np.clip(np.searchsorted(knots, x_in, side="right") - 1, 0, k - 2)
    h = knots[j + 1] - knots[j]
    xl = (knots[j + 1] - x_in) / h  # a^- weight
    xr = (x_in - knots[j]) / h
    cl = ((knots[j + 1] - x_in) ** 3 / h - h * (knots[j + 1] - x_in)) / 6.0
    cr = ((x_in - knots[j]) ** 3 / h - h * (x_in - knots[j])) / 6.0

    X = np.zeros((n, k))
    rows = np.arange(n)
    np.add.at(X, (rows, j), xl)
    np.add.at(X, (rows, j + 1), xr)
    X += cl[:, None] * F[j, :] + cr[:, None] * F[j + 1, :]

    # Linear extrapolation: f(x) = f(b) + f'(b) (x - b) outside [lo, hi].
    out_lo = x < lo
    out_hi = x > hi
    if out_lo.any() or out_hi.any():
        d = 1e-6 * (hi - lo)
        for mask, b, sgn in ((out_lo, lo, 1.0), (out_hi, hi, -1.0)):
            if not mask.any():
                continue
            Xb = _cr_design(np.array([b, b + sgn * d]), knots, F)
            slope = sgn * (Xb[1] - Xb[0]) / d
            X[mask] = Xb[0][None, :] + (x[mask] - b)[:, None] * slope[None, :]
    return X


@dataclasses.dataclass
class _CCState:
    knots: np.ndarray  # (K,) including both endpoints (identified)
    F: np.ndarray  # (K-1, K-1): free values -> curvatures at knots
    Z: np.ndarray


class CCSmooth(SmoothBasis):
    """Cyclic cubic regression spline (Wood 2017 section 5.3.2 flavor;
    mgcv bs='cc'). Parameters are function values at the K-1 distinct
    knots; f and its first two derivatives are continuous across the
    wrap point f(knot_K) = f(knot_0). Penalty is the integrated squared
    second derivative over one period. Evaluation wraps x into the knot
    range modulo the period.
    """

    def __init__(self, label, x, k, shrink=False, center=True, knots=None):
        x = np.asarray(x, float)
        if knots is not None:
            knots = np.sort(np.asarray(knots, float))
            k = len(knots)
        if k < 4:
            raise ValueError("cc basis needs k >= 4")
        if knots is None:
            knots = _place_knots(x, k)
        K = k - 1  # free values (last knot identified with first)
        h = np.diff(knots)  # (K,) interval widths, h[K-1] closes the loop

        # Cyclic value->curvature system B gam = D beta with gam the
        # second derivatives at the K free knots: continuity of f' at
        # every knot of the periodic natural spline.
        B = np.zeros((K, K))
        D = np.zeros((K, K))
        for i in range(K):  # knot i, intervals (i-1) and i
            im = (i - 1) % K
            ip = (i + 1) % K
            B[i, im] += h[im] / 6.0
            B[i, i] += (h[im] + h[i]) / 3.0
            B[i, ip] += h[i] / 6.0
            D[i, im] += 1.0 / h[im]
            D[i, i] += -1.0 / h[im] - 1.0 / h[i]
            D[i, ip] += 1.0 / h[i]
        # duplicate wrap contributions collapse for K=3; fine for K>=3
        F = np.linalg.solve(B, D)  # (K, K)
        S_full = D.T @ F  # D' B^-1 D

        X_full = _cc_design(x, knots, F)
        Z = sum_to_zero_constraint(X_full) if center else np.eye(K)
        X = X_full @ Z
        S = Z.T @ S_full @ Z
        if shrink:
            S = shrinkage_penalty(S, null_dim=1)
        self._state = _CCState(knots=knots, F=F, Z=Z)
        super().__init__(
            label=label,
            X=X,
            S=0.5 * (S + S.T),
            col_names=[f"{label}.{i + 1}" for i in range(X.shape[1])],
        )

    def eval(self, x_new):
        st = self._state
        return _cc_design(np.asarray(x_new, float), st.knots, st.F) @ st.Z


def _cc_design(x, knots, F):
    """Evaluate the cyclic basis (values at the K-1 free knots) at x,
    wrapping into [knots[0], knots[-1]) modulo the period."""
    K = len(knots) - 1  # free values
    lo, hi = knots[0], knots[-1]
    period = hi - lo
    x_in = lo + np.mod(np.asarray(x, float) - lo, period)
    j = np.clip(np.searchsorted(knots, x_in, side="right") - 1, 0, K - 1)
    h = knots[j + 1] - knots[j]
    xl = (knots[j + 1] - x_in) / h
    xr = (x_in - knots[j]) / h
    cl = ((knots[j + 1] - x_in) ** 3 / h - h * (knots[j + 1] - x_in)) / 6.0
    cr = ((x_in - knots[j]) ** 3 / h - h * (x_in - knots[j])) / 6.0

    n = len(x_in)
    X = np.zeros((n, K))
    rows = np.arange(n)
    jp = (j + 1) % K  # value at the wrap knot is the first free value
    np.add.at(X, (rows, j), xl)
    np.add.at(X, (rows, jp), xr)
    X += cl[:, None] * F[j, :] + cr[:, None] * F[jp, :]
    return X


class BSSmooth(SmoothBasis):
    """Cubic B-spline basis with a second-difference penalty (P-spline
    flavor of mgcv's bs/ps). Interior knots at covariate quantiles."""

    def __init__(self, label, x, k, shrink=False):
        x = np.asarray(x, float)
        if k < 4:
            raise ValueError("bs basis needs k >= 4")
        degree = 3
        n_interior = k - degree - 1
        inner = (
            _place_knots(x, n_interior + 2)[1:-1]
            if n_interior > 0
            else np.empty(0)
        )
        lo, hi = x.min(), x.max()
        pad = np.finfo(float).eps * max(1.0, abs(hi - lo))
        t = np.concatenate(
            [np.repeat(lo - pad, degree + 1), inner, np.repeat(hi + pad, degree + 1)]
        )
        self._t, self._degree = t, degree
        X_full = _bspline_design(x, t, degree, k)
        D2 = np.diff(np.eye(k), n=2, axis=0)
        S_full = D2.T @ D2
        Z = sum_to_zero_constraint(X_full)
        X = X_full @ Z
        S = Z.T @ S_full @ Z
        if shrink:
            S = shrinkage_penalty(S, null_dim=1)
        self._Z = Z
        super().__init__(
            label=label,
            X=X,
            S=0.5 * (S + S.T),
            col_names=[f"{label}.{i + 1}" for i in range(X.shape[1])],
        )

    def eval(self, x_new):
        return (
            _bspline_design(np.asarray(x_new, float), self._t, self._degree, self.X.shape[1] + 1)
            @ self._Z
        )


def _bspline_design(x, t, degree, k):
    """Cox-de Boor recursion, clamping x into the knot span."""
    x = np.clip(x, t[degree], t[-degree - 1] - 1e-300)
    n = len(x)
    # order-1 (degree 0) indicators
    B = np.zeros((n, len(t) - 1))
    for j in range(len(t) - 1):
        B[:, j] = (x >= t[j]) & (x < t[j + 1])
    for d in range(1, degree + 1):
        Bn = np.zeros((n, len(t) - d - 1))
        for j in range(len(t) - d - 1):
            den1 = t[j + d] - t[j]
            den2 = t[j + d + 1] - t[j + 1]
            term = 0.0
            if den1 > 0:
                term = term + (x - t[j]) / den1 * B[:, j]
            if den2 > 0:
                term = term + (t[j + d + 1] - x) / den2 * B[:, j + 1]
            Bn[:, j] = term
        B = Bn
    return B[:, :k]


class RESmooth(SmoothBasis):
    """i.i.d. Gaussian random effect of a factor: indicator basis with
    identity penalty, no centering constraint (mgcv bs='re',
    test_sde.R:61 expects k = nlevels columns)."""

    def __init__(self, label, x, levels=None):
        x = np.asarray(x)
        if levels is None:
            levels = sorted(np.unique(x).tolist())
        self.levels = list(levels)
        X = self._indicators(x)
        k = len(self.levels)
        super().__init__(
            label=label,
            X=X,
            S=np.eye(k),
            col_names=[f"{label}.{i + 1}" for i in range(k)],
        )

    def _indicators(self, x):
        idx = {lv: i for i, lv in enumerate(self.levels)}
        X = np.zeros((len(x), len(self.levels)))
        for r, v in enumerate(np.asarray(x).tolist()):
            if v not in idx:
                raise ValueError(f"unknown factor level {v!r} in re smooth")
            X[r, idx[v]] = 1.0
        return X

    def eval(self, x_new):
        return self._indicators(np.asarray(x_new))


class TensorSmooth(SmoothBasis):
    """Tensor-product smooth te/ti of two 1-d margins (mgcv te()/ti()).

    Design = row-wise Kronecker product of the marginal bases; TWO
    penalties share the block's coefficients (one per margin):
      S_1 = S_m1 (x) I,   S_2 = I (x) S_m2
    so each margin gets its own smoothing parameter (scale-variant
    anisotropic smoothing, unlike the isotropic s(x1, x2)).

    te: margins UNcentered, one joint sum-to-zero constraint absorbed
        afterwards (k1*k2 - 1 columns).
    ti: margins individually centered (the interaction-only term;
        (k1-1)*(k2-1) columns, no joint constraint).

    NOTE (exceeds the reference): the reference's TMB penalty assumes
    one lambda per coefficient block (nllk_sde.hpp:91-124), so mgcv
    te/ti terms cannot be fit by the reference at all; here the
    objective's multi-penalty groups handle them
    (ops/penalty.py:make_penalty). Use shrinkage margins (bs='cs'/'ts')
    for a full-rank prior, exactly as for 1-d smooths.
    """

    def __init__(self, label, x, k1, k2, bs="cs", mode="te"):
        x = np.asarray(x, float)
        assert x.ndim == 2 and x.shape[1] == 2
        center_margins = mode == "ti"
        self._margins = [
            _marginal_basis(f"{label}[m{j + 1}]", x[:, j], kj, bs,
                            center=center_margins)
            for j, kj in enumerate((k1, k2))
        ]
        X1, X2 = (m.X for m in self._margins)
        p1, p2 = X1.shape[1], X2.shape[1]
        X_full = _row_kron(X1, X2)
        S1 = np.kron(self._margins[0].S, np.eye(p2))
        S2 = np.kron(np.eye(p1), self._margins[1].S)
        if mode == "te":
            Z = sum_to_zero_constraint(X_full)
            X = X_full @ Z
            S_list = [Z.T @ S1 @ Z, Z.T @ S2 @ Z]
        else:
            Z = np.eye(p1 * p2)
            X = X_full
            S_list = [S1, S2]
        self._Z = Z
        self._mode = mode
        self._S_list = [0.5 * (S + S.T) for S in S_list]
        super().__init__(
            label=label,
            X=X,
            S=sum(self._S_list),  # lambda = 1 aggregate (accessor only)
            col_names=[f"{label}.{i + 1}" for i in range(X.shape[1])],
        )

    @property
    def S_list(self):
        return list(self._S_list)

    def eval(self, x_new):
        x_new = np.asarray(x_new, float)
        X1 = self._margins[0].eval(x_new[:, 0])
        X2 = self._margins[1].eval(x_new[:, 1])
        return _row_kron(X1, X2) @ self._Z


def _row_kron(A, B):
    """Row-wise Kronecker (face-splitting) product: (n, p1*p2) with
    column index i1*p2 + i2."""
    n = A.shape[0]
    return (A[:, :, None] * B[:, None, :]).reshape(n, -1)


def _marginal_basis(label, x, k, bs, center):
    if bs in ("cr", "cs"):
        return CRSmooth(label, x, k, shrink=(bs == "cs"), center=center)
    if bs == "cc":
        return CCSmooth(label, x, k, center=center)
    if bs in ("tp", "ts"):
        return TPSmooth(label, x, k, shrink=(bs == "ts"), center=center)
    raise ValueError(
        f"tensor-product margins support bs='cr'/'cs'/'cc'/'tp'/'ts' "
        f"(got {bs!r})"
    )


def build_smooth(term, x, is_factor, levels=None, knots=None) -> SmoothBasis:
    """Construct the basis named by a SmoothTerm on covariate values x.

    knots: optional explicit knot locations for cr/cs/cc (sets the
    basis dimension and, for cc, the period — e.g. knots=[0, ..., 24]
    for a 24 h cycle; mgcv's gam(knots=...) passthrough, which the
    reference cannot forward, R/sde.R:396-398).
    """
    bs = term.bs
    label = term.label
    if bs == "re":
        return RESmooth(label, x, levels=levels)
    if is_factor:
        raise ValueError(
            f"smooth of factor {term.var!r} requires bs='re'"
        )
    if getattr(term, "tensor", None):
        if isinstance(term.k, tuple):
            k1, k2 = term.k  # per-margin k=(k1, k2)
        else:
            k1 = k2 = term.k if term.k > 0 else 5  # mgcv te default
        return TensorSmooth(label, x, k1, k2, bs=bs, mode=term.tensor)
    two_d = np.asarray(x).ndim == 2 and np.asarray(x).shape[1] == 2
    k = term.k if term.k > 0 else (30 if two_d else 10)  # mgcv defaults
    if bs in ("tp", "ts"):
        return TPSmooth(label, x, k, shrink=(bs == "ts"))
    if bs in ("cr", "cs"):
        return CRSmooth(label, x, k, shrink=(bs == "cs"), knots=knots)
    if bs == "cc":
        return CCSmooth(label, x, k, knots=knots)
    if bs == "bs":
        return BSSmooth(label, x, k)
    raise ValueError(f"unknown basis {bs!r}")
