"""Design-matrix assembly: formulas + data -> X_fe, X_re, penalty blocks.

Equivalent of the reference's make_mat (reference R/sde.R:378-455)
without mgcv: each SDE-parameter formula yields a parametric block
(intercept, linear/factor terms -> X_fe) and penalized smooth blocks
(-> X_re with one penalty per smooth), stacked block-diagonally across
parameters so the joint linear predictor is a single matrix product.

The FE/RE split follows mgcv's nsdf convention: strictly parametric
columns are fixed effects; every smooth basis column is penalized
(reference R/sde.R:412-421). Shape contract pinned by the reference's
test (test_sde.R:53-72): s(x, k=5, bs='ts') contributes 4 columns,
s(ID, bs='re') contributes nlevels columns, one lambda per smooth.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from smoothsde_tpu_torch.formula.parser import Formula, parse_formula
from smoothsde_tpu_torch.formula.smooths import SmoothBasis, build_smooth

_NUMPY_FUNCS = {
    name: getattr(np, name)
    for name in (
        "sin", "cos", "tan", "exp", "log", "log2", "log10", "sqrt",
        "abs", "floor", "ceil", "tanh", "arctan", "arcsin", "arccos",
        "minimum", "maximum",
    )
}


class ColumnData:
    """Uniform accessor over pandas DataFrames / dicts of arrays.

    Factor semantics follow R's factor(): levels are the sorted unique
    values unless the input is a pandas Categorical with explicit
    categories (reference coerces ID with factor(), R/sde.R:117).
    """

    def __init__(self, data):
        try:
            import pandas as pd

            if isinstance(data, pd.DataFrame):
                self._cols = {c: data[c] for c in data.columns}
                self._pandas = True
                self._n = len(data)
                return
        except ImportError:  # pragma: no cover
            pass
        if not isinstance(data, dict):
            raise TypeError(
                "data must be a pandas DataFrame or a dict of arrays"
            )
        self._cols = {k: np.asarray(v) for k, v in data.items()}
        self._pandas = False
        lens = {len(v) for v in self._cols.values()}
        if len(lens) > 1:
            raise ValueError("data columns have unequal lengths")
        self._n = lens.pop() if lens else 0

    @property
    def n(self) -> int:
        return self._n

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __contains__(self, name) -> bool:
        return name in self._cols

    def raw(self, name) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(f"column {name!r} not found in data")
        return np.asarray(self._cols[name])

    def is_factor(self, name) -> bool:
        col = self._cols[name]
        if self._pandas:
            import pandas as pd

            if isinstance(col.dtype, pd.CategoricalDtype):
                return True
            col = np.asarray(col)
        return np.asarray(col).dtype.kind in ("O", "U", "S", "b")

    def levels(self, name) -> List:
        col = self._cols[name]
        if self._pandas:
            import pandas as pd

            if isinstance(col.dtype, pd.CategoricalDtype):
                return list(col.cat.categories)
        vals = np.asarray(col)
        return sorted(set(vals.tolist()))

    def numeric(self, name) -> np.ndarray:
        return np.asarray(self.raw(name), dtype=float)


def _eval_expr(expr: str, data: ColumnData) -> np.ndarray:
    """Evaluate a numeric term expression against the data columns with
    numpy semantics; `pi` is available (cf. R/utility.R:49-51)."""
    ns = dict(_NUMPY_FUNCS)
    ns["pi"] = np.pi
    import ast

    tree = ast.parse(expr, mode="eval")
    for node in ast.walk(tree):
        if isinstance(node, ast.Name) and node.id not in ns:
            ns[node.id] = data.numeric(node.id)
    out = eval(compile(tree, "<formula>", "eval"), {"__builtins__": {}}, ns)
    out = np.asarray(out, dtype=float)
    if out.ndim == 0:
        out = np.full(data.n, float(out))
    return out


@dataclasses.dataclass
class _FactorInfo:
    name: str
    levels: List


@dataclasses.dataclass
class SmoothBlock:
    """One penalized block: a smooth (or one level of a factor-by)."""

    label: str  # e.g. "s(x1)", "s(x2):x3b"
    basis: SmoothBasis
    by: Optional[str] = None
    by_level: Optional[object] = None  # factor-by level, None for numeric
    col_names: List[str] = dataclasses.field(default_factory=list)
    vars: Optional[List[str]] = None  # covariate columns of the basis


class FormulaDesign:
    """Design builder for one SDE parameter's formula.

    knots: optional {covariate: knot locations} passed to cr/cs/cc
    bases (sets the cc period).
    """

    def __init__(self, formula, data: ColumnData, knots=None):
        self._knots = dict(knots or {})
        if isinstance(formula, str):
            formula = parse_formula(formula)
        self.formula: Formula = formula
        self._factors: Dict[str, _FactorInfo] = {}

        # ---- parametric part (X_fe) ----
        fe_cols, fe_names, fe_terms = [], [], []
        if formula.intercept:
            fe_cols.append(np.ones(data.n))
            fe_names.append("(Intercept)")
            fe_terms.append("(Intercept)")
        for term in formula.linear_terms:
            expr = term.expr
            if expr in data.columns and data.is_factor(expr):
                levels = data.levels(expr)
                self._factors[expr] = _FactorInfo(expr, levels)
                vals = data.raw(expr)
                # treatment contrasts: drop first level (R default)
                for lv in levels[1:]:
                    fe_cols.append((vals == lv).astype(float))
                    fe_names.append(f"{expr}{lv}")
                    fe_terms.append(expr)
            else:
                fe_cols.append(_eval_expr(expr, data))
                fe_names.append(expr)
                fe_terms.append(expr)
        self.X_fe = (
            np.column_stack(fe_cols) if fe_cols else np.zeros((data.n, 0))
        )
        self.names_fe = fe_names
        # structured term label per FE column (the generating formula
        # term: "(Intercept)", an expression, or the factor name) —
        # replaces the reference's substring matching on coefficient
        # names (utility.R:137-144, SURVEY "What NOT to carry over")
        self.fe_term_labels = fe_terms

        # ---- smooth part (X_re) ----
        self.blocks: List[SmoothBlock] = []
        self._smooth_specs = []
        for sm in formula.smooth_terms:
            is_factor = sm.var in data.columns and data.is_factor(sm.var)
            sm_vars = [sm.var] if sm.var2 is None else [sm.var, sm.var2]
            if sm.var2 is not None:
                xvals = np.column_stack(
                    [data.numeric(sm.var), data.numeric(sm.var2)]
                )
            elif is_factor:
                xvals = data.raw(sm.var)
            else:
                xvals = data.numeric(sm.var)
            base = build_smooth(
                sm, xvals, is_factor,
                levels=data.levels(sm.var) if is_factor else None,
                knots=self._knots.get(sm.var),
            )
            if sm.by is not None and data.is_factor(sm.by):
                # factor by: one centered copy of the smooth per level,
                # each with its own penalty (mgcv behavior; example.R:20)
                for lv in data.levels(sm.by):
                    label = f"{base.label}:{sm.by}{lv}"
                    blk = SmoothBlock(
                        label=label,
                        basis=base,
                        by=sm.by,
                        by_level=lv,
                        col_names=[
                            f"{label}.{i + 1}" for i in range(base.X.shape[1])
                        ],
                        vars=sm_vars,
                    )
                    self.blocks.append(blk)
            else:
                label = base.label if sm.by is None else f"{base.label}:{sm.by}"
                blk = SmoothBlock(
                    label=label,
                    basis=base,
                    by=sm.by,
                    by_level=None,
                    col_names=[
                        f"{label}.{i + 1}" for i in range(base.X.shape[1])
                    ],
                    vars=sm_vars,
                )
                self.blocks.append(blk)

        self.X_re = self._smooth_matrix(data)
        self.names_re = [n for blk in self.blocks for n in blk.col_names]
        self.S_blocks = [blk.basis.S for blk in self.blocks]
        # one GROUP per block; a group's matrices share the block's
        # coefficients with one lambda each (tensor smooths have two)
        self.S_groups = [list(blk.basis.S_list) for blk in self.blocks]
        self.smooth_labels = [blk.label for blk in self.blocks]

    # -- evaluation ---------------------------------------------------------

    def _smooth_matrix(self, data: ColumnData) -> np.ndarray:
        cols = []
        for blk in self.blocks:
            sm_vars = blk.vars if blk.vars else [_basis_var(blk)]
            if len(sm_vars) == 2:
                x = np.column_stack(
                    [data.numeric(v) for v in sm_vars]
                )
            elif isinstance(blk.basis, _RE_TYPES):
                x = data.raw(sm_vars[0])
            else:
                x = data.numeric(sm_vars[0])
            X = blk.basis.eval(x)
            if blk.by is not None:
                if blk.by_level is not None:
                    ind = (data.raw(blk.by) == blk.by_level).astype(float)
                    X = X * ind[:, None]
                else:
                    X = X * data.numeric(blk.by)[:, None]
            cols.append(X)
        if not cols:
            return np.zeros((data.n, 0))
        return np.column_stack(cols)

    def eval(self, data: ColumnData):
        """Design matrices for new data (prediction path,
        R/sde.R:404-408)."""
        fe_cols = []
        if self.formula.intercept:
            fe_cols.append(np.ones(data.n))
        for term in self.formula.linear_terms:
            expr = term.expr
            if expr in self._factors:
                info = self._factors[expr]
                vals = data.raw(expr)
                for lv in info.levels[1:]:
                    fe_cols.append((vals == lv).astype(float))
            else:
                fe_cols.append(_eval_expr(expr, data))
        X_fe = np.column_stack(fe_cols) if fe_cols else np.zeros((data.n, 0))
        return X_fe, self._smooth_matrix(data)


def _basis_var(blk: SmoothBlock) -> str:
    # "s(x1)" or "s(x1):by..." -> x1
    lab = blk.basis.label
    return lab[lab.index("(") + 1 : lab.index(")")]


from smoothsde_tpu_torch.formula.smooths import RESmooth  # noqa: E402

_RE_TYPES = (RESmooth,)


@dataclasses.dataclass
class DesignMatrices:
    """Joint design across all SDE parameters (block-diagonal stacking,
    R/sde.R:443-447)."""

    param_names: List[str]
    per_param: Dict[str, FormulaDesign]
    n: int

    @property
    def ncol_fe(self) -> List[int]:
        return [self.per_param[p].X_fe.shape[1] for p in self.param_names]

    @property
    def ncol_re(self) -> List[int]:
        return [
            S.shape[0]
            for p in self.param_names
            for S in self.per_param[p].S_blocks
        ]

    @property
    def ncol_re_names(self) -> List[str]:
        return [
            f"{p}.{lab}"
            for p in self.param_names
            for lab in self.per_param[p].smooth_labels
        ]

    @property
    def names_fe(self) -> List[str]:
        return [
            f"{p}.{n}"
            for p in self.param_names
            for n in self.per_param[p].names_fe
        ]

    @property
    def names_re(self) -> List[str]:
        return [
            f"{p}.{n}"
            for p in self.param_names
            for n in self.per_param[p].names_re
        ]

    @property
    def fe_col_terms(self) -> List[tuple]:
        """(param, term_label) per FE column — structured metadata for
        term subsetting (replaces substring matching on names)."""
        return [
            (p, lab)
            for p in self.param_names
            for lab in self.per_param[p].fe_term_labels
        ]

    @property
    def re_col_terms(self) -> List[tuple]:
        """(param, block_label) per RE column."""
        return [
            (p, blk.label)
            for p in self.param_names
            for blk in self.per_param[p].blocks
            for _ in blk.col_names
        ]

    @property
    def S_blocks(self) -> List[np.ndarray]:
        return [
            S for p in self.param_names for S in self.per_param[p].S_blocks
        ]

    @property
    def S_groups(self) -> List[List[np.ndarray]]:
        """Penalty groups: one per smooth block, each a list of penalty
        matrices over that block's coefficients (len > 1 for tensor
        smooths). The lambda vector has one entry per matrix, in this
        flattened order."""
        return [
            g for p in self.param_names for g in self.per_param[p].S_groups
        ]

    @property
    def n_lambda(self) -> int:
        return sum(len(g) for g in self.S_groups)

    @property
    def lambda_labels(self) -> List[str]:
        out = []
        for p in self.param_names:
            fd = self.per_param[p]
            for lab, grp in zip(fd.smooth_labels, fd.S_groups):
                if len(grp) == 1:
                    out.append(f"{p}.{lab}")
                else:
                    out.extend(
                        f"{p}.{lab}[m{j + 1}]" for j in range(len(grp))
                    )
        return out

    def fe_blocks(self) -> List[np.ndarray]:
        return [self.per_param[p].X_fe for p in self.param_names]

    def re_blocks(self) -> List[np.ndarray]:
        return [self.per_param[p].X_re for p in self.param_names]

    def re_gather_plans(self, min_cols: int = 16):
        """Per-parameter sparse plan for wide random-effect blocks.

        An `s(ID, bs='re')` block is a one-hot indicator matrix (times
        an optional `by` weight), so `X_block @ c` is a gather
        `w * c[idx]` — O(n) instead of the O(n * n_levels) dense
        matvec, and TPU-native (indexed gather fuses into the
        surrounding elementwise ops; CSR is a poor fit for the MXU).
        The reference reaches the same goal through sparse Eigen
        matrices inside TMB (DATA_SPARSE_MATRIX, nllk_sde.hpp:28-30).

        Returns one entry per parameter: None (keep the dense matvec)
        or (dense_idx, X_dense, gathers) with gathers a list of
        (start, k, idx, w or None); only parameters whose combined RE
        indicator width is >= min_cols get a plan.
        """
        plans = []
        for p in self.param_names:
            fd = self.per_param[p]
            X = fd.X_re
            offs = np.concatenate(
                [[0], np.cumsum([b.basis.X.shape[1] for b in fd.blocks])]
            ).astype(int)
            gathers, gather_cols = [], []
            for b, blk in enumerate(fd.blocks):
                if not isinstance(blk.basis, _RE_TYPES):
                    continue
                s, e = offs[b], offs[b + 1]
                sub = X[:, s:e]
                # one nonzero per row by construction; idx/weight
                # recover the level index and any by-modulation
                idx = np.argmax(sub != 0.0, axis=1)
                w = sub[np.arange(sub.shape[0]), idx]
                gathers.append(
                    (int(s), int(e - s), idx.astype(np.int32),
                     None if np.all(w == 1.0) else w)
                )
                gather_cols.extend(range(s, e))
            if not gathers or len(gather_cols) < min_cols:
                plans.append(None)
                continue
            dense_idx = np.array(
                [c for c in range(X.shape[1]) if c not in set(gather_cols)],
                int,
            )
            plans.append((dense_idx, X[:, dense_idx], gathers))
        return plans

    def stacked_X_fe(self) -> np.ndarray:
        return _block_diag(self.fe_blocks())

    def stacked_X_re(self) -> np.ndarray:
        return _block_diag(self.re_blocks())

    def stacked_S(self) -> np.ndarray:
        return _block_diag(self.S_blocks) if self.S_blocks else np.zeros((0, 0))

    def eval(self, data: ColumnData) -> "DesignEval":
        fe, re = [], []
        for p in self.param_names:
            X_fe, X_re = self.per_param[p].eval(data)
            fe.append(X_fe)
            re.append(X_re)
        return DesignEval(fe, re, data.n)


@dataclasses.dataclass
class DesignEval:
    """Evaluated design blocks for a (possibly new) data set."""

    fe_blocks: List[np.ndarray]
    re_blocks: List[np.ndarray]
    n: int

    def stacked_X_fe(self) -> np.ndarray:
        return _block_diag(self.fe_blocks)

    def stacked_X_re(self) -> np.ndarray:
        return _block_diag(self.re_blocks)


def _block_diag(blocks: List[np.ndarray]) -> np.ndarray:
    rows = sum(b.shape[0] for b in blocks)
    cols = sum(b.shape[1] for b in blocks)
    out = np.zeros((rows, cols))
    r = c = 0
    for b in blocks:
        out[r : r + b.shape[0], c : c + b.shape[1]] = b
        r += b.shape[0]
        c += b.shape[1]
    return out


def build_design(formulas: Dict[str, object], data, knots=None) -> DesignMatrices:
    """Build the joint design for an ordered dict of parameter formulas.

    knots: optional {covariate: knot locations} for cr/cs/cc bases.
    """
    cdata = data if isinstance(data, ColumnData) else ColumnData(data)
    per_param = {
        name: FormulaDesign(form, cdata, knots=knots)
        for name, form in formulas.items()
    }
    return DesignMatrices(
        param_names=list(formulas), per_param=per_param, n=cdata.n
    )
