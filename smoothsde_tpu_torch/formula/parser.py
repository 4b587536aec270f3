"""Mini formula language: R/mgcv-style strings -> term lists.

Supports the formula surface exercised by the reference's tests and
examples (reference tests/testthat/test_sde.R:7,60-61,
inst/example.R:19-20, inst/driver.R:63-64, vignettes/smoothSDE.rmd:285,
477-478):

    "~1"
    "~x"                                linear term
    "~state"                            factor term (dummy-coded)
    "~s(x1, k=5, bs='ts') + x2"         smooth + linear
    "~s(ID, bs='re')"                   iid random effect
    "~s(x2, by=x3)"                     by-variable smooth
    "~sin(2*pi*time/24) + x"            arbitrary numpy expressions

Terms are split on top-level '+'; each is either "1"/"0", an s(...) call
(parsed with the Python ast module), or an expression evaluated against
the data columns with numpy semantics (pi available, matching
R/utility.R:49-51).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SmoothTerm:
    """One s(...) smooth specification."""

    var: str
    k: object = -1  # int, or (k1, k2) for te/ti; -1 = default
    bs: str = "tp"
    by: Optional[str] = None
    m: int = 2  # penalty order (tp)
    label_override: Optional[str] = None
    var2: Optional[str] = None  # second covariate (2-d isotropic tp)
    tensor: Optional[str] = None  # "te"/"ti" for tensor-product smooths

    @property
    def label(self) -> str:
        if self.label_override:
            return self.label_override
        head = self.tensor or "s"
        if self.var2 is not None:
            return f"{head}({self.var},{self.var2})"
        return f"{head}({self.var})"


@dataclasses.dataclass(frozen=True)
class LinearTerm:
    """A parametric term: a column name or a numpy expression string."""

    expr: str

    @property
    def label(self) -> str:
        return self.expr


@dataclasses.dataclass(frozen=True)
class Formula:
    intercept: bool
    linear_terms: tuple
    smooth_terms: tuple
    source: str

    def variables(self) -> list:
        """All column names referenced (for covariate grids)."""
        out = []
        for t in self.linear_terms:
            tree = ast.parse(t.expr, mode="eval")
            called = {
                node.func.id
                for node in ast.walk(tree)
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            }
            for node in ast.walk(tree):
                if (
                    isinstance(node, ast.Name)
                    and node.id != "pi"
                    and node.id not in called
                ):
                    out.append(node.id)
        for s in self.smooth_terms:
            out.append(s.var)
            if s.var2 is not None:
                out.append(s.var2)
            if s.by is not None:
                out.append(s.by)
        seen, uniq = set(), []
        for v in out:
            if v not in seen:
                seen.add(v)
                uniq.append(v)
        return uniq


def _split_top_level(s: str, sep: str = "+") -> list:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


def _parse_smooth(term: str) -> SmoothTerm:
    tree = ast.parse(term, mode="eval").body
    fname = getattr(getattr(tree, "func", None), "id", None)
    if not (isinstance(tree, ast.Call) and fname in ("s", "te", "ti")):
        raise ValueError(f"not a smooth term: {term!r}")
    tensor = fname if fname in ("te", "ti") else None
    if (
        not 1 <= len(tree.args) <= 2
        or not all(isinstance(a, ast.Name) for a in tree.args)
    ):
        raise ValueError(
            f"{fname}() takes one or two covariate names (got {term!r})"
        )
    if tensor and len(tree.args) != 2:
        raise ValueError(f"{fname}() needs two covariates (got {term!r})")
    var = tree.args[0].id
    var2 = tree.args[1].id if len(tree.args) == 2 else None
    kw = {}
    for k in tree.keywords:
        if isinstance(k.value, ast.Constant):
            kw[k.arg] = k.value.value
        elif isinstance(k.value, ast.Name):
            kw[k.arg] = k.value.id  # e.g. by=x3 (bare name)
        elif (
            k.arg == "k"
            and isinstance(k.value, (ast.Tuple, ast.List))
            and all(isinstance(e, ast.Constant) for e in k.value.elts)
        ):
            kw[k.arg] = tuple(e.value for e in k.value.elts)  # k=(5, 8)
        else:
            raise ValueError(f"unsupported s() argument {k.arg!r} in {term!r}")
    bs = kw.get("bs", "cs" if tensor else "tp")
    if bs not in ("tp", "ts", "cr", "cs", "cc", "re", "bs"):
        raise ValueError(f"unsupported basis bs={bs!r} in {term!r}")
    if tensor:
        if bs not in ("tp", "ts", "cr", "cs", "cc"):
            raise ValueError(
                f"te/ti margins support bs='cr'/'cs'/'cc'/'tp'/'ts' "
                f"(got bs={bs!r} in {term!r})"
            )
    elif var2 is not None and bs not in ("tp", "ts"):
        raise ValueError(
            f"2-d s() smooths support bs='tp'/'ts' only (got bs={bs!r} in "
            f"{term!r}); use te()/ti() for anisotropic tensor products"
        )
    k_val = kw.get("k", -1)
    if isinstance(k_val, tuple):
        if not tensor or len(k_val) != 2:
            raise ValueError(
                f"per-margin k=(k1, k2) is only valid for te/ti with two "
                f"covariates (got {term!r})"
            )
        k_val = tuple(int(v) for v in k_val)
    else:
        k_val = int(k_val)
    return SmoothTerm(
        var=var,
        k=k_val,
        bs=bs,
        by=kw.get("by"),
        m=int(kw.get("m", 2)),
        var2=var2,
        tensor=tensor,
    )


def parse_formula(formula: str) -> Formula:
    """Parse "~ ..." (or the RHS alone) into a Formula."""
    src = formula.strip()
    rhs = src
    if "~" in rhs:
        rhs = rhs.split("~", 1)[1].strip()
    # Normalize R-style quoting: bs="ts" works via ast already.
    terms = _split_top_level(rhs)
    intercept = True
    linear, smooths = [], []
    for term in terms:
        if term == "1":
            continue
        if term in ("0", "-1"):
            intercept = False
            continue
        if (
            term.startswith(("s(", "te(", "ti("))
            or term.startswith(("s (", "te (", "ti ("))
        ):
            smooths.append(_parse_smooth(term))
        else:
            linear.append(LinearTerm(term))
    return Formula(
        intercept=intercept,
        linear_terms=tuple(linear),
        smooth_terms=tuple(smooths),
        source=src if src.startswith("~") else "~" + rhs,
    )
