"""Import guard for the PyTorch port: no module of smoothsde_tpu_torch
imports jax or the JAX package, and none imports triton or a compiled
extension at module level (those load inside the function that launches
a kernel, so the CPU tests can import every module)."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1] / "smoothsde_tpu_torch"
FILES = sorted(PKG.rglob("*.py"))
# modules that may only be imported inside functions
LAZY_ONLY = ("triton", "ctypes", "torch.utils.cpp_extension",
             "smoothsde_tpu_torch.ops._kernels")


def _imports(tree):
    """(module name, is_module_level) for every import in the tree."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            yield name, id(node) in top


def test_package_has_modules():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_lazy_extensions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top in _imports(tree):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib"), f"{path}: imports {name}"
        assert root != "smoothsde_tpu", f"{path}: imports {name}"
        if top and path.name != "_kernels.py":
            for lazy in LAZY_ONLY:
                assert not (name == lazy or name.startswith(lazy + ".")), (
                    f"{path}: module-level import of {name}"
                )


# the API tail's modules: NumPy copies of the JAX package's (grids,
# simulate, plots) and the device optimizer
API_TAIL = ("utils/grids.py", "api/simulate.py", "api/plots.py",
            "infer/lbfgs.py")


@pytest.mark.parametrize("rel", API_TAIL)
def test_api_tail_modules_are_guarded(rel):
    assert PKG / rel in FILES


def _load_in_fresh_interpreter(rels):
    """Import the modules (and the SDE that uses them) in a fresh
    interpreter; fail if any module of jax, jaxlib or smoothsde_tpu got
    loaded."""
    import subprocess
    import sys

    mods = ["smoothsde_tpu_torch." + r[:-3].replace("/", ".")
            for r in rels] + ["smoothsde_tpu_torch.api.sde"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "roots = ('jax', 'jaxlib', 'smoothsde_tpu')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(PKG.parent))


def test_api_tail_modules_load_neither_jax_nor_the_jax_package():
    _load_in_fresh_interpreter(API_TAIL)


# the generic and special filters: the full-state and parallel filters,
# the square-root filter, the full-state step builders, the objective
FILTERS = ("ops/kalman.py", "ops/kalman_sqrt.py", "models/ssm.py",
           "infer/objective.py")


@pytest.mark.parametrize("rel", FILTERS)
def test_filter_modules_are_guarded(rel):
    assert PKG / rel in FILES


def test_filter_modules_load_neither_jax_nor_the_jax_package():
    _load_in_fresh_interpreter(FILTERS)


# the sharding modules (a single-controller mesh of torch devices, no jax)
PARALLEL = ("parallel/batching.py", "parallel/dist.py",
            "parallel/time_scan.py")


@pytest.mark.parametrize("rel", PARALLEL)
def test_parallel_modules_are_guarded(rel):
    assert PKG / rel in FILES
