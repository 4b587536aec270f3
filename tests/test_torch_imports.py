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


def test_parallel_modules_load_neither_jax_nor_the_jax_package():
    _load_in_fresh_interpreter(PARALLEL)


# the multi-process mesh's collectives, the fit's timers and trace, the
# native host pipeline and the kernel library's directory
TAIL = ("parallel/collectives.py", "utils/profiling.py", "utils/native.py",
        "utils/cache.py")


@pytest.mark.parametrize("rel", TAIL)
def test_tail_modules_are_guarded(rel):
    assert PKG / rel in FILES


def test_tail_modules_load_neither_jax_nor_the_jax_package():
    _load_in_fresh_interpreter(TAIL)


# Every top-level def / class of the JAX package has a counterpart in the
# port under its own name, or under the name given here (the JAX tiling,
# interpret and element helpers the port has on purpose in another
# form), or is one of the JAX-only internals ROADMAP.md's "Do not port"
# lists with its reason.
OTHER_NAMES = {
    "LaplaceConfig": "infer/laplace.py _MAX_ITER, _TOL, _RIDGE",
    "_BwdParTiles": "ops/ctcrw_fused.py Plan, stack_rows",
    "_BwdTiles": "ops/ctcrw_fused.py Plan, stack_rows",
    "_ParStack": "ops/ctcrw_fused.py build_par_stack",
    "_Row": "ops/ctcrw_fused.py stack_rows",
    "_Tiles": "ops/ctcrw_fused.py Plan",
    "_Tiles1": "ops/ctcrw_fused.py Plan",
    "_plan": "ops/ctcrw_fused.py plan",
    "_stack_tiles": "ops/ctcrw_fused.py stack_rows",
    "_unstack_tiles": "ops/ctcrw_fused.py unstack",
    "_interpret": "ops/ctcrw_fused.py OPS['plain'] (the plain versions)",
    "_block_prefix_pallas": "ops/ctcrw_fused.py block_prefix (K2)",
    "_elem_from_inputs": "ops/ctcrw_fused.py _elem_from_vals",
    "_par_terms": "ops/ctcrw_fused.py _par_terms_vals",
    "_smooth_elem": "ops/ctcrw_fused.py _smooth_elem_vals",
    "_smooth_elem_par": "ops/ctcrw_fused.py _par_smooth_elem",
    "_diag_fwd": "ops/diag_fused.py diag_fwd",
    "_diag_bwd": "ops/diag_fused.py diag_bwd",
    "_fused_par_core": "ops/kalman_soa.py _make_core (CtcrwFusedCore)",
    "_llk2_fused_par": "ops/kalman_soa.py ctcrw_loglik_soa",
    "_flip": "ops/kalman_smooth.py torch.flip",
    "_build_sharded_soa_loglik": "parallel/dist.py build_sharded_loglik",
    "_mesh_on_tpu": "parallel/dist.py _ops_name",
    "_CsvResult": "utils/native.py _csv_result_type",
    "xla_trace": "utils/profiling.py trace",
}
JAX_ONLY = {
    "aot_cached", "guard_first_call", "_export_backend_ok", "_aot_dir",
    "source_digest", "maybe_enable_default_cache", "_content_token",
    "_no_persistent_cache", "_fused_par_core_elem", "device_float",
    "device_int", "_full_precision",
}


def _top_level_names(root):
    names = set()
    for path in root.rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
    return names


def test_every_jax_name_has_a_counterpart():
    jax_pkg = PKG.parent / "smoothsde_tpu"
    missing = _top_level_names(jax_pkg) - _top_level_names(PKG)
    assert missing == set(OTHER_NAMES) | JAX_ONLY
    roadmap = (PKG.parent / "ROADMAP.md").read_text()
    for name in JAX_ONLY:
        assert f"`{name}`" in roadmap, name


def test_exports_equal_the_jax_packages():
    import subprocess
    import sys

    code = ("import smoothsde_tpu as j, smoothsde_tpu_torch as t\n"
            "assert sorted(j.__all__) == sorted(t.__all__)\n"
            "for name in t.__all__:\n"
            "    getattr(t, name)\n")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=str(PKG.parent))
