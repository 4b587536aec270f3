"""utils/native.py and utils/cache.py of the port: the native host
pipeline against smoothsde_tpu.utils.native on tests/test_native.py's
inputs, results equal exactly, through the shared library (built on
demand, as test_native.py does) and through the NumPy fallbacks; and
`enable_compilation_cache`'s directory.
"""

import os
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (one PyTorch thread a process)

from smoothsde_tpu.utils import native as jax_native
from smoothsde_tpu_torch import enable_compilation_cache
from smoothsde_tpu_torch.ops import _kernels
from smoothsde_tpu_torch.parallel.batching import PackedTracks, pack_tracks
from smoothsde_tpu_torch.utils import native

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)


@pytest.fixture(scope="module", autouse=True)
def _ensure_native_built():
    so = os.path.join(_NATIVE_DIR, "libsmoothsde_native.so")
    if not os.path.exists(so) and shutil.which("make"):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=False,
                       capture_output=True)
    native.reset()
    jax_native.reset()


@pytest.fixture(params=["native", "numpy"])
def route(request, monkeypatch):
    """Both packages on the shared library, or both on the fallbacks."""
    if request.param == "native":
        if not native.native_available():
            pytest.skip("native library not built")
    else:
        for mod in (native, jax_native):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_LIB_TRIED", True)
    assert native.native_available() == jax_native.native_available()
    return request.param


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("data") / "tracks.csv"
    p.write_text(
        "ID,time,x,y\n"
        "b,0.0,1.5,2.5\n"
        "b,1.0,NA,3.5\n"
        "a,0.0,0.1,0.2\n"
        "a,0.5,0.3,\n"
        "a,1.5,0.5,0.6\n"
    )
    return str(p)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype.kind == "f":
        assert np.array_equal(a, b, equal_nan=True)
    else:
        assert np.array_equal(a, b)


def test_read_csv(route, csv_file):
    got, want = native.read_csv(csv_file), jax_native.read_csv(csv_file)
    assert list(got) == list(want)
    for k in want:
        _equal(got[k], want[k])
    assert got["__ID_codes__"].tolist() == [1, 1, 0, 0, 0]


def test_track_segments(route):
    ids = np.array([0, 0, 1, 1, 1, 2])
    for g, w in zip(native.track_segments(ids),
                    jax_native.track_segments(ids)):
        _equal(g, w)


def _tracks():
    rng = np.random.default_rng(0)
    n = 300
    ids = np.sort(rng.integers(0, 4, size=n))
    times = np.cumsum(rng.uniform(0.1, 1.0, size=n))
    obs = rng.normal(size=(n, 2))
    return obs, times, ids


def test_pack_tracks(route):
    obs, times, ids = _tracks()
    got = native.pack_tracks_native(obs, times, ids, pad_multiple=32)
    want = jax_native.pack_tracks_native(obs, times, ids, pad_multiple=32)
    for g, w in zip(got, want):
        _equal(g, w)
    packed = native.pack_tracks_native(obs, times, ids, pad_multiple=32,
                                       device="cpu")
    ref = pack_tracks(obs, times, ids, pad_multiple=32, device="cpu")
    assert isinstance(packed, PackedTracks)
    for g, w in zip(packed, ref):
        assert torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))


def test_cr_design(route):
    from smoothsde_tpu_torch.formula.smooths import CRSmooth

    rng = np.random.default_rng(1)
    x = rng.uniform(0, 5, 200)
    st = CRSmooth("s(x)", x, k=8)._state
    x_new = np.concatenate([x, [-1.0, 6.0]])
    _equal(native.cr_design_native(x_new, st.knots, st.F),
           jax_native.cr_design_native(x_new, st.knots, st.F))


def test_enable_compilation_cache(tmp_path):
    try:
        got = enable_compilation_cache(str(tmp_path / "kernels"))
        assert got == str((tmp_path / "kernels").resolve())
        assert _kernels._BUILD_ROOT == tmp_path / "kernels"
        default = enable_compilation_cache()
        assert default == str(_kernels.DEFAULT_BUILD_ROOT)
        assert default.endswith(os.path.join("build", "smoothsde_tpu_torch"))
    finally:
        enable_compilation_cache()
    assert _kernels._BUILD_ROOT == _kernels.DEFAULT_BUILD_ROOT
