"""ctypes bindings for the native host runtime (native/smoothsde_native.cpp).

Port of smoothsde_tpu/utils/native.py: the host-side data pipeline, fast
CSV ingestion with R-style ID factor coding, track segmentation, padded
batch packing and cr-basis design evaluation, from the shared library
that `make -C native` builds at the root of the checkout
(native/libsmoothsde_native.so), with the JAX package's pure-NumPy
fallbacks when it has not been built. `native_available()` says which
route runs. Host code either way: no device and no kernel is involved,
except that `pack_tracks_native(..., device=)` hands the padded batch to
the port as a parallel/batching.PackedTracks on that device. ctypes is
imported inside the functions that use it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_LIB = None
_LIB_TRIED = False
_CSV = None


def _csv_result_type():
    """The C struct smoothsde_read_csv fills (the JAX package's
    `_CsvResult`), made once."""
    global _CSV
    if _CSV is None:
        import ctypes

        class _CsvResult(ctypes.Structure):
            _fields_ = [
                ("n_rows", ctypes.c_int64),
                ("n_cols", ctypes.c_int64),
                ("values", ctypes.POINTER(ctypes.c_double)),
                ("id_codes", ctypes.POINTER(ctypes.c_int64)),
                ("n_levels", ctypes.c_int64),
                # raw pointers (NOT c_char_p: ctypes would convert to bytes
                # and smoothsde_free would then free Python's own buffer)
                ("header", ctypes.c_void_p),
                ("levels", ctypes.c_void_p),
            ]

        _CSV = _CsvResult
    return _CSV


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "native",
        "libsmoothsde_native.so",
    )
    if not os.path.exists(path):
        return None
    import ctypes

    i64p, f64p = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(
        ctypes.c_double)
    lib = ctypes.CDLL(path)
    lib.smoothsde_read_csv.restype = ctypes.c_int
    lib.smoothsde_read_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_char, ctypes.c_char_p,
        ctypes.POINTER(_csv_result_type()),
    ]
    lib.smoothsde_track_segments.restype = ctypes.c_int64
    lib.smoothsde_track_segments.argtypes = [i64p, ctypes.c_int64, i64p,
                                             i64p]
    lib.smoothsde_pack_tracks.restype = None
    lib.smoothsde_pack_tracks.argtypes = [
        f64p, f64p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, f64p, f64p,
    ]
    lib.smoothsde_cr_design.restype = None
    lib.smoothsde_cr_design.argtypes = [f64p, ctypes.c_int64, f64p,
                                        ctypes.c_int64, f64p, f64p]
    lib.smoothsde_free.restype = None
    lib.smoothsde_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def reset() -> None:
    """Forget a cached load failure (after building the .so
    mid-process, e.g. a test's on-demand `make -C native`)."""
    global _LIB, _LIB_TRIED
    _LIB = None
    _LIB_TRIED = False


def _dptr(a):
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    import ctypes

    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def read_csv(path: str, delim: str = ",", id_col: Optional[str] = "ID"):
    """Load a delimited file into a dict of columns.

    Numeric columns become float64 arrays ("NA"/empty -> NaN); `id_col`
    (if present) becomes an object array of its level strings plus
    integer codes under the same semantics as the SDE constructor.
    Uses the native loader when built, else a numpy fallback.
    """
    import ctypes

    lib = _load()
    if lib is None:
        return _read_csv_numpy(path, delim, id_col)
    res = _csv_result_type()()
    rc = lib.smoothsde_read_csv(
        path.encode(), delim.encode(), id_col.encode() if id_col else None,
        ctypes.byref(res),
    )
    if rc != 0:
        raise IOError(f"native CSV read of {path!r} failed (code {rc})")
    n, m = res.n_rows, res.n_cols
    vals = np.ctypeslib.as_array(res.values, shape=(n, m)).copy()
    names = (
        ctypes.string_at(res.header).decode().split("\n")
        if res.header
        else []
    )
    out = {nm: vals[:, i] for i, nm in enumerate(names)}
    if res.id_codes:
        codes = np.ctypeslib.as_array(res.id_codes, shape=(n,)).copy()
        levels = ctypes.string_at(res.levels).decode().split("\n")
        out[id_col] = np.array([levels[c] for c in codes], dtype=object)
        out[f"__{id_col}_codes__"] = codes
    lib.smoothsde_free(res.values)
    if res.id_codes:
        lib.smoothsde_free(res.id_codes)
    if res.header:
        lib.smoothsde_free(res.header)
    if res.levels:
        lib.smoothsde_free(res.levels)
    return out


def _read_csv_numpy(path, delim, id_col):
    import csv

    with open(path) as f:
        reader = csv.reader(f, delimiter=delim)
        header = next(reader)
        rows = [r for r in reader if r]
    out = {}
    for i, name in enumerate(header):
        col = [r[i] if i < len(r) else "" for r in rows]
        if id_col is not None and name == id_col:
            levels = sorted(set(col))
            code = {lv: j for j, lv in enumerate(levels)}
            out[name] = np.array(col, dtype=object)
            out[f"__{id_col}_codes__"] = np.array([code[v] for v in col])
        else:
            def conv(v):
                v = v.strip().strip('"')
                if v in ("", "NA", "NaN", "nan"):
                    return np.nan
                try:
                    return float(v)
                except ValueError:
                    return np.nan
            out[name] = np.array([conv(v) for v in col])
    return out


def track_segments(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, lengths) of consecutive equal-ID runs."""
    ids = np.ascontiguousarray(np.asarray(ids, np.int64))
    lib = _load()
    if lib is None:
        n = len(ids)
        breaks = np.where(ids[1:] != ids[:-1])[0]
        starts = np.concatenate([[0], breaks + 1]).astype(np.int64)
        ends = np.concatenate([breaks + 1, [n]]).astype(np.int64)
        return starts, ends - starts
    starts = np.empty(len(ids), np.int64)
    lengths = np.empty(len(ids), np.int64)
    k = lib.smoothsde_track_segments(
        _iptr(ids), len(ids), _iptr(starts), _iptr(lengths)
    )
    return starts[:k].copy(), lengths[:k].copy()


def pack_tracks_native(
    obs: np.ndarray, times: np.ndarray, ids: np.ndarray,
    pad_multiple: int = 128, *, device=None, dtype=None,
):
    """Padded (K, L, d) observation and (K, L) time batches and the (K,)
    lengths (semantics of parallel/batching.py::pack_tracks), as NumPy
    arrays; with `device`, the port's PackedTracks on that device (in
    `dtype`, float64 if None)."""
    obs = np.ascontiguousarray(np.asarray(obs, np.float64))
    times = np.ascontiguousarray(np.asarray(times, np.float64))
    starts, lengths = track_segments(ids)
    K = len(starts)
    L = int(-(-lengths.max() // pad_multiple) * pad_multiple)
    d = obs.shape[1]
    lib = _load()
    if lib is None:
        obs_p = np.full((K, L, d), np.nan)
        t_p = np.zeros((K, L))
        for k in range(K):
            s, ln = starts[k], lengths[k]
            obs_p[k, :ln] = obs[s : s + ln]
            t_p[k, :ln] = times[s : s + ln]
            t_p[k, ln:] = times[s + ln - 1] + 1.0 + np.arange(L - ln)
    else:
        obs_p = np.empty((K, L, d), np.float64)
        t_p = np.empty((K, L), np.float64)
        lib.smoothsde_pack_tracks(
            _dptr(obs), _dptr(times), _iptr(starts), _iptr(lengths),
            K, L, d, _dptr(obs_p), _dptr(t_p),
        )
    if device is None:
        return obs_p, t_p, lengths
    import torch

    from smoothsde_tpu_torch.parallel.batching import PackedTracks

    dtype = torch.float64 if dtype is None else dtype
    return PackedTracks(
        torch.as_tensor(obs_p, dtype=dtype, device=device),
        torch.as_tensor(t_p, dtype=dtype, device=device),
        torch.as_tensor(lengths, device=device),
    )


def cr_design_native(x, knots, F) -> np.ndarray:
    """Native cr-basis design evaluation; numpy fallback via
    formula.smooths._cr_design."""
    lib = _load()
    if lib is None:
        from smoothsde_tpu_torch.formula.smooths import _cr_design

        return _cr_design(np.asarray(x, float), np.asarray(knots),
                          np.asarray(F))
    x = np.ascontiguousarray(np.asarray(x, np.float64))
    knots = np.ascontiguousarray(np.asarray(knots, np.float64))
    F = np.ascontiguousarray(np.asarray(F, np.float64))
    k = len(knots)
    out = np.empty((len(x), k), np.float64)
    lib.smoothsde_cr_design(
        _dptr(x), len(x), _dptr(knots), k, _dptr(F), _dptr(out)
    )
    return out
