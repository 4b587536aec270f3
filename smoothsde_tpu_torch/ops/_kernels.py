"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

At first use each source is compiled by its own nvcc, all started
together, and the objects are linked into one shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <tmp>/<name>.o csrc/<name>.cu   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o <build>/libssde_kernels.so <tmp>/*.o

The library lands in build/smoothsde_tpu_torch/<hash>/ at the root of
the checkout (or under the directory given to
utils/cache.enable_compilation_cache), keyed by a hash of the sources
and flags, so a changed source rebuilds and an unchanged one is reused.
Every C entry point takes device pointers, scalars and the CUDA stream,
launches on that stream without synchronising, and returns
cudaGetLastError() of its launches; `launch` raises on a non-zero code. A few entry points take
nothing and return a constant of the kernels' geometry (`constant`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
_CSRC = _PKG / "csrc"
DEFAULT_BUILD_ROOT = _PKG.parent / "build" / "smoothsde_tpu_torch"
# re-pointed by utils/cache.enable_compilation_cache
_BUILD_ROOT = DEFAULT_BUILD_ROOT
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

# C argument kinds after the entry-point name: p = device pointer,
# d = double, i = int. Every entry point ends with the stream (p) and
# returns an int (cudaError_t).
_SIGNATURES = {
    # stack, bd, h, p0_pos, p0_vel, totals, L, lanes
    "ctcrw_filter_totals": "pppddpii",
    # stack, bd, prefix, h, p0_pos, p0_vel, moments, llk, L, lanes
    "ctcrw_filter_scan": "ppppddppii",
    # totals, out, tiles (scratch), d, NB, ntiles, reverse
    "block_prefix_filter": "pppiiii",
    "block_prefix_smooth": "pppiiii",
    # stack, moments, totals, rows, L, lanes
    "ctcrw_smooth_totals": "pppiii",
    # stack, moments, suffix, h, p0_pos, cot, hbar, rows, L, lanes
    "ctcrw_score_scan": "ppppdppiii",
    # scalar-state (BM_SSM / OU_SSM) kernels, csrc/diag_*.cu
    # stack, h, p0, totals, seg (scratch), L, lanes
    "diag_filter_totals": "ppdppii",
    # stack, prefix, seg, h, p0, moments, llk, L, lanes
    "diag_filter_scan": "ppppdppii",
    "block_prefix_diag_filter": "pppiiii",
    "block_prefix_diag_smooth": "pppiiii",
    "block_prefix_sqrt2": "pppiiii",
    "block_prefix_sqrt1": "pppiiii",
    # stack, moments, totals, L, lanes
    "diag_smooth_totals": "pppii",
    # stack, moments, suffix, h, p0, cot, hbar, L, lanes
    "diag_score_scan": "ppppdppii",
    # CTCRW element-space kernels, csrc/elem_fused.cu
    # stack, h, p0_pos, p0_vel, totals, L, lanes
    "elem_filter_totals": "ppddpii",
    # stack, prefix, h, p0_pos, p0_vel, moments, llk, L, lanes
    "elem_filter_scan": "pppddppii",
    # stack, moments, totals, L, lanes
    "elem_smooth_totals": "pppii",
    # stack, moments, suffix, h, p0_pos, cot, hbar, L, lanes
    "elem_score_scan": "ppppdppii",
    # phase-1 scan, csrc/phase1_scan.cu: in, out, L, lanes, reverse
    "phase1_scan_filter": "ppiii",
    "phase1_scan_smooth": "ppiii",
    "phase1_scan_diag_filter": "ppiii",
    "phase1_scan_diag_smooth": "ppiii",
    "phase1_scan_sqrt2": "ppiii",
    "phase1_scan_sqrt1": "ppiii",
}
_CTYPES = {"p": ctypes.c_void_p, "d": ctypes.c_double, "i": ctypes.c_int}
# entry points that take nothing and return a constant of the built
# kernels (`constant`): D1b's segments per lane (csrc/diag_filter.cu)
_CONSTANTS = ("diag_filter_segs",)

_lib = None  # the loaded library, built on first use


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def build() -> Path:
    """Compile the kernels (once per source hash); returns the .so path.
    Add "-Xptxas", "-v" to _NVCC_FLAGS to see each kernel's registers,
    shared memory and spills."""
    h = hashlib.sha256()
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    out_dir = _BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libssde_kernels.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        jobs = []
        for f in sorted(_CSRC.glob("*.cu")):
            obj = Path(tmp_dir) / f"{f.stem}.o"
            cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(f)]
            jobs.append((f.name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for name, _, proc in jobs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name} ({proc.returncode}):\n{out}\n{err}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = Path(tmp_dir) / so.name
        res = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp),
             *(str(obj) for _, obj, _ in jobs)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}\n"
                f"{res.stderr}"
            )
        os.replace(tmp, so)  # atomic: a loader never sees half a file
    return so


def load():
    """Build if needed and load the library; returns the ctypes handle."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, sig in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"ssde_{name}_{suffix}")
                fn.argtypes = [_CTYPES[c] for c in sig] + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
        for name in _CONSTANTS:
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"ssde_{name}_{suffix}")
                fn.argtypes, fn.restype = [], ctypes.c_int
        lib.ssde_error_string.argtypes = [ctypes.c_int]
        lib.ssde_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def constant(name: str, dtype) -> int:
    """The value of the built kernels' constant `name` (_CONSTANTS) for
    the working type dtype (float32/float64); builds if needed."""
    return getattr(load(), f"ssde_{name}_{_SUFFIX[dtype]}")()
# positions of each entry point's pointer arguments
_PTRS = {name: tuple(i for i, c in enumerate(sig) if c == "p")
         for name, sig in _SIGNATURES.items()}


def _check_args(name: str, args):
    """Raise TypeError unless every pointer argument is a contiguous CUDA
    tensor on the first one's device and of its dtype (float32/float64,
    which picks the _f32/_f64 symbol); returns the first. Runs before
    anything is built: one pass of cheap tests, and only a failure walks
    the arguments again to name the culprit."""
    sig = _SIGNATURES[name]
    if len(sig) != len(args):
        raise TypeError(f"{name} takes {len(sig)} arguments, got {len(args)}")
    ptrs = [args[i] for i in _PTRS[name]]
    first = ptrs[0]
    try:
        dev, dtype = first.get_device(), first.dtype
        ok = first.is_cuda and dtype in _SUFFIX
        for a in ptrs:
            ok = (ok and a.get_device() == dev and a.dtype is dtype
                  and a.is_contiguous())
        if ok:
            return first
    except AttributeError:  # not a tensor
        pass
    for i, a in enumerate(ptrs):
        if not (isinstance(a, torch.Tensor) and a.is_cuda):
            raise TypeError(f"{name}: pointer argument {i} is not a CUDA tensor")
        if a.device != first.device or a.dtype != first.dtype:
            raise TypeError(
                f"{name}: pointer argument {i} is {a.dtype} on {a.device}, "
                f"the first is {first.dtype} on {first.device}"
            )
        if not a.is_contiguous():
            raise TypeError(f"{name}: pointer argument {i} is not contiguous")
    raise TypeError(f"{name}: dtype {first.dtype} is not float32/float64")


def launch(name: str, *args):
    """Launch kernel `name` on the current stream of the first tensor's
    device. Tensors pass as device pointers (they must stay referenced
    by the caller until the kernel has run, which holding them in the
    argument list guarantees for the enqueue), floats as doubles, ints
    as ints (ctypes converts each by the entry point's argtypes)."""
    first = _check_args(name, args)
    lib = load()
    c_args = [
        a.data_ptr() if kind == "p" else float(a) if kind == "d" else int(a)
        for kind, a in zip(_SIGNATURES[name], args)
    ]
    symbol = f"ssde_{name}_{_SUFFIX[first.dtype]}"
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        err = getattr(lib, symbol)(*c_args, stream)
    if err != 0:
        msg = lib.ssde_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {symbol} failed: {msg}")
