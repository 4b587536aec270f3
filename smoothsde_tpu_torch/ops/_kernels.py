"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

At first use the sources are compiled with nvcc into one shared library
with a plain C interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o <build>/libssde_kernels.so csrc/*.cu

The library lands in build/smoothsde_tpu_torch/<hash>/ at the root of
the checkout, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one is reused. Every C entry point
takes device pointers, scalars and the CUDA stream, launches on that
stream without synchronising, and returns cudaGetLastError() of its
launches; `launch` raises on a non-zero code.
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
_BUILD_ROOT = _PKG.parent / "build" / "smoothsde_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# C argument kinds after the entry-point name: p = device pointer,
# d = double, i = int. Every entry point ends with the stream (p) and
# returns an int (cudaError_t).
_SIGNATURES = {
    # stack, bd, h, p0_pos, p0_vel, totals, L, lanes
    "ctcrw_filter_totals": "pppddpii",
    # stack, bd, prefix, h, p0_pos, p0_vel, moments, llk, L, lanes
    "ctcrw_filter_scan": "ppppddppii",
    # totals, out, d, NB, reverse
    "block_prefix_filter": "ppiii",
    "block_prefix_smooth": "ppiii",
    # stack, moments, totals, rows, L, lanes
    "ctcrw_smooth_totals": "pppiii",
    # stack, moments, suffix, h, p0_pos, cot, hbar, rows, L, lanes
    "ctcrw_score_scan": "ppppdppiii",
}
_CTYPES = {"p": ctypes.c_void_p, "d": ctypes.c_double, "i": ctypes.c_int}

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
    cu = [str(f) for f in sorted(_CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, *cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
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
        lib.ssde_error_string.argtypes = [ctypes.c_int]
        lib.ssde_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def launch(name: str, *args):
    """Launch kernel `name` on the current stream of the first tensor's
    device. Tensors pass as device pointers (they must stay referenced
    by the caller until the kernel has run, which holding them in the
    argument list guarantees for the enqueue), floats as doubles, ints
    as ints."""
    lib = load()
    first = next(a for a in args if isinstance(a, torch.Tensor))
    suffix = {torch.float32: "f32", torch.float64: "f64"}[first.dtype]
    sig = _SIGNATURES[name]
    if len(sig) != len(args):
        raise TypeError(f"{name} takes {len(sig)} arguments, got {len(args)}")
    c_args = []
    for kind, a in zip(sig, args):
        if kind == "p":
            if not (isinstance(a, torch.Tensor) and a.is_cuda):
                raise TypeError(f"{name}: expected a CUDA tensor")
            c_args.append(ctypes.c_void_p(a.data_ptr()))
        elif kind == "d":
            c_args.append(ctypes.c_double(float(a)))
        else:
            c_args.append(ctypes.c_int(int(a)))
    with torch.cuda.device(first.device):
        stream = torch.cuda.current_stream(first.device).cuda_stream
        err = getattr(lib, f"ssde_{name}_{suffix}")(
            *c_args, ctypes.c_void_p(stream)
        )
    if err != 0:
        msg = lib.ssde_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name}_{suffix} failed: {msg}")
