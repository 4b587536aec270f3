"""Where the compiled kernel library is kept.

The counterpart of smoothsde_tpu/utils/cache.py's
`enable_compilation_cache`: the JAX package keeps XLA's compiled
executables in a persistent cache so that a later process skips the
compile; the port compiles its CUDA kernels once (ops/_kernels.py
`build`: one nvcc per source, linked into one library) into a directory
keyed by a hash of the sources and flags, which every later process of
the same sources reuses. That directory is build/smoothsde_tpu_torch/
at the root of the checkout unless re-pointed here. No environment
variable sets it (the JAX package's SMOOTHSDE_CACHE_DIR and
SMOOTHSDE_NO_COMPILE_CACHE have no counterpart).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """Keep the compiled kernel library under `cache_dir` (created on the
    first build; None: the default build/smoothsde_tpu_torch/ of the
    checkout) and return the directory in use. A library this process
    has already loaded stays loaded; later builds and loads look in the
    new directory."""
    from smoothsde_tpu_torch.ops import _kernels

    root = _kernels.DEFAULT_BUILD_ROOT if cache_dir is None \
        else Path(cache_dir).expanduser().resolve()
    _kernels._BUILD_ROOT = root
    return str(root)
