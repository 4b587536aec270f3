"""smoothsde-tpu on PyTorch and CUDA: the H100 port of smoothsde_tpu.

A second package beside the JAX reference `smoothsde_tpu`, with the same
module layout (ops/, models/, formula/, infer/, api/, utils/). It imports
torch and never jax. The state-space fits (CTCRW, BM_SSM, OU_SSM) run end
to end through `SDE(...).fit()`; their filters, cross-block prefix and
Fisher-score backwards are hand-written CUDA kernels for Hopper (csrc/),
each with a plain PyTorch version that the CPU tests run. The
closed-form models (BM, BM_t, OU, CIR) run on plain torch ops, with
smooths and random effects integrated out by the Laplace approximation. The device is explicit:
`SDE(..., device="cuda")` by default, `device="cpu"` for the plain
versions.

The exports are the JAX package's. `enable_compilation_cache`
(utils/cache.py) re-points where the compiled kernel library is kept,
the port's compile-once cache.
"""

__version__ = "0.1.0"

# The API surface is loaded lazily (PEP 562) so the ops can be imported
# without the formula and fitting layers.
_LAZY = {
    "SDE": ("smoothsde_tpu_torch.api.sde", "SDE"),
    "enable_compilation_cache": ("smoothsde_tpu_torch.utils.cache",
                                 "enable_compilation_cache"),
    "MODEL_TYPES": ("smoothsde_tpu_torch.models.registry", "MODEL_TYPES"),
    "get_model_spec": ("smoothsde_tpu_torch.models.registry",
                       "get_model_spec"),
    "prec_to_cov": ("smoothsde_tpu_torch.utils.misc", "prec_to_cov"),
    "term_indices": ("smoothsde_tpu_torch.utils.misc", "term_indices"),
    "ctcrw_cov": ("smoothsde_tpu_torch.utils.misc", "ctcrw_cov"),
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'smoothsde_tpu_torch' has no attribute '{name}'"
    )
