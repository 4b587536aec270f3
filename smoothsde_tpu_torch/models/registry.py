"""Model-type registry: SDE parameter names, link functions, likelihood kind.

Port of smoothsde_tpu/models/registry.py. The links act on torch tensors
and, through NumPy's own ufuncs, on arrays and floats (the host-side
bookkeeping in api/sde.py applies them to NumPy values).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

MODEL_TYPES = (
    "BM",
    "BM_t",
    "OU",
    "CIR",
    "BM_SSM",
    "OU_SSM",
    "CTCRW",
    "ESEAL_SSM",
)

# Likelihood engines ("closed_form" = per-step transition density,
# "ssm" = linear-Gaussian Kalman filter), cf. smoothSDE.cpp:14-26.
_KIND = {
    "BM": "closed_form",
    "BM_t": "closed_form",
    "OU": "closed_form",
    "CIR": "closed_form",
    "BM_SSM": "ssm",
    "OU_SSM": "ssm",
    "CTCRW": "ssm",
    "ESEAL_SSM": "ssm",
}


def _identity(x):
    return x


def _log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(x)


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


_LINKS: dict[str, Tuple[Callable, Callable]] = {
    # name -> (link, invlink)
    "identity": (_identity, _identity),
    "log": (_log, _exp),
}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One SDE parameter: its name and link ('identity' or 'log')."""

    name: str
    link_name: str

    @property
    def link(self) -> Callable:
        return _LINKS[self.link_name][0]

    @property
    def invlink(self) -> Callable:
        return _LINKS[self.link_name][1]


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static description of one SDE model type."""

    type: str
    params: Tuple[ParamSpec, ...]  # in par_mat column order
    kind: str  # "closed_form" | "ssm"
    # names of extra scalar (outer) parameters beyond coeff_fe/log_lambda
    extra_params: Tuple[str, ...] = ()
    multidim: bool = True  # multiple response dims allowed?

    @property
    def n_par(self) -> int:
        return len(self.params)

    @property
    def param_names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self.params)

    def links(self):
        return {p.name: p.link for p in self.params}

    def invlinks(self):
        return {p.name: p.invlink for p in self.params}


def _mu_block(n_dim: int, link: str) -> Tuple[ParamSpec, ...]:
    if n_dim == 1:
        return (ParamSpec("mu", link),)
    return tuple(ParamSpec(f"mu{i + 1}", link) for i in range(n_dim))


def get_model_spec(type: str, n_dim: int = 1) -> ModelSpec:
    """Build the ModelSpec for a model type and number of response dims
    (parameter layout of the reference's R/sde.R:56-87)."""
    if type not in MODEL_TYPES:
        raise ValueError(
            f"Unknown model type '{type}'. Options: {', '.join(MODEL_TYPES)}"
        )
    if type in ("BM_t", "ESEAL_SSM") and n_dim != 1:
        raise ValueError(f"{type} only supports a single response variable")

    if type in ("BM", "BM_SSM"):
        params = _mu_block(n_dim, "identity") + (ParamSpec("sigma", "log"),)
    elif type == "BM_t":
        params = (ParamSpec("mu", "identity"), ParamSpec("sigma", "log"))
    elif type in ("OU", "OU_SSM"):
        params = _mu_block(n_dim, "identity") + (
            ParamSpec("tau", "log"),
            ParamSpec("kappa", "log"),
        )
    elif type == "CIR":
        params = _mu_block(n_dim, "log") + (
            ParamSpec("beta", "log"),
            ParamSpec("sigma", "log"),
        )
    elif type == "CTCRW":
        params = _mu_block(n_dim, "identity") + (
            ParamSpec("tau", "log"),
            ParamSpec("nu", "log"),
        )
    elif type == "ESEAL_SSM":
        params = (ParamSpec("mu", "identity"), ParamSpec("sigma", "log"))
    else:  # pragma: no cover
        raise AssertionError(type)

    extra: Tuple[str, ...] = ()
    if type in ("BM_SSM", "OU_SSM", "CTCRW"):
        extra = ("log_sigma_obs",)
    elif type == "ESEAL_SSM":
        extra = ("log_tau", "a1", "log_a2")

    return ModelSpec(
        type=type,
        params=params,
        kind=_KIND[type],
        extra_params=extra,
        multidim=type not in ("BM_t", "ESEAL_SSM"),
    )


def model_eqn(type: str) -> str:
    """Equation string for printing, mirroring R/sde.R:1676-1698."""
    eqns = {
        "BM": "    dZ(t) = mu dt + sigma dW(t)",
        "BM_SSM": (
            "    dY(t) = mu dt + sigma dW(t)\n"
            "    Z(i) ~ N(Y(i), sigma_obs^2)"
        ),
        "BM_t": "    Brownian motion with t-distributed noise",
        "OU": (
            "    dZ(t) = beta (mu - Z(t)) dt + sigma dW(t)\n"
            "Parameterised in terms of:\n"
            "* tau = 1/beta\n"
            "* kappa = sigma^2/(2*beta)"
        ),
        "OU_SSM": (
            "    dZ(t) = beta (mu - Z(t)) dt + sigma dW(t)\n"
            "    Z(i) ~ N(Y(i), sigma_obs^2)\n"
            "Parameterised in terms of:\n"
            "* tau = 1/beta\n"
            "* kappa = sigma^2/(2*beta)"
        ),
        "CIR": "    dZ(t) = beta (mu - Z(t)) dt + sigma sqrt(Z(t)) dW(t)",
        "CTCRW": (
            "    dV(t) = beta (mu - V(t)) dt + sigma dW(t)\n"
            "    dZ(t) = V(t) dt\n"
            "Parameterised in terms of:\n"
            "* tau = 1/beta\n"
            "* nu = sqrt(pi/beta)*sigma/2"
        ),
        "ESEAL_SSM": (
            "    dL(t) = mu dt + sigma dW(t)\n"
            "    Z(i) ~ N(a1 + a2 L(i)/R(i), tau^2/h(i))"
        ),
    }
    return eqns[type]
