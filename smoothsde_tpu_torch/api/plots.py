"""Parameter plots: covariate-grid curves with posterior spaghetti or
confidence ribbons (matplotlib port of R/sde.R:1539-1644).

Port of smoothsde_tpu/api/plots.py; matplotlib is imported when a
plot is made, never at import."""

from __future__ import annotations

import numpy as np


def plot_par(
    sde,
    var: str,
    par_names=None,
    covs=None,
    n_post: int = 100,
    show_CI: str = "none",
    resp: bool = True,
    term=None,
    rng=None,
):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    rng = np.random.default_rng() if rng is None else rng
    mats = sde.make_mat_grid(var=var, covs=covs)
    X_fe, X_re = mats["X_fe"], mats["X_re"]
    grid = np.asarray(mats["new_data"][var])
    par = sde.par(t="all", X_fe=X_fe, X_re=X_re, resp=resp, term=term)

    all_names = list(sde.spec().param_names)
    if par_names is None:
        par_names = all_names
    else:
        unknown = set(par_names) - set(all_names)
        if unknown:
            raise ValueError(
                f"Check that elements of 'par_names' are in: "
                f"{', '.join(all_names)}"
            )

    post = None
    CI = None
    if n_post > 0 and show_CI == "none" and sde._fit_result is not None:
        post = sde.post_par(
            X_fe=X_fe, X_re=X_re, n_post=n_post, resp=resp, term=term, rng=rng
        )
    elif show_CI != "none":
        ci_fn = (
            sde.CI_pointwise if show_CI == "pointwise" else sde.CI_simultaneous
        )
        CI = ci_fn(
            X_fe=X_fe, X_re=X_re, n_post=max(n_post, 100), level=0.95,
            resp=resp, term=term, rng=rng,
        )

    # caption with pinned covariates (R/sde.R:1598-1613)
    others = [
        f"{k} = {np.asarray(v).flat[0]}"
        for k, v in mats["new_data"].items()
        if k != var
    ]
    caption = ", ".join(others)

    k = len(par_names)
    fig, axes = plt.subplots(1, k, figsize=(4.2 * k, 3.4), squeeze=False)
    is_factor_grid = not np.issubdtype(np.asarray(grid).dtype, np.number)
    for ax_i, pname in enumerate(par_names):
        i = all_names.index(pname)
        ax = axes[0, ax_i]
        if post is not None:
            for s in range(post.shape[2]):
                if is_factor_grid:
                    ax.plot(grid, post[:, i, s], ".", color=(0.7, 0, 0, 0.1),
                            markersize=2)
                else:
                    ax.plot(grid, post[:, i, s], color=(0.7, 0, 0, 0.1),
                            linewidth=0.6)
        if CI is not None:
            if is_factor_grid:
                ax.vlines(grid, CI[i, 0], CI[i, 1], color=(0.2, 0.5, 0.8, 0.5))
            else:
                ax.fill_between(
                    grid, CI[i, 0], CI[i, 1], color=(0.2, 0.5, 0.8, 0.3)
                )
        if is_factor_grid:
            ax.plot(grid, par[:, i], "k.", markersize=6)
            ax.tick_params(axis="x", rotation=90)
        else:
            ax.plot(grid, par[:, i], "k-")
        ax.set_xlabel(var)
        ax.set_ylabel(pname)
    if caption:
        fig.suptitle(caption, fontsize=9)
    fig.tight_layout()
    return fig
