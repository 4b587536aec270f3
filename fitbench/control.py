"""The control of the comparison that decides `correct`: the plain
reference put in the program's place and computed in the precision below
the configuration's (`LOWER`: bfloat16 for float32, float32 for
float64).

For each seed, the jobs a run of that seed would fit first get the
control's fit: the program's procedure on the reference's nllk and its
gradient, the filter run in the lower precision (the per-step system formed in
float64 and rounded, as a kernel's inputs would be): BFGS from the
program's starting point (the reference's `start`) with the program's
f32 stopping rule, then the outer Hessian by central
differences of the gradient and its inverse. The fit is then judged as a
run judges the program's (check.py), and every number is printed:

    python fitbench/control.py --workload <cell> --seeds 11 12 13 \
        [--fits 2] [--device cuda]

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LOWER = {"float32": "bfloat16", "float64": "float32"}


def control_fit(cell, data, obs, dt, device, dtype):
    """The control's fit of one job: a record as harness.run_job makes."""
    import torch
    from scipy import optimize

    from fitbench.check import fd_hessian, tensors, value_grad

    obs_t, dt_t = tensors(obs, dt, device)

    def vg(x):
        v, g = value_grad(cell, x, obs_t, dt_t, dtype)
        if not np.isfinite(v):
            return 1e10, np.zeros_like(g)
        return v, np.where(np.isfinite(g), g, 0.0)

    x0 = cell.reference.start(cell.config, np.column_stack(
        [data[r] for r in cell.config["response"]]))
    gtol = max(1e-3, 1e-3 * (1.0 + abs(vg(x0)[0])))
    res = optimize.minimize(vg, x0, jac=True, method="BFGS",
                            options={"maxiter": 200, "gtol": gtol})
    H = fd_hessian(cell, res.x, obs_t, dt_t, dtype)
    return {"value": float(res.fun), "par": np.asarray(res.x, float),
            # non-finite entries dropped, as the program's prec_to_cov does
            "prec": np.where(np.isfinite(H), H, 0.0),
            "names": cell.reference.names(cell.config),
            "iterations": int(res.nit), "dtype": str(dtype)}


def readings(cell, seeds, fits, device, dtype):
    """The numbers compared, for the control's fit of jobs 1 .. fits of
    each seed's inputs."""
    from fitbench.check import compare
    from fitbench.harness import Inputs

    out = []
    for seed in seeds:
        inputs = Inputs(cell, seed)
        for j in range(1, 1 + fits):
            obs, dt = inputs.arrays(j)
            rec = control_fit(cell, inputs.job(j), obs, dt, device, dtype)
            nums = compare(cell, rec, obs, dt, device)
            out.append({"seed": seed, "job": j, "value": rec["value"],
                        "iterations": rec["iterations"], **nums})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fits", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from fitbench.check import NUMBERS
    from fitbench.harness import Cell

    cell = Cell(args.workload)
    dtype = getattr(torch, LOWER[cell.config["dtype"]])
    rows = readings(cell, args.seeds, args.fits, args.device, dtype)
    for r in rows:
        print(json.dumps(r), flush=True)
    # a control that gives no number (nan) has failed and sets no end
    low = {n: float(np.nanmin([r[n] for r in rows] + [np.inf]))
           for n in NUMBERS}
    nan = {n: sum(not np.isfinite(r[n]) for r in rows) for n in NUMBERS}
    print(json.dumps({"cell": cell.name, "smallest": low, "no_number": nan,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
