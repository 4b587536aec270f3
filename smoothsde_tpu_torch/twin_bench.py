"""Times one Laplace marginal evaluation on one GPU per form of the
forward-mode twin, at config 4 and at longer tracks of the same model.

    python3 smoothsde_tpu_torch/twin_bench.py [--reps N] [--forms A,B]
        [--n-per N1,N2] [--eager-forms C,D]

The data are chip_smoke.py's `config4` (8 tracks of 2-D CTCRW with
`tau ~ s(ID, bs='re')`, seed 3) with --n-per steps a track (250 is
config 4; 2,048 and 8,192 give n = 16,384 and 65,536, the threshold
`objective.TWIN_SOA_MIN_STEPS`), in f32 on the card. For each form of
--forms ("associative": the SoA filter's Hillis-Steele scan; "blocked":
its block scan with plain phases) and each size it builds the objective
with that form (it replaces `objective.twin_route` for the build; the
library chooses by device and n alone) and evaluates the marginal value
+ gradient, with the twin's CUDA graphs, at chip_smoke 3i's f64 optimum
of config 4: first from zeros (the first call, which captures), then
from that bhat (the warm start the fit's late evaluations see) and from
zeros. The forms of --eager-forms ("track": the per-dim sequential
filter batched by track, the CPU's form; or a scan) run at config 4
only, with the graphs replaced by eager calls, one warm evaluation each
(a capture of "track" would replay ~1.5M launches four times). For each
also one eager value + inner gradient of the twin alone: its device
operations compare the forms. Prints one JSON line per row and then one
with all: the host wall s per evaluation (median of --reps), device busy
ms, device operations and the idle share per evaluation
(torch.profiler, one call), the marginal value and gradient, and the
graphs' status; with the card's name and power limit (nvidia-smi).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the outer optimum of chip_smoke 3i's f64 fit at config 4
X_OPT = [-2.3208855183777244, -0.012463357004233988, -0.0855189355539962,
         1.2707034344514465, -0.019196970641790774, 2.4370000034820563]


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profiled(fn, torch):
    """(device busy ms, device operations, wall ms) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = ops = 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            busy += e.self_cuda_time_total if us is None else us
            ops += e.count
    return busy / 1e3, ops, wall


class _Eager:
    """A stand-in for `laplace.Graphed` that calls fn as it is."""

    def __init__(self, fn):
        self.fn, self.status = fn, {"eager": "eager"}

    def __call__(self, *args):
        return self.fn(*args)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--forms", default="associative,blocked")
    ap.add_argument("--n-per", default="250,2048,8192")
    ap.add_argument("--eager-forms", default="associative,track")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer import laplace, objective
    from smoothsde_tpu_torch.infer.fit import make_val_grad
    from smoothsde_tpu_torch.ops import _kernels

    if not torch.cuda.is_available():
        raise SystemExit("twin_bench: no CUDA device")
    _kernels.build()
    _kernels.load()
    x = np.asarray(X_OPT)
    out = {"card": card_line(), "rows": {}}
    chosen, graphed = objective.twin_route, laplace.Graphed
    runs = [(form, int(n_per), True) for n_per in args.n_per.split(",")
            for form in args.forms.split(",")]
    runs += [(form, 250, False) for form in args.eager_forms.split(",")
             if form]
    warm = {}  # n_per -> a bhat at X_OPT
    for form, n_per, graphs in runs:
        kw, _ = chip_smoke.config4(n_per=n_per)
        objective.twin_route = lambda device, n, form=form: form
        laplace.Graphed = graphed if graphs else _Eager
        try:
            bundle = SDE(**kw, device="cuda", dtype=torch.float32).bundle()
            vg = make_val_grad(bundle)
        finally:
            objective.twin_route, laplace.Graphed = chosen, graphed
        zeros = bundle.packer.inner_init()
        row = {"n": bundle.n_obs, "twin": bundle.twin}
        if graphs:
            t = time.perf_counter()
            warm[n_per] = vg(x, zeros)[2]
            row["first_call_s"] = time.perf_counter() - t
        starts = (("warm", warm[n_per]),)
        if graphs:
            starts += (("zeros", zeros),)
        for start, b0 in starts:
            ts = []
            for _ in range(args.reps if graphs else 1):
                t = time.perf_counter()
                v, g, _ = vg(x, b0)
                ts.append(time.perf_counter() - t)
            row[start] = {"s_per_eval": float(np.median(ts)),
                          "value": v, "grad": g.tolist()}
            if graphs:
                busy, ops, wall = profiled(lambda: vg(x, b0), torch)
                row[start].update(device_busy_ms=busy, device_ops=ops,
                                  profiled_wall_ms=wall,
                                  idle_share=1.0 - busy / wall)
        # one value + inner gradient of the twin, eager: its device
        # operations compare the forms' launch counts
        xt = torch.tensor(x, dtype=torch.float32, device="cuda")
        bt = torch.tensor(warm[n_per], dtype=torch.float32, device="cuda")
        unit = torch.func.grad_and_value(
            lambda o, b: bundle.joint_nllk_ad(bundle.packer.unpack(o, b)),
            argnums=1)
        busy, ops, wall = profiled(lambda: unit(xt, bt), torch)
        row["value_and_inner_grad"] = {"device_busy_ms": busy,
                                       "device_ops": ops, "wall_ms": wall}
        row["graphs"] = {k: gr.status
                         for k, gr in bundle.marginal.graphs.items()}
        name = f"{form}_n{bundle.n_obs}_{'graphs' if graphs else 'eager'}"
        out["rows"][name] = row
        print(json.dumps({name: row}), flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
