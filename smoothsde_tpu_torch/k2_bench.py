"""Times the cross-block prefix K2 and the CTCRW nllk+grad on one GPU.

    python3 smoothsde_tpu_torch/k2_bench.py [--root DIR] [--sweep]
                                             [--fit [--k2-f64]] [--k2]

Imports smoothsde_tpu_torch from DIR (default: the checkout holding this
file), so that two versions of the package can be timed on one card, each
in its own process. Prints one JSON line with:

  - "k2": each K2 instantiation in its direction on the fits' paths
    (Elem14 forward, Smooth9 reverse, Elem5 forward, Smooth3 reverse) and
    on the square-root "pallas" value pass (Sqrt14, Sqrt5 forward), at
    NB = 31,250 blocks for d = 2 (config 5a, the OU_SSM fit) in f32 and
    f64, and for d = 1 (the BM_SSM fit; not the square-root kinds) in
    f32: device us per call (torch.profiler, 20 calls), the same split by
    K2's CUDA kernels ("split"), us per wrapper call (CUDA events, 200
    calls, launch included) and the SHA-256 of the output's bytes (equal
    across two versions: the kernel kept its bits);
  - "paths": nllk+grad at 1M steps, f32, of the CTCRW par-space core
    (the fit's route), the element-space `llk2_analytic` "fused" and
    "pallas" (d = 2), and the OU_SSM (d = 2) and BM_SSM (d = 1) fused
    cores: the wall median over 100 calls before any profiling, device
    busy and per-kernel device us per call (profiler, 10 calls), the wall
    median again after the profiler has run, and the gradient (exact
    values: equal lists across two versions mean that every kernel of the
    path gave the same bits);
  - with --sweep, "sweep": the CTCRW par-space measurement for
    STEPS_PER_LANE in (16, 32, 64);
  - with --k2, only "k2";
  - with --fit, "fit": the config-5a CTCRW fit in f32 (chip_smoke.py's
    `config5a` from DIR): wall s, evaluations, tau, nu, nllk; with
    --k2-f64 the fit's K2 calls run the kernel in f64 on the f32 totals
    (the rest in f32), to see how far the fit's path depends on K2's
    rounding.

The data are those of tools/accuracy_audit.py (rng seed 0, 1M steps,
times = cumsum U(0.4, 0.6), obs = cumsum N(0, 0.3^2) in 2-D; its first
column for BM_SSM), the parameters constant over the steps. The inputs
of the moment-form K2 instantiations are the identity plus N(0, 0.01^2)
noise (their combine does the same work for any values); those of
`sqrt2` / `sqrt1` are real square-root totals, whose combine branches on
zero factors: the plain phase-1 scan (ops/scan_utils.py
`pallas_phase1_scan_plain`) of the CTCRW square-root elements over the
2-D data (mu = (0.05, -0.02), tau = 2, nu = 1) and of the OU_SSM ones
(mu = 0, tau = 2, kappa = 1), sigma_obs = 0.1. No kernel's output is
checked here: chip_smoke.py does.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

K2 = {  # wrapper name: (element kind, reverse), as the fits call them
    "block_prefix_filter": ("filter", False),
    "block_prefix_smooth": ("smooth", True),
    "block_prefix_diag_filter": ("diag_filter", False),
    "block_prefix_diag_smooth": ("diag_smooth", True),
    "block_prefix_sqrt2": ("sqrt2", False),
    "block_prefix_sqrt1": ("sqrt1", False),
}
K2_ELEM = {"Elem14": "block_prefix_filter", "Smooth9": "block_prefix_smooth",
           "Elem5": "block_prefix_diag_filter",
           "Smooth3": "block_prefix_diag_smooth",
           "Sqrt14": "block_prefix_sqrt2", "Sqrt5": "block_prefix_sqrt1"}
SQRT_KINDS = ("sqrt2", "sqrt1")


def profile(fn, reps, torch):
    """(device busy us, {kernel key: device us}) per call of fn."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, per = 0.0, {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        busy += us
        key = e.key
        if "block_prefix" in key:  # K2's kernels, by element type
            name = next(n for el, n in K2_ELEM.items() if el in key)
            sub = key.split("ssde::")[1].split("<")[0]
            per[f"{name} {sub}"] = per.get(f"{name} {sub}", 0.0) + us / reps
            key = name
        elif "ssde::" in key:
            key = key.split("ssde::")[1].split("<")[0]
        else:
            key = "other"
        per[key] = per.get(key, 0.0) + us / reps
    return busy / reps, per


def event_us(fn, reps, torch):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps * 1e3


def sqrt_totals(torch):
    """{kind: (C, 2 * 31,250) f64 square-root totals on the card}: the
    plain phase-1 scan of the audit data's CTCRW (`sqrt2`) and OU_SSM
    (`sqrt1`) square-root elements (chip_smoke.py's `slice_elements`)."""
    from chip_smoke import elem_stack, slice_elements

    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import scan_utils as su

    dev = torch.device("cuda")
    n = 1_000_000
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.4, 0.6, size=n))
    obs = np.cumsum(rng.normal(size=(n, 2)) * 0.3, axis=0)
    ids = np.zeros(n, np.int32)
    p = cf.plan(2, n)
    out = {}
    with torch.no_grad():
        for typ, kind, theta in (
                ("CTCRW", "sqrt2", [0.05, -0.02, np.log(2.0), 0.0]),
                ("OU_SSM", "sqrt1", [0.0, 0.0, np.log(2.0), 0.0])):
            par = torch.tensor(theta, dtype=torch.float64,
                               device=dev).expand(n, 4).contiguous()
            el = slice_elements(torch, typ, par, 0.1, obs, times, ids)[kind]
            st = elem_stack(torch, kind, el, p)
            out[kind] = su.pallas_phase1_scan_plain(st, kind)[-1].contiguous()
    assert all(t.shape[1] == 2 * 31_250 for t in out.values())
    return out


def k2_times(torch):
    import hashlib

    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sq = sqrt_totals(torch)
    out = {}
    for d, dtype in ((2, torch.float32), (2, torch.float64),
                     (1, torch.float32)):
        dt = "f32" if dtype == torch.float32 else "f64"
        xs = {}
        for name, (kind, _) in K2.items():
            if kind in SQRT_KINDS:
                if d == 2:
                    xs[name] = sq[kind].to(dtype)
                continue
            ident = torch.tensor(cf.ELEMS[kind].id_vals, device=dev)
            noise = torch.randn((len(ident), d * 31_250), device=dev,
                                generator=gen)
            xs[name] = (ident[:, None] + 0.01 * noise).to(dtype).contiguous()

        def all_k2(d=d, xs=xs):
            for name in xs:
                cf.block_prefix(xs[name], d, *K2[name])

        _, per = profile(all_k2, 20, torch)
        for name, x in xs.items():
            kind, rev = K2[name]
            got = cf.block_prefix(x, d, kind, rev)
            torch.cuda.synchronize()
            out[f"{name} d={d} {dt}"] = {
                "device_us": per[name],
                "split": {k.split(" ", 1)[1]: v for k, v in per.items()
                          if k.startswith(f"{name} ")},
                "event_us": event_us(
                    lambda: cf.block_prefix(x, d, kind, rev), 200, torch),
                "sha256": hashlib.sha256(
                    got.cpu().numpy().tobytes()).hexdigest()}
    return out


def path_calls(torch, which):
    """{path: value+grad closure} at 1M steps, f32: the CTCRW par-space
    core (the fit's route), the element-space `llk2_analytic` "fused" and
    "pallas", and the OU_SSM (d = 2) and BM_SSM (d = 1) fused cores; each
    closure differentiates in a broadcast parameter row and ends in a
    device-to-host copy of the gradient."""
    from smoothsde_tpu_torch.ops import diag_fused as df
    from smoothsde_tpu_torch.ops.kalman_smooth import llk2_analytic
    from smoothsde_tpu_torch.ops.kalman_soa import (
        _ctcrw_system,
        ctcrw_loglik_soa,
        prepare_ctcrw_data,
    )

    dev = torch.device("cuda")
    n = 1_000_000
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.4, 0.6, size=n))
    obs = np.cumsum(rng.normal(size=(n, 2)) * 0.3, axis=0)
    ids = np.zeros(n, np.int32)
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float32,
                              device=dev)

    def vg(theta, loglik):
        # f32 as the data: np.log's float64 would promote the path to f64
        th = torch.tensor(theta, dtype=torch.float32, device=dev,
                          requires_grad=True)

        def call():
            v = loglik(th.expand(n, len(theta)).contiguous())
            (g,) = torch.autograd.grad(-v, th)
            return g.cpu()

        return call

    def elem(scan):
        return lambda par: llk2_analytic(_ctcrw_system(
            par, None, None, None, 0.1, dt=data.dtv, yd=data.yd,
            reset=data.resetf > 0.5, valid=data.validf > 0.5), scan)

    ctcrw_theta = [0.05, -0.02, np.log(2.0), 0.0]
    calls = {
        "ctcrw": lambda: vg(ctcrw_theta, lambda par: ctcrw_loglik_soa(
            par, None, None, None, 0.1, scan="fused", analytic_grad=True,
            data=data)),
        "ctcrw_elem_fused": lambda: vg(ctcrw_theta, elem("fused")),
        "ctcrw_elem_pallas": lambda: vg(ctcrw_theta, elem("pallas")),
    }
    for typ, d, theta in (("OU_SSM", 2, [0.0, 0.0, np.log(2.0), 0.0]),
                          ("BM_SSM", 1, [0.05, np.log(0.3)])):
        ddata = df.prepare_diag_data(typ, obs[:, :d], times, ids,
                                     dtype=torch.float32, device=dev)
        calls[typ.lower()] = (lambda typ=typ, ddata=ddata, theta=theta: vg(
            theta, lambda par: df.diag_fused_loglik(df.diag_system(
                typ, par, None, None, None, 0.1, data=ddata))))
    return {k: calls[k]() for k in which}


def wall_us(fn, reps):
    for _ in range(5):
        fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e6)
    return float(np.median(ts))


def path_times(torch, which):
    """Per path: the wall median over 100 calls before any profiling,
    device busy and per-kernel device us per call (profiler, 10 calls),
    the wall median again after the profiler has run, and the
    gradient."""
    out = {}
    for name, fn in path_calls(torch, which).items():
        wall = wall_us(fn, 100)
        busy, per = profile(fn, 10, torch)
        out[name] = {"wall_median_us": wall, "device_busy_us": busy,
                     "device_us": per,
                     "wall_median_after_profile_us": wall_us(fn, 100),
                     "grad": fn().tolist()}
    return out


def fit_probe(torch, k2_f64):
    from chip_smoke import config5a

    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    if k2_f64:
        kern = cf.OPS["kernels"]

        def block_prefix_f64(totals, d, elem, reverse):
            out = kern.block_prefix(totals.double(), d, elem, reverse)
            return out.to(totals.dtype)

        cf.OPS["kernels"] = kern._replace(block_prefix=block_prefix_f64)
    data = config5a()
    t = time.perf_counter()
    sde = SDE(data=data, type="CTCRW", response=["y1", "y2"],
              par0=[0, 0, 2, 0.8], device="cuda")
    res = sde.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    tau, nu = (float(v) for v in sde.par(t=0)[0, 2:4])
    return {"k2_f64": k2_f64, "wall_s": wall, "evals": res.counts["evals"],
            "bfgs": res.counts, "tau": tau, "nu": nu, "nllk": res.value}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--fit", action="store_true")
    ap.add_argument("--k2-f64", action="store_true")
    ap.add_argument("--k2", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    # run as a script, this file's directory (the package itself) heads
    # sys.path: only --root provides the package
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [p for p in sys.path
                            if os.path.abspath(p or os.curdir) != here]
    import torch

    import smoothsde_tpu_torch
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    if not torch.cuda.is_available():
        sys.exit("k2_bench: no CUDA device")
    pkg = os.path.dirname(os.path.abspath(smoothsde_tpu_torch.__file__))
    if pkg != os.path.join(root, "smoothsde_tpu_torch"):
        sys.exit(f"k2_bench: imported the package from {pkg}, not {root}")
    res = {"root": args.root, "card": torch.cuda.get_device_name(0)}
    if args.fit:
        res["fit"] = fit_probe(torch, args.k2_f64)
        print(json.dumps(res), flush=True)
        return
    if not args.k2:
        paths = ["ctcrw", "ctcrw_elem_fused", "ctcrw_elem_pallas", "ou_ssm",
                 "bm_ssm"]
        res["paths"] = path_times(torch, paths)
    res["k2"] = k2_times(torch)
    if args.sweep:
        res["sweep"] = {}
        for spl in (16, 32, 64):
            cf.STEPS_PER_LANE = spl
            res["sweep"][spl] = path_times(torch, ["ctcrw"])["ctcrw"]
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
