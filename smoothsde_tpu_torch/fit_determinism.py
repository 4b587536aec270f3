"""Checks whether the f32 fit of config 4 (chip_smoke.py phase 3i) depends
on what ran before it in the process, and whether any computation of the
fit reads memory it did not write.

    python3 smoothsde_tpu_torch/fit_determinism.py [--modes a,b,...]

Each mode runs in a fresh process on one GPU. It builds and loads the
kernels, turns TF32 off as chip_smoke.py does, and fits chip_smoke's
`config4` (8 tracks of 2-D CTCRW with `tau ~ s(ID, bs='re')`, seed 3) in
f32 with `SDE(..., device="cuda").fit()` twice, the second fit after the
first one's allocations; the "plain" mode then fits it in f64 as well.
The modes:

  plain    nothing else;
  dirty    first fills ~4 GiB of the caching allocator's blocks with
           random values and frees them, so an uninitialized read sees
           garbage;
  fill     torch.use_deterministic_algorithms(True, warn_only=True) and
           torch.utils.deterministic.fill_uninitialized_memory: every
           torch.empty is filled with NaN, so an uninitialized read that
           reaches a result turns it NaN;
  nocache  PYTORCH_NO_CUDA_MEMORY_CACHING=1: every allocation is a fresh
           cudaMalloc;
  script   chip_smoke.py's main() up to phase 3i, whose fits these are;
  bisect   as "script", and also before and after each phase function
           of chip_smoke.py up to 3i;
  profiled first runs torch.profiler once over a small CUDA op;
  script_det  as "script" with torch.use_deterministic_algorithms(True,
           warn_only=True), which swaps operations that accumulate with
           atomics for ordered ones (the warnings it raises are kept);
  tail*    no fit: the Laplace layer's `tail` (the cross derivatives
           and log-det partials: the part of the marginal gradient the
           probes found moving while the partials were taken by reverse
           mode) called eagerly on the same inputs, the digest of each
           call's bits in order: "tail" 5 calls, "tail_fwd" 3, then the
           reverse-mode partials twice, then 2 more,
           "tail_ws" as "tail" with CUBLAS_WORKSPACE_CONFIG=:4096:8,
           "tail_cublas" / "tail_cublaslt" after
           torch.backends.cuda.preferred_blas_library(...),
           "tail_bundles" 5 calls, then 3 on a second model,
           "tail_parts" / "tail_parts_rev" the cross derivatives and the
           reverse-mode partials apart,
           "tail_kernels" the operations, runtime calls and CUDA kernels
           (torch.profiler) of the first two reverse-mode calls that only
           one of them ran, "tail_ops" the first operation whose output
           differs between the first two (a TorchDispatchMode digest of
           every operation's arguments and output).

Every mode but "script" first evaluates, on a fresh f32 config-4 model at
chip_smoke 3i's f64 optimum (twin_bench.X_OPT), the marginal value +
gradient and some of its parts, and every mode again just before the
fits ("probes": digests of their bits): where they differ tells which
part the history moves.

Prints one JSON line per mode, then one with all: each fit's estimates,
marginal nllk, convergence and wall, and each f32 fit's distance from
the f64 fit in f64 standard errors (phase 3i's gate: 0.1 on the outer
coordinates, 1 on log lambda); with the card's name and power limit
(nvidia-smi).
"""

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MODES = ("plain", "dirty", "fill", "nocache", "script", "bisect",
         "profiled", "script_det", "tail", "tail_ws", "tail_cublas",
         "tail_cublaslt", "tail_bundles", "tail_parts", "tail_parts_rev",
         "tail_kernels", "tail_ops", "tail_fwd")
# chip_smoke.py's phase functions that run before phase 3i
PHASES = ("phase_kernels_vs_plain", "phase_k2", "phase_alone",
          "diag_fit", "elem_full_width", "phase_audit",
          "phase_config1", "phase_config2", "phase_config5b")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run_mode(mode):
    """The fits of one mode in this process; returns their JSON row."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.ops import _kernels

    _kernels.build()
    _kernels.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode in ("fill", "script_det"):
        torch.use_deterministic_algorithms(True, warn_only=True)
    if mode == "fill":
        torch.utils.deterministic.fill_uninitialized_memory = True
    if mode == "profiled":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.ones(1024, device="cuda").sum().item()
    if mode == "dirty":
        gen = torch.Generator(device="cuda").manual_seed(0)
        blocks = [torch.empty(2 ** 26, device="cuda").uniform_(
            -1e3, 1e3, generator=gen) for _ in range(16)]
        torch.cuda.synchronize()
        del blocks  # kept by the caching allocator, garbage inside
    kw, _ = chip_smoke.config4()

    def probe():
        """Digests of the bits of a fresh f32 model's quantities at X_OPT:
        the joint nllk + gradient through the kernels (inner coefficients
        b = 0.1), each of the Laplace layer's twin functions called as it
        is ("*_eager") and from its CUDA graph at b, the log-det and
        inverse of the inner Hessian there, and the marginal's value,
        gradient and bhat (from the inner initial values)."""
        import hashlib

        from smoothsde_tpu_torch.infer.fit import make_val_grad
        from smoothsde_tpu_torch.infer.laplace import _ALPHAS, _solve
        from smoothsde_tpu_torch.twin_bench import X_OPT

        def bits(*ts):
            h = hashlib.sha1()
            for t in ts:
                h.update(np.asarray(torch.as_tensor(t).detach().cpu(),
                                    np.float32).tobytes())
            return h.hexdigest()[:12]

        bundle = SDE(**kw, device="cuda", dtype=torch.float32).bundle()
        packer = bundle.packer
        vg = make_val_grad(bundle)
        graphs = bundle.marginal.graphs
        x = torch.tensor(X_OPT, dtype=torch.float32, device="cuda")
        b = torch.full((packer.n_inner,), 0.1, dtype=torch.float32,
                       device="cuda")
        xg = x.clone().requires_grad_(True)
        jv = bundle.joint_nllk(packer.unpack(xg, b))
        (jg,) = torch.autograd.grad(jv, xg)
        alphas = torch.tensor(_ALPHAS, dtype=torch.float32, device="cuda")
        cand = b[None, :] * (1.0 - alphas[:, None])
        out = {"joint": bits(jv, jg)}
        for how in ("eager", "graph"):
            def call(name, *args):
                g = graphs[name]
                return g.fn(*args) if how == "eager" else g(*args)

            H = call("hess", x, b)
            W = _solve(H, torch.eye(packer.n_inner, device="cuda"))
            out[f"value_grad_{how}"] = bits(*call("value_grad", x, b))
            out[f"hess_{how}"] = bits(H)
            out[f"batch_{how}"] = bits(call("batch", x, cand))
            out[f"tail_{how}"] = bits(*call("tail", x, b, W))
            out[f"logdet_inverse_{how}"] = bits(
                torch.linalg.slogdet(H)[1], W)
        v, g, bhat = vg(X_OPT)
        out.update({"marginal_value": bits(v), "marginal_grad": bits(g),
                    "bhat": bits(bhat)})
        return out

    def fit(dtype):
        t = time.time()
        sde = SDE(**kw, device="cuda", dtype=dtype)
        res = sde.fit()
        torch.cuda.synchronize()
        return {"par": res.par.tolist(), "nllk": res.value,
                "convergence": res.convergence,
                "via": res.convergence_via, "evals": res.counts["evals"],
                "wall_s": time.time() - t,
                "names": sde.bundle().packer.outer_names()}, res

    if mode.startswith("tail"):
        return tail_repeats(torch, SDE, kw, mode)
    # "script" keeps the script's history: its first probe is the last
    row = {"mode": mode, "probes": [] if mode.startswith("script")
           else [("start", probe())]}
    if mode in ("script", "bisect", "script_det"):
        # run the script's phases, then stop where phase 3i starts
        class Reached(Exception):
            pass

        def stop(torch, card):
            raise Reached

        chip_smoke.phase_config4 = stop
        if mode == "bisect":
            def wrap(name, fn):
                def run(*a, **k):
                    row["probes"].append((f"before {name}", probe()))
                    out = fn(*a, **k)
                    row["probes"].append((f"after {name}", probe()))
                    return out
                return run

            for name in PHASES:
                setattr(chip_smoke, name, wrap(name,
                                               getattr(chip_smoke, name)))
        try:
            chip_smoke.main()
        except Reached:
            pass
    row["probes"].append(("before the fits", probe()))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        first, _ = fit(torch.float32)
        second, _ = fit(torch.float32)
    row["nondeterministic_ops"] = sorted({
        str(w.message)[:160] for w in caught
        if "deterministic" in str(w.message)})
    row.update({"f32_first": first, "f32_second": second,
                "second_equals_first": first["par"] == second["par"]})
    if mode == "plain":
        f64, res64 = fit(torch.float64)
        row["f64"] = f64
        row["se_f64"] = np.sqrt(np.diag(res64.cov_fixed)).tolist()
    return row


def tail_repeats(torch, SDE, kw, mode):
    """The "tail*" modes' row: digests of the bits of each call, in the
    order the mode makes them, on a fresh f32 config-4 model at X_OPT
    with inner coefficients 0.1 (W the inverse of the inner Hessian
    there). "tail" is the Laplace layer's own; "cross" its jacfwd of the
    inner gradient in the outer parameters and "logdet_reverse" the
    log-det partials by reverse mode over the inner Hessian, as
    infer/laplace.make_laplace took them before it took them by jacfwd."""
    import hashlib

    from torch.func import grad, jacfwd

    from smoothsde_tpu_torch.infer.coloring import colored_hessian
    from smoothsde_tpu_torch.infer.fit import make_val_grad
    from smoothsde_tpu_torch.infer.laplace import _solve
    from smoothsde_tpu_torch.twin_bench import X_OPT

    if mode == "tail_cublaslt":
        torch.backends.cuda.preferred_blas_library("cublaslt")
    if mode == "tail_cublas":
        torch.backends.cuda.preferred_blas_library("cublas")

    def calls():
        bundle = SDE(**kw, device="cuda", dtype=torch.float32).bundle()
        make_val_grad(bundle)
        packer, n_inner = bundle.packer, bundle.packer.n_inner
        x = torch.tensor(X_OPT, dtype=torch.float32, device="cuda")
        b = torch.full((n_inner,), 0.1, dtype=torch.float32, device="cuda")
        grad_b = grad(lambda o, bb: bundle.joint_nllk_ad(
            packer.unpack(o, bb)), argnums=1)
        hess_b = (jacfwd(grad_b, argnums=1) if bundle.hess_plan is None
                  else colored_hessian(grad_b, bundle.hess_plan))
        W = _solve(hess_b(x, b), torch.eye(n_inner, device="cuda"))
        tail = bundle.marginal.graphs["tail"].fn
        return {
            "tail": lambda: tail(x, b, W),
            "cross": lambda: (jacfwd(grad_b, argnums=0)(x, b),),
            "logdet_reverse": lambda: grad(lambda o, bb: 0.5 * (
                W * hess_b(o, bb)).sum(), argnums=(0, 1))(x, b),
        }

    def digest(outs):
        h = hashlib.sha1()
        for t in outs:
            h.update(t.detach().cpu().numpy(force=True).tobytes())
        return h.hexdigest()[:12]

    rev = "logdet_reverse"
    order = {"tail_parts": ["cross"] * 4 + [rev] * 4 + ["cross"] * 2,
             "tail_parts_rev": [rev] * 4 + ["cross"] * 4,
             "tail_fwd": ["tail"] * 3 + [rev] * 2 + ["tail"] * 2,
             }.get(mode, ["tail"] * 5)
    fns = calls()
    if mode == "tail_kernels":  # the CUDA kernels of two logdet calls
        from collections import Counter

        from torch.profiler import ProfilerActivity, profile

        runs = []
        for _ in range(2):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = digest(fns["logdet_reverse"]())
            runs.append((out, Counter(e.name for e in prof.events())))
        (d1, k1), (d2, k2) = runs
        return {"mode": mode, "calls": [(rev, d1), (rev, d2)],
                "only_first": dict(k1 - k2), "only_second": dict(k2 - k1)}
    if mode == "tail_ops":  # every operation's output, two logdet calls
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_leaves

        class Record(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.log = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                def floats(x):
                    return [t for t in tree_leaves(x)
                            if isinstance(t, torch.Tensor) and not t.is_meta
                            and t.is_floating_point()]

                ins = [digest([a]) for a in floats(args)]  # at use
                out = func(*args, **(kwargs or {}))
                self.log.append((str(func), digest(floats(out)), ins, [
                    (tuple(a.shape), tuple(a.stride()), str(a.dtype))
                    for a in floats(args)]))
                return out

        logs = []
        for _ in range(2):
            with Record() as rec:
                fns["logdet_reverse"]()
            logs.append(rec.log)
        first = next((i for i, (a, b) in enumerate(zip(*logs))
                      if a[:2] != b[:2]), None)
        row = {"mode": mode, "ops": [len(g) for g in logs],
               "first_difference": first}
        if first is not None:
            row["op"] = logs[0][first][0]
            row["args"] = logs[0][first][3]
            # each argument's bits at use in either call, and the earlier
            # operation of that call whose output had those bits
            for k, log in enumerate(logs):
                made = {}
                for i, entry in enumerate(log[:first]):
                    made.setdefault(entry[1], i)
                row[f"call{k + 1}_args"] = [
                    (d, made.get(d, "not made in this call"))
                    for d in log[first][2]]
        return row
    seq = [(name, digest(fns[name]())) for name in order]
    if mode == "tail_bundles":  # the same calls on a second model
        fns = calls()
        seq += [("tail, second model", digest(fns["tail"]()))
                for _ in range(3)]
    return {"mode": mode, "calls": seq}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--modes", default=",".join(MODES))
    ap.add_argument("--mode", help=argparse.SUPPRESS)  # one child process
    args = ap.parse_args()
    if args.mode:
        print("ROW " + json.dumps(run_mode(args.mode)), flush=True)
        return 0
    card = card_line()
    print(card, flush=True)
    rows = []
    for mode in args.modes.split(","):
        if mode not in MODES:
            raise SystemExit(f"unknown mode {mode!r}; one of {MODES}")
        env = dict(os.environ)
        if mode == "nocache":
            env["PYTORCH_NO_CUDA_MEMORY_CACHING"] = "1"
        if mode in ("fill", "script_det", "tail_ws"):
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--mode", mode],
            capture_output=True, text=True, env=env, timeout=1200)
        row = next((json.loads(line[4:]) for line in out.stdout.splitlines()
                    if line.startswith("ROW ")), None)
        if row is None:
            print(f"{mode}: exit {out.returncode}\n{out.stderr[-4000:]}",
                  flush=True)
            rows.append({"mode": mode, "failed": out.returncode})
            continue
        rows.append(row)
        print(json.dumps(row), flush=True)
        probes = row.get("probes", [])
        for (a, pa), (b, pb) in zip(probes, probes[1:]):
            moved = [k for k in pa if pa[k] != pb[k]]
            if moved:
                print(f"{mode}: {moved} changed between {a!r} and {b!r}",
                      flush=True)
        if probes:
            print(f"{mode} probes: {probes[0]} ... {probes[-1]}",
                  flush=True)
        for msg in row.get("nondeterministic_ops", []):
            print(f"{mode} warned: {msg}", flush=True)
    last = {r["mode"]: r["probes"][-1][1] for r in rows if r.get("probes")}
    for mode, pr in last.items():
        print(f"before the fits, {mode}: {pr}", flush=True)
    ref = next((r for r in rows if "f64" in r), None)
    if ref is not None:
        se = np.array(ref["se_f64"])
        p64 = np.array(ref["f64"]["par"])
        for r in rows:
            for key in ("f32_first", "f32_second"):
                if key in r:
                    d = (np.array(r[key]["par"]) - p64) / se
                    r[key]["over_se64"] = d.tolist()
                    print(f"{r['mode']} {key}: nllk {r[key]['nllk']!r}, "
                          f"f64 standard errors {np.round(d, 4).tolist()}",
                          flush=True)
    print(json.dumps({"card": card, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
