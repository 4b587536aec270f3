"""One rank of the port's multi-process runs, for
tests/test_torch_multiprocess.py: the data (NumPy, from seeds), and
`run`, which joins a gloo group of two processes on the CPU, builds each
case on a ("dcn", axis) mesh of two CPU shards a process (fits with
optimizer="scipy" and "device" among them), and writes its results to
<out>/rank<r>.npz. Imports torch and the port only (the
parent test holds the results against the JAX package).
"""

import numpy as np

# the time cases' length and the cut of BASELINE config 4 (8 tracks)
N_TIME = 2000
N_PER = 60


def config4_cut(n_per=N_PER, seed=3):
    """BASELINE config 4's data (tools/bench_configs.py config4: 8 CTCRW
    tracks, tau_k = 3 exp(0.3 z_k), seed 3), n_per steps a track, and its
    SDE keywords (`tau ~ s(ID, bs='re')`)."""
    from smoothsde_tpu_torch.utils.misc import ctcrw_cov

    rng = np.random.default_rng(seed)
    rows = {"ID": [], "time": [], "y1": [], "y2": []}
    for k in range(8):
        tau_k = 3.0 * np.exp(rng.normal() * 0.3)
        beta = 1 / tau_k
        sigma = 2 / np.sqrt(np.pi * tau_k)
        times = np.cumsum(rng.uniform(0.3, 0.8, size=n_per))
        v, z = np.zeros(2), np.zeros(2)
        obs = np.empty((n_per, 2))
        obs[0] = 0
        for i in range(1, n_per):
            dt = times[i] - times[i - 1]
            e = np.exp(-beta * dt)
            V = ctcrw_cov(beta, sigma, dt)
            for d in range(2):
                mv, mz = e * v[d], z[d] + v[d] / beta * (1 - e)
                v[d], z[d] = rng.multivariate_normal([mv, mz], V)
            obs[i] = z + rng.normal(size=2) * 0.1
        rows["ID"] += [f"a{k}"] * n_per
        rows["time"] += times.tolist()
        rows["y1"] += obs[:, 0].tolist()
        rows["y2"] += obs[:, 1].tolist()
    data = {k: np.asarray(v) for k, v in rows.items()}
    return dict(formulas={"mu1": "~1", "mu2": "~1",
                          "tau": "~s(ID, bs='re')", "nu": "~1"},
                data=data, type="CTCRW", response=["y1", "y2"],
                par0=[0.0, 0.0, 2.0, 0.8])


def time_case(kind, n=N_TIME, seed=21):
    """One long track of n irregular steps with a NaN row: a CTCRW (2-D)
    or an OU_SSM (2-D) and its SDE keywords."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.2, 0.8, size=n))
    if kind == "CTCRW":
        obs = np.cumsum(rng.normal(size=(n, 2)) * 0.3, axis=0)
        par0 = [0.0, 0.0, 1.0, 0.5]
    else:
        obs = np.empty((n, 2))
        obs[0] = rng.normal(size=2)
        for i in range(1, n):
            e = np.exp(-(times[i] - times[i - 1]) / 2.0)
            obs[i] = e * obs[i - 1] + np.sqrt(1 - e * e) * rng.normal(size=2)
        obs = obs + 0.1 * rng.normal(size=(n, 2))
        par0 = [0.0, 0.0, 1.0, 0.5]
    obs[n // 3] = np.nan
    data = {"ID": np.zeros(n, int), "time": times, "y1": obs[:, 0],
            "y2": obs[:, 1]}
    return dict(data=data, type=kind, response=["y1", "y2"], par0=par0)


def point(packer, seed, scale):
    """A point near the initial values: (outer, inner)."""
    rng = np.random.default_rng(seed)
    outer = packer.outer_init() + scale * rng.normal(
        size=packer.outer_init().shape)
    inner = packer.inner_init() + scale * rng.normal(
        size=packer.inner_init().shape)
    return outer, inner


def value_grads(bundle, outer, inner):
    """[joint nllk, the twin's joint nllk], d/d outer, d/d inner."""
    import torch

    def tensor(x):
        return torch.tensor(x, dtype=bundle.dtype, device=bundle.device,
                            requires_grad=True)

    o, i = tensor(outer), tensor(inner)
    v = bundle.joint_nllk(bundle.packer.unpack(o, i))
    go, gi = torch.autograd.grad(v, (o, i), allow_unused=True)
    gi = torch.zeros_like(i) if gi is None else gi
    with torch.no_grad():
        ad = bundle.joint_nllk_ad(bundle.packer.unpack(o, i))
    return (np.array([float(v.detach()), float(ad)]),
            go.double().cpu().numpy(), gi.double().cpu().numpy())


def marginal(bundle, outer, inner):
    """The Laplace marginal's [value] and gradient at outer (the inner
    solve from `inner`)."""
    from smoothsde_tpu_torch.infer.fit import make_val_grad

    v, g, _ = make_val_grad(bundle)(outer, inner)
    return np.array([v]), g


FIT_CASE = "OU_SSM"
FIT_MAXITER = 30


def re_tracks(seed=7, K=8, Lk=60):
    """K Brownian tracks of Lk irregular steps, each with its own drift
    mu_k = 0.5 + 0.4 z_k, and the SDE keywords of a BM with `mu ~ s(ID,
    bs='re')`: a Laplace model (K inner coefficients) whose marginal costs
    milliseconds on the CPU."""
    rng = np.random.default_rng(seed)
    rows = {"ID": [], "time": [], "z": []}
    for k in range(K):
        mu_k = 0.5 + 0.4 * rng.normal()
        t = np.cumsum(rng.uniform(0.4, 0.6, Lk))
        dt = np.diff(t)
        z = np.concatenate([[0.0], np.cumsum(
            mu_k * dt + 0.8 * np.sqrt(dt) * rng.normal(size=Lk - 1))])
        rows["ID"] += [f"a{k}"] * Lk
        rows["time"] += t.tolist()
        rows["z"] += z.tolist()
    data = {k: np.asarray(v) for k, v in rows.items()}
    return dict(formulas={"mu": "~s(ID, bs='re')", "sigma": "~1"},
                data=data, type="BM", response="z", par0=[0.5, 1.0])


def graph_name(a):
    """`device_graph` back from fit_arrays' bytes."""
    return bytes(np.asarray(a, np.uint8)).decode()


def fit_arrays(tag, fit):
    """A FitResult's `par`, `value`, `convergence`, `device_steps`,
    `device_graph` (its UTF-8 bytes) and `counts` (its values in key
    order) as arrays under `tag`_*."""
    return {f"{tag}_par": fit.par, f"{tag}_value": np.array([fit.value]),
            f"{tag}_conv": np.array([fit.convergence]),
            f"{tag}_steps": np.array([fit.device_steps]),
            f"{tag}_graph": np.frombuffer(
                str(fit.device_graph).encode(), np.uint8),
            f"{tag}_counts": np.array([fit.counts[k]
                                       for k in sorted(fit.counts)])}


def run(rank, world, store, out):
    """Rank `rank` of `world` processes (a FileStore at `store`): every
    case of the module docstring, written to <out>/rank<rank>.npz."""
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.parallel.batching import Mesh, auto_mesh

    f64 = torch.float64
    res = {"auto_shape": np.array(list(auto_mesh("time", "cpu")
                                       .shape.values()))}
    kw = config4_cut()
    b = SDE(**kw, device="cpu", dtype=f64).setup(
        mesh=Mesh(["cpu"] * 2, ("dcn", "tracks")), mesh_axis="tracks")
    outer, inner = point(b.packer, 4, 0.2)
    res["tracks_v"], res["tracks_go"], res["tracks_gi"] = value_grads(
        b, outer, inner)
    res["tracks_mv"], res["tracks_mg"] = marginal(b, outer, inner)
    for kind in ("CTCRW", "OU_SSM"):
        b = SDE(**time_case(kind), device="cpu", dtype=f64).setup(
            mesh=Mesh(["cpu"] * 2, ("dcn", "time")), mesh_axis="time")
        outer, inner = point(b.packer, 5, 0.1)
        res[f"{kind}_v"], res[f"{kind}_go"], _ = value_grads(b, outer,
                                                             inner)
    fit = SDE(**time_case(FIT_CASE), device="cpu", dtype=f64).fit(
        mesh="auto", mesh_axis="time", maxiter=FIT_MAXITER)
    res.update(fit_par=fit.par, fit_value=np.array([fit.value]),
               fit_cov=fit.cov_fixed)
    dev = SDE(**time_case(FIT_CASE), device="cpu", dtype=f64).fit(
        mesh=Mesh(["cpu"] * 2, ("dcn", "time")), mesh_axis="time",
        optimizer="device", maxiter=FIT_MAXITER)
    res.update(fit_arrays("dev_time", dev), dev_time_cov=dev.cov_fixed)
    dev_re = SDE(**re_tracks(), device="cpu", dtype=f64).fit(
        mesh=Mesh(["cpu"] * 2, ("dcn", "tracks")), mesh_axis="tracks",
        optimizer="device", compute_sdreport=False)
    res.update(fit_arrays("dev_tracks", dev_re), dev_tracks_bhat=dev_re.bhat)
    np.savez(f"{out}/rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def run_card(rank, world, store, out):
    """Rank `rank` of `world` processes on cuda:0, for the card test: the
    time cases' f64 joint nllk and gradient on a ("dcn", "time") mesh of
    two shards a process, the kernels each process launched for them,
    and an f64 optimizer="device" fit of FIT_CASE on that mesh, written
    to <out>/card<rank>.npz."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.parallel.batching import Mesh

    res = {}
    for kind in ("CTCRW", "OU_SSM"):
        b = SDE(**time_case(kind), device="cuda", dtype=torch.float64).setup(
            mesh=Mesh(["cuda:0"] * 2, ("dcn", "time")), mesh_axis="time")
        outer, inner = point(b.packer, 5, 0.1)
        cf.reset_launches()
        res[f"{kind}_v"], res[f"{kind}_go"], _ = value_grads(b, outer, inner)
        res[f"{kind}_launches"] = np.array(
            [n for n in cf.LAUNCHES.values() if n])
    fit = SDE(**time_case(FIT_CASE), device="cuda", dtype=torch.float64).fit(
        mesh=Mesh(["cuda:0"] * 2, ("dcn", "time")), mesh_axis="time",
        optimizer="device", maxiter=FIT_MAXITER)
    res.update(fit_arrays("dev_time", fit))
    np.savez(f"{out}/card{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()
