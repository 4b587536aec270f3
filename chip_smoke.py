#!/usr/bin/env python3
"""Smoke run of smoothsde_tpu_torch (the PyTorch / CUDA port) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (or
another sm_90a card) and the CUDA toolkit. Phases; any failure exits
non-zero before the final line:

  1. card and build: prints the card's name and power limit
     (nvidia-smi), compiles csrc/*.cu with nvcc (ops/_kernels.py);
  2. kernels against their plain PyTorch versions on the card, through
     the autograd.Function (value + gradient): two tracks with NaN rows
     and irregular dt, d in {1, 2, 3}, n in {80, 5,000, 200,000};
     f64 kernels vs f64 plain (value rtol 1e-10, gradient 1e-8 of the
     largest component), f32 kernels vs f64 plain (1e-4 relative, the
     docs/ACCURACY.md bar);
     the same checks for the element-space CTCRW path, value + gradient
     through `llk2_analytic` with scan="fused" (K4a, K2, K4b / K5a, K2,
     K5b) and scan="pallas" (K8 and K2 in both directions), each kernel
     of the path launched at every shape; and for the scalar-state
     BM_SSM and OU_SSM kernels through DiagFusedCore / DiagPlainCore;
     2b. the cross-block prefix K2 alone against its plain version: all
     six element kinds in both directions, d in {1, 2, 3}, NB around its
     256-block tile (1, 255, 256, 257, 773) and 31,250, the square-root
     kinds also around the run design's run of 4 blocks and tile of 512
     (3, 4, 5, 511, 512, 513, 1,541); f64 within 1e-10 and f32 (against
     the f64 plain version) within 1e-5 of the output's scale; then its
     time at the diag fits' shapes (d = 2 and d = 1, NB = 31,250), for
     the square-root kinds also in f64 and by CUDA kernel;
     2c. the backward kernels K3a and K3b alone against their plain
     versions: d in {1, 2, 3}, n in {80, 2,048, 5,000, 20,001} (lanes
     below, at and across their 64-lane tile, not a multiple of 4) and
     lanes cut to L in {1, 3} steps (below and across their 2-step
     chunk); f64 within 1e-10 and f32 (against the f64 plain version)
     within 1e-4 of the output's scale;
     2d. the forward kernels K1a and K1b alone against their plain
     versions, at the shapes and with the bars of 2c (lanes below, at and
     across their 128-lane CUDA block; L = 1 leaves no next step to
     prefetch);
     2e. the scalar-state kernels D1a, D1b, D3a and D3b alone against
     their plain versions (BM_SSM at d = 1, OU_SSM at d = 2 and 3), at the
     shapes and with the bars of 2c (lanes below, at and across the
     32-lane CUDA blocks of D1a, D1b and D3a and D3b's 128-lane one; L = 1
     leaves three of their four segments empty and no next step to load
     ahead), and at L = 5 and 27 (the last segments short: 2, 2, 1, 0 and
     7, 7, 7, 6 steps) and 8, 16 and 24 (L = 32's segment boundaries; 2
     to 6 steps a segment); D1b from D1a's segment totals;
  3. the CTCRW slice at full size: a 1M-step 2-D CTCRW (dt = 0.1,
     tau = 3, nu = 1, sigma_obs = 0.1, seed 5), simulated here with
     NumPy, fitted by `SDE(..., device="cuda").fit()` in f32; requires
     convergence, tau and nu within 5% of the truth, every CTCRW kernel
     launched by the fit, and the f32 nllk (1e-4 relative) and gradient
     (1e-4 of |nllk|: the gradient vanishes at the optimum, so its f32
     roundoff is measured against the objective's scale, as the fit's
     gtol rule does) against the f64 plain version on the card;
     3b. a 1M-step 2-D OU_SSM (dt = 0.1, mu = (1, -0.5), tau = 2,
     kappa = 1, sigma_obs = 0.1, seed 8) and 3c. a 1M-step 1-D BM_SSM
     (dt ~ U(0.4, 0.6), mu = 0.05, sigma = 0.3, sigma_obs = 0.1, seed 9),
     each fitted in f32 with the same gates (tau, kappa, sigma within 5%,
     each mu within 0.05 absolute, every diag kernel launched);
     3d. the element-space path at config 5a's full width (1M steps,
     d = 2, f32), launch counts from zero: `llk2_analytic` "fused" and
     "pallas" value + gradient at the optimum and at the start point,
     and `sde.smoothed_states()`; gates: f32 nllk (1e-4 relative) and
     gradient (1e-4 of |nllk|) against the f64 plain version, smoothed
     means and covariances against the f64 plain Hillis-Steele scan to
     the PERF.md bar (positions 1e-5 of the largest, velocities and
     covariances 1e-3 of the largest), f64 kernels against
     the par-space CtcrwFusedCore in f64 (value 1e-10, gradient 1e-8 of
     its largest component over the two points), every element-space
     kernel and K8 launched;
     3e. f32 accuracy at the JAX package's own audit point
     (tools/accuracy_audit.py's data, regenerated: 1M steps, theta =
     (0.05, -0.02, log 2, 0)): `ctcrw_loglik_soa(scan="fused",
     analytic_grad=True)` in f32 against its plain version in f64 on the
     card, nllk (1e-4 relative) and gradient (1e-4 of |nllk|) gated, the
     per-component errors printed beside docs/ACCURACY.md's TPU figures;
     3f-3h. the closed-form family (plain torch ops, no hand-written
     kernel: the JAX package's densities reach no pallas_call), with the
     data of the JAX package's tools/bench_configs.py simulated here with
     its seeds: 3f. config 1, BM (n = 1,000), fitted in f32 and f64:
     convergence, sigma within 5% of 0.8, the f32 estimates within 1e-3
     of the f64 fit's; 3g. config 2, OU with s(time, k=8, bs='cs') on mu
     and kappa (n = 3,000), the Laplace approximation in f32 and f64:
     convergence, tau within 5% of 2, the f32 nllk within 1e-4 relative
     of the f64 fit's, bhat and cov_fixed finite; 3h. config 5b, the
     1M-step CIR (mu 2, beta 0.8, sigma 0.5, seed 6) in f32: convergence,
     each parameter within 5%, the f32 nllk (1e-4 relative) and gradient
     (1e-4 of |nllk|) against the f64 evaluation on the card at the
     optimum and the start; then its nllk+grad wall (110 calls), device
     busy share and device operations per call (profiler) and peak
     memory, on the SUMMARY line under "closed_form";
     3l. the API tail at config 4 from 3i's f32 fit (no refit): the
     joint covariance, pointwise and simultaneous CIs over all 2,000 rows
     (n_post 1,000), par(term=), linear_predictor, make_mat_grid("ID"),
     log_lik (a forward pass through K1a, K2, K1b, gated to launch those
     once each), edf_conditional, AIC, BIC, simulate(posterior=True),
     check_post (20 simulations), save_state and load_state into a new
     f64 model; gates: f32 against f64 at the same checkpoint, log_lik
     1e-4 and edf 1e-3 relative; the f64 log_lik through the kernels
     against the twin's -joint_nllk_unpenalized, 1e-10 relative; the
     reloaded model's CIs bit for bit; prints each call's seconds;
     3m. fit(optimizer="device") at config 5a (each L-BFGS step one CUDA
     graph, one host read) and optimizer="auto" at config 2 (resolves to
     "device"); gates: convergence, 5a's tau and nu and config 2's tau
     within 5%, the final nllk within 1e-4 relative of the scipy fits of
     3 and 3g, 5a's steps a graph; prints walls, iterations, evaluations,
     kernel launches and host reads per iteration, the idle share;
     3n. the square-root filter at config 5a: the f32 fit with
     setup(kalman_impl="sqrt") (convergence, tau and nu within 5%, nllk
     within 1e-4 relative of phase 3's); at 3e's audit point
     `ctcrw_loglik_sqrt` f32 value + gradient against f64 (1e-4 /
     1e-4 of |nllk|, printed beside docs/ACCURACY.md's "f32 sqrt (tpu)"
     column); scan="pallas" (K8 and K2 `sqrt2` / `sqrt1` / Elem5)
     against "blocked" for `ctcrw_loglik_sqrt` at 5a and
     `diag_ssm_loglik_sqrt` / `diag_ssm_loglik_soa` at 3b's OU_SSM (f64
     1e-10, f32 1e-4 relative), each kernel launched, and a gradient
     through "pallas" raises;
     3o. user H: config 5a's latent path with a per-row Argos-style H
     (seed 15), fitted in f32 and f64 by the parallel full-state filter
     ("auto"); gates convergence, the f64 fit's tau and nu within 5% (the
     f32 fit's printed: the JAX package's f32 stopping rule ends it
     early, PERF.md), f32 nllk and gradient against f64 at the f32
     optimum (1e-4 / 1e-4 of |nllk|); `filtered_states()` and
     `residuals()` on it and on phase 3's fit, f32 against f64, finite
     exactly where the JAX package gives finite (the states within 1e-3
     of the largest, the residuals within 0.1 absolute, a tenth of their
     N(0, 1) scale); prints each call's wall;
     3p. ESEAL_SSM, 16 tracks x 1,000 dives of tests/test_models_fit.py
     `_eseal_sim`'s model (per-track seeds, h and R varying by dive),
     f32, a1 / log_a2 pinned: with priors=None mu, sigma, tau at
     TestESEAL.test_recovery's bars; with the default priors convergence
     and the f32 nllk within 1e-4 of f64's;
     3q. sharding, 4 shards on cuda:0 (parallel/): the 5a CTCRW and
     the 3b OU_SSM fitted with their time axis in 4 chunks (f32; gates:
     convergence, the truth as phases 3 / 3b, the nllk within 1e-4 of
     the unsharded fit's; at the start f64 sharded against unsharded
     kernels 1e-10 / 1e-8 of the largest gradient component and f32
     against the f64 plain version 1e-4 / 1e-4 of |nllk|; each of the
     six kernels launched once a chunk per nllk+grad; prints both walls,
     device busy and the stitch's own device time), config 4 by tracks
     (f32 fit: convergence, nllk within 1e-4 of 3i's; f64 joint nllk
     and twin at the golden point against unsharded, 1e-10 / 1e-8), 3k's
     BM by tracks
     (nllk within 1e-4 of 3k's) and 3p's ESEAL data on the time-sharded
     full-state filter (f64 value and gradient against the unsharded
     route, 1e-10 / 1e-8);
     3r. the multi-process ("dcn", axis) mesh: two processes spawned on
     the one card (torch.multiprocessing, gloo, a FileStore in a
     temporary directory), two shards on cuda:0 each: the 5a CTCRW and
     3b OU_SSM with their time axis in 2 x 2 chunks (f64 nllk and
     gradient at the start against the one-process unsharded kernels,
     1e-10 / 1e-8 of the largest component; f32 fits converged, nllk
     within 1e-4 of the unsharded fits'; each kernel launched twice a
     process per nllk+grad; the walls beside 3q's; f32
     optimizer="device" fits, every step eager, converged with the nllk
     within 1e-4 of 3m's device fit (5a) and of the unsharded fit (3b),
     their walls beside the scipy fits') and config 4 by
     tracks (f64 joint nllk and twin against one process, and the
     Laplace marginal against 3i's at the golden point, 1e-10 / 1e-8);
     both ranks' results equal bit for bit; a failure or hang of either
     process fails the phase;
     3s. BASELINE config 3, one 2-D CTCRW track of 1,500 irregular
     steps (tools/bench_configs.py config3's data, seed 2), fitted in
     f32 and f64: convergence, tau and nu within 5%, the f32 nllk within
     1e-4 of f64's, every CTCRW kernel launched;
     3t. fit(profile_dir=...) at 5a writes a torch.profiler trace
     naming each CUDA kernel of the path, timings under the JAX stage
     names; sdreport_mode "device" (the FD points stacked on the card)
     against "host" in f64 at 5a and config 2, within 1e-6 of the
     largest entry;
     2f. (run after 2e) K8 alone for the scalar-state and square-root
     kinds (diag_filter, diag_smooth, sqrt2, sqrt1), both directions,
     d in {1, 2, 3}, lanes around its 128-thread block: f64 within 1e-10
     and f32 within 1e-4 of the scale;
  4. each kernel against its plain version at its fit's shapes (the
     diag kernels at both the OU_SSM and the BM_SSM fit's, the
     element-space kernels and K8 at config 5a's; f64, max abs error
     within 1e-8 of the output's scale; the diag kernels in f32 too,
     within 1e-4), and times on the card: each
     kernel and its plain version (CUDA events; the CTCRW kernels in
     f64 too), nllk + grad at 1M steps (host wall time per call, median
     and p90, kernels and plain; the element-space "fused" and "pallas"
     beside the par-space core),
     `smoothed_states()` at 1M, device time per kernel and the device's
     busy share (torch.profiler; the CTCRW path in f64 too), the fits.
     Each fit counts its launches from zero.

The line before last is the card as nvidia-smi reports it, the one
before that a JSON object {"kernels": [...]} (per kernel: launches on its
main path, f64 error against the plain version, ms and plain_ms from CUDA
events, device_ms from the profiler, bytes and bound_us / bound_ms /
bound_by from `bound`, share = bound_ms / device_ms, library_ms null; the
CTCRW kernels also ms_f64 and device_ms_f64, K2 `sqrt2` / `sqrt1` ms_f64
and bound_ms_f64 and, from 2b at d = 2, their device us by CUDA kernel
(split_us_ou_ssm_shape, split_us_f64_ou_ssm_shape); the CTCRW and
scalar-state kernels their launches on 3q's time-sharded fit and per sharded
nllk+grad, and on 3r's two-process fit and nllk+grad (rank 0's), the
CTCRW kernels on 3s's fit), and the last line
{"ok": true, "device": {...}}. It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
P0_POS, P0_VEL = 1.0, 10.0
TPU_KERNEL = "smoothsde_tpu/ops/ctcrw_fused.py"
DIAG_TPU_KERNEL = "smoothsde_tpu/ops/diag_fused.py"
CTCRW_KERNELS = [
    # (name, source, pallas_call it replaces)
    ("ctcrw_filter_totals", "smoothsde_tpu_torch/csrc/ctcrw_filter.cu",
     f"{TPU_KERNEL}:731"),
    ("block_prefix_filter", "smoothsde_tpu_torch/csrc/block_prefix.cu",
     f"{TPU_KERNEL}:294"),
    ("ctcrw_filter_scan", "smoothsde_tpu_torch/csrc/ctcrw_filter.cu",
     f"{TPU_KERNEL}:842"),
    ("ctcrw_smooth_totals", "smoothsde_tpu_torch/csrc/ctcrw_backward.cu",
     f"{TPU_KERNEL}:1525"),
    ("block_prefix_smooth", "smoothsde_tpu_torch/csrc/block_prefix.cu",
     f"{TPU_KERNEL}:294"),
    ("ctcrw_score_scan", "smoothsde_tpu_torch/csrc/ctcrw_backward.cu",
     f"{TPU_KERNEL}:1720"),
]
DIAG_KERNELS = [
    ("diag_filter_totals", "smoothsde_tpu_torch/csrc/diag_filter.cu",
     f"{DIAG_TPU_KERNEL}:283"),
    ("block_prefix_diag_filter", "smoothsde_tpu_torch/csrc/block_prefix.cu",
     f"{TPU_KERNEL}:294"),
    ("diag_filter_scan", "smoothsde_tpu_torch/csrc/diag_filter.cu",
     f"{DIAG_TPU_KERNEL}:369"),
    ("diag_smooth_totals", "smoothsde_tpu_torch/csrc/diag_backward.cu",
     f"{DIAG_TPU_KERNEL}:481"),
    ("block_prefix_diag_smooth", "smoothsde_tpu_torch/csrc/block_prefix.cu",
     f"{TPU_KERNEL}:294"),
    ("diag_score_scan", "smoothsde_tpu_torch/csrc/diag_backward.cu",
     f"{DIAG_TPU_KERNEL}:588"),
]
SCAN_TPU_KERNEL = "smoothsde_tpu/ops/scan_utils.py"
ELEM_SRC = "smoothsde_tpu_torch/csrc/elem_fused.cu"
PHASE1_SRC = "smoothsde_tpu_torch/csrc/phase1_scan.cu"
ELEM_KERNELS = [
    ("elem_filter_totals", ELEM_SRC, f"{TPU_KERNEL}:410"),
    ("elem_filter_scan", ELEM_SRC, f"{TPU_KERNEL}:525"),
    ("elem_smooth_totals", ELEM_SRC, f"{TPU_KERNEL}:1105"),
    ("elem_score_scan", ELEM_SRC, f"{TPU_KERNEL}:1260"),
    ("phase1_scan_filter", PHASE1_SRC, f"{SCAN_TPU_KERNEL}:81"),
    ("phase1_scan_smooth", PHASE1_SRC, f"{SCAN_TPU_KERNEL}:81"),
]
# the kernels llk2_analytic (value + gradient) launches, per scan
ELEM_PATH = {
    "fused": ("elem_filter_totals", "block_prefix_filter", "elem_filter_scan",
              "elem_smooth_totals", "block_prefix_smooth", "elem_score_scan"),
    "pallas": ("phase1_scan_filter", "block_prefix_filter",
               "phase1_scan_smooth", "block_prefix_smooth"),
}
PREFIX_SRC = "smoothsde_tpu_torch/csrc/block_prefix.cu"
# the instantiations of K8 and K2 the generic and special filters add
# (the scalar-state and square-root elements)
SLICE_KERNELS = [
    ("phase1_scan_diag_filter", PHASE1_SRC, f"{SCAN_TPU_KERNEL}:81"),
    ("phase1_scan_diag_smooth", PHASE1_SRC, f"{SCAN_TPU_KERNEL}:81"),
    ("phase1_scan_sqrt2", PHASE1_SRC, f"{SCAN_TPU_KERNEL}:81"),
    ("phase1_scan_sqrt1", PHASE1_SRC, f"{SCAN_TPU_KERNEL}:81"),
    ("block_prefix_sqrt2", PREFIX_SRC, f"{TPU_KERNEL}:294"),
    ("block_prefix_sqrt1", PREFIX_SRC, f"{TPU_KERNEL}:294"),
]
# the kernels of each "pallas" path of phase 3n (value only)
SLICE_PATH = {
    "ctcrw_sqrt": ("phase1_scan_sqrt2", "block_prefix_sqrt2"),
    "ou_sqrt": ("phase1_scan_sqrt1", "block_prefix_sqrt1"),
    "ou_soa": ("phase1_scan_diag_filter", "block_prefix_diag_filter"),
}
KERNELS = CTCRW_KERNELS + DIAG_KERNELS + ELEM_KERNELS + SLICE_KERNELS
P0_DIAG = 10.0
# What each kernel's function must move and compute, counted from
# csrc/ (each source's head note): values per lane-step (stack rows and
# moments read, moments or cotangents written), values per lane (boundary
# rows, totals, prefixes read or written, llk / h partials), and flops per
# lane-step and per lane (approximate: a 14-comp combine ~150, a 9-comp
# ~50, a 5-comp ~15, a 3-comp ~5, plus the element and score algebra).
# The function's own traffic: the segment totals that D1a hands D1b in
# f32 are the design's, not the function's, and are not counted.
TRAFFIC = {
    "ctcrw_filter_totals": (8, 19, 210, 0),
    "block_prefix_filter": (0, 28, 0, 150),
    "ctcrw_filter_scan": (13, 20, 230, 0),
    "ctcrw_smooth_totals": (11, 9, 100, 0),
    "block_prefix_smooth": (0, 18, 0, 50),
    "ctcrw_score_scan": (18, 10, 300, 0),
    "diag_filter_totals": (6, 5, 25, 0),
    "block_prefix_diag_filter": (0, 10, 0, 15),
    "diag_filter_scan": (8, 6, 35, 0),
    "diag_smooth_totals": (6, 3, 12, 0),
    "block_prefix_diag_smooth": (0, 6, 0, 5),
    "diag_score_scan": (14, 4, 60, 0),
    "elem_filter_totals": (10, 14, 180, 0),
    "elem_filter_scan": (15, 15, 200, 0),
    "elem_smooth_totals": (13, 9, 100, 0),
    "elem_score_scan": (25, 10, 250, 0),
    "phase1_scan_filter": (28, 0, 150, 0),
    "phase1_scan_smooth": (18, 0, 50, 0),
    "phase1_scan_diag_filter": (10, 0, 15, 0),
    "phase1_scan_diag_smooth": (6, 0, 5, 0),
    "phase1_scan_sqrt2": (28, 0, 250, 0),
    "phase1_scan_sqrt1": (10, 0, 20, 0),
    "block_prefix_sqrt2": (0, 28, 0, 250),
    "block_prefix_sqrt1": (0, 10, 0, 20),
}
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s, f32 flop/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


# the CTCRW kernels of a value-only pass (log_lik, the probes)
FORWARD_KERNELS = ("ctcrw_filter_totals", "block_prefix_filter",
                   "ctcrw_filter_scan")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def two_track_data(d, n, seed):
    """Two tracks, NaN rows, irregular dt, per-step varying parameters."""
    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.05, 0.5, size=n))
    ids = (np.arange(n) >= (2 * n) // 5).astype(int)
    obs = np.cumsum(rng.normal(size=(n, d)) * 0.3, axis=0)
    obs[rng.integers(1, n, size=max(2, n // 50))] = np.nan
    par = np.column_stack([
        0.1 * rng.normal(size=(n, d)),
        np.log(2.0) + 0.2 * rng.normal(size=n),
        np.log(0.8) + 0.2 * rng.normal(size=n),
    ])
    return obs, times, ids, par


def config5a(n=1_000_000, sobs=0.1):
    """The 1M-step 2-D CTCRW of the JAX package's benchmark config 5a:
    exact simulation, velocity AR(1) by lfilter, dt = 0.1, tau = 3,
    nu = 1, sigma_obs = 0.1, seed 5 (sobs=0: the same latent path
    without observation noise)."""
    from scipy.signal import lfilter

    from smoothsde_tpu_torch.utils.misc import ctcrw_cov

    rng = np.random.default_rng(5)
    dt = 0.1
    tau_t, nu_t = 3.0, 1.0
    beta = 1 / tau_t
    sigma = 2 * nu_t / np.sqrt(np.pi * tau_t)
    e = np.exp(-beta * dt)
    Lc = np.linalg.cholesky(ctcrw_cov(beta, sigma, dt))
    obs = np.empty((n, 2))
    for d in range(2):
        eps = rng.normal(size=(n - 1, 2)) @ Lc.T
        v = lfilter([1.0], [1.0, -e], eps[:, 0])
        v_prev = np.concatenate([[0.0], v[:-1]])
        dz = v_prev / beta * (1 - e) + eps[:, 1]
        z = np.concatenate([[0.0], np.cumsum(dz)])
        obs[:, d] = z + rng.normal(size=n) * sobs
    return {"ID": np.zeros(n, np.int32), "time": np.arange(n) * dt,
            "y1": obs[:, 0], "y2": obs[:, 1]}


def ou_ssm_1m(n=1_000_000):
    """1M-step 2-D OU_SSM at the widths of the JAX package's own OU_SSM
    case (tests/test_dist.py): exact AR(1) simulation by lfilter from the
    stationary law, dt = 0.1, mu = (1, -0.5), tau = 2, kappa = 1,
    sigma_obs = 0.1, seed 8."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(8)
    dt, tau, kappa, sobs = 0.1, 2.0, 1.0, 0.1
    decay = np.exp(-dt / tau)
    obs = np.empty((n, 2))
    for d, mu in enumerate((1.0, -0.5)):
        eps = rng.normal(size=n) * np.sqrt(kappa * (1.0 - decay**2))
        eps[0] = rng.normal() * np.sqrt(kappa)
        z = lfilter([1.0], [1.0, -decay], eps)
        obs[:, d] = mu + z + rng.normal(size=n) * sobs
    return {"ID": np.zeros(n, np.int32), "time": np.arange(n) * dt,
            "y1": obs[:, 0], "y2": obs[:, 1]}


def bm_ssm_1m(n=1_000_000):
    """1M-step 1-D BM_SSM in the shape of the JAX package's diag kernel
    check (tools/tpu_sharded_kernel_check.py: dt ~ U(0.4, 0.6),
    sigma_obs = 0.1), simulated with a known truth by exact Gaussian
    increments: mu = 0.05, sigma = 0.3, seed 9."""
    rng = np.random.default_rng(9)
    mu, sigma, sobs = 0.05, 0.3, 0.1
    dt = rng.uniform(0.4, 0.6, size=n - 1)
    x = np.concatenate([[0.0], np.cumsum(
        mu * dt + sigma * np.sqrt(dt) * rng.normal(size=n - 1))])
    return {"ID": np.zeros(n, np.int32),
            "time": np.concatenate([[0.0], np.cumsum(dt)]),
            "y": x + rng.normal(size=n) * sobs}


# The closed-form configurations of the JAX package's benchmark
# (tools/bench_configs.py config1, config2, config5_cir), simulated as
# there, with the same seeds: (SDE keyword arguments, truth).


def config1(n=1000):
    """BM, constant parameters, an elephant-scale track (~1k steps)."""
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.4, 0.6, size=n))
    dt = np.diff(times)
    z = np.concatenate([[0.0], np.cumsum(
        0.4 * dt + 0.8 * np.sqrt(dt) * rng.normal(size=n - 1))])
    data = {"ID": np.zeros(n, int), "time": times, "z": z}
    return (dict(data=data, type="BM", response="z", par0=[0.0, 1.0]),
            {"mu": 0.4, "sigma": 0.8})


def config2(n=3000):
    """OU with spline-varying mean and variance via s(time, k=8, bs='cs')."""
    rng = np.random.default_rng(1)
    dt = 0.3
    times = np.arange(n) * dt
    mu_t = 1.0 + 0.8 * np.sin(2 * np.pi * times / times[-1])
    kap_t = np.exp(0.5 * np.cos(2 * np.pi * times / times[-1]))
    tau = 2.0
    x = np.empty(n)
    x[0] = mu_t[0]
    for i in range(1, n):
        e = np.exp(-dt / tau)
        x[i] = mu_t[i - 1] + e * (x[i - 1] - mu_t[i - 1]) + rng.normal() * \
            np.sqrt(kap_t[i - 1] * (1 - e * e))
    data = {"ID": np.zeros(n, int), "time": times, "z": x}
    sm = "~s(time, k=8, bs='cs')"
    return (dict(formulas={"mu": sm, "tau": "~1", "kappa": sm}, data=data,
                 type="OU", response="z", par0=[1.0, 1.0, 1.0]),
            {"tau": 2.0})


def config4(n_id=8, n_per=250):
    """Multi-animal CTCRW with an individual random effect on tau
    (tools/bench_configs.py `config4`, :97-136): 8 tracks of 250 fixes,
    2-D, track k's tau = 3 exp(0.3 z_k), nu = 1, dt ~ U(0.3, 0.8),
    sigma_obs = 0.1, seed 3; `tau ~ s(ID, bs='re')`."""
    from smoothsde_tpu_torch.utils.misc import ctcrw_cov

    rng = np.random.default_rng(3)
    rows = {"ID": [], "time": [], "y1": [], "y2": []}
    for k in range(n_id):
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
        rows["ID"].extend([f"a{k}"] * n_per)
        rows["time"].extend(times.tolist())
        rows["y1"].extend(obs[:, 0].tolist())
        rows["y2"].extend(obs[:, 1].tolist())
    data = {k: np.asarray(v) for k, v in rows.items()}
    return (dict(formulas={"mu1": "~1", "mu2": "~1",
                           "tau": "~s(ID, bs='re')", "nu": "~1"},
                 data=data, type="CTCRW", response=["y1", "y2"],
                 par0=[0.0, 0.0, 2.0, 0.8]),
            {"tau_pop": 3.0})


def multi_animal_bm(K=40, n_per=30, seed=9):
    """tests/test_coloring.py `_multi_animal_data`: K BM tracks, track
    k's sigma = 0.8 exp(0.3 z_k), dt ~ U(0.3, 0.8), and a uniform
    covariate x."""
    rng = np.random.default_rng(seed)
    rows = {"ID": [], "time": [], "z": [], "x": []}
    for k in range(K):
        sig_k = 0.8 * np.exp(rng.normal() * 0.3)
        t = np.cumsum(rng.uniform(0.3, 0.8, n_per))
        z = np.concatenate(
            [[0.0], np.cumsum(sig_k * np.sqrt(np.diff(t))
                              * rng.normal(size=n_per - 1))]
        )
        rows["ID"].extend([f"a{k:03d}"] * n_per)
        rows["time"].extend(t.tolist())
        rows["z"].extend(z.tolist())
        rows["x"].extend(rng.uniform(0, 1, n_per).tolist())
    return {k: np.asarray(v) for k, v in rows.items()}


def config5b(n=1_000_000):
    """The 1M-step CIR of BASELINE config 5 (part 2): exact
    noncentral-chi^2 transitions, dt = 0.1, mu = 2, beta = 0.8,
    sigma = 0.5, seed 6."""
    rng = np.random.default_rng(6)
    dt = 0.1
    mu_t, beta_t, sigma_t = 2.0, 0.8, 0.5
    c = 2 * beta_t / (sigma_t**2 * (1 - np.exp(-beta_t * dt)))
    df = 4 * beta_t * mu_t / sigma_t**2
    ebd = np.exp(-beta_t * dt)
    z = np.empty(n)
    z[0] = mu_t
    draws = rng.noncentral_chisquare
    for i in range(1, n):
        z[i] = draws(df, 2 * c * z[i - 1] * ebd) / (2 * c)
    data = {"ID": np.zeros(n, np.int32), "time": np.arange(n) * dt, "z": z}
    return (dict(data=data, type="CIR", response="z", par0=[1.5, 1.0, 0.7]),
            {"mu": 2.0, "beta": 0.8, "sigma": 0.5})


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def loglik_value_grad(core, par, sobs, data, torch):
    """(llk, d llk/d par, d llk/d sigma_obs) through one autograd core."""
    p = par.detach().clone().requires_grad_(True)
    s = sobs.detach().clone().requires_grad_(True)
    v = core.apply(p, data.yd, s * s, data.dtv, data.resetf, data.validf,
                   P0_POS, P0_VEL)
    gp, gs = torch.autograd.grad(v, (p, s))
    return float(v.detach()), gp.double().cpu().numpy(), float(gs)


def diag_value_grad(typ, core, par, sobs, data, torch):
    """loglik_value_grad for the scalar-state models (BM_SSM / OU_SSM)."""
    from smoothsde_tpu_torch.ops.diag_fused import diag_fused_loglik, diag_system

    p = par.detach().clone().requires_grad_(True)
    s = sobs.detach().clone().requires_grad_(True)
    v = diag_fused_loglik(diag_system(typ, p, None, None, None, s, data=data),
                          core)
    gp, gs = torch.autograd.grad(v, (p, s))
    return float(v.detach()), gp.double().cpu().numpy(), float(gs)


def diag_outer_value_grad(typ, bundle, core, data, x, torch):
    """outer_value_grad for the scalar-state models."""
    from smoothsde_tpu_torch.ops.diag_fused import diag_fused_loglik, diag_system

    xt = torch.tensor(x, dtype=bundle.dtype, device=bundle.device,
                      requires_grad=True)
    full = bundle.packer.unpack(xt)
    s = torch.exp(full["log_sigma_obs"][0])
    v = -diag_fused_loglik(
        diag_system(typ, bundle.par_matrix(full), None, None, None, s,
                    data=data), core)
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.double().cpu().numpy()


def elem_system(par, sobs, data):
    """The element-space CtcrwSystem of the likelihood's boundary data."""
    from smoothsde_tpu_torch.ops.kalman_soa import _ctcrw_system

    return _ctcrw_system(par, None, None, None, sobs, P0_POS, P0_VEL,
                         dt=data.dtv, yd=data.yd, reset=data.resetf > 0.5,
                         valid=data.validf > 0.5)


def elem_value_grad(scan, par, sobs, data, torch):
    """loglik_value_grad through llk2_analytic(scan); checks that every
    kernel of the path was launched (counts from zero)."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.kalman_smooth import llk2_analytic

    p = par.detach().clone().requires_grad_(True)
    s = sobs.detach().clone().requires_grad_(True)
    cf.reset_launches()
    v = llk2_analytic(elem_system(p, s, data), scan)
    gp, gs = torch.autograd.grad(v, (p, s))
    for name in ELEM_PATH[scan]:
        check(cf.LAUNCHES[name] > 0,
              f"{scan} path at d={data.yd.shape[0]} n={data.yd.shape[1]}: "
              f"{name} never launched")
    return float(v.detach()), gp.double().cpu().numpy(), float(gs)


def elem_outer_value_grad(bundle, data, x, scan, torch):
    """outer_value_grad through llk2_analytic(scan)."""
    from smoothsde_tpu_torch.ops.kalman_smooth import llk2_analytic

    xt = torch.tensor(x, dtype=bundle.dtype, device=bundle.device,
                      requires_grad=True)
    full = bundle.packer.unpack(xt)
    s = torch.exp(full["log_sigma_obs"][0])
    v = -llk2_analytic(elem_system(bundle.par_matrix(full), s, data), scan)
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.double().cpu().numpy()


def outer_value_grad(bundle, core, data, x, torch):
    """Joint nllk and its gradient in the outer vector x through `core`
    (the objective's own formula: -loglik(par_matrix), h = sigma_obs^2)."""
    xt = torch.tensor(x, dtype=bundle.dtype, device=bundle.device,
                      requires_grad=True)
    full = bundle.packer.unpack(xt)
    s = torch.exp(full["log_sigma_obs"][0])
    v = -core.apply(bundle.par_matrix(full), data.yd, s * s, data.dtv,
                    data.resetf, data.validf, P0_POS, P0_VEL)
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.double().cpu().numpy()


def cuda_ms(fn, reps, warm, torch):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_ms(fn, reps, warm):
    """Host wall time per call: median, and the 90th percentile when at
    least ten samples lie beyond it (else None), with the sample count."""
    for _ in range(warm):
        fn()
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()  # ends in a device-to-host copy, so the work is done
        ts.append((time.perf_counter() - t) * 1e3)
    p90 = float(np.percentile(ts, 90)) if reps >= 100 else None
    return {"median": float(np.median(ts)), "p90": p90, "n": reps}


def kernel_of(key):
    """KERNELS name of a profiler kernel key: K8 and K2 (its three
    kernels together) by their element type (the template argument), the
    per-lane kernels by name, diag and elem first (the CTCRW names are
    substrings of theirs)."""
    if "phase1_scan_kernel" in key:
        for elem, name in (("Elem14", "phase1_scan_filter"),
                           ("Smooth9", "phase1_scan_smooth"),
                           ("Elem5", "phase1_scan_diag_filter"),
                           ("Smooth3", "phase1_scan_diag_smooth"),
                           ("Sqrt14", "phase1_scan_sqrt2"),
                           ("Sqrt5", "phase1_scan_sqrt1")):
            if elem in key:
                return name
        return None
    if "block_prefix_" in key:  # K2's reduce, carry and rescan kernels
        for elem, name in (("Elem14", "block_prefix_filter"),
                           ("Smooth9", "block_prefix_smooth"),
                           ("Elem5", "block_prefix_diag_filter"),
                           ("Smooth3", "block_prefix_diag_smooth"),
                           ("Sqrt14", "block_prefix_sqrt2"),
                           ("Sqrt5", "block_prefix_sqrt1")):
            if elem in key:
                return name
        return None
    for n in ("filter_totals", "filter_scan", "smooth_totals", "score_scan"):
        for family in ("diag", "elem"):
            if f"{family}_{n}_kernel" in key:
                return f"{family}_{n}"
        if f"{n}_kernel" in key:
            return f"ctcrw_{n}"
    return None


def profile_device_ms(fn, reps, torch, stats=None):
    """Device time per call of every kernel of the port (by KERNELS name)
    and the device's busy share of the wall time, from torch.profiler
    over `reps` calls of fn (after one warm-up call). `stats`, when
    given, receives "device_ops": the device operations (kernels, copies,
    fills) per call, "kernel_counts" and "cuda_kernels": device us per
    call by the port's CUDA kernel name (with the element type of K8 and
    K2's kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    per_kernel = {name: 0.0 for name, _, _ in KERNELS}
    by_cuda = {}
    busy_us = 0.0
    ops = 0
    top = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        busy_us += us
        ops += e.count
        key = e.key
        top.append((us / reps, e.count // reps, key[:90]))
        name = kernel_of(key)
        if name is not None:
            per_kernel[name] += us
        if "ssde::" in key:  # "<kernel> <element type>" for K8 and K2
            parts = [q.split("<")[0] for q in key.split("ssde::")[1:3]]
            cuda = " ".join(parts)
            by_cuda[cuda] = by_cuda.get(cuda, 0.0) + us / reps
    for us, count, key in sorted(top, reverse=True)[:15]:
        log(f"    {us:9.1f} us  x{count:3d}  {key}")
    if stats is not None:
        stats["device_ops"] = ops / reps
        stats["cuda_kernels"] = by_cuda
        stats["kernel_counts"] = {
            name: sum(e.count for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")
                      and kernel_of(e.key) == name) / reps
            for name, _, _ in KERNELS}
    return ({k: v / 1e3 / reps for k, v in per_kernel.items()},
            busy_us / 1e3 / reps, wall_ms / reps)


def bound(name, p, itemsize):
    """The least time the card could take for kernel `name`'s function
    at plan p: the larger of its bytes (each input read once, each output
    written once) over the HBM rate and its flops over the f32 peak. No
    single PyTorch call computes these non-commutative scans of 3-14
    component elements, so library_ms is None for every kernel."""
    per_step, per_lane, fl_step, fl_lane = TRAFFIC[name]
    lane_steps = p.L * p.lanes
    nbytes = itemsize * (per_step * lane_steps + per_lane * p.lanes)
    t_bytes = nbytes / HBM_BPS
    t_ops = (fl_step * lane_steps + fl_lane * p.lanes) / F32_FLOPS
    t = max(t_bytes, t_ops)
    return {"bytes": nbytes, "bound_us": t * 1e6, "bound_ms": t * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def flat(out, torch):
    if isinstance(out, tuple):
        return torch.cat([o.reshape(-1) for o in out])
    return out.reshape(-1)


def ctcrw_kernel_calls(torch, bun, dat, x, inner=None):
    """The six CTCRW kernels' calls on the stack that bundle `bun` builds
    from `dat` (prepare_ctcrw_data) at outer x and inner coefficients
    `inner` (their initial values if None): (plan, {name: fn(op table)}).
    Each input comes from the kernels' own upstream outputs, as on the
    fit's path. Call under torch.no_grad()."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    ops_k = cf.OPS["kernels"]
    as_t = partial(torch.tensor, dtype=bun.dtype, device=bun.device)
    full = bun.packer.unpack(as_t(x), None if inner is None else as_t(inner))
    pm = bun.par_matrix(full)
    h1 = (torch.exp(full["log_sigma_obs"][0]) ** 2).reshape(1)
    p = cf.plan(2, pm.shape[0])
    stack, bd = cf.par_stack_from_data(pm, dat.yd, dat.dtv, dat.resetf,
                                       dat.validf, p)
    tot = ops_k.filter_totals(stack, bd, h1, P0_POS, P0_VEL)
    pre = ops_k.block_prefix(tot, 2, "filter", False)
    mom, _ = ops_k.filter_scan(stack, bd, pre, h1, P0_POS, P0_VEL)
    stot = ops_k.smooth_totals(stack, mom)
    suf = ops_k.block_prefix(stot, 2, "smooth", True)
    return p, {
        "ctcrw_filter_totals": lambda o: o.filter_totals(
            stack, bd, h1, P0_POS, P0_VEL),
        "block_prefix_filter": lambda o: o.block_prefix(
            tot, 2, "filter", False),
        "ctcrw_filter_scan": lambda o: o.filter_scan(
            stack, bd, pre, h1, P0_POS, P0_VEL),
        "ctcrw_smooth_totals": lambda o: o.smooth_totals(stack, mom),
        "block_prefix_smooth": lambda o: o.block_prefix(
            stot, 2, "smooth", True),
        "ctcrw_score_scan": lambda o: o.score_scan(
            stack, mom, suf, h1, P0_POS),
    }


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels_vs_plain(torch, variants, prepare, n_extra=2):
    """variants: {tag: (dtype, value_grad)} with value_grad(par, sobs,
    data, torch) -> (llk, dpar, dsobs); "ref" is the f64 plain version,
    the others are held to it: f64 ones (value rtol 1e-10, gradient 1e-8
    of the largest component), f32 ones (1e-4, 1e-4). n_extra: the
    model's parameters beyond the d mus (2 for CTCRW and OU_SSM: the two
    log-scale columns; 1 for BM_SSM: the first)."""
    dev = torch.device("cuda")
    worst = {f"{tag}_{q}": 0.0 for tag in variants if tag != "ref"
             for q in ("val", "grad")}
    for d in (1, 2, 3):
        for n in (80, 5_000, 200_000):
            obs, times, ids, par = two_track_data(d, n, seed=100 * d + n % 97)
            par = par[:, :d + n_extra]
            res = {}
            for tag, (dtype, value_grad) in variants.items():
                data = prepare(obs, times, ids, dtype=dtype, device=dev)
                pt = torch.tensor(par, dtype=dtype, device=dev)
                st = torch.tensor(0.2, dtype=dtype, device=dev)
                res[tag] = value_grad(pt, st, data, torch)
            torch.cuda.synchronize()
            v64, g64, s64 = res["ref"]
            gscale = max(np.max(np.abs(g64)), abs(s64))
            for tag, (dtype, _) in variants.items():
                if tag == "ref":
                    continue
                tol_v, tol_g = ((1e-10, 1e-8) if dtype == torch.float64
                                else (1e-4, 1e-4))
                v, g, s = res[tag]
                ev = abs(v - v64) / abs(v64)
                eg = max(np.max(np.abs(g - g64)), abs(s - s64)) / gscale
                worst[f"{tag}_val"] = max(worst[f"{tag}_val"], ev)
                worst[f"{tag}_grad"] = max(worst[f"{tag}_grad"], eg)
                check(np.isfinite(v) and np.all(np.isfinite(g)),
                      f"{tag} d={d} n={n}: non-finite output")
                check(ev <= tol_v, f"{tag} d={d} n={n}: value rel {ev:.3e}")
                check(eg <= tol_g, f"{tag} d={d} n={n}: grad rel {eg:.3e}")
            log(f"  d={d} n={n}: value rel to the f64 plain version: " +
                ", ".join(f"{tag} {abs(r[0] - v64) / abs(v64):.2e}"
                          for tag, r in res.items() if tag != "ref"))
    return worst


K2_KINDS = [(kind, rev) for kind in ("filter", "smooth", "diag_filter",
                                     "diag_smooth", "sqrt2", "sqrt1")
            for rev in (False, True)]
# each K2 instantiation's scan direction on the fits' paths (the
# square-root ones on phase 3n's "pallas" scans)
K2_PATH = {"block_prefix_filter": ("filter", False),
           "block_prefix_smooth": ("smooth", True),
           "block_prefix_diag_filter": ("diag_filter", False),
           "block_prefix_diag_smooth": ("diag_smooth", True),
           "block_prefix_sqrt2": ("sqrt2", False),
           "block_prefix_sqrt1": ("sqrt1", False)}


def elem_stack(torch, kind, elem, p):
    """The (L, C, lanes) stack of an element pytree (leaves (n,) or
    (d, n)) of ELEMS kind `kind`, identity-padded, as
    blocked_associative_scan lays it out."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    k = cf.ELEMS[kind]
    x = torch.stack([v.expand(p.d, p.n) for v in k.pack(elem)])
    return cf.pad_to_lanes(x, k.id_vals, p)


def slice_elements(torch, typ, par, sobs, obs=None, times=None, ids=None,
                   data=None):
    """The elements of the generic and special filters' new K8 / K2
    kinds at the parameter matrix `par` (a tensor on the card), from
    obs / times / ids or from the likelihood's prepared `data`:
    {"sqrt2": CTCRW square-root elements} or, for OU_SSM,
    {"diag_filter", "diag_smooth", "sqrt1"} (the smoothing elements from
    the plain filtered moments)."""
    from smoothsde_tpu_torch.ops import diag_fused as df
    from smoothsde_tpu_torch.ops import kalman_sqrt as ks
    from smoothsde_tpu_torch.ops.kalman_soa import (
        _ID1,
        _comb1,
        _ctcrw_system,
        _scan_elements,
        _shift_back,
    )

    if typ == "CTCRW":
        sys = elem_system(par, sobs, data) if data is not None else \
            _ctcrw_system(par, obs, times, ids, sobs, P0_POS, P0_VEL)
        return {"sqrt2": ks._build_sqrt_elements(sys)}
    sysd = df.diag_system(typ, par, obs, times, ids, sobs, data=data)
    filt = df.diag_elements(sysd)
    _, bf, Cf, _, _ = _scan_elements(_comb1, _ID1, filt, "blocked")
    te = _shift_back(sysd.resetf, 1.0)
    sm, _ = df._smooth_elem1(_shift_back(sysd.t, 1.0), _shift_back(sysd.q),
                             _shift_back(sysd.c), bf, Cf, te)
    return {"diag_filter": filt, "diag_smooth": sm,
            "sqrt1": ks._build_sqrt_elements1(sysd)}


def k2_totals(torch):
    """Real per-block totals of the six element kinds, f64 on the card:
    the plain K1a / K3a / D1a / D3a chains and the plain phase-1 scan of
    the square-root elements over two_track_data (d = 2, 2,048 lanes)."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import diag_fused as df
    from smoothsde_tpu_torch.ops import scan_utils as su
    from smoothsde_tpu_torch.ops.kalman_soa import prepare_ctcrw_data

    dev = torch.device("cuda")
    n = 32 * 1024
    obs, times, ids, par = two_track_data(2, n, seed=60)
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device=dev)
    p = cf.plan(2, n)
    pt = torch.tensor(par, device=dev)
    stack, bd = cf.par_stack_from_data(pt, data.yd, data.dtv, data.resetf,
                                       data.validf, p)
    h = torch.tensor([0.01], dtype=torch.float64, device=dev)
    ftot = cf.filter_totals_plain(stack, bd, h, P0_POS, P0_VEL)
    pre = cf.block_prefix_plain(ftot, 2, "filter", False)
    mom, _ = cf.filter_scan_plain(stack, bd, pre, h, P0_POS, P0_VEL)
    sysd = df.diag_system("OU_SSM", pt, obs, times, ids, 0.1)
    rows = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef, p)
    fwd = df.forward_stack(*rows)
    dtot = df.diag_filter_totals_plain(fwd, h, P0_DIAG)
    dpre = cf.block_prefix_plain(dtot, 2, "diag_filter", False)
    dmom, _ = df.diag_filter_scan_plain(fwd, dpre, h, P0_DIAG)
    sq = {**slice_elements(torch, "CTCRW", pt, 0.1, obs, times, ids),
          **slice_elements(torch, "OU_SSM", pt, 0.1, obs, times, ids)}
    return {"filter": ftot, "smooth": cf.smooth_totals_plain(stack, mom),
            "diag_filter": dtot,
            "diag_smooth": df.diag_smooth_totals_plain(
                df.backward_stack(*rows), dmom),
            **{k: su.pallas_phase1_scan_plain(
                elem_stack(torch, k, sq[k], p), k)[-1].contiguous()
               for k in ("sqrt2", "sqrt1")}}


def cycled(tot, d, nb, torch):
    """(C, d * nb) real totals: the lanes of `tot`, cycled with stride 5."""
    idx = torch.from_numpy((5 * np.arange(d * nb)) % tot.shape[1])
    return tot[:, idx.to(tot.device)].contiguous()


def phase_k2(torch):
    """Phase 2b: K2 alone against its plain version on the card, all six
    element kinds in both directions, d in {1, 2, 3}, NB around its tile
    (1, T - 1, T, T + 1, 3T + 5) and config 5a's 31,250, the square-root
    kinds also around the run design's run R and tile RT (R - 1, R,
    R + 1, RT - 1, RT, RT + 1, 3RT + 5): f64 within 1e-10
    of the output's scale, f32 against the f64 plain version within 1e-5.
    Then each instantiation's time, in its direction on the fits' paths,
    at the OU_SSM fit's (d = 2) and BM_SSM fit's (d = 1) NB = 31,250, f32:
    CUDA events per wrapper call and profiler device time. Returns
    {K2 name: measurements}."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    tots = k2_totals(torch)
    T = cf.PREFIX_TILE
    R = cf.PREFIX_RUN
    RT = R * cf.PREFIX_RUN_THREADS
    worst = {}
    for kind, reverse in K2_KINDS:
        nbs = (1, T - 1, T, T + 1, 3 * T + 5, 31_250)
        if kind in cf.PREFIX_RUN_KINDS:  # the run design's run and tile
            nbs += (R - 1, R, R + 1, RT - 1, RT, RT + 1, 3 * RT + 5)
        for d in (1, 2, 3):
            for nb in nbs:
                tot = cycled(tots[kind], d, nb, torch)
                ref = cf.block_prefix_plain(tot, d, kind, reverse)
                got = cf.block_prefix(tot, d, kind, reverse)
                got32 = cf.block_prefix(tot.float(), d, kind, reverse)
                scale = max(1.0, float(ref.abs().max()))
                where = f"K2 {kind} reverse={reverse} d={d} NB={nb}"
                check(bool(torch.isfinite(got).all())
                      and bool(torch.isfinite(got32).all()),
                      f"{where}: non-finite")
                e64 = float((got - ref).abs().max()) / scale
                e32 = float((got32.double() - ref).abs().max()) / scale
                check(e64 <= 1e-10, f"{where}: f64 vs plain {e64:.3e}")
                check(e32 <= 1e-5, f"{where}: f32 vs f64 plain {e32:.3e}")
                w = worst.setdefault(f"{kind} reverse={reverse}",
                                     {"f64": 0.0, "f32": 0.0})
                w["f64"], w["f32"] = max(w["f64"], e64), max(w["f32"], e32)
    log(f"[2b] worst error over the output's scale: {json.dumps(worst)}")
    out = {name: {"k2_max_rel_err_f64": worst[f"{k} reverse={r}"]["f64"],
                  "k2_max_rel_err_f32": worst[f"{k} reverse={r}"]["f32"]}
           for name, (k, r) in K2_PATH.items()}
    for label, d in (("ou_ssm_shape", 2), ("bm_ssm_shape", 1)):
        xs = {name: cycled(tots[k], d, 31_250, torch).float()
              for name, (k, _) in K2_PATH.items()}

        def all_k2(d=d, xs=xs):
            for name, (k, r) in K2_PATH.items():
                cf.block_prefix(xs[name], d, k, r)

        st = {}
        dev_ms, _, _ = profile_device_ms(all_k2, 10, torch, st)
        for name, (k, r) in K2_PATH.items():
            out[name][f"ms_{label}"] = cuda_ms(
                partial(cf.block_prefix, xs[name], d, k, r), 50, 3, torch)
            out[name][f"device_ms_{label}"] = dev_ms[name]
        log(f"[2b] K2 at d={d}, NB=31250, f32: " + ", ".join(
            f"{name} {out[name][f'device_ms_{label}'] * 1e3:.1f} us device, "
            f"{out[name][f'ms_{label}'] * 1e3:.1f} us per call"
            for name in K2_PATH))
        if d == 2:  # the square-root kinds' split, and their f64 times
            x64 = {name: cycled(tots[k], d, 31_250, torch)
                   for name, (k, _) in K2_PATH.items()
                   if k in cf.PREFIX_RUN_KINDS}

            def sqrt_k2(xs=x64):
                for name, x in xs.items():
                    cf.block_prefix(x, 2, *K2_PATH[name])

            st64 = {}
            dev64, _, _ = profile_device_ms(sqrt_k2, 10, torch, st64)
            for name, x in x64.items():
                elem = "Sqrt14" if name.endswith("sqrt2") else "Sqrt5"
                o = out[name]
                o[f"split_us_{label}"] = {
                    k.split()[0]: v for k, v in st["cuda_kernels"].items()
                    if k.endswith(f" {elem}")}
                o[f"split_us_f64_{label}"] = {
                    k.split()[0]: v for k, v in st64["cuda_kernels"].items()
                    if k.endswith(f" {elem}")}
                o[f"device_ms_f64_{label}"] = dev64[name]
                o[f"ms_f64_{label}"] = cuda_ms(
                    partial(cf.block_prefix, x, 2, *K2_PATH[name]), 50, 3,
                    torch)
                log(f"[2b] {name} at d=2, NB=31250, device us by CUDA "
                    f"kernel: f32 {json.dumps(o[f'split_us_{label}'])}, "
                    f"f64 {json.dumps(o[f'split_us_f64_{label}'])}; f64 "
                    f"{o[f'device_ms_f64_{label}'] * 1e3:.1f} us device, "
                    f"{o[f'ms_f64_{label}'] * 1e3:.1f} us per call")
    return out


def par_inputs(torch, d, n, seed):
    """(stack, bd, h) of the par-space path, f64 on the card, over
    two_track_data(d, n, seed)."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.kalman_soa import prepare_ctcrw_data

    dev = torch.device("cuda")
    obs, times, ids, par = two_track_data(d, n, seed=seed)
    data = prepare_ctcrw_data(obs, times, ids, dtype=torch.float64,
                              device=dev)
    stack, bd = cf.par_stack_from_data(torch.tensor(par, device=dev),
                                       data.yd, data.dtv, data.resetf,
                                       data.validf, cf.plan(d, n))
    return stack, bd, torch.tensor([0.04], dtype=torch.float64, device=dev)


def forward_inputs(torch, d, n, L):
    """(stack, bd, prefix, h) of the par-space forward, f64 on the card,
    cut to each lane's first L steps when L is given; the prefix from the
    plain K1a and K2 over the (cut) stack."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    stack, bd, h = par_inputs(torch, d, n, 80 + d)
    if L is not None:
        stack = stack[:L].contiguous()
    tot = cf.filter_totals_plain(stack, bd, h, P0_POS, P0_VEL)
    return stack, bd, cf.block_prefix_plain(tot, d, "filter", False), h


def backward_inputs(torch, d, n, L):
    """(stack, moments, suffix, h) of the par-space backward, f64 on the
    card, from the plain forward; cut to each lane's first L steps when L
    is given."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    stack, bd, h = par_inputs(torch, d, n, 70 + d)
    tot = cf.filter_totals_plain(stack, bd, h, P0_POS, P0_VEL)
    pre = cf.block_prefix_plain(tot, d, "filter", False)
    mom, _ = cf.filter_scan_plain(stack, bd, pre, h, P0_POS, P0_VEL)
    if L is not None:
        stack, mom = stack[:L].contiguous(), mom[:L].contiguous()
    suffix = cf.block_prefix_plain(cf.smooth_totals_plain(stack, mom), d,
                                   "smooth", True)
    return stack, mom, suffix, h


def diag_inputs(torch, d, n, L, typ=None):
    """(forward stack, backward stack, prefix, moments, suffix, h) of the
    scalar-state path of `typ` (by default BM_SSM at d = 1, OU_SSM above),
    f64 on the card, over two_track_data; cut to each lane's first L steps
    when L is given; the prefix, moments and suffix from the plain D1a,
    K2, D1b, D3a and K2 (reverse) over the (cut) stacks."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import diag_fused as df

    dev = torch.device("cuda")
    typ = typ or ("BM_SSM" if d == 1 else "OU_SSM")
    n_extra = 1 if typ == "BM_SSM" else 2
    obs, times, ids, par = two_track_data(d, n, seed=90 + d)
    sysd = df.diag_system(typ, torch.tensor(par[:, :d + n_extra],
                                            device=dev),
                          obs, times, ids, 0.2)
    rows = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf, sysd.updatef,
            cf.plan(d, n))
    fst, bst = df.forward_stack(*rows), df.backward_stack(*rows)
    if L is not None:
        fst, bst = fst[:L].contiguous(), bst[:L].contiguous()
    h = sysd.h.reshape(1)
    pre = cf.block_prefix_plain(df.diag_filter_totals_plain(fst, h, P0_DIAG),
                                d, "diag_filter", False)
    mom, _ = df.diag_filter_scan_plain(fst, pre, h, P0_DIAG)
    suf = cf.block_prefix_plain(df.diag_smooth_totals_plain(bst, mom), d,
                                "diag_smooth", True)
    return fst, bst, pre, mom, suf, h


# the kernels alone (phases 2c, 2d, 2e; D_ALONE also in
# tests/test_torch_gpu.py): each call takes an op table (kernels or plain)
# of ops/ctcrw_fused.py or ops/diag_fused.py and its inputs
K3_ALONE = {
    "ctcrw_smooth_totals": lambda o, x: o.smooth_totals(x[0], x[1]),
    "ctcrw_score_scan": lambda o, x: o.score_scan(*x, P0_POS),
}
K1_ALONE = {
    "ctcrw_filter_totals": lambda o, x: o.filter_totals(x[0], x[1], x[3],
                                                        P0_POS, P0_VEL),
    "ctcrw_filter_scan": lambda o, x: o.filter_scan(*x, P0_POS, P0_VEL),
}

# phase 2e's cuts of L: 1 and 3 as 2c; 5 and 27 (the last of the four
# segments of D1a, D1b and D3a short or empty) and L = 32's segment
# boundaries 8, 16 and 24 (also tests/test_torch_gpu.py)
D_CUTS = (1, 3, 5, 8, 16, 24, 27)


def d1a_alone(o, x):
    from smoothsde_tpu_torch.ops.diag_fused import segment_scratch

    return o.filter_totals(x[0], x[5], P0_DIAG, segment_scratch(x[0]))


def d1b_alone(o, x):
    """D1b seeded, as on the fit's path, with the segment totals that D1a
    leaves over the same stack (D1a launches once more for it)."""
    from smoothsde_tpu_torch.ops.diag_fused import segment_scratch

    seg = segment_scratch(x[0])
    o.filter_totals(x[0], x[5], P0_DIAG, seg)
    return o.filter_scan(x[0], x[2], seg, x[5], P0_DIAG)


D_ALONE = {
    "diag_filter_totals": d1a_alone,
    "diag_filter_scan": d1b_alone,
    "diag_smooth_totals": lambda o, x: o.smooth_totals(x[1], x[3]),
    "diag_score_scan": lambda o, x: o.score_scan(x[1], x[3], x[4], x[5],
                                                 P0_DIAG),
}


def phase_alone(torch, tag, make_inputs, calls, ops, cuts=(1, 3)):
    """Phases 2c (K3a, K3b: backward_inputs), 2d (K1a, K1b:
    forward_inputs) and 2e (D1a, D1b, D3a, D3b: diag_inputs): kernels
    alone, through the op table `ops` ({"kernels": ..., "plain": ...}),
    against their plain versions on the card, d in {1, 2, 3}, n in {80,
    2048, 5000, 20001} (lanes below, at and across K3's 64-lane tile,
    D1a's 32-lane and the walks' 128-lane blocks, not a multiple of 4) and
    n = 5000 cut to the L in `cuts` steps per lane (1 and 3: below and
    across K3's 2-step chunk; 2e adds D_CUTS' others, the four segments of
    D1a, D1b and D3a then of 2, 2, 1, 0 steps, 2 to 6 each, 7, 7, 7, 6
    steps): f64 within 1e-10 of the output's
    scale, f32 (on the inputs rounded to f32) against the f64 plain
    version within 1e-4 (the f32 bar: f32 forming the 2x2 inverses and
    K3's Qinv E Qinv score on short intervals costs up to ~5e-5 of the
    scale here, in the one-thread-per-lane walks too). Returns the worst
    errors."""
    ops_k, ops_p = ops["kernels"], ops["plain"]
    worst = {f"{k}_{dt}": 0.0 for k in calls for dt in ("f64", "f32")}
    shapes = [(d, n, None) for d in (1, 2, 3)
              for n in (80, 2048, 5000, 20001)]
    shapes += [(d, 5000, L) for d in (1, 2, 3) for L in cuts]
    for d, n, L in shapes:
        x64 = make_inputs(torch, d, n, L)
        ref = {name: call(ops_p, x64) for name, call in calls.items()}
        for dtype, dt, bar in ((torch.float64, "f64", 1e-10),
                               (torch.float32, "f32", 1e-4)):
            x = [t.to(dtype) for t in x64]
            for name, call in calls.items():
                g = flat(call(ops_k, x), torch).double()
                r = flat(ref[name], torch)
                where = f"{tag} {name} {dt} d={d} n={n} L={L}"
                check(bool(torch.isfinite(g).all()), f"{where}: non-finite")
                err = float((g - r).abs().max()) / max(1.0,
                                                       float(r.abs().max()))
                check(err <= bar, f"{where}: {err:.3e} of the scale")
                worst[f"{name}_{dt}"] = max(worst[f"{name}_{dt}"], err)
    log(f"[{tag}] worst error over the output's scale: {json.dumps(worst)}")
    return worst


def phase_audit(torch):
    """Phase 3e: f32 accuracy at the JAX package's own audit point
    (tools/accuracy_audit.py, regenerated here): n = 1M, rng seed 0,
    times = cumsum U(0.4, 0.6), obs = cumsum N(0, 0.3^2) in 2-D, theta =
    (0.05, -0.02, log 2, log 1) for every step, sigma_obs = 0.1. The port's
    `ctcrw_loglik_soa(scan="fused", analytic_grad=True)` in f32 on the
    card against its plain version (CtcrwPlainCore) in f64 on the card;
    gates: nllk within 1e-4 relative, the gradient in theta within 1e-4
    of |nllk|, every par-space kernel launched. Returns the errors beside
    docs/ACCURACY.md's TPU ones."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.kalman_soa import (
        CtcrwPlainCore,
        ctcrw_loglik_soa,
        prepare_ctcrw_data,
    )

    dev = torch.device("cuda")
    obs, times, ids, theta0 = audit_data()
    n = len(ids)
    res = {}
    cf.reset_launches()
    for dtype in (torch.float32, torch.float64):
        data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=dev)
        th = torch.tensor(theta0, dtype=dtype, device=dev, requires_grad=True)
        par = th.expand(n, 4).contiguous()
        if dtype == torch.float32:
            v = ctcrw_loglik_soa(par, None, None, None, 0.1, scan="fused",
                                 analytic_grad=True, data=data)
        else:
            h = torch.tensor(0.01, dtype=dtype, device=dev)
            v = CtcrwPlainCore.apply(par, data.yd, h, data.dtv, data.resetf,
                                     data.validf, P0_POS, P0_VEL)
        (g,) = torch.autograd.grad(-v, th)
        res[dtype] = (-float(v.detach()), g.double().cpu().numpy())
    for name, _, _ in CTCRW_KERNELS:
        check(cf.LAUNCHES[name] > 0, f"3e: kernel {name} never launched")
    (v32, g32), (v64, g64) = res[torch.float32], res[torch.float64]
    check(np.isfinite(v32) and np.all(np.isfinite(g32)),
          "3e: non-finite f32 nllk or gradient")
    ev = abs(v32 - v64) / abs(v64)
    eg = float(np.max(np.abs(g32 - g64)) / abs(v64))
    names = ["mu1", "mu2", "log_tau", "log_nu"]
    per = {nm: float(abs(g32[i] - g64[i]) / abs(g64[i]))
           for i, nm in enumerate(names)}
    # docs/ACCURACY.md, 1M-step audit: f32 fused on one TPU v5e chip vs
    # the f64 CPU oracle (the JAX package's figures, not the port's)
    jax_tpu = {"nllk": 3.4e-6, "mu1": 3.3e-6, "mu2": 3.5e-6,
               "log_tau": 9.5e-6, "log_nu": 7.9e-5}
    out = {"nllk_f32": v32, "nllk_f64": v64, "grad_f32": g32.tolist(),
           "grad_f64": g64.tolist(), "nllk_rel": ev,
           "grad_err_over_nllk": eg, "grad_rel_per_component": per,
           "jax_package_tpu_rel": jax_tpu,
           "worse_than_2x_jax": [nm for nm in names
                                 if per[nm] > 2 * jax_tpu[nm]]}
    log(f"[3e] audit point, f32 kernels vs f64 plain: {json.dumps(out)}")
    check(ev <= 1e-4, f"3e f32 nllk rel {ev:.3e}")
    check(eg <= 1e-4, f"3e f32 gradient {eg:.3e} of |nllk|")
    return out


def fit_on_card(torch, label, kw, dtype, **fit_kw):
    """Fit a model with `SDE(**kw, device="cuda", dtype=dtype).fit(
    **fit_kw)`; no exception is caught. Returns (sde, result, wall s)."""
    from smoothsde_tpu_torch import SDE

    t = time.time()
    sde = SDE(**kw, device="cuda", dtype=dtype)
    res = sde.fit(**fit_kw)
    torch.cuda.synchronize()
    wall = time.time() - t
    log(f"[{label}] {kw['type']} fit in {str(dtype)[6:]}: {wall:.2f} s, "
        f"{res.counts['evals']} marginal nllk+grad evals (BFGS "
        f"{res.counts}), convergence via {res.convergence_via}, par "
        f"{res.par.tolist()}, nllk {res.value:.6f}")
    return sde, res, wall


def phase_config1(torch):
    """Phase 3f: config 1 (BM, n = 1,000) in f32 and f64 on the card.
    Gates: convergence, sigma within 5% of 0.8 (n = 1,000 cannot pin mu
    to 5%: its standard error is ~9%), the f32 estimates within 1e-3 of
    the f64 fit's."""
    kw, truth = config1()
    sde, res, wall = fit_on_card(torch, "3f", kw, torch.float32)
    _, res64, wall64 = fit_on_card(torch, "3f", kw, torch.float64)
    mu, sigma = (float(v) for v in sde.par(t=0)[0])
    dpar = float(np.max(np.abs(res.par - res64.par)))
    check(res.convergence == 0 and res64.convergence == 0,
          f"3f: BM fit did not converge: {res.message} / {res64.message}")
    check(abs(sigma - truth["sigma"]) / truth["sigma"] < 0.05,
          f"3f: sigma {sigma} not within 5% of {truth['sigma']}")
    check(dpar <= 1e-3, f"3f: f32 estimates {dpar:.3e} from the f64 fit's")
    check(np.all(np.isfinite(res.cov_fixed)), "3f: cov_fixed not finite")
    out = {"wall_s": wall, "evals": res.counts["evals"],
           "via": res.convergence_via, "mu": mu, "sigma": sigma,
           "truth": truth, "nllk": res.value, "f64_wall_s": wall64,
           "f64_nllk": res64.value, "par_f32_minus_f64_max_abs": dpar}
    log(f"[3f] {json.dumps(out)}")
    return out


def phase_config2(torch):
    """Phase 3g: config 2 (OU with s(time, k=8, bs='cs') on mu and kappa,
    n = 3,000), the Laplace approximation on the card, in f32 and f64.
    Gates: convergence, tau within 5% of 2.0, the f32 nllk within 1e-4
    relative of the f64 fit's, bhat and cov_fixed finite."""
    kw, truth = config2()
    sde, res, wall = fit_on_card(torch, "3g", kw, torch.float32)
    _, res64, wall64 = fit_on_card(torch, "3g", kw, torch.float64)
    tau = float(sde.par(t=0)[0, 1])
    ev = abs(res.value - res64.value) / abs(res64.value)
    check(res.convergence == 0, f"3g: OU fit did not converge: {res.message}")
    check(abs(tau - truth["tau"]) / truth["tau"] < 0.05,
          f"3g: tau {tau} not within 5% of {truth['tau']}")
    check(ev <= 1e-4, f"3g: f32 nllk {res.value} vs f64 {res64.value}: "
          f"rel {ev:.3e}")
    check(len(res.bhat) > 0 and np.all(np.isfinite(res.bhat)),
          "3g: bhat empty or not finite")
    check(np.all(np.isfinite(res.cov_fixed)), "3g: cov_fixed not finite")
    out = {"wall_s": wall, "evals": res.counts["evals"],
           "via": res.convergence_via, "tau": tau, "truth": truth,
           "nllk": res.value, "f64_nllk": res64.value, "nllk_rel": ev,
           "f64_wall_s": wall64, "f64_evals": res64.counts["evals"],
           "n_inner": len(res.bhat), "lambda": sde.lambda_().tolist(),
           "timings_s": res.timings, "par_f64": res64.par.tolist(),
           "bhat_f64": res64.bhat.tolist()}
    log(f"[3g] {json.dumps(out)}")
    return out


def phase_config5b(torch, card):
    """Phase 3h: config 5b (the 1M-step CIR) fitted in f32 on the card.
    Gates: convergence, each parameter within 5% of the truth, the f32
    nllk within 1e-4 relative and the gradient within 1e-4 of |nllk| of
    the f64 evaluation on the card, at the optimum (q ~ 11.8, Olver's
    branch) and at the start (q ~ 5.1, the series and Hankel branches).
    Then the times: nllk+grad wall (110 calls), device busy and idle
    share and device operations per call (torch.profiler), peak memory."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad

    t = time.time()
    kw, truth = config5b()
    log(f"[3h] simulated in {time.time() - t:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    sde, res, wall = fit_on_card(torch, "3h", kw, torch.float32)
    fit_peak = torch.cuda.max_memory_allocated()
    est = dict(zip(truth, (float(v) for v in sde.par(t=0)[0])))
    check(res.convergence == 0, f"3h: CIR fit did not converge: {res.message}")
    for name, want in truth.items():
        check(abs(est[name] - want) / want < 0.05,
              f"3h: {name} {est[name]} not within 5% of {want}")
    check(np.all(np.isfinite(res.cov_fixed)), "3h: cov_fixed not finite")

    vg32 = make_val_grad(sde.bundle())
    vg64 = make_val_grad(SDE(**kw, device="cuda",
                             dtype=torch.float64).bundle())
    accuracy = {}
    for where, x in (("optimum", res.par),
                     ("start", sde.bundle().packer.outer_init())):
        v32, g32, _ = vg32(x)
        v64, g64, _ = vg64(x)
        ev = abs(v32 - v64) / abs(v64)
        eg = float(np.max(np.abs(g32 - g64)) / abs(v64))
        accuracy[where] = {"nllk_f32": v32, "nllk_f64": v64, "nllk_rel": ev,
                           "grad_f32": g32.tolist(), "grad_f64": g64.tolist(),
                           "grad_err_over_nllk": eg}
        check(np.isfinite(v32) and np.all(np.isfinite(g32)),
              f"3h: non-finite f32 nllk or gradient at the {where}")
        check(ev <= 1e-4, f"3h: f32 nllk at the {where}: rel {ev:.3e}")
        check(eg <= 1e-4, f"3h: f32 gradient at the {where}: {eg:.3e}")
    log(f"[3h] f32 vs f64 on the card: {json.dumps(accuracy)}")

    x = res.par
    torch.cuda.reset_peak_memory_stats()
    vg32(x)
    peak = torch.cuda.max_memory_allocated()
    stats = {}
    _, busy_ms, prof_wall_ms = profile_device_ms(lambda: vg32(x), 10, torch,
                                                 stats)
    vg = wall_ms(lambda: vg32(x), 110, 5)
    out = {"card": card, "n": len(kw["data"]["z"]), "fit_wall_s": wall,
           "fit_evals": res.counts["evals"], "bfgs": res.counts,
           "via": res.convergence_via, "estimates": est, "truth": truth,
           "nllk": res.value, "nllk_grad_1M_ms": vg,
           "profile_per_nllk_grad_ms": {"device_busy": busy_ms,
                                        "wall": prof_wall_ms},
           "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
           "device_ops_per_nllk_grad": stats["device_ops"],
           "peak_memory_bytes_nllk_grad": peak,
           "peak_memory_bytes_fit": fit_peak,
           "accuracy_f32_vs_f64": accuracy}
    log(f"[3h] {json.dumps(out)}")
    return out


def marginal_timing(torch, bundle, vg, x, b0, reps, stats):
    """One Laplace marginal evaluation (value, gradient, bhat) of the
    `make_val_grad(bundle)` function vg at (x, b0): host wall s per
    evaluation (median of `reps`, after one warm-up), and into `stats`
    the profiler's device busy and wall ms and device operations per
    evaluation (one call) and the twin's graphs' status."""
    wall = wall_ms(lambda: vg(x, b0), reps, 1)["median"] / 1e3
    _, busy, prof_wall = profile_device_ms(lambda: vg(x, b0), 1, torch,
                                           stats)
    stats.update(busy_ms=busy, wall_ms=prof_wall,
                 idle_share=1.0 - busy / prof_wall,
                 graphs={k: g.status
                         for k, g in bundle.marginal.graphs.items()})
    return wall


def phase_config4(torch, card):
    """Phase 3i: config 4 (8 x 250-step CTCRW, tau ~ s(ID, bs='re'))
    fitted in f32 and f64 on the card with the sdreport: the value term
    and outer gradient on K1a, K1b, K2 and K3a / K3b, every second-order
    quantity on the forward-mode twin (no kernel). Gates: convergence;
    f32 against f64: marginal nllk within 1e-4 relative, and the outer
    estimates apart by at most 0.1 f64 standard errors, the log smoothing
    parameter by at most 1 (the smoothing parameter's direction is flat;
    measured, PERF.md §6: 0.040 and 0.056, the same in every process
    history); the f64 marginal value and gradient at
    tests/golden/config4.npz's frozen point within test_golden.py's bars
    (value 1e-7 (1 + |v|), gradient rtol 1e-6, atol 1e-7); the joint
    precision finite and symmetric, its inner block positive definite;
    each of the twin's quantities a CUDA graph in both fits (no capture
    fell back to eager); each CTCRW kernel against its plain version on
    config 4's own stack (8 resets, 63 lanes) at each fit's optimum and
    bhat, at phase 4's bar in f64 (1e-8 of the scale) and in f32 at 1e-3
    of the scale (phase 4 records K3b's f32 outputs 5.2e-4 of the scale
    off at 5a: PERF.md §6). Printed: fit walls and evaluations, s per
    marginal evaluation, the kernels' launches per marginal evaluation
    and errors against their plain versions, device operations and busy
    / idle share per marginal evaluation, peak memory (smoothsde_tpu_torch/
    twin_bench.py times the twin's forms). Returns (the results, the f32
    fitted model)."""
    from smoothsde_tpu_torch.infer.fit import make_val_grad
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.kalman_soa import prepare_ctcrw_data

    kw, truth = config4()
    cf.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sde, res, wall = fit_on_card(torch, "3i", kw, torch.float32)
    fit_peak = torch.cuda.max_memory_allocated()
    fit_launches = {k: v for k, v in cf.LAUNCHES.items() if v}
    sde64, res64, wall64 = fit_on_card(torch, "3i", kw, torch.float64)
    b32, b64 = sde.bundle(), sde64.bundle()
    n_out = b32.packer.n_outer
    ev = abs(res.value - res64.value) / abs(res64.value)
    dpar = float(np.max(np.abs(res.par - res64.par)))
    check(res.convergence == 0 and res64.convergence == 0,
          f"3i: config 4 did not converge: {res.message} / {res64.message}")
    check(ev <= 1e-4, f"3i: f32 marginal nllk {res.value} vs f64 "
          f"{res64.value}: rel {ev:.3e}")
    se64 = np.sqrt(np.diag(res64.cov_fixed))
    dse = (res.par - res64.par) / se64
    smoothing = np.array([nm.startswith("log_lambda")
                          for nm in b64.packer.outer_names()])
    check(np.all(np.isfinite(dse))
          and float(np.max(np.abs(dse[~smoothing]))) <= 0.1
          and float(np.max(np.abs(dse[smoothing]))) <= 1.0,
          f"3i: f32 estimates {res.par.tolist()} vs f64 "
          f"{res64.par.tolist()}: {dse.tolist()} f64 standard errors")
    for tag, b in (("f32", b32), ("f64", b64)):
        status = {k: g.status for k, g in b.marginal.graphs.items()}
        check(all(list(st.values()) == ["graph"] for st in status.values()),
              f"3i: {tag} twin quantities not all CUDA graphs: {status}")
    for tag, r in (("f32", res), ("f64", res64)):
        Q = r.joint_precision
        check(Q is not None and np.all(np.isfinite(Q))
              and np.array_equal(Q, Q.T),
              f"3i: {tag} joint precision not finite and symmetric")
        lo = float(np.linalg.eigvalsh(Q[n_out:, n_out:]).min())
        check(lo > 0, f"3i: {tag} joint precision's inner block not "
              f"positive definite (least eigenvalue {lo:.3e})")

    fx = np.load(os.path.join(HERE, "tests", "golden", "config4.npz"))
    vg64 = make_val_grad(b64)
    gv, gg, _ = vg64(fx["outer"])
    want_v, want_g = float(fx["marginal_nllk"]), fx["marginal_grad"]
    golden = {"marginal_nllk": gv, "want": want_v, "grad": gg.tolist(),
              "abs_err": abs(gv - want_v),
              "grad_max_abs_err": float(np.max(np.abs(gg - want_g)))}
    check(abs(gv - want_v) < 1e-7 * (1 + abs(want_v)),
          f"3i: f64 marginal at the golden point {gv} vs {want_v}")
    check(np.allclose(gg, want_g, rtol=1e-6, atol=1e-7),
          f"3i: f64 marginal gradient at the golden point {gg.tolist()} vs "
          f"{want_g.tolist()}")

    x, bh = res.par, res.bhat
    vg32 = make_val_grad(b32)  # the fit's marginal, graphs captured
    cf.reset_launches()
    vg32(x, bh)
    per_eval = {k: v for k, v in cf.LAUNCHES.items() if v}
    for name in ("ctcrw_filter_totals", "ctcrw_filter_scan",
                 "block_prefix_filter", "ctcrw_smooth_totals",
                 "block_prefix_smooth", "ctcrw_score_scan"):
        check(per_eval.get(name, 0) > 0,
              f"3i: {name} not launched by a marginal evaluation")
    torch.cuda.reset_peak_memory_stats()
    vg32(x, bh)
    eval_peak = torch.cuda.max_memory_allocated()
    stats = {}
    s_eval = marginal_timing(torch, b32, vg32, x, bh, 3, stats)

    ops_k, ops_p = cf.OPS["kernels"], cf.OPS["plain"]
    kchecks = {}
    for tag, s_, r_, bun in (("", sde64, res64, b64), ("_f32", sde, res, b32)):
        dat = prepare_ctcrw_data(s_.obs(), kw["data"]["time"],
                                 kw["data"]["ID"], dtype=bun.dtype,
                                 device=bun.device)
        with torch.no_grad():
            p, calls = ctcrw_kernel_calls(torch, bun, dat, r_.par, r_.bhat)
            for name, fn in calls.items():
                got, ref = flat(fn(ops_k), torch), flat(fn(ops_p), torch)
                err = float((got - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                bar = 1e-3 if tag else 1e-8
                check(bool(torch.isfinite(got).all()) and err <= bar * scale,
                      f"3i: {name}{tag} kernel vs plain at config 4: max abs "
                      f"err {err:.3e}, scale {scale:.3e}")
                kchecks.setdefault(name, {
                    "shape_config4": f"n={p.n} d=2 lanes={p.lanes} L={p.L}"})
                kchecks[name].update({
                    f"max_abs_err{tag}_config4": err,
                    f"max_rel_err{tag}_config4": err / scale})

    out = {"card": card, "n": len(kw["data"]["ID"]), "twin": b32.twin,
           "fit_wall_s": wall, "fit_evals": res.counts["evals"],
           "via": res.convergence_via, "timings_s": res.timings,
           "f64_fit_wall_s": wall64, "f64_evals": res64.counts["evals"],
           "s_per_marginal_eval_fit": wall / res.counts["evals"],
           "s_per_marginal_eval_optimum": s_eval,
           "par": res.par.tolist(), "par_f64": res64.par.tolist(),
           "se_f64": se64.tolist(), "smoothing": smoothing.tolist(),
           "nllk": res.value, "nllk_f64": res64.value, "nllk_rel": ev,
           "par_f32_minus_f64_max_abs": dpar,
           "par_f32_minus_f64_over_se64": dse.tolist(),
           "tau_per_track": sde.par(t="all")[::250, 2].tolist(),
           "truth": truth, "lambda": sde.lambda_().tolist(),
           "golden_f64": golden,
           "launches_fit": fit_launches,
           "launches_per_marginal_eval": per_eval,
           "kernel_checks": kchecks,
           "profile_per_marginal_eval": stats,
           "peak_memory_bytes_fit": fit_peak,
           "peak_memory_bytes_marginal_eval": eval_peak}
    log(f"[3i] {json.dumps(out)}")
    return out, sde  # phase 3l starts from the f32 fit


def phase_api_tail(torch, card, sde):
    """Phase 3l: the API tail at config 4 on the card, from phase 3i's
    f32 fit `sde` (no refit): joint_cov, CI_pointwise and CI_simultaneous over
    all 2,000 rows (n_post 1,000, fixed seeds), par(term=) and
    linear_predictor, make_mat_grid("ID"), log_lik (a forward pass
    through K1a, K2, K1b), edf_conditional (torch.func.hessian of the
    twin), the AICs and BIC, simulate(posterior=True) and check_post
    (n_sims 20), save_state, then load_state into a new f64 model.
    Gates: every output finite and of its shape; log_lik launches K1a,
    K2 and K1b once each and nothing else; at the same checkpoint the
    f32 model's log_lik within 1e-4 relative and edf_conditional within
    1e-3 relative of the f64 model's; the f64 log_lik through the
    kernels equal to -joint_nllk_unpenalized through the twin to 1e-10
    relative; the reloaded model's CIs equal the original's at the same
    seeds, bit for bit. Prints the seconds of each call."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    kw, _ = config4()
    n = len(kw["data"]["ID"])
    n_par = len(sde.par_names())
    secs = {}

    def timed(name, fn):
        t = time.time()
        value = fn()
        torch.cuda.synchronize()
        secs[name] = time.time() - t
        return value

    def rng(seed):
        return np.random.default_rng(seed)

    V = timed("joint_cov", sde.joint_cov)
    k = len(sde.out().par) + len(sde.out().bhat)
    check(V.shape == (k, k) and np.all(np.isfinite(V)),
          f"3l: joint_cov {V.shape} not finite or not {k} x {k}")
    ci_pw = timed("CI_pointwise", lambda: sde.CI_pointwise(
        t="all", n_post=1000, rng=rng(21)))
    ci_sim = timed("CI_simultaneous", lambda: sde.CI_simultaneous(
        t="all", n_post=1000, rng=rng(22)))
    for name, ci in (("CI_pointwise", ci_pw), ("CI_simultaneous", ci_sim)):
        check(ci.shape == (n_par, 2, n) and np.all(np.isfinite(ci))
              and np.all(ci[:, 0] <= ci[:, 1]),
              f"3l: {name} {ci.shape} not finite or not ordered")
    p_term = timed("par_term", lambda: sde.par(t="all", term="tau.s(ID)"))
    lp = timed("linear_predictor", sde.linear_predictor)
    grid = timed("make_mat_grid", lambda: sde.make_mat_grid("ID"))
    check(p_term.shape == lp.shape == (n, n_par)
          and np.all(np.isfinite(p_term)) and np.all(np.isfinite(lp)),
          "3l: par(term=) or linear_predictor not finite")
    check(grid["X_fe"].shape[0] == 8 * n_par
          and np.all(np.isfinite(grid["X_re"])),
          f"3l: make_mat_grid('ID') X_fe {grid['X_fe'].shape}")
    cf.reset_launches()
    ll = timed("log_lik", sde.log_lik)
    ll_launches = {k_: v for k_, v in cf.LAUNCHES.items() if v}
    check(ll_launches == {"ctcrw_filter_totals": 1, "block_prefix_filter": 1,
                          "ctcrw_filter_scan": 1},
          f"3l: log_lik launched {ll_launches}, not K1a, K2, K1b once each")
    edf = timed("edf_conditional", sde.edf_conditional)
    aic_c = timed("AIC_conditional", sde.AIC_conditional)
    aic_m = timed("AIC_marginal", sde.AIC_marginal)
    bic = timed("BIC", sde.BIC)
    check(all(np.isfinite([ll, edf, aic_c, aic_m, bic])),
          "3l: log_lik, edf or an information criterion not finite")
    sim = timed("simulate", lambda: sde.simulate(posterior=True,
                                                 rng=rng(23)))
    check(all(np.isfinite(sim[r]).all() for r in ("y1", "y2")),
          "3l: simulate(posterior=True) not finite")

    def step_length(d):
        return [np.nanmean(np.hypot(np.diff(d["y1"]), np.diff(d["y2"])))]

    cp = timed("check_post", lambda: sde.check_post(
        step_length, n_sims=20, silent=True, rng=rng(24)))
    check(cp["stats"].shape == (1, 20) and np.all(np.isfinite(cp["stats"])),
          "3l: check_post statistics not finite")
    path = os.path.join(HERE, "build", "chip_smoke_config4.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    timed("save_state", lambda: sde.save_state(path))
    sde64 = SDE(**kw, device="cuda", dtype=torch.float64)
    timed("load_state", lambda: sde64.load_state(path))
    ll64 = timed("log_lik_f64", sde64.log_lik)
    edf64 = timed("edf_conditional_f64", sde64.edf_conditional)
    r = sde64.out()
    b64 = sde64.bundle()
    with torch.no_grad():
        full = b64.packer.unpack(
            torch.tensor(r.par, dtype=torch.float64, device="cuda"),
            torch.tensor(r.bhat, dtype=torch.float64, device="cuda"))
        twin64 = -float(b64.joint_nllk_unpenalized(full))
    e_ll = abs(ll - ll64) / abs(ll64)
    e_edf = abs(edf - edf64) / abs(edf64)
    e_twin = abs(ll64 - twin64) / abs(twin64)
    check(e_ll <= 1e-4, f"3l: f32 log_lik {ll} vs f64 {ll64}: rel {e_ll:.3e}")
    check(e_edf <= 1e-3,
          f"3l: f32 edf {edf} vs f64 {edf64}: rel {e_edf:.3e}")
    check(e_twin <= 1e-10, f"3l: f64 log_lik through the kernels {ll64} vs "
          f"the twin {twin64}: rel {e_twin:.3e}")
    same_pw = np.array_equal(sde64.CI_pointwise(t="all", n_post=1000,
                                                rng=rng(21)), ci_pw)
    same_sim = np.array_equal(sde64.CI_simultaneous(t="all", n_post=1000,
                                                    rng=rng(22)), ci_sim)
    check(same_pw and same_sim, "3l: the reloaded model's CIs differ from "
          f"the original's (pointwise {same_pw}, simultaneous {same_sim})")
    out = {"card": card, "seconds": secs, "log_lik": ll,
           "log_lik_f64": ll64, "log_lik_rel": e_ll,
           "log_lik_f64_vs_twin_rel": e_twin, "edf_conditional": edf,
           "edf_conditional_f64": edf64, "edf_rel": e_edf,
           "AIC_conditional": aic_c, "AIC_marginal": aic_m, "BIC": bic,
           "log_lik_launches": ll_launches,
           "check_post_obs": cp["obs_stat"].tolist(),
           "check_post_stats_mean": float(cp["stats"].mean()),
           "tau_CI_pointwise_width_mean":
               float(np.mean(ci_pw[2, 1] - ci_pw[2, 0]))}
    log(f"[3l] {json.dumps(out)}")
    return out


def phase_device_optimizer(torch, card, data5a, res5a, fit5a_s, cfg2):
    """Phase 3m: `fit(optimizer="device")` at config 5a (1M-step 2-D
    CTCRW, f32: each L-BFGS step one CUDA graph of val+grad and the
    update, one host read) and `fit(optimizer="auto")` at config 2 (which
    resolves to "device": the Laplace marginal, eager, then the host
    polish). Gates: convergence through the optimizer, gtol or a probe;
    tau and nu within 5% at 5a, tau within 5% at config 2; the final
    nllk within 1e-4 relative of the scipy fits of phases 3 and 3g; at
    5a every step a CUDA graph, and every CTCRW kernel launched during
    the fit (its wrappers count the kernels that ran, a graph's replays
    included; so does the profiler). Prints the walls, iterations and
    evaluations, kernel launches and host reads per iteration, and the
    profiler's idle share of a second 5a fit."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    vias = ("optimizer", "gtol", "slope_probe", "descent_probe")
    cf.reset_launches()
    t = time.time()
    sde = SDE(data=data5a, type="CTCRW", response=["y1", "y2"],
              par0=[0, 0, 2, 0.8], device="cuda")
    r = sde.fit(optimizer="device")
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = {k: v for k, v in cf.LAUNCHES.items() if v}
    tau, nu = (float(v) for v in sde.par(t=0)[0, 2:4])
    e_v = abs(r.value - res5a.value) / abs(res5a.value)
    n_iter = r.counts["iterations"]
    log(f"[3m] 5a device fit {wall:.2f} s: {n_iter} iterations, "
        f"{r.device_steps} steps ({r.device_graph}), counts {r.counts}, "
        f"via {r.convergence_via}, tau {tau:.4f}, nu {nu:.4f}, nllk "
        f"{r.value:.3f} (scipy {res5a.value:.3f}, rel {e_v:.2e}), timings "
        f"{r.timings}")
    check(r.optimizer == "device" and r.convergence_via in vias,
          f"3m: 5a device fit did not converge: {r.message}")
    check(abs(tau - 3.0) / 3.0 < 0.05 and abs(nu - 1.0) < 0.05,
          f"3m: 5a tau {tau} or nu {nu} not within 5%")
    check(e_v <= 1e-4, f"3m: 5a device nllk {r.value} vs scipy "
          f"{res5a.value}: rel {e_v:.3e}")
    check(r.device_graph == "graph",
          f"3m: 5a L-BFGS steps not a CUDA graph: {r.device_graph}")
    for name, _, _ in CTCRW_KERNELS:
        check(launches.get(name, 0) > 0,
              f"3m: {name} not launched by the device fit")
    stats = {}
    profiled = {}

    def refit():
        profiled["res"] = sde.fit(optimizer="device")

    _, busy_ms, prof_wall_ms = profile_device_ms(refit, 1, torch, stats)
    steps = profiled["res"].device_steps
    # The profiler counts every kernel the fit ran, the graph replays'
    # included. Outside the loop: the start's evaluation, the capture's
    # warm-up and checking replay, the five value-only probes (forward
    # kernels only) and the FD Hessian's 4 n_outer gradients (replays of
    # the bundle's evaluation graph, captured in the first fit); the loop
    # adds one launch of each kernel a step. K2's count is of its three
    # kernels a call.
    n_out = len(r.par)
    per_fit = {}
    per_iter = {}
    for name, _, _ in CTCRW_KERNELS:
        calls = stats["kernel_counts"][name] / (
            3 if name.startswith("block_prefix") else 1)
        outside = 3 + 4 * n_out + (5 if name in FORWARD_KERNELS else 0)
        per_fit[name] = calls
        per_iter[name] = (calls - outside) / profiled["res"].counts[
            "iterations"]
        check(calls == outside + steps,
              f"3m: {name} ran {calls} times in the profiled fit, not "
              f"{outside} + {steps} steps")

    kw2, truth2 = config2()
    t = time.time()
    sde2 = SDE(**kw2, device="cuda")
    r2 = sde2.fit(optimizer="auto")
    torch.cuda.synchronize()
    wall2 = time.time() - t
    tau2 = float(sde2.par(t=0)[0, 1])
    e_v2 = abs(r2.value - cfg2["nllk"]) / abs(cfg2["nllk"])
    log(f"[3m] config 2 auto fit {wall2:.2f} s: optimizer {r2.optimizer}, "
        f"{r2.device_steps} steps ({r2.device_graph}), counts {r2.counts}, "
        f"via {r2.convergence_via}, tau {tau2:.4f}, nllk {r2.value:.4f} "
        f"(scipy {cfg2['nllk']:.4f}, rel {e_v2:.2e})")
    check(r2.optimizer == "device",
          f"3m: config 2 'auto' chose {r2.optimizer}")
    check(r2.convergence_via in vias,
          f"3m: config 2 device fit did not converge: {r2.message}")
    check(abs(tau2 - truth2["tau"]) / truth2["tau"] < 0.05,
          f"3m: config 2 tau {tau2} not within 5% of {truth2['tau']}")
    check(e_v2 <= 1e-4, f"3m: config 2 device nllk {r2.value} vs scipy "
          f"{cfg2['nllk']}: rel {e_v2:.3e}")
    out = {"card": card,
           "config5a": {"wall_s": wall, "scipy_wall_s": fit5a_s,
                        "iterations": n_iter, "steps": r.device_steps,
                        "evals": r.counts["evals"],
                        "scipy_evals": res5a.counts["evals"],
                        "host_reads_per_iteration":
                            (r.device_steps + 1) / n_iter,
                        "host_reads_per_loop_evaluation":
                            (r.device_steps + 1) / r.counts["device_evals"],
                        "graph": r.device_graph, "via": r.convergence_via,
                        "tau": tau, "nu": nu, "nllk": r.value,
                        "nllk_scipy": res5a.value, "nllk_rel": e_v,
                        "timings_s": r.timings,
                        "wrapper_launches_fit": launches,
                        "kernel_calls_fit_profiler": per_fit,
                        "kernel_launches_per_iteration": per_iter,
                        "profile_fit_ms": {"device_busy": busy_ms,
                                           "wall": prof_wall_ms},
                        "device_idle_share": 1.0 - busy_ms / prof_wall_ms,
                        "device_ops_fit": stats["device_ops"]},
           "config2": {"wall_s": wall2, "scipy_wall_s": cfg2["wall_s"],
                       "optimizer": r2.optimizer,
                       "steps": r2.device_steps,
                       "iterations": r2.counts["iterations"],
                       "evals": r2.counts["evals"],
                       "scipy_evals": cfg2["evals"],
                       "graph": r2.device_graph,
                       "via": r2.convergence_via, "tau": tau2,
                       "nllk": r2.value, "nllk_scipy": cfg2["nllk"],
                       "nllk_rel": e_v2, "timings_s": r2.timings}}
    log(f"[3m] {json.dumps(out)}")
    return out


def phase_twin_1m(torch, card, cases):
    """Phase 3j: the forward-mode twin's long branch (the SoA filter's
    plain "blocked" scan, TWIN_SOA_MIN_STEPS steps and up) against the
    kernel route at 1M steps, at each case's start and its f32 optimum;
    the twin launches no kernel. f64: value within 1e-10 relative,
    gradient within 1e-8 of its largest component (the card test's bars
    at 200k). f32, against the f64 kernel route: value within 1e-4
    relative; at the start (gradient components ~1e4-1e6) the gradient
    within 1e-3 of its largest component. At the f32 optimum the f32
    gradient is rounding noise of the 1M-step sums (both routes ~10-30
    from f64's; PERF.md §6), so there its errors are printed, not gated.
    Each route's f32 nllk+grad wall ms and the twin's peak memory."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    def value_grad(bundle, fn, x):
        xt = torch.tensor(x, dtype=bundle.dtype, device=bundle.device,
                          requires_grad=True)
        v = fn(bundle.packer.unpack(xt))
        (g,) = torch.autograd.grad(v, xt)
        return float(v.detach()), g.double().cpu().numpy()

    out = {"card": card}
    for label, b32, b64, x_opt in cases:
        res = out[label] = {}
        for where, x in (("start", b32.packer.outer_init()),
                         ("optimum", x_opt)):
            r = {}
            for tag, b in (("f64", b64), ("f32", b32)):
                check(b.twin == "blocked", f"3j: {label} twin {b.twin}")
                cf.reset_launches()
                r[f"twin_{tag}"] = value_grad(b, b.joint_nllk_ad, x)
                check(not any(cf.LAUNCHES.values()),
                      f"3j: the {label} twin launched {cf.LAUNCHES}")
                r[f"kernels_{tag}"] = value_grad(b, b.joint_nllk, x)
            kv, kg = r["kernels_f64"]
            gscale = float(np.max(np.abs(kg)))
            err = {}
            for key in ("twin_f64", "twin_f32", "kernels_f32"):
                v, g = r[key]
                err[key] = {"nllk_rel": abs(v - kv) / abs(kv),
                            "grad_err_over_max": float(
                                np.max(np.abs(g - kg))) / gscale}
            res[where] = {"nllk_f64": kv, "grad_f64": kg.tolist(),
                          **{k: (v, g.tolist()) for k, (v, g) in r.items()
                             if k != "kernels_f64"},
                          "vs_f64_kernels": err}
            e = err["twin_f64"]
            check(e["nllk_rel"] <= 1e-10 and e["grad_err_over_max"] <= 1e-8,
                  f"3j: {label} f64 twin vs kernels at the {where}: {e}")
            e = err["twin_f32"]
            check(e["nllk_rel"] <= 1e-4, f"3j: {label} f32 twin nllk at the "
                  f"{where}: rel {e['nllk_rel']:.3e}")
            if where == "start":
                check(e["grad_err_over_max"] <= 1e-3,
                      f"3j: {label} f32 twin gradient at the start: "
                      f"{e['grad_err_over_max']:.3e} of its largest "
                      f"component")
        torch.cuda.reset_peak_memory_stats()
        value_grad(b32, b32.joint_nllk_ad, x_opt)
        res["twin_peak_memory_bytes_f32"] = torch.cuda.max_memory_allocated()
        res["twin_ms"] = wall_ms(
            lambda: value_grad(b32, b32.joint_nllk_ad, x_opt), 5, 1)
        res["kernels_ms"] = wall_ms(
            lambda: value_grad(b32, b32.joint_nllk, x_opt), 20, 2)
    log(f"[3j] {json.dumps(out)}")
    return out


def phase_colored(torch, card):
    """Phase 3k: the wide-random-effect BM fit of tests/test_coloring.py
    (40 animals x 30, seed 9, sigma ~ s(ID, bs='re')) on the card in f32
    through the colored inner Hessian. Gates: one color, convergence,
    median sigma within 0.25 of 0.8."""
    kw = dict(data=multi_animal_bm(), type="BM", response="z",
              formulas={"mu": "~1", "sigma": "~s(ID, bs='re')"},
              par0=[0.0, 1.0])
    sde, res, wall = fit_on_card(torch, "3k", kw, torch.float32)
    plan = sde.bundle().hess_plan
    med = float(np.median(sde.par(t="all")[:, 1]))
    check(plan is not None and plan["n_colors"] == 1,
          f"3k: colored plan {None if plan is None else plan['n_colors']}")
    check(res.convergence == 0, f"3k: BM fit did not converge: "
          f"{res.message}")
    check(abs(med - 0.8) < 0.25, f"3k: median sigma {med}")
    out = {"card": card, "n_colors": plan["n_colors"], "p_re": plan["p"],
           "fit_wall_s": wall, "evals": res.counts["evals"],
           "via": res.convergence_via, "median_sigma": med,
           "nllk": res.value, "par": res.par.tolist()}
    log(f"[3k] {json.dumps(out)}")
    return out


def diag_fit(torch, label, typ, data, response, par0, truth):
    """Phases 3b / 3c: fit a 1M-step scalar-state model on the card in f32
    with launch counts from zero; gates as in phase 3, truth given per
    parameter on the response scale (mus within 0.05 absolute, the rest
    within 5%). Returns what phase 4 needs."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.diag_fused import DiagPlainCore, prepare_diag_data

    dev = torch.device("cuda")
    cf.reset_launches()
    t = time.time()
    sde = SDE(data=data, type=typ, response=response, par0=par0,
              device="cuda")
    res = sde.fit()
    torch.cuda.synchronize()
    fit_s = time.time() - t
    launches = dict(cf.LAUNCHES)
    est = dict(zip(truth, (float(v) for v in sde.par(t=0)[0])))
    log(f"[{label}] {typ} fit {fit_s:.2f} s, {res.counts['evals']} nllk+grad "
        f"evals (BFGS {res.counts}), convergence via {res.convergence_via}, "
        f"estimates {json.dumps(est)}, nllk {res.value:.3f}")
    log(f"[{label}] launches during the fit: {launches}")
    check(res.convergence == 0, f"{typ} fit did not converge: {res.message}")
    for name, want in truth.items():
        got = est[name]
        if name.startswith("mu"):
            check(abs(got - want) <= 0.05, f"{typ} {name} {got} vs {want}")
        else:
            check(abs(got - want) / want < 0.05,
                  f"{typ} {name} {got} not within 5% of {want}")
    for name, _, _ in DIAG_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched by the fit")
    check(res.cov_fixed is not None and np.all(np.isfinite(res.cov_fixed)),
          f"{typ} cov_fixed not finite")

    b32 = sde.bundle()
    b64 = SDE(data=data, type=typ, response=response, par0=par0,
              device="cuda", dtype=torch.float64).bundle()
    d32, d64 = (prepare_diag_data(typ, sde.obs(), data["time"], data["ID"],
                                  dtype=dt, device=dev)
                for dt in (torch.float32, torch.float64))
    accuracy = {}
    for where, x in (("optimum", res.par), ("start", b32.packer.outer_init())):
        v32, g32, _ = make_val_grad(b32)(x)  # the fit's own evaluation
        v64, g64 = diag_outer_value_grad(typ, b64, DiagPlainCore, d64, x,
                                         torch)
        ev = abs(v32 - v64) / abs(v64)
        eg_scale = float(np.max(np.abs(g32 - g64)) / abs(v64))
        eg_comp = float(np.max(np.abs(g32 - g64) / np.maximum(
            np.abs(g64), 1e-300)))
        accuracy[where] = {"nllk_rel": ev, "grad_err_over_nllk": eg_scale,
                           "grad_rel_per_component": eg_comp}
        log(f"[{label}] f32 kernels vs f64 plain at the {where}: nllk "
            f"{v32:.6f} vs {v64:.6f} (rel {ev:.2e}); grad {g32} vs {g64}")
        check(ev <= 1e-4, f"{typ} f32 nllk at the {where}: rel {ev:.3e}")
        check(eg_scale <= 1e-4,
              f"{typ} f32 gradient at the {where}: {eg_scale:.3e}")
    log(f"[{label}] accuracy: {json.dumps(accuracy)}")
    return {"typ": typ, "res": res, "launches": launches, "b32": b32,
            "b64": b64, "d32": d32, "d64": d64, "d": len(response),
            "summary": {"wall_s": fit_s, "evals": res.counts["evals"],
                        "bfgs": res.counts, "via": res.convergence_via,
                        "estimates": est, "truth": truth, "nllk": res.value,
                        "accuracy_f32_vs_f64": accuracy}}


def diag_kernel_checks(torch, fit):
    """Phase 4 for the scalar-state kernels at a diag fit's shapes: each
    kernel against its plain version (max abs error within 1e-8 of the
    output's scale in f64, 1e-4 in f32: the fit's own precision, in which
    D1b runs its segments) and its time and its plain version's (f32,
    CUDA events). Returns {kernel name: measurements}."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import diag_fused as df

    dev = torch.device("cuda")
    ops_k, ops_p = df.OPS["kernels"], df.OPS["plain"]
    d, typ = fit["d"], fit["typ"]
    out = {name: {} for name, _, _ in DIAG_KERNELS}
    for dtype, dat, bun in ((torch.float64, fit["d64"], fit["b64"]),
                            (torch.float32, fit["d32"], fit["b32"])):
        with torch.no_grad():
            xt = torch.tensor(fit["res"].par, dtype=dtype, device=dev)
            full = bun.packer.unpack(xt)
            sysd = df.diag_system(typ, bun.par_matrix(full), None, None, None,
                                  torch.exp(full["log_sigma_obs"][0]),
                                  data=dat)
            h1 = sysd.h.reshape(1)
            p = cf.plan(d, sysd.yd.shape[1])
            rows = (sysd.t, sysd.q, sysd.c, sysd.yd, sysd.resetf,
                    sysd.updatef, p)
            fst, bst = df.forward_stack(*rows), df.backward_stack(*rows)
            seg = df.segment_scratch(fst)  # D1a writes it, D1b reads it
            tot = ops_k.filter_totals(fst, h1, P0_DIAG, seg)
            pre = ops_k.block_prefix(tot, d, "diag_filter", False)
            mom, _ = ops_k.filter_scan(fst, pre, seg, h1, P0_DIAG)
            stot = ops_k.smooth_totals(bst, mom)
            suf = ops_k.block_prefix(stot, d, "diag_smooth", True)
            calls = {
                "diag_filter_totals": lambda o: o.filter_totals(
                    fst, h1, P0_DIAG, seg),
                "block_prefix_diag_filter": lambda o: o.block_prefix(
                    tot, d, "diag_filter", False),
                "diag_filter_scan": lambda o: o.filter_scan(
                    fst, pre, seg, h1, P0_DIAG),
                "diag_smooth_totals": lambda o: o.smooth_totals(bst, mom),
                "block_prefix_diag_smooth": lambda o: o.block_prefix(
                    stot, d, "diag_smooth", True),
                "diag_score_scan": lambda o: o.score_scan(
                    bst, mom, suf, h1, P0_DIAG),
            }
            for name, _, _ in DIAG_KERNELS:
                fn = calls[name]
                got, ref = flat(fn(ops_k), torch), flat(fn(ops_p), torch)
                err = float((got - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                e = out[name]
                check(bool(torch.isfinite(got).all()),
                      f"{typ} {name}: non-finite")
                if dtype == torch.float64:
                    e["max_abs_err"] = err
                    e["max_rel_err"] = err / scale
                    check(err <= 1e-8 * scale, f"{typ} {name}: f64 kernel vs "
                          f"plain max abs err {err:.3e}")
                else:
                    e["max_abs_err_f32"] = err
                    e["max_rel_err_f32"] = err / scale
                    check(err <= 1e-4 * scale, f"{typ} {name}: f32 kernel vs "
                          f"plain max abs err {err:.3e}")
                    e["ms"] = cuda_ms(lambda: fn(ops_k), 50, 3, torch)
                    e["plain_ms"] = cuda_ms(lambda: fn(ops_p), 3, 1, torch)
                    e["shape"] = (f"{typ} n={p.n} d={d} lanes={p.lanes} "
                                  f"L={p.L} f32")
                    e.update(bound(name, p, 4))
    for name, e in out.items():
        log(f"  {typ} {name}: {e['ms']:.4f} ms (plain {e['plain_ms']:.2f} "
            f"ms), bound {e['bound_us']:.2f} us ({e['bytes'] / 1e6:.2f} MB), "
            f"max abs err over the scale f64 {e['max_rel_err']:.2e}, "
            f"f32 {e['max_rel_err_f32']:.2e}")
    return out


def diag_times(torch, fit):
    """Profiler device time per kernel and busy share, and nllk+grad wall
    time (kernels and plain) at a diag fit's optimum, f32."""
    from smoothsde_tpu_torch.ops.diag_fused import DiagFusedCore, DiagPlainCore

    typ, b32, d32, x = fit["typ"], fit["b32"], fit["d32"], fit["res"].par
    dev_ms, busy_ms, prof_wall_ms = profile_device_ms(
        lambda: diag_outer_value_grad(typ, b32, DiagFusedCore, d32, x, torch),
        10, torch)
    log(f"[4] {typ} profiler, per nllk+grad: device busy {busy_ms:.3f} ms of "
        f"{prof_wall_ms:.3f} ms wall; per kernel {json.dumps(dev_ms)}")
    vg_k = wall_ms(
        lambda: diag_outer_value_grad(typ, b32, DiagFusedCore, d32, x, torch),
        110, 5)
    vg_p = wall_ms(
        lambda: diag_outer_value_grad(typ, b32, DiagPlainCore, d32, x, torch),
        5, 1)
    log(f"[4] {typ} nllk+grad at 1M steps, f32, wall ms: kernels {vg_k}, "
        f"plain {vg_p}")
    return dev_ms, {"nllk_grad_1M_ms": {"kernels": vg_k, "plain": vg_p},
                    "profile_per_nllk_grad_ms": {"device_busy": busy_ms,
                                                 "wall": prof_wall_ms},
                    "device_ms": dev_ms}


def elem_full_width(torch, sde, data, x_points, b32, b64, d32, d64,
                    plain64):
    """Phase 3d: the element-space path at config 5a's full width, f32,
    launch counts from zero over the path (llk2_analytic "fused" and
    "pallas" value + gradient at both points, sde.smoothed_states());
    then the gates against the f64 plain version and the f64 par-space
    kernels. Returns the launches and a summary."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.kalman_smooth import ctcrw_smoothed_states
    from smoothsde_tpu_torch.ops.kalman_soa import CtcrwFusedCore

    scans = ("fused", "pallas")
    cf.reset_launches()
    vals = {(where, scan): elem_outer_value_grad(b32, d32, x, scan, torch)
            for where, x in x_points.items() for scan in scans}
    t = time.perf_counter()
    means, covs = sde.smoothed_states()
    first_s = time.perf_counter() - t
    launches = dict(cf.LAUNCHES)
    log(f"[3d] launches over the path: {launches}")
    for name in ELEM_PATH["fused"] + ELEM_PATH["pallas"]:
        check(launches[name] > 0, f"kernel {name} never launched in 3d")

    acc = {}
    for (where, scan), (v32, g32) in vals.items():
        v64, g64 = plain64[where]
        ev = abs(v32 - v64) / abs(v64)
        eg = float(np.max(np.abs(g32 - g64)) / abs(v64))
        acc[f"{scan}_{where}_f32_vs_f64_plain"] = {
            "nllk_rel": ev, "grad_err_over_nllk": eg}
        check(ev <= 1e-4, f"3d {scan} f32 nllk at the {where}: rel {ev:.3e}")
        check(eg <= 1e-4, f"3d {scan} f32 gradient at the {where}: {eg:.3e}")
    ref = {where: outer_value_grad(b64, CtcrwFusedCore, d64, x, torch)
           for where, x in x_points.items()}
    gscale = max(float(np.max(np.abs(g))) for _, g in ref.values())
    for where, x in x_points.items():
        rv, rg = ref[where]
        for scan in scans:
            v, g = elem_outer_value_grad(b64, d64, x, scan, torch)
            ev = abs(v - rv) / abs(rv)
            eg = float(np.max(np.abs(g - rg))) / gscale
            acc[f"{scan}_{where}_f64_vs_par_space_f64"] = {
                "nllk_rel": ev, "grad_err_over_max_grad": eg}
            check(ev <= 1e-10, f"3d {scan} f64 nllk at the {where}: {ev:.3e}")
            check(eg <= 1e-8, f"3d {scan} f64 gradient at the {where}: "
                  f"{eg:.3e}")

    dev = torch.device("cuda")
    with torch.no_grad():
        full = b64.packer.unpack(torch.tensor(x_points["optimum"],
                                              dtype=torch.float64, device=dev))
        args = (b64.par_matrix(full), sde.obs(), data["time"], data["ID"],
                torch.exp(full["log_sigma_obs"][0]))
        m64, c64 = (t.cpu().numpy() for t in ctcrw_smoothed_states(
            *args, scan="associative"))
        mk, ck = (t.cpu().numpy() for t in ctcrw_smoothed_states(*args))
    sm = {}
    # the f32 covariance bar: at a track start the velocity variance is
    # the prior's 10 less ~9.9 of update, a cancellation that costs f32
    # ~2e-4 of the largest covariance in any scan order (PERF.md)
    for tag, (m, c), bars in (("f32_vs_f64_plain", (means, covs),
                               (1e-5, 1e-3, 1e-3)),
                              ("f64_kernels_vs_f64_plain", (mk, ck),
                               (1e-8, 1e-8, 1e-8))):
        check(np.all(np.isfinite(m)) and np.all(np.isfinite(c)),
              f"3d smoothed states {tag}: non-finite")
        errs = {
            "pos": float(np.max(np.abs(m[..., 0] - m64[..., 0]))
                         / np.max(np.abs(m64[..., 0]))),
            "vel": float(np.max(np.abs(m[..., 1] - m64[..., 1]))
                         / np.max(np.abs(m64[..., 1]))),
            "cov": float(np.max(np.abs(c - c64)) / np.max(np.abs(c64))),
        }
        sm[tag] = errs
        for (key, err), bar in zip(errs.items(), bars):
            check(err <= bar, f"3d smoothed {key} {tag}: {err:.3e} > {bar}")
    sm["max_abs_position"] = float(np.max(np.abs(m64[..., 0])))
    sm["max_abs_velocity"] = float(np.max(np.abs(m64[..., 1])))
    sm["max_abs_cov"] = float(np.max(np.abs(c64)))
    check(means.shape == (2, len(data["time"]), 2)
          and covs.shape == (2, len(data["time"]), 2, 2),
          f"smoothed states shapes {means.shape}, {covs.shape}")
    wall = wall_ms(lambda: sde.smoothed_states(), 5, 1)
    log(f"[3d] accuracy: {json.dumps(acc)}")
    log(f"[3d] smoothed states (errors relative to the largest value of "
        f"each kind): {json.dumps(sm)}; smoothed_states() wall ms {wall} "
        f"(first call {first_s * 1e3:.1f} ms)")
    return {"launches": launches,
            "summary": {"accuracy": acc, "smoothed_states": sm,
                        "smoothed_states_wall_ms": wall,
                        "smoothed_states_first_call_ms": first_s * 1e3}}


def elem_kernel_checks(torch, b32, b64, d32, d64, x):
    """Phase 4 for the element-space kernels and K8 at config 5a's
    shapes: each against its plain version (f64, max abs error within
    1e-8 of the output's scale), its time and its plain version's (f32,
    CUDA events), device times (profiler) and nllk+grad wall time of the
    "fused" and "pallas" paths. Returns ({kernel name: measurements},
    times)."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import scan_utils as su
    from smoothsde_tpu_torch.ops.kalman_smooth import rts_elements
    from smoothsde_tpu_torch.ops.kalman_soa import (
        _ID2,
        _combine2,
        _scan_elements,
    )

    dev = torch.device("cuda")
    ops_k, ops_p = cf.ELEM_OPS["kernels"], cf.ELEM_OPS["plain"]
    out = {name: {} for name, _, _ in ELEM_KERNELS}
    for dtype, dat, bun in ((torch.float64, d64, b64),
                            (torch.float32, d32, b32)):
        with torch.no_grad():
            full = bun.packer.unpack(torch.tensor(x, dtype=dtype, device=dev))
            sys = elem_system(bun.par_matrix(full),
                              torch.exp(full["log_sigma_obs"][0]), dat)
            d, n = sys.yd.shape
            p = cf.plan(d, n)
            h1 = sys.h.reshape(1)
            fst = cf.elem_forward_stack(sys, p)
            bst = cf.elem_backward_stack(sys, p)
            tot = ops_k.filter_totals(fst, h1, P0_POS, P0_VEL)
            pre = ops_k.block_prefix(tot, d, "filter", False)
            mom, _ = ops_k.filter_scan(fst, pre, h1, P0_POS, P0_VEL)
            stot = ops_k.smooth_totals(bst, mom)
            suf = ops_k.block_prefix(stot, d, "smooth", True)
            filt = _scan_elements(_combine2, _ID2, sys.elem, "pallas")
            te = torch.cat([sys.reset[1:], sys.reset.new_ones(1)])
            sm = rts_elements(sys.Ft, sys.ct, sys.Qt, filt.b, filt.C, te)[0]
            el_st = cf.pad_to_lanes(torch.stack(cf._pack_elem(sys.elem)),
                                    cf._ID_VALS, p)
            sm_st = cf.pad_to_lanes(torch.stack(cf._pack_sm(sm)), cf._ID_SM,
                                    p)
            calls = {
                "elem_filter_totals": lambda o: o.filter_totals(
                    fst, h1, P0_POS, P0_VEL),
                "elem_filter_scan": lambda o: o.filter_scan(
                    fst, pre, h1, P0_POS, P0_VEL),
                "elem_smooth_totals": lambda o: o.smooth_totals(bst, mom),
                "elem_score_scan": lambda o: o.score_scan(
                    bst, mom, suf, h1, P0_POS),
            }
            pairs = {name: (partial(fn, ops_k), partial(fn, ops_p))
                     for name, fn in calls.items()}
            pairs["phase1_scan_filter"] = (
                partial(su.pallas_phase1_scan, el_st, "filter"),
                partial(su.pallas_phase1_scan_plain, el_st, "filter"))
            pairs["phase1_scan_smooth"] = (
                partial(su.pallas_phase1_scan, sm_st, "smooth", True),
                partial(su.pallas_phase1_scan_plain, sm_st, "smooth", True))
            for name, (kfn, pfn) in pairs.items():
                got, ref = flat(kfn(), torch), flat(pfn(), torch)
                err = float((got - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                e = out[name]
                check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                if dtype == torch.float64:
                    e["max_abs_err"] = err
                    e["max_rel_err"] = err / scale
                    check(err <= 1e-8 * scale,
                          f"{name}: f64 kernel vs plain max abs err {err:.3e}")
                else:
                    e["max_abs_err_f32"] = err
                    e["ms"] = cuda_ms(kfn, 50, 3, torch)
                    e["plain_ms"] = cuda_ms(pfn, 3, 1, torch)
                    e["shape"] = f"n={n} d={d} lanes={p.lanes} L={p.L} f32"
                    e.update(bound(name, p, 4))
    times = {}
    for scan in ("fused", "pallas"):
        def vg(scan=scan):
            return elem_outer_value_grad(b32, d32, x, scan, torch)

        dev_ms, busy_ms, prof_wall_ms = profile_device_ms(vg, 10, torch)
        for name in ELEM_PATH[scan]:
            if name in out:
                out[name]["device_ms"] = dev_ms[name]
        times[f"nllk_grad_1M_ms_{scan}"] = wall_ms(vg, 110, 5)
        times[f"profile_per_nllk_grad_ms_{scan}"] = {
            "device_busy": busy_ms, "wall": prof_wall_ms,
            "device_ms": dev_ms}
        log(f"[4] llk2_analytic {scan}: profiler device busy {busy_ms:.3f} ms "
            f"of {prof_wall_ms:.3f} ms wall; nllk+grad wall ms "
            f"{times[f'nllk_grad_1M_ms_{scan}']}")
    for name, e in out.items():
        log(f"  {name}: {e['ms']:.4f} ms (plain {e['plain_ms']:.2f} ms), "
            f"f64 max abs err {e['max_abs_err']:.2e}")
    return out, times



# ---------------------------------------------------------------------------
# the generic and special filters: phases 2f, 3n, 3o, 3p and their part
# of phase 4
# ---------------------------------------------------------------------------

K8_KINDS = ("diag_filter", "diag_smooth", "sqrt2", "sqrt1")
# lanes below, at and across K8's 128-thread CUDA block for d = 1 (n / 32
# lanes), and a ragged n
K8_NS = (80, 4_064, 4_096, 4_128, 20_001)


def phase_k8(torch):
    """Phase 2f: K8 alone against its plain version on the card for the
    scalar-state and square-root kinds, both directions, d in {1, 2, 3},
    n in K8_NS, on real elements (slice_elements over two_track_data):
    f64 within 1e-10 of the output's scale, f32 (against the f64 plain
    version) within 1e-4. Launch counts from zero over the phase (the
    scalar smoothing kind has no fit path: this is its path). Returns
    ({kind: worst errors}, launches)."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import scan_utils as su

    dev = torch.device("cuda")
    worst = {f"{k} reverse={r}": {"f64": 0.0, "f32": 0.0}
             for k in K8_KINDS for r in (False, True)}
    cf.reset_launches()
    for d in (1, 2, 3):
        for n in K8_NS:
            obs, times, ids, par = two_track_data(d, n, seed=70 + d)
            pt = torch.tensor(par, device=dev)
            els = {**slice_elements(torch, "CTCRW", pt, 0.2, obs, times,
                                    ids),
                   **slice_elements(torch, "OU_SSM", pt, 0.2, obs, times,
                                    ids)}
            p = cf.plan(d, n)
            for kind in K8_KINDS:
                st = elem_stack(torch, kind, els[kind], p)
                for rev in (False, True):
                    ref = su.pallas_phase1_scan_plain(st, kind, rev)
                    got = su.pallas_phase1_scan(st, kind, rev)
                    got32 = su.pallas_phase1_scan(st.float(), kind, rev)
                    where = f"K8 {kind} reverse={rev} d={d} n={n}"
                    check(bool(torch.isfinite(got).all())
                          and bool(torch.isfinite(got32).all()),
                          f"{where}: non-finite")
                    scale = max(1.0, float(ref.abs().max()))
                    e64 = float((got - ref).abs().max()) / scale
                    e32 = float((got32.double() - ref).abs().max()) / scale
                    check(e64 <= 1e-10, f"{where}: f64 vs plain {e64:.3e}")
                    check(e32 <= 1e-4, f"{where}: f32 vs f64 plain {e32:.3e}")
                    w = worst[f"{kind} reverse={rev}"]
                    w["f64"], w["f32"] = max(w["f64"], e64), max(w["f32"],
                                                                 e32)
    launches = dict(cf.LAUNCHES)
    for kind in K8_KINDS:
        check(launches[f"phase1_scan_{kind}"] > 0,
              f"2f: K8 {kind} never launched")
    log(f"[2f] worst error over the output's scale: {json.dumps(worst)}")
    return worst, launches


def audit_data():
    """tools/accuracy_audit.py's 1M-step audit point, regenerated: (obs,
    times, ids, theta0)."""
    n = 1_000_000
    rng = np.random.default_rng(0)
    times = np.cumsum(rng.uniform(0.4, 0.6, size=n))
    obs = np.cumsum(rng.normal(size=(n, 2)) * 0.3, axis=0)
    return obs, times, np.zeros(n, np.int32), \
        [0.05, -0.02, np.log(2.0), np.log(1.0)]


def at_point(torch, bundle, x):
    """(par_matrix, sigma_obs) of a bundle at outer x, no gradient."""
    with torch.no_grad():
        full = bundle.packer.unpack(torch.tensor(
            x, dtype=bundle.dtype, device=bundle.device))
        return bundle.par_matrix(full), torch.exp(full["log_sigma_obs"][0])


def phase_sqrt(torch, card, data5a, res5a, d32, d64, b32, b64, ou):
    """Phase 3n: the square-root filter at config 5a. (a) the f32 fit with
    setup(kalman_impl="sqrt") ("blocked" plain scan, autograd): gates
    convergence, tau and nu within 5%, nllk within 1e-4 relative of phase
    3's fused fit; (b) at 3e's audit point `ctcrw_loglik_sqrt` value +
    gradient in f32 against the f64 plain version on the card (nllk
    1e-4 relative, gradient 1e-4 of |nllk|), printed beside
    docs/ACCURACY.md's "f32 sqrt (tpu)" column; (c) scan="pallas" (K8 and
    K2 `sqrt2` / `sqrt1` / Elem5) against "blocked" for
    `ctcrw_loglik_sqrt` at the 5a optimum and `diag_ssm_loglik_sqrt` and
    `diag_ssm_loglik_soa` at 3b's OU_SSM optimum, f64 within 1e-10
    relative, f32 within 1e-4, launch counts from zero over the pallas
    calls (the path). Returns (summary, launches)."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops.kalman_soa import (
        diag_ssm_loglik_soa,
        prepare_ctcrw_data,
    )
    from smoothsde_tpu_torch.ops.kalman_sqrt import (
        ctcrw_loglik_sqrt,
        diag_ssm_loglik_sqrt,
    )

    dev = torch.device("cuda")
    out = {"card": card}
    # (a) the fit
    cf.reset_launches()
    t = time.time()
    sde = SDE(data=data5a, type="CTCRW", response=["y1", "y2"],
              par0=[0, 0, 2, 0.8], device="cuda")
    sde.setup(kalman_impl="sqrt")
    res = sde.fit()
    torch.cuda.synchronize()
    wall = time.time() - t
    tau, nu = (float(v) for v in sde.par(t=0)[0, 2:4])
    e_v = abs(res.value - res5a.value) / abs(res5a.value)
    out["fit"] = {"wall_s": wall, "evals": res.counts["evals"],
                  "bfgs": res.counts, "via": res.convergence_via,
                  "tau": tau, "nu": nu, "nllk": res.value,
                  "nllk_rel_to_fused_fit": e_v,
                  "kernel_launches": {k: v for k, v in cf.LAUNCHES.items()
                                      if v}}
    log(f"[3n] sqrt fit: {json.dumps(out['fit'])}")
    check(res.convergence == 0, f"3n: sqrt fit did not converge: "
          f"{res.message}")
    check(abs(tau - 3.0) / 3.0 < 0.05 and abs(nu - 1.0) < 0.05,
          f"3n: tau {tau}, nu {nu} not within 5%")
    check(e_v <= 1e-4, f"3n: sqrt fit nllk {res.value} vs fused "
          f"{res5a.value}: rel {e_v:.3e}")

    # (b) the audit point
    obs, times, ids, theta0 = audit_data()
    n = len(ids)
    got = {}
    for dtype in (torch.float32, torch.float64):
        data = prepare_ctcrw_data(obs, times, ids, dtype=dtype, device=dev)
        th = torch.tensor(theta0, dtype=dtype, device=dev, requires_grad=True)
        v = ctcrw_loglik_sqrt(th.expand(n, 4), None, None, None, 0.1,
                              scan="blocked", data=data)
        (g,) = torch.autograd.grad(-v, th)
        got[dtype] = (-float(v.detach()), g.double().cpu().numpy())
    (v32, g32), (v64, g64) = got[torch.float32], got[torch.float64]
    check(np.isfinite(v32) and np.all(np.isfinite(g32)),
          "3n: non-finite f32 sqrt nllk or gradient")
    ev = abs(v32 - v64) / abs(v64)
    eg = float(np.max(np.abs(g32 - g64)) / abs(v64))
    names = ["mu1", "mu2", "log_tau", "log_nu"]
    per = {nm: float(abs(g32[i] - g64[i]) / abs(g64[i]))
           for i, nm in enumerate(names)}
    # docs/ACCURACY.md, 1M-step audit, "f32 sqrt (tpu)": the JAX
    # package's figures on one TPU v5e chip, not the port's
    jax_tpu = {"nllk": 3.3e-6, "mu1": 1.3e-5, "mu2": 4.7e-5,
               "log_tau": 8.7e-6, "log_nu": 8.1e-5}
    out["audit_point"] = {"nllk_f32": v32, "nllk_f64": v64,
                          "nllk_rel": ev, "grad_err_over_nllk": eg,
                          "grad_rel_per_component": per,
                          "jax_package_sqrt_tpu_rel": jax_tpu}
    log(f"[3n] audit point, f32 sqrt vs f64 sqrt on the card: "
        f"{json.dumps(out['audit_point'])}")
    check(ev <= 1e-4, f"3n: audit f32 sqrt nllk rel {ev:.3e}")
    check(eg <= 1e-4, f"3n: audit f32 sqrt gradient {eg:.3e} of |nllk|")

    # (c) "pallas" against "blocked", value only; the pallas calls are
    # the path of the new K8 / K2 instantiations
    pm = {dt: at_point(torch, b, res5a.par)
          for dt, b in ((torch.float32, b32), (torch.float64, b64))}
    ou_pm = {dt: at_point(torch, ou[f"b{tag}"], ou["res"].par)
             for dt, tag in ((torch.float32, "32"), (torch.float64, "64"))}
    cdata = {torch.float32: d32, torch.float64: d64}
    odata = {torch.float32: ou["d32"], torch.float64: ou["d64"]}
    fns = {
        "ctcrw_sqrt": lambda dt, scan: ctcrw_loglik_sqrt(
            pm[dt][0], None, None, None, pm[dt][1], scan=scan,
            data=cdata[dt]),
        "ou_sqrt": lambda dt, scan: diag_ssm_loglik_sqrt(
            "OU_SSM", ou_pm[dt][0], None, None, None, ou_pm[dt][1],
            scan=scan, data=odata[dt]),
        "ou_soa": lambda dt, scan: diag_ssm_loglik_soa(
            "OU_SSM", ou_pm[dt][0], None, None, None, ou_pm[dt][1],
            scan=scan, data=odata[dt]),
    }
    cmp = {}
    with torch.no_grad():
        blocked = {(k, dt): float(fn(dt, "blocked"))
                   for k, fn in fns.items()
                   for dt in (torch.float32, torch.float64)}
        cf.reset_launches()
        pallas = {(k, dt): float(fn(dt, "pallas"))
                  for k, fn in fns.items()
                  for dt in (torch.float32, torch.float64)}
        torch.cuda.synchronize()
        launches = dict(cf.LAUNCHES)
    for k in fns:
        e64 = abs(pallas[k, torch.float64] - blocked[k, torch.float64]) / \
            abs(blocked[k, torch.float64])
        e32 = abs(pallas[k, torch.float32] - blocked[k, torch.float32]) / \
            abs(blocked[k, torch.float32])
        e32_64 = abs(pallas[k, torch.float32] - blocked[k, torch.float64]) / \
            abs(blocked[k, torch.float64])
        cmp[k] = {"f64_rel": e64, "f32_rel": e32,
                  "f32_pallas_vs_f64_blocked": e32_64,
                  "llk_f64": blocked[k, torch.float64]}
        check(e64 <= 1e-10, f"3n: {k} pallas vs blocked f64 rel {e64:.3e}")
        check(e32 <= 1e-4, f"3n: {k} pallas vs blocked f32 rel {e32:.3e}")
        for name in SLICE_PATH[k]:
            check(launches[name] > 0, f"3n: {name} never launched by {k}")
    out["pallas_vs_blocked"] = cmp
    log(f"[3n] pallas vs blocked: {json.dumps(cmp)}; launches {launches}")
    # a gradient through the forward-only kernels raises
    p = pm[torch.float32][0].clone().requires_grad_(True)
    try:
        ctcrw_loglik_sqrt(p, None, None, None, pm[torch.float32][1],
                          scan="pallas", data=d32)
        raised = False
    except RuntimeError as err:
        raised = "forward-only" in str(err)
    check(raised, "3n: a gradient through scan='pallas' did not raise")
    return out, launches


def argos_H(n, seed):
    """Per-row 2x2 Argos-style error covariances: semi-axes a ~ U(0.05,
    0.2), b ~ U(0.02, 0.08) and an orientation ~ U(0, pi) per row."""
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(0.05, 0.2, size=n), rng.uniform(0.02, 0.08, size=n)
    th = rng.uniform(0.0, np.pi, size=n)
    c, s = np.cos(th), np.sin(th)
    H = np.empty((n, 2, 2))
    H[:, 0, 0] = a * a * c * c + b * b * s * s
    H[:, 1, 1] = a * a * s * s + b * b * c * c
    H[:, 0, 1] = H[:, 1, 0] = (a * a - b * b) * c * s
    return H


def config5a_H(n=1_000_000):
    """Config 5a's data with its observation noise re-simulated under a
    per-row Argos-style H (argos_H, seed 15): the latent path of
    config5a (noise-free), plus chol(H_i) eps_i. Returns (data, H)."""
    data = config5a(n, sobs=0.0)
    H = argos_H(n, 15)
    eps = np.random.default_rng(16).normal(size=(n, 2))
    L = np.linalg.cholesky(H)
    noise = np.einsum("nij,nj->ni", L, eps)
    data["y1"] = data["y1"] + noise[:, 0]
    data["y2"] = data["y2"] + noise[:, 1]
    return data, H


def f64_twin_of(torch, sde, kw, name):
    """A float64 model on the card holding sde's fit (through a
    checkpoint under build/)."""
    from smoothsde_tpu_torch import SDE

    path = os.path.join(HERE, "build", f"chip_smoke_{name}.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sde.save_state(path)
    return SDE(**kw, device="cuda", dtype=torch.float64).load_state(path)


def states_and_residuals(torch, label, sde, sde64, expect_nan):
    """filtered_states() and residuals() of a fitted model in f32 and in
    f64 (its f64 twin at the same estimates): walls, finite exactly
    where JAX gives finite (residuals NaN at `expect_nan`, the rows
    without a measurement update); the f32 states within 1e-3 of the
    largest f64 state, the f32 residuals within 0.1 of the f64 ones (a
    tenth of their N(0, 1) scale: an f32 filter's error in a 1e3-scale
    position, divided by sqrt(F) ~ 0.1, sets their floor; the relative
    error is printed)."""
    out = {}
    for what in ("filtered_states", "residuals"):
        vals = {}
        for tag, m in (("f32", sde), ("f64", sde64)):
            t = time.perf_counter()
            vals[tag] = getattr(m, what)()
            out[f"{what}_{tag}_wall_s"] = time.perf_counter() - t
        a, b = vals["f32"], vals["f64"]
        nan = np.isnan(b).any(axis=-1) if what == "residuals" else \
            np.zeros(len(b), bool)
        want_nan = expect_nan if what == "residuals" else nan
        check(np.array_equal(np.isnan(a), np.isnan(b))
              and np.array_equal(np.isnan(b).any(axis=-1), want_nan)
              and np.all(np.isfinite(b[~want_nan])),
              f"{label}: {what} not finite exactly where expected")
        diff = float(np.nanmax(np.abs(a - b)))
        err = diff / float(np.nanmax(np.abs(b)))
        out[f"{what}_f32_vs_f64"] = err
        out[f"{what}_f32_vs_f64_abs"] = diff
        out[f"{what}_shape"] = list(a.shape)
        if what == "residuals":
            check(diff <= 0.1, f"{label}: residuals f32 vs f64 {diff:.3e}")
        else:
            check(err <= 1e-3, f"{label}: {what} f32 vs f64 {err:.3e} of "
                  f"the largest")
    log(f"[{label}] states and residuals: {json.dumps(out)}")
    return out


def phase_user_H(torch, card, sde5a, kw5a):
    """Phase 3o: user H and the generic filter at config 5a's width (1M
    steps, d = 2, a per-row Argos-style H): fits with "auto" (the
    parallel full-state filter on the card) in f32 and f64. Gates: both
    converge; the f32 nllk and gradient against f64 on the card at the
    f32 optimum (1e-4 relative / 1e-4 of |nllk|); tau and nu within 5%
    for the f64 fit. The f32 fit's tau and nu are printed, not gated:
    the JAX package's f32 stopping rule, max |g| < 1e-3 (1 + |nllk|)
    (3,394 here), ends its BFGS where the f32 gradient, accurate to a
    few units, still reads ~1,800 in log tau (PERF.md §6). Then
    filtered_states() and residuals() on the f32 fit and on phase 3's
    isotropic fit, f32 against f64 at the same estimates."""
    from smoothsde_tpu_torch.infer.fit import make_val_grad

    data, H = config5a_H()
    kw = dict(data=data, type="CTCRW", response=["y1", "y2"],
              par0=[0, 0, 2, 0.8], other_data={"H": H})
    out = {"card": card}
    fits = {}
    for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        sde, res, wall = fit_on_card(torch, "3o", kw, dtype)
        tau, nu = (float(v) for v in sde.par(t=0)[0, 2:4])
        fits[tag] = (sde, res)
        out[f"fit_{tag}"] = {"wall_s": wall, "evals": res.counts["evals"],
                             "bfgs": res.counts, "via": res.convergence_via,
                             "tau": tau, "nu": nu, "nllk": res.value,
                             "twin": sde.bundle().twin}
        check(res.convergence == 0,
              f"3o: {tag} H fit did not converge: {res.message}")
        check(sde.bundle().twin == "parallel", "3o: not the parallel filter")
        if tag == "f64":
            check(abs(tau - 3.0) / 3.0 < 0.05 and abs(nu - 1.0) < 0.05,
                  f"3o: f64 fit tau {tau}, nu {nu} not within 5%")
    sde, res = fits["f32"]
    sde64 = f64_twin_of(torch, sde, kw, "user_H")
    v32, g32, _ = make_val_grad(sde.bundle())(res.par)
    v64, g64, _ = make_val_grad(sde64.bundle())(res.par)
    ev = abs(v32 - v64) / abs(v64)
    eg = float(np.max(np.abs(g32 - g64)) / abs(v64))
    out["f32_vs_f64_at_f32_optimum"] = {
        "nllk_f32": v32, "nllk_f64": v64, "nllk_rel": ev,
        "grad_err_over_nllk": eg, "grad_f32": g32.tolist(),
        "grad_f64": g64.tolist(),
        "f32_stop_gtol": 1e-3 * (1.0 + abs(v32))}
    vg = wall_ms(lambda: make_val_grad(sde.bundle())(res.par), 5, 1)
    out["nllk_grad_1M_ms"] = vg
    log(f"[3o] fits {json.dumps({k: out[k] for k in ('fit_f32', 'fit_f64')})}"
        f"; f32 vs f64 {json.dumps(out['f32_vs_f64_at_f32_optimum'])}; "
        f"nllk+grad wall ms {vg}")
    check(ev <= 1e-4, f"3o: f32 nllk rel {ev:.3e}")
    check(eg <= 1e-4, f"3o: f32 gradient {eg:.3e} of |nllk|")
    row0 = np.zeros(len(data["time"]), bool)
    row0[0] = True  # one track, no NaN row: only the start has no update
    out["user_H"] = states_and_residuals(torch, "3o H", sde, sde64, row0)
    iso64 = f64_twin_of(torch, sde5a, kw5a, "isotropic_5a")
    out["isotropic_5a"] = states_and_residuals(torch, "3o 5a", sde5a, iso64,
                                               row0)
    return out


def eseal_tracks(K=16, n=1000, mu_t=0.05, sigma_t=0.12, a1_t=-0.578,
                 a2_t=1.214, tau_t=0.08):
    """K tracks of n drift dives from tests/test_models_fit.py
    `_eseal_sim`'s generative model (nllk_e_seal_ssm.hpp:11-59), one
    seed per track (100 + k), with h ~ U(80, 120) and R ~ U(9, 11) varying
    by dive: L_{i+1} = L_i + mu dt + sigma sqrt(dt) eps,
    z_i = a1 + (a2 / R_i) L_i + (tau / sqrt(h_i)) nu_i, L_0 ~ 60."""
    cols = {"ID": [], "time": [], "z": [], "h": [], "R": [], "dep": []}
    for k in range(K):
        rng = np.random.default_rng(100 + k)
        L = 60.0 + rng.normal() + np.concatenate([[0.0], np.cumsum(
            mu_t + sigma_t * rng.normal(size=n - 1))])
        R = rng.uniform(9.0, 11.0, size=n)
        h = rng.uniform(80.0, 120.0, size=n)
        z = a1_t + a2_t * L / R + rng.normal(size=n) * tau_t / np.sqrt(h)
        cols["ID"] += [k] * n
        cols["time"] += list(np.arange(n, dtype=float))
        cols["z"] += list(z)
        cols["h"] += list(h)
        cols["R"] += list(R)
        cols["dep"] += [L[0]] * n
    c = {k: np.asarray(v) for k, v in cols.items()}
    return ({"ID": c["ID"], "time": c["time"], "z": c["z"]},
            {"h": c["h"], "R": c["R"], "dep_fat": c["dep"]},
            {"mu": mu_t, "sigma": sigma_t, "tau": tau_t})


def phase_eseal(torch, card):
    """Phase 3p: ESEAL_SSM, 16 tracks x 1,000 dives, in f32 on the card
    (the parallel full-state filter), a1 and log_a2 pinned as in the JAX
    package's recovery test, with the default (Schick et al. 2013) priors
    and with priors=None. Gates: convergence of both; without priors mu,
    sigma and tau at TestESEAL.test_recovery's bars (0.03, 0.06, 0.04
    absolute); with them (their pseudo-count of 10 n pins sigma^2 near
    4, so the truth is no bar) the f32 nllk within 1e-4 relative of the
    f64 evaluation at the optimum."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad

    data, other, truth = eseal_tracks()
    out = {"card": card, "n": len(data["ID"])}
    for tag, priors in (("schick2013", "schick2013"), ("no_priors", None)):
        kw = dict(data=data, type="ESEAL_SSM", response="z",
                  other_data={**other, "priors": priors}, par0=[0.0, 0.3])
        t = time.time()
        sde = SDE(**kw, device="cuda")
        res = sde.fit(map={"a1": [True], "log_a2": [True]})
        torch.cuda.synchronize()
        wall = time.time() - t
        mu, sigma = (float(v) for v in sde.par(t=0)[0, :2])
        est = dict(zip(res.par_names, res.par))
        tau = float(np.exp(est["log_tau"]))
        r = {"wall_s": wall, "evals": res.counts["evals"],
             "via": res.convergence_via, "mu": mu, "sigma": sigma,
             "tau": tau, "nllk": res.value, "twin": sde.bundle().twin}
        check(res.convergence == 0, f"3p {tag}: ESEAL fit did not converge: "
              f"{res.message}")
        if priors is None:
            for nm, got, bar in (("mu", mu, 0.03), ("sigma", sigma, 0.06),
                                 ("tau", tau, 0.04)):
                check(abs(got - truth[nm]) < bar,
                      f"3p: {nm} {got} vs {truth[nm]} (bar {bar})")
        else:
            b64 = SDE(**kw, device="cuda", dtype=torch.float64).setup(
                map={"a1": [True], "log_a2": [True]})
            v64, _, _ = make_val_grad(b64)(res.par)
            r["nllk_f64_at_optimum"] = v64
            r["nllk_rel"] = abs(res.value - v64) / abs(v64)
            check(r["nllk_rel"] <= 1e-4,
                  f"3p: f32 nllk {res.value} vs f64 {v64}")
        out[tag] = r
        log(f"[3p] {tag}: {json.dumps(r)}")
    return out


SHARDS = 4  # phase 3q's shards, all on cuda:0
# calls a 3q profile averages: the profiler's own processing grows with
# the ~1,500 operations of a sharded call
PROFILE_REPS = 3


def bundle_value_grad(torch, bundle, x, fn=None):
    """(joint nllk, its gradient in x) of a bundle: x the outer vector
    (the inner coefficients at their initial values) or the outer and
    inner vectors concatenated; fn: the bundle's joint_nllk unless
    given."""
    fn = fn or bundle.joint_nllk
    xt = torch.tensor(x, dtype=bundle.dtype, device=bundle.device,
                      requires_grad=True)
    n_out = bundle.packer.n_outer
    v = fn(bundle.packer.unpack(xt[:n_out], xt[n_out:] if len(x) > n_out
                                else None))
    (g,) = torch.autograd.grad(v, xt)
    return float(v.detach()), g.double().cpu().numpy()


def stitch_device_ms(torch, d, sizes, dtype, elems):
    """Device ms per nllk+grad of the stitch's own operations, the ones
    the time-sharded cores run between K2 and K1b / K3b (D1b / D3b):
    each chunk's total, the exclusive prefixes and suffixes of the totals,
    and their fold into every block's prefix / suffix, for the forward and
    the backward element kinds `elems`, at chunks of `sizes` steps
    (profiled alone, on identity elements of the real shapes; the
    arithmetic does not depend on the values)."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    work = []
    for elem, reverse in zip(elems, (False, True)):
        ids = cf.ELEMS[elem].id_vals
        excl = [torch.tensor(ids, dtype=dtype, device="cuda")[:, None].expand(
            len(ids), cf.plan(d, m).lanes).contiguous() for m in sizes]
        work.append((elem, reverse, excl))

    def fn():
        for elem, reverse, excl in work:
            totals = cf.chunk_totals(excl, excl, d, elem, reverse,
                                     excl[0].device)
            cf.seed_chunks(cf.stitch_seeds(totals, elem, reverse), excl, d,
                           elem)

    stats = {}
    _, busy, _ = profile_device_ms(fn, PROFILE_REPS, torch, stats)
    return busy, stats["device_ops"]


def time_sharded_case(torch, card, label, kw, truth, flat, names, elems):
    """Phase 3q-a / 3q-b: `kw`'s 1M-step model fitted with the time axis
    cut into SHARDS chunks on cuda:0, in f32. flat: the unsharded phase's
    f32 and f64 bundles ("b32", "b64"), fit result ("res") and wall
    ("wall_s"), and the f64 plain version's (value, gradient) at the
    start ("plain_start"). Gates: convergence; the truth by parameter
    name (mus within 0.05, the rest within 5%); the nllk within 1e-4 relative of the
    unsharded fit's; at the start the f64 sharded kernels against the f64
    unsharded kernel route (value 1e-10 relative, gradient 1e-8 of its
    largest component) and the f32 sharded kernels against the f64 plain
    version (1e-4 relative, gradient 1e-4 of |nllk|); each kernel of
    `names` launched once a chunk per nllk+grad. Printed: the sharded and
    unsharded nllk+grad walls (median and p90 of 110), device busy, and
    the stitch's own device time."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.parallel.batching import make_mesh, shard_sizes

    t_case = time.time()
    b32_flat, b64_flat, res_flat = flat["b32"], flat["b64"], flat["res"]
    pv64, pg64 = flat["plain_start"]
    mesh = make_mesh(SHARDS, "time", device="cuda:0")
    cf.reset_launches()
    t = time.time()
    sde = SDE(**kw, device="cuda")
    res = sde.fit(mesh=mesh, mesh_axis="time")
    torch.cuda.synchronize()
    wall = time.time() - t
    fit_launches = {k: cf.LAUNCHES[k] for k in names}
    est = dict(zip(sde.formulas(), (float(v) for v in sde.par(t=0)[0])))
    log(f"[{label}] {kw['type']} fit over {SHARDS} time chunks: {wall:.2f} "
        f"s, {res.counts['evals']} evals, via {res.convergence_via}, "
        f"estimates {json.dumps(est)}, nllk {res.value:.4f} (unsharded "
        f"{res_flat.value:.4f}); launches {fit_launches}")
    check(res.convergence == 0, f"{label}: sharded fit did not converge: "
          f"{res.message}")
    for nm, want in truth.items():
        got = est[nm]
        check(abs(got - want) <= 0.05 if nm.startswith("mu")
              else abs(got - want) / want < 0.05,
              f"{label}: {nm} {got} vs {want}")
    ev_fit = abs(res.value - res_flat.value) / abs(res_flat.value)
    check(ev_fit <= 1e-4, f"{label}: sharded nllk {res.value} vs unsharded "
          f"{res_flat.value}: rel {ev_fit:.3e}")

    bsh32 = sde.bundle()
    bsh64 = SDE(**kw, device="cuda", dtype=torch.float64).setup(
        mesh=mesh, mesh_axis="time")
    x0 = b32_flat.packer.outer_init()
    v64, g64 = bundle_value_grad(torch, bsh64, x0)
    fv64, fg64 = bundle_value_grad(torch, b64_flat, x0)
    v32, g32 = bundle_value_grad(torch, bsh32, x0)
    acc = {"f64_vs_unsharded_nllk_rel": abs(v64 - fv64) / abs(fv64),
           "f64_vs_unsharded_grad_over_max": float(
               np.max(np.abs(g64 - fg64)) / np.max(np.abs(fg64))),
           "f32_vs_f64_plain_nllk_rel": abs(v32 - pv64) / abs(pv64),
           "f32_vs_f64_plain_grad_over_nllk": float(
               np.max(np.abs(g32 - pg64)) / abs(pv64))}
    log(f"[{label}] at the start: {json.dumps(acc)}")
    check(acc["f64_vs_unsharded_nllk_rel"] <= 1e-10
          and acc["f64_vs_unsharded_grad_over_max"] <= 1e-8,
          f"{label}: f64 sharded vs unsharded kernels: {acc}")
    check(acc["f32_vs_f64_plain_nllk_rel"] <= 1e-4
          and acc["f32_vs_f64_plain_grad_over_nllk"] <= 1e-4,
          f"{label}: f32 sharded vs f64 plain: {acc}")

    x = res.par
    cf.reset_launches()
    bundle_value_grad(torch, bsh32, x)
    per_eval = {k: cf.LAUNCHES[k] for k in names}
    for nm in names:
        check(per_eval[nm] == SHARDS, f"{label}: {nm} launched "
              f"{per_eval[nm]} times a nllk+grad, not once per chunk")
    walls = {tag: wall_ms(lambda b=b: bundle_value_grad(torch, b, x), 110, 5)
             for tag, b in (("sharded", bsh32), ("unsharded", b32_flat))}
    t_prof = time.time()
    prof = {}
    for tag, b in (("sharded", bsh32), ("unsharded", b32_flat)):
        dev_ms, busy, pwall = profile_device_ms(
            lambda b=b: bundle_value_grad(torch, b, x), PROFILE_REPS, torch)
        prof[tag] = {"device_busy_ms": busy, "wall_ms": pwall,
                     "kernels_ms": {k: dev_ms[k] for k in names}}
    sizes = shard_sizes(len(kw["data"]["ID"]), SHARDS)
    stitch_ms, stitch_ops = stitch_device_ms(
        torch, len(kw["response"]) if isinstance(kw["response"], list)
        else 1, sizes, torch.float32, elems)
    out = {"card": card, "shards": SHARDS, "fit_wall_s": wall,
           "fit_wall_s_unsharded": flat["wall_s"],
           "evals": res.counts["evals"],
           "via": res.convergence_via, "estimates": est, "nllk": res.value,
           "nllk_unsharded": res_flat.value, "nllk_rel": ev_fit,
           "accuracy_start": acc, "launches_fit": fit_launches,
           "launches_per_nllk_grad": per_eval,
           "nllk_grad_ms": walls, "profile": prof,
           "stitch_device_ms": stitch_ms, "stitch_device_ops": stitch_ops,
           "stitch_share_of_busy": stitch_ms / prof["sharded"][
               "device_busy_ms"],
           "wall_ratio_sharded_to_unsharded": walls["sharded"]["median"]
           / walls["unsharded"]["median"],
           "case_wall_s": time.time() - t_case,
           "profiles_wall_s": time.time() - t_prof}
    log(f"[{label}] {json.dumps(out)}")
    return out


def phase_sharding(torch, card, cases, c4, colored):
    """Phase 3q: sharded fits on cuda:0 (SHARDS shards on the one card).
    3q-a, 3q-b: the time-sharded 5a CTCRW and 3b OU_SSM
    (`time_sharded_case`; each case (label, SDE keywords, truth by
    parameter name, the unsharded phase's results, the kernels, the
    element kinds)). 3q-c: config 4 with its tracks in SHARDS
    shards, f32: convergence and the nllk within 1e-4 relative of 3i's f32
    fit; f64: convergence and the estimates within 0.1 of 3i's f64
    standard errors of 3i's f64 fit (1 for the log smoothing parameter,
    as 3i); in f64 at tests/golden/config4.npz's outer point (inner at
    their initial values + 0.05) the sharded joint nllk (the kernels) and
    its twin against the unsharded ones, value 1e-10 relative and
    gradient in the outer and inner vectors 1e-8 of its largest
    component. The f32 estimates' distance from 3i's f64 fit in its
    standard errors is printed, not gated: the JAX package's f32 stopping
    rule (max |g| < 1e-3 (1 + |nllk|), 3.2 here) lets the sharded fit's
    rounding path stop 0.31 standard errors off (PERF.md §6), as it does
    3o's f32 fit; the f64 fit (stopping at 1e-6) is the witness free of
    that rule.
    3q-d: 3k's 40 x 30 BM with its tracks sharded, f32: convergence, the
    nllk at the optimum within 1e-4 relative of 3k's. 3q-e: 3p's ESEAL
    data (16 x 1,000 dives, one time axis over the tracks), f64: the
    time-sharded full-state filter's value and gradient at the start
    against the unsharded route's, 1e-10 / 1e-8 of the largest
    component."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.parallel.batching import make_mesh

    t0 = time.time()
    out = {}
    for tag, (label, kw, truth, flat, names, elems) in cases.items():
        log(f"[{label}] time-sharded {kw['type']}, {SHARDS} chunks")
        out[tag] = time_sharded_case(torch, card, label, kw, truth, flat,
                                     names, elems)

    t_c = time.time()
    tracks = make_mesh(SHARDS, "tracks", device="cuda:0")
    kw4, _ = config4()
    sde4, res4, wall4 = fit_on_card(torch, "3q-c", kw4, torch.float32,
                                    mesh=tracks)
    dse = (res4.par - np.asarray(c4["par_f64"])) / np.asarray(c4["se_f64"])
    ev4 = abs(res4.value - c4["nllk"]) / abs(c4["nllk"])
    check(res4.convergence == 0 and ev4 <= 1e-4,
          f"3q-c: sharded f32 fit: {res4.message}, nllk {res4.value} vs "
          f"3i's {c4['nllk']}")
    _, res64, wall64 = fit_on_card(torch, "3q-c", kw4, torch.float64,
                                   mesh=tracks)
    dse64 = (res64.par - np.asarray(c4["par_f64"])) / np.asarray(
        c4["se_f64"])
    smoothing = np.asarray(c4["smoothing"])
    check(res64.convergence == 0 and np.all(np.isfinite(dse64))
          and float(np.max(np.abs(dse64[~smoothing]))) <= 0.1
          and float(np.max(np.abs(dse64[smoothing]))) <= 1.0,
          f"3q-c: sharded f64 fit: {res64.message}, estimates "
          f"{res64.par.tolist()}: {dse64.tolist()} of 3i's f64 standard "
          f"errors from 3i's f64 fit")
    fx = np.load(os.path.join(HERE, "tests", "golden", "config4.npz"))
    e64 = {}
    b64s = [SDE(**kw4, device="cuda", dtype=torch.float64).setup(mesh=m)
            for m in (tracks, None)]
    z = np.concatenate([fx["outer"], b64s[1].packer.inner_init() + 0.05])
    for route in ("joint_nllk", "joint_nllk_ad"):
        (v, g), (fv, fg) = (bundle_value_grad(
            torch, b, z, lambda full, b=b, route=route: getattr(b, route)(
                full)) for b in b64s)
        e64[route] = {"nllk_rel": abs(v - fv) / abs(fv),
                      "grad_over_max": float(np.max(np.abs(g - fg))
                                             / np.max(np.abs(fg)))}
        check(e64[route]["nllk_rel"] <= 1e-10
              and e64[route]["grad_over_max"] <= 1e-8,
              f"3q-c: f64 sharded {route} at the golden point vs "
              f"unsharded: {e64[route]}")
    out["config4_tracks"] = {
        "fit_wall_s": wall4, "fit_wall_s_unsharded": c4["fit_wall_s"],
        "evals": res4.counts["evals"], "via": res4.convergence_via,
        "nllk": res4.value, "nllk_unsharded": c4["nllk"], "nllk_rel": ev4,
        "par_minus_f64_over_se64": dse.tolist(),
        "f64_fit_wall_s": wall64, "f64_evals": res64.counts["evals"],
        "nllk_f64": res64.value, "nllk_f64_unsharded": c4["nllk_f64"],
        "par_f64_minus_f64_over_se64": dse64.tolist(),
        "f64_vs_unsharded_at_golden": e64, "case_wall_s": time.time() - t_c}
    log(f"[3q-c] {json.dumps(out['config4_tracks'])}")

    kwk = dict(data=multi_animal_bm(), type="BM", response="z",
               formulas={"mu": "~1", "sigma": "~s(ID, bs='re')"},
               par0=[0.0, 1.0])
    _, resk, wallk = fit_on_card(torch, "3q-d", kwk, torch.float32,
                                 mesh=tracks)
    ev = abs(resk.value - colored["nllk"]) / abs(colored["nllk"])
    check(resk.convergence == 0 and ev <= 1e-4,
          f"3q-d: sharded BM nllk {resk.value} vs 3k's {colored['nllk']}")
    out["bm_colored_tracks"] = {
        "fit_wall_s": wallk, "fit_wall_s_unsharded": colored["fit_wall_s"],
        "evals": resk.counts["evals"], "nllk": resk.value, "nllk_rel": ev,
        "par_minus_unsharded_max_abs": float(np.max(np.abs(
            resk.par - np.asarray(colored["par"]))))}
    log(f"[3q-d] {json.dumps(out['bm_colored_tracks'])}")

    t_e = time.time()
    data, other, _ = eseal_tracks()
    kwe = dict(data=data, type="ESEAL_SSM", response="z", other_data=other,
               par0=[0.0, 0.3])
    f64 = torch.float64
    be = SDE(**kwe, device="cuda", dtype=f64).setup(
        mesh=make_mesh(SHARDS, "time", device="cuda:0"), mesh_axis="time")
    bf = SDE(**kwe, device="cuda", dtype=f64).setup()
    x0 = bf.packer.outer_init()
    (v, g), (fv, fg) = (bundle_value_grad(torch, b, x0) for b in (be, bf))
    e = {"nllk_rel": abs(v - fv) / abs(fv),
         "grad_over_max": float(np.max(np.abs(g - fg)) / np.max(np.abs(fg))),
         "ms_sharded": wall_ms(lambda: bundle_value_grad(torch, be, x0), 5,
                               1),
         "ms_unsharded": wall_ms(lambda: bundle_value_grad(torch, bf, x0), 5,
                                 1)}
    check(e["nllk_rel"] <= 1e-10 and e["grad_over_max"] <= 1e-8,
          f"3q-e: ESEAL time-sharded vs unsharded: {e}")
    e["case_wall_s"] = time.time() - t_e
    out["eseal_time"] = e
    log(f"[3q-e] {json.dumps(e)}")
    out["phase_wall_s"] = time.time() - t0
    log(f"[3q] {out['phase_wall_s']:.1f} s")
    return out


def slice_kernel_checks(torch, b32, b64, d32, d64, x5a, ou):
    """Phase 4 for the K8 / K2 instantiations of the generic and special
    filters at full width: K8 and K2 `sqrt2` on config 5a's square-root
    elements at its optimum, `sqrt1`, `diag_filter`, `diag_smooth` on
    3b's OU_SSM elements at its optimum; each against its plain version
    (f64, max abs error within 1e-8 of the output's scale), its time and
    its plain version's (f32, CUDA events), its bound, and the device
    time of one call of each (profiler). K2 `sqrt2` / `sqrt1` also in
    f64 (CUDA events, bound; their device time by CUDA kernel is phase
    2b's). Returns {kernel name: measurements}."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import scan_utils as su

    out = {name: {} for name, _, _ in SLICE_KERNELS}
    calls32 = {}
    for dtype, b, dat, bo, do in ((torch.float64, b64, d64, ou["b64"],
                                   ou["d64"]),
                                  (torch.float32, b32, d32, ou["b32"],
                                   ou["d32"])):
        with torch.no_grad():
            pm, sobs = at_point(torch, b, x5a)
            opm, osobs = at_point(torch, bo, ou["res"].par)
            els = {**slice_elements(torch, "CTCRW", pm, sobs, data=dat),
                   **slice_elements(torch, "OU_SSM", opm, osobs, data=do)}
            stacks = {}
            for kind, el in els.items():
                p = cf.plan(2, pm.shape[0] if kind == "sqrt2"
                            else opm.shape[0])
                stacks[kind] = (elem_stack(torch, kind, el, p), p)
            pairs = {}
            for kind in K8_KINDS:
                st, p = stacks[kind]
                rev = kind == "diag_smooth"
                pairs[f"phase1_scan_{kind}"] = (
                    partial(su.pallas_phase1_scan, st, kind, rev),
                    partial(su.pallas_phase1_scan_plain, st, kind, rev), p)
            for kind in ("sqrt2", "sqrt1"):
                st, p = stacks[kind]
                tot = su.pallas_phase1_scan(st, kind)[-1].contiguous()
                pairs[f"block_prefix_{kind}"] = (
                    partial(cf.block_prefix, tot, 2, kind, False),
                    partial(cf.block_prefix_plain, tot, 2, kind, False), p)
            for name, (kfn, pfn, p) in pairs.items():
                got, ref = flat(kfn(), torch), flat(pfn(), torch)
                err = float((got - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                e = out[name]
                check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                if dtype == torch.float64:
                    e["max_abs_err"] = err
                    e["max_rel_err"] = err / scale
                    check(err <= 1e-8 * scale,
                          f"{name}: f64 kernel vs plain max abs err {err:.3e}")
                    if name.startswith("block_prefix_"):  # K2, in f64 too
                        e["ms_f64"] = cuda_ms(kfn, 50, 3, torch)
                        e["bound_ms_f64"] = bound(name, p, 8)["bound_ms"]
                else:
                    e["max_abs_err_f32"] = err
                    e["max_rel_err_f32"] = err / scale
                    e["ms"] = cuda_ms(kfn, 50, 3, torch)
                    e["plain_ms"] = cuda_ms(pfn, 3, 1, torch)
                    e["shape"] = (f"n={p.n} d={p.d} lanes={p.lanes} L={p.L} "
                                  f"f32")
                    e.update(bound(name, p, 4))
                    calls32[name] = kfn

    def all_calls():
        for fn in calls32.values():
            fn()

    dev_ms, _, _ = profile_device_ms(all_calls, 10, torch)
    for name, e in out.items():
        e["device_ms"] = dev_ms[name]
        log(f"  {name}: {e['ms']:.4f} ms (plain {e['plain_ms']:.2f} ms), "
            f"device {e['device_ms'] * 1e3:.1f} us, bound "
            f"{e['bound_us']:.1f} us, f64 max abs err {e['max_abs_err']:.2e}")
        if "ms_f64" in e:
            log(f"    f64: {e['ms_f64'] * 1e3:.1f} us a call, bound "
                f"{e['bound_ms_f64'] * 1e3:.2f} us")
    return out


MP_RANKS = 2  # phase 3r's processes, both on cuda:0
MP_SHARDS = 2  # each process's shards
MP_TIMEOUT_S = 600


def mp_rank(rank, store, out, cases, kw4, z4):
    """One process of phase 3r: joins a gloo group of MP_RANKS processes
    (a FileStore at `store`), runs `mp_cases` on ("dcn", axis) meshes of
    MP_SHARDS shards on cuda:0, and pickles the results to
    <out>.<rank>. Any error raises out of the process (a non-zero exit
    code, which fails the phase)."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=MP_RANKS,
        rank=rank, timeout=datetime.timedelta(seconds=MP_TIMEOUT_S))
    try:
        res = mp_cases(torch, cases, kw4, z4)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def mp_cases(torch, cases, kw4, z4):
    """Phase 3r's work in one process. For each time case (SDE keywords,
    the kernels of its path): the f64 joint nllk and gradient at the
    start, the f32 fit with its launches, the launches and wall of one
    f32 nllk+grad at the optimum, and the f32 optimizer="device" fit
    with its steps and wall. For config 4 by tracks, f64 at the
    golden point: the joint nllk and its twin with their gradients, and
    the Laplace marginal's value and gradient with its launches."""
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.parallel.batching import Mesh

    f64 = torch.float64
    out = {}
    for tag, (kw, names) in cases.items():
        t_case = time.time()
        mesh = Mesh(["cuda:0"] * MP_SHARDS, ("dcn", "time"))
        b64 = SDE(**kw, device="cuda", dtype=f64).setup(mesh=mesh,
                                                       mesh_axis="time")
        x0 = b64.packer.outer_init()
        v64, g64 = bundle_value_grad(torch, b64, x0)
        del b64
        cf.reset_launches()
        t = time.time()
        sde = SDE(**kw, device="cuda")
        res = sde.fit(mesh=mesh, mesh_axis="time")
        torch.cuda.synchronize()
        wall = time.time() - t
        fit_launches = {k: cf.LAUNCHES[k] for k in names}
        b32 = sde.bundle()
        cf.reset_launches()
        bundle_value_grad(torch, b32, res.par)
        per_eval = {k: cf.LAUNCHES[k] for k in names}
        walls = wall_ms(lambda: bundle_value_grad(torch, b32, res.par), 30,
                        3)
        t = time.time()
        dev = SDE(**kw, device="cuda").fit(mesh=mesh, mesh_axis="time",
                                           optimizer="device")
        torch.cuda.synchronize()
        dev_wall = time.time() - t
        out[tag] = {"v64_start": v64, "g64_start": g64, "par": res.par,
                    "nllk": res.value, "convergence": res.convergence,
                    "via": res.convergence_via,
                    "evals": res.counts["evals"], "fit_wall_s": wall,
                    "launches_fit": fit_launches,
                    "launches_per_nllk_grad": per_eval,
                    "nllk_grad_ms": walls,
                    "device_fit": {
                        "par": dev.par, "nllk": dev.value,
                        "convergence": dev.convergence,
                        "via": dev.convergence_via, "steps": dev.device_steps,
                        "graph": dev.device_graph, "counts": dev.counts,
                        "fit_wall_s": dev_wall},
                    "case_wall_s": time.time() - t_case}
    t_case = time.time()
    mesh = Mesh(["cuda:0"] * MP_SHARDS, ("dcn", "tracks"))
    b = SDE(**kw4, device="cuda", dtype=f64).setup(mesh=mesh)
    c4 = {}
    for route in ("joint_nllk", "joint_nllk_ad"):
        c4[route] = bundle_value_grad(
            torch, b, z4, lambda full, route=route: getattr(b, route)(full))
    n_out = b.packer.n_outer
    cf.reset_launches()
    t = time.time()
    mv, mg, _ = make_val_grad(b)(z4[:n_out])
    c4["marginal"] = (mv, mg)
    c4["marginal_s"] = time.time() - t
    c4["launches_per_marginal_eval"] = {k: v for k, v in cf.LAUNCHES.items()
                                        if v}
    c4["graphs"] = {k: g.status for k, g in b.marginal.graphs.items()}
    c4["case_wall_s"] = time.time() - t_case
    out["config4_tracks"] = c4
    return out


def phase_multiprocess(torch, card, cases, c4, sharding):
    """Phase 3r: the ("dcn", axis) mesh, MP_RANKS processes spawned on the
    one card (torch.multiprocessing, gloo, a FileStore in a temporary
    directory), each with MP_SHARDS shards on cuda:0 (`mp_rank`). cases:
    {tag: (SDE keywords, kernel names, the unsharded f64 bundle, the
    unsharded f32 fit result, 3q's case, the one-process f32 device fit's
    nllk and its name)} for the time axis (5a CTCRW against 3m's device
    fit, 3b OU_SSM against its unsharded fit); config 4 by tracks at
    tests/golden/config4.npz's point.
    Gates: both processes exit 0 within MP_TIMEOUT_S (a failure or a
    hang in either fails the phase; a hung one is killed); both ranks'
    results equal bit for bit; time cases: f64 nllk and gradient at the
    start against the one-process unsharded kernels' (1e-10 relative,
    1e-8 of the largest component), f32 fits converge with the nllk
    within 1e-4 relative of the unsharded fits', each kernel of the path
    launched MP_SHARDS times a process per nllk+grad, the f32
    optimizer="device" fits converge with every step eager (the reason
    names the processes) and the nllk within 1e-4 relative of the
    one-process device fit's; config 4: the f64
    joint nllk and its twin against the one-process unsharded ones and
    the Laplace marginal against 3i's f64 marginal at the golden point
    (1e-10 / 1e-8), each CTCRW kernel launched by the marginal
    evaluation. Prints each multi-process nllk+grad wall beside 3q's
    one-process walls (unsharded and SHARDS chunks), and each device
    fit's steps, graph, flag reads per step and wall beside the scipy
    fit's."""
    import pickle
    import tempfile

    import torch.multiprocessing as tmp

    from smoothsde_tpu_torch import SDE

    t0 = time.time()
    kw4, _ = config4()
    fx = np.load(os.path.join(HERE, "tests", "golden", "config4.npz"))
    b4 = SDE(**kw4, device="cuda", dtype=torch.float64).setup()
    z4 = np.concatenate([fx["outer"], b4.packer.inner_init()])
    flat4 = {route: bundle_value_grad(
        torch, b4, z4, lambda full, route=route: getattr(b4, route)(full))
        for route in ("joint_nllk", "joint_nllk_ad")}
    del b4
    flat = {tag: bundle_value_grad(torch, c[2], c[2].packer.outer_init())
            for tag, c in cases.items()}
    with tempfile.TemporaryDirectory() as tmpdir:
        ctx = tmp.get_context("spawn")
        procs = [ctx.Process(target=mp_rank, args=(
            r, os.path.join(tmpdir, "store"), os.path.join(tmpdir, "res"),
            {tag: (c[0], c[1]) for tag, c in cases.items()}, kw4, z4))
            for r in range(MP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.time() + MP_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        check(not hung and codes == [0] * MP_RANKS,
              f"3r: processes {hung} still running after {MP_TIMEOUT_S} s "
              f"(killed); exit codes {codes}")
        ranks = []
        for r in range(MP_RANKS):
            with open(os.path.join(tmpdir, f"res.{r}"), "rb") as f:
                ranks.append(pickle.load(f))
    spawn_s = time.time() - t0

    def same(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a
                                                if not k.endswith("_s")
                                                and k != "nllk_grad_ms")
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(map(same, a, b))
        return np.array_equal(np.asarray(a), np.asarray(b))

    check(same(ranks[0], ranks[1]), "3r: the ranks' results differ")
    r0 = ranks[0]
    out = {"card": card, "processes": MP_RANKS, "shards_per_process":
           MP_SHARDS}
    vias = ("optimizer", "gtol", "slope_probe", "descent_probe")
    for tag, (kw, names, _, res_flat, sh, (dev_ref, dev_ref_name)) in \
            cases.items():
        m = r0[tag]
        fv, fg = flat[tag]
        acc = {"f64_nllk_rel": abs(m["v64_start"] - fv) / abs(fv),
               "f64_grad_over_max": float(np.max(np.abs(m["g64_start"] - fg))
                                          / np.max(np.abs(fg)))}
        ev = abs(m["nllk"] - res_flat.value) / abs(res_flat.value)
        check(acc["f64_nllk_rel"] <= 1e-10 and acc["f64_grad_over_max"]
              <= 1e-8, f"3r {tag}: f64 two processes vs one: {acc}")
        check(m["convergence"] == 0 and ev <= 1e-4,
              f"3r {tag}: f32 fit over two processes: convergence "
              f"{m['convergence']}, nllk {m['nllk']} vs {res_flat.value}")
        for nm in names:
            check(m["launches_per_nllk_grad"][nm] == MP_SHARDS,
                  f"3r {tag}: {nm} launched {m['launches_per_nllk_grad'][nm]}"
                  f" times a nllk+grad in a process, not {MP_SHARDS}")
        d = m["device_fit"]
        ed = abs(d["nllk"] - dev_ref) / abs(dev_ref)
        check(d["convergence"] == 0 and d["via"] in vias and ed <= 1e-4,
              f"3r {tag}: f32 device fit over two processes: convergence "
              f"{d['convergence']} via {d['via']}, nllk {d['nllk']} vs "
              f"{dev_ref_name} {dev_ref}")
        check(d["graph"] == f"eager (collectives across {MP_RANKS} "
              f"processes)", f"3r {tag}: device fit steps ran as "
              f"{d['graph']}")
        device_fit = {**{k: v for k, v in d.items() if k != "par"},
                      "par": d["par"].tolist(), "nllk_ref": dev_ref,
                      "nllk_ref_is": dev_ref_name, "nllk_rel": ed,
                      "flag_reads_per_step":
                          (d["steps"] + 1) / max(d["steps"], 1),
                      "flag_reads_per_iteration":
                          (d["steps"] + 1) / max(d["counts"]["iterations"],
                                                 1)}
        log(f"[3r] {tag}: device fit over two processes {d['fit_wall_s']:.2f}"
            f" s ({d['steps']} steps, {d['graph']}, "
            f"{device_fit['flag_reads_per_step']:.3f} flag reads a step, "
            f"{d['counts']['evals']} evals, via {d['via']}, nllk rel "
            f"{ed:.2e} vs {dev_ref_name}) vs scipy {m['fit_wall_s']:.2f} s "
            f"({m['evals']} evals), {card}")
        out[tag] = {**{k: v for k, v in m.items()
                       if k not in ("g64_start", "par", "device_fit")},
                    "par": m["par"].tolist(), "accuracy_start": acc,
                    "device_fit": device_fit,
                    "nllk_unsharded": res_flat.value, "nllk_rel": ev,
                    "fit_wall_s_unsharded": sh["fit_wall_s_unsharded"],
                    "fit_wall_s_one_process_sharded": sh["fit_wall_s"],
                    "nllk_grad_ms_one_process": sh["nllk_grad_ms"]}
        log(f"[3r] {tag}: nllk+grad wall median two processes "
            f"{m['nllk_grad_ms']['median']:.2f} ms, one process unsharded "
            f"{sh['nllk_grad_ms']['unsharded']['median']:.2f} ms, one "
            f"process {SHARDS} chunks "
            f"{sh['nllk_grad_ms']['sharded']['median']:.2f} ms; fit "
            f"{m['fit_wall_s']:.2f} s ({m['evals']} evals) vs "
            f"{sh['fit_wall_s_unsharded']:.2f} s unsharded")
    m4 = r0["config4_tracks"]
    e4 = {}
    for route in ("joint_nllk", "joint_nllk_ad"):
        (v, g), (fv, fg) = m4[route], flat4[route]
        e4[route] = {"nllk_rel": abs(v - fv) / abs(fv),
                     "grad_over_max": float(np.max(np.abs(g - fg))
                                            / np.max(np.abs(fg)))}
    gv, gg = m4["marginal"]
    want = c4["golden_f64"]
    e4["marginal"] = {"nllk_rel": abs(gv - want["marginal_nllk"])
                      / abs(want["marginal_nllk"]),
                      "grad_over_max": float(
                          np.max(np.abs(gg - np.asarray(want["grad"])))
                          / np.max(np.abs(want["grad"])))}
    for route, e in e4.items():
        check(e["nllk_rel"] <= 1e-10 and e["grad_over_max"] <= 1e-8,
              f"3r config 4: f64 {route} over two processes vs one: {e}")
    for name, _, _ in CTCRW_KERNELS:
        check(m4["launches_per_marginal_eval"].get(name, 0) > 0,
              f"3r config 4: {name} not launched by a marginal evaluation")
    out["config4_tracks"] = {
        "f64_vs_one_process": e4, "marginal_s": m4["marginal_s"],
        "launches_per_marginal_eval": m4["launches_per_marginal_eval"],
        "graphs": m4["graphs"], "case_wall_s": m4["case_wall_s"]}
    out["phase_wall_s"] = time.time() - t0
    out["spawn_to_results_s"] = spawn_s
    log(f"[3r] {json.dumps(out)}")
    return out


def config3(seed=2, n=1500):
    """BASELINE config 3 (the JAX package's tools/bench_configs.py
    config3): one 2-D CTCRW GPS track of n steps at irregular times
    (dt ~ U(0.2, 1.5)), tau 3, nu 1, sigma_obs 0.1, seed 2, simulated
    step by step as there. Returns (SDE keywords, truth)."""
    from smoothsde_tpu_torch.utils.misc import ctcrw_cov

    rng = np.random.default_rng(seed)
    times = np.cumsum(rng.uniform(0.2, 1.5, size=n))
    tau_t, nu_t, sobs = 3.0, 1.0, 0.1
    beta = 1 / tau_t
    sigma = 2 * nu_t / np.sqrt(np.pi * tau_t)
    v, z = np.zeros(2), np.zeros(2)
    obs = np.empty((n, 2))
    obs[0] = 0
    for i in range(1, n):
        dt = times[i] - times[i - 1]
        e = np.exp(-beta * dt)
        V = ctcrw_cov(beta, sigma, dt)
        for d in range(2):
            mv, mz = e * v[d], z[d] + v[d] / beta * (1 - e)
            v[d], z[d] = rng.multivariate_normal([mv, mz], V)
        obs[i] = z + rng.normal(size=2) * sobs
    data = {"ID": np.zeros(n, int), "time": times,
            "y1": obs[:, 0], "y2": obs[:, 1]}
    return (dict(data=data, type="CTCRW", response=["y1", "y2"],
                 par0=[0.0, 0.0, 2.0, 0.8]), {"tau": tau_t, "nu": nu_t})


def phase_config3(torch, card):
    """Phase 3s: BASELINE config 3 (`config3`), fitted in f32 and f64 on
    the card through K1a-K3b. Gates: convergence, tau and nu within 5% of
    the truth in both, the f32 nllk within 1e-4 relative of the f64
    fit's, every CTCRW kernel launched by the f32 fit."""
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf

    kw, truth = config3()
    cf.reset_launches()
    sde, res, wall = fit_on_card(torch, "3s", kw, torch.float32)
    launches = {name: cf.LAUNCHES[name] for name, _, _ in CTCRW_KERNELS}
    sde64, res64, wall64 = fit_on_card(torch, "3s", kw, torch.float64)
    est = {}
    for tag, s_, r_ in (("f32", sde, res), ("f64", sde64, res64)):
        tau, nu = (float(v) for v in s_.par(t=0)[0, 2:4])
        est[tag] = {"tau": tau, "nu": nu}
        check(r_.convergence == 0, f"3s: {tag} fit: {r_.message}")
        for nm, got in est[tag].items():
            check(abs(got - truth[nm]) / truth[nm] < 0.05,
                  f"3s: {tag} {nm} {got} not within 5% of {truth[nm]}")
    ev = abs(res.value - res64.value) / abs(res64.value)
    check(ev <= 1e-4, f"3s: f32 nllk {res.value} vs f64 {res64.value}")
    for name, n in launches.items():
        check(n > 0, f"3s: {name} never launched by the fit")
    out = {"card": card, "n": len(kw["data"]["ID"]), "fit_wall_s": wall,
           "evals": res.counts["evals"], "via": res.convergence_via,
           "f64_fit_wall_s": wall64, "f64_evals": res64.counts["evals"],
           "estimates": est, "truth": truth, "nllk": res.value,
           "nllk_f64": res64.value, "nllk_rel": ev,
           "launches_fit": launches, "timings": res.timings}
    log(f"[3s] {json.dumps(out)}")
    return out


# the CUDA kernel functions of the CTCRW path (csrc/ctcrw_filter.cu,
# block_prefix.cu, ctcrw_backward.cu), which 3t finds in the fit's trace
CTCRW_CUDA_FUNCTIONS = (
    "filter_totals_kernel", "filter_scan_kernel",
    "block_prefix_reduce_kernel", "block_prefix_carry_kernel",
    "block_prefix_rescan_kernel", "smooth_totals_kernel",
    "score_scan_kernel")


PROFILE_ITERS = 3  # the BFGS iterations of 3t's profiled fit (a short trace)


def phase_profile_fd(torch, card, data5a, b64, x5a, cfg2):
    """Phase 3t: `fit(profile_dir=..., maxiter=PROFILE_ITERS)` at config
    5a in f32 writes a torch.profiler trace (under build/) that names
    each CUDA kernel function of the path (CTCRW_CUDA_FUNCTIONS), and
    its `timings` hold, beside the port's own (`PORT_STAGES`), the JAX
    package's stage names; the FD outer Hessian of
    sdreport_mode="device" (`infer.fit.fd_hessian`: the points stacked on
    the card, one copy back) against "host" (one evaluation and read a
    point) in f64 at 5a's f32 optimum (b64: the f64 bundle) and at
    config 2's f64 optimum (cfg2: phase 3g's results): each entry within
    1e-6 of the matrix's largest."""
    import shutil

    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import (
        PORT_STAGES,
        _fd_device,
        _fd_host,
        make_val_grad,
    )
    from smoothsde_tpu_torch.utils.profiling import NO_TIMER

    t0 = time.time()
    log_dir = os.path.join(HERE, "build", "chip_smoke_trace")
    shutil.rmtree(log_dir, ignore_errors=True)
    _, res, wall = fit_on_card(
        torch, "3t", dict(data=data5a, type="CTCRW", response=["y1", "y2"],
                          par0=[0, 0, 2, 0.8]), torch.float32,
        profile_dir=log_dir, compute_sdreport=False, maxiter=PROFILE_ITERS)
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
    check(len(files) == 1 and os.path.getsize(files[0]) > 0,
          f"3t: the trace directory holds {files}")
    with open(files[0]) as f:
        text = f.read()
    # a kernel's name appears in the trace in its device events only
    found = {fn: text.count(fn) for fn in CTCRW_CUDA_FUNCTIONS}
    check(all(found.values()), f"3t: CUDA kernels missing from the trace: "
          f"{found}")
    check(set(res.timings) - set(PORT_STAGES) == {"marginal_nllk_grad"},
          f"3t: timings stages {sorted(res.timings)}")
    trace_mb = os.path.getsize(files[0]) / 2**20
    shutil.rmtree(log_dir, ignore_errors=True)

    fd = {}
    kw2, _ = config2()
    b2 = SDE(**kw2, device="cuda", dtype=torch.float64).setup()
    for tag, b, x, bh in (("config5a", b64, x5a, np.zeros(0)),
                          ("config2", b2, np.asarray(cfg2["par_f64"]),
                           np.asarray(cfg2["bhat_f64"]))):
        vg = make_val_grad(b)
        t = time.time()
        H_host = _fd_host(vg, x, bh, 1e-4)
        t_host = time.time() - t
        t = time.time()
        H_dev = _fd_device(b, x, bh, 1e-4, NO_TIMER)
        t_dev = time.time() - t
        err = float(np.max(np.abs(H_dev - H_host)) / np.max(np.abs(H_host)))
        fd[tag] = {"err_over_max": err, "host_s": t_host, "device_s": t_dev,
                   "n_outer": len(x)}
        check(np.all(np.isfinite(H_dev)) and err <= 1e-6,
              f"3t: {tag} FD Hessian, device vs host: {err:.3e}")
    out = {"card": card, "fit_wall_s": wall, "evals": res.counts["evals"],
           "trace_mb": trace_mb, "kernels_in_trace": found,
           "timings": res.timings, "fd_hessian_f64": fd,
           "phase_wall_s": time.time() - t0}
    log(f"[3t] {json.dumps(out)}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: no GPU")
    if not os.path.isdir(os.path.join(HERE, "smoothsde_tpu_torch")):
        raise SmokeFailure("smoothsde_tpu_torch/ is not beside this script")
    sys.path.insert(0, HERE)
    import smoothsde_tpu_torch

    pkg_dir = os.path.dirname(os.path.abspath(smoothsde_tpu_torch.__file__))
    check(pkg_dir == os.path.join(HERE, "smoothsde_tpu_torch"),
          f"imported the port from {pkg_dir}, not from this checkout")
    from smoothsde_tpu_torch import SDE
    from smoothsde_tpu_torch.infer.fit import make_val_grad
    from smoothsde_tpu_torch.ops import _kernels
    from smoothsde_tpu_torch.ops import ctcrw_fused as cf
    from smoothsde_tpu_torch.ops import diag_fused as df
    from smoothsde_tpu_torch.ops.diag_fused import (
        DiagFusedCore,
        DiagPlainCore,
        prepare_diag_data,
    )
    from smoothsde_tpu_torch.ops.kalman_soa import (
        CtcrwFusedCore,
        CtcrwPlainCore,
        prepare_ctcrw_data,
    )

    # the reference comparisons are in full f32 / f64, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_main = time.time()
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.time()
    so = _kernels.build()
    _kernels.load()
    log(f"[1] kernels built in {time.time() - t:.1f} s: {so.name}")

    f32, f64 = torch.float32, torch.float64
    log("[2] kernels vs plain versions through the autograd.Function: "
        "par-space (k), element-space fused and pallas (llk2_analytic)")
    variants = {
        "ref": (f64, partial(loglik_value_grad, CtcrwPlainCore)),
        "k64": (f64, partial(loglik_value_grad, CtcrwFusedCore)),
        "k32": (f32, partial(loglik_value_grad, CtcrwFusedCore)),
    }
    for scan in ("fused", "pallas"):
        variants[f"{scan}64"] = (f64, partial(elem_value_grad, scan))
        variants[f"{scan}32"] = (f32, partial(elem_value_grad, scan))
    worst = phase_kernels_vs_plain(torch, variants, prepare_ctcrw_data)
    log(f"[2] worst: {json.dumps(worst)}")
    worst_diag = {}
    for typ, n_extra in (("BM_SSM", 1), ("OU_SSM", 2)):
        log(f"[2] {typ} kernels vs plain versions through DiagFusedCore")
        worst_diag[typ] = phase_kernels_vs_plain(torch, {
            "ref": (f64, partial(diag_value_grad, typ, DiagPlainCore)),
            "k64": (f64, partial(diag_value_grad, typ, DiagFusedCore)),
            "k32": (f32, partial(diag_value_grad, typ, DiagFusedCore)),
        }, partial(prepare_diag_data, typ), n_extra)
        log(f"[2] {typ} worst: {json.dumps(worst_diag[typ])}")
    log("[2b] the cross-block prefix K2 alone vs its plain version, around "
        "its tile")
    k2 = phase_k2(torch)
    log("[2c] the backward kernels K3a and K3b alone vs their plain "
        "versions, around their tile and chunk")
    k3 = phase_alone(torch, "2c", backward_inputs, K3_ALONE, cf.OPS)
    log("[2d] the forward kernels K1a and K1b alone vs their plain "
        "versions, around their CUDA block")
    k1 = phase_alone(torch, "2d", forward_inputs, K1_ALONE, cf.OPS)
    log("[2e] the scalar-state kernels D1a, D1b, D3a and D3b alone vs their "
        "plain versions, around their CUDA blocks and D1a's segments")
    kd = phase_alone(torch, "2e", diag_inputs, D_ALONE, df.OPS, cuts=D_CUTS)
    log("[2f] the phase-1 scan K8 alone vs its plain version for the "
        "scalar-state and square-root elements, around its CUDA block")
    k8, k8_launches = phase_k8(torch)

    log("[3] config 5a: 1M-step 2-D CTCRW fit on the card, f32")
    t = time.time()
    data = config5a()
    log(f"[3] simulated in {time.time() - t:.1f} s")
    cf.reset_launches()
    t = time.time()
    sde = SDE(data=data, type="CTCRW", response=["y1", "y2"],
              par0=[0, 0, 2, 0.8], device="cuda")
    res = sde.fit()
    torch.cuda.synchronize()
    fit_s = time.time() - t
    launches = dict(cf.LAUNCHES)
    tau_hat, nu_hat = (float(v) for v in sde.par(t=0)[0, 2:4])
    log(f"[3] fit {fit_s:.2f} s, {res.counts['evals']} nllk+grad evals "
        f"(BFGS {res.counts}), convergence via {res.convergence_via}, "
        f"tau {tau_hat:.4f}, nu {nu_hat:.4f}, nllk {res.value:.3f}")
    log(f"[3] launches during the fit: {launches}")
    check(res.convergence == 0, f"fit did not converge: {res.message}")
    check(abs(tau_hat - 3.0) / 3.0 < 0.05, f"tau {tau_hat} not within 5%")
    check(abs(nu_hat - 1.0) < 0.05, f"nu {nu_hat} not within 5%")
    for name, _, _ in CTCRW_KERNELS:
        check(launches[name] > 0, f"kernel {name} never launched by the fit")
    check(res.cov_fixed is not None and np.all(np.isfinite(res.cov_fixed)),
          "cov_fixed not finite")

    b32 = sde.bundle()
    sde64 = SDE(data=data, type="CTCRW", response=["y1", "y2"],
                par0=[0, 0, 2, 0.8], device="cuda", dtype=torch.float64)
    b64 = sde64.bundle()
    d32 = prepare_ctcrw_data(sde.obs(), data["time"], data["ID"],
                             dtype=torch.float32, device=dev)
    d64 = prepare_ctcrw_data(sde.obs(), data["time"], data["ID"],
                             dtype=torch.float64, device=dev)
    accuracy = {}
    x_points = {"optimum": res.par, "start": b32.packer.outer_init()}
    plain64 = {}
    for label, x in x_points.items():
        v32, g32, _ = make_val_grad(b32)(x)  # the fit's own evaluation
        v64, g64 = outer_value_grad(b64, CtcrwPlainCore, d64, x, torch)
        plain64[label] = (v64, g64)
        ev = abs(v32 - v64) / abs(v64)
        eg_scale = float(np.max(np.abs(g32 - g64)) / abs(v64))
        eg_comp = float(np.max(np.abs(g32 - g64) / np.maximum(
            np.abs(g64), 1e-300)))
        accuracy[label] = {"nllk_rel": ev, "grad_err_over_nllk": eg_scale,
                           "grad_rel_per_component": eg_comp}
        log(f"[3] f32 kernels vs f64 plain at the {label}: nllk {v32:.6f} "
            f"vs {v64:.6f} (rel {ev:.2e}); grad {g32} vs {g64}")
        check(ev <= 1e-4, f"f32 nllk at the {label}: rel {ev:.3e}")
        check(eg_scale <= 1e-4, f"f32 gradient at the {label}: {eg_scale:.3e}")
    log(f"[3] accuracy: {json.dumps(accuracy)}")

    log("[3b] 1M-step 2-D OU_SSM fit on the card, f32")
    ou = diag_fit(torch, "3b", "OU_SSM", ou_ssm_1m(), ["y1", "y2"],
                  [0.0, 0.0, 1.0, 1.0],
                  {"mu1": 1.0, "mu2": -0.5, "tau": 2.0, "kappa": 1.0})
    log("[3c] 1M-step 1-D BM_SSM fit on the card, f32")
    bm = diag_fit(torch, "3c", "BM_SSM", bm_ssm_1m(), ["y"], [0.0, 1.0],
                  {"mu": 0.05, "sigma": 0.3})

    log("[3d] element-space path at config 5a's full width (1M steps, "
        "d = 2, f32)")
    elem = elem_full_width(torch, sde, data, x_points, b32, b64, d32, d64,
                           plain64)
    log("[3e] f32 accuracy at the JAX package's audit point (1M steps)")
    audit = phase_audit(torch)

    log("[3f] config 1: BM fit on the card (n = 1,000), f32 and f64")
    closed = {"config1_bm": phase_config1(torch)}
    log("[3g] config 2: OU with smooths, the Laplace approximation on the "
        "card (n = 3,000), f32 and f64")
    closed["config2_ou_smooth"] = phase_config2(torch)
    log("[3h] config 5b: 1M-step CIR fit on the card, f32")
    closed["config5b_cir"] = phase_config5b(torch, card)
    log("[3i] config 4: 8 x 250-step CTCRW with tau ~ s(ID, bs='re'), the "
        "state-space Laplace layer on the card, f32 and f64")
    c4, sde4 = phase_config4(torch, card)
    log("[3j] the forward-mode twin at 1M steps (CTCRW 5a, OU_SSM 3b) "
        "against the kernel route, f32")
    twin = phase_twin_1m(torch, card, [
        ("CTCRW_5a", b32, b64, res.par),
        ("OU_SSM_3b", ou["b32"], ou["b64"], ou["res"].par)])
    log("[3k] the colored inner Hessian: the wide-random-effect BM fit")
    colored = phase_colored(torch, card)
    log("[3l] the API tail at config 4 from 3i's f32 fit: intervals, model "
        "selection, simulation, checkpoints")
    api_tail = phase_api_tail(torch, card, sde4)
    log("[3m] fit(optimizer='device') at config 5a and 'auto' at config 2")
    device_opt = phase_device_optimizer(torch, card, data, res, fit_s,
                                        closed["config2_ou_smooth"])
    log("[3n] the square-root filter at config 5a: the fit, the audit "
        "point, and scan='pallas' (K8 / K2) against 'blocked'")
    sqrt_out, slice_launches = phase_sqrt(torch, card, data, res, d32, d64,
                                          b32, b64, ou)
    log("[3o] user H at config 5a's width: the parallel full-state filter's "
        "fit, filtered states and residuals")
    user_h = phase_user_H(torch, card, sde, dict(
        data=data, type="CTCRW", response=["y1", "y2"], par0=[0, 0, 2, 0.8]))
    log("[3p] ESEAL_SSM: 16 tracks x 1,000 dives, with and without priors")
    eseal = phase_eseal(torch, card)
    log(f"[3q] sharding, {SHARDS} shards on cuda:0: the time-sharded 5a "
        "CTCRW and 3b OU_SSM, config 4 and 3k's BM by tracks, the "
        "time-sharded ESEAL route")
    ctcrw_names = [name for name, _, _ in CTCRW_KERNELS]
    diag_names = [name for name, _, _ in DIAG_KERNELS]
    sharding = phase_sharding(torch, card, {
        "ctcrw_5a_time": (
            "3q-a", dict(data=data, type="CTCRW", response=["y1", "y2"],
                         par0=[0, 0, 2, 0.8]), {"tau": 3.0, "nu": 1.0},
            {"b32": b32, "b64": b64, "res": res, "wall_s": fit_s,
             "plain_start": plain64["start"]},
            ctcrw_names, ("filter", "smooth")),
        "ou_ssm_3b_time": (
            "3q-b", dict(data=ou_ssm_1m(), type="OU_SSM",
                         response=["y1", "y2"], par0=[0.0, 0.0, 1.0, 1.0]),
            {"mu1": 1.0, "mu2": -0.5, "tau": 2.0, "kappa": 1.0},
            {"b32": ou["b32"], "b64": ou["b64"], "res": ou["res"],
             "wall_s": ou["summary"]["wall_s"],
             "plain_start": diag_outer_value_grad(
                 "OU_SSM", ou["b64"], DiagPlainCore, ou["d64"],
                 ou["b32"].packer.outer_init(), torch)},
            diag_names, ("diag_filter", "diag_smooth")),
    }, c4, colored)
    log(f"[3r] the multi-process mesh: {MP_RANKS} processes on cuda:0, "
        f"{MP_SHARDS} shards each: the time-sharded 5a CTCRW and 3b OU_SSM, "
        "config 4 by tracks")
    multiprocess = phase_multiprocess(torch, card, {
        "ctcrw_5a_time": (dict(data=data, type="CTCRW",
                               response=["y1", "y2"], par0=[0, 0, 2, 0.8]),
                          ctcrw_names, b64, res, sharding["ctcrw_5a_time"],
                          (device_opt["config5a"]["nllk"], "3m device fit")),
        "ou_ssm_3b_time": (dict(data=ou_ssm_1m(), type="OU_SSM",
                                response=["y1", "y2"],
                                par0=[0.0, 0.0, 1.0, 1.0]),
                           diag_names, ou["b64"], ou["res"],
                           sharding["ou_ssm_3b_time"],
                           (ou["res"].value, "unsharded fit")),
    }, c4, sharding)
    log("[3s] config 3: the 1,500-step irregular 2-D CTCRW track, f32 and "
        "f64")
    c3 = phase_config3(torch, card)
    log("[3t] fit(profile_dir=...) at config 5a, and sdreport_mode "
        "'device' against 'host' at 5a and config 2")
    prof_fd = phase_profile_fd(torch, card, data, b64, res.par,
                               closed["config2_ou_smooth"])

    log("[4] kernels vs plain at the fit's shapes, and times")
    ops_k, ops_p = cf.OPS["kernels"], cf.OPS["plain"]
    x_hat = res.par
    entries = {}
    for dtype, dat, bun in ((torch.float64, d64, b64),
                            (torch.float32, d32, b32)):
        with torch.no_grad():
            p, calls = ctcrw_kernel_calls(torch, bun, dat, x_hat)
            for name, source, replaces in CTCRW_KERNELS:
                fn = calls[name]
                got, ref = flat(fn(ops_k), torch), flat(fn(ops_p), torch)
                err = float((got - ref).abs().max())
                scale = max(1.0, float(ref.abs().max()))
                e = entries.setdefault(name, {
                    "name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                })
                check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                if dtype == torch.float64:
                    e["max_abs_err"] = err
                    e["max_rel_err"] = err / scale
                    check(err <= 1e-8 * scale,
                          f"{name}: f64 kernel vs plain max abs err {err:.3e}")
                    e["ms_f64"] = cuda_ms(lambda: fn(ops_k), 50, 3, torch)
                else:
                    e["max_abs_err_f32"] = err
                    e["ms"] = cuda_ms(lambda: fn(ops_k), 50, 3, torch)
                    e["plain_ms"] = cuda_ms(lambda: fn(ops_p), 3, 1, torch)
                    e["shape"] = f"n=1000000 d=2 lanes={p.lanes} L={p.L} f32"
                    e.update(bound(name, p, 4))
    kernels = [entries[name] for name, _, _ in CTCRW_KERNELS]
    for e in kernels:
        e["launches_config4_per_marginal_eval"] = \
            c4["launches_per_marginal_eval"].get(e["name"], 0)
        e["launches_per_device_lbfgs_iteration_5a"] = \
            device_opt["config5a"]["kernel_launches_per_iteration"][e["name"]]
        e.update(c4["kernel_checks"][e["name"]])
    for e in kernels:
        log(f"  {e['name']}: {e['ms']:.4f} ms (plain {e['plain_ms']:.2f} ms),"
            f" f64 max abs err {e['max_abs_err']:.2e}")

    dev_ms, busy_ms, prof_wall_ms = profile_device_ms(
        lambda: outer_value_grad(b32, CtcrwFusedCore, d32, x_hat, torch), 10,
        torch)
    dev64_ms, busy64_ms, _ = profile_device_ms(
        lambda: outer_value_grad(b64, CtcrwFusedCore, d64, x_hat, torch), 10,
        torch)
    for e in kernels:
        e["device_ms"] = dev_ms[e["name"]]
        e["device_ms_f64"] = dev64_ms[e["name"]]
    log(f"[4] profiler, per nllk+grad: device busy {busy_ms:.3f} ms of "
        f"{prof_wall_ms:.3f} ms wall; per kernel {json.dumps(dev_ms)}; f64: "
        f"busy {busy64_ms:.3f} ms, per kernel {json.dumps(dev64_ms)}")
    vg_k = wall_ms(
        lambda: outer_value_grad(b32, CtcrwFusedCore, d32, x_hat, torch),
        110, 5)
    vg_p = wall_ms(
        lambda: outer_value_grad(b32, CtcrwPlainCore, d32, x_hat, torch), 5, 1)
    fit_line = {
        "card": card,
        "nllk_grad_1M_ms": {"kernels": vg_k, "plain": vg_p},
        "profile_per_nllk_grad_ms": {"device_busy": busy_ms,
                                     "wall": prof_wall_ms,
                                     "device_busy_f64": busy64_ms},
        "fit": {"wall_s": fit_s, "evals": res.counts["evals"],
                "bfgs": res.counts, "via": res.convergence_via,
                "tau": tau_hat, "nu": nu_hat, "nllk": res.value},
        "accuracy_f32_vs_f64": accuracy,
        "kernel_checks": worst,
    }
    log(f"[4] nllk+grad at 1M steps, f32, wall ms: kernels {vg_k}, "
        f"plain {vg_p}")
    log("[4] element-space kernels and K8 vs plain at config 5a's shapes, "
        "and times")
    elem_checks, elem_times = elem_kernel_checks(torch, b32, b64, d32, d64,
                                                 x_hat)
    fit_line["elem_path"] = {**elem["summary"], **elem_times}

    log("[4] diag kernels vs plain at the OU_SSM and BM_SSM fits' shapes, "
        "and times")
    ou_checks = diag_kernel_checks(torch, ou)
    bm_checks = diag_kernel_checks(torch, bm)
    ou_dev_ms, ou_times = diag_times(torch, ou)
    bm_dev_ms, bm_times = diag_times(torch, bm)
    for name, source, replaces in DIAG_KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": ou["launches"][name],
            **ou_checks[name], "device_ms": ou_dev_ms[name],
            "launches_bm_ssm_fit": bm["launches"][name],
            **{f"{k}_bm": v for k, v in bm_checks[name].items()},
            "device_ms_bm": bm_dev_ms[name],
        })
    for name, source, replaces in ELEM_KERNELS:
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": elem["launches"][name],
            **elem_checks[name],
        })
    log("[4] the scalar-state and square-root K8 / K2 instantiations vs "
        "plain at full width, and times")
    slice_checks = slice_kernel_checks(torch, b32, b64, d32, d64, x_hat, ou)
    for name, source, replaces in SLICE_KERNELS:
        # the scalar smoothing kind's path is phase 2f (no fit scans it)
        path = k8_launches if name == "phase1_scan_diag_smooth" \
            else slice_launches
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path[name],
            **slice_checks[name],
        })
    for e in kernels:
        e.update(k2.get(e["name"], {}))
        for case in ("ctcrw_5a_time", "ou_ssm_3b_time"):
            if e["name"] in sharding[case]["launches_per_nllk_grad"]:
                e["launches_time_sharded_fit"] = \
                    sharding[case]["launches_fit"][e["name"]]
                e["launches_time_sharded_per_nllk_grad"] = \
                    sharding[case]["launches_per_nllk_grad"][e["name"]]
                mp = multiprocess[case]
                e["launches_multiprocess_fit_rank0"] = \
                    mp["launches_fit"][e["name"]]
                e["launches_multiprocess_per_nllk_grad_rank0"] = \
                    mp["launches_per_nllk_grad"][e["name"]]
        if e["name"] in c3["launches_fit"]:
            e["launches_config3_fit"] = c3["launches_fit"][e["name"]]
        if e.get("device_ms"):  # the bound's share of the device time
            e["share"] = e["bound_ms"] / e["device_ms"]
    fit_line["kernel_checks_diag"] = worst_diag
    fit_line["kernel_checks_k3"] = k3
    fit_line["kernel_checks_k1"] = k1
    fit_line["kernel_checks_diag_alone"] = kd
    fit_line["accuracy_audit_point"] = audit
    fit_line["closed_form"] = closed
    fit_line["config4_ssm_laplace"] = c4
    fit_line["twin_1m"] = twin
    fit_line["colored_hessian_fit"] = colored
    fit_line["api_tail_config4"] = api_tail
    fit_line["device_optimizer"] = device_opt
    fit_line["kernel_checks_k8_alone"] = k8
    fit_line["sqrt_3n"] = sqrt_out
    fit_line["user_H_3o"] = user_h
    fit_line["eseal_3p"] = eseal
    fit_line["sharding_3q"] = sharding
    fit_line["multiprocess_3r"] = multiprocess
    fit_line["config3_3s"] = c3
    fit_line["profile_fd_3t"] = prof_fd
    for fit, times in ((ou, ou_times), (bm, bm_times)):
        fit_line[fit["typ"]] = {"fit": fit["summary"], **times}
    fit_line["chip_smoke_s"] = time.time() - t_main
    log("SUMMARY " + json.dumps(fit_line))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        sys.exit(1)
