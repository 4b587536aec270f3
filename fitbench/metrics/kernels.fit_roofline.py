"""kernels.fit_roofline: the least time the traced fits' evaluations
could take on the card, evaluations x the problem's bytes (work/<TYPE>.py)
over the peak HBM bandwidth (peaks.json), as a share of the device's busy
time over those fits (every kernel and copy, hand-written or PyTorch's)."""


def read(run):
    tr = run.traced
    if tr is None or run.peak is None or tr["busy_s"] <= 0:
        return None
    least_s = tr["evals"] * run.eval_bytes / run.peak["hbm_bytes_per_s"]
    return 100.0 * least_s / tr["busy_s"]
