"""fit.sdreport_ms: the program's sdreport stages (FitResult.timings
"outer_hessian_fd" and "joint_precision" totals), mean per fit of the
window; nothing where no fit ran them (the device optimizer folds its
FD Hessian into "device_lbfgs")."""

STAGES = ("outer_hessian_fd", "joint_precision")


def read(run):
    per_fit = [sum(f["timings"][s]["total_s"] for s in STAGES
                   if s in f["timings"]) for f in run.fits]
    if not any(per_fit):
        return None
    return 1e3 * sum(per_fit) / len(per_fit)
