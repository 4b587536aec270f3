"""objective.params_ms: build_objective's parameter blocks, the design's
uploads, the log_sigma_obs default, the penalty and the packer's device
constants, the program's "build.params" stage (FitResult.timings
total), mean per fit of the window; nothing where no fit recorded it."""


def read(run):
    vals = [f["timings"]["build.params"]["total_s"] for f in run.fits
            if "build.params" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
