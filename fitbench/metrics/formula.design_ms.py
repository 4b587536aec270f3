"""formula.design_ms: SDE(...)'s design matrices (build_design) and
par0, the program's "build.design" stage (FitResult.timings total),
mean per fit of the window; nothing where no fit recorded it."""


def read(run):
    vals = [f["timings"]["build.design"]["total_s"] for f in run.fits
            if "build.design" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
