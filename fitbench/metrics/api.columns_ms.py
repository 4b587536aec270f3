"""api.columns_ms: SDE(...)'s data columns, ID levels and index, times
and observations, the program's "build.columns" stage
(FitResult.timings total), mean per fit of the window; nothing where no
fit recorded it."""


def read(run):
    vals = [f["timings"]["build.columns"]["total_s"] for f in run.fits
            if "build.columns" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
