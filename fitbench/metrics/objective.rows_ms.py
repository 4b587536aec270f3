"""objective.rows_ms: build_objective's likelihood of the rows (the
per-step device data, the filters' tensors, the track plan), the
program's "build.rows" stage (FitResult.timings total), mean per fit of
the window; nothing where no fit recorded it."""


def read(run):
    vals = [f["timings"]["build.rows"]["total_s"] for f in run.fits
            if "build.rows" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
