"""api.build_ms: SDE(...) and .setup() (build_objective on the job's
rows), ending in a device synchronize; mean per fit of the window."""


def read(run):
    if not run.fits:
        return None
    return 1e3 * sum(f["build_s"] for f in run.fits) / len(run.fits)
