"""fit.evals: the program's count of nllk+grad evaluations of a fit
(FitResult.counts["evals"]), mean per fit of the window."""


def read(run):
    if not run.fits:
        return None
    return sum(f["evals"] for f in run.fits) / len(run.fits)
