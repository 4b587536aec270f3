"""fit_s: the window's seconds over the fits it ran (all the work over
all the time, from SDE(...) to estimates and standard errors on the
host)."""


def read(run):
    return run.window_s / run.attempted if run.attempted else None
