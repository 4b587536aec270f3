"""objective.enqueue_ms: the host's part of one nllk+grad, from the
upload of x through the forward and the gradient to the first read of
the device, the program's steady time of its "eval.enqueue" stage, mean
per fit of the window; nothing where no fit recorded it."""


def read(run):
    vals = [f["timings"]["eval.enqueue"]["steady_s"] for f in run.fits
            if "eval.enqueue" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
