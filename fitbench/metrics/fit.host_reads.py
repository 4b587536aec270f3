"""fit.host_reads: the fit's reads of the device (each a stop of the
host until the card has done the work queued before it), the calls of
the program's "host_read" stage, mean per fit of the window; nothing
where no fit recorded it."""


def read(run):
    vals = [f["timings"]["host_read"]["calls"] for f in run.fits
            if "host_read" in f["timings"]]
    return sum(vals) / len(vals) if vals else None
