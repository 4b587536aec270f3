"""fit.host_read_ms: the host's time in the fit's reads of the device
(its wait on the card, and the copies), the program's "host_read"
stage total, mean per fit of the window; nothing where no fit recorded
it."""


def read(run):
    vals = [f["timings"]["host_read"]["total_s"] for f in run.fits
            if "host_read" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
