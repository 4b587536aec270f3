"""lbfgs.loop_ms: the device optimizer (FitResult.timings "device_lbfgs"
and "device_polish" totals: the L-BFGS steps, the probes and the FD
Hessian on the card, then any host polish), mean per fit of the window;
nothing where no fit ran it."""

STAGES = ("device_lbfgs", "device_polish")


def read(run):
    vals = [sum(f["timings"][s]["total_s"] for s in STAGES
                if s in f["timings"])
            for f in run.fits if "device_lbfgs" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
