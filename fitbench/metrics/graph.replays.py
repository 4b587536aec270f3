"""graph.replays: the fit's replays of CUDA graphs (the program's
"graph.replay" stage calls: an evaluation or FD gradient of the bundle's
graphed value and gradient, a device optimizer's step, a Laplace-layer
quantity), mean per fit of the window; nothing where no fit replayed
one."""


def read(run):
    vals = [f["timings"]["graph.replay"]["calls"] for f in run.fits
            if "graph.replay" in f["timings"]]
    return sum(vals) / len(vals) if vals else None
