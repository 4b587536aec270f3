"""graph.capture_ms: the fit's CUDA graph captures (the program's
"graph.capture" stage total: the warm-up run, the capture and the replay
check of the device optimizer's step, or of the Laplace layer's graphs),
mean per fit of the window; nothing where no fit captured one. Kept out
of BENCHMARK.json with the held-back device cell, which captures once a
fit."""


def read(run):
    vals = [f["timings"]["graph.capture"]["total_s"] for f in run.fits
            if "graph.capture" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
