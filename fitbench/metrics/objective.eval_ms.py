"""objective.eval_ms: one nllk+grad on the host loop, the program's
steady time of its "marginal_nllk_grad" stage, mean per fit of the
window; nothing where no fit ran the host loop."""


def read(run):
    vals = [f["timings"]["marginal_nllk_grad"]["steady_s"] for f in run.fits
            if "marginal_nllk_grad" in f["timings"]]
    return 1e3 * sum(vals) / len(vals) if vals else None
