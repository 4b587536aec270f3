"""kernels.csrc_us_per_eval: device time of the hand-written kernels
(the __global__ functions of smoothsde_tpu_torch/csrc/) over the traced
fits, per nllk+grad evaluation of those fits; nothing unless the
profiler saw, kernel by kernel, exactly those that the program's counted
launches run (launches/*.json): fewer means dropped events, more means
launches that went uncounted, as in a CUDA graph's replay."""


def read(run):
    tr = run.traced
    if tr is None or not tr["csrc_kernels"] or not tr["evals"]:
        return None
    if not tr["kernels_match"]:
        return None
    return 1e6 * tr["csrc_s"] / tr["evals"]
