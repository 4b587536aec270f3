"""Run one cell of the benchmark of smoothsde_tpu_torch on one card:

    python fitbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device, with
--trace 1 the breakdown, and last the checks (each number compared with
its limit), which also end standard error. Exits non-zero, printing no
result, without a CUDA card, with too few cards for the cell, or when
jax, jaxlib, flax or smoothsde_tpu was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def steady_host():
    """One thread for the host's math libraries and two fixed cores for
    the process, set before numpy or torch is loaded, so that every run
    has the same host layout: a fit's host path is one Python thread."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-2:])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    steady_host()
    # every cache at a fixed path inside the checkout
    cache = ROOT / "build" / "fitbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path.insert(0, str(ROOT))
    import torch

    from fitbench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} seen", file=sys.stderr)
        return 2
    result, lines = harness.run(cell, args.seed, args.seconds,
                                bool(args.trace), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
