"""The traced run's reduction of a torch.profiler window to device busy
time, idle gaps, device operations and the hand-written kernels' time.

Host spans are `torch.profiler.record_function` ranges: the harness's
own ("fitbench.build", "fitbench.fit", "fitbench.read") and, while
`stage_spans` is active, one around each of the program's StageTimer
stages ("stage.<name>"), so that an idle gap can be named by what the
host was doing.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import re
from pathlib import Path

import torch

SPAN_PREFIXES = ("fitbench.", "stage.")
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def csrc_kernel_names(root: Path) -> set:
    """The __global__ function names of the program's hand-written
    kernels (smoothsde_tpu_torch/csrc/*.cu)."""
    names = set()
    for f in sorted((root / "smoothsde_tpu_torch" / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(f.read_text()))
    return names


def launch_map(bench_dir: Path) -> dict:
    """Launch name (the program's `LAUNCHES` key) -> the csrc __global__
    functions one launch runs, merged from `launches/*.json`."""
    out = {}
    for f in sorted((bench_dir / "launches").glob("*.json")):
        out.update(json.loads(f.read_text()))
    return out


def expected_kernels(launches: dict, mapping: dict):
    """The csrc kernels, by name, that `launches` (name -> count) run;
    None where a launch name is not in `mapping`."""
    if not set(launches) <= set(mapping):
        return None
    out = collections.Counter()
    for name, n in launches.items():
        for kernel in mapping[name]:
            out[kernel] += n
    return dict(out)


def kernel_base(name: str) -> str:
    """`void ns::foo_kernel<float, Elem14>(float const*, ...)` -> foo_kernel."""
    name = re.sub(r"^void\s+", "", name)
    name = re.split(r"[<(]", name, maxsplit=1)[0]
    return name.rsplit("::", 1)[-1].strip()


@contextlib.contextmanager
def stage_spans():
    """A record_function range around every StageTimer stage of the
    program while the block runs."""
    from smoothsde_tpu_torch.utils import profiling

    orig = profiling.StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name):
        with torch.profiler.record_function("stage." + name), \
                orig(self, name):
            yield

    profiling.StageTimer.stage = stage
    try:
        yield
    finally:
        profiling.StageTimer.stage = orig


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(events, csrc_names: set) -> dict:
    """Device busy seconds, device operations by name, idle gaps by the
    innermost host span around their midpoint, and the csrc kernels'
    seconds and count (in all and by kernel name), from a profiler's
    `events()` (times in us)."""
    dev, spans = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIXES):
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append((start, end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((start, end, e.name))
    busy = _merge((s, e) for s, e, _ in dev)
    ops, csrc_us, csrc_by_name = {}, 0.0, collections.Counter()
    for s, e, name in dev:
        ops[name] = ops.get(name, 0.0) + (e - s)
        if kernel_base(name) in csrc_names:
            csrc_us += e - s
            csrc_by_name[kernel_base(name)] += 1
    # the innermost host span of each stretch between span boundaries
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    names = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
        names.append(max(inner, key=lambda sp: sp[0])[2] if inner
                     else "outside the harness spans")
    # the idle gaps inside the outermost harness spans
    outer = _merge((s, e) for s, e, n in spans if n.startswith("fitbench."))
    gaps = {}
    for lo, hi in outer:
        cursor = lo
        for s, e in busy + [[hi, hi]]:
            s, e = min(max(s, lo), hi), min(max(e, lo), hi)
            if s > cursor:
                i = bisect.bisect_right(cuts, 0.5 * (cursor + s)) - 1
                name = names[min(max(i, 0), len(names) - 1)]
                gaps[name] = gaps.get(name, 0.0) + (s - cursor)
            cursor = max(cursor, e)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_ops": [[name[:160], us * 1e-6] for name, us in top],
        "idle_gaps": [[name, us * 1e-6] for name, us in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        "csrc_s": csrc_us * 1e-6,
        "csrc_kernels": sum(csrc_by_name.values()),
        "csrc_by_name": dict(csrc_by_name),
        "device_events": len(dev),
    }
