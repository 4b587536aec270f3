"""Profiling and timing hooks.

Port of smoothsde_tpu/utils/profiling.py. `StageTimer` is the JAX
package's: per-stage wall-clock, the first call of each stage apart (it
pays the first use of a kernel library or a CUDA graph's capture).
`trace` takes the place of its `xla_trace`: a torch.profiler trace of
the enclosed work, with the CUDA activities on a card, written to a
directory as a Chrome trace (viewable in Perfetto or chrome://tracing).
On a card a stage's time covers the device's work when the stage ends
at a host read (every stage of infer/fit.py does).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class StageTimer:
    """Accumulates named wall-clock stages; first call per stage is
    recorded separately (it includes the first use of what it runs)."""

    def __init__(self):
        self.first: Dict[str, float] = {}
        self.total: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        if name not in self.first:
            self.first[name] = dt
        self.total[name] = self.total.get(name, 0.0) + dt
        self.count[name] = self.count.get(name, 0) + 1

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name in self.total:
            n = self.count[name]
            steady = (
                (self.total[name] - self.first[name]) / (n - 1)
                if n > 1
                else self.first[name]
            )
            out[name] = {
                "calls": n,
                "first_s": self.first[name],  # includes first use
                "steady_s": steady,
                "total_s": self.total[name],
            }
        return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Capture a torch.profiler trace of the enclosed work into log_dir
    (None = no-op): the CPU activities, and the CUDA ones when a card is
    visible. The trace is written when the block ends, as
    <log_dir>/trace_<pid>_<ns>.json."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
