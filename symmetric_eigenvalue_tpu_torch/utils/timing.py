"""Phase timing instrumentation.

Port of the JAX package's ``utils/timing.py``.  The reference brackets
phases with ``omp_get_wtime`` and prints seconds (main.c:672-678,
filehandling.c:564-569).  Each timed block synchronizes its device before
the clock stops, so phase times are honest under CUDA's asynchronous
launches; :func:`maybe_profile` gives the deep view (a ``torch.profiler``
Chrome trace) the reference never had.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def sync(x=None, device=None):
    """Wait for the device that holds ``x`` (or ``device``) to finish queued
    work: ``torch.cuda.synchronize`` on CUDA, nothing on the CPU.  Returns
    ``x`` unchanged."""
    dev = x.device if isinstance(x, torch.Tensor) else device
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)
    return x


class PhaseTimer:
    """Wall time per named phase (``times``), and event counts a run
    records beside them (``counts``)."""

    def __init__(self, device=None):
        self.device = device
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(device=self.device)
            self.times[name] = self.times.get(name, 0.0) + \
                time.perf_counter() - t0

    def time_phase(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)`` timed as phase ``name``."""
        with self.phase(name):
            return fn(*args, **kwargs)

    def report(self, total_key: str = "eigenvalues") -> str:
        """Reference-style report lines (main.c:676-678,
        filehandling.c:567-568): the eigenvalue phase, then the
        backtransformation ("backtransformation", or
        "backtransformation_streamed" on the streamed route)."""
        lines = []
        if total_key in self.times:
            lines.append("Required time to compute all eigenvalues: "
                         f"{self.times[total_key]:f} seconds")
        for key in ("backtransformation", "backtransformation_streamed"):
            if key in self.times:
                lines.append("Required time for backtransformation: "
                             f"{self.times[key]:f} seconds")
        return "\n".join(lines)


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """``torch.profiler`` around the block when ``trace_dir`` is given (the
    CLI's ``--profile-dir``): host operators, and the card's kernels and
    copies when CUDA is available, written as one Chrome trace
    ``trace_<pid>_<time>.json`` into ``trace_dir`` (created if missing)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}"
        ".json"))
