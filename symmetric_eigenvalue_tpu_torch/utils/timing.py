"""Phase timing instrumentation.

Each timed block synchronizes its device before the clock stops, so phase
times are honest under CUDA's asynchronous launches.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

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
