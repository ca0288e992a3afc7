"""Run tracing: steps/sec and ESS/sec counters and ``torch.profiler``
capture.

Counterpart of ``tensorbnn_tpu/utils/tracing.py``. The driver feeds a
``RunTracer`` once per chunk (``start_chunk`` before the chunk's work is
enqueued, ``end_chunk`` once its diagnostics are on the host, after a
``torch.cuda.synchronize`` that only traced runs pay), giving leapfrog
steps/sec, ESS/sec and a summary; ``profile()`` wraps
``torch.profiler.profile`` for an on-demand trace of a block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class ChunkRecord:
    epochs: int
    #: executed leapfrog kicks per chain per epoch — in grouped-adaptation
    #: runs this is the group-size-weighted mean L (mask-frozen chains do
    #: not kick while the straggler group finishes), so it may be non-int
    leapfrog: float
    n_chains: int
    seconds: float
    #: the straggler group's L — what every chain *pays in wall clock*
    #: each epoch (equals ``leapfrog`` for shared-adapter runs)
    max_leapfrog: float = None

    def __post_init__(self):
        if self.max_leapfrog is None:
            self.max_leapfrog = self.leapfrog


class RunTracer:
    """Accumulates per-chunk timing into throughput counters."""

    def __init__(self):
        self.chunks: List[ChunkRecord] = []
        self._t0: Optional[float] = None

    def start_chunk(self):
        self._t0 = time.perf_counter()

    def end_chunk(self, epochs: int, leapfrog: float, n_chains: int,
                  max_leapfrog: float = None):
        if self._t0 is None:
            return
        self.chunks.append(ChunkRecord(
            epochs, leapfrog, n_chains, time.perf_counter() - self._t0,
            max_leapfrog))
        self._t0 = None

    @property
    def total_seconds(self) -> float:
        return sum(c.seconds for c in self.chunks)

    @property
    def total_leapfrog_steps(self) -> int:
        """Main-chain leapfrog position updates *executed* across all
        chains (grouped-adaptation chunks count each chain at its own
        group's L, not the straggler group's max)."""
        return int(round(sum(c.epochs * c.leapfrog * c.n_chains
                             for c in self.chunks)))

    @property
    def leapfrog_steps_per_sec(self) -> float:
        t = self.total_seconds
        return self.total_leapfrog_steps / t if t > 0 else float("nan")

    def ess_per_sec(self, sample_series: np.ndarray) -> float:
        """ESS/sec of a (draws, chains) scalar summary series."""
        from tensorbnn_tpu_torch.utils.diagnostics import multichain_ess
        series = np.asarray(sample_series)
        if series.ndim == 1:
            series = series[:, None]
        ess = multichain_ess(series[:, :, None] if series.ndim == 2
                             else series)
        t = self.total_seconds
        return ess / t if t > 0 else float("nan")

    @property
    def straggler_efficiency(self) -> float:
        """Mean executed L / straggler-paid L over the run (1.0 for
        shared-adapter runs; below 1, the fraction of the wave front's
        wall the average chain actually kicks through)."""
        paid = sum(c.epochs * c.max_leapfrog for c in self.chunks)
        done = sum(c.epochs * c.leapfrog for c in self.chunks)
        return done / paid if paid > 0 else float("nan")

    def summary(self) -> dict:
        return {
            "chunks": len(self.chunks),
            "epochs": sum(c.epochs for c in self.chunks),
            "total_seconds": round(self.total_seconds, 4),
            "leapfrog_steps": self.total_leapfrog_steps,
            "leapfrog_steps_per_sec": round(self.leapfrog_steps_per_sec, 1),
            "straggler_efficiency": round(self.straggler_efficiency, 4),
        }


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None):
    """Traces the enclosed block with ``torch.profiler`` (the CPU, and the
    CUDA card when there is one) when ``log_dir`` is set, writing a Chrome
    trace ``trace.json`` there; a no-op otherwise. Yields the profiler (or
    None)."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
