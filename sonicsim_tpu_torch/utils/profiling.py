"""Per-stage timing and traces.

Port of ``sonicsim_tpu.utils.profiling``: ``StageTimer`` accumulates named
stage timings, waiting for the stage's CUDA device before it reads the
clock (on the CPU there is nothing to wait for); ``trace`` wraps
``torch.profiler`` and writes a Chrome trace; ``annotate`` names a region
in that trace (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import torch


def _devices(result) -> set:
    """The CUDA devices of the tensors in ``result`` (nested tuples, lists
    and dicts)."""
    if torch.is_tensor(result):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (tuple, list)):
        return set().union(*(_devices(r) for r in result)) if result else set()
    return set()


def _wait(result=None) -> None:
    """Wait for ``result``'s CUDA devices, or with no result for the current
    CUDA device where one is in use; nothing on the CPU."""
    devices = _devices(result) if result is not None else (
        {torch.device("cuda", torch.cuda.current_device())}
        if torch.cuda.is_available() and torch.cuda.is_initialized() else set())
    for d in devices:
        torch.cuda.synchronize(d)


class StageTimer:
    """Accumulating per-stage wall-clock timer with device synchronization."""

    def __init__(self, sync: bool = True):
        self.sync = sync
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        """Time the block; with ``sync``, wait for ``result``'s devices (or the
        current CUDA device) before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                _wait(result)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def time(self, name: str, fn, *args, **kwargs):
        """Run fn, waiting for its result's devices, and record the stage."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.sync:
            _wait(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 6),
                "count": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def report(self) -> str:
        lines = [f"{'stage':<32} {'count':>6} {'mean ms':>10} {'total s':>9}"]
        for name, s in self.summary().items():
            lines.append(
                f"{name:<32} {s['count']:>6} {s['mean_ms']:>10.3f} {s['total_s']:>9.3f}"
            )
        return "\n".join(lines)

    def dump(self, path: str | Path) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def trace(log_dir: str | Path = "sonicsim_trace"):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where there
    is a card) and write its Chrome trace, ``trace.json``, under
    ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region that shows up in profiler traces."""
    with torch.profiler.record_function(name):
        yield
