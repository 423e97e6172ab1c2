"""Per-stage timing + counters, and JAX profiler trace capture.

The reference has NO tracing/profiling support (SURVEY §5: its only
artifacts are progress logs every 100 frames, test_system.cpp:38-39, and
dead timer variables). This module provides the observability layer the
device build needs: named stage timers (wall clock, with device sync),
monotonic counters, rates (frames/s, BA iterations/s), and a context
manager around `jax.profiler` for XLA-level traces viewable in
TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict, Optional


class StageTimer:
    """Accumulating named wall-clock timers.

    with timers.stage("track"):   # accumulate into 'track'
        ...
    Device work is asynchronous; pass `sync=result` to block on a JAX value
    so the stage charges its real device time.
    """

    def __init__(self):
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)
        self.counters: Dict[str, float] = defaultdict(float)
        self._t0 = time.time()

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.time()
        try:
            yield
        finally:
            if sync is not None:
                import jax
                jax.block_until_ready(sync)
            self.total_s[name] += time.time() - t0
            self.count[name] += 1

    def add(self, counter: str, value: float = 1.0):
        self.counters[counter] += value

    def rate(self, counter: str) -> float:
        """counter per wall second since construction/reset."""
        dt = max(time.time() - self._t0, 1e-9)
        return self.counters[counter] / dt

    def summary(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for name, tot in sorted(self.total_s.items()):
            n = self.count[name]
            out[name] = {"total_s": round(tot, 4), "calls": n,
                         "mean_ms": round(1e3 * tot / max(n, 1), 3)}
        for name, v in sorted(self.counters.items()):
            out[f"counter/{name}"] = {"value": v,
                                      "per_s": round(self.rate(name), 3)}
        return out

    def report(self) -> str:
        return json.dumps(self.summary(), indent=2)

    def reset(self):
        self.total_s.clear()
        self.count.clear()
        self.counters.clear()
        self._t0 = time.time()


@contextlib.contextmanager
def xla_trace(log_dir: Optional[str]):
    """Capture a jax.profiler trace (XLA ops, device timelines) into log_dir.
    No-op when log_dir is falsy, so call sites can stay unconditional."""
    if not log_dir:
        yield
        return
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
