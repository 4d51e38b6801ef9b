"""Tracing and per-stage profiling.

The reference has no profiling beyond wrapping module tests in /usr/bin/time
(Makefile:49,53,57); SURVEY.md section 5 calls for jax.profiler traces plus
per-stage wall timers and Mpix/s counters — this module provides both.

JAX dispatch is asynchronous, so a stage's time ends when its result is
ready: StageTimer waits on the value passed to ``done`` with
``jax.block_until_ready``, which raises if the computation failed.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


def _sync(value):
    """Wait for the computation producing `value` (errors propagate)."""
    if value is not None:
        import jax

        jax.block_until_ready(value)
    return value


class StageTimer:
    """Accumulates wall time and pixel counts per named pipeline stage."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.pixels = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, pixels: int = 0):
        if not self.enabled:
            yield lambda value=None: value
            return
        t0 = time.perf_counter()
        box = {}

        def done(value=None):
            box["value"] = _sync(value)
            return box.get("value")

        yield done
        _sync(box.get("value"))
        dt = time.perf_counter() - t0
        self.times[name] += dt
        self.counts[name] += 1
        self.pixels[name] += pixels

    def report(self) -> str:
        lines = ["stage                          calls   total_s    Mpix/s"]
        for name in sorted(self.times, key=lambda n: -self.times[n]):
            t = self.times[name]
            mpix = self.pixels[name] / t / 1e6 if t > 0 and self.pixels[name] else 0
            lines.append(
                f"{name:<30} {self.counts[name]:>5} {t:>9.3f} {mpix:>9.1f}"
            )
        return "\n".join(lines)


def stage_report(timer: StageTimer) -> str:
    return timer.report()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """jax.profiler trace context (view with TensorBoard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
