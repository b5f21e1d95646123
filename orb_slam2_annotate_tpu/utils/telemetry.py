"""Per-stage timing telemetry + jax.profiler integration.

The reference's observability is chrono timers in the drivers
(mono_tum.cc:78-121) and cout banners (SURVEY §5.1/§5.5).  This module
provides the structured equivalent: named stage timers with streaming
stats, a context manager that also emits jax.profiler TraceAnnotations
(visible in jax.profiler traces), and a one-line report.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageStats:
    count: int = 0
    total: float = 0.0
    best: float = float("inf")
    worst: float = 0.0
    samples: list = field(default_factory=list)

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.best = min(self.best, dt)
        self.worst = max(self.worst, dt)
        if len(self.samples) < 10000:
            self.samples.append(dt)

    @property
    def mean(self):
        return self.total / max(self.count, 1)

    @property
    def median(self):
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        return s[len(s) // 2]


class Telemetry:
    """Collects per-stage wall-clock stats; optionally traces to XProf."""

    def __init__(self, enable_jax_annotations: bool = True):
        self.stages: dict[str, StageStats] = defaultdict(StageStats)
        self._annotate = enable_jax_annotations

    @contextlib.contextmanager
    def stage(self, name: str):
        ctx = contextlib.nullcontext()
        if self._annotate:
            try:
                import jax.profiler

                ctx = jax.profiler.TraceAnnotation(name)
            except Exception:
                pass
        t0 = time.perf_counter()
        with ctx:
            yield
        self.stages[name].add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, st in sorted(self.stages.items()):
            lines.append(
                f"{name:<28s} n={st.count:5d} median={st.median*1e3:8.2f}ms "
                f"mean={st.mean*1e3:8.2f}ms worst={st.worst*1e3:8.2f}ms"
            )
        return "\n".join(lines)

    def reset(self):
        self.stages.clear()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Capture a jax.profiler trace (open with TensorBoard / xprof)."""
    import jax.profiler

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
