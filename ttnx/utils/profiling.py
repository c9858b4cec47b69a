"""Profiling, timing, and roofline telemetry (SURVEY §5: the reference has
only @showprogress; this is the jax.profiler-based observability layer)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import jax

__all__ = ["trace", "Timer", "SolverTelemetry", "contraction_flops",
           "sync_and_time"]


@contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace around a block (view in TensorBoard /
    xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def sync_and_time(fn, *args, iters: int = 1):
    """Mean wall-clock seconds of ``fn(*args)`` over ``iters`` calls, each
    waited for with ``jax.block_until_ready``, after one untimed warm-up
    call (which absorbs compilation). Returns ``(seconds, out)``."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = jax.block_until_ready(fn(*args))
    return (time.perf_counter() - t0) / iters, out


class Timer:
    """Accumulating named wall-clock sections."""

    def __init__(self):
        self.sections: dict[str, float] = {}

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.sections.values())
        lines = [f"total {total * 1e3:.2f} ms"]
        for k, v in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v * 1e3:.2f} ms ({100 * v / total:.1f}%)")
        return "\n".join(lines)


@dataclass
class SolverTelemetry:
    """Structured per-solve metrics: iteration/rank histories plus throughput
    (replaces the reference's @info rank logging with data a dashboard can
    consume)."""

    residuals: list = field(default_factory=list)
    energies: list = field(default_factory=list)
    max_ranks: list = field(default_factory=list)
    local_solves: int = 0
    wall_seconds: float = 0.0
    flops: float = 0.0

    def gflops_per_s(self) -> float:
        return self.flops / max(self.wall_seconds, 1e-12) / 1e9

    def record_sweep(self, residual=None, energy=None, max_rank=None):
        if residual is not None:
            self.residuals.append(float(residual))
        if energy is not None:
            self.energies.append(float(energy))
        if max_rank is not None:
            self.max_ranks.append(int(max_rank))


def contraction_flops(dims_a, dims_b, contracted) -> float:
    """FLOP count of a pairwise tensor contraction: 2 * prod(all distinct
    dims); ``contracted`` is the list of shared dimension sizes."""
    out = 2.0
    for d in dims_a:
        out *= d
    for d in dims_b:
        out *= d
    for d in contracted:
        out /= d
    return out
