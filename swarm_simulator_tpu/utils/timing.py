"""Timing, profiling, and problem-size observability.

The reference wraps every stage in a wall-clock Timer and prints runtimes
plus QP problem-size counters (timer.hpp:6-35; rbp_planner.hpp:51-60).
Device work is asynchronous under JAX, so the Timer here blocks on
jax.block_until_ready when given a result, and a jax.profiler context is
provided for deep traces.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass


class Timer:
    """Wall-clock stage timer (timer.hpp semantics + async-aware stop)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._elapsed = 0.0

    def stop(self, result=None) -> float:
        if result is not None:
            import jax
            jax.block_until_ready(result)
        self._elapsed = time.perf_counter() - self._t0
        return self._elapsed

    def elapsed_seconds(self) -> float:
        return self._elapsed


@contextlib.contextmanager
def scoped_timer(name: str, sink=None):
    """ScopedTimer (timer.hpp:24-35): prints on exit."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    msg = f"{name}: {dt:.6f}s"
    if sink is None:
        print(msg)
    else:
        sink(msg)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context — the device deep-profiling path."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@dataclass
class ProblemSize:
    """QP problem-size counters (printed by the reference after each
    solve: rbp_planner.hpp:58-60)."""

    n_vars: int = 0
    n_eq: int = 0
    n_ineq: int = 0

    @classmethod
    def of_batch(cls, B: int, M: int, n: int, phi: int,
                 n_pairs: int) -> "ProblemSize":
        D = M * (n + 1)
        return cls(
            n_vars=3 * B * D,
            n_eq=3 * B * (M + 1) * phi,
            n_ineq=2 * 3 * B * D + n_pairs * D,
        )

    def __str__(self):
        return (f"x size={self.n_vars}, eq const size={self.n_eq}, "
                f"ineq const size={self.n_ineq}")
