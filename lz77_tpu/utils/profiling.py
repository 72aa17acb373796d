"""Profiling hooks (jax.profiler) — SURVEY.md §5 'tracing/profiling: none'
in the reference; the device build exposes real traces.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Capture a TensorBoard-loadable device trace when ``log_dir`` is set."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline (no-op overheadless fallback)."""
    try:
        import jax

        with jax.profiler.TraceAnnotation(name):
            yield
    except Exception:
        yield
