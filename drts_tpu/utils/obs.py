"""Observability: scoped pass tracing, per-frame metrics, structured logs.

Replacement for the reference's instrumentation (SURVEY.md §5.1,
§5.5): PIX scoped events (App.cpp:598) become jax.profiler trace
annotations; the Streamline PCL latency markers and OutputDebugString
logging become a structured per-frame metric dict + stdlib logging. Use
``jax.profiler.start_trace`` around a frame window to capture a device
timeline viewable in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time

import jax

logger = logging.getLogger("drts_tpu")


@contextlib.contextmanager
def pass_scope(name: str):
    """ScopedPixEvent analogue: labels device work in profiler timelines
    and measures host wall time."""
    start = time.perf_counter()
    with jax.profiler.TraceAnnotation(name):
        yield
    logger.debug("pass %s: %.2f ms host", name,
                 (time.perf_counter() - start) * 1e3)


class FrameMetrics:
    """Per-frame metric accumulator (ms/pass, Mray/s, FPS) with JSON-lines
    output — the structured form of the reference's debug overlay stats."""

    def __init__(self):
        self.frames = []

    @contextlib.contextmanager
    def frame(self):
        record = {}
        start = time.perf_counter()
        yield record
        record["frame_ms"] = (time.perf_counter() - start) * 1e3
        self.frames.append(record)

    def summary(self) -> dict:
        if not self.frames:
            return {}
        keys = {k for f in self.frames for k in f}
        return {k: sum(f.get(k, 0.0) for f in self.frames) / len(self.frames)
                for k in keys}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            for record in self.frames:
                f.write(json.dumps(record) + "\n")


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a JAX profiler trace for a code region (the PIX GPU
    capture analogue)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
