"""Tracing / profiling utilities.

The reference's observability is ad-hoc ``timeit`` spans and tqdm bars
(SURVEY.md §5: ex3.py:681-686, tracking_database.py:445-470). Here:

  * :class:`StageTimer` — structured wall-clock spans with a JSON dump
    (consumed by the pipeline driver's ``timings`` report);
  * :func:`device_trace` — context manager around ``jax.profiler`` traces
    (view with TensorBoard / xprof) for kernel-level device profiling;
  * :func:`log` — stdlib-logging-backed structured event logging,
    replacing the reference's bare prints.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path

logger = logging.getLogger("slam_tpu")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(asctime)s %(name)s] %(message)s",
                                      "%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)


def log(event: str, **fields) -> None:
    """Structured event log line (key=value pairs)."""
    suffix = " ".join(f"{k}={v}" for k, v in fields.items())
    logger.info("%s %s", event, suffix)


class StageTimer:
    """Nested wall-clock spans with a flat JSON report."""

    def __init__(self) -> None:
        self.spans: dict[str, float] = {}
        self._stack: list[tuple[str, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        self._stack.append((name, t0))
        try:
            yield
        finally:
            self._stack.pop()
            prefix = ".".join(n for n, _ in self._stack)
            key = f"{prefix}.{name}" if prefix else name
            self.spans[key] = self.spans.get(key, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> dict[str, float]:
        return dict(self.spans)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.report(), indent=2))


@contextlib.contextmanager
def device_trace(out_dir: str | Path, enabled: bool = True):
    """jax.profiler trace scope (kernel-level device timeline)."""
    if not enabled:
        yield
        return
    import jax

    jax.profiler.start_trace(str(out_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()
