"""Tracing / profiling utilities: the port's one tracing module.

`span(name)` names a stage of the program where its work happens (the
fused solvers' construction, each outer-loop stage, every L-BFGS
evaluation, BB iteration and Davidson sigma).  A span always adds its
host seconds and a count of one to the keys it names in the running
solve's `stage_stats` (the dict `collect` makes current); while a
torch.profiler session runs, and only then, it also appends (name,
start_ns, end_ns) on `time.time_ns()`, the profiler's clock, to a
bounded process-wide timeline (`timeline()`, `clear_timeline()`).  A
span puts nothing on the device: no record_function, no event, no sync,
no tensor.  There is no switch besides the profiler itself: tracing is
on exactly while one runs (`trace_to`, or any torch.profiler.profile).

Port of esoo_tpu/utils/profiling.py besides: a PhaseTimer accumulates
per-phase wall times; `trace_to` wraps a block in a torch.profiler trace
of the host and the card, exported as a Chrome trace that also carries
the block's spans; `annotate` names a span in that trace.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger("esoo_torch")

# the timeline keeps the newest spans only: a few traced solves fit many
# times over (an H4 cc-pVTZ request makes ~200 spans, an H8 one ~300)
TIMELINE_CAPACITY = 1 << 16
_timeline: deque = deque(maxlen=TIMELINE_CAPACITY)
_stats: contextvars.ContextVar = contextvars.ContextVar(
    "esoo_torch_stage_stats", default=None)


@contextlib.contextmanager
def collect(stats: Optional[dict]) -> Iterator[Optional[dict]]:
    """Spans closed inside the block add their totals into `stats` (into
    nothing where it is None)."""
    token = _stats.set(stats)
    try:
        yield stats
    finally:
        _stats.reset(token)


class span:
    """with span(name, key, count): the block's host seconds (perf_counter)
    are added to stage_stats[key] and 1 to stage_stats[count] of the
    running solve (either key may be None); under a profiler the block
    also joins the timeline.  `start` and `seconds` hold the block's
    perf_counter start and duration."""

    __slots__ = ("name", "key", "count", "start", "seconds", "_ns")

    def __init__(self, name: str, key: Optional[str] = None,
                 count: Optional[str] = None):
        self.name, self.key, self.count = name, key, count
        self.seconds = 0.0

    def __enter__(self) -> "span":
        self._ns = (time.time_ns()
                    if _autograd_profiler._is_profiler_enabled else None)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self.start
        if self._ns is not None:
            _timeline.append((self.name, self._ns, time.time_ns()))
        stats = _stats.get()
        if stats is not None:
            if self.key is not None:
                stats[self.key] = stats.get(self.key, 0.0) + self.seconds
            if self.count is not None:
                stats[self.count] = stats.get(self.count, 0) + 1
        return False


def timeline() -> list:
    """[(name, start_ns, end_ns)] of the spans closed under a profiler,
    oldest first (the newest TIMELINE_CAPACITY)."""
    return list(_timeline)


def clear_timeline() -> None:
    _timeline.clear()


class PhaseTimer:
    """Accumulates wall-clock per named phase.

    with timer.phase("eigensolver"):
        ...
    timer.totals() -> {"eigensolver": 1.23, ...}
    """

    def __init__(self):
        self._laps: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._laps[name].append(time.perf_counter() - t0)

    @property
    def laps(self) -> Dict[str, List[float]]:
        return dict(self._laps)

    def totals(self) -> Dict[str, float]:
        return {k: sum(v) for k, v in self._laps.items()}

    def report(self) -> str:
        lines = []
        for name, laps in sorted(self._laps.items()):
            lines.append(f"{name:>24}: {sum(laps):8.3f}s over {len(laps)} laps"
                         f" (mean {sum(laps) / len(laps):.4f}s)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace_to(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the block (CPU and, where a card is
    visible, CUDA activities), exported as a Chrome trace
    `trace_<pid>.json` into `logdir`, with the block's spans added as host
    events (category "esoo_span"); a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in _timeline if s[1] >= t0])


def _add_spans(path: str, spans: list) -> None:
    """Append `spans` to the Chrome trace at `path` as complete events on
    the exporting thread, on the trace's own time base (microseconds
    after its baseTimeNanoseconds)."""
    with open(path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid, tid = os.getpid(), threading.get_native_id()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "esoo_span", "name": name, "pid": pid,
         "tid": tid, "ts": (s - base) / 1e3, "dur": (e - s) / 1e3}
        for name, s, e in spans)
    with open(path, "w") as f:
        json.dump(trace, f)


def annotate(name: str):
    """torch.profiler.record_function: a named span, as a context
    manager."""
    import torch
    return torch.profiler.record_function(name)
