"""Tracing / profiling utilities.

Port of esoo_tpu/utils/profiling.py.  A PhaseTimer accumulates per-phase
wall times; `trace_to` wraps a block in a torch.profiler trace of the
host and the card, exported as a Chrome trace; `annotate` names a span in
that trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

logger = logging.getLogger("esoo_torch")


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
    `trace_<pid>.json` into `logdir`; a no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """torch.profiler.record_function: a named span, as a context
    manager."""
    import torch
    return torch.profiler.record_function(name)
