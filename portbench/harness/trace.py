"""The device timeline of a traced window, from torch.profiler.

The profiler records the device's activity only (CUDA kernels, copies and
sets; no host operators, so it adds little to a host-bound path).  Its
timestamps are the host's wall clock in nanoseconds, the base of the
client's spans, so an idle gap on the device is named by the span the
host was in.  The functions below take plain (name, start_ns, end_ns)
tuples, so they are tested on synthetic timelines.
"""

from __future__ import annotations

import re
import time


class Tracer:
    """Starts and stops torch.profiler around the traced requests."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> dict:
        self.torch.cuda.synchronize()
        t1 = time.time_ns()
        self.prof.stop()
        return {"prof": self.prof, "t0_ns": self.t0_ns, "t1_ns": t1}


def device_events(trace: dict) -> list:
    """[(name, start_ns, end_ns)] of every device activity in the trace."""
    out = []
    for e in trace["prof"].profiler.kineto_results.events():
        if str(e.device_type()).rsplit(".", 1)[-1] == "CUDA":
            start = e.start_ns()
            out.append((e.name(), start, start + e.duration_ns()))
    return out


def merged(events, lo: int, hi: int) -> list:
    """The union of the events' intervals, clipped to [lo, hi]."""
    out = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(events, lo: int, hi: int) -> int:
    return sum(e - s for s, e in merged(events, lo, hi))


def gaps(events, lo: int, hi: int) -> list:
    """[(start_ns, end_ns)] where no device activity runs in [lo, hi]."""
    out, t = [], lo
    for s, e in merged(events, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def _overlap(a0, a1, b0, b1) -> int:
    return max(0, min(a1, b1) - max(a0, b0))


def name_gap(gap, spans) -> str:
    """The host span (name, request index, start, end) that covers most of
    the gap, as "name r<index>"; "harness" where none does."""
    best, name = 0, "harness"
    for sname, index, s, e in spans:
        ov = _overlap(gap[0], gap[1], s, e)
        if ov > best:
            best, name = ov, f"{sname} r{index}"
    return name


def by_name(events) -> dict:
    """{name: (total seconds, count)} of the events."""
    out = {}
    for name, s, e in events:
        tot, cnt = out.get(name, (0.0, 0))
        out[name] = (tot + (e - s) / 1e9, cnt + 1)
    return out


def kernel_re(*names: str):
    """A pattern that matches a kernel by its function name (demangled
    names carry a return type, template arguments and a signature)."""
    return re.compile(r"(?:^|[\s:])(?:%s)\b" % "|".join(
        re.escape(n) for n in names))


def breakdown(events, spans, lo: int, hi: int, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle gaps,
    each [name, seconds]."""
    ops = sorted(((n, t) for n, (t, _) in by_name(events).items()),
                 key=lambda x: -x[1])[:top]
    longest = sorted(gaps(events, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:160], t] for n, t in ops],
            "idle_gaps": [[name_gap(g, spans), (g[1] - g[0]) / 1e9]
                          for g in longest]}
