"""The program's own spans beside the device trace of the traced requests,
and the least time of one sigma of a CI sector.

The port (esoo_torch.utils.profiling) adds a span to a process-wide
timeline only while a profiler runs, so after a traced run the timeline
holds the traced requests' spans: the window and the warm-up run with no
profiler.  The spans are stamped on time.time_ns(), the clock of the
profiler's device timeline (trace.py).  As in trace.py the functions take
plain (name, start_ns, end_ns) tuples, so they are tested on synthetic
timelines; `program_spans` alone reads the port, and finds nothing in a
program that keeps no timeline.
"""

from __future__ import annotations

import bisect
from math import comb

from . import roofline, trace as _trace


def program_spans(run: dict):
    """The program's spans that lie inside the run's traced span, oldest
    first; None untraced, or where the program keeps no timeline."""
    tr = run.get("trace")
    if tr is None:
        return None
    try:
        from esoo_torch.utils.profiling import timeline
    except ImportError:
        return None
    lo, hi = tr["t0_ns"], tr["t1_ns"]
    return [s for s in timeline() if lo <= s[1] and s[2] <= hi]


def innermost(events, spans) -> list:
    """For each event, the index in `spans` of the innermost span that
    holds its start (start <= t < end), or None.  Spans nest (the host
    opens them in one thread); a sweep over both, sorted by start."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1],
                                                     -spans[i][2]))
    out = [None] * len(events)
    stack, j = [], 0
    for k in sorted(range(len(events)), key=lambda k: events[k][1]):
        t = events[k][1]
        while j < len(order) and spans[order[j]][1] <= t:
            nxt = spans[order[j]]
            while stack and spans[stack[-1]][2] <= nxt[1]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]][2] <= t:
            stack.pop()
        if stack:
            out[k] = stack[-1]
    return out


def events_per_span(events, spans, name: str):
    """The device events (kernels, copies, sets) that start inside `name`
    spans, each given to the innermost span holding its start, per `name`
    span; None where there is no such span."""
    n = sum(1 for s in spans if s[0] == name)
    if not n:
        return None
    hits = sum(1 for i in innermost(events, spans)
               if i is not None and spans[i][0] == name)
    return hits / n


def busy_inside(events, spans, name: str) -> tuple:
    """(number of `name` spans, device busy ns inside them: the union of
    the events clipped to each span)."""
    mine = sorted((s, e) for n, s, e in spans if n == name)
    if not mine:
        return 0, 0
    busy = _trace.merged(events, mine[0][0], max(e for _, e in mine))
    starts = [a for a, _ in busy]
    total = 0
    for s, e in mine:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            total += max(0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
    return len(mine), total


def sigma_couplings(n: int, na: int, nb: int) -> int:
    """The structural nonzero <D|H|D'> in one determinant's row of the
    (na, nb) sector of n spatial orbitals: itself, its alpha and beta
    singles, its same-spin doubles and its alpha-beta doubles."""
    sa, sb = na * (n - na), nb * (n - nb)
    return (1 + sa + sb + comb(na, 2) * comb(n - na, 2)
            + comb(nb, 2) * comb(n - nb, 2) + sa * sb)


def _electrons(n: int, strings: int) -> int:
    """A particle count whose strings number `strings` (the couplings are
    the same for k and n - k electrons)."""
    for k in range(n + 1):
        if comb(n, k) == strings:
            return k
    raise ValueError(f"no count of {n} orbitals makes {strings} strings")


def sigma_bound_s(n: int, nA: int, nB: int, itemsize: int) -> float:
    """The least time of one sigma H v of the sector with nA alpha and nB
    beta strings over n orbitals, whatever computes it: the CI vector read
    and sigma written once, an FMA (two operations) a coupling."""
    nd = nA * nB
    couplings = sigma_couplings(n, _electrons(n, nA), _electrons(n, nB))
    return roofline.bound_s(2 * nd * itemsize, 2 * nd * couplings, itemsize)
