"""The measured window of a closed loop with one client, and its
arithmetic.

The window opens at the start of the first timed request and closes at the
end of the first request that ends `seconds` or more after it opened, so
it holds whole requests only and overruns by less than one request.  Each
request's latency counts its construction, solve and copy-back.
"""

from __future__ import annotations

import statistics
import time
import traceback


def serve(issue, req: dict, spans: list, traced: bool = False) -> dict:
    """One request through `issue(req, spans)`: its record, with the
    index, latency, whether it was traced and whether it failed (a failed
    request is counted, not fatal)."""
    own = []
    t0 = time.perf_counter()
    try:
        rec, failed = issue(req, own), False
    except Exception:
        traceback.print_exc()
        rec, failed = {}, True
    t1 = time.perf_counter()
    spans += [(name, req["index"], a, b) for name, a, b in own]
    return dict(rec, index=req["index"], latency_s=t1 - t0, traced=traced,
                failed=failed)


def run(issue, requests, seconds: float) -> dict:
    """Drive `issue(req, spans)` over `requests` for `seconds`.

    Returns {"window_s", "requests": [serve's records], "spans": [(name,
    index, start_ns, end_ns)]}."""
    done, spans = [], []
    t_open = time.perf_counter()
    for req in requests:
        done.append(serve(issue, req, spans))
        if time.perf_counter() - t_open >= seconds:
            break
    return {"window_s": time.perf_counter() - t_open, "requests": done,
            "spans": spans}


def solve_s(window_s: float, n_requests: int) -> float:
    """Window seconds per request completed in it."""
    return window_s / n_requests


def percentile(values, q: float) -> float:
    """The q-th percentile of all values (linear between order statistics,
    as statistics.quantiles' 'inclusive' method)."""
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    cuts = statistics.quantiles(xs, n=100, method="inclusive")
    return float(cuts[int(q) - 1])
