"""What the metric readers share: the run record and its device trace.

A run record (built by run.py) holds "setup_s", "window_s", "peak_bytes",
"requests" (the window's, then the traced ones; each with "latency_s",
"failed", "traced", "outer_iterations" and the solver's numeric
"stage_stats"), "shapes" (the cell's m, n, string counts, gates and item
size), "trace" (None untraced; else the traced requests' "events" (name,
start_ns, end_ns), "t0_ns", "t1_ns" and "requests") and "spans".
"""

from __future__ import annotations

from . import roofline, trace as _trace

# the transform's kernels: the one-pass route (csrc/transform.cu) and the
# K1 chain (csrc/gemm.cu, which runs only in the transform)
TRANSFORM_KERNELS = ("transform_slab_pass", "transform_reduce",
                     "gemm_narrow_ring", "gemm_tiled")


def completed(run: dict) -> list:
    return [r for r in run["requests"] if not r["failed"]]


def window_requests(run: dict) -> list:
    """The requests of the measured window (the traced ones follow it)."""
    return [r for r in run["requests"] if not r["traced"]]


def host_requests(run: dict) -> list:
    """The window's completed requests, none run under the profiler: host
    clocks read from these."""
    return [r for r in completed(run) if not r["traced"]]


def stat_sum(reqs: list, key: str):
    """The sum of a stage_stats key over reqs; None where none has it."""
    vals = [r["stage_stats"][key] for r in reqs if key in r["stage_stats"]]
    return sum(vals) if vals else None


def ratio_ms(run: dict, seconds_key: str, count_key: str):
    """Milliseconds per unit: sum of a seconds stat over sum of a count."""
    reqs = host_requests(run)
    s, c = stat_sum(reqs, seconds_key), stat_sum(reqs, count_key)
    if s is None or not c:
        return None
    return 1e3 * s / c


def mean_stat(run: dict, key: str):
    reqs = host_requests(run)
    total = stat_sum(reqs, key)
    return None if total is None else total / len(reqs)


def kernel_time(run: dict, *names: str):
    """(seconds, launches) of the traced kernels with these function names;
    None untraced or where none ran."""
    tr = run.get("trace")
    if tr is None:
        return None
    pat = _trace.kernel_re(*names)
    hits = [(e - s) for n, s, e in tr["events"] if pat.search(n)]
    if not hits:
        return None
    return sum(hits) / 1e9, len(hits)


def transform_share(run: dict):
    """The 4-index transform's share of its roofline (%): one transform of
    the cell's (m, n) an outer iteration and one for the final re-solve
    (outer_iterations + 1 a traced request), each bounded by roofline.py
    whatever route runs it, over the traced transform kernels' time."""
    hit = kernel_time(run, *TRANSFORM_KERNELS)
    if hit is None:
        return None
    seconds, _ = hit
    sh = run["shapes"]
    calls = sum(r["outer_iterations"] + 1 for r in run["trace"]["requests"]
                if not r["failed"])
    one = roofline.bound_s(
        roofline.transform_bytes(sh["m"], sh["n"], sh["itemsize"]),
        roofline.transform_flops(sh["m"], sh["n"]), sh["itemsize"])
    return 100.0 * calls * one / seconds


def idle_share(run: dict):
    """The share of the traced span in which no device activity runs (%)."""
    tr = run.get("trace")
    if tr is None or not tr["events"]:
        return None
    lo, hi = tr["t0_ns"], tr["t1_ns"]
    return 100.0 * (1.0 - _trace.busy_ns(tr["events"], lo, hi) / (hi - lo))
