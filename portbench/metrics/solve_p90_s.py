"""solve_p90_s: the 90th percentile of the latencies of all requests in
the window (host clock; construction, solve and copy-back)."""
from portbench.harness import records, window


def read(run):
    lat = [r["latency_s"] for r in records.window_requests(run)]
    return window.percentile(lat, 90) if lat else None
