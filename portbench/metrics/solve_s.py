"""solve_s: window seconds per request completed in it (host clock)."""
from portbench.harness import records, window


def read(run):
    done = records.host_requests(run)
    return window.solve_s(run["window_s"], len(done)) if done else None
