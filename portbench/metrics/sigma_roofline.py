"""sigma_roofline: the Davidson sigma's share of its roofline (%): the
traced `davidson.sigma` spans, each bounded by harness/spans.py at the
cell's sector (n, nA, nB) and item size whatever computes it, over the
device busy time inside those spans."""
from portbench.harness import spans


def read(run):
    sp = spans.program_spans(run)
    if not sp:
        return None
    n, busy_ns = spans.busy_inside(run["trace"]["events"], sp,
                                   "davidson.sigma")
    if not n or not busy_ns:
        return None
    sh = run["shapes"]
    one = spans.sigma_bound_s(sh["n"], sh["nA"], sh["nB"], sh["itemsize"])
    return 100.0 * n * one / (busy_ns / 1e9)
