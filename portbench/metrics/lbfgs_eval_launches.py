"""lbfgs_eval_launches: device events (kernels, copies, sets) a traced
L-BFGS value-and-gradient evaluation: those that start inside the
program's `lbfgs.eval` spans (each given to the innermost span holding its
start) over the number of those spans."""
from portbench.harness import spans


def read(run):
    sp = spans.program_spans(run)
    if not sp:
        return None
    return spans.events_per_span(run["trace"]["events"], sp, "lbfgs.eval")
