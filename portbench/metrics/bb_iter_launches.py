"""bb_iter_launches: device events (kernels, copies, sets) a traced
Barzilai-Borwein orbital iteration: those that start inside the program's
`bb.iter` spans (each given to the innermost span holding its start) over
the number of those spans."""
from portbench.harness import spans


def read(run):
    sp = spans.program_spans(run)
    if not sp:
        return None
    return spans.events_per_span(run["trace"]["events"], sp, "bb.iter")
