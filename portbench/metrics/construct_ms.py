"""construct_ms: milliseconds of the solver's construction a request in the
VQE cells (stage_stats construct_s, the program's `construct` span: the
integrals to the card, the sector and its tables, the ansatz), mean over
the window's requests."""
from portbench.harness import records


def read(run):
    mean = records.mean_stat(run, "construct_s")
    return None if mean is None else 1e3 * mean
