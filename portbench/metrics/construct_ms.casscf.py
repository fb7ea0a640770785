"""construct_ms.casscf: construct_ms in the CASSCF cells (the solver's
`construct` span a request, ms, mean over the window's requests)."""
from portbench.harness import records


def read(run):
    mean = records.mean_stat(run, "construct_s")
    return None if mean is None else 1e3 * mean
