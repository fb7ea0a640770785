"""construct_ms.vqe16: construct_ms in the H8 -> 16 VQE cell (the solver's
`construct` span a request, ms, mean over the window's requests)."""
from portbench.harness import records


def read(run):
    mean = records.mean_stat(run, "construct_s")
    return None if mean is None else 1e3 * mean
