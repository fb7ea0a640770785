"""solve_s.casscf: window seconds per CASSCF request completed in it (host
clock): solve_s for the CASSCF cells, whose runs spread less than the VQE
cells' and so carry a bound of their own."""
from portbench.harness import records, window


def read(run):
    done = records.host_requests(run)
    return window.solve_s(run["window_s"], len(done)) if done else None
