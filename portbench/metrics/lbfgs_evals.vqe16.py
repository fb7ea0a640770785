"""lbfgs_evals.vqe16: L-BFGS evaluations a request (mean) in the H8 -> 16
VQE cell."""
from portbench.harness import records


def read(run):
    return records.mean_stat(run, "lbfgs_evaluations")
