"""lbfgs_evals: L-BFGS evaluations a request (mean): fewer evaluations
against faster ones."""
from portbench.harness import records


def read(run):
    return records.mean_stat(run, "lbfgs_evaluations")
