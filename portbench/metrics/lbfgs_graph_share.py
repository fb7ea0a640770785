"""lbfgs_graph_share: the share of the L-BFGS evaluations served by a
CUDA graph replay, in percent: stage_stats lbfgs_graph_evals over
lbfgs_graph_evals + lbfgs_eager_evals, summed over the window's requests
(a program counter), in the H4 VQE cell.  None where the program counts
neither."""
from portbench.harness import records


def read(run):
    reqs = records.host_requests(run)
    graph = records.stat_sum(reqs, "lbfgs_graph_evals")
    eager = records.stat_sum(reqs, "lbfgs_eager_evals")
    if graph is None or eager is None or graph + eager == 0:
        return None
    return 100.0 * graph / (graph + eager)
