"""outer_iters: outer iterations of the OptOrb loop a request
(result.outer_iterations, mean)."""
from portbench.harness import records


def read(run):
    reqs = records.host_requests(run)
    return sum(r["outer_iterations"] for r in reqs) / len(reqs) if reqs \
        else None
