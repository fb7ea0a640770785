"""lbfgs_eval_ms.vqe16: lbfgs_eval_ms in the H8 -> 16 VQE cell (sum of
stage_stats lbfgs_s over sum of lbfgs_evaluations, ms, host clock)."""
from portbench.harness import records


def read(run):
    return records.ratio_ms(run, "lbfgs_s", "lbfgs_evaluations")
