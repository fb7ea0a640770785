"""lbfgs_eval_ms: milliseconds per L-BFGS value-and-gradient evaluation,
sum of stage_stats lbfgs_s over sum of lbfgs_evaluations (host clock)."""
from portbench.harness import records


def read(run):
    return records.ratio_ms(run, "lbfgs_s", "lbfgs_evaluations")
