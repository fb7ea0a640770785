"""davidson_matvec_ms: milliseconds per Davidson matvec, sum of
stage_stats davidson_s over sum of davidson_matvecs (host clock;
davidson_s also holds each solve's build_values and diagonal)."""
from portbench.harness import records


def read(run):
    return records.ratio_ms(run, "davidson_s", "davidson_matvecs")
