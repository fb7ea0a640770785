"""sigma_ms: milliseconds a Davidson sigma, sum of stage_stats sigma_s (the
program's `davidson.sigma` spans, each closing at its iteration's stop test)
over sum of davidson_matvecs (host clock, the window's requests)."""
from portbench.harness import records


def read(run):
    return records.ratio_ms(run, "sigma_s", "davidson_matvecs")
