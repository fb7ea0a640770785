"""bb_iter_ms.casscf: milliseconds per Barzilai-Borwein orbital iteration
in the CASSCF cells, sum of stage_stats bb_s over sum of bb_iterations
(host clock, the window's requests)."""
from portbench.harness import records


def read(run):
    return records.ratio_ms(run, "bb_s", "bb_iterations")
