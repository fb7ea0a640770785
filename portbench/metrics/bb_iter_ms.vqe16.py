"""bb_iter_ms.vqe16: milliseconds per Barzilai-Borwein orbital iteration
in the H8 -> 16 VQE cell, sum of stage_stats bb_s over sum of
bb_iterations (host clock, the window's requests)."""
from portbench.harness import records


def read(run):
    return records.ratio_ms(run, "bb_s", "bb_iterations")
