"""device_idle_share.vqe16: the share of the traced requests' span in
which no device activity runs, from the profiler's device timeline (%), in
the H8 -> 16 VQE cell."""
from portbench.harness import records


def read(run):
    return records.idle_share(run)
