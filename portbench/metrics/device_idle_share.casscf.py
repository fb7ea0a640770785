"""device_idle_share.casscf: the share of the traced requests' span in
which no device activity runs, from the profiler's device timeline (%), in
the CASSCF cells."""
from portbench.harness import records


def read(run):
    return records.idle_share(run)
