"""davidson_matvecs: Davidson matvecs a request (mean)."""
from portbench.harness import records


def read(run):
    return records.mean_stat(run, "davidson_matvecs")
