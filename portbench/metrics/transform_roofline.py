"""transform_roofline: the 4-index integral transform's share of its
roofline (%) in the VQE cells (harness/records.py::transform_share)."""
from portbench.harness import records


def read(run):
    return records.transform_share(run)
