"""transform_roofline.vqe16: the 4-index integral transform's share of its
roofline (%) in the H8 -> 16 VQE cell (harness/records.py::transform_share)."""
from portbench.harness import records


def read(run):
    return records.transform_share(run)
