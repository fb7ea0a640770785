"""gate_scan_roofline.vqe16: the string gate scan K3's share of its
roofline (%) in the H8 -> 16 VQE cell: each traced gate_scan_fwd /
gate_scan_bwd launch bounded at the cell's sector (nB, nA), gates and item
size by harness/roofline.py, over their device time."""
from portbench.harness import records, roofline


def read(run):
    sh = run["shapes"]
    if "gates" not in sh:
        return None
    nbytes = roofline.gate_scan_bytes(sh["nB"], sh["nA"], sh["gates"],
                                      sh["itemsize"])
    flops = roofline.gate_scan_flops(sh["nB"], sh["nA"], sh["gates"])
    bound, seconds = 0.0, 0.0
    for d in ("fwd", "bwd"):
        hit = records.kernel_time(run, f"gate_scan_{d}")
        if hit is None:
            continue
        t, launches = hit
        seconds += t
        bound += launches * roofline.bound_s(nbytes[d], flops[d],
                                             sh["itemsize"])
    return 100.0 * bound / seconds if seconds else None
