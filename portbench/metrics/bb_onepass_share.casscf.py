"""bb_onepass_share.casscf: the share of the BB value-and-grads that went
through the one-pass orbital kernel, in percent: stage_stats bb_vag_onepass
over bb_vag_onepass + bb_vag_autograd, summed over the window's requests
(a program counter), in the CASSCF cell.  None where the program counts
neither."""
from portbench.harness import records


def read(run):
    reqs = records.host_requests(run)
    onepass = records.stat_sum(reqs, "bb_vag_onepass")
    autograd = records.stat_sum(reqs, "bb_vag_autograd")
    if onepass is None or autograd is None or onepass + autograd == 0:
        return None
    return 100.0 * onepass / (onepass + autograd)
