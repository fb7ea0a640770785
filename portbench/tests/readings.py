"""The readings behind a cell's limits, on the card at the cell's size.

    python3 -m portbench.tests.readings --workload <cell> --seeds a,b,... \
        --seconds <s> [--fault orbitals_unchanged|tf32] --out <file.json>

from the root of a checkout.  Each seed is one run of run.execute (set-up,
window, check, result line) in one process, the port sound or with a fault
of tests/faults.py planted underneath its timed path; every request's
readings, latency and outer iterations go to `--out`, and each run's worst
readings to standard output.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import run as _run  # noqa: E402

from portbench.tests import faults  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   type=lambda s: [int(x) for x in s.split(",") if x])
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", choices=("orbitals_unchanged", "tf32"))
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    _run.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    patch = faults.Patch()
    if args.fault:
        getattr(faults, args.fault)(patch)
    out = {"cell": args.workload, "fault": args.fault,
           "device": torch.cuda.get_device_name(0), "runs": []}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for seed in args.seeds:
        line, checks = _run.execute(args.workload, seed, args.seconds, False,
                                    t0=time.perf_counter())
        out["runs"].append({"seed": seed, "line": line,
                            "worst": checks["worst"],
                            "requests": checks["requests"]})
        print(json.dumps({"seed": seed, "correct": line["correct"],
                          "attempted": line["attempted"],
                          "metrics": line["metrics"],
                          "worst": checks["worst"]}), flush=True)
        with open(args.out, "w") as f:     # after every run: a cut call
            json.dump(out, f)              # keeps what it read
    patch.undo()
    faults.tf32_off()
    return 0


if __name__ == "__main__":
    sys.exit(main())
