"""Run one cell of the benchmark once, on the card it is started on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The cell (BENCHMARK.json "workloads") names
a configuration (portbench/configs/) and a traffic mix (portbench/traffic/).
Set-up loads the configuration's inputs (made and cached in the checkout
on its first run), the port and its kernels, and serves one warm-up
request; then a closed loop with one client serves requests for `--seconds`
(harness/window.py); with --trace 1 the traffic's `trace_requests` next
requests run under the profiler after the window closes, so that no host
clock of the window runs beside it.  Then the plain reference checks every
request (portbench/reference/), and the last line of standard output is one
JSON object: "correct", "attempted", "failed", "metrics" (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), "device"
(and with --trace 1 "breakdown"), and last "checks", each compared
number beside its limit.  Exits 2 without a result where there is no card
(or fewer than the cell asks for), and 3 where a forbidden module (JAX,
the JAX package) was loaded.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BUILD = os.path.join(HERE, "build")


def set_cache_dirs() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout (the port builds its own kernels into build/esoo_torch/
    beside its package)."""
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("ESOO_CACHE_DIR", "esoo_torch_cache")):
        os.environ[key] = os.path.join(BUILD, sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, bench, run, worst, limits, device, traced,
                base) -> dict:
    """The last line: the contract's keys, with `checks` (each compared
    number beside its limit) last."""
    from portbench.harness import manifest, records, session, trace
    metrics = {}
    for m in manifest.metrics_of(bench, cell["name"], traced):
        value = manifest.metric_reader(m["name"], base)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(run["requests"])
    failed = attempted - len(records.completed(run))
    correct, rows = session.judge(worst, limits, attempted, failed)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if traced and run["trace"] is not None:
        tr = run["trace"]
        lo, hi = tr["t0_ns"], tr["t1_ns"]
        device["busy_s"] = trace.busy_ns(tr["events"], lo, hi) / 1e9
        device["window_s"] = (hi - lo) / 1e9
        line["breakdown"] = trace.breakdown(tr["events"], run["spans"],
                                            lo, hi)
    line["checks"] = rows
    return line


def execute(cell_name: str, seed: int, seconds: float, traced: bool,
            device: str = "cuda", root: str = ROOT, base: str = HERE,
            cache_root: str = None, t0: float = _T0):
    """Set-up, window, check and result line of one run on `device`:
    (result line, the check's readings).  `root` holds BENCHMARK.json,
    `base` the configs/, traffic/, limits/ and metrics/ folders."""
    import torch

    from portbench.harness import manifest, session

    bench = manifest.benchmark(root)
    cell = manifest.cell(bench, cell_name)
    config = manifest.config(cell["config"], base)
    traffic = manifest.traffic(cell["traffic"], base)
    limits = manifest.limits(cell["name"], base)["limits"]

    cuda = torch.device(device).type == "cuda"
    s = session.Session(config, traffic, device, cache_root)
    s.warmup(seed)
    setup_s = time.perf_counter() - t0
    run = s.measure(seed, seconds, traced and cuda)
    run["setup_s"] = setup_s
    checks = s.check(run)
    device_row = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": cell["chips"],
                  "memory_peak_bytes": run["peak_bytes"]}
    line = result_line(cell, bench, run, checks["worst"], limits,
                       device_row, traced, base)
    print("latencies_s " + " ".join(f"{r['latency_s']:.4f}"
                                    for r in run["requests"]),
          file=sys.stderr)
    return line, checks


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    sys.path.insert(0, ROOT)
    from portbench.harness import manifest, session

    cell = manifest.cell(manifest.benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2

    line, checks = execute(args.workload, args.seed, args.seconds,
                           bool(args.trace))
    bad = session.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, v in sorted(checks["worst"].items()):
        if name not in line["checks"]:
            print(f"check (not compared) {name} = {v!r}", file=sys.stderr)
    for name, row in line["checks"].items():
        print(f"check {name} = {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
