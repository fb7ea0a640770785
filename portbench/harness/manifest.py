"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of "workloads") names a configuration and a traffic mix.
The harness reads:
  portbench/configs/<config>.json    the configuration (molecule, basis,
                                     precision, sizes, source, reduced)
  portbench/traffic/<traffic>.json   the traffic mix's parameters, which
                                     the one generator (harness/generator.py)
                                     and client (harness/client.py) read
  portbench/limits/<cell>.json       the limit of each number that decides
                                     `correct`
  portbench/metrics/<metric>.py      one reader a metric, `read(run)`
so a later change adds a configuration, a mix or a metric as new files
and new entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def _named(kind: str, name: str, ext: str, base: str = PORTBENCH) -> str:
    if not NAME_RE.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(base, kind, name + ext)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def config(name: str, base: str = PORTBENCH) -> dict:
    return read_json(_named("configs", name, ".json", base))


def traffic(name: str, base: str = PORTBENCH) -> dict:
    return read_json(_named("traffic", name, ".json", base))


def limits(cell: str, base: str = PORTBENCH) -> dict:
    return read_json(_named("limits", cell, ".json", base))


def metric_reader(name: str, base: str = PORTBENCH):
    """The `read(run)` of metrics/<name>.py."""
    path = _named("metrics", name, ".py", base)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, cell_name: str, traced: bool) -> list:
    """The cell's metrics: its end-to-end metrics untraced, its per-layer
    metrics traced (a metric without "workloads" belongs to every cell)."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if cell_name in m.get("workloads", [cell_name])]
