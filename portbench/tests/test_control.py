"""The controls: the precision step below a configuration's fails its
cell's check, and the configuration's own precision passes it.

A float32 cell's control is the port with its float32 products allowed
TF32 (on the card; at H4 6-31G with the outer and BB loops capped so that
it fits a test: under TF32 the BB loop runs to its cap, and at the cells'
size a request takes minutes).  A float64 cell's control is the port's
float32 path (on the CPU here).  tests/readings.py reads either at the
cells' size on the card."""

import json
import os
import sys
import time

import pytest

from portbench.harness import manifest
from portbench.tests import faults, minibench


def _tree(tmp):
    root, base = minibench.build(tmp)
    path = os.path.join(base, "configs", "h4_631g.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["precision"] = {"dtype": "float32", "tf32": False}
    with open(path, "w") as f:
        json.dump(cfg, f)
    for mix in ("vqe8",):
        path = os.path.join(base, "traffic", mix + ".json")
        with open(path) as f:
            tr = json.load(f)
        tr["options"].update(maxiter=3, inner_maxiter=300)
        tr["reference_device"] = "cuda"
        with open(path, "w") as f:
            json.dump(tr, f)
    return root, base


def _execute(cell, root, base, tmp_path):
    sys.path.insert(0, manifest.PORTBENCH)
    import run
    line, _ = run.execute(cell, 987654321, 1.0, False, device="cuda",
                          root=root, base=base,
                          cache_root=str(tmp_path / "cache"),
                          t0=time.perf_counter())
    return line


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["h4_631g.vqe8"])
def test_tf32_control_fails_and_float32_passes(cuda, tmp_path, cell,
                                               monkeypatch):
    """The float32 cell (the VQE mix, under the H4 cell's limits); the
    float64 cell's control is the next test's."""
    root, base = _tree(str(tmp_path))
    sound = _execute(cell, root, base, tmp_path)
    assert sound["correct"], sound["checks"]

    faults.tf32(monkeypatch)
    try:
        control = _execute(cell, root, base, tmp_path)
    finally:
        faults.tf32_off()
    assert not control["correct"], control["checks"]


def test_float32_path_fails_the_float64_cell(tmp_path):
    """The CASSCF cell is float64: its limits hold the port's float64 path
    and refuse its float32 path."""
    sys.path.insert(0, manifest.PORTBENCH)
    import run
    cell = "h4_631g.casscf8"
    root, base = minibench.build(str(tmp_path))
    seen = {}
    for dtype in ("float64", "float32"):
        path = os.path.join(base, "configs", "h4_631g.json")
        with open(path) as f:
            cfg = json.load(f)
        cfg["precision"]["dtype"] = dtype
        with open(path, "w") as f:
            json.dump(cfg, f)
        seen[dtype], _ = run.execute(cell, 55555, 1.0, False, device="cpu",
                                     root=root, base=base,
                                     cache_root=str(tmp_path / "cache"),
                                     t0=time.perf_counter())
    assert seen["float64"]["correct"], seen["float64"]["checks"]
    assert not seen["float32"]["correct"], seen["float32"]["checks"]
