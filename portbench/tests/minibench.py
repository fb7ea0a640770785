"""A small benchmark tree for the CPU tests: the harness's own metrics and
the cells' traffic and limits, on H4 6-31G (8 spatial orbitals) at
float64, so a whole run (set-up, window, check, result line) fits a test."""

from __future__ import annotations

import json
import os
import shutil

from portbench.harness import manifest

H4_631G = {
    "name": "h4_631g",
    "source": "test configuration: linear H4 at 1.23 Angstrom, 6-31G",
    "molecule": {"atom": "H 0 0 0; H 0 0 1.23; H 0 0 2.46; H 0 0 3.69",
                 "basis": "6-31g", "charge": 0, "spin": 0,
                 "units": "angstrom"},
    "mean_field": "RHF",
    "num_spatial_orbitals": 8,
    "num_particles": [2, 2],
    "precision": {"dtype": "float64", "tf32": False},
    "reduced": [],
}

CELLS = {"h4_631g.vqe8": ("vqe8", "h4_ccpvtz.vqe8"),
         "h4_631g.casscf8": ("casscf8", "h8_ccpvtz_f64.casscf28")}


def build(tmp: str) -> tuple:
    """(root, base) of a benchmark whose two cells run the real cells'
    traffic (casscf28's at 8 active spin orbitals) and limits on H4
    6-31G."""
    root = os.path.join(tmp, "root")
    base = os.path.join(root, "portbench")
    shutil.copytree(os.path.join(manifest.PORTBENCH, "metrics"),
                    os.path.join(base, "metrics"))
    for d in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(base, d))
    real = manifest.benchmark()

    def dump(path, obj):
        with open(path, "w") as f:
            json.dump(obj, f)

    dump(os.path.join(base, "configs", "h4_631g.json"), H4_631G)
    vqe = manifest.traffic("vqe8")
    cas = dict(manifest.traffic("casscf28"), active_spin_orbitals=8)
    for t in (vqe, cas):
        t["trace_requests"] = 0
    dump(os.path.join(base, "traffic", "vqe8.json"), vqe)
    dump(os.path.join(base, "traffic", "casscf8.json"), cas)
    workloads = []
    for name, (mix, real_cell) in CELLS.items():
        workloads.append({"name": name, "config": "h4_631g",
                          "traffic": mix, "chips": 1, "why": "test"})
        dump(os.path.join(base, "limits", name + ".json"),
             manifest.limits(real_cell))
    bench = dict(real, workloads=workloads,
                 configs=[{"name": "h4_631g", "source": "test",
                           "file": "portbench/configs/h4_631g.json",
                           "reduced": [], "why": "test"}])
    for group in ("end_to_end", "per_layer"):
        bench[group] = [dict(m, workloads=list(CELLS)) if "workloads" in m
                        else m for m in real[group]]
    dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root, base
