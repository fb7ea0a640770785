"""The benchmark's inputs: a configuration's molecular integrals, made once
per checkout and cached.

`load(config)` returns the RHF MO integrals of the configuration's
molecule (inputs/molecule.py over the frozen chemistry copies beside it).
The first call in a checkout computes them on the host and writes them to
`portbench/cache/<config>-<key>/` (a fixed directory inside the checkout,
keyed by the configuration's molecule); later calls read the files.  The
program and the reference are both handed these tensors.  Nothing here
imports the program.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np

CACHE_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cache")

# bump when the input maker's arithmetic changes, so old caches are not read
_MAKER_VERSION = 1
_FILES = ("h.npy", "eri.npy", "meta.json")


def cache_dir(config: dict, root: str = None) -> str:
    """The configuration's cache directory (fixed for its molecule) under
    `root` (default CACHE_ROOT)."""
    spec = json.dumps({"molecule": config["molecule"],
                       "maker": _MAKER_VERSION}, sort_keys=True)
    key = hashlib.sha256(spec.encode()).hexdigest()[:12]
    return os.path.join(root or CACHE_ROOT, f"{config['name']}-{key}")


def _make(config: dict, dst: str) -> None:
    from .molecule import rhf_mo_integrals
    mol = config["molecule"]
    out = rhf_mo_integrals(mol["atom"], mol["basis"], mol.get("charge", 0),
                           mol.get("spin", 0))
    parent = os.path.dirname(dst)
    os.makedirs(parent, exist_ok=True)
    # written beside the fixed directory and renamed onto it, so a reader
    # never sees a half-written cache; where another process got there
    # first, its copy stays
    tmp = tempfile.mkdtemp(prefix=os.path.basename(dst) + ".", dir=parent)
    try:
        np.save(os.path.join(tmp, "h.npy"), out["h"])
        np.save(os.path.join(tmp, "eri.npy"), out["eri"])
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({k: out[k] for k in ("nuclear_repulsion",
                                           "num_particles", "rhf_energy",
                                           "eri_engine")}, f)
        os.rename(tmp, dst)
    except OSError:
        if not os.path.isdir(dst):
            raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load(config: dict, root: str = None) -> dict:
    """{"h", "eri" (chemist), "nuclear_repulsion", "num_particles",
    "rhf_energy", "eri_engine", "made": whether this call computed them}."""
    dst = cache_dir(config, root)
    made = not all(os.path.exists(os.path.join(dst, f)) for f in _FILES)
    if made:
        _make(config, dst)
    with open(os.path.join(dst, "meta.json")) as f:
        meta = json.load(f)
    out = {"h": np.load(os.path.join(dst, "h.npy")),
           "eri": np.load(os.path.join(dst, "eri.npy")),
           "nuclear_repulsion": meta["nuclear_repulsion"],
           "num_particles": tuple(meta["num_particles"]),
           "rhf_energy": meta["rhf_energy"],
           "eri_engine": meta["eri_engine"], "made": made}
    m = config["num_spatial_orbitals"]
    if out["h"].shape != (m, m) or out["eri"].shape != (m,) * 4:
        raise ValueError(f"{config['name']}: cached inputs have m = "
                         f"{out['h'].shape[0]}, the configuration {m}")
    if out["num_particles"] != tuple(config["num_particles"]):
        raise ValueError(f"{config['name']}: {out['num_particles']} "
                         f"electrons, the configuration "
                         f"{config['num_particles']}")
    return out
