"""Checkpoint / resume for OptOrb outer loops.

Copy of esoo_tpu/orbital_optimization/checkpoint.py (the .npz format is
shared: the port reads the JAX package's checkpoints and vice versa).
After every outer iteration the resumable state (partial unitary,
warm-start parameters, energy history, iteration counter) is written as
an .npz; `load_checkpoint` restores it and solvers accept `resume_from=`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np


def save_checkpoint(path: str, *, iteration: int,
                    partial_unitary: np.ndarray,
                    energy_convergence_list,
                    optimal_point=None,
                    optimal_points=None,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "iteration": np.asarray(iteration),
        "partial_unitary": np.asarray(partial_unitary),
        "energy_convergence_list": np.asarray(energy_convergence_list,
                                              dtype=np.float64),
    }
    if optimal_point is not None:
        payload["optimal_point"] = np.asarray(optimal_point)
    if optimal_points is not None:
        for i, pt in enumerate(optimal_points):
            payload[f"optimal_point_{i}"] = np.asarray(pt)
        payload["num_points"] = np.asarray(len(optimal_points))
    if extra:
        payload["extra_json"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    np.savez(path, **payload)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        out: Dict[str, Any] = {
            "iteration": int(z["iteration"]),
            "partial_unitary": z["partial_unitary"],
            "energy_convergence_list": list(z["energy_convergence_list"]),
        }
        if "optimal_point" in z:
            out["optimal_point"] = z["optimal_point"]
        if "num_points" in z:
            out["optimal_points"] = [
                z[f"optimal_point_{i}"] for i in range(int(z["num_points"]))
            ]
        if "extra_json" in z:
            out["extra"] = json.loads(z["extra_json"].tobytes().decode())
    return out
