"""The one request generator: a traffic mix's parameters and `--seed` ->
the run's sequence of requests.

A request is one chemist's multi-start job: solve the configuration's
molecule from a start of its own.  Its start is a seeded rotation of the
Hartree-Fock orbitals: the first n columns of exp(kappa), kappa an
antisymmetric m x m matrix whose upper triangle is drawn N(0, scale^2)
from (seed, request index).  The warm-up request draws from a stream of
its own, so the timed requests are the same whether or not a run warms up.
"""

from __future__ import annotations

import numpy as np
from scipy.linalg import expm

_WINDOW, _WARMUP = 0, 1


def _rng(seed: int, stream: int, index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, stream, index]))


def rotated_start(rng: np.random.Generator, m: int, n: int,
                  scale: float) -> np.ndarray:
    """The first n columns of exp(kappa), kappa antisymmetric (m, m)."""
    kappa = np.zeros((m, m))
    iu = np.triu_indices(m, 1)
    kappa[iu] = rng.normal(scale=scale, size=len(iu[0]))
    kappa -= kappa.T
    return np.ascontiguousarray(expm(kappa)[:, :n])


def request(traffic: dict, config: dict, seed: int, index: int,
            warmup: bool = False) -> dict:
    """{"index", "U0" (m, n) float64} of request `index`."""
    m = config["num_spatial_orbitals"]
    n = traffic["active_spin_orbitals"] // 2
    rng = _rng(seed, _WARMUP if warmup else _WINDOW, index)
    return {"index": index, "warmup": warmup,
            "U0": rotated_start(rng, m, n, traffic["start_scale"])}


def requests(traffic: dict, config: dict, seed: int):
    """The endless closed-loop sequence of timed requests."""
    index = 0
    while True:
        yield request(traffic, config, seed, index)
        index += 1
