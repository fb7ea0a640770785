"""Determinant enumeration for the particle-number sector (host NumPy).

Copy of the part of esoo_tpu/initializations/ci.py the sector simulator
needs (`hf_determinant`, `enumerate_determinants`).  Spin-orbital bit
ordering is block: alpha 0..n-1, beta n..2n-1 (Jordan-Wigner, the
occupation-basis reading every sector path relies on).
"""

from __future__ import annotations

import itertools
from typing import List, Tuple


def hf_determinant(num_spin_orbitals: int,
                   num_particles: Tuple[int, int]) -> int:
    """HF occupation bitmask (single source of truth: sim.ansatz)."""
    from ..sim.ansatz import hartree_fock_bitmask
    return hartree_fock_bitmask(num_spin_orbitals // 2, num_particles)


def enumerate_determinants(num_spin_orbitals: int,
                           num_particles: Tuple[int, int],
                           max_excitation: int) -> List[int]:
    """HF determinant plus all spin-conserving excitations up to the
    order, sorted."""
    n = num_spin_orbitals // 2
    na, nb = num_particles
    occ_a = list(range(na))
    vir_a = list(range(na, n))
    occ_b = [n + p for p in range(nb)]
    vir_b = [n + p for p in range(nb, n)]
    hf = hf_determinant(num_spin_orbitals, num_particles)

    dets = {hf}
    # excitation of ka alpha electrons and kb beta electrons, ka+kb <= order
    for ka in range(0, max_excitation + 1):
        for kb in range(0, max_excitation + 1 - ka):
            if ka == 0 and kb == 0:
                continue
            if ka > min(len(occ_a), len(vir_a)):
                continue
            if kb > min(len(occ_b), len(vir_b)):
                continue
            for oa in itertools.combinations(occ_a, ka):
                for va in itertools.combinations(vir_a, ka):
                    for ob in itertools.combinations(occ_b, kb):
                        for vb in itertools.combinations(vir_b, kb):
                            d = hf
                            for i in oa + ob:
                                d &= ~(1 << i)
                            for a in va + vb:
                                d |= 1 << a
                            dets.add(d)
    return sorted(dets)
