"""UCC ansatz descriptors for the particle-number-sector simulator.

The port has no circuit objects yet (the full-space simulator is a later
slice).  What the sector simulator reads from a UCC circuit of the JAX
package — its excitation list, its Hartree-Fock occupation and its
encoding — is carried here by two small descriptors:

  * `HartreeFock(n, (na, nb))`  -> `OccupationState` with the HF bitmask;
  * `UCCSD(n, (na, nb), initial_state=...)` -> `UCCAnsatz` with
    `_ucc_excitations`, `_ucc_initial_state`, `num_parameters` and
    `_encoding = 'jw'`, the attributes `sim.sector.SectorUCC` consumes.

`hartree_fock_bitmask` and `generate_excitations` are copies of
esoo_tpu/sim/ansatz.py: the excitation order defines the parameter order.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple


def hartree_fock_bitmask(num_spatial_orbitals: int,
                         num_particles: Tuple[int, int]) -> int:
    """Occupation bitmask: alpha 0..na-1, beta n..n+nb-1 (block ordering)."""
    n = num_spatial_orbitals
    na, nb = num_particles
    mask = 0
    for i in range(na):
        mask |= 1 << i
    for i in range(nb):
        mask |= 1 << (n + i)
    return mask


def generate_excitations(num_spatial_orbitals: int,
                         num_particles: Tuple[int, int],
                         excitations: str = "sd",
                         generalized: bool = False):
    """Spin-conserving excitation list: [(occ_tuple, virt_tuple), ...] in
    spin-orbital indices (alpha block first).  Singles preserve spin;
    doubles preserve total Sz."""
    n = num_spatial_orbitals
    na, nb = num_particles
    occ_a = list(range(na))
    vir_a = list(range(na, n))
    occ_b = [n + i for i in range(nb)]
    vir_b = [n + i for i in range(nb, n)]
    if generalized:
        occ_a = vir_a = list(range(n))
        occ_b = vir_b = [n + i for i in range(n)]

    singles = [
        ((i,), (a,)) for i, a in itertools.product(occ_a, vir_a)
    ] + [
        ((i,), (a,)) for i, a in itertools.product(occ_b, vir_b)
    ]

    occ_all = occ_a + occ_b
    vir_all = vir_a + vir_b

    def spin(so):
        return 0 if so < n else 1

    doubles = []
    for i, j in itertools.combinations(occ_all, 2):
        for a, b in itertools.combinations(vir_all, 2):
            if spin(i) + spin(j) == spin(a) + spin(b):
                doubles.append(((i, j), (a, b)))

    out = []
    if "s" in excitations:
        out += singles
    if "d" in excitations:
        out += doubles
    return out


@dataclasses.dataclass(frozen=True)
class OccupationState:
    """An occupation-basis (X-gates-only) preparation: its bitmask."""
    num_qubits: int
    mask: int
    _encoding: str = "jw"


def HartreeFock(num_spatial_orbitals: int,
                num_particles: Tuple[int, int],
                qubit_mapper=None) -> OccupationState:
    """The Hartree-Fock determinant as an occupation state."""
    _check_mapper(qubit_mapper)
    return OccupationState(
        2 * num_spatial_orbitals,
        hartree_fock_bitmask(num_spatial_orbitals, num_particles))


@dataclasses.dataclass(frozen=True)
class UCCAnsatz:
    """prod_k exp(theta_k (T_k - T_k^+)) over `_ucc_excitations`, applied
    to `_ucc_initial_state`: the data the sector simulator needs."""
    num_qubits: int
    _ucc_excitations: tuple
    _ucc_initial_state: Optional[OccupationState] = None
    _encoding: str = "jw"

    @property
    def num_parameters(self) -> int:
        return len(self._ucc_excitations)


def _check_mapper(qubit_mapper) -> None:
    if qubit_mapper is not None:
        raise NotImplementedError(
            "only the Jordan-Wigner encoding (qubit_mapper=None) is ported; "
            "qubit mappers come with the full-space simulator, not "
            "ported yet")


def UCC(num_spatial_orbitals: int,
        num_particles: Tuple[int, int],
        excitations: str = "sd",
        qubit_mapper=None,
        initial_state: Optional[OccupationState] = None,
        reps: int = 1,
        generalized: bool = False) -> UCCAnsatz:
    """Unitary coupled-cluster ansatz descriptor (parameter k <->
    excitation k of the `reps`-fold repeated list); the signature of
    esoo_tpu.sim.UCC."""
    _check_mapper(qubit_mapper)
    excs = generate_excitations(num_spatial_orbitals, num_particles,
                                excitations, generalized)
    return UCCAnsatz(2 * num_spatial_orbitals, tuple(excs) * reps,
                     initial_state)


def UCCSD(num_spatial_orbitals: int,
          num_particles: Tuple[int, int],
          qubit_mapper=None,
          initial_state: Optional[OccupationState] = None,
          reps: int = 1,
          generalized: bool = False) -> UCCAnsatz:
    """UCC with singles and doubles."""
    return UCC(num_spatial_orbitals, num_particles, "sd", qubit_mapper,
               initial_state, reps, generalized)
