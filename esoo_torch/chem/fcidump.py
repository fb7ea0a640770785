"""FCIDUMP interop — the standard integral-exchange format.

Copy of esoo_tpu/chem/fcidump.py (host NumPy).

Write any `ElectronicStructureProblem` to a Molpro/PySCF-compatible
FCIDUMP file and reconstruct a solvable problem from one.  This is the
ecosystem bridge the reference library delegated to PySCF: integrals computed
by ANY package (PySCF, Molpro, Psi4, Dirac, ...) can be dumped to this
format and fed straight into every OptOrb solver here, and vice versa
— correlated methods elsewhere can consume integrals from the native
McMurchie–Davidson engine.

Format (Knowles & Handy, Comput. Phys. Commun. 54, 75 (1989)):
a `&FCI NORB=.. NELEC=.. MS2=.. &END` namelist header, then lines
`value i j k l` (1-based) with chemist-notation two-electron integrals
(ij|kl) written over the canonical 8-fold-unique index set, one-body
`value i j 0 0`, and the scalar constant `value 0 0 0 0` (nuclear
repulsion + any frozen-core energy).
"""

from __future__ import annotations

import numpy as np


def write_fcidump(problem, path: str, threshold: float = 1e-14) -> None:
    """Dump `problem`'s MO-basis integrals to an FCIDUMP file.

    The scalar constant line absorbs nuclear repulsion AND core_energy,
    so `solver_energy + constant` is the total energy on both sides of
    a round trip.  Orbital symmetry labels are written as 1 (C1 — the
    package computes without point-group symmetry)."""
    n = int(problem.num_spatial_orbitals)
    n_a, n_b = problem.num_particles
    h = np.asarray(problem.hcore_mo, dtype=np.float64)
    eri = np.asarray(problem.eri_mo, dtype=np.float64)
    const = float(problem.nuclear_repulsion_energy) + float(
        getattr(problem, "core_energy", 0.0))

    with open(path, "w") as f:
        f.write(f"&FCI NORB={n},NELEC={n_a + n_b},MS2={n_a - n_b},\n")
        f.write("  ORBSYM=" + "1," * n + "\n")
        f.write("  ISYM=1,\n&END\n")
        # canonical 8-fold-unique (ij|kl): i>=j, k>=l, (i,j)>=(k,l)
        for i in range(n):
            for j in range(i + 1):
                for k in range(i + 1):
                    for l in range(k + 1):
                        if i * (i + 1) // 2 + j < k * (k + 1) // 2 + l:
                            continue
                        v = eri[i, j, k, l]
                        if abs(v) > threshold:
                            f.write(f"{v:23.16E} {i + 1:4d} {j + 1:4d} "
                                    f"{k + 1:4d} {l + 1:4d}\n")
        for i in range(n):
            for j in range(i + 1):
                if abs(h[i, j]) > threshold:
                    f.write(f"{h[i, j]:23.16E} {i + 1:4d} {j + 1:4d} "
                            f"{0:4d} {0:4d}\n")
        f.write(f"{const:23.16E} {0:4d} {0:4d} {0:4d} {0:4d}\n")


def read_fcidump(path: str):
    """Reconstruct an `ElectronicStructureProblem` from an FCIDUMP file.

    The 8-fold permutational symmetry of the chemist integrals is
    expanded to the dense (n, n, n, n) tensor; `hcore_mo`/`eri_mo` feed
    every solver directly (no AO metadata — population/dipole analysis
    needs the original molecule, but energies and RDM diagnostics are
    fully available).  The file's scalar constant is returned as
    `nuclear_repulsion_energy`."""
    from .driver import ElectronicStructureProblem

    header = ""
    body_start = 0
    with open(path) as f:
        lines = f.readlines()
    for idx, ln in enumerate(lines):
        header += " " + ln.strip()
        # Fortran namelists end with '&END' or a '/' — the slash may
        # share the line with the last fields (' ISYM=1 /')
        if "&END" in ln.upper() or ln.rstrip().endswith("/"):
            body_start = idx + 1
            break
    else:
        raise ValueError(f"{path}: no &END (or '/') namelist terminator")

    import re

    def field(name, required=True, default=None):
        m = re.search(rf"{name}\s*=\s*(-?\d+)", header, re.IGNORECASE)
        if m is None:
            if required:
                raise ValueError(f"{path}: header missing {name}")
            return default
        return int(m.group(1))

    n = field("NORB")
    nelec = field("NELEC")
    ms2 = field("MS2", required=False, default=0)
    if (nelec + ms2) % 2:
        raise ValueError(f"{path}: NELEC={nelec} and MS2={ms2} are "
                         f"inconsistent")
    n_a = (nelec + ms2) // 2
    n_b = nelec - n_a

    h = np.zeros((n, n))
    eri = np.zeros((n, n, n, n))
    const = 0.0
    for ln in lines[body_start:]:
        parts = ln.split()
        if not parts:
            continue
        v = float(parts[0].replace("D", "E").replace("d", "e"))
        i, j, k, l = (int(x) for x in parts[1:5])
        if i == 0:
            const = v
        elif j == 0:
            # 'value i 0 0 0' records are ORBITAL ENERGIES (Molpro
            # writes them before the core line); they are not part of
            # the Hamiltonian — treating them as one-body elements
            # would silently corrupt hcore via the j-1 = -1 wraparound
            continue
        elif k == 0:
            h[i - 1, j - 1] = h[j - 1, i - 1] = v
        else:
            i, j, k, l = i - 1, j - 1, k - 1, l - 1
            for a, b, c, d in ((i, j, k, l), (j, i, k, l),
                               (i, j, l, k), (j, i, l, k),
                               (k, l, i, j), (l, k, i, j),
                               (k, l, j, i), (l, k, j, i)):
                eri[a, b, c, d] = v

    return ElectronicStructureProblem(
        num_particles=(n_a, n_b),
        num_spatial_orbitals=n,
        nuclear_repulsion_energy=const,
        hcore_mo=h,
        eri_mo=eri,
        atom=f"FCIDUMP:{path}",
    )
