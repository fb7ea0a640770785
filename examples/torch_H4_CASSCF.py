"""The PyTorch port's twin of H4_CASSCF.py: orbital-optimized exact
diagonalization (CASSCF) on an H4 chain, 6-31G -> 8 spin orbitals, and
its state-averaged variant over the three lowest states.

    python examples/torch_H4_CASSCF.py                # the card
    python examples/torch_H4_CASSCF.py --device cpu   # the host

FusedOptOrbCASSCF swaps the variational eigensolver for the exact lowest
sector eigenpair (warm-started Davidson on the string-CI sigma): the
accuracy upper baseline of every OptOrb* solver.  The state-averaged
variant takes the lowest k exact states (block Davidson) with the same
weighted-RDM orbital updates.
"""

import argparse
from time import perf_counter

import numpy as np

from esoo_torch import FusedOptOrbCASSCF, FusedOptOrbSACASSCF
from esoo_torch.chem import MoleculeDriver
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver(
        atom="H 0 0 0; H 0 0 1.23; H 0 0 2.46; H 0 0 3.69",
        basis="6-31G").run()

    # ground state: 6-31G (16 spin orbitals) optimized down to an
    # 8-spin-orbital active space, exactly diagonalized each iteration
    t0 = perf_counter()
    result = FusedOptOrbCASSCF(num_spin_orbitals=8, problem=problem,
                               maxiter=20,
                               device=device).compute_minimum_energy()
    print(f"FusedOptOrbCASSCF H4 6-31G->8: {result.eigenvalue:.8f} Ha "
          f"(electronic) in {result.outer_iterations} outer iterations, "
          f"{perf_counter() - t0:.1f}s")
    # natural-orbital occupation numbers and the total-spin expectation
    # (0 = pure singlet)
    print("natural occupations:", result.natural_occupations)
    print(f"<S^2> = {result.spin_squared:.6f}")

    # state-averaged: the three lowest exact states steer the orbitals
    t0 = perf_counter()
    sa = FusedOptOrbSACASSCF(num_spin_orbitals=8, k=3, problem=problem,
                             maxiter=20, device=device).compute_energies()
    es = np.asarray(sa.eigenvalues)
    print(f"FusedOptOrbSACASSCF k=3: {es[0]:.6f} / {es[1]:.6f} / "
          f"{es[2]:.6f} Ha in {sa.outer_iterations} outer iterations, "
          f"{perf_counter() - t0:.1f}s")
    total = result.eigenvalue + problem.nuclear_repulsion_energy
    print("total electronic + nuclear repulsion:", f"{total:.8f} Ha")
    return {"eigenvalue": float(result.eigenvalue),
            "outer_iterations": result.outer_iterations,
            "natural_occupations": [float(o) for o in
                                    result.natural_occupations],
            "spin_squared": float(result.spin_squared),
            "sa_eigenvalues": [float(e) for e in es],
            "sa_outer_iterations": sa.outer_iterations,
            "total": float(total)}


if __name__ == "__main__":
    main()
