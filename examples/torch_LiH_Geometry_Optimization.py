"""The PyTorch port's twin of LiH_Geometry_Optimization.py: geometry
optimization and equilibrium properties of LiH.

    python examples/torch_LiH_Geometry_Optimization.py               # card
    python examples/torch_LiH_Geometry_Optimization.py --device cpu  # host

BFGS over the nuclear coordinates with finite-difference gradients of
fully re-converged exact-CASSCF total energies (each solve on the
device), then the dipole moment and Mulliken charges at the optimized
geometry from the CASSCF 1-RDM.
"""

import argparse

import numpy as np

from esoo_torch import FusedOptOrbCASSCF
from esoo_torch.chem import (MoleculeDriver, casscf_energy_fn, dipole_moment,
                             optimize_geometry, populations)
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    # full space = FCI quality
    energy = casscf_energy_fn(basis="sto-3g", device=device)

    print("optimizing LiH from a stretched 1.8 A start (FCI/STO-3G):")
    res = optimize_geometry(
        "Li 0 0 0; H 0 0 1.8", energy,
        callback=lambda atom, e, g: print(
            f"  E = {e:+.8f} Ha   max|dE/dR| = {np.abs(g).max():.2e}"))

    r_bohr = np.linalg.norm(res["coords"][1] - res["coords"][0])
    print(f"\nconverged: {res['converged']} in {res['n_iterations']} "
          f"iterations ({res['n_evaluations']} energy evaluations)")
    print(f"equilibrium bond length: {r_bohr:.4f} bohr "
          f"= {r_bohr * 0.52917721092:.4f} A")
    print(f"total energy: {res['energy']:.8f} Ha")

    # properties at the optimized geometry from the CASSCF 1-RDM
    problem = MoleculeDriver(res["atom"], basis="sto-3g").run()
    r = FusedOptOrbCASSCF(num_spin_orbitals=2 * problem.num_spatial_orbitals,
                          problem=problem, maxiter=30,
                          device=device).compute_minimum_energy()
    mu = dipole_moment(problem, gamma_spatial=r.one_rdm_spatial,
                       partial_unitary=r.optimal_partial_unitary,
                       unit="debye")
    _, q = populations(problem, gamma_spatial=r.one_rdm_spatial,
                       partial_unitary=r.optimal_partial_unitary)
    print(f"dipole at equilibrium: {mu[2]:+.3f} D (z)")
    print(f"Mulliken charges: Li {q[0]:+.3f}, H {q[1]:+.3f}")

    assert res["converged"] and 1.30 < r_bohr < 1.75 * 2
    assert np.abs(res["gradient"]).max() < 3e-4
    return {"r_bohr": float(r_bohr), "energy": float(res["energy"]),
            "n_iterations": res["n_iterations"], "mu_z": float(mu[2]),
            "charges": [float(q[0]), float(q[1])]}


if __name__ == "__main__":
    main()
