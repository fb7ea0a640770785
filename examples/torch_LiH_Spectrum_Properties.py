"""The PyTorch port's twin of LiH_Spectrum_Properties.py: the LiH
absorption spectrum and dipole moments from exact SA-CASSCF.

    python examples/torch_LiH_Spectrum_Properties.py                # the card
    python examples/torch_LiH_Spectrum_Properties.py --device cpu   # the host

The chemistry computes the dipole-operator integrals, the state-averaged
exact-CASSCF solver (on the device) returns per-state and transition
1-RDMs, and chem.properties assembles per-state dipole moments,
transition dipoles mu_IJ = -<I|r|J> and length-gauge oscillator
strengths f = (2/3) dE |mu|^2.  The singlet->triplet spin selection rule
comes out exact (f = 0 to machine precision for the S^2 = 2 states).
"""

import argparse

from esoo_torch import FusedOptOrbSACASSCF
from esoo_torch.chem import (AU_TO_DEBYE, MoleculeDriver, dipole_moment,
                             oscillator_strengths, transition_dipoles)
from esoo_torch.utils import resolve_device

HARTREE_TO_EV = 27.211386245988


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver("Li 0 0 0; H 0 0 1.595", basis="sto-3g").run()
    print(f"LiH sto-3g: {problem.num_spatial_orbitals} orbitals, "
          f"{problem.num_particles} electrons")
    hf_dipole = dipole_moment(problem, unit="debye")[2]
    print(f"HF dipole: {hf_dipole:+.3f} D (z)")

    # 4-state state-averaged exact CASSCF in an 8-spin-orbital active space
    solver = FusedOptOrbSACASSCF(num_spin_orbitals=8, k=4,
                                 problem=problem, maxiter=12, device=device)
    res = solver.compute_energies()

    mu = transition_dipoles(problem, res.transition_rdm1_spatial,
                            partial_unitary=res.optimal_partial_unitary)
    f = oscillator_strengths(res.eigenvalues, mu)

    labels = {0.0: "singlet", 0.75: "doublet", 2.0: "triplet"}
    print(f"\n{'state':>5} {'E (Ha)':>12} {'dE (eV)':>8} {'S^2':>5} "
          f"{'mu_z (D)':>9} {'f(0->n)':>9}")
    for i in range(4):
        s2 = float(res.spin_squared[i])
        lab = labels.get(round(s2, 2), f"S^2={s2:.2f}")
        de = (res.eigenvalues[i] - res.eigenvalues[0]) * HARTREE_TO_EV
        print(f"{i:>5} {res.eigenvalues[i]:>12.6f} {de:>8.3f} "
              f"{lab:>8} {mu[i, i, 2] * AU_TO_DEBYE:>+9.3f} "
              f"{f[0, i]:>9.5f}")

    # the spin selection rule is exact: singlet ground state -> Sz=0
    # triplet components carry zero transition dipole
    triplets = [i for i in range(1, 4)
                if abs(float(res.spin_squared[i]) - 2.0) < 1e-6]
    singlets = [i for i in range(1, 4)
                if abs(float(res.spin_squared[i])) < 1e-6]
    assert all(abs(f[0, i]) < 1e-10 for i in triplets)
    assert all(f[0, i] > 0.01 for i in singlets)
    print(f"\nspin-forbidden f(0->{triplets}) = 0 exactly; "
          f"allowed X->A f = {f[0, singlets[0]]:.4f}")
    return {"hf_dipole": float(hf_dipole),
            "eigenvalues": [float(e) for e in res.eigenvalues],
            "spin_squared": [float(s) for s in res.spin_squared],
            "mu_z": [float(mu[i, i, 2]) for i in range(4)],
            "f": [float(f[0, i]) for i in range(4)],
            "triplets": triplets, "singlets": singlets,
            "f_allowed": float(f[0, singlets[0]])}


if __name__ == "__main__":
    main()
