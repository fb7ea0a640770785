"""The PyTorch port's twin of H2S_FrozenCore_OptOrbVQE.py: H2S STO-3G
with a frozen sulfur core, its 12-spin-orbital valence window reduced
to 10 by the fused solver on the determinant sector.

    python examples/torch_H2S_FrozenCore_OptOrbVQE.py               # card
    python examples/torch_H2S_FrozenCore_OptOrbVQE.py --device cpu  # host

The active-space transform folds the S 1s2s2p core into an effective
one-body operator and a scalar; the RHF total reproduces the literature
H2S STO-3G value, -394.3116 Ha.
"""

import argparse

from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_torch.chem import MoleculeDriver
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver(
        atom="S 0 0 0; H 0 0.9617 0.9269; H 0 -0.9617 0.9269",
        basis="sto-3g").run()
    rhf_total = (problem.scf.energy_electronic
                 + problem.nuclear_repulsion_energy)
    print(f"H2S RHF total: {rhf_total:.6f} Ha")

    active = problem.active_space()        # auto: S -> 5 frozen core orbitals
    print(f"active space: {active.num_particles} electrons in "
          f"{active.num_spatial_orbitals} spatial orbitals, "
          f"E_core = {active.core_energy:.6f} Ha")

    ansatz = UCCSD(5, active.num_particles,
                   initial_state=HartreeFock(5, active.num_particles))
    result = FusedOptOrbVQE(num_spin_orbitals=10, ansatz=ansatz,
                            problem=active, maxiter=8, vqe_maxiter=200,
                            simulation="sector",
                            device=device).compute_minimum_energy()

    total = (result.eigenvalue + active.core_energy
             + problem.nuclear_repulsion_energy)
    print(f"OptOrbVQE active-space energy: {result.eigenvalue:.6f} Ha")
    print(f"H2S total energy (12 -> 10 valence spin orbitals): "
          f"{total:.6f} Ha")
    return {"rhf_total": float(rhf_total),
            "core_energy": float(active.core_energy),
            "eigenvalue": float(result.eigenvalue), "total": float(total)}


if __name__ == "__main__":
    main()
