"""The PyTorch port's twin of MP2_ActiveSpace_OptOrbVQE.py: MP2 natural
occupations choose the OptOrb active-space size.

    python examples/torch_MP2_ActiveSpace_OptOrbVQE.py               # card
    python examples/torch_MP2_ActiveSpace_OptOrbVQE.py --device cpu  # host

MP2's unrelaxed natural-occupation spectrum says how many spin orbitals
to keep: occupations well above ~1e-3 mark orbitals that carry
correlation.  LiH/6-31G (22 spin orbitals) is compressed to the
MP2-selected size and OptOrbVQE recovers more correlation there than MP2
in the full space.  Pipek-Mezey localization names the occupied
orbitals (a Li core and a Li-H bond).
"""

import argparse

import numpy as np

from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_torch.chem import MoleculeDriver, localize_orbitals, mp2
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    problem = MoleculeDriver("Li 0 0 0; H 0 0 1.5949",
                             basis="6-31g").run()
    r = mp2(problem)
    occ = r["natural_occupations"]
    print("MP2 natural occupations (first 8):")
    for i, o in enumerate(occ[:8]):
        print(f"  NO {i}: {o:10.6f}")

    # localize the occupied window: LiH's two occupied MOs become a Li
    # core and a Li-H bond
    loc = localize_orbitals(problem, method="pipek")
    print("\nPipek-Mezey localized occupied orbitals "
          "(per-atom populations):")
    for i, row in enumerate(loc["populations"]):
        kind = "Li core" if row[0] > 0.9 else "Li-H bond"
        print(f"  LMO {i}: Li {row[0]:.3f}  H {row[1]:.3f}   ({kind})")
    kinds = sorted(loc["populations"][:, 0])
    assert kinds[0] < 0.9 < kinds[1]     # one bond + one core

    # keep every NO with occupation above the selection threshold
    thresh = 1e-3
    n_keep = int(np.sum(occ > thresh))
    print(f"\nselected active space: {n_keep} spatial orbitals "
          f"({2 * n_keep} spin orbitals) of {problem.num_spatial_orbitals}")

    n_act = n_keep
    parts = problem.num_particles
    ansatz = UCCSD(n_act, parts,
                   initial_state=HartreeFock(n_act, parts))
    res = FusedOptOrbVQE(num_spin_orbitals=2 * n_act, ansatz=ansatz,
                         problem=problem, maxiter=25,
                         device=device).compute_minimum_energy()
    e_hf = r["e_hf"]
    e_opt = res.eigenvalue
    print(f"\nHF energy        : {e_hf:.6f} Ha")
    print(f"MP2 energy       : {e_hf + r['e_corr']:.6f} Ha")
    print(f"OptOrbVQE ({2 * n_act} so): {e_opt:.6f} Ha")
    corr = e_hf - e_opt
    print(f"correlation recovered in the compressed space: "
          f"{corr:.6f} Ha ({corr / -r['e_corr'] * 100:.0f}% of MP2's)")

    assert n_keep < problem.num_spatial_orbitals
    assert e_opt < e_hf + r["e_corr"]    # beats MP2 in a smaller space
    return {"occ": [float(o) for o in occ[:8]],
            "populations": np.asarray(loc["populations"]).tolist(),
            "n_keep": n_keep, "e_hf": float(e_hf),
            "e_mp2": float(e_hf + r["e_corr"]), "e_opt": float(e_opt)}


if __name__ == "__main__":
    main()
