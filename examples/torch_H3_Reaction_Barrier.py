"""The PyTorch port's twin of H3_Reaction_Barrier.py: the H + H2
exchange reaction's transition state, barrier and TST rate.

    python examples/torch_H3_Reaction_Barrier.py                # the card
    python examples/torch_H3_Reaction_Barrier.py --device cpu   # the host

Locates the first-order saddle point with Newton steps on FD gradients
and Hessians over FCI-quality energies (exact-CASSCF solves on the
device), certifies it (exactly one imaginary mode), computes the
classical and ZPE-corrected barriers against the relaxed H2 + H
asymptote, and evaluates the Eyring transition-state-theory rate.
"""

import argparse

import numpy as np

from esoo_torch.chem import (casscf_energy_fn, eyring_rate,
                             harmonic_frequencies, optimize_geometry,
                             optimize_transition_state, thermochemistry)
from esoo_torch.utils import resolve_device

KCAL = 627.5094740631


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    e_doublet = casscf_energy_fn(basis="sto-3g", spin=1, device=device)
    e_singlet = casscf_energy_fn(basis="sto-3g", device=device)

    print("searching the H-H-H saddle point (Newton on FD Hessians):")
    ts = optimize_transition_state("H 0 0 0; H 0 0 0.90; H 0 0 1.85",
                                   e_doublet)
    assert ts["converged"] and ts["n_negative"] == 1
    c = ts["coords"]
    r = np.linalg.norm(c[1] - c[0]) / 1.8897259886
    print(f"  TS: symmetric linear, r(H-H) = {r:.4f} A, "
          f"E = {ts['energy']:.6f} Ha, {ts['n_negative']} negative mode")

    # reactant asymptote: relaxed H2 + free H atom
    h2 = optimize_geometry("H 0 0 0; H 0 0 0.735", e_singlet)
    e_h = e_doublet("H 0 0 0")
    barrier = ts["energy"] - (h2["energy"] + e_h)
    print(f"\nclassical barrier: {barrier * KCAL:.2f} kcal/mol "
          f"(exact surface: 9.6 — the minimal basis overbinds H2)")

    print("\nvibrational analysis at the saddle (ships with the TS "
          "result — no second Hessian pass):")
    fr_ts = ts["frequencies"]
    vib = fr_ts["frequencies_cm1"][fr_ts["vib_mask"]]
    for nu in sorted(vib):
        tag = "imaginary (reaction coordinate)" if nu < 0 else ""
        print(f"  {nu:9.1f} cm^-1  {tag}")

    fr_h2 = harmonic_frequencies(h2["atom"], e_singlet)
    t_ts = thermochemistry(ts["atom"], fr_ts, symmetry_number=2,
                           multiplicity=2, pressure=1e5,
                           electronic_energy=ts["energy"])
    t_h2 = thermochemistry(h2["atom"], fr_h2, symmetry_number=2,
                           pressure=1e5, electronic_energy=h2["energy"])
    t_h = thermochemistry("H 0 0 0", multiplicity=2, pressure=1e5,
                          electronic_energy=e_h)
    assert t_ts["n_imaginary"] == 1      # excluded from the TS sums

    zpe_corr = barrier + t_ts["zpe"] - t_h2["zpe"]
    print(f"\nZPE-corrected barrier: {zpe_corr * KCAL:.2f} kcal/mol")

    dg = (t_ts["gibbs_free_energy"]
          - t_h2["gibbs_free_energy"] - t_h["gibbs_free_energy"])
    rates = []
    for T in (298.15, 500.0, 1000.0):
        t_ts_T = thermochemistry(ts["atom"], fr_ts, symmetry_number=2,
                                 multiplicity=2, temperature=T,
                                 pressure=1e5,
                                 electronic_energy=ts["energy"])
        t_h2_T = thermochemistry(h2["atom"], fr_h2, symmetry_number=2,
                                 temperature=T, pressure=1e5,
                                 electronic_energy=h2["energy"])
        t_h_T = thermochemistry("H 0 0 0", multiplicity=2,
                                temperature=T, pressure=1e5,
                                electronic_energy=e_h)
        dgT = (t_ts_T["gibbs_free_energy"]
               - t_h2_T["gibbs_free_energy"]
               - t_h_T["gibbs_free_energy"])
        k = eyring_rate(dgT, T)
        rates.append((float(dgT), float(k)))
        print(f"  T = {T:7.2f} K: dG‡ = {dgT * KCAL:6.2f} kcal/mol, "
              f"k_TST = {k:.3e} (1 bar standard state)")

    assert zpe_corr < barrier            # ZPE lowers the barrier here
    assert dg > 0
    return {"r_ts": float(r), "ts_energy": float(ts["energy"]),
            "barrier": float(barrier), "zpe_corrected": float(zpe_corr),
            "modes": [float(nu) for nu in sorted(vib)], "dg": float(dg),
            "rates": rates}


if __name__ == "__main__":
    main()
