"""The PyTorch port's twin of H2_Spectroscopy_Thermo.py: the
vibrational-spectroscopy and thermochemistry workflow on H2.

    python examples/torch_H2_Spectroscopy_Thermo.py                # the card
    python examples/torch_H2_Spectroscopy_Thermo.py --device cpu   # the host

Everything downstream of one FCI-quality potential-energy surface (each
point an exact-CASSCF solve on the device): geometry optimization,
harmonic frequencies, IR intensities, Raman activities and ideal-gas
RRHO thermochemistry.  H2's one vibration is exactly IR-dark but
Raman-active (mutual exclusion), and the s-only STO-3G basis makes the
depolarization ratio exactly 1/3.
"""

import argparse

import numpy as np

from esoo_torch.chem import (casscf_dipole_fn, casscf_energy_fn,
                             casscf_polarizability_fn, harmonic_frequencies,
                             ir_intensities, optimize_geometry,
                             raman_activities, thermochemistry)
from esoo_torch.utils import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default) or 'cpu'")
    device = resolve_device(parser.parse_args(argv).device)

    energy = casscf_energy_fn(basis="sto-3g", device=device)  # FCI

    print("optimizing H2 (FCI/STO-3G):")
    res = optimize_geometry("H 0 0 0; H 0 0 0.80", energy)
    assert res["converged"]
    print(f"  E_min = {res['energy']:.8f} Ha at {res['atom']}")

    print("\nharmonic analysis:")
    vib = harmonic_frequencies(res["atom"], energy)
    nu = float(vib["frequencies_cm1"][vib["vib_mask"]].max())
    print(f"  stretch: {nu:.1f} cm^-1")

    print("\nspectroscopy (mutual exclusion in a centrosymmetric "
          "molecule):")
    ir = ir_intensities(res["atom"],
                        casscf_dipole_fn(basis="sto-3g", device=device), vib)
    acts, depol = raman_activities(
        res["atom"], casscf_polarizability_fn(basis="sto-3g", device=device),
        vib)
    k = np.where(vib["vib_mask"])[0][-1]
    print(f"  IR intensity  : {ir[k]:10.4f} km/mol   (exactly dark)")
    print(f"  Raman activity: {acts[k]:10.4f} A^4/amu "
          f"(rho = {depol[k]:.4f})")
    assert ir[k] < 1e-9        # homonuclear: dark to FD noise
    assert acts[k] > 1.0
    assert abs(depol[k] - 1.0 / 3.0) < 1e-6     # s-only basis: exact

    print("\nideal-gas RRHO thermochemistry (298.15 K, 1 bar):")
    t = thermochemistry(res["atom"], vib, symmetry_number=2,
                        pressure=1e5, electronic_energy=res["energy"])
    print(f"  ZPE            = {t['zpe']:.6f} Ha "
          f"({t['zpe'] * 627.5094740631:.2f} kcal/mol)")
    print(f"  S(total)       = {t['entropy_J_mol_K']:.2f} J/(mol K)  "
          f"[JANAF: 130.68]")
    print(f"  H(298)         = {t['enthalpy']:.6f} Ha")
    print(f"  G(298)         = {t['gibbs_free_energy']:.6f} Ha")
    assert t["n_imaginary"] == 0
    assert t["gibbs_free_energy"] < t["enthalpy"]
    # mass + geometry dominate S; the FCI/STO-3G surface lands within
    # a J/(mol K) of the tabulated standard entropy
    assert abs(t["entropy_J_mol_K"] - 130.68) < 1.5
    return {"energy": float(res["energy"]), "nu": nu, "ir": float(ir[k]),
            "raman": float(acts[k]), "depol": float(depol[k]),
            "zpe": float(t["zpe"]), "entropy": float(t["entropy_J_mol_K"]),
            "enthalpy": float(t["enthalpy"]),
            "gibbs": float(t["gibbs_free_energy"])}


if __name__ == "__main__":
    main()
