"""The frozen chemistry copy (portbench/inputs/) against the port's
MoleculeDriver: the same RHF energies and MO integrals, the native engine
built into the fixed directory inside the checkout, and the cache."""

import json
import os

import numpy as np
import pytest

from portbench import inputs
from portbench.inputs import molecule, native
from portbench.harness import manifest

H2 = "H 0 0 0; H 0 0 0.735"
H4 = "H 0 0 0; H 0 0 1.23; H 0 0 2.46; H 0 0 3.69"


@pytest.mark.parametrize("atom,basis", [(H2, "6-31g"), (H4, "cc-pvtz")])
def test_rhf_agrees_with_the_port(atom, basis):
    from esoo_torch.chem import MoleculeDriver
    ours = molecule.rhf_mo_integrals(atom, basis)
    port = MoleculeDriver(atom=atom, basis=basis).run()
    assert ours["eri_engine"] == "native"
    assert ours["rhf_energy"] == pytest.approx(port.scf.energy_total,
                                               abs=1e-10)
    assert ours["nuclear_repulsion"] == pytest.approx(
        port.nuclear_repulsion_energy, abs=1e-12)
    assert ours["num_particles"] == tuple(port.num_particles)
    # the MO tensors up to the columns' signs: h's diagonal and (pp|qq)
    assert np.allclose(np.diag(ours["h"]), np.diag(port.hcore_mo),
                       atol=1e-9)
    assert np.allclose(np.einsum("ppqq->pq", ours["eri"]),
                       np.einsum("ppqq->pq", port.eri_mo), atol=1e-9)


def test_native_engine_builds_inside_the_checkout():
    assert native.native_available()
    so = native._so_path()
    assert os.path.dirname(so) == os.path.join(manifest.PORTBENCH, "build")
    assert os.path.exists(so)


def test_cache_is_made_once_then_read(tmp_path):
    cfg = {"name": "h2_631g", "num_spatial_orbitals": 4,
           "num_particles": [1, 1],
           "molecule": {"atom": H2, "basis": "6-31g"}}
    first = inputs.load(cfg, str(tmp_path))
    second = inputs.load(cfg, str(tmp_path))
    assert first["made"] and not second["made"]
    assert np.array_equal(first["eri"], second["eri"])
    d = inputs.cache_dir(cfg, str(tmp_path))
    assert sorted(os.listdir(d)) == ["eri.npy", "h.npy", "meta.json"]
    with open(os.path.join(d, "meta.json")) as f:
        assert json.load(f)["num_particles"] == [1, 1]
    # a configuration of another molecule has a directory of its own
    other = dict(cfg, molecule={"atom": H2, "basis": "sto-3g"})
    assert inputs.cache_dir(other, str(tmp_path)) != d
    with pytest.raises(ValueError):
        inputs.load(dict(cfg, num_spatial_orbitals=5), str(tmp_path))


def test_the_real_configurations_state_their_molecules():
    for name, dtype in (("h4_ccpvtz", "float32"),
                        ("h8_ccpvtz_f64", "float64")):
        cfg = manifest.config(name)
        assert cfg["molecule"]["basis"] == "cc-pvtz"
        assert cfg["precision"] == {"dtype": dtype, "tf32": False}
    h8 = manifest.config("h8_ccpvtz_f64")["molecule"]["atom"]
    assert h8 == "; ".join(f"H 0 0 {1.23 * i:.2f}" for i in range(8))
