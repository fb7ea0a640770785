"""N2 through the port past hydrogen, float64 on the CPU: the JAX
package's heavier-molecule showcase (tests/test_n2_showcase.py: cc-pVDZ,
RHF, two frozen N 1s cores, FusedOptOrbCASSCF from 26 orbitals into a
16-spin-orbital window), the port's own CPU run against esoo_tpu's on the
same problem, and the constants chip_smoke.py's `chem` phase gates on.

Tolerances: the showcase anchors' own (RHF 2e-5, CASSCF 5e-4 of the
total); the port against esoo_tpu 1e-8 in energy."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_torch.chem as TC
import esoo_tpu.chem as JC
from esoo_torch import FusedOptOrbCASSCF
from esoo_torch.ops import gemm
from esoo_tpu.orbital_optimization import FusedOptOrbCASSCF as JCASSCF
from esoo_tpu.orbital_optimization import kernels as JK
from test_torch_transform import H100_BLOCKS, _emulate
from test_torch_engine import same_eri_engine  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


def _drivers(basis):
    """(port, JAX) N2 problems and their automatic active spaces."""
    tp = TC.MoleculeDriver(atom=SMOKE.N2_GEOM, basis=basis).run()
    jp = JC.MoleculeDriver(atom=SMOKE.N2_GEOM, basis=basis).run()
    return tp, jp, tp.active_space(), jp.active_space()


@pytest.mark.parametrize("basis,nso", [("cc-pvdz", 16), ("sto-3g", 12)])
def test_n2_casscf_matches_jax_and_the_showcase(basis, nso):
    """cc-pVDZ 26 -> 16 is the showcase (tests/test_n2_showcase.py:15-44);
    STO-3G 8 -> 12 the same path at minimal width."""
    tp, jp, ta, ja = _drivers(basis)
    total_rhf = tp.scf.energy_electronic + tp.nuclear_repulsion_energy
    assert ta.num_particles == (5, 5)
    if basis == "cc-pvdz":
        np.testing.assert_allclose(total_rhf, SMOKE.N2_DZ_RHF, atol=2e-5)
        assert ta.num_spatial_orbitals == 26
    np.testing.assert_array_equal(ta.eri_mo, ja.eri_mo)
    offset = ta.core_energy + ta.nuclear_repulsion_energy
    r = FusedOptOrbCASSCF(nso, problem=ta, device="cpu",
                          **SMOKE.N2_CASSCF_KW).compute_minimum_energy()
    ref = JCASSCF(num_spin_orbitals=nso, problem=ja,
                  **SMOKE.N2_CASSCF_KW).compute_minimum_energy()
    assert abs(r.eigenvalue - ref.eigenvalue) <= 1e-8
    assert r.outer_iterations == ref.outer_iterations
    assert r.eigenvalue + offset < total_rhf
    if basis == "cc-pvdz":
        np.testing.assert_allclose(r.eigenvalue + offset,
                                   SMOKE.N2_DZ_CASSCF, atol=5e-4)
        occ = np.sort(np.asarray(r.natural_occupations).ravel())[::-1]
        assert occ[0] > 1.98 and occ[4] < 1.97 and occ[5:8].sum() > 0.05
    # the smoke's host checks of the solve: no dipole, 14 electrons
    g, U = r.one_rdm_spatial, r.optimal_partial_unitary
    mu = TC.dipole_moment(ta, g, U)
    assert np.abs(mu).max() < 1e-4
    np.testing.assert_allclose(mu, JC.dipole_moment(ja, g, U), atol=1e-10)
    np.testing.assert_allclose(TC.quadrupole_moment(ta, g, U),
                               JC.quadrupole_moment(ja, g, U), atol=1e-10)
    assert TC.populations(ta, g, U)[0].sum() == pytest.approx(14.0,
                                                               abs=1e-8)


@pytest.mark.parametrize("itemsize", [4, 8])
def test_transform_routes_at_the_n2_shapes(itemsize):
    """cc-pVDZ (26, 8) takes the one-pass kernel (m not a multiple of 4:
    a ragged m*m slab stride, padded to 16 bytes); cc-pVTZ (58, 10) the
    four-launch K1 chain."""
    route, stages = gemm._transform_plan(26, 8, itemsize)
    assert route == "fused" and 2 <= stages <= gemm._MAX_STAGES
    per16 = 16 // itemsize
    stride = -(-26 * 26 // per16) * per16
    assert gemm._transform_smem(26, 8, itemsize, stages) == itemsize * (
        stages * stride + 26 * 8 + 256 * 16 + 8 ** 3)
    assert gemm._transform_plan(58, 10, itemsize) == ("chain", 0)


@pytest.mark.parametrize("blocks", [7, H100_BLOCKS])
def test_one_pass_emulation_at_the_n2_dz_shape(blocks):
    """The one-pass kernel's block decomposition (tests/
    test_torch_transform.py) at (26, 8): 676 slabs over the H100 grid,
    the ranges ending mid-p, against the JAX transform."""
    rng = np.random.default_rng(268)
    g = rng.normal(size=(26,) * 4)
    u = np.linalg.qr(rng.normal(size=(26, 8)))[0]
    out = _emulate(torch.as_tensor(g), torch.as_tensor(u), blocks)
    ref = np.asarray(JK.rotate_two_body(jnp.asarray(g), jnp.asarray(u)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(ref).max()))


@pytest.mark.slow
def test_n2_ccpvtz_matches_the_smoke_constant():
    """chip_smoke.py's casscf_n2_tz path gates the card's float32 energy
    against JAX_N2_TZ_20_F64: the JAX package's float64 FusedOptOrbCASSCF
    at 20 spin orbitals on N2 cc-pVTZ after active_space(), with the
    path's settings.  This test is where the constant comes from."""
    p = JC.MoleculeDriver(atom=SMOKE.N2_GEOM, basis="cc-pvtz").run()
    np.testing.assert_allclose(p.scf.energy_electronic
                               + p.nuclear_repulsion_energy,
                               SMOKE.N2_TZ_RHF, atol=5e-4)
    a = p.active_space()
    assert a.num_particles == (5, 5) and a.num_spatial_orbitals == 58
    r = JCASSCF(num_spin_orbitals=20, problem=a,
                **SMOKE.N2_TZ_KW).compute_minimum_energy()
    assert r.outer_iterations == SMOKE.N2_TZ_KW["maxiter"]
    np.testing.assert_allclose(float(r.eigenvalue), SMOKE.JAX_N2_TZ_20_F64,
                               rtol=0, atol=1e-8)


@pytest.mark.slow
def test_n2_ccpvtz_float32_lands_within_the_smoke_gate():
    """The port's float32 FusedOptOrbCASSCF(20) on the CPU at the
    casscf_n2_tz path's settings meets the path's gate: within N2_TOL of
    JAX_N2_TZ_20_F64 (earlier in the valley the float32 and float64
    trajectories part by more than N2_TOL)."""
    a = TC.MoleculeDriver(atom=SMOKE.N2_GEOM,
                          basis="cc-pvtz").run().active_space()
    r = FusedOptOrbCASSCF(20, problem=a, dtype=torch.float32, device="cpu",
                          **SMOKE.N2_TZ_KW).compute_minimum_energy()
    assert r.outer_iterations == SMOKE.N2_TZ_KW["maxiter"]
    assert r.eigenvalue <= r.energy_convergence_list[0]
    assert abs(r.eigenvalue - SMOKE.JAX_N2_TZ_20_F64) <= SMOKE.N2_TOL
