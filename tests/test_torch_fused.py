"""esoo_torch.FusedOptOrbVQE end to end against esoo_tpu.FusedOptOrbVQE
(H2 6-31G -> 4 spin orbitals, float64, CPU), the port's chemistry against
the JAX package's, the options the slice keeps or refuses, and the rule
that the port never loads JAX or esoo_tpu."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from esoo_tpu.orbital_optimization import FusedOptOrbVQE as JaxFused
from esoo_tpu.orbital_optimization.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
from esoo_torch.chem import MoleculeDriver
from esoo_torch.convert import tensors_from_numpy
from esoo_torch.utils import resolve_device
from esoo_torch.parallel import make_orbital_state_mesh
from test_torch_engine import same_eri_engine  # noqa: F401

REFERENCE = -1.8661038079694765     # tests/test_optorb_e2e.py (decimal 3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ansatz():
    return UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1)))


def _port(problem, **kw):
    kw.setdefault("device", "cpu")
    return FusedOptOrbVQE(4, _ansatz(), problem=problem, maxiter=20,
                          stopping_tolerance=1e-5, **kw)


@pytest.fixture(scope="module")
def jax_solver(h2_631g):
    ansatz = JUCCSD(2, (1, 1), initial_state=JHF(2, (1, 1)))
    return JaxFused(num_spin_orbitals=4, ansatz=ansatz, problem=h2_631g,
                    maxiter=20, stopping_tolerance=1e-5)


@pytest.fixture(scope="module")
def jax_result(jax_solver):
    return jax_solver.compute_minimum_energy()


class _Tensors:
    """A problem that hands over spatial tensors as they are."""

    def __init__(self, h, g):
        self._t = (h, g)

    def spatial_integral_tensors(self):
        return self._t


def test_fused_h2_matches_jax(jax_solver, jax_result):
    """The JAX solver's own state (integrals, U0, theta0, all built by
    esoo_tpu.chem), carried over by convert.tensors_from_numpy."""
    h, g, U0, th0 = tensors_from_numpy(
        *(np.asarray(a) for a in (jax_solver._h_sp, jax_solver._g_sp,
                                  jax_solver._U0, jax_solver._theta0)),
        dtype=torch.float64, device="cpu")
    r = _port(_Tensors(h, g), initial_partial_unitary=U0.numpy(),
              initial_point=th0.numpy()).compute_minimum_energy()
    assert abs(r.eigenvalue - jax_result.eigenvalue) <= 1e-8
    assert abs(r.eigenvalue - REFERENCE) <= 5e-4
    assert abs(jax_result.eigenvalue - REFERENCE) <= 5e-4
    assert r.outer_iterations == jax_result.outer_iterations
    np.testing.assert_allclose(r.energy_convergence_list,
                               jax_result.energy_convergence_list,
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(r.optimal_partial_unitary,
                               jax_result.optimal_partial_unitary,
                               rtol=0, atol=1e-6)
    U = r.optimal_partial_unitary
    np.testing.assert_allclose(U.T @ U, np.eye(2), atol=1e-8)
    st = r.stage_stats
    assert st["bb_iterations"] > 0 and st["lbfgs_evaluations"] > 0
    assert st["lbfgs_evaluations"] >= st["lbfgs_iterations"]
    assert 0.0 < st["lbfgs_s"] and 0.0 < st["bb_s"]


def test_fused_diagnostics_match_jax(h2_631g, jax_result):
    r = _port(h2_631g).compute_minimum_energy()
    for k in ("natural_occupations", "one_rdm_spatial",
              "spin_density_spatial"):
        np.testing.assert_allclose(getattr(r, k), getattr(jax_result, k),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert abs(r.spin_squared - jax_result.spin_squared) <= 1e-8
    assert _port(h2_631g, diagnostics=False).compute_minimum_energy(
    ).natural_occupations is None


def test_integral_tensor_entry_and_dispatch_modes_agree(h2_631g):
    """problem= and integral_tensors= entries, dispatch='two' and
    vqe_chunk give the one-dispatch result."""
    ref = _port(h2_631g).compute_minimum_energy().eigenvalue
    h_so, g_so = h2_631g.integral_tensors()
    for kw in (dict(integral_tensors=(h_so, g_so)),
               dict(problem=h2_631g, dispatch="two"),
               dict(problem=h2_631g, dispatch="two", vqe_chunk=3)):
        r = FusedOptOrbVQE(4, _ansatz(), maxiter=20, device="cpu",
                           stopping_tolerance=1e-5,
                           **kw).compute_minimum_energy()
        assert r.eigenvalue == ref


def test_port_chemistry_matches_jax(h2_631g):
    """The port's MoleculeDriver (native ERI) against esoo_tpu.chem."""
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    assert p.num_particles == h2_631g.num_particles
    assert abs(p.nuclear_repulsion_energy
               - h2_631g.nuclear_repulsion_energy) <= 1e-12
    for a, b in zip(p.spatial_integral_tensors(),
                    h2_631g.spatial_integral_tensors()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)
    r = _port(p).compute_minimum_energy()
    assert abs(r.eigenvalue - REFERENCE) <= 5e-4


def test_python_eri_matches_native():
    from esoo_torch.chem.basis import build_shells
    from esoo_torch.chem.integrals import IntegralEngine
    shells, _, coords = build_shells("H 0 0 0; H 0 0 0.9", "cc-pvtz")
    eng = IntegralEngine(shells[:7], np.ones(2), coords)  # s, p, d shells
    native = eng.eri()
    assert eng.eri_engine == "native"
    python = eng.eri(use_native=False)
    assert eng.eri_engine == "python"
    np.testing.assert_allclose(native, python, rtol=0, atol=1e-12)


def test_checkpoints_written_and_jax_checkpoint_resumed(h2_631g, jax_result,
                                                        tmp_path):
    seen = []
    r = _port(h2_631g, checkpoint_dir=str(tmp_path),
              outer_loop_callback=lambda it, e: seen.append((it, e))
              ).compute_minimum_energy()
    assert [it for it, _ in seen] == list(range(1, r.outer_iterations + 1))
    assert len(os.listdir(tmp_path)) == r.outer_iterations
    # a checkpoint written by the JAX package resumes both packages alike
    path = jax_save_checkpoint(
        str(tmp_path / "jax.npz"), iteration=jax_result.outer_iterations,
        partial_unitary=jax_result.optimal_partial_unitary,
        energy_convergence_list=jax_result.energy_convergence_list,
        optimal_point=jax_result.optimal_point)
    resumed = _port(h2_631g, resume_from=path).compute_minimum_energy()
    ref = JaxFused(num_spin_orbitals=4, problem=h2_631g, maxiter=20,
                   ansatz=JUCCSD(2, (1, 1), initial_state=JHF(2, (1, 1))),
                   stopping_tolerance=1e-5, resume_from=path,
                   diagnostics=False).compute_minimum_energy()
    assert resumed.outer_iterations == ref.outer_iterations
    assert abs(resumed.eigenvalue - ref.eigenvalue) <= 1e-8
    assert resumed.eigenvalue <= jax_result.eigenvalue + 1e-10


def test_float32_run_on_carried_tensors(h2_631g):
    h_sp, g_sp = h2_631g.spatial_integral_tensors()
    h, g, U, th = tensors_from_numpy(h_sp, g_sp, np.eye(4)[:, :2],
                                     np.zeros(3), dtype=torch.float32,
                                     device="cpu")
    assert h.dtype == torch.float32 and g.is_contiguous()

    r = _port(_Tensors(h, g), dtype=torch.float32,
              initial_partial_unitary=U.numpy(),
              initial_point=th.numpy()).compute_minimum_energy()
    assert abs(r.eigenvalue - REFERENCE) <= 5e-4


def test_options_outside_the_slice_raise(h2_631g):
    with pytest.raises(TypeError, match="OrbitalMesh"):
        _port(h2_631g, mesh=object())
    with pytest.raises(NotImplementedError, match="state axis"):
        _port(h2_631g,
              mesh=make_orbital_state_mesh(2, 2, devices=["cpu"] * 4))
    # the full-space simulator is ported: simulation='full' is taken
    assert _port(h2_631g, simulation="full").simulation == "full"
    with pytest.raises(TypeError):
        FusedOptOrbVQE(4, object(), problem=h2_631g, device="cpu")
    with pytest.raises(ValueError):
        _port(h2_631g, vqe_chunk=2)
    with pytest.raises(ValueError):
        _port(h2_631g, dispatch="three")
    h, g = h2_631g.integral_tensors()
    g = g.copy()
    g[0, 4, 0, 0] += 0.1   # break the spin-block structure
    with pytest.raises(ValueError):
        FusedOptOrbVQE(4, _ansatz(), integral_tensors=(h, g), device="cpu")


def test_cuda_without_a_card_raises(h2_631g, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        FusedOptOrbVQE(4, _ansatz(), problem=h2_631g)     # default "cuda"


def test_port_imports_neither_jax_nor_esoo_tpu():
    """Import every module of esoo_torch in a fresh interpreter and check
    that neither jax nor esoo_tpu was loaded; the full-space simulator,
    the operator algebra and the class-based solvers are among them."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import esoo_torch, esoo_torch.sim, esoo_torch.ops\n"
        "import esoo_torch.sim.statevector\n"
        "names = [m.name for m in pkgutil.walk_packages(esoo_torch.__path__,"
        " 'esoo_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "want = {'esoo_torch.' + n for n in ('sim.circuit', 'sim.ansatz',"
        " 'sim.statevector', 'sim.rdm', 'sim.estimator', 'ops.pauli',"
        " 'ops.fermion', 'ops.jw', 'ops.mappers', 'ops.hamiltonian',"
        " 'interop', 'utils.debug', 'solvers.optimizers', 'solvers.energy',"
        " 'solvers.vqe', 'solvers.ssvqe', 'solvers.mcvqe', 'solvers.vqd',"
        " 'solvers.adapt_vqe', 'orbital_optimization.stiefel',"
        " 'orbital_optimization.base',"
        " 'orbital_optimization.minimum_eigensolver',"
        " 'orbital_optimization.eigensolver',"
        " 'orbital_optimization.opt_orb_vqe',"
        " 'orbital_optimization.opt_orb_ssvqe',"
        " 'orbital_optimization.opt_orb_mcvqe',"
        " 'orbital_optimization.opt_orb_vqd',"
        " 'orbital_optimization.opt_orb_adapt_vqe', 'parallel.sharded',"
        " 'utils.profiling')}\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith(('jax.', 'jaxlib', 'esoo_tpu')))\n"
        "print(len(names), bad, sorted(want - set(names)))\n"
        "sys.exit(1 if bad or want - set(names) or len(names) < 25"
        " else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
