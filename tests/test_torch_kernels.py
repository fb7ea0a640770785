"""esoo_torch orbital kernels, GEMM wrappers and Stiefel descent against
esoo_tpu on the same inputs (numpy, seeded), float64 on the CPU.

Tolerances: 1e-12 of max(1, max|ref|) for single evaluations (the two
packages sum in different orders), 1e-10 for the 50-step BB trajectory;
the GEMM plain paths against the Pallas kernel body (interpret mode) at
float32 use the JAX package's own 5e-6 * max(1, max|ref|)."""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.ops.pallas_kernels import matmul_pallas, rotate_two_body_pallas
from esoo_tpu.orbital_optimization import kernels as JK
from esoo_tpu.orbital_optimization.fused import _inner_bb as jax_inner_bb
from esoo_tpu.orbital_optimization.stiefel import (
    _bb_projected_descent as jax_bb, orth as jax_orth)
from esoo_torch.ops import _build, gemm, launch_counts, reset_launch_counts
from esoo_torch.orbital_optimization import kernels as TK
from esoo_torch.orbital_optimization.fused import (
    _ORBITAL_VAG as TORCH_VAG, _inner_bb as torch_inner_bb)
from esoo_torch.orbital_optimization.stiefel import (
    _bb_projected_descent as torch_bb, orth as torch_orth)

jax.config.update("jax_enable_x64", True)


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float64))


def assert_close(out, ref, rtol=1e-12):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=rtol * scale)


def _random_problem(m=7, n=3, seed=0):
    """Spatial (h, g) with the real-orbital symmetries, a partial unitary
    u and spin-summed RDM-shaped (gamma_s, Gamma_s)."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(m, m))
    h = (h + h.T) / 2
    g = rng.normal(size=(m,) * 4)
    g = g + g.transpose(1, 0, 3, 2)
    g = g + g.transpose(2, 3, 0, 1)
    u = np.linalg.qr(rng.normal(size=(m, n)))[0]
    gam = rng.normal(size=(n, n))
    gam = (gam + gam.T) / 2
    Gam = rng.normal(size=(n,) * 4)
    Gam = Gam + Gam.transpose(1, 0, 3, 2)
    return h, g, u, gam, Gam


@pytest.mark.parametrize("name", ["rotate_two_body", "rotate_two_body_kron",
                                  "rotate_two_body_minor",
                                  "rotate_two_body_auto"])
@pytest.mark.parametrize("m,n", [(7, 3), (4, 3)])
def test_two_body_transforms_match_jax(name, m, n):
    _, g, u, _, _ = _random_problem(m, n, seed=m + n)
    ref = getattr(JK, name)(jnp.asarray(g), jnp.asarray(u))
    assert_close(getattr(TK, name)(_t(g), _t(u)), ref)


def test_one_body_and_spin_helpers_match_jax():
    h, g, u, _, _ = _random_problem(seed=1)
    assert_close(TK.rotate_one_body(_t(h), _t(u)),
                 JK.rotate_one_body(jnp.asarray(h), jnp.asarray(u)))
    assert_close(TK.expand_spin(_t(u)), JK.expand_spin(jnp.asarray(u)))
    h_so, g_so = TK.expand_spin_tensors(_t(h), _t(g))
    hj, gj = JK.expand_spin_tensors(jnp.asarray(h), jnp.asarray(g))
    assert_close(h_so, hj)
    assert_close(g_so, gj)
    assert TK.spin_blocks_consistent(h_so.numpy(), g_so.numpy())
    for a, b in zip(TK.spatial_blocks(h_so.numpy(), g_so.numpy()),
                    JK.spatial_blocks(np.asarray(hj), np.asarray(gj))):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TK.rotated_integrals_spatial(_t(u), _t(h), _t(g)),
                    JK.rotated_integrals_spatial(jnp.asarray(u),
                                                 jnp.asarray(h),
                                                 jnp.asarray(g))):
        assert_close(a, b)


def test_rdm_reductions_match_jax():
    rng = np.random.default_rng(2)
    N = 6
    gamma = rng.normal(size=(N, N))
    Gamma = rng.normal(size=(N,) * 4)
    for a, b in zip(TK.spin_reduce_rdms(_t(gamma), _t(Gamma)),
                    JK.spin_reduce_rdms(jnp.asarray(gamma),
                                        jnp.asarray(Gamma))):
        assert_close(a, b)
    assert_close(TK.spin_squared_from_rdms(_t(gamma), _t(Gamma)),
                 JK.spin_squared_from_rdms(jnp.asarray(gamma),
                                           jnp.asarray(Gamma)))


@pytest.mark.parametrize("m,n", [(7, 3), (4, 3)])
def test_rotated_energy_value_and_grad_match_jax(m, n):
    """value_and_grad of the orbital objective (the BB loop's hot op):
    torch autograd against jax.value_and_grad (fused.py _ORBITAL_VAG)."""
    h, g, u, gam, Gam = _random_problem(m, n, seed=3)
    Ej, Gj = jax.value_and_grad(JK.rotated_energy_spatial)(
        *(jnp.asarray(a) for a in (u, gam, Gam, h, g)))
    Et, Gt = TORCH_VAG(*(_t(a) for a in (u, gam, Gam, h, g)))
    assert_close(Et, Ej)
    assert_close(Gt, Gj)


def test_spin_orbital_and_complex_energies_match_jax():
    h, g, u, gam, Gam = _random_problem(5, 2, seed=4)
    h_so, g_so = JK.expand_spin_tensors(jnp.asarray(h), jnp.asarray(g))
    rng = np.random.default_rng(5)
    gamma = rng.normal(size=(4, 4))
    Gamma = rng.normal(size=(4,) * 4)
    ref = JK.rotated_energy_so(jnp.asarray(u), jnp.asarray(gamma),
                               jnp.asarray(Gamma), h_so, g_so)
    out = TK.rotated_energy_so(_t(u), _t(gamma), _t(Gamma),
                               _t(h_so), _t(g_so))
    assert_close(out, ref)
    cgamma = gamma + 1j * rng.normal(size=gamma.shape)
    cGamma = Gamma + 1j * rng.normal(size=Gamma.shape)
    ref = JK.rotated_energy_so_complex(jnp.asarray(u), jnp.asarray(cgamma),
                                       jnp.asarray(cGamma), h_so, g_so)
    out = TK.rotated_energy_so_complex(_t(u), torch.as_tensor(cgamma),
                                       torch.as_tensor(cGamma), _t(h_so),
                                       _t(g_so))
    assert_close(out, ref)
    cg = gam + 1j * rng.normal(size=gam.shape)
    cG = Gam + 1j * rng.normal(size=Gam.shape)
    ref = JK.rotated_energy_spatial_complex(
        jnp.asarray(u), jnp.asarray(cg), jnp.asarray(cG), jnp.asarray(h),
        jnp.asarray(g))
    out = TK.rotated_energy_spatial_complex(
        _t(u), torch.as_tensor(cg), torch.as_tensor(cG), _t(h), _t(g))
    assert_close(out, ref)


@pytest.mark.parametrize("M,K,N", [(300, 700, 150), (17, 33, 5)])
@pytest.mark.parametrize("trans_x", [False, True])
def test_gemm_plain_matches_pallas_kernel_body(M, K, N, trans_x):
    """gemm.matmul on CPU tensors (its plain twin) against the Pallas
    kernel body run by the Pallas interpreter; trans_x hands the wrapper
    x stored (K, M)."""
    rng = np.random.default_rng(M + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    y = rng.normal(size=(K, N)).astype(np.float32)
    ref = np.asarray(matmul_pallas(jnp.asarray(x), jnp.asarray(y),
                                   interpret=True))
    xt = torch.as_tensor(np.ascontiguousarray(x.T) if trans_x else x)
    out = gemm.matmul(xt, torch.as_tensor(y), trans_x=trans_x)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=5e-6 * max(1.0, np.abs(ref).max()))
    # f64: the Pallas wrapper routes to the library product; 1e-12
    out64 = gemm.matmul(xt.double(), torch.as_tensor(y).double(),
                        trans_x=trans_x)
    assert_close(out64, matmul_pallas(jnp.asarray(x, jnp.float64),
                                      jnp.asarray(y, jnp.float64)))


@pytest.mark.parametrize("m,n", [(7, 3), (6, 4)])
def test_rotate_two_body_cuda_plain_matches_pallas_wrapper(m, n):
    """The K2 wrapper's CPU path against rotate_two_body_pallas (which off
    the TPU runs kernels.rotate_two_body), through the public
    kernels.rotate_two_body dispatch too."""
    _, g, u, _, _ = _random_problem(m, n, seed=6)
    ref = rotate_two_body_pallas(jnp.asarray(g), jnp.asarray(u))
    assert_close(gemm.rotate_two_body_cuda(_t(g), _t(u)), ref)
    assert_close(TK.rotate_two_body(_t(g), _t(u)), ref)


def test_plain_paths_count_no_launches():
    reset_launch_counts()
    _, g, u, _, _ = _random_problem(seed=7)
    gemm.rotate_two_body_cuda(_t(g), _t(u))
    gemm.matmul(_t(u).T.contiguous(), _t(u))
    assert launch_counts() == {}


def test_launch_seam_calls_checks_and_counts(monkeypatch):
    """ops/_build.py's launch through a Python stand-in for a C entry
    (the device guard and the stream lookup patched): a tensor goes as its
    data pointer, None as NULL, the stream last; each call adds the
    entry's declared launches under <source>.<kernel>[.<route>]; a
    non-zero return raises RuntimeError naming the source and the entry
    and counts nothing."""
    calls, rc = [], [0]

    def entry(*args):
        calls.append(args)
        return rc[0]

    name, symbol = "probe", "esoo_probe_step_f64"
    argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    monkeypatch.setitem(_build._ENTRIES, (name, symbol), (argtypes, 3))
    monkeypatch.setattr(_build, "load",
                        lambda n: types.SimpleNamespace(**{symbol: entry}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=77))
    _build._entry.cache_clear()
    x = torch.arange(4.0)
    reset_launch_counts()
    try:
        _build.launch(name, symbol, x.device, x, None, 5)
        assert calls == [(x.data_ptr(), None, 5, 77)]
        assert entry.restype is ctypes.c_int
        assert entry.argtypes == argtypes + [ctypes.c_void_p]
        assert launch_counts() == {"probe.probe_step": 3}
        _build.launch(name, symbol, x.device, x, None, 5, route="smem")
        counts = launch_counts()
        assert counts == {"probe.probe_step": 3, "probe.probe_step.smem": 3}
        counts.clear()                                   # a copy
        rc[0] = 700
        with pytest.raises(RuntimeError, match=r"csrc/probe\.cu: "
                           r"esoo_probe_step_f64 failed: CUDA error 700"):
            _build.launch(name, symbol, x.device, x, None, 5)
        assert launch_counts() == {"probe.probe_step": 3,
                                   "probe.probe_step.smem": 3}
        reset_launch_counts()
        assert launch_counts() == {}
    finally:
        _build._entry.cache_clear()


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises:
    'meta' tensors (no storage) must raise, not run the plain twin."""
    x = torch.empty(4, 3, device="meta")
    y = torch.empty(3, 2, device="meta")
    with pytest.raises(ValueError):
        gemm.matmul(x, y)
    with pytest.raises(ValueError):
        gemm.matmul(torch.zeros(4, 3), y)
    with pytest.raises(ValueError):
        gemm.rotate_two_body_cuda(torch.empty(3, 3, 3, 3, device="meta"),
                                  torch.empty(3, 2, device="meta"))


def test_orth_matches_jax():
    rng = np.random.default_rng(8)
    V = rng.normal(size=(9, 3))
    assert_close(torch_orth(_t(V)), jax_orth(jnp.asarray(V)))


def test_inner_bb_50_step_trajectory_matches_jax():
    """fused._inner_bb for exactly 50 BB steps (a 1e-300 tolerance never
    stops it): same alternating steps, same iterate to 1e-10."""
    h, g, u, gam, Gam = _random_problem(6, 2, seed=9)
    u0 = u + 0.05 * np.random.default_rng(10).normal(size=u.shape)
    args = (1e-3, 1e-300, 0.8)
    ref = jax_inner_bb(jax.value_and_grad(JK.rotated_energy_spatial),
                       jnp.asarray(u0),
                       tuple(jnp.asarray(a) for a in (gam, Gam, h, g)),
                       *(jnp.asarray(a) for a in args), 50)
    counts = {"bb_iterations": 0, "bb_s": 0.0}
    out = torch_inner_bb(TORCH_VAG, _t(u0),
                         tuple(_t(a) for a in (gam, Gam, h, g)),
                         *(_t(a) for a in args), 50, counts)
    assert counts["bb_iterations"] == 50
    assert_close(out, ref, rtol=1e-10)


def test_bb_projected_descent_matches_jax():
    """stiefel._bb_projected_descent with the EMA stop: same iteration
    count, final S, energy trace and U."""
    h, g, u, gam, Gam = _random_problem(6, 2, seed=11)
    args = (1e-3, 1e-5, 0.8)
    Uj, Ej, kj, Sj, trj = jax_bb(
        jax.value_and_grad(JK.rotated_energy_spatial), 4,
        tuple(jnp.asarray(a) for a in (u, gam, Gam, h, g)),
        *(jnp.asarray(a) for a in args), 500)
    Ut, Et, kt, St, trt = torch_bb(TORCH_VAG, _t(u),
                                   tuple(_t(a) for a in (gam, Gam, h, g)),
                                   *(_t(a) for a in args), 500)
    assert kt == int(kj)
    assert_close(Ut, Uj, rtol=1e-10)
    assert_close(Et, Ej, rtol=1e-10)
    assert_close(St, Sj, rtol=1e-8)
    assert_close(trt, np.asarray(trj)[: int(kj) + 1], rtol=1e-10)
