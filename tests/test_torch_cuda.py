"""esoo_torch's hand-written CUDA kernels against their plain versions on
the card.  CUDA kernels have no interpreter, so these tests need an NVIDIA
GPU and skip without one; run them there with

    pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 and complex64 5e-6 * max(1, max|ref|) (the JAX
package's GEMM test); float64 and complex128 1e-12 * max(1, max|ref|)."""

import ctypes

import numpy as np
import pytest
import torch

from esoo_torch.ops import gemm, launch_counts, reset_launch_counts

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    return torch.device("cuda")


def _close(out, ref):
    single = ref.dtype in (torch.float32, torch.complex64)
    tol = (5e-6 if single else 1e-12) * max(1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol


def _launched(prefix: str) -> int:
    """The counted device launches under the keys that start with prefix
    (ops/_build.py's key scheme)."""
    return sum(v for k, v in launch_counts().items() if k.startswith(prefix))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M,K,N,trans_x", [(300, 700, 150, False),
                                           (300, 700, 150, True),
                                           (17, 33, 5, False),
                                           (17, 33, 5, True),
                                           (175616, 56, 4, True)])
def test_matmul_kernel_matches_plain(card, dtype, M, K, N, trans_x):
    rng = np.random.default_rng(M + K + N)
    x = torch.as_tensor(rng.normal(size=(K, M) if trans_x else (M, K)),
                        device=card).to(dtype)
    y = torch.as_tensor(rng.normal(size=(K, N)), device=card).to(dtype)
    before = _launched("gemm.matmul")
    out = gemm.matmul(x, y, trans_x=trans_x)
    torch.cuda.synchronize()
    assert _launched("gemm.matmul") == before + 1
    _close(out, gemm.matmul_plain(x, y, trans_x=trans_x))


def test_matmul_narrow_kernel_takes_rows_beyond_the_tile_grid(card):
    """trans_x with N <= 16 runs on a 1-D grid: M above the tiled kernel's
    65535 * 64 rows (stage 1 of the transform at m >= 162) must run."""
    M, K, N = 65535 * 64 + 1000, 3, 4
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.normal(size=(K, M)), device=card).float()
    y = torch.as_tensor(rng.normal(size=(K, N)), device=card).float()
    out = gemm.matmul(x, y, trans_x=True)
    torch.cuda.synchronize()
    _close(out, gemm.matmul_plain(x, y, trans_x=True))
    with pytest.raises(ValueError, match="out of range"):
        gemm.matmul(x.T.contiguous(), y)          # the tiled kernel's limit


_NARROW_SHAPES = ([(729, 112, n) for n in (1, 4, 5, 8, 12, 14, 16)]
                  + [(4097, k, 16) for k in (1, 3, 112, 300)]
                  + [(729, 300, 5), (4096, 112, 16), (4098, 7, 14),
                     (1, 5, 3)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M,K,N", _NARROW_SHAPES)
def test_narrow_matmul_kernel_matches_plain(card, dtype, M, K, N):
    """gemm_narrow_ring (trans_x, N <= 16): N from 1 to 16; M ragged
    against a tile (729, 4097) and not a multiple of 4 (element copies);
    K of one ring stage (1, 3), of 7 (112) and of 19 (300: y in two
    chunks at float32 and three at float64, N = 16)."""
    rng = np.random.default_rng(M * 7 + K * 3 + N)
    x = torch.as_tensor(rng.normal(size=(K, M)), device=card).to(dtype)
    y = torch.as_tensor(rng.normal(size=(K, N)), device=card).to(dtype)
    out = gemm.matmul(x, y, trans_x=True)
    torch.cuda.synchronize()
    _close(out, gemm.matmul_plain(x, y, trans_x=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_narrow_matmul_takes_an_unaligned_x(card, dtype):
    """x starting one element past a 16-byte boundary: element copies."""
    M, K, N = 1024, 37, 14
    rng = np.random.default_rng(5)
    buf = torch.as_tensor(rng.normal(size=K * M + 1), device=card).to(dtype)
    x = buf[1:].view(K, M)
    y = torch.as_tensor(rng.normal(size=(K, N)), device=card).to(dtype)
    out = gemm.matmul(x, y, trans_x=True)
    torch.cuda.synchronize()
    _close(out, gemm.matmul_plain(x, y, trans_x=True))


@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_narrow_matmul_at_the_chain_stages(card, stage):
    """The four stages of the transform's chain at (m, n) = (112, 16),
    float32: x (112, rest) with rest = m^3, m^2 n, m n^2, n^3."""
    m, n = 112, 16
    rest = (m ** 3, m * m * n, m * n * n, n ** 3)[stage - 1]
    gen = torch.Generator(device=card).manual_seed(stage)
    x = torch.randn(m, rest, dtype=torch.float32, device=card, generator=gen)
    u = torch.randn(m, n, dtype=torch.float32, device=card, generator=gen)
    out = gemm.matmul(x, u, trans_x=True)
    torch.cuda.synchronize()
    _close(out, gemm.matmul_plain(x, u, trans_x=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("M,K,N", [(112 ** 3, 112, 16), (4097, 300, 14)])
def test_narrow_matmul_repeats_bit_for_bit(card, dtype, M, K, N):
    gen = torch.Generator(device=card).manual_seed(M + N)
    x = torch.randn(K, M, dtype=dtype, device=card, generator=gen)
    y = torch.randn(K, N, dtype=dtype, device=card, generator=gen)
    first = gemm.matmul(x, y, trans_x=True)
    second = gemm.matmul(x, y, trans_x=True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("M,K,N,itemsize", [(112 ** 3, 112, 16, 4),
                                            (112 * 16 * 16, 112, 14, 4),
                                            (4096, 112, 16, 4),
                                            (17, 33, 5, 8), (4097, 300, 16, 8),
                                            (65535 * 64 + 1000, 3, 4, 4)])
def test_narrow_plan_matches_the_kernel(card, M, K, N, itemsize):
    """ops/gemm.py::_narrow_plan (which the CPU tests hold to the limits
    and emulate) equals the built kernel's own launch plan on this card
    (csrc/gemm.cu esoo_matmul_narrow_plan)."""
    plan = (ctypes.c_int * 11)()
    assert gemm._lib().esoo_matmul_narrow_plan(M, K, N, itemsize, plan) == 0
    keys = ("nb", "rows", "stage_k", "ring", "y_rows", "smem", "sms",
            "per_sm", "blocks", "stages", "vec")
    got = dict(zip(keys, plan), groups=-(-M // plan[1]))
    assert got == gemm._narrow_plan(M, K, N, itemsize, got["sms"],
                                    got["per_sm"])
    assert got["per_sm"] >= 1


def _transform_inputs(m, n, dtype, card):
    rng = np.random.default_rng(m * n)
    g = torch.as_tensor(rng.normal(size=(m,) * 4), device=card).to(dtype)
    u = torch.as_tensor(np.linalg.qr(rng.normal(size=(m, n)))[0],
                        device=card).to(dtype)
    return g, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n", [(56, 4), (24, 8), (9, 3), (4, 2), (70, 4),
                                 (130, 2)])
def test_rotate_two_body_kernel_matches_plain(card, dtype, m, n):
    """The one-pass kernel (csrc/transform.cu): the headline shape (the
    float32 fast path), n = 8, odd m (element-wise copies), more blocks
    than slabs, and 128 and 256 slab columns (float64 at m = 130 takes the
    chain: two of its slabs do not fit a block)."""
    g, u = _transform_inputs(m, n, dtype, card)
    out = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    _close(out, gemm.rotate_two_body_plain(g, u))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rotate_two_body_chain_route_matches_plain(card, dtype):
    g, u = _transform_inputs(24, 12, dtype, card)
    out = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    _close(out, gemm.rotate_two_body_plain(g, u))
    _close(gemm.rotate_two_body_chain(g, u), gemm.rotate_two_body_plain(g, u))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rotate_two_body_repeats_bit_for_bit(card, dtype):
    g, u = _transform_inputs(56, 4, dtype, card)
    first = gemm.rotate_two_body_cuda(g, u)
    second = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("m,n,route,launches", [(24, 4, "fused", 2),
                                                (24, 12, "chain", 4)])
def test_rotate_two_body_launch_counts_per_route(card, m, n, route,
                                                 launches):
    g, u = _transform_inputs(m, n, torch.float32, card)
    reset_launch_counts()
    gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    kernel = "transform.transform" if route == "fused" else "gemm.matmul"
    assert launch_counts() == {kernel: launches}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,route", [(26, 8, "fused"), (58, 10, "chain")])
def test_rotate_two_body_at_the_n2_shapes(card, dtype, m, n, route):
    """The N2 paths' transforms: cc-pVDZ (26, 8) on the one-pass kernel
    (m not a multiple of 4: the ragged m*m slab stride and the slab ring's
    tail), cc-pVTZ (58, 10) on the K1 chain, whose stage 1 has M = 58^3."""
    g, u = _transform_inputs(m, n, dtype, card)
    assert gemm._transform_plan(m, n, g.element_size())[0] == route
    reset_launch_counts()
    out = gemm.rotate_two_body_cuda(g, u)
    again = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    per = 2 if route == "fused" else 4
    kernel = "transform.transform" if route == "fused" else "gemm.matmul"
    assert launch_counts() == {kernel: 2 * per}
    _close(out, gemm.rotate_two_body_plain(g, u))
    assert torch.equal(out, again)
    if route == "chain":
        x = g.reshape(m, m ** 3)
        _close(gemm.matmul(x, u, trans_x=True),
               gemm.matmul_plain(x, u, trans_x=True))


def test_casscf_n2_sto3g_on_the_card_matches_the_cpu(card):
    """The ported chemistry past hydrogen on the card: N2 STO-3G, frozen
    core, FusedOptOrbCASSCF(12) at float64, card against CPU."""
    from esoo_torch import FusedOptOrbCASSCF
    from esoo_torch.chem import MoleculeDriver
    p = MoleculeDriver(atom="N 0 0 0; N 0 0 1.0977",
                       basis="sto-3g").run().active_space()
    runs = []
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        runs.append(FusedOptOrbCASSCF(
            12, problem=p, maxiter=12, stopping_tolerance=1e-6,
            device=device, dtype=torch.float64).compute_minimum_energy())
        if device == "cuda":
            assert _launched("transform.transform") > 0
    assert abs(runs[0].eigenvalue - runs[1].eigenvalue) <= 1e-8


def test_rotate_two_body_refuses_a_strided_g(card):
    g, u = _transform_inputs(8, 4, torch.float32, card)
    with pytest.raises(ValueError, match="contiguous"):
        gemm.rotate_two_body_cuda(g.transpose(0, 1), u)


def test_fused_h2_on_the_card_matches_the_cpu(card):
    from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
    from esoo_torch.chem import MoleculeDriver
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    runs = []
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        runs.append(FusedOptOrbVQE(
            4, UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1))),
            problem=p, device=device).compute_minimum_energy().eigenvalue)
        if device == "cuda":
            assert _launched("transform.transform") > 0
    assert abs(runs[0] - runs[1]) <= 1e-8
    assert abs(runs[0] + 1.8661038079694765) <= 5e-4


def test_chain_route_and_k1_at_the_casscf_shape(card):
    """The CASSCF path's transform (m=112, n=14, float32: the chain route,
    n > 8) and its K1 stage 1, (1404928 x 112)^T @ (112 x 14)."""
    m, n = 112, 14
    assert gemm._transform_plan(m, n, 4)[0] == "chain"
    gen = torch.Generator(device=card).manual_seed(0)
    g = torch.randn((m,) * 4, dtype=torch.float32, device=card,
                    generator=gen)
    u = torch.as_tensor(np.linalg.qr(np.random.default_rng(0).normal(
        size=(m, n)))[0], device=card).float()
    reset_launch_counts()
    out = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    assert launch_counts() == {"gemm.matmul": 4}
    _close(out, gemm.rotate_two_body_plain(g, u))
    x = g.reshape(m, m ** 3)
    _close(gemm.matmul(x, u, trans_x=True),
           gemm.matmul_plain(x, u, trans_x=True))


def test_casscf_h2_on_the_card_matches_the_cpu(card):
    from esoo_torch import FusedOptOrbCASSCF
    from esoo_torch.chem import MoleculeDriver
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    runs = []
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        runs.append(FusedOptOrbCASSCF(4, problem=p, maxiter=20, device=device,
                                      dtype=torch.float64
                                      ).compute_minimum_energy().eigenvalue)
        if device == "cuda":
            assert _launched("transform.transform") > 0
    assert abs(runs[0] - runs[1]) <= 1e-8
    assert abs(runs[0] + 1.8661038) <= 1e-4


def test_sector_ci_sigma_and_diagonal_at_n20_float32(card):
    """SectorCI at N=20, (4, 4) (44,100 determinants): float32 on the card
    against float64 on the CPU, within 5e-6 * max(1, max|ref|) (float32
    products over up to ~2e4 terms; the CPU's float32 error is ~2e-7 of
    the scale)."""
    from esoo_torch.sim import SectorCI
    sec = SectorCI(20, (4, 4))
    rng = np.random.default_rng(20)
    N = 20
    h = rng.normal(size=(N, N))
    g0 = rng.normal(size=(N,) * 4)
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    V = rng.normal(size=(sec.nB, sec.nA))
    V /= np.linalg.norm(V)
    out = {}
    for dev, dt in ((card, torch.float32), ("cpu", torch.float64)):
        vals = sec.build_values(torch.as_tensor((h + h.T) / 2).to(dev, dt),
                                torch.as_tensor(g).to(dev, dt))
        out[dt] = (sec.sigma_values(torch.as_tensor(V).to(dev, dt), vals),
                   sec.diagonal_values(vals))
    for got, ref in zip(out[torch.float32], out[torch.float64]):
        err = float((got.double().cpu() - ref).abs().max())
        assert err <= 5e-6 * max(1.0, float(ref.abs().max()))


@pytest.mark.parametrize("N,parts", [(12, (3, 3)), (16, (3, 3))])
def test_compact_kernels_match_dense_on_the_card(card, N, parts):
    """The compact int8 tables' operator-chunked sigma, RDMs and diagonal
    on the card (N=12: q = 36 padded to 64; N=16: q = 64) against the
    dense tables on the card, float32, within 1e-5 * max(1, max|ref|) (the
    two sum the same products in different orders), and against float64
    on the CPU within 5e-6 * max(1, max|ref|)."""
    from esoo_torch.sim import SectorCI
    sec = SectorCI(N, parts)
    rng = np.random.default_rng(N)
    h = rng.normal(size=(N, N))
    g0 = rng.normal(size=(N,) * 4)
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    V = rng.normal(size=(sec.nB, sec.nA))
    V /= np.linalg.norm(V)
    out = {}
    for dev, dt, storage in ((card, torch.float32, "dense"),
                             (card, torch.float32, "compact"),
                             ("cpu", torch.float64, "compact")):
        tabs = sec.device_tables(dt, device=dev, storage=storage)
        vals = sec.build_values(torch.as_tensor((h + h.T) / 2).to(dev, dt),
                                torch.as_tensor(g).to(dev, dt), tabs)
        Vt = torch.as_tensor(V).to(dev, dt)
        out[(dt, storage)] = [sec.sigma_values(Vt, vals, tabs),
                              sec.diagonal_values(vals, tabs),
                              *sec.rdms(Vt, tabs)]
    for got, dense, ref in zip(out[(torch.float32, "compact")],
                               out[(torch.float32, "dense")],
                               out[(torch.float64, "compact")]):
        got, dense = got.double().cpu(), dense.double().cpu()
        assert float((got - dense).abs().max()) <= 1e-5 * max(
            1.0, float(dense.abs().max()))
        assert float((got - ref).abs().max()) <= 5e-6 * max(
            1.0, float(ref.abs().max()))


def test_ssvqe_h2_on_the_card_matches_the_cpu(card):
    from esoo_torch import (FusedOptOrbSSVQE, HartreeFock, OccupationState,
                            UCCSD)
    from esoo_torch.chem import MoleculeDriver
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    runs = []
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        runs.append(FusedOptOrbSSVQE(
            4, UCCSD(2, (1, 1), reps=2),
            initial_states=[HartreeFock(2, (1, 1)),
                            OccupationState(4, 0b0110)],
            weight_vector=[2, 1], problem=p, maxiter=20, dtype=torch.float64,
            device=device).compute_energies().eigenvalues)
        if device == "cuda":
            assert _launched("transform.transform") > 0
    np.testing.assert_allclose(runs[0], runs[1], rtol=0, atol=1e-8)
    np.testing.assert_allclose(runs[0], [-1.85403538, -1.37044354], rtol=0,
                               atol=1.5e-3)


def test_one_pass_transform_at_the_full_space_shape(card):
    """The H8 -> 12 full-space path's transform (m=112, n=6, float32):
    the one-pass kernel with a 4-slab ring, one block an SM."""
    m, n = 112, 6
    assert gemm._transform_plan(m, n, 4) == ("fused", 4)
    gen = torch.Generator(device=card).manual_seed(6)
    g = torch.randn((m,) * 4, dtype=torch.float32, device=card,
                    generator=gen)
    u = torch.as_tensor(np.linalg.qr(np.random.default_rng(6).normal(
        size=(m, n)))[0], device=card).float()
    reset_launch_counts()
    out = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    assert launch_counts() == {"transform.transform": 2}
    _close(out, gemm.rotate_two_body_plain(g, u))


@pytest.mark.parametrize("name", ["real_amplitudes", "efficient_su2",
                                  "uccsd_h8_12"])
def test_full_space_statevector_and_gradient_match_the_cpu(card, name):
    """The statevector and d rdm_energy / d theta of the full-space
    simulator on the card against its CPU run, float64 (1e-12, 1e-10)."""
    import esoo_torch as T
    from esoo_torch.orbital_optimization.kernels import expand_spin_tensors
    from esoo_torch.sim import compile_circuit, rdm_energy
    qc = {"real_amplitudes": lambda: T.RealAmplitudes(4),
          "efficient_su2": lambda: T.EfficientSU2(4),
          "uccsd_h8_12": lambda: T.UCCSD(
              6, (4, 4), initial_state=T.HartreeFock(6, (4, 4)))}[name]()
    rng = np.random.default_rng(12)
    theta = rng.normal(size=qc.num_parameters) * 0.1
    n = qc.num_qubits // 2
    h = rng.normal(size=(n, n))
    h_so, g_so = expand_spin_tensors(torch.as_tensor((h + h.T) / 2),
                                     torch.as_tensor(rng.normal(
                                         size=(n,) * 4) * 0.1))
    out = []
    for dev in (card, torch.device("cpu")):
        t = torch.as_tensor(theta, device=dev).requires_grad_(True)
        state = compile_circuit(qc).state_fn(t)
        rdm_energy(state, h_so.to(dev), g_so.to(dev)).backward()
        out.append((state.detach().cpu(), t.grad.cpu()))
    assert float((out[0][0] - out[1][0]).abs().max()) <= 1e-12
    assert float((out[0][1] - out[1][1]).abs().max()) <= 1e-10


def test_full_space_h2_on_the_card_matches_the_cpu(card):
    from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
    from esoo_torch.chem import MoleculeDriver
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    runs = []
    for device in ("cuda", "cpu"):
        reset_launch_counts()
        solver = FusedOptOrbVQE(
            4, UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1))),
            problem=p, simulation="full", device=device)
        assert solver.simulation == "full"
        runs.append(solver.compute_minimum_energy().eigenvalue)
        if device == "cuda":
            assert _launched("transform.transform") > 0
    assert abs(runs[0] - runs[1]) <= 1e-8
    assert abs(runs[0] + 1.8661038079694765) <= 5e-4


def _class_optorb(kind, problem, device):
    """The reference's H2 6-31G -> 4 class-path drive on `device`."""
    import esoo_torch as T
    dk = {"device": device}
    pupo = T.PartialUnitaryProjectionOptimizer(1e-3, 1e-5, 10000, **dk)
    if kind == "vqe":
        ansatz = T.UCCSD(2, (1, 1), initial_state=T.HartreeFock(2, (1, 1)))
        vqe = T.VQE(T.Estimator(**dk), ansatz, T.L_BFGS_B(),
                    initial_point=np.zeros(ansatz.num_parameters), **dk)
        return T.OptOrbVQE(num_spin_orbitals=4, ground_state_solver=vqe,
                           partial_unitary_optimizer=pupo, problem=problem,
                           maxiter=20, **dk).compute_minimum_energy()
    ansatz = T.UCCSD(2, (1, 1), reps=2)
    init1 = T.QuantumCircuit(4)
    init1.x(1)
    init1.x(2)
    ss = T.SSVQE(k=2, ansatz=ansatz, optimizer=T.L_BFGS_B(),
                 initial_states=[T.HartreeFock(2, (1, 1)), init1],
                 weight_vector=[2, 1],
                 initial_point=np.zeros(ansatz.num_parameters), **dk)
    return T.OptOrbSSVQE(num_spin_orbitals=4, excited_states_solver=ss,
                         partial_unitary_optimizer=pupo, problem=problem,
                         maxiter=20, **dk).compute_energies()


@pytest.mark.parametrize("kind", ["vqe", "ssvqe"])
def test_class_optorb_h2_on_the_card_matches_the_cpu(card, kind):
    """OptOrbVQE / OptOrbSSVQE through the class API: card against CPU
    within 1e-8, the transform's launches all one-pass, two per rotated
    Hamiltonian (`metrics["hamiltonian_time"]` has one entry per
    rebuild)."""
    from esoo_torch.chem import MoleculeDriver
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    reset_launch_counts()
    r_gpu = _class_optorb(kind, p, "cuda")
    matmuls, fused = _launched("gemm.matmul"), _launched("transform.")
    r_cpu = _class_optorb(kind, p, "cpu")
    key = "eigenvalue" if kind == "vqe" else "eigenvalues"
    np.testing.assert_allclose(getattr(r_gpu, key), getattr(r_cpu, key),
                               rtol=0, atol=1e-8)
    assert matmuls == 0
    assert fused == 2 * len(r_gpu.metrics["hamiltonian_time"]) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,m_loc,n", [(112, 28, 14), (56, 14, 4),
                                       (12, 3, 5)])
def test_rotate_two_body_shard_matches_plain(card, dtype, m, m_loc, n):
    """One shard's partial transform (four K1 launches, stage 4 over the
    local axis) against its plain version, and the shards' sum against
    the unsharded transform."""
    rng = np.random.default_rng(m + m_loc + n)
    g = torch.as_tensor(rng.normal(size=(m,) * 4) / m, device=card).to(dtype)
    u = torch.as_tensor(np.linalg.qr(rng.normal(size=(m, n)))[0],
                        device=card).to(dtype)
    reset_launch_counts()
    parts = []
    for d in range(m // m_loc):
        g_loc = g[..., d * m_loc:(d + 1) * m_loc].contiguous()
        u_loc = u[d * m_loc:(d + 1) * m_loc].contiguous()
        out = gemm.rotate_two_body_shard(g_loc, u, u_loc)
        _close(out, gemm.rotate_two_body_shard_plain(g_loc, u, u_loc))
        parts.append(out)
    torch.cuda.synchronize()
    assert launch_counts() == {"gemm.matmul": 4 * (m // m_loc)}
    _close(sum(parts), gemm.rotate_two_body_plain(g, u))


def _pairs_sector(n, parts):
    from esoo_torch import HartreeFock, UCCSD
    from esoo_torch.sim.sector import SectorUCC
    return SectorUCC(UCCSD(n, parts, initial_state=HartreeFock(n, parts)),
                     2 * n, kernel="pairs")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pairs_kernels_on_the_card_match_the_cpu(card, dtype):
    """The pairwise sector kernels on the card (n = 4, (2, 2)): state,
    theta-gradient of the energy, values, energy and RDMs against the
    same code on the CPU at float64."""
    sec = _pairs_sector(4, (2, 2))
    rng = np.random.default_rng(4)
    N = 8
    h = rng.normal(size=(N, N))
    g = rng.normal(size=(N,) * 4)
    h, g = (h + h.T) / 2, g + g.transpose(1, 0, 3, 2)
    th = rng.normal(size=len(sec._excs)) * 0.3
    out = {}
    for dev, dt in ((card, dtype), (torch.device("cpu"), torch.float64)):
        x = torch.as_tensor(th, device=dev).to(dt).requires_grad_(True)
        vals = sec.build_values(torch.as_tensor(h, device=dev).to(dt),
                                torch.as_tensor(g, device=dev).to(dt))
        E = sec.energy_values(x, vals)
        (grad,) = torch.autograd.grad(E, x)
        v = sec.state(x.detach())
        out[dev.type] = [E.detach(), grad, v, *sec.rdms(v)]
    tol = 5e-6 if dtype == torch.float32 else 1e-12
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.device.type == "cuda"
        err = float((a.double().cpu() - b).abs().max())
        assert err <= tol * max(1.0, float(b.abs().max()))


def test_pairs_vqe_on_the_card_matches_the_cpu(card, monkeypatch):
    from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
    from esoo_torch.chem import MoleculeDriver
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "pairs")
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    runs = []
    for device in ("cuda", "cpu"):
        s = FusedOptOrbVQE(4, UCCSD(2, (1, 1),
                                    initial_state=HartreeFock(2, (1, 1))),
                           problem=p, device=device)
        assert s._sector.kernel == "pairs"
        runs.append(s.compute_minimum_energy().eigenvalue)
    assert abs(runs[0] - runs[1]) <= 1e-8


def test_mesh_on_the_card_matches_the_cpu(card):
    """FusedOptOrbCASSCF on H4 6-31G -> 8 over four logical shards on one
    card: the card's run against the CPU's 4-shard run (1e-8), every
    rotation through the shard route."""
    from esoo_torch import FusedOptOrbCASSCF
    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.parallel import make_orbital_mesh
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 1.23; H 0 0 2.46; H 0 0 3.69",
                       basis="6-31g").run()
    runs = []
    for dev in ("cuda", "cpu"):
        reset_launch_counts()
        r = FusedOptOrbCASSCF(8, problem=p, device=dev,
                              mesh=make_orbital_mesh(devices=[dev] * 4)
                              ).compute_minimum_energy()
        runs.append(r.eigenvalue)
        if dev == "cuda":
            assert _launched("gemm.matmul") == 16 * (r.outer_iterations + 1)
            assert _launched("transform.") == 0
    assert abs(runs[0] - runs[1]) <= 1e-8


# -- the string gate scan K3 (csrc/gate_scan.cu) ------------------------------

def _scan_inputs(n, parts, dtype, batch, card, seed=0):
    """A UCCSD(n, parts) sector's device tables, theta (every fifth one
    exactly 0: ADAPT's padded slots), states (batch, nB, nA) and a
    cotangent."""
    from esoo_torch.sim import HartreeFock, UCCSD
    from esoo_torch.sim.sector import SectorUCC
    ts = SectorUCC(UCCSD(n, parts, initial_state=HartreeFock(n, parts)),
                   2 * n)
    rng = np.random.default_rng(seed)
    th = rng.normal(size=len(ts._excs)) * 0.4
    th[::5] = 0.0
    V0 = rng.normal(size=(batch, ts.nB, ts.nA))
    V0 /= np.linalg.norm(V0, axis=(1, 2), keepdims=True)
    ct = rng.normal(size=V0.shape)
    f = lambda a: torch.as_tensor(a, device=card).to(dtype)
    return ts.device_tables(dtype, device=card), f(th), f(V0), f(ct)


def _scan_plain(tabs, th, V0, ct):
    """sim/strings.py::_ApplyRevStr on the card: V, W (the cotangent of
    V0) and dtheta."""
    from esoo_torch.sim import strings
    v, t = V0.clone().requires_grad_(), th.clone().requires_grad_()
    V = strings._ApplyRevStr.apply(v, t, *strings.gate_fields(tabs))
    torch.autograd.backward(V, ct)
    return V.detach(), v.grad, t.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,parts,batch,route", [
    (4, (2, 2), 1, None), (6, (3, 2), 3, None), (8, (4, 4), 1, None),
    (8, (4, 4), 3, None), (6, (3, 2), 3, "global"), (9, (4, 4), 1, None),
    (6, (3, 3), 2, None), (8, (4, 4), 1, "global")])
def test_gate_scan_kernel_matches_plain(card, dtype, n, parts, batch, route):
    """Both directions against _ApplyRevStr: V, W and dtheta, on the route
    of _plan (n = 9, (4, 4): shared memory both ways at float32, the
    global route backward at float64; H4's 26 records all staged at the
    start, H8 -> 16's 360 through a ring of 32) or forced onto the global
    route."""
    from esoo_torch.ops import gate_scan
    tabs, th, V0, ct = _scan_inputs(n, parts, dtype, batch, card)
    c, s = torch.cos(th), torch.sin(th)
    reset_launch_counts()
    V = gate_scan._forward(V0, c, s, tabs, route)
    W, dth = gate_scan._backward(V, ct, c, s, tabs, route)
    torch.cuda.synchronize()
    plan = gate_scan._plan(V0.shape[1], V0.shape[2], dtype)
    assert launch_counts() == {
        f"gate_scan.gate_scan_{d}.{route or plan[d]['route']}": 1
        for d in ("fwd", "bwd")}
    V_ref, W_ref, dth_ref = _scan_plain(tabs, th, V0, ct)
    _close(V, V_ref)
    _close(W, W_ref)
    _close(dth.sum(0), dth_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gate_scan_autograd_and_repeats(card, dtype):
    """apply_rev_str through autograd (one launch a direction, states with
    two leading axes) against the plain version; two calls agree bit for
    bit; an all-zero theta leaves the states exactly."""
    from esoo_torch.ops import gate_scan
    tabs, th, V0, ct = _scan_inputs(6, (3, 3), dtype, 4, card, seed=1)
    V0, ct = V0.reshape(2, 2, *V0.shape[1:]), ct.reshape(2, 2, *ct.shape[1:])
    runs = []
    for _ in range(2):
        reset_launch_counts()
        v, t = V0.clone().requires_grad_(), th.clone().requires_grad_()
        V = gate_scan.apply_rev_str(v, t, tabs)
        torch.autograd.backward(V, ct)
        torch.cuda.synchronize()
        assert _launched("gate_scan.gate_scan_fwd") == 1
        assert _launched("gate_scan.gate_scan_bwd") == 1
        runs.append((V.detach(), v.grad, t.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    for got, ref in zip(runs[0], _scan_plain(tabs, th, V0, ct)):
        _close(got, ref)
    zero = torch.zeros_like(th)
    assert torch.equal(gate_scan.apply_rev_str(V0, zero, tabs), V0)


def test_gate_scan_plan_matches_the_kernel(card):
    from esoo_torch.ops import gate_scan
    lib = gate_scan._lib()
    for nB, nA in ((6, 6), (15, 20), (70, 70), (126, 126), (3432, 3432)):
        assert lib.esoo_gate_scan_threads(nA * nB) == \
            gate_scan._threads(nA * nB)
        words = gate_scan._words(nA, nB)
        for item in (4, 8):
            for bufs in (0, 1, 2):
                for stages in (1, 4, 26, 32):
                    assert lib.esoo_gate_scan_smem_bytes(
                        nA * nB, item, bufs, words, stages) == \
                        gate_scan._smem_bytes(nB, nA, item, bufs, words,
                                              stages)


def test_gate_scan_refuses_what_it_does_not_take(card):
    from esoo_torch.ops import gate_scan
    tabs, th, V0, _ = _scan_inputs(4, (2, 2), torch.float32, 1, card)
    with pytest.raises(TypeError):
        gate_scan.apply_rev_str(V0.double(), th, tabs)
    with pytest.raises(ValueError, match="do not agree"):
        gate_scan.apply_rev_str(V0[..., :-1], th, tabs)
    with pytest.raises(ValueError, match="CUDA device"):
        gate_scan.apply_rev_str(V0, th.cpu(), tabs)
    no_records = {k: v for k, v in tabs.items() if k != "GREC"}
    with pytest.raises(ValueError, match="GREC"):
        gate_scan.apply_rev_str(V0, th, no_records)


def test_sector_vqe_on_the_card_never_runs_the_plain_scan(card, monkeypatch):
    """FusedOptOrbVQE on H2 6-31G at float64: every gate scan on the card
    goes through the kernels, one forward and one backward launch an
    L-BFGS evaluation, and the energy is the CPU's."""
    from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.ops import gate_scan
    from esoo_torch.sim import strings
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    energies = {}
    for device in ("cpu", "cuda"):
        if device == "cuda":
            def refuse(*args):
                raise AssertionError("the plain gate scan ran on the card")
            monkeypatch.setattr(strings._ApplyRevStr, "apply", refuse)
        reset_launch_counts()
        r = FusedOptOrbVQE(
            4, UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1))),
            problem=p, dtype=torch.float64, device=device
        ).compute_minimum_energy()
        energies[device] = r.eigenvalue
    fwd = _launched("gate_scan.gate_scan_fwd")
    bwd = _launched("gate_scan.gate_scan_bwd")
    assert bwd > 0 and fwd >= bwd
    assert bwd >= r.stage_stats["lbfgs_evaluations"]
    assert abs(energies["cuda"] - energies["cpu"]) <= 1e-8


# -- the full-space Pauli-rotation scan K8 (csrc/prot_scan.cu) ----------------

def _prot_inputs(nq, kind, dtype, batch, card, K=None, seed=0):
    """A run of Pauli rotations on nq qubits: "uccsd" (UCCSD(nq / 2,
    ...) from HF, odd-Y strings, a real state; groups of 2 and 8 equal X
    masks), "parity" (the same under the parity mapper) or "random" (K
    seeded strings, every Y count, groups of one; a complex state), as a
    sim/statevector.py _ScanRun, its tables on the card at `dtype` (the
    masks x, z, the factors f and the group offsets), angles (every fifth
    one exactly 0), states (batch, 2^nq) and a cotangent."""
    import importlib
    from esoo_torch.sim import HartreeFock, QuantumCircuit, UCCSD
    TV = importlib.import_module("esoo_torch.sim.statevector")
    rng = np.random.default_rng(seed)
    if kind in ("uccsd", "parity"):
        from esoo_torch.ops import ParityMapper
        n = nq // 2
        parts = ((n + 1) // 2, n // 2)
        mapper = ParityMapper() if kind == "parity" else None
        qc = UCCSD(n, parts, qubit_mapper=mapper,
                   initial_state=HartreeFock(n, parts, qubit_mapper=mapper))
    else:
        qc = QuantumCircuit(nq)
        for x, z in rng.integers(0, 1 << nq, size=(K, 2)):
            qc.pauli_rot(qc.parameter(), int(x), int(z))
    run = TV._ScanRun([g for g in qc.gates if g.name == "prot"])
    rd = torch.float32 if dtype in (torch.float32, torch.complex64) \
        else torch.float64
    ang = rng.normal(size=len(run.xs))
    ang[::5] = 0.0

    def draw():
        a = rng.normal(size=(batch, 1 << nq))
        if dtype.is_complex:
            a = a + 1j * rng.normal(size=a.shape)
        return torch.as_tensor(a, device=card).to(dtype)

    s0 = draw()
    s0 = s0 / torch.linalg.vector_norm(s0, dim=1, keepdim=True)
    return run.tables(1 << nq, dtype, card), \
        torch.as_tensor(ang, device=card).to(rd), s0, draw(), run


def _prot_plain(tabs, ang, s0, ct, run):
    """sim/statevector.py::_ProtScan on the card: out, the cotangent of
    the states and d/d ang."""
    import importlib
    TV = importlib.import_module("esoo_torch.sim.statevector")
    dim = s0.shape[-1]
    FS = tabs["f"][:, None] * TV._prot_signs(run.xs, run.zs, dim,
                                     s0.device).to(s0.dtype)
    s, a = s0.clone().requires_grad_(), ang.clone().requires_grad_()
    out = TV._ProtScan.apply(s, a, FS, [TV._flip_dims(v) for v in run.xs],
                             dim.bit_length() - 1)
    torch.autograd.backward(out, ct)
    return out.detach(), s.grad, a.grad


@pytest.mark.parametrize("route", [None, "global"])
@pytest.mark.parametrize("nq,kind,dtype,batch,K", [
    (8, "uccsd", torch.float64, 1, None), (8, "uccsd", torch.float32, 2, None),
    (12, "uccsd", torch.float32, 1, None),
    (6, "random", torch.complex64, 2, 60),
    (7, "random", torch.complex128, 1, 70),
    (8, "parity", torch.float64, 2, None),
    (13, "random", torch.complex128, 1, 40),
    (14, "uccsd", torch.float32, 1, None)])
def test_prot_scan_kernel_matches_plain(card, nq, kind, dtype, batch, K,
                                        route):
    """Both directions against _ProtScan: the state, its input cotangent
    and dang, on the route of _plan (smem at these sizes: one buffer, in
    place; complex128 at 13 qubits) or forced onto the global route (in
    place in the output)."""
    from esoo_torch.ops import prot_scan
    tabs, ang, s0, ct, run = _prot_inputs(nq, kind, dtype, batch, card, K)
    c, s = torch.cos(ang / 2), torch.sin(ang / 2)
    g = [tabs["x"], tabs["z"], tabs["f"], c, s, tabs["groups"]]
    plan = prot_scan._plan(s0.shape[1], batch, len(ang), dtype,
                           len(tabs["groups"]) - 1)
    reset_launch_counts()
    out, ckpt = prot_scan._forward(s0, g, plan["stride"], True, route)
    w0, dang = prot_scan._backward(ckpt, ct, g, plan["stride"], route)
    torch.cuda.synchronize()
    assert launch_counts() == {
        f"prot_scan.prot_scan_{d}.{route or 'smem'}": 1
        for d in ("fwd", "bwd")}
    ref = _prot_plain(tabs, ang, s0, ct, run)
    _close(out, ref[0])
    _close(w0, ref[1])
    _close(dang.sum(0), ref[2])


@pytest.mark.parametrize("route", ["smem", "global"])
@pytest.mark.parametrize("kind,dtype", [("uccsd", torch.float64),
                                        ("random", torch.complex64)])
def test_prot_scan_reloads_a_window_the_run_outgrows(card, kind, dtype,
                                                     route):
    """A window of 8 staged rotations, which the 160 (UCCSD) or 90
    (random) outgrow: the kernels restage it at group boundaries, forward
    and backward (and in the chunked regime's re-run), and agree with
    the plain scan."""
    from esoo_torch.ops import prot_scan
    tabs, ang, s0, ct, run = _prot_inputs(8, kind, dtype, 2, card, 90)
    c, s = torch.cos(ang / 2), torch.sin(ang / 2)
    g = [tabs["x"], tabs["z"], tabs["f"], c, s, tabs["groups"]]
    for stride in (1, 3):
        out, ckpt = prot_scan._forward(s0, g, stride, True, route, 8)
        w0, dang = prot_scan._backward(ckpt, ct, g, stride, route, 8)
        torch.cuda.synchronize()
        ref = _prot_plain(tabs, ang, s0, ct, run)
        _close(out, ref[0])
        _close(w0, ref[1])
        _close(dang.sum(0), ref[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex128])
def test_prot_scan_chunked_regime_matches_plain(card, dtype, monkeypatch):
    """Past _REMAT_RESIDUAL_BUDGET (set low) the kernels keep every
    isqrt(K)-th state and re-run each chunk in the backward; the plain
    scan chunks alike."""
    import importlib
    from esoo_torch.ops import prot_scan
    TV = importlib.import_module("esoo_torch.sim.statevector")
    monkeypatch.setattr(TV, "_REMAT_RESIDUAL_BUDGET", 1 << 10)
    kind = "uccsd" if not dtype.is_complex else "random"
    tabs, ang, s0, ct, run = _prot_inputs(8, kind, dtype, 2, card, 90)
    assert prot_scan._plan(256, 2, len(ang), dtype,
                           len(tabs["groups"]) - 1)["stride"] > 1
    a = ang.clone().requires_grad_()
    s = s0.clone().requires_grad_()
    out = prot_scan.apply_prot_scan(s, a, tabs)
    torch.autograd.backward(out, ct)
    ref = _prot_plain(tabs, ang, s0, ct, run)
    for got, want in zip((out.detach(), s.grad, a.grad), ref):
        _close(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64])
def test_prot_scan_autograd_and_repeats(card, dtype):
    """apply_prot_scan through autograd (one launch a direction, states
    with two leading axes) against the plain version; two calls agree bit
    for bit; all-zero angles leave the states exactly."""
    from esoo_torch.ops import prot_scan
    kind = "uccsd" if not dtype.is_complex else "random"
    tabs, ang, s0, ct, run = _prot_inputs(8, kind, dtype, 4, card, 64,
                                          seed=1)
    runs = []
    for _ in range(2):
        reset_launch_counts()
        s = s0.reshape(2, 2, -1).clone().requires_grad_()
        a = ang.clone().requires_grad_()
        out = prot_scan.apply_prot_scan(s, a, tabs)
        torch.autograd.backward(out, ct.reshape(2, 2, -1))
        torch.cuda.synchronize()
        assert _launched("prot_scan.prot_scan_fwd") == \
            _launched("prot_scan.prot_scan_bwd") == 1
        runs.append((out.detach().reshape(4, -1), s.grad.reshape(4, -1),
                     a.grad))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    for got, want in zip(runs[0], _prot_plain(tabs, ang, s0, ct, run)):
        _close(got, want)
    zero = torch.zeros_like(ang)
    assert torch.equal(prot_scan.apply_prot_scan(s0, zero, tabs), s0)


def test_prot_scan_plan_matches_the_kernel(card):
    from esoo_torch.ops import prot_scan
    lib = prot_scan._lib()
    for nq in (1, 4, 8, 12, 14, 16):
        dim = 1 << nq
        assert lib.esoo_prot_scan_threads(dim) == prot_scan._threads(dim)
        for item, ritem in ((4, 4), (8, 8), (8, 4), (16, 8)):
            for bufs in (0, 1):
                for window in (8, 160, 2688):
                    assert lib.esoo_prot_scan_smem_bytes(
                        dim, item, ritem, bufs, window) == \
                        prot_scan._smem_bytes(dim, item, ritem, bufs,
                                              window)


def test_prot_scan_refuses_what_it_does_not_take(card):
    from esoo_torch.ops import prot_scan
    tabs, ang, s0, _, _ = _prot_inputs(8, "uccsd", torch.float32, 1, card)
    with pytest.raises(TypeError):
        prot_scan.apply_prot_scan(s0.double(), ang, tabs)
    with pytest.raises(ValueError, match="do not agree"):
        prot_scan.apply_prot_scan(s0, ang, dict(tabs, x=tabs["x"][:-1]))
    with pytest.raises(ValueError, match="do not agree"):
        prot_scan.apply_prot_scan(s0, ang,
                                  dict(tabs, groups=tabs["groups"].long()))
    with pytest.raises(ValueError, match="CUDA device"):
        prot_scan.apply_prot_scan(s0, ang.cpu(), tabs)


def _h4_631g():
    from esoo_torch.chem import MoleculeDriver
    return MoleculeDriver(atom="H 0 0 0; H 0 0 1.23; H 0 0 2.46; "
                          "H 0 0 3.69", basis="6-31g").run()


def test_full_space_vqe_on_the_card_never_runs_the_plain_scan(card,
                                                               monkeypatch):
    """FusedOptOrbVQE(simulation='full') on H4 6-31G -> 8 at float64 (160
    rotations on 256 amplitudes): every scan on the card goes through the
    kernels, one forward and one backward launch an L-BFGS evaluation,
    and the energy is the CPU's."""
    import importlib
    from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
    from esoo_torch.ops import prot_scan
    TV = importlib.import_module("esoo_torch.sim.statevector")
    p = _h4_631g()
    energies = {}
    for device in ("cpu", "cuda"):
        if device == "cuda":
            def refuse(*args):
                raise AssertionError("the plain Pauli-rotation scan ran on "
                                     "the card")
            monkeypatch.setattr(TV._ProtScan, "apply", refuse)
        reset_launch_counts()
        r = FusedOptOrbVQE(
            8, UCCSD(4, (2, 2), initial_state=HartreeFock(4, (2, 2))),
            problem=p, simulation="full", maxiter=3, dtype=torch.float64,
            device=device).compute_minimum_energy()
        energies[device] = r.eigenvalue
    fwd = _launched("prot_scan.prot_scan_fwd")
    bwd = _launched("prot_scan.prot_scan_bwd")
    assert bwd > 0 and fwd >= bwd
    assert bwd >= r.stage_stats["lbfgs_evaluations"]
    assert abs(energies["cuda"] - energies["cpu"]) <= 1e-8


# -- the pairs gate scan (csrc/pair_scan.cu) ----------------------------------

def _pair_inputs(n, parts, dtype, batch, card, seed=0):
    """A UCCSD(n, parts) pairs sector's PARTNER/SFIELD on the card, theta
    (every fifth one exactly 0), padded states (batch, nd + 1) and a
    cotangent."""
    sec = _pairs_sector(n, parts)
    rng = np.random.default_rng(seed)
    th = rng.normal(size=len(sec._excs)) * 0.4
    th[::5] = 0.0
    v0 = rng.normal(size=(batch, sec.dim + 1))
    v0[:, -1] = 0.0
    v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    ct = rng.normal(size=v0.shape)
    f = lambda a: torch.as_tensor(a, device=card).to(dtype)
    P = torch.as_tensor(sec._PARTNER, device=card)
    return P, f(sec._SFIELD), f(th), f(v0), f(ct)


def _pair_plain(P, S, th, v0, ct):
    """sim/sector.py::_ApplyRev on the card: v, the cotangent of v0 and
    dtheta."""
    from esoo_torch.sim import sector
    v, t = v0.clone().requires_grad_(), th.clone().requires_grad_()
    out = sector._ApplyRev.apply(v, t, P, S)
    torch.autograd.backward(out, ct)
    return out.detach(), v.grad, t.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,parts,batch,route", [
    (4, (2, 2), 1, None), (6, (3, 2), 3, None), (6, (4, 4), 2, None),
    (8, (4, 4), 1, None), (6, (3, 2), 3, "global"), (9, (4, 4), 1, None),
    (9, (4, 4), 1, "global")])
def test_pair_scan_kernel_matches_plain(card, dtype, n, parts, batch, route):
    """Both directions against _ApplyRev: v, w and dtheta, on the route of
    _plan (n = 9, (4, 4): the smem route at float32, the global route
    backward at float64) or forced onto the global route; at H8 -> 16 and
    n = 9 the ring of record chunks wraps (more chunks than stages)."""
    from esoo_torch.ops import pair_scan
    P, S, th, v0, ct = _pair_inputs(n, parts, dtype, batch, card)
    c, s = torch.cos(th), torch.sin(th)
    reset_launch_counts()
    out = pair_scan._forward(v0, c, s, P, S, route)
    w0, dth = pair_scan._backward(out, ct, c, s, P, S, route)
    torch.cuda.synchronize()
    st = pair_scan._stream(P, S)
    plan = pair_scan._plan(v0.shape[1], dtype, P.shape[0], st["max_pairs"],
                           st["total"])
    assert st["plans"][v0.shape[1], dtype] == plan
    assert launch_counts() == {
        f"pair_scan.pair_scan_{d}.{route or plan[d]['route']}": 1
        for d in ("fwd", "bwd")}
    if n >= 8:
        assert all(plan[d]["chunks"] > plan[d]["stages"]
                   for d in ("fwd", "bwd"))
    ref = _pair_plain(P, S, th, v0, ct)
    _close(out, ref[0])
    _close(w0, ref[1])
    _close(dth.sum(0), ref[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_scan_gate_without_pairs(card, dtype):
    """Gates that touch nothing (PARTNER the identity, SFIELD 0): empty
    lists, skipped without a wait; dtheta 0 there, the rest against the
    plain scan, on both routes."""
    from esoo_torch.ops import pair_scan
    P, S, th, v0, ct = _pair_inputs(6, (3, 2), dtype, 2, card, seed=4)
    P, S = P.clone(), S.clone()
    for k in (0, 4, P.shape[0] - 1):
        P[k] = torch.arange(P.shape[1], device=card)
        S[k] = 0.0
    c, s = torch.cos(th), torch.sin(th)
    ref = _pair_plain(P, S, th, v0, ct)
    for route in ("smem", "global"):
        out = pair_scan._forward(v0, c, s, P, S, route)
        w0, dth = pair_scan._backward(out, ct, c, s, P, S, route)
        _close(out, ref[0])
        _close(w0, ref[1])
        _close(dth.sum(0), ref[2])
        assert float(dth[:, [0, 4, -1]].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pair_scan_autograd_and_repeats(card, dtype):
    """apply_rev_pairs through autograd (one launch a direction, states
    with two leading axes) against the plain version; two calls agree bit
    for bit; an all-zero theta leaves the states exactly."""
    from esoo_torch.ops import pair_scan
    P, S, th, v0, ct = _pair_inputs(6, (3, 3), dtype, 4, card, seed=1)
    runs = []
    for _ in range(2):
        reset_launch_counts()
        v = v0.reshape(2, 2, -1).clone().requires_grad_()
        t = th.clone().requires_grad_()
        out = pair_scan.apply_rev_pairs(v, t, P, S)
        torch.autograd.backward(out, ct.reshape(2, 2, -1))
        torch.cuda.synchronize()
        assert _launched("pair_scan.pair_scan_fwd") == \
            _launched("pair_scan.pair_scan_bwd") == 1
        runs.append((out.detach().reshape(4, -1), v.grad.reshape(4, -1),
                     t.grad))
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    for got, want in zip(runs[0], _pair_plain(P, S, th, v0, ct)):
        _close(got, want)
    zero = torch.zeros_like(th)
    assert torch.equal(pair_scan.apply_rev_pairs(v0, zero, P, S), v0)


def test_pair_scan_plan_matches_the_kernel(card):
    from esoo_torch.ops import pair_scan
    lib = pair_scan._lib()
    for p in (0, 15, 60, 64, 65, 400, 1400, 4410):
        assert lib.esoo_pair_scan_threads(p) == pair_scan._threads(p)
    for n in (1, 37, 226, 4901, 15877, 44101):
        for item in (4, 8):
            for bufs in (0, 1, 2):
                for log_chunk, stages, K in ((9, 1, 1), (9, 32, 92),
                                             (12, 4, 560), (9, 8, 361)):
                    assert lib.esoo_pair_scan_smem_bytes(
                        n, item, bufs, log_chunk, stages, K) == \
                        pair_scan._smem_bytes(n, item, bufs, log_chunk,
                                              stages, K)


def test_pair_scan_refuses_what_it_does_not_take(card):
    from esoo_torch.ops import pair_scan
    P, S, th, v0, _ = _pair_inputs(4, (2, 2), torch.float32, 1, card)
    with pytest.raises(TypeError):
        pair_scan.apply_rev_pairs(v0.double(), th, P, S)
    with pytest.raises(ValueError, match="do not agree"):
        pair_scan.apply_rev_pairs(v0[..., :-1], th, P, S)
    with pytest.raises(ValueError, match="CUDA device"):
        pair_scan.apply_rev_pairs(v0, th.cpu(), P, S)


def test_pairs_vqe_on_the_card_never_runs_the_plain_scan(card, monkeypatch):
    """FusedOptOrbVQE on H4 6-31G -> 8 with ESOO_SECTOR_KERNEL=pairs at
    float64: every scan on the card goes through the kernels, one forward
    and one backward launch an L-BFGS evaluation, and the energy is the
    CPU's."""
    from esoo_torch import FusedOptOrbVQE, HartreeFock, UCCSD
    from esoo_torch.ops import pair_scan
    from esoo_torch.sim import sector
    monkeypatch.setenv("ESOO_SECTOR_KERNEL", "pairs")
    p = _h4_631g()
    energies = {}
    for device in ("cpu", "cuda"):
        if device == "cuda":
            def refuse(*args):
                raise AssertionError("the plain pairs scan ran on the card")
            monkeypatch.setattr(sector._ApplyRev, "apply", refuse)
        reset_launch_counts()
        s = FusedOptOrbVQE(
            8, UCCSD(4, (2, 2), initial_state=HartreeFock(4, (2, 2))),
            problem=p, maxiter=3, dtype=torch.float64, device=device)
        assert s._sector.kernel == "pairs"
        r = s.compute_minimum_energy()
        energies[device] = r.eigenvalue
    fwd = _launched("pair_scan.pair_scan_fwd")
    bwd = _launched("pair_scan.pair_scan_bwd")
    assert bwd > 0 and fwd >= bwd
    assert bwd >= r.stage_stats["lbfgs_evaluations"]
    assert abs(energies["cuda"] - energies["cpu"]) <= 1e-8


# -- the sigma's single-excitation-list gathers (csrc/sigma_lists.cu) ---------

def _sector_28():
    from esoo_torch.orbital_optimization.casscf import _sector_ci_cached
    return _sector_ci_cached(28, (4, 4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sigma_list_gathers_match_plain_at_n28(card, dtype):
    """Both gathers at the H8 -> 28 shape (q = 196 operators, 1,001
    strings a spin) against their plain versions on the card, bit for bit
    (a gather is exact; the back-gather adds +-y in the plain version's
    order), a rerun bit for bit too, one launch each; the back-gather
    also over a batch of two states."""
    from esoo_torch.ops import sigma_lists as SL
    sec = _sector_28()
    tabs = sec.device_tables(dtype, device=card, storage="int8")
    rng = np.random.default_rng(28)
    ns = sec.nA
    V = torch.as_tensor(rng.normal(size=(ns, ns)), device=card).to(dtype)
    reset_launch_counts()
    T = SL.alpha_gather(V, tabs["SRC_A"], tabs["SGN_A"])
    torch.cuda.synchronize()
    assert launch_counts() == {"sigma_lists.alpha_gather": 1}
    assert torch.equal(T, SL.alpha_gather_plain(V, tabs["SRC_A"],
                                                tabs["SGN_A"]))
    for K in (1, 2):
        Y = torch.as_tensor(rng.normal(size=(196, K, ns, ns)),
                            device=card).to(dtype)
        base = torch.as_tensor(rng.normal(size=(K, ns, ns)),
                               device=card).to(dtype)
        before = _launched("sigma_lists.beta_gather")
        out = SL.beta_gather(Y, tabs["SRC_B"], tabs["SGN_B"], base)
        torch.cuda.synchronize()
        assert _launched("sigma_lists.beta_gather") == before + 1
        assert torch.equal(out, SL.beta_gather_plain(Y, tabs["SRC_B"],
                                                     tabs["SGN_B"], base))
        assert torch.equal(out, SL.beta_gather(Y, tabs["SRC_B"],
                                               tabs["SGN_B"], base))


def test_sigma_list_gathers_refuse_what_they_do_not_take(card):
    from esoo_torch.ops import sigma_lists as SL
    assert SL._lib().esoo_beta_gather_max_ops() == SL._MAX_OPS
    src = torch.zeros((4, 3), dtype=torch.int32, device=card)
    sgn = torch.ones((4, 3), dtype=torch.int8, device=card)
    V = torch.zeros((2, 3), device=card)
    with pytest.raises(TypeError):
        SL.alpha_gather(V.half(), src, sgn)
    with pytest.raises(TypeError):
        SL.alpha_gather(V, src.long(), sgn)
    with pytest.raises(ValueError):
        SL.alpha_gather(V, src.cpu(), sgn.cpu())
    with pytest.raises(ValueError):
        SL.alpha_gather(torch.zeros((2, 4), device=card), src, sgn)
    with pytest.raises(ValueError):
        SL.beta_gather(torch.zeros((5, 1, 3, 2), device=card), src, sgn,
                       torch.zeros((1, 3, 2), device=card))


def test_list_sigma_matches_dense_at_n28(card):
    """SectorCI at N=28 (1,002,001 determinants), float64 on the card: the
    list path's sigma of one state and of two against the dense sigma on
    the same tables, within 1e-12 * max(1, max|ref|), one launch of each
    gather a state batch."""
    from esoo_torch.ops import sigma_lists as SL
    from esoo_torch.sim import strings as S
    sec = _sector_28()
    f64 = torch.float64
    tabs = sec.device_tables(f64, device=card)
    h, g = (torch.as_tensor(a, device=card) for a in _random_so(28, 28))
    vals = sec.build_values(h, g, tabs)
    ops = S.build_ops(h, g, tabs)
    rng = np.random.default_rng(7)
    V = torch.as_tensor(rng.normal(size=(2, sec.nB, sec.nA)), device=card)
    for x in (V[0], V):
        reset_launch_counts()
        got = sec.sigma_values(x, vals, tabs)
        torch.cuda.synchronize()
        assert launch_counts() == {"sigma_lists.alpha_gather": 1,
                                   "sigma_lists.beta_gather": 1}
        ref = S.sigma(x, ops, tabs)
        _close(got, ref)


def _random_so(N, seed):
    """Spin-orbital (h, g) with the index symmetries of chemistry
    tensors."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, N))
    g0 = rng.normal(size=(N,) * 4)
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    return (h + h.T) / 2, g


def test_h8_davidson_on_lists_matches_the_dense_sigma(card):
    """The float64 Davidson ground energy of H8 cc-pVTZ -> 28 at the HF
    orbitals on the list path and on the dense sigma (the same tables
    without the lists): within 1e-10 Ha; the list path launches each
    gather once a matvec, and the back-gather twice more for its build
    (HA, HB)."""
    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.ops import sigma_lists as SL
    from esoo_torch.orbital_optimization.kernels import expand_spin_tensors
    from esoo_torch.sim import strings as S
    from esoo_torch.solvers import davidson_ground
    p = MoleculeDriver(atom="; ".join(f"H 0 0 {1.23 * i:.2f}"
                                      for i in range(8)),
                       basis="cc-pvtz").run()
    h_np, g_np = p.spatial_integral_tensors()
    h_so, g_so = expand_spin_tensors(
        torch.as_tensor(np.ascontiguousarray(h_np[:14, :14]), device=card),
        torch.as_tensor(np.ascontiguousarray(g_np[:14, :14, :14, :14]),
                        device=card))
    sec = _sector_28()
    lists = sec.device_tables(torch.float64, device=card)
    dense = {k: v for k, v in lists.items() if k not in S.LIST_KEYS}
    v0 = sec.hf_matrix(torch.float64, device=card).reshape(-1)
    energies, matvecs = {}, 0
    for name, tabs in (("lists", lists), ("dense", dense)):
        reset_launch_counts()
        vals = sec.build_values(h_so, g_so, tabs)
        diag = sec.diagonal_values(vals, tabs).reshape(-1)
        res = davidson_ground(
            lambda x: sec.sigma_values(x.reshape(sec.nB, sec.nA), vals,
                                       tabs).reshape(-1),
            diag, v0, tol=1e-9)
        energies[name] = float(res.eigenvalue)
        if name == "lists":
            matvecs = res.iterations
            assert launch_counts() == {
                "sigma_lists.alpha_gather": matvecs,
                "sigma_lists.beta_gather": 2 + matvecs}
        else:
            assert launch_counts() == {}
    assert matvecs > 2
    assert abs(energies["lists"] - energies["dense"]) <= 1e-10


# -- the orbital step's one-pass value and gradient (csrc/orbital_vag.cu) ----

def _orbital_inputs(card, m, n, dtype, seed):
    """U (m, n) with orthonormal columns, gamma symmetric, Gamma with the
    spin-summed RDM's symmetries, h symmetric and a random g with the pair
    symmetry g[p,q,r,s] = g[r,s,p,q], made in float64 on the card."""
    gen = torch.Generator(device=card).manual_seed(seed)
    f64 = dict(generator=gen, device=card, dtype=torch.float64)
    g = torch.randn((m,) * 4, **f64)
    g = (g + g.permute(2, 3, 0, 1)).to(dtype).contiguous()
    U = torch.linalg.qr(torch.randn(m, n, **f64))[0].to(dtype).contiguous()
    a, G0, h = (torch.randn(n, n, **f64), torch.randn((n,) * 4, **f64),
                torch.randn(m, m, **f64))
    Gamma = (G0 + G0.permute(2, 3, 0, 1) + G0.permute(1, 0, 3, 2)
             + G0.permute(3, 2, 1, 0))
    return (U, (a + a.T).to(dtype), Gamma.to(dtype).contiguous(),
            (h + h.T).to(dtype), g)


@pytest.mark.parametrize("m,n,dtype", [(112, 14, torch.float64),
                                       (112, 8, torch.float32),
                                       (56, 4, torch.float32),
                                       (112, 16, torch.float64),
                                       (112, 16, torch.float32),
                                       (13, 3, torch.float64),
                                       (26, 8, torch.float32)])
def test_orbital_vag_kernel_matches_plain(card, m, n, dtype):
    """The kernel against its plain twin (1e-11 relative at float64, 1e-5
    at float32), two calls bit for bit, four launches a call; odd and
    unaligned rows (13, 26 x 4 bytes) take the element-wise copies."""
    from esoo_torch.ops import orbital_vag as OV
    args = _orbital_inputs(card, m, n, dtype, 31 * m + n)
    reset_launch_counts()
    E, G = OV.orbital_value_and_grad_cuda(*args)
    E2, G2 = OV.orbital_value_and_grad_cuda(*args)
    torch.cuda.synchronize()
    assert launch_counts() == {"orbital_vag.orbital_vag": 8}
    assert torch.equal(E, E2) and torch.equal(G, G2)
    Er, Gr = OV.orbital_value_and_grad_plain(*args)
    tol = 1e-11 if dtype == torch.float64 else 1e-5
    for out, ref in ((E, Er), (G, Gr)):
        assert float((out - ref).abs().max()) <= tol * max(
            1.0, float(ref.abs().max()))


@pytest.mark.parametrize("itemsize", [4, 8])
def test_orbital_vag_plan_matches_the_kernel(card, itemsize):
    """The built kernel plans every shape the route sends it (m <= 256, n
    <= 16) within shared memory, with the workspace the wrapper allocates,
    and refuses the shapes beyond; its plans at the cells' shapes."""
    from esoo_torch.ops import orbital_vag as OV
    cpt = 16 // itemsize
    for m in range(1, OV._MAX_M + 1):
        for n in range(1, OV._MAX_N + 1):
            p = OV.kernel_plan(m, n, itemsize)
            assert p["work"] == OV._workspace(m, n)
            assert p["smem"] <= (115712 if p["per_sm"] == 2 else 232448)
            assert p["finish_smem"] <= 232448
            assert 2 <= p["depth"] <= 8 and p["per_sm"] in (1, 2)
            assert p["threads"] % 32 == 0 and p["threads"] <= 256
            assert p["spb"] * (p["mp"] // cpt) <= p["threads"]
            assert p["nb"] >= n and m <= p["mp"] < m + cpt
            assert p["steps"] * 4 >= m
    for m, n in ((OV._MAX_M + 1, 4), (56, OV._MAX_N + 1), (0, 4)):
        with pytest.raises(ValueError):
            OV.kernel_plan(m, n, itemsize)
    if itemsize == 8:
        p = OV.kernel_plan(112, 14, 8)
        assert (p["nb"], p["spb"], p["threads"], p["depth"], p["per_sm"]) \
            == (14, 4, 224, 3, 2)
    else:
        p = OV.kernel_plan(112, 8, 4)
        assert (p["nb"], p["spb"], p["threads"], p["per_sm"]) == \
            (8, 9, 256, 2)
        p = OV.kernel_plan(56, 4, 4)
        assert (p["nb"], p["spb"], p["threads"]) == (4, 16, 224)


def test_orbital_vag_bb_iterates_match_autograd(card):
    """A BB descent in float64 through the kernel: its first 10 iterates
    and their energies within 1e-10 of the autograd route's."""
    from esoo_torch.ops import orbital_vag as OV
    from esoo_torch.orbital_optimization import fused
    from esoo_torch.orbital_optimization.stiefel import _bb_loop
    U0, *data = _orbital_inputs(card, 40, 6, torch.float64, 5)
    scalar = lambda v: torch.tensor(v, dtype=torch.float64, device=card)
    for k in range(1, 11):
        runs = [_bb_loop(vag, U0, tuple(data), scalar(1e-3), scalar(1e-30),
                         scalar(0.8), k)
                for vag in (fused._ORBITAL_ONEPASS_VAG, fused._ORBITAL_VAG)]
        (U1, k1, _, tr1), (U2, k2, _, tr2) = runs
        assert k1 == k2 == k + 1
        assert float((U1 - U2).abs().max()) <= 1e-10
        assert float((torch.stack(tr1) - torch.stack(tr2)).abs().max()) <= \
            1e-10 * max(1.0, abs(float(tr2[0])))


def test_casscf_on_the_card_takes_the_one_pass_route(card):
    """A fused solver on the card checks g's pair symmetry once, at the
    first call of its orbital objective, and sends every BB value and
    gradient through the kernel; a g without the symmetry keeps
    autograd."""
    from esoo_torch import FusedOptOrbCASSCF
    from esoo_torch.chem import MoleculeDriver
    from esoo_torch.ops import orbital_vag as OV
    from esoo_torch.orbital_optimization import fused
    from esoo_torch.orbital_optimization.kernels import expand_spin_tensors
    p = MoleculeDriver(atom="H 0 0 0; H 0 0 0.735", basis="6-31g").run()
    solver = FusedOptOrbCASSCF(4, problem=p, device="cuda",
                               dtype=torch.float64)
    assert solver._g_pair_symmetric is None
    reset_launch_counts()
    st = solver.compute_minimum_energy().stage_stats
    assert solver._g_pair_symmetric is True
    assert solver._orbital_objective()[0] is fused._ORBITAL_ONEPASS_VAG
    assert _launched("orbital_vag.pair_asymmetry") == 1
    assert st["bb_vag_autograd"] == 0
    assert st["bb_vag_onepass"] == _launched("orbital_vag.orbital_vag") / 4
    assert st["bb_vag_onepass"] > 0
    h, g = p.spatial_integral_tensors()
    rng = np.random.default_rng(0)
    g = g + 1e-3 * rng.normal(size=g.shape)          # no pair symmetry
    h_so, g_so = expand_spin_tensors(torch.as_tensor(h), torch.as_tensor(g))
    solver = FusedOptOrbCASSCF(4, integral_tensors=(h_so.numpy(),
                                                    g_so.numpy()),
                               num_particles=(1, 1), device="cuda",
                               dtype=torch.float64)
    assert solver._orbital_objective()[0] is fused._ORBITAL_VAG
    assert solver._g_pair_symmetric is False
    st = solver.compute_minimum_energy().stage_stats
    assert st["bb_vag_onepass"] == 0 and st["bb_vag_autograd"] > 0


@pytest.mark.parametrize("m,dtype", [(112, torch.float64), (56, torch.float32),
                                     (13, torch.float64), (5, torch.float32)])
def test_pair_asymmetry_kernel_matches_plain(card, m, dtype):
    """The pair-symmetry check's kernel against its plain version: a g
    with the symmetry reads 0, a g with one element off reads that
    element's offset over max|g|, a random g reads its own asymmetry; one
    launch a check."""
    from esoo_torch.ops import orbital_vag as OV
    gen = torch.Generator(device=card).manual_seed(m)
    g = torch.randn((m,) * 4, generator=gen, device=card, dtype=dtype)
    sym = (g + g.permute(2, 3, 0, 1)).contiguous()
    off = sym.clone()
    off[m - 1, 0, m // 2, 1] += 1e-3
    reset_launch_counts()
    assert OV.pair_asymmetry(sym) == 0.0
    assert OV.pair_symmetric(sym) and not OV.pair_symmetric(off)
    for x in (off, g):
        got, ref = OV.pair_asymmetry(x), OV.pair_asymmetry_plain(x)
        assert got == pytest.approx(ref, rel=1e-6) and got > 0
    assert launch_counts() == {"orbital_vag.pair_asymmetry": 5}
