"""esoo_torch's hand-written CUDA kernels against their plain versions on
the card.  CUDA kernels have no interpreter, so these tests need an NVIDIA
GPU and skip without one; run them there with

    pytest -m cuda tests/test_torch_cuda.py

Tolerances: float32 5e-6 * max(1, max|ref|) (the JAX package's GEMM
test); float64 1e-12 * max(1, max|ref|)."""

import ctypes

import numpy as np
import pytest
import torch

from esoo_torch.ops import gemm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels run only on the card")
    return torch.device("cuda")


def _close(out, ref):
    tol = (5e-6 if ref.dtype == torch.float32 else 1e-12) * max(
        1.0, float(ref.abs().max()))
    assert float((out - ref).abs().max()) <= tol


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
    before = gemm.launch_counts()["gemm.matmul"]
    out = gemm.matmul(x, y, trans_x=trans_x)
    torch.cuda.synchronize()
    assert gemm.launch_counts()["gemm.matmul"] == before + 1
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
    gemm.reset_launch_counts()
    gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    assert gemm.launch_counts() == {
        "gemm.matmul": 0 if route == "fused" else 4,
        "gemm.rotate_two_body_cuda": launches}
    assert gemm.route_launch_counts()[route] == launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,n,route", [(26, 8, "fused"), (58, 10, "chain")])
def test_rotate_two_body_at_the_n2_shapes(card, dtype, m, n, route):
    """The N2 paths' transforms: cc-pVDZ (26, 8) on the one-pass kernel
    (m not a multiple of 4: the ragged m*m slab stride and the slab ring's
    tail), cc-pVTZ (58, 10) on the K1 chain, whose stage 1 has M = 58^3."""
    g, u = _transform_inputs(m, n, dtype, card)
    assert gemm._transform_plan(m, n, g.element_size())[0] == route
    gemm.reset_launch_counts()
    out = gemm.rotate_two_body_cuda(g, u)
    again = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    per = 2 if route == "fused" else 4
    assert gemm.route_launch_counts()[route] == 2 * per
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
        gemm.reset_launch_counts()
        runs.append(FusedOptOrbCASSCF(
            12, problem=p, maxiter=12, stopping_tolerance=1e-6,
            device=device, dtype=torch.float64).compute_minimum_energy())
        if device == "cuda":
            assert gemm.route_launch_counts()["fused"] > 0
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
        gemm.reset_launch_counts()
        runs.append(FusedOptOrbVQE(
            4, UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1))),
            problem=p, device=device).compute_minimum_energy().eigenvalue)
        if device == "cuda":
            assert gemm.launch_counts()["gemm.rotate_two_body_cuda"] > 0
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
    gemm.reset_launch_counts()
    out = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    assert gemm.route_launch_counts() == {"fused": 0, "chain": 4,
                                          "shard": 0}
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
        gemm.reset_launch_counts()
        runs.append(FusedOptOrbCASSCF(4, problem=p, maxiter=20, device=device,
                                      dtype=torch.float64
                                      ).compute_minimum_energy().eigenvalue)
        if device == "cuda":
            assert gemm.launch_counts()["gemm.rotate_two_body_cuda"] > 0
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
        gemm.reset_launch_counts()
        runs.append(FusedOptOrbSSVQE(
            4, UCCSD(2, (1, 1), reps=2),
            initial_states=[HartreeFock(2, (1, 1)),
                            OccupationState(4, 0b0110)],
            weight_vector=[2, 1], problem=p, maxiter=20, dtype=torch.float64,
            device=device).compute_energies().eigenvalues)
        if device == "cuda":
            assert gemm.route_launch_counts()["fused"] > 0
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
    gemm.reset_launch_counts()
    out = gemm.rotate_two_body_cuda(g, u)
    torch.cuda.synchronize()
    assert gemm.route_launch_counts() == {"fused": 2, "chain": 0,
                                          "shard": 0}
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
        gemm.reset_launch_counts()
        solver = FusedOptOrbVQE(
            4, UCCSD(2, (1, 1), initial_state=HartreeFock(2, (1, 1))),
            problem=p, simulation="full", device=device)
        assert solver.simulation == "full"
        runs.append(solver.compute_minimum_energy().eigenvalue)
        if device == "cuda":
            assert gemm.launch_counts()["gemm.rotate_two_body_cuda"] > 0
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
    gemm.reset_launch_counts()
    r_gpu = _class_optorb(kind, p, "cuda")
    routes = gemm.route_launch_counts()
    r_cpu = _class_optorb(kind, p, "cpu")
    key = "eigenvalue" if kind == "vqe" else "eigenvalues"
    np.testing.assert_allclose(getattr(r_gpu, key), getattr(r_cpu, key),
                               rtol=0, atol=1e-8)
    assert routes["chain"] == 0
    assert routes["fused"] == 2 * len(r_gpu.metrics["hamiltonian_time"]) > 0


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
    gemm.reset_launch_counts()
    parts = []
    for d in range(m // m_loc):
        g_loc = g[..., d * m_loc:(d + 1) * m_loc].contiguous()
        u_loc = u[d * m_loc:(d + 1) * m_loc].contiguous()
        out = gemm.rotate_two_body_shard(g_loc, u, u_loc)
        _close(out, gemm.rotate_two_body_shard_plain(g_loc, u, u_loc))
        parts.append(out)
    torch.cuda.synchronize()
    assert gemm.route_launch_counts()["shard"] == 4 * (m // m_loc)
    assert gemm.launch_counts()["gemm.matmul"] == 4 * (m // m_loc)
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
        gemm.reset_launch_counts()
        r = FusedOptOrbCASSCF(8, problem=p, device=dev,
                              mesh=make_orbital_mesh(devices=[dev] * 4)
                              ).compute_minimum_energy()
        runs.append(r.eigenvalue)
        if dev == "cuda":
            routes = gemm.route_launch_counts()
            assert routes["shard"] == 16 * (r.outer_iterations + 1)
            assert routes["fused"] == routes["chain"] == 0
    assert abs(runs[0] - runs[1]) <= 1e-8
