"""The opt-in exact bf16-split products (esoo_torch/ops/split_precision.py)
and their call sites in the string kernels, the mirror of
tests/test_split_precision.py: at float32 working precision the split
path is as accurate as the plain float32 path, both held against the
float64 oracle, for values and first-order gradients, across sigma,
quadform, the RDMs, the compact int8 kernels and a mesh's sharded
tables.  The tolerances are the JAX package's.  The port's gate scan
gathers (no product to split): force_split leaves it bit for bit.

The CPU runs the plain version (the bf16 parts cast to float32); the
`cuda`-marked tests hold the card's float32-output bf16 products against
it and skip without a card:

    pytest --noconftest -m cuda tests/test_torch_split_precision.py"""

import numpy as np
import pytest
import torch

from esoo_torch import HartreeFock, UCCSD
from esoo_torch import parallel as TP
from esoo_torch.ops import split_precision as sp
from esoo_torch.sim import strings as S
from esoo_torch.sim.sector import SectorCI, SectorUCC

F32, F64 = torch.float32, torch.float64


@pytest.fixture
def forced_split():
    """Force the split path on for the test body, restoring the default
    policy afterwards."""
    prev = sp.force_split(True)
    yield
    sp.force_split(prev)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the float32-output bf16 product "
                    "runs only on the card")
    return torch.device("cuda")


def _random_integrals(N, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(N, N))
    h = (h + h.T) / 2
    g0 = rng.normal(size=(N, N, N, N))
    g = (g0 + g0.transpose(1, 0, 3, 2) + g0.transpose(2, 3, 0, 1)
         + g0.transpose(3, 2, 1, 0))
    return h, g


def _sector(n=4, parts=(2, 2)):
    ansatz = UCCSD(n, parts, initial_state=HartreeFock(n, parts))
    sec = SectorUCC(ansatz, 2 * n, kernel="strings")
    assert sec.kernel == "strings"
    return ansatz, sec


def _ops(h, g, tabs, dtype):
    return S.build_ops(torch.as_tensor(h).to(dtype),
                       torch.as_tensor(g).to(dtype), tabs)


def _err(a, ref) -> float:
    return float((a.double() - ref.double()).abs().max())


def test_exact_mm_helpers_match_f64():
    """exact_mm / exact_mmT / exact_einsum reproduce the f64 product to
    f32 rounding: no worse than the plain f32 product's own error."""
    rng = np.random.default_rng(0)
    E = torch.as_tensor(rng.integers(-1, 2, size=(33, 47))).to(F32)
    X = torch.as_tensor(rng.normal(size=(47, 21))).to(F32)
    ref = E.double() @ X.double()
    scale = float(ref.abs().max())
    assert _err(sp.exact_mm(E, X), ref) <= 3 * _err(E @ X, ref) + 1e-9 * scale

    Y = torch.as_tensor(rng.normal(size=(21, 47))).to(F32)
    refT = Y.double() @ E.double().T
    assert _err(sp.exact_mmT(Y, E), refT) <= \
        3 * _err(Y @ E.T, refT) + 1e-9 * float(refT.abs().max())

    M = torch.as_tensor(rng.integers(-1, 2, size=(6, 9, 11))).to(torch.int8)
    V = torch.as_tensor(rng.normal(size=(5, 11))).to(F32)
    got = sp.exact_einsum("qji,bi->qbj", "qji,qbj->bi", M, V)
    assert got.dtype == F32
    assert _err(got, torch.einsum("qji,bi->qbj", M.double(),
                                  V.double())) < 1e-6


def test_exact_einsum_gradient_is_exact_not_bf16():
    """The backward recurses into the split product: the gradient matches
    f64 to f32 rounding (a plain 3-split would route the cotangent
    through the hi part at bf16 precision, 2^-9 relative)."""
    rng = np.random.default_rng(1)
    M = torch.as_tensor(rng.integers(-1, 2, size=(6, 9, 11))).to(torch.int8)
    V = torch.as_tensor(rng.normal(size=(5, 11))).to(F32)
    W = torch.as_tensor(rng.normal(size=(6, 5, 9))).to(F32)
    v = V.clone().requires_grad_(True)
    (g_split,) = torch.autograd.grad(torch.sum(W * sp.exact_einsum(
        "qji,bi->qbj", "qji,qbj->bi", M, v)), v)
    v64 = V.double().requires_grad_(True)
    (g_64,) = torch.autograd.grad(torch.sum(W.double() * torch.einsum(
        "qji,bi->qbj", M.double(), v64)), v64)
    rel = _err(g_split, g_64) / float(g_64.abs().max())
    assert rel < 1e-6, rel
    # exact_mm and exact_mmT recurse too
    E = torch.as_tensor(rng.integers(-1, 2, size=(7, 9))).to(F32)
    X = torch.as_tensor(rng.normal(size=(9, 4))).to(F32).requires_grad_(True)
    (gx,) = torch.autograd.grad(sp.exact_mm(E, X).sum()
                                + sp.exact_mmT(X.T, E).pow(2).sum(), X)
    X64 = X.detach().double().requires_grad_(True)
    (gx64,) = torch.autograd.grad((E.double() @ X64).sum()
                                  + (X64.T @ E.double().T).pow(2).sum(), X64)
    assert _err(gx, gx64) / float(gx64.abs().max()) < 1e-6


def test_use_split_policy():
    """Off by default; f64 never takes the split path; force_split
    overrides and restores cleanly."""
    assert not sp.use_split(F32)
    assert not sp.use_split(F64)
    prev = sp.force_split(True)
    try:
        assert sp.use_split(F32)
        assert not sp.use_split(F64)
        sp.force_split(False)
        assert not sp.use_split(F32)
    finally:
        sp.force_split(prev)
    assert sp.force_split(None) is prev


def test_gate_scan_is_unchanged_and_quadform_split_as_accurate(forced_split):
    """The port's gate scan gathers: under force_split(True) it is bit
    for bit the unsplit scan, in value and reversible gradient.  The
    quadform's value and theta-gradient through it (split sigma) are as
    close to f64 as the plain f32 path (the JAX package's check)."""
    ansatz, sec = _sector()
    tabs64 = sec.device_tables(F64, device="cpu")
    tabs32 = sec.device_tables(F32, device="cpu")
    rng = np.random.default_rng(3)
    V0 = rng.normal(size=sec.state_shape)
    V0 = V0 / np.linalg.norm(V0)
    th = rng.normal(size=ansatz.num_parameters) * 0.4
    w = torch.as_tensor(rng.normal(size=sec.state_shape)).to(F32)

    def scan(split):
        sp.force_split(split)
        t = torch.as_tensor(th).to(F32).requires_grad_(True)
        V = sec.apply_matrix(torch.as_tensor(V0).to(F32), t, tabs32)
        (grad,) = torch.autograd.grad(torch.sum(w * V), t)
        return V.detach(), grad

    for a, b in zip(scan(True), scan(False)):
        assert torch.equal(a, b)
    sp.force_split(True)

    h, g = _random_integrals(8, seed=7)
    ops64, ops32 = _ops(h, g, tabs64, F64), _ops(h, g, tabs32, F32)

    def vag(dtype, tabs, ops):
        t = torch.as_tensor(th).to(dtype).requires_grad_(True)
        e = S.quadform(sec.apply_matrix(torch.as_tensor(V0).to(dtype), t,
                                        tabs), ops, tabs)
        (grad,) = torch.autograd.grad(e, t)
        return float(e.detach()), grad

    v64, g64 = vag(F64, tabs64, ops64)
    v32, g32 = vag(F32, tabs32, ops32)
    sp.force_split(False)
    vhi, ghi = vag(F32, tabs32, ops32)
    sp.force_split(True)
    assert abs(v32 - v64) <= 3 * abs(vhi - v64) + 1e-5
    assert _err(g32, g64) <= 3 * _err(ghi, g64) + 1e-5


def _sigma_quadform_rdms(sec, tabs, ops, V, dtype, q_pad):
    Vt = torch.as_tensor(V).to(dtype)
    maps = S.build_rdm_maps(sec.num_qubits // 2, q_pad=q_pad)
    return (S.sigma(Vt, ops, tabs), float(S.quadform(Vt, ops, tabs)),
            *S.rdms(Vt, tabs, maps))


def _assert_split_matches_f64(got, ref):
    s32, q32, gam32, Gam32 = got
    s64, q64, gam64, Gam64 = ref
    assert _err(s32, s64) < 5e-5 * max(1.0, float(s64.abs().max()))
    assert abs(q32 - q64) < 5e-5 * max(1.0, abs(q64))
    assert _err(gam32, gam64) < 2e-5
    assert _err(Gam32, Gam64) < 2e-5


def test_sigma_and_rdms_split_match_f64(forced_split):
    """Dense-path sigma, quadform and RDMs at f32 + split match the f64
    oracle to f32 rounding; the batched (k, nB, nA) sigma too."""
    _, sec = _sector()
    tabs64 = sec.device_tables(F64, device="cpu")
    tabs32 = sec.device_tables(F32, device="cpu")
    h, g = _random_integrals(8, seed=5)
    ops64, ops32 = _ops(h, g, tabs64, F64), _ops(h, g, tabs32, F32)
    rng = np.random.default_rng(9)
    V = rng.normal(size=sec.state_shape)
    V = V / np.linalg.norm(V)
    q = tabs64["MA"].shape[0]
    _assert_split_matches_f64(
        _sigma_quadform_rdms(sec, tabs32, ops32, V, F32, q),
        _sigma_quadform_rdms(sec, tabs64, ops64, V, F64, q))
    Vk = np.stack([V, V[::-1]])
    s32 = S.sigma(torch.as_tensor(Vk).to(F32), ops32, tabs32)
    s64 = S.sigma(torch.as_tensor(Vk), ops64, tabs64)
    assert _err(s32, s64) < 5e-5 * max(1.0, float(s64.abs().max()))


def test_compact_split_matches_dense_f64(forced_split):
    """Compact int8-stack kernels at f32 + split (sigma, quadform, RDMs)
    match the dense f64 oracle."""
    sec = SectorCI(8, (2, 2))
    h, g = _random_integrals(8, seed=13)
    dense64 = sec.device_tables(F64, device="cpu")
    comp32 = sec.device_tables(F32, device="cpu", storage="compact")
    rng = np.random.default_rng(2)
    V = rng.normal(size=(sec.nB, sec.nA))
    V = V / np.linalg.norm(V)
    _assert_split_matches_f64(
        _sigma_quadform_rdms(sec, comp32, _ops(h, g, comp32, F32), V, F32,
                             comp32["MA8"].shape[0]),
        _sigma_quadform_rdms(sec, dense64, _ops(h, g, dense64, F64), V, F64,
                             dense64["MA"].shape[0]))


@pytest.mark.parametrize("storage", ["dense", "compact"])
def test_sharded_split_matches_dense_f64(forced_split, storage):
    """The sharded kernels (3 shards: 16 operators padded to 18) at f32 +
    split match the dense f64 oracle; the diagonal and transition 1-RDM
    (no split in the JAX package) equal the f32 unsplit ones."""
    sec = SectorCI(8, (2, 2))
    h, g = _random_integrals(8, seed=17)
    dense64 = sec.device_tables(F64, device="cpu")
    tt = TP.shard_sector_tables(TP.make_orbital_mesh(devices=["cpu"] * 3),
                                sec, F32, storage=storage)
    rng = np.random.default_rng(4)
    V = rng.normal(size=(sec.nB, sec.nA))
    V = V / np.linalg.norm(V)
    ops32 = _ops(h, g, tt, F32)
    _assert_split_matches_f64(
        _sigma_quadform_rdms(sec, tt, ops32, V, F32, tt.q_pad),
        _sigma_quadform_rdms(sec, dense64, _ops(h, g, dense64, F64), V, F64,
                             dense64["MA"].shape[0]))


# -- on the card -----------------------------------------------------------------

@pytest.mark.cuda
def test_card_split_products_are_f32_and_match_the_plain_version(card):
    """On the card the split products are bf16 tensor-core products with
    float32 accumulation and output: equal to the CPU plain version (the
    bf16 parts cast to float32) to f32 rounding, and the bf16 reduction
    flag is restored."""
    rng = np.random.default_rng(5)
    E = torch.as_tensor(rng.integers(-1, 2, size=(64, 300))).to(F32)
    X = torch.as_tensor(rng.normal(size=(300, 48))).to(F32)
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    got = sp.exact_mm(E.to(card), X.to(card))
    torch.cuda.synchronize()
    assert got.dtype == F32
    assert (torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
            == flag)
    ref = sp.exact_mm(E, X)
    assert _err(got.cpu(), ref) <= 5e-6 * max(1.0, float(ref.abs().max()))


@pytest.mark.cuda
def test_card_split_sigma_matches_f64(card, forced_split):
    sec = SectorCI(8, (2, 2))
    h, g = _random_integrals(8, seed=19)
    tabs32 = sec.device_tables(F32, device=card)
    dense64 = sec.device_tables(F64, device="cpu")
    rng = np.random.default_rng(6)
    V = rng.normal(size=(sec.nB, sec.nA))
    V = V / np.linalg.norm(V)
    ops32 = S.build_ops(torch.as_tensor(h).to(card, F32),
                        torch.as_tensor(g).to(card, F32), tabs32)
    s32 = S.sigma(torch.as_tensor(V).to(card, F32), ops32, tabs32)
    s64 = S.sigma(torch.as_tensor(V), _ops(h, g, dense64, F64), dense64)
    assert _err(s32.cpu(), s64) < 5e-5 * max(1.0, float(s64.abs().max()))
