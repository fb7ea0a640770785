"""The port's operator algebra (esoo_torch/ops: Pauli, fermion,
Jordan-Wigner, the linear mappers, the active-space Hamiltonian builder)
against esoo_tpu/ops on the same seeded inputs.

The modules are host NumPy copies, so masks must be equal and
coefficients equal to 1e-14; the Hamiltonian builder's coefficients and
`hamiltonian_matrix` to 1e-12.  The inputs mirror tests/test_pauli.py,
test_jw.py, test_mappers.py and test_hamiltonian.py."""

import itertools

import numpy as np
import pytest

import esoo_tpu.ops as J
from esoo_tpu.ops import mappers as JM, pauli as JP
import esoo_torch.ops as T
from esoo_torch.convert import pauli_op_from_numpy
from esoo_torch.ops import mappers as TM, pauli as TP
from test_torch_engine import same_eri_engine  # noqa: F401

COEFF_TOL = 1e-14
H_TOL = 1e-12


def _random_label(rng, n):
    return "".join(rng.choice(list("IXYZ"), size=n))


def _random_ops(seed, n=3, terms=5):
    rng = np.random.default_rng(seed)
    labels = [_random_label(rng, n) for _ in range(terms)]
    coeffs = rng.normal(size=terms) + 1j * rng.normal(size=terms)
    return labels, coeffs


def _same_op(port, ref, tol=COEFF_TOL):
    assert port.num_qubits == ref.num_qubits
    assert list(port.xs) == list(ref.xs) and list(port.zs) == list(ref.zs)
    np.testing.assert_allclose(port.coeffs, ref.coeffs, rtol=0, atol=tol)


def _random_tensors(n, seed):
    """(h, g) with the index symmetries of real chemistry tensors."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(n, n))
    h = (h + h.T) / 2
    g = rng.normal(size=(n, n, n, n))
    g = (g + g.transpose(1, 0, 3, 2)) / 2
    g = (g + g.transpose(2, 3, 0, 1)) / 2
    return h, 0.1 * g


@pytest.mark.parametrize("a,b", list(itertools.product("IXYZ", repeat=2)))
def test_pauli_mul_matches_jax(a, b):
    ma, mb = TP.label_to_masks(a), TP.label_to_masks(b)
    assert ma == JP.label_to_masks(a) and mb == JP.label_to_masks(b)
    assert TP.pauli_mul(*ma, *mb) == JP.pauli_mul(*ma, *mb)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_pauli_algebra_matches_jax(seed):
    la, ca = _random_ops(seed)
    lb, cb = _random_ops(seed + 10)
    pa, pb = T.SparsePauliOp(la, ca), T.SparsePauliOp(lb, cb)
    ja, jb = J.SparsePauliOp(la, ca), J.SparsePauliOp(lb, cb)
    assert pa.labels == ja.labels == la
    assert TP.masks_to_label(pa.xs[0], pa.zs[0], 3) == la[0]
    for port, ref in ((pa.compose(pb), ja.compose(jb)),
                      (pa + pb * 0.5, ja + jb * 0.5), (pa - pb, ja - jb),
                      (pa.adjoint(), ja.adjoint()),
                      ((pa + pa).simplify(), (ja + ja).simplify())):
        _same_op(port, ref)
    np.testing.assert_allclose(pa.to_matrix(), ja.to_matrix(), rtol=0,
                               atol=COEFF_TOL)
    for got, want in zip(pa.mask_arrays(), ja.mask_arrays()):
        np.testing.assert_array_equal(got, want)
    h = pa + pa.adjoint()
    assert h.is_hermitian() and not (pa - pa.adjoint()).is_hermitian()
    assert pa.equiv(pa.compose(T.SparsePauliOp.identity(3)))
    assert T.SparsePauliOp.from_list(pa.to_list()).equiv(pa)
    # carried across as its masks and coefficients
    _same_op(pauli_op_from_numpy(*ja.mask_arrays()[:2], ja.coeffs, 3), ja)


FERMION_TERMS = [
    {"+_0 -_1": 1.0},
    {"+_2 +_0 -_1 -_3": 0.5 - 0.2j},
    {"+_3 -_3": 1.0, "+_1 -_1": -0.5},
    {"+_4 +_1 -_5 -_0": 1.0, "+_0 +_5 -_1 -_4": -1.0},
    {"-_2 +_2": 1.0},
    {"": 0.3, "+_5 -_0": 1.0},
]


@pytest.mark.parametrize("data", FERMION_TERMS)
def test_fermion_and_jw_match_jax(data):
    fp, fj = T.FermionicOp(data, 6), J.FermionicOp(data, 6)
    assert fp.terms == fj.terms
    assert fp.adjoint().terms == fj.adjoint().terms
    assert (fp + fp.adjoint() * 2.0).terms == (fj + fj.adjoint() * 2.0).terms
    _same_op(T.JordanWignerMapper().map(fp), J.JordanWignerMapper().map(fj))


@pytest.mark.parametrize("name", ["ParityMapper", "BravyiKitaevMapper"])
@pytest.mark.parametrize("n", [4, 6])     # 6: non-power-of-2 Fenwick tree
def test_mappers_match_jax(name, n):
    port, ref = getattr(T, name)(), getattr(J, name)()
    np.testing.assert_array_equal(TM._gf2_inverse(port._matrix(n)),
                                  JM._gf2_inverse(ref._matrix(n)))
    for mask in range(1 << n):
        enc = port.encode_mask(mask, n)
        assert enc == ref.encode_mask(mask, n)
        assert port.decode_mask(enc, n) == mask == ref.decode_mask(enc, n)
    rng = np.random.default_rng(n)
    for _ in range(4):
        p, q, r, s = rng.permutation(n)[:4]
        data = {f"+_{p} +_{q} -_{r} -_{s}": 1.0, f"+_{p} -_{q}": 0.5}
        _same_op(port.map(T.FermionicOp(data, n)),
                 ref.map(J.FermionicOp(data, n)))


@pytest.mark.parametrize("mapper", [None, "ParityMapper",
                                    "BravyiKitaevMapper"])
def test_hamiltonian_builder_matches_jax(mapper):
    """The builder's per-iteration coefficients (two (h, g) in turn, as
    the class-based OptOrb loop rebuilds them) and the fermionic tag."""
    port = T.ActiveSpaceHamiltonianBuilder(
        4, None if mapper is None else getattr(T, mapper)())
    ref = J.ActiveSpaceHamiltonianBuilder(
        4, None if mapper is None else getattr(J, mapper)())
    assert port.xs == ref.xs and port.zs == ref.zs
    for seed in (0, 1):
        h, g = _random_tensors(4, seed)
        hp, hj = port.build(h, g), ref.build(h, g)
        _same_op(hp, hj, tol=H_TOL)
        if mapper is None:
            np.testing.assert_array_equal(hp.fermionic[0], hj.fermionic[0])
            np.testing.assert_array_equal(hp.fermionic[1], hj.fermionic[1])
        else:
            assert hp.fermionic is None and hj.fermionic is None


@pytest.mark.parametrize("seed", [0, 3])
def test_hamiltonian_matrix_matches_jax(seed):
    h, g = _random_tensors(4, seed)
    np.testing.assert_allclose(T.hamiltonian_matrix(h, g),
                               J.hamiltonian_matrix(h, g), rtol=0, atol=H_TOL)


def test_h2_hamiltonian_matches_jax(h2_sto3g):
    """The H2 STO-3G qubit Hamiltonian, and its spectrum's ground state
    (-1.85727503, tests/test_hamiltonian.py)."""
    h, g = h2_sto3g.integral_tensors()
    hp = T.ActiveSpaceHamiltonianBuilder(4).build(h, g)
    _same_op(hp, J.ActiveSpaceHamiltonianBuilder(4).build(h, g), tol=H_TOL)
    np.testing.assert_allclose(np.linalg.eigvalsh(hp.to_matrix())[0],
                               -1.85727503, atol=1e-8)
