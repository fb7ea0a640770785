"""The full-space Pauli-rotation scan K8 (esoo_torch/ops/prot_scan.py,
csrc/prot_scan.cu) on the CPU against the JAX package's
`statevector._apply_prot_scan` (a lax.scan over `_scan_gates`, in sqrt(K)
jax.checkpoint chunks past `_REMAT_RESIDUAL_BUDGET`) and its jax.grad, at
float64 and complex128: a UCCSD(3, (2, 1)) run (80 rotations, real
state), the same under the parity mapper, seeded random Pauli strings on
6 qubits (real: odd Y counts; complex: every Y count mod 4), and 10
qubits (1,024 amplitudes, 512 pairs, one a thread at the kernel's 512
threads).  Every rotation takes its own parameter, so d/dparams is the
kernel's dang; every fifth angle is 0.  Tolerance: 1e-12 * max(1,
max|ref|) on the state, its input cotangent and dang; the two packages
order a rotation's products and dang's sums differently.

The CUDA kernels run only on the card (tests/test_torch_cuda.py).  Here
(a) `prot_scan.apply_prot_scan` on CPU tensors runs the plain
sim/statevector.py::_ProtScan, and a tensor elsewhere raises rather than
taking it; (b) `_emulate_fwd`/`_emulate_bwd` repeat the kernels'
schedule and arithmetic: the run cut into groups of equal X mask
(`prot_scan.group_offsets`), each group applied in place to the pairs
{e, e ^ x} (e with a 0 inserted at x's highest set bit), rotation by
rotation in registers, with the sign from popcounts of the masks; the
checkpoints at every `stride`-th group; the backward's chunks last to
first, each re-run from its checkpoint, then each group's rotation
inputs rebuilt forward from the group's input pair and the adjoint run
through them in reverse; dang = (c S1 - s S2) / 2, each of the inner
products S1 = Re<W, FS . P s_k> and S2 = Re<W, s_k> summed per thread
over its pairs (q = tid, tid + T, ...; amplitude e, then its mate) in
order, then all 16 of a group's sums within each warp by the halving
exchanges of __shfl_xor_sync (offsets 16, 8, 4, 2, then 1), and one
warp's __shfl_down_sync tree over the warp sums, at the kernel's block
size T = _plan's "threads"; (c) `_plan`
against the constants of csrc/prot_scan.cu; (d) `_ScanRun` off the CPU
keeps (K,) masks and the group offsets, no (K, 2^N) sign table."""

import dataclasses
import importlib
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import esoo_tpu.sim as J
import esoo_torch.sim as T
from esoo_tpu.ops import ParityMapper as JParity
from esoo_torch.ops import (ParityMapper, _build, launch_counts, prot_scan,
                            reset_launch_counts)
# the kernels' reductions
from test_torch_gate_scan import _pair_thread_sums, _warp_tree

jax.config.update("jax_enable_x64", True)

TV = importlib.import_module("esoo_torch.sim.statevector")
JV = sys.modules["esoo_tpu.sim.statevector"]

TOL = 1e-12
_REFS = {}


def _uccsd_gates(mapper=None):
    qc = J.UCCSD(3, (2, 1), qubit_mapper=mapper,
                 initial_state=J.HartreeFock(3, (2, 1), qubit_mapper=mapper),
                 reps=2)
    return [g for g in qc.gates if g.name == "prot"], 6


def _random_gates(nq, K, real, seed):
    """K rotations of seeded random Pauli strings (odd Y counts for a real
    run; for a complex one every Y count mod 4 occurs)."""
    rng = np.random.default_rng(seed)
    proto = J.QuantumCircuit(nq).pauli_rot(0.0, 1, 1).gates[0]
    gates = []
    while len(gates) < K:
        x, z = (int(v) for v in rng.integers(0, 1 << nq, size=2))
        y = bin(x & z).count("1")
        if real and y % 2 == 0:
            continue
        gates.append(dataclasses.replace(proto, data=(x, z, y)))
    return gates, nq


def _random_runs(nq, K, seed):
    """K complex rotations in runs of one X mask (1 to 12 long, so a run
    past _MAX_GROUP is cut), x = 0 (diagonal strings) among them."""
    rng = np.random.default_rng(seed)
    proto = J.QuantumCircuit(nq).pauli_rot(0.0, 1, 1).gates[0]
    gates = []
    while len(gates) < K:
        x = 0 if not gates else int(rng.integers(0, 1 << nq))
        for z in rng.integers(0, 1 << nq, size=int(rng.integers(1, 13))):
            y = bin(x & int(z)).count("1")
            gates.append(dataclasses.replace(proto, data=(x, int(z), y)))
    return gates[:K], nq


CASES = {"uccsd": (_uccsd_gates, True),
         "parity": (lambda: _uccsd_gates(JParity()), True),
         "real_n6": (lambda: _random_gates(6, 60, True, 1), True),
         "complex_n6": (lambda: _random_gates(6, 60, False, 2), False),
         "complex_runs": (lambda: _random_runs(6, 70, 4), False),
         "real_n10": (lambda: _random_gates(10, 50, True, 3), True)}


def _case(case):
    """The run's gates, each rotation its own parameter, and its host
    arrays: (gates, nq, real, xs, zs, factor)."""
    make, real = CASES[case]
    gates, nq = make()
    gates = [dataclasses.replace(g, angle=("param", k, 1.0, 0.0))
             for k, g in enumerate(gates)]
    xs, zs, ys = (np.array([g.data[i] for g in gates], dtype=np.int64)
                  for i in range(3))
    factor = np.where(ys % 4 == 1, 1.0, -1.0) if real else \
        -1j * np.power(1j, ys % 4)
    return gates, nq, real, xs, zs, factor


def _tabs(case, device="cpu"):
    """The run's tables on `device` (sim/statevector.py::_ScanRun.tables:
    FS and dims on the CPU, the masks and factors elsewhere)."""
    gates, nq, real, *_ = _case(case)
    dtype = torch.float64 if real else torch.complex128
    return TV._ScanRun(gates).tables(1 << nq, dtype, device)


def _inputs(K, nq, real, batch, seed):
    """Angles (every fifth one exactly 0), a normalized state and a
    cotangent, shape (2^nq,) or (batch, 2^nq)."""
    rng = np.random.default_rng(seed)
    ang = rng.normal(size=K)
    ang[::5] = 0.0
    shape = (1 << nq,) if batch is None else (batch, 1 << nq)

    def draw():
        a = rng.normal(size=shape)
        return a if real else a + 1j * rng.normal(size=shape)

    s0 = draw()
    s0 /= np.linalg.norm(s0, axis=-1, keepdims=True)
    return ang, s0, draw()


def _jax_vjp(gates, real, ang, s0, ct):
    """The JAX package's scan and the gradient of L = Re<ct, out> in the
    state's real and imaginary parts and in the angles (states vmapped
    over a batch)."""
    dtype = jnp.float64 if real else jnp.complex128

    def run(s, a):
        one = lambda v: JV._apply_prot_scan(v, a, gates, real, dtype)
        return one(s) if s.ndim == 1 else jax.vmap(one)(s)

    def loss(sr, si, a):
        s = sr if real else sr + 1j * si
        out = run(s, a)
        return jnp.sum(jnp.real(jnp.conj(jnp.asarray(ct)) * out))

    sr, si = jnp.asarray(s0.real), jnp.asarray(s0.imag)
    out = run(jnp.asarray(s0), jnp.asarray(ang))
    gr, gi, ga = jax.grad(loss, argnums=(0, 1, 2))(sr, si, jnp.asarray(ang))
    ds0 = np.asarray(gr) if real else np.asarray(gr) + 1j * np.asarray(gi)
    return np.asarray(out), ds0, np.asarray(ga)


def _reference(case, batch, chunked=False):
    """The seeded inputs and the JAX package's forward and gradients, once
    per (case, batch, chunked)."""
    key = (case, batch, chunked)
    if key not in _REFS:
        gates, nq, real, *_ = _case(case)
        ang, s0, ct = _inputs(len(gates), nq, real, batch, seed=11)
        _REFS[key] = (ang, s0, ct), _jax_vjp(gates, real, ang, s0, ct)
    return _REFS[key]


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * scale)


def _t(a):
    return torch.as_tensor(np.array(a))


# -- (b) the kernels' arithmetic in their order -------------------------------

def _parity(v):
    """popcount(v) & 1 of non-negative ints below 2^32 (the kernel's
    __popc on 32-bit indices and masks)."""
    return TV._parity(v, 32).bool()


def _pairs(dim, x):
    """The pairs of a group with X mask x, as the kernel enumerates them:
    (e, its mate, diag) for q = 0 .. dim / 2 - 1, e being q with a 0
    inserted at x's highest set bit (bit 0 for x = 0, whose mate is
    e ^ 1 and whose rotations act on each amplitude alone)."""
    q = torch.arange(dim // 2)
    h = x.bit_length() - 1 if x else 0
    low = (1 << h) - 1
    e = ((q & ~low) << 1) | (q & low)
    return e, e ^ (x if x else 1), x == 0


def _rotate_pair(a, b, e, p, diag, x, z, f, c, s):
    """rotate_pair(): a' = c a + s FS(e) a[e ^ x], b' = c b + s FS(p)
    a[p ^ x], FS(v) = f (-1)^popc((v ^ x) & z)."""
    fe = torch.where(_parity((e ^ x) & z), -f, f)
    fp = torch.where(_parity((p ^ x) & z), -f, f)
    return (c * a + s * (fe * (a if diag else b)),
            c * b + s * (fp * (b if diag else a)))


def _redot(w, u):
    """Re(conj(w) u)."""
    return (w.real * u.real + w.imag * u.imag) if w.is_complex() else w * u


def _group_fwd(S, k0, k1, xs, zs, f, c, s):
    """Group [k0, k1) applied in place to the pairs of S (B, dim), each
    pair loaded once and stored once."""
    x = int(xs[k0])
    e, p, diag = _pairs(S.shape[1], x)
    a, b = S[:, e], S[:, p]
    for k in range(k0, k1):
        a, b = _rotate_pair(a, b, e, p, diag, x, int(zs[k]), f[k], c[k],
                            s[k])
    S[:, e], S[:, p] = a, b


def _emulate_fwd(S, xs, zs, f, c, s, stride=None, groups=None):
    """The forward kernel on (B, dim) states: (the output, the list of
    checkpoints, the input state of every `stride`-th group, or None
    without a gradient)."""
    off = prot_scan.group_offsets(xs) if groups is None else groups
    cur, ckpt = S.clone(), [] if stride else None
    for g in range(len(off) - 1):
        if stride and g % stride == 0:
            ckpt.append(cur.clone())
        _group_fwd(cur, int(off[g]), int(off[g + 1]), xs, zs, f, c, s)
    return cur, ckpt


def _warp_sums(v):
    """The backward kernel's warp_sums: v (B, 16, threads), each thread's
    values (S1, S2 of rotation j // 2 at j); the halving exchanges at lane
    offsets 16, 8, 4 and 2 (a lane keeps the half its bit selects and adds
    its partner's copy), then 1, within each warp; returns (B, 16, warps),
    value j's warp sum (lane 2j's)."""
    B, J, T = v.shape
    v = v.reshape(B, J, T // 32, 32)
    lanes = torch.arange(32)
    for o, m in ((16, 8), (8, 4), (4, 2), (2, 1)):
        up = (lanes & o) != 0
        keep = torch.where(up, v[:, m:2 * m], v[:, :m])
        send = torch.where(up, v[:, :m], v[:, m:2 * m])
        v = keep + send[..., lanes ^ o]
    v = v[:, 0] + v[:, 0][..., lanes ^ 1]
    return v[..., 0::2].permute(0, 2, 1)


def _across_warps(sums):
    """One warp's __shfl_down_sync tree over the warp sums (B, warps)
    (lanes past the last warp hold 0)."""
    lanes = torch.zeros(sums.shape[0], 32, dtype=sums.dtype)
    lanes[:, :sums.shape[1]] = sums
    return _warp_tree(lanes)


def _emulate_bwd(ckpt, W, xs, zs, f, c, s, stride, groups=None):
    """The backward kernel: chunks of `stride` groups last to first, each
    re-run from its checkpoint, then group by group in reverse each
    rotation's input pair rebuilt forward from the group's input and the
    adjoint run through them; (the input cotangent, the (B, K) dang
    partials)."""
    off = prot_scan.group_offsets(xs) if groups is None else groups
    B, dim = W.shape
    K, G = c.shape[0], len(off) - 1
    threads = prot_scan._plan(dim, B, K, W.dtype, G)["threads"]
    wc = W.clone()
    dang = torch.zeros(B, K, dtype=c.dtype)
    for j in reversed(range(-(-G // stride))):
        g0, g1 = j * stride, min(G, (j + 1) * stride)
        rows = [ckpt[j]]
        for g in range(g0, g1 - 1):
            rows.append(rows[-1].clone())
            _group_fwd(rows[-1], int(off[g]), int(off[g + 1]), xs, zs, f, c,
                       s)
        for g in reversed(range(g0, g1)):
            k0, k1 = int(off[g]), int(off[g + 1])
            x = int(xs[k0])
            e, p, diag = _pairs(dim, x)
            sa, sb = [rows[g - g0][:, e]], [rows[g - g0][:, p]]
            for k in range(k0, k1 - 1):
                a, b = _rotate_pair(sa[-1], sb[-1], e, p, diag, x,
                                    int(zs[k]), f[k], c[k], s[k])
                sa.append(a)
                sb.append(b)
            wa, wb = wc[:, e], wc[:, p]
            sums = torch.zeros(B, 16, threads, dtype=c.dtype)
            for r in reversed(range(k1 - k0)):
                k = k0 + r
                z = int(zs[k])
                fe = torch.where(_parity((e ^ x) & z), -f[k], f[k])
                fp = torch.where(_parity((p ^ x) & z), -f[k], f[k])
                a, b = sa[r], sb[r]
                # S1 = Re<W, FS . P s_k>, S2 = Re<W, s_k>: each thread's
                # sums over its pairs
                sums[:, 2 * r] = _pair_thread_sums(
                    _redot(wa, fe * (a if diag else b)),
                    _redot(wb, fp * (b if diag else a)), threads)
                sums[:, 2 * r + 1] = _pair_thread_sums(
                    _redot(wa, a), _redot(wb, b), threads)
                conj = torch.conj if fe.is_complex() else (lambda v: v)
                wa, wb = (c[k] * wa + s[k] * (conj(fe if diag else fp)
                                              * (wa if diag else wb)),
                          c[k] * wb + s[k] * (conj(fp if diag else fe)
                                              * (wb if diag else wa)))
            wc[:, e], wc[:, p] = wa, wb
            # the warps' sums of all 16 values, then rotation r's S1 and
            # S2 across the warps; dang = (c S1 - s S2) / 2
            warps = _warp_sums(sums)
            for r in range(k1 - k0):
                k = k0 + r
                s1 = _across_warps(warps[:, 2 * r])
                s2 = _across_warps(warps[:, 2 * r + 1])
                dang[:, k] = 0.5 * (c[k] * s1 - s[k] * s2)
    return wc, dang


def _emulate(case, batch):
    """The emulated kernels on the reference's inputs: (out, input
    cotangent, dang summed over the batch, the stride in groups), at
    _plan's stride."""
    _, nq, real, xs, zs, factor = _case(case)
    (ang, s0, ct), _ = _reference(case, batch)
    S, W = _t(s0).reshape(-1, 1 << nq), _t(ct).reshape(-1, 1 << nq)
    a = _t(ang)
    c, s, f = torch.cos(a / 2), torch.sin(a / 2), _t(factor)
    G = len(prot_scan.group_offsets(xs)) - 1
    stride = prot_scan._plan(S.shape[1], S.shape[0], len(ang), S.dtype,
                             G)["stride"]
    out, ckpt = _emulate_fwd(S, xs, zs, f, c, s, stride)
    w0, dang = _emulate_bwd(ckpt, W, xs, zs, f, c, s, stride)
    return out.reshape(s0.shape), w0.reshape(s0.shape), dang.sum(0), stride


# -- (a) the plain route of apply_prot_scan -----------------------------------

def _plain_route(case, batch):
    (ang, s0, ct), _ = _reference(case, batch)
    reset_launch_counts()
    st, a = _t(s0).requires_grad_(), _t(ang).requires_grad_()
    out = prot_scan.apply_prot_scan(st, a, _tabs(case))
    torch.autograd.backward(out, _t(ct))
    assert launch_counts() == {}
    return out.detach(), st.grad, a.grad


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", ["uccsd", "complex_n6"])
def test_plain_route_matches_jax(case, batch):
    _, (out_ref, ds0_ref, da_ref) = _reference(case, batch)
    for got, ref in zip(_plain_route(case, batch),
                        (out_ref, ds0_ref, da_ref)):
        _close(got, ref)


def test_a_device_without_kernels_raises():
    """A tensor neither on the CPU nor on the card is refused, not sent to
    the plain version; so is a kernel that fails to load."""
    _, nq, real, xs, zs, factor = _case("real_n6")
    state = torch.zeros(1 << nq, dtype=torch.float64, device="meta")
    ang = torch.zeros(len(xs), dtype=torch.float64, device="meta")
    tabs = _tabs("real_n6", "meta")
    with pytest.raises(ValueError, match="CUDA device"):
        prot_scan.apply_prot_scan(state, ang, tabs)
    with pytest.raises(ValueError, match="CUDA device"):
        prot_scan.apply_prot_scan(state, _t(np.zeros(len(xs))), tabs)


def test_a_kernel_that_fails_to_build_raises(monkeypatch):
    """No fallback: past the device check, a build failure propagates."""
    _, nq, real, xs, zs, factor = _case("real_n6")

    def no_nvcc(name):
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu")

    monkeypatch.setattr(prot_scan, "_check", lambda *args: None)
    monkeypatch.setattr(_build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        prot_scan.apply_prot_scan(
            torch.zeros(1 << nq, dtype=torch.float64, device="meta"),
            _t(np.zeros(len(xs))).to("meta"), _tabs("real_n6", "meta"))


def test_a_zero_angle_scan_is_the_identity():
    """Rotations at angle 0 leave the state bit for bit, on the plain
    route and in the kernel's arithmetic."""
    for case in ("real_n6", "complex_n6"):
        _, nq, real, xs, zs, factor = _case(case)
        _, s0, _ = _inputs(len(xs), nq, real, 2, seed=5)
        S, a = _t(s0), torch.zeros(len(xs), dtype=torch.float64)
        f = _t(factor)
        assert torch.equal(prot_scan.apply_prot_scan(S, a, _tabs(case)), S)
        out, _ = _emulate_fwd(S, xs, zs, f, torch.cos(a / 2),
                              torch.sin(a / 2))
        assert torch.equal(out, S)


# -- (b) the kernels' emulation -----------------------------------------------

@pytest.mark.parametrize("case,batch", [("uccsd", None), ("uccsd", 2),
                                        ("real_n6", None),
                                        ("complex_n6", None),
                                        ("complex_n6", 2),
                                        ("real_n10", None),
                                        ("parity", None),
                                        ("complex_runs", 2)])
def test_kernel_emulation_matches_jax(case, batch):
    _, (out_ref, ds0_ref, da_ref) = _reference(case, batch)
    out, w0, dang, stride = _emulate(case, batch)
    assert stride == 1                # every state within the budget
    _close(out, out_ref)
    _close(w0, ds0_ref)
    _close(dang, da_ref)


@pytest.mark.parametrize("case,batch", [("uccsd", 2), ("complex_n6", None)])
def test_chunked_regime_matches_jax(case, batch, monkeypatch):
    """Past _REMAT_RESIDUAL_BUDGET (set low in both packages) the JAX scan
    runs sqrt(K) jax.checkpoint chunks and the kernel keeps the input of
    every isqrt(G)-th group, re-running each chunk in the backward: the plain
    route and the emulation against JAX's, and the emulation's output and
    gradients bit for bit those of its unchunked schedule."""
    _, nq, *_ = _case(case)
    full = _emulate(case, batch)
    monkeypatch.setattr(JV, "_REMAT_RESIDUAL_BUDGET", 64)
    monkeypatch.setattr(TV, "_REMAT_RESIDUAL_BUDGET", 64)
    _REFS.pop((case, batch, True), None)
    (ang, *_), refs = _reference(case, batch, chunked=True)
    out, w0, dang, stride = _emulate(case, batch)
    G = len(prot_scan.group_offsets(_case(case)[3])) - 1
    assert stride == math.isqrt(G) > 1
    for got, ref in zip((out, w0, dang), refs):
        _close(got, ref)
    for got, ref in zip(_plain_route(case, batch), refs):
        _close(got, ref)
    for a, b in zip((out, w0, dang), full[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,batch", [("uccsd", 2), ("parity", None),
                                        ("complex_n6", 2),
                                        ("complex_runs", None)])
def test_grouped_emulation_matches_the_plain_scan(case, batch):
    """The grouped, in-place schedule against the port's plain _ProtScan
    (the CPU route of apply_prot_scan) on the same inputs, and the
    schedule with every rotation its own group (the previous kernel's
    order) bit for bit: grouping changes no rounding."""
    _, nq, real, xs, zs, factor = _case(case)
    for got, ref in zip(_emulate(case, batch)[:3], _plain_route(case, batch)):
        _close(got, ref)
    (ang, s0, ct), _ = _reference(case, batch)
    S, W = _t(s0).reshape(-1, 1 << nq), _t(ct).reshape(-1, 1 << nq)
    a = _t(ang)
    c, s, f = torch.cos(a / 2), torch.sin(a / 2), _t(factor)
    ones = np.arange(len(xs) + 1, dtype=np.int32)
    grouped, ck = _emulate_fwd(S, xs, zs, f, c, s, 1)
    single, _ = _emulate_fwd(S, xs, zs, f, c, s, 1, ones)
    assert torch.equal(grouped, single)
    w0, dang = _emulate_bwd(ck, W, xs, zs, f, c, s, 1)
    assert w0.shape == W.shape and dang.shape == (S.shape[0], len(xs))


def test_emulated_warp_sums_are_the_kernels_exchanges():
    """_warp_sums on integer values (exact in float64): lane 2j of each
    warp ends with value j's sum over the warp's 32 lanes, for every j."""
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.integers(-50, 50, size=(2, 16, 64)),
                        dtype=torch.float64)
    got = _warp_sums(v)
    assert got.shape == (2, 16, 2)
    want = v.reshape(2, 16, 2, 32).sum(-1)
    assert torch.equal(got, want)


def _runs_of_equal_x(xs):
    """The maximal runs of consecutive equal x, as lengths."""
    cuts = [0] + [k for k in range(1, len(xs)) if xs[k] != xs[k - 1]]
    return np.diff(cuts + [len(xs)])


@pytest.mark.parametrize("name,ansatz,K,G", [
    ("h4_8", lambda: T.UCCSD(4, (2, 2)), 160, 26),
    ("h8_12", lambda: T.UCCSD(6, (4, 4)), 640, 92),
    ("h4_8_parity", lambda: T.UCCSD(4, (2, 2), qubit_mapper=ParityMapper()),
     160, 26),
])
def test_group_offsets_of_ucc_runs(name, ansatz, K, G):
    """Jordan-Wigner (and here the parity mapper) gives each excitation's
    2 or 8 strings one X mask, one after the other: 26 groups for the 160
    rotations of H4 -> 8, 92 for the 640 of H8 -> 12, each a maximal run
    of equal x (at most 8), in the run's order."""
    run = TV._ScanRun([g for g in ansatz().gates if g.name == "prot"])
    off = prot_scan.group_offsets(run.xs)
    assert off.dtype == np.int32 and len(run.xs) == K and len(off) == G + 1
    assert off[0] == 0 and off[-1] == K
    lengths = np.diff(off)
    assert set(lengths) <= {2, 8}
    assert np.array_equal(lengths, _runs_of_equal_x(run.xs))
    for g in range(G):
        assert len(set(run.xs[off[g]:off[g + 1]])) == 1


def test_group_offsets_of_random_strings_and_long_runs():
    """Random strings give groups of one; a run of equal x longer than
    _MAX_GROUP is cut into groups of 8 and the rest; nothing is
    reordered."""
    _, _, _, xs, *_ = _case("complex_n6")
    off = prot_scan.group_offsets(xs)
    assert np.array_equal(np.diff(off), _runs_of_equal_x(xs))
    assert np.all(np.diff(off) == 1)
    xs = np.array([5] * 20 + [3] * 8 + [0] * 9 + [5])
    assert np.diff(prot_scan.group_offsets(xs)).tolist() == \
        [8, 8, 4, 8, 8, 1, 1]
    _, _, _, xs, *_ = _case("complex_runs")
    off = prot_scan.group_offsets(xs)
    assert max(np.diff(off)) == 8 and (xs == 0).any()
    assert off[-1] == len(xs) and np.all(np.diff(off) >= 1)


# -- (c) the route plan against the kernel's constants ------------------------

def _kernel_constants():
    path = os.path.join(os.path.dirname(prot_scan.__file__), "..", "csrc",
                        "prot_scan.cu")
    with open(path) as f:
        src = f.read()
    return {name: int(v) for name, v in re.findall(
        r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}


def test_plan_mirrors_the_kernel_constants():
    k = _kernel_constants()
    assert k["kMaxThreads"] == prot_scan._MAX_THREADS
    assert k["kMaxSmem"] == prot_scan._SMEM_LIMIT
    assert k["kBuffers"] == prot_scan._BUFFERS == 1
    assert k["kMaxGroup"] == prot_scan._MAX_GROUP
    assert [prot_scan._threads(d) for d in (2, 64, 256, 4096, 65536)] == \
        [32, 32, 128, 512, 512]


@pytest.mark.parametrize("nq,dtype,route", [
    (12, torch.float32, "smem"),        # H8 -> 12
    (8, torch.float64, "smem"),         # H4 -> 8
    (14, torch.float32, "smem"),
    (15, torch.float32, "smem"),        # one buffer: a qubit further
    (12, torch.complex128, "smem"),
    (13, torch.complex128, "smem"),
    (16, torch.float32, "global"),      # H8 -> 16
    (14, torch.float64, "smem"),
    (14, torch.complex64, "smem"),
    (15, torch.float64, "global"),
    (14, torch.complex128, "global"),
])
def test_plan_routes(nq, dtype, route):
    """One state buffer (in place) beside the 640 rotations' staged
    parameters (a 16-byte-aligned Rot of two factors with s folded in, c
    and the z mask; the two factors; s) and the 4 KB of dang warp sums:
    real float32 to N = 15, float64 and complex64 to N = 14, complex128
    to N = 13 in shared memory."""
    dim = 1 << nq
    item = torch.empty((), dtype=dtype).element_size()
    ritem = item // 2 if dtype.is_complex else item
    plan = prot_scan._plan(dim, 1, 640, dtype)
    assert plan["window"] == 640
    for direction in ("fwd", "bwd"):
        assert plan[direction]["route"] == route
        state = dim * item if route == "smem" else 0
        rot = -(-(2 * item + ritem + 4) // 16) * 16
        assert plan[direction]["smem"] == \
            state + 640 * (rot + 2 * item + ritem) + 4096 <= 232448


def test_plan_checkpoint_stride():
    """Every state while K * B * dim is within the budget (2^23), else
    every isqrt(K)-th: H8 -> 12 keeps all 640, H8 -> 16 every 51st of
    2,688 (53 checkpoints)."""
    assert prot_scan._plan(4096, 1, 640, torch.float32)["stride"] == 1
    assert prot_scan._plan(4096, 2, 640, torch.float32)["stride"] == 1
    assert prot_scan._plan(4096, 4, 640, torch.float32)["stride"] == 25
    plan = prot_scan._plan(65536, 1, 2688, torch.float32)
    assert (plan["stride"], plan["checkpoints"]) == (51, 53)


def test_plan_checkpoint_stride_in_groups():
    """Counted in groups: H8 -> 12's 92 keep every group's input, one
    state or two; H8 -> 16's 360 every 18th (20 checkpoints)."""
    for B in (1, 2):
        plan = prot_scan._plan(4096, B, 640, torch.float32, 92)
        assert (plan["stride"], plan["checkpoints"]) == (1, 92)
    plan = prot_scan._plan(65536, 1, 2688, torch.float32, 360)
    assert (plan["stride"], plan["checkpoints"]) == (18, 20)
    assert plan["fwd"]["route"] == plan["bwd"]["route"] == "global"
    assert plan["window"] == 2688
    with pytest.raises(ValueError, match="groups"):
        prot_scan._plan(4096, 1, 10, torch.float32, 11)


def test_plan_window_past_shared_memory():
    """A run whose parameters outgrow shared memory beside the state is
    staged a window at a time (a multiple of 4, at least a group): 10,000
    complex128 rotations at N = 12, and N = 13 beside the 128 KB state."""
    plan = prot_scan._plan(4096, 1, 10_000, torch.complex128, 2_000)
    w = plan["window"]
    assert plan["fwd"]["route"] == "smem" and w % 4 == 0 and 8 <= w < 10_000
    assert prot_scan._rotation_bytes(16, 8) == 48 + 32 + 8
    assert plan["fwd"]["smem"] <= 232448 < plan["fwd"]["smem"] + 4 * 88
    plan = prot_scan._plan(8192, 1, 10_000, torch.complex128, 2_000)
    assert plan["fwd"]["route"] == "smem" and plan["window"] >= 8


def test_plan_refuses_what_neither_route_takes():
    with pytest.raises(ValueError, match="no route"):
        prot_scan._plan(1 << 31, 1, 10, torch.float32)
    with pytest.raises(ValueError, match="power of two"):
        prot_scan._plan(48, 1, 10, torch.float32)
    with pytest.raises(TypeError):
        prot_scan._plan(64, 1, 10, torch.float16)


# -- (d) _ScanRun's tables ----------------------------------------------------

def test_scan_run_keeps_no_sign_table_off_the_cpu():
    """On the CPU the run builds the plain scan's (K, dim) FS; on any
    other device only (K,) masks and factors and the (G + 1,) group
    offsets, and calling it there sends the state to the kernel wrapper
    (which refuses a non-CUDA device)."""
    ans = T.UCCSD(4, (2, 2), initial_state=T.HartreeFock(4, (2, 2)))
    cc = TV.CompiledCircuit(ans)
    run, = [st for st in cc._state_steps if isinstance(st, TV._ScanRun)]
    K, dim = len(run.xs), 256
    assert K == 160
    cpu = run.tables(dim, torch.float64, "cpu")
    assert cpu["FS"].shape == (K, dim) and len(cpu["dims"]) == K
    assert not {"x", "z", "f"} & set(cpu)
    off = run.tables(dim, torch.float64, "meta")
    assert "FS" not in off and set(off) == {"idx", "mult", "off", "x", "z",
                                            "f", "groups"}
    assert off["groups"].dtype == torch.int32
    assert off["groups"].shape == (27,)
    assert all(t.shape != (K, dim) and t.numel() == K
               for key, t in off.items() if key != "groups")
    keys = [k for k in run._tables if k[2] == "meta"]
    assert keys == [(dim, torch.float64, "meta")]
    state = torch.zeros(dim, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        run(state, torch.zeros(ans.num_parameters, dtype=torch.float64,
                               device="meta"))

