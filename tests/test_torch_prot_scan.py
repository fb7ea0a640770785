"""The full-space Pauli-rotation scan K8 (esoo_torch/ops/prot_scan.py,
csrc/prot_scan.cu) on the CPU against the JAX package's
`statevector._apply_prot_scan` (a lax.scan over `_scan_gates`, in sqrt(K)
jax.checkpoint chunks past `_REMAT_RESIDUAL_BUDGET`) and its jax.grad, at
float64 and complex128: a UCCSD(3, (2, 1)) run (80 rotations, real
state), seeded random Pauli strings on 6 qubits (real: odd Y counts;
complex: every Y count mod 4), and 10 qubits (1,024 amplitudes, two a
thread at the kernel's 512 threads).  Every rotation takes its own
parameter, so d/dparams is the kernel's dang; every fifth angle is 0.
Tolerance: 1e-12 * max(1, max|ref|) on the state, its input cotangent and
dang; the two packages order a rotation's products and dang's sums
differently.

The CUDA kernels run only on the card (tests/test_torch_cuda.py).  Here
(a) `prot_scan.apply_prot_scan` on CPU tensors runs the plain
sim/statevector.py::_ProtScan, and a tensor elsewhere raises rather than
taking it; (b) `_emulate_fwd`/`_emulate_bwd` repeat the kernels'
arithmetic in their order: per rotation, the sign from popcounts of the
masks, the update read from one ping-pong buffer and written to the
other, the checkpoints at every `stride`-th rotation, the backward's
chunks last to first, each re-run from its checkpoint before the adjoint
runs through it, and dang summed per thread over its amplitudes (e = tid,
tid + T, ...) in order, then by the warps' __shfl_down_sync trees
(offsets 16 .. 1) and warp 0's tree over the warp sums, at the kernel's
block size T = _plan's "threads"; (c) `_plan` against the constants of
csrc/prot_scan.cu; (d) `_ScanRun` off the CPU keeps (K,) masks, no (K,
2^N) sign table."""

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
from esoo_torch.ops import prot_scan
from test_torch_gate_scan import _block_sum  # the kernels' dtheta tree

jax.config.update("jax_enable_x64", True)

TV = importlib.import_module("esoo_torch.sim.statevector")
JV = sys.modules["esoo_tpu.sim.statevector"]

TOL = 1e-12
_REFS = {}


def _uccsd_gates():
    qc = J.UCCSD(3, (2, 1), initial_state=J.HartreeFock(3, (2, 1)), reps=2)
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


CASES = {"uccsd": (_uccsd_gates, True),
         "real_n6": (lambda: _random_gates(6, 60, True, 1), True),
         "complex_n6": (lambda: _random_gates(6, 60, False, 2), False),
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


def _rotate(S, e, x, z, f, c, s):
    """rotate(): c v + s FS(e) S[e ^ x], FS(e) = f (-1)^popc((e ^ x) & z)."""
    p = e ^ x
    fs = torch.where(_parity(p & z), -f, f)
    return c * S + s * (fs * S[:, p])


def _redot(w, u):
    """Re(conj(w) u)."""
    return (w.real * u.real + w.imag * u.imag) if w.is_complex() else w * u


def _emulate_fwd(S, xs, zs, f, c, s, stride=None):
    """The forward kernel on (B, dim) states: (the output, the list of
    checkpoints, the input state of every `stride`-th rotation, or None
    without a gradient)."""
    e = torch.arange(S.shape[1])
    cur, ckpt = S.clone(), [] if stride else None
    for k in range(c.shape[0]):
        if stride and k % stride == 0:
            ckpt.append(cur.clone())
        cur = _rotate(cur, e, int(xs[k]), int(zs[k]), f[k], c[k], s[k])
    return cur, ckpt


def _emulate_bwd(ckpt, W, xs, zs, f, c, s, stride):
    """The backward kernel: chunks last to first, each re-run from its
    checkpoint, then the adjoint through it; (the input cotangent, the
    (B, K) dang partials)."""
    B, dim = W.shape
    K = c.shape[0]
    threads = prot_scan._plan(dim, B, K, W.dtype)["threads"]
    e = torch.arange(dim)
    wc = W.clone()
    dang = torch.zeros(B, K, dtype=c.dtype)
    for j in reversed(range(-(-K // stride))):
        k0, k1 = j * stride, min(K, (j + 1) * stride)
        rows = [ckpt[j]]
        for k in range(k0, k1 - 1):
            rows.append(_rotate(rows[-1], e, int(xs[k]), int(zs[k]), f[k],
                                c[k], s[k]))
        for k in reversed(range(k0, k1)):
            x, z, sk = int(xs[k]), int(zs[k]), rows[k - k0]
            p = e ^ x
            fs_e = torch.where(_parity(p & z), -f[k], f[k])
            fs_p = torch.where(_parity(e & z), -f[k], f[k])
            term = c[k] * _redot(wc, fs_e * sk[:, p]) - s[k] * _redot(wc, sk)
            dang[:, k] = 0.5 * _block_sum(term, threads)
            cf = torch.conj(fs_p) if fs_p.is_complex() else fs_p
            wc = c[k] * wc + s[k] * (cf * wc[:, p])
    return wc, dang


def _emulate(case, batch):
    """The emulated kernels on the reference's inputs: (out, input
    cotangent, dang summed over the batch), at _plan's stride."""
    _, nq, real, xs, zs, factor = _case(case)
    (ang, s0, ct), _ = _reference(case, batch)
    S, W = _t(s0).reshape(-1, 1 << nq), _t(ct).reshape(-1, 1 << nq)
    a = _t(ang)
    c, s, f = torch.cos(a / 2), torch.sin(a / 2), _t(factor)
    stride = prot_scan._plan(S.shape[1], S.shape[0], len(ang),
                             S.dtype)["stride"]
    out, ckpt = _emulate_fwd(S, xs, zs, f, c, s, stride)
    w0, dang = _emulate_bwd(ckpt, W, xs, zs, f, c, s, stride)
    return out.reshape(s0.shape), w0.reshape(s0.shape), dang.sum(0), stride


# -- (a) the plain route of apply_prot_scan -----------------------------------

def _plain_route(case, batch):
    (ang, s0, ct), _ = _reference(case, batch)
    prot_scan.reset_launch_counts()
    st, a = _t(s0).requires_grad_(), _t(ang).requires_grad_()
    out = prot_scan.apply_prot_scan(st, a, _tabs(case))
    torch.autograd.backward(out, _t(ct))
    assert prot_scan.launch_counts()["prot_scan.apply_prot_scan"] == 0
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

    def no_nvcc():
        raise RuntimeError("nvcc failed on csrc/prot_scan.cu")

    monkeypatch.setattr(prot_scan, "_check", lambda *args: None)
    monkeypatch.setattr(prot_scan, "_lib", no_nvcc)
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
                                        ("real_n10", None)])
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
    runs sqrt(K) jax.checkpoint chunks and the kernel keeps every
    isqrt(K)-th state, re-running each chunk in the backward: the plain
    route and the emulation against JAX's, and the emulation's output and
    gradients bit for bit those of its unchunked schedule."""
    _, nq, *_ = _case(case)
    full = _emulate(case, batch)
    monkeypatch.setattr(JV, "_REMAT_RESIDUAL_BUDGET", 64)
    monkeypatch.setattr(TV, "_REMAT_RESIDUAL_BUDGET", 64)
    _REFS.pop((case, batch, True), None)
    (ang, *_), refs = _reference(case, batch, chunked=True)
    out, w0, dang, stride = _emulate(case, batch)
    assert stride == math.isqrt(len(ang)) > 1
    for got, ref in zip((out, w0, dang), refs):
        _close(got, ref)
    for got, ref in zip(_plain_route(case, batch), refs):
        _close(got, ref)
    for a, b in zip((out, w0, dang), full[:3]):
        assert torch.equal(a, b)


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
    assert k["kBuffers"] == prot_scan._BUFFERS
    assert [prot_scan._threads(d) for d in (2, 64, 256, 4096, 65536)] == \
        [32, 64, 256, 512, 512]


@pytest.mark.parametrize("nq,dtype,route", [
    (12, torch.float32, "smem"),        # H8 -> 12
    (8, torch.float64, "smem"),         # H4 -> 8
    (14, torch.float32, "smem"),
    (15, torch.float32, "global"),
    (12, torch.complex128, "smem"),
    (13, torch.complex128, "global"),
    (16, torch.float32, "global"),      # H8 -> 16
])
def test_plan_routes(nq, dtype, route):
    dim = 1 << nq
    item = torch.empty((), dtype=dtype).element_size()
    plan = prot_scan._plan(dim, 1, 640, dtype)
    for direction in ("fwd", "bwd"):
        assert plan[direction]["route"] == route
        state = 2 * dim * item if route == "smem" else 0
        assert plan[direction]["smem"] == state + 256 <= 232448


def test_plan_checkpoint_stride():
    """Every state while K * B * dim is within the budget (2^23), else
    every isqrt(K)-th: H8 -> 12 keeps all 640, H8 -> 16 every 51st of
    2,688 (53 checkpoints)."""
    assert prot_scan._plan(4096, 1, 640, torch.float32)["stride"] == 1
    assert prot_scan._plan(4096, 2, 640, torch.float32)["stride"] == 1
    assert prot_scan._plan(4096, 4, 640, torch.float32)["stride"] == 25
    plan = prot_scan._plan(65536, 1, 2688, torch.float32)
    assert (plan["stride"], plan["checkpoints"]) == (51, 53)


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
    other device only (K,) masks and factors, and calling it there sends
    the state to the kernel wrapper (which refuses a non-CUDA device)."""
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
                                            "f"}
    assert all(t.shape != (K, dim) and t.numel() == K for t in off.values())
    keys = [k for k in run._tables if k[2] == "meta"]
    assert keys == [(dim, torch.float64, "meta")]
    state = torch.zeros(dim, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        run(state, torch.zeros(ans.num_parameters, dtype=torch.float64,
                               device="meta"))

