"""The string gate scan K3 (esoo_torch/ops/gate_scan.py, csrc/gate_scan.cu)
on the CPU against the JAX package's `strings.apply_gates`
(`_apply_rev_str`, a custom_vjp over lax.scan with its reversible
backward), on the sector tables of UCCSD at H2 (2, (1, 1)), H4 (4, (2, 2))
and a synthetic n = 6, (3, 2) sector (nA = 20 != nB = 15), and
at n = 7, (3, 3) for the emulation's multi-element threads (nd = 1,225 >
512).  Inputs are seeded numpy arrays; some theta are exactly 0 (ADAPT's
padded slots).  Tolerance: 1e-12 * max(1, max|ref|) at float64, values
and VJP; the two packages round the update and sum dtheta in different
orders.

The CUDA kernels run only on the card (tests/test_torch_cuda.py).  Here
(a) `gate_scan.apply_rev_str` on CPU tensors runs the plain
sim/strings.py::_ApplyRevStr; (b) `_emulate_fwd`/`_emulate_bwd` repeat
the kernels' arithmetic in their order: per gate, every element's M, S
and partner address formed from the factored tables, the update read
from one ping-pong buffer and written to the other, and dtheta summed
per thread over its elements (e = tid, tid + T, ...) in element order,
then by the warps' __shfl_down_sync trees (offsets 16 .. 1) and warp 0's
tree over the warp sums, at the kernel's block size T = _plan's
"threads"; (c) `_plan` against the constants of csrc/gate_scan.cu."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from esoo_tpu.sim import strings as JS
from esoo_tpu.sim.sector import SectorUCC as JSector
from esoo_torch.ops import gate_scan
from esoo_torch.sim import HartreeFock, UCCSD
from esoo_torch.sim import strings as TS
from esoo_torch.sim.sector import SectorUCC

jax.config.update("jax_enable_x64", True)

CASES = {"h2": (2, (1, 1)), "h4": (4, (2, 2)), "n6_32": (6, (3, 2)),
         "n7_33": (7, (3, 3))}
TOL = 1e-12
_SECTORS = {}
_REFS = {}


def _sectors(case):
    if case not in _SECTORS:
        n, parts = CASES[case]
        js = JSector(JUCCSD(n, parts, initial_state=JHF(n, parts)), 2 * n)
        ts = SectorUCC(UCCSD(n, parts, initial_state=HartreeFock(n, parts)),
                       2 * n)
        _SECTORS[case] = js, ts
    return _SECTORS[case]


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * scale)


def _inputs(ts, batch, seed):
    """theta (every fifth one exactly 0), the states V0 and a cotangent,
    shape (nB, nA) or (batch, nB, nA)."""
    rng = np.random.default_rng(seed)
    K = len(ts._excs)
    th = rng.normal(size=K) * 0.4
    th[::5] = 0.0
    shape = (ts.nB, ts.nA) if batch is None else (batch, ts.nB, ts.nA)
    V0 = rng.normal(size=shape)
    V0 /= np.linalg.norm(V0)
    return th, V0, rng.normal(size=shape)


def _reference(case, batch):
    """The seeded inputs and the JAX package's forward and VJP on them,
    once per (case, batch) for the plain route's and the emulation's
    tests."""
    if (case, batch) not in _REFS:
        js, ts = _sectors(case)
        th, V0, ct = _inputs(ts, batch, seed=11)
        _REFS[case, batch] = (th, V0, ct), _jax_vjp(js, th, V0, ct)
    return _REFS[case, batch]


def _jax_vjp(js, th, V0, ct):
    """The JAX package's forward and VJP (states vmapped over a batch;
    dtheta sums over it)."""
    jt = js._str_tabs._asdict()

    def f(v, t):
        one = lambda x: JS.apply_gates(x, t, jt)
        return one(v) if v.ndim == 2 else jax.vmap(one)(v)

    V, vjp = jax.vjp(f, jnp.asarray(V0), jnp.asarray(th))
    dV0, dth = vjp(jnp.asarray(ct))
    return np.asarray(V), np.asarray(dV0), np.asarray(dth)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


# -- (b) the kernels' arithmetic in their order --------------------------------

def _gate_terms(tabs, k, nB, nA):
    """Per element e = ib * nA + ia: the touched mask M, the sign field S
    and the partner's address, formed from gate k's factored tables as
    the kernel forms them."""
    e = torch.arange(nB * nA)
    ib, ia = e // nA, e % nA
    ad, ar, ud, ur = (tabs[key][k][ia] for key in ("AD", "AR", "UD", "UR"))
    bd, br, vd, vr = (tabs[key][k][ib] for key in ("BD", "BR", "VD", "VR"))
    pa = tabs["PA"].to(torch.int32)[k].long()
    pb = tabs["PB"].to(torch.int32)[k].long()
    return bd * ad + br * ar, vr * ur - vd * ud, pb[ib] * nA + pa[ia]


def _emulate_fwd(V0, c, s, tabs):
    B, nB, nA = V0.shape
    cur = V0.reshape(B, nB * nA).clone()
    for k in range(c.shape[0]):
        m, sg, p = _gate_terms(tabs, k, nB, nA)
        cm1 = c[k] - 1.0
        v, g = cur, cur[:, p]
        cur = v + cm1 * (m * v) + s[k] * (sg * g)     # into the other buffer
    return cur.reshape(B, nB, nA)


def _warp_tree(x):
    """Lane 0 of __shfl_down_sync with offsets 16, 8, 4, 2, 1 over the
    last axis (32 lanes)."""
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


def _block_sum(x, threads):
    """The kernel's dtheta reduction of x (B, nd): thread t sums its
    elements t, t + T, ... in order; each warp's tree; warp 0's tree over
    the warp sums (lanes past the last warp hold 0)."""
    B, nd = x.shape
    J = -(-nd // threads)
    xs = torch.zeros(B, J * threads, dtype=x.dtype)
    xs[:, :nd] = x
    xs = xs.reshape(B, J, threads)
    acc = torch.zeros(B, threads, dtype=x.dtype)
    for j in range(J):
        acc = acc + xs[:, j]
    warps = _warp_tree(acc.reshape(B, threads // 32, 32))
    lanes = torch.zeros(B, 32, dtype=x.dtype)
    lanes[:, :warps.shape[1]] = warps
    return _warp_tree(lanes)


def _emulate_bwd(V, W, c, s, tabs):
    B, nB, nA = V.shape
    threads = gate_scan._plan(nB, nA, V.dtype)["threads"]
    vc, wc = V.reshape(B, -1).clone(), W.reshape(B, -1).clone()
    dth = torch.zeros(B, c.shape[0], dtype=V.dtype)
    for k in reversed(range(c.shape[0])):
        m, sg, p = _gate_terms(tabs, k, nB, nA)
        ck, sk, cm1 = c[k], s[k], c[k] - 1.0
        vk, gk, w, gw = vc, vc[:, p], wc, wc[:, p]
        vprev = vk + cm1 * (m * vk) - sk * (sg * gk)
        pprev = gk + cm1 * (m * gk) + sk * (sg * vk)
        dth[:, k] = _block_sum(w * (-sk * (m * vprev) + ck * (sg * pprev)),
                               threads)
        vc, wc = vprev, w + cm1 * (m * w) - sk * (sg * gw)
    return wc.reshape(B, nB, nA), dth


# -- (a) the plain route of apply_rev_str ---------------------------------------

@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", ["h2", "h4", "n6_32"])
def test_plain_route_matches_jax(case, batch):
    _, ts = _sectors(case)
    (th, V0, ct), (V_ref, dV0_ref, dth_ref) = _reference(case, batch)
    tabs = ts.device_tables(torch.float64, device="cpu")
    gate_scan.reset_launch_counts()
    v, t = _t(V0).requires_grad_(), _t(th).requires_grad_()
    out = gate_scan.apply_rev_str(v, t, tabs)
    torch.autograd.backward(out, _t(ct))
    assert gate_scan.launch_counts()["gate_scan.apply_rev_str"] == 0
    _close(out.detach(), V_ref)
    _close(v.grad, dV0_ref)
    _close(t.grad, dth_ref)


def test_plain_route_without_the_fields():
    """Tables without the precomputed (K, nd) fields (a JAX-side dict
    crossed as tensors) take strings.gate_fields on the CPU."""
    js, ts = _sectors("h4")
    th, V0, _ = _inputs(ts, None, seed=3)
    tabs = {k: v for k, v in ts.device_tables(torch.float64,
                                              device="cpu").items()
            if k not in ("M", "S", "flat")}
    ref = JS.apply_gates(jnp.asarray(V0), jnp.asarray(th),
                         js._str_tabs._asdict())
    _close(gate_scan.apply_rev_str(_t(V0), _t(th), tabs), ref)
    _close(TS.apply_gates(_t(V0), _t(th), tabs), ref)


def test_a_zero_angle_scan_is_the_identity():
    """ADAPT's padded slots: gates at theta = 0 leave the state bit for
    bit, on the plain route and in the kernel's arithmetic."""
    _, ts = _sectors("n6_32")
    _, V0, _ = _inputs(ts, 2, seed=5)
    tabs = ts.device_tables(torch.float64, device="cpu")
    th = torch.zeros(len(ts._excs), dtype=torch.float64)
    V0 = _t(V0)
    assert torch.equal(gate_scan.apply_rev_str(V0, th, tabs), V0)
    assert torch.equal(_emulate_fwd(V0, torch.cos(th), torch.sin(th), tabs),
                       V0)


def test_a_device_without_kernels_raises():
    """A tensor neither on the CPU nor on the card is refused, not sent to
    the plain version."""
    _, ts = _sectors("h2")
    tabs = ts.device_tables(torch.float64, device="cpu")
    V0 = torch.zeros(ts.nB, ts.nA, dtype=torch.float64, device="meta")
    th = torch.zeros(len(ts._excs), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        gate_scan.apply_rev_str(V0, th, tabs)


# -- (b) the kernels' emulation -----------------------------------------------

@pytest.mark.parametrize("case,batch", [("h4", None), ("h4", 2),
                                        ("n6_32", None), ("n6_32", 2),
                                        ("n7_33", None)])
def test_kernel_emulation_matches_jax(case, batch):
    _, ts = _sectors(case)
    (th, V0, ct), (V_ref, dV0_ref, dth_ref) = _reference(case, batch)
    tabs = ts.device_tables(torch.float64, device="cpu")
    theta = _t(th)
    c, s = torch.cos(theta), torch.sin(theta)
    shape = (-1, ts.nB, ts.nA)
    V = _emulate_fwd(_t(V0).reshape(shape), c, s, tabs)
    W0, dth = _emulate_bwd(V, _t(ct).reshape(shape), c, s, tabs)
    _close(V.reshape(V_ref.shape), V_ref)
    _close(W0.reshape(dV0_ref.shape), dV0_ref)
    _close(dth.sum(0), dth_ref)


def test_emulated_reduction_is_the_kernels_tree():
    """_block_sum at T = 64 over 100 elements: thread t holds x[t] +
    x[t + 64], and the trees pair lanes l and l + off."""
    x = torch.arange(100, dtype=torch.float64)[None] + 0.5
    assert float(_block_sum(x, 64)[0]) == float(x.sum())
    acc = torch.zeros(64, dtype=torch.float64)
    acc[:64] = x[0, :64]
    acc[:36] += x[0, 64:]
    lanes = acc.reshape(2, 32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[:, :off] + lanes[:, off:2 * off]
    assert float(_block_sum(x, 64)[0]) == float(lanes[0, 0] + lanes[1, 0])


# -- (c) the route plan against the kernel's constants ------------------------

def _kernel_constants():
    path = os.path.join(os.path.dirname(gate_scan.__file__), "..", "csrc",
                        "gate_scan.cu")
    with open(path) as f:
        src = f.read()
    return {name: int(v) for name, v in re.findall(
        r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}


def test_plan_mirrors_the_kernel_constants():
    k = _kernel_constants()
    assert k["kMaxThreads"] == gate_scan._MAX_THREADS
    assert k["kMaxSmem"] == gate_scan._SMEM_LIMIT
    assert k["kFwdBuffers"] == gate_scan._FWD_BUFFERS
    assert k["kBwdBuffers"] == gate_scan._BWD_BUFFERS
    assert [gate_scan._threads(nd) for nd in (1, 4, 36, 300, 512, 4900)] == \
        [32, 32, 64, 320, 512, 512]


@pytest.mark.parametrize("shape,dtype,fwd,bwd", [
    ((6, 6), torch.float32, "smem", "smem"),            # H4
    ((70, 70), torch.float32, "smem", "smem"),          # H8 -> 16
    ((70, 70), torch.float64, "smem", "smem"),
    ((126, 126), torch.float32, "smem", "global"),      # n = 9, (4, 4)
    ((126, 126), torch.float64, "global", "global"),
])
def test_plan_routes(shape, dtype, fwd, bwd):
    nB, nA = shape
    item = 4 if dtype == torch.float32 else 8
    plan = gate_scan._plan(nB, nA, dtype)
    for direction, route, bufs in (("fwd", fwd, 2), ("bwd", bwd, 4)):
        got = plan[direction]
        assert got["route"] == route
        state = bufs * nA * nB if route == "smem" else 0
        assert got["smem"] == item * (state + 8 * (nA + nB) + 32) + \
            8 * (nA + nB) <= 232448
    if shape == (70, 70) and dtype == torch.float64:
        assert plan["bwd"]["smem"] == 167136            # 153 KB of state


def test_plan_refuses_what_neither_route_takes():
    """n = 14 at (7, 7): 3,432 strings a spin; the table ring alone
    exceeds a block's shared memory."""
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(ValueError, match="no route"):
            gate_scan._plan(3432, 3432, dtype)
    with pytest.raises(TypeError):
        gate_scan._plan(6, 6, torch.float16)


def test_partner_maps_cached_once_per_tables_dict():
    _, ts = _sectors("h4")
    tabs = ts.device_tables(torch.float64, device="cpu")
    pa, pb = gate_scan._index32(tabs)
    assert pa.dtype == pb.dtype == torch.int32
    assert gate_scan._index32(tabs)[0] is pa
    assert torch.equal(pa.long(), tabs["PA"]) and torch.equal(pb.long(),
                                                              tabs["PB"])
