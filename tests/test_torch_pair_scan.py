"""The pairs gate scan (esoo_torch/ops/pair_scan.py, csrc/pair_scan.cu) on
the CPU against the JAX package's `sector._apply_rev` (a custom_vjp over
the lax.scan of `_apply_gates_tabled`, with its reversible backward), on
the PARTNER/SFIELD tables of UCCSD at H2 (2, (1, 1)), H4 (4, (2, 2)), a
synthetic n = 6, (3, 2) sector (nd + 1 = 301) and n = 7, (3, 3) (nd + 1
= 1,226, three amplitudes a thread at the kernel's 512 threads).  Inputs
are seeded numpy arrays; every fifth theta is exactly 0.  Tolerance:
1e-12 * max(1, max|ref|) at float64, values and VJP; the two packages
round the update and sum dtheta in different orders.

The CUDA kernels run only on the card (tests/test_torch_cuda.py).  Here
(a) `pair_scan.apply_rev_pairs` on CPU tensors runs the plain
sim/sector.py::_ApplyRev, and a tensor elsewhere raises rather than
taking it; (b) `_emulate_fwd`/`_emulate_bwd` repeat the kernels'
arithmetic in their order: per gate, ce = 1 + (c - 1)|S| and S s formed
per amplitude, the update read from one ping-pong buffer and written to
the other, the backward's inverse rotation of v and its partner, and
dtheta summed per thread over its amplitudes (i = tid, tid + T, ...) in
order, then by the warps' __shfl_down_sync trees (offsets 16 .. 1) and
warp 0's tree over the warp sums, at the kernel's block size T = _plan's
"threads"; (c) `_plan` against the constants of csrc/pair_scan.cu."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from esoo_tpu.sim import sector as JS
from esoo_torch.ops import pair_scan
from esoo_torch.sim import HartreeFock, UCCSD
from esoo_torch.sim import sector as TS
from test_torch_gate_scan import _block_sum  # the kernels' dtheta tree

jax.config.update("jax_enable_x64", True)

CASES = {"h2": (2, (1, 1)), "h4": (4, (2, 2)), "n6_32": (6, (3, 2)),
         "n7_33": (7, (3, 3))}
TOL = 1e-12
_SECTORS = {}
_REFS = {}


def _sectors(case):
    """The JAX and the port's pairs sectors of the case."""
    if case not in _SECTORS:
        n, parts = CASES[case]
        js = JS.SectorUCC(JUCCSD(n, parts, initial_state=JHF(n, parts)),
                          2 * n, kernel="pairs")
        ts = TS.SectorUCC(UCCSD(n, parts, initial_state=HartreeFock(n, parts)),
                          2 * n, kernel="pairs")
        _SECTORS[case] = js, ts
    return _SECTORS[case]


def _tables(case):
    """PARTNER (int64) and SFIELD (float64) as CPU tensors."""
    _, ts = _sectors(case)
    return torch.as_tensor(ts._PARTNER), torch.as_tensor(ts._SFIELD)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL * scale)


def _inputs(ts, batch, seed):
    """theta (every fifth one exactly 0), padded states v0 (zero pad slot)
    and a cotangent, shape (nd + 1,) or (batch, nd + 1)."""
    rng = np.random.default_rng(seed)
    K = len(ts._excs)
    th = rng.normal(size=K) * 0.4
    th[::5] = 0.0
    shape = (ts.dim + 1,) if batch is None else (batch, ts.dim + 1)
    v0 = rng.normal(size=shape)
    v0[..., -1] = 0.0
    v0 /= np.linalg.norm(v0, axis=-1, keepdims=True)
    return th, v0, rng.normal(size=shape)


def _reference(case, batch):
    """The seeded inputs and the JAX package's _apply_rev and its VJP on
    them (states vmapped over a batch; dtheta sums over it)."""
    if (case, batch) not in _REFS:
        js, ts = _sectors(case)
        th, v0, ct = _inputs(ts, batch, seed=11)
        P, S = jnp.asarray(js._PARTNER), jnp.asarray(js._SFIELD)

        def f(v, t):
            one = lambda x: JS._apply_rev(x, t, P, S)
            return one(v) if v.ndim == 1 else jax.vmap(one)(v)

        out, vjp = jax.vjp(f, jnp.asarray(v0), jnp.asarray(th))
        dv0, dth = vjp(jnp.asarray(ct))
        _REFS[case, batch] = (th, v0, ct), tuple(
            np.asarray(a) for a in (out, dv0, dth))
    return _REFS[case, batch]


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


# -- (b) the kernels' arithmetic in their order -------------------------------

def _gate(P, S, k, c, s):
    """Gate k's per-amplitude terms as the kernel forms them: partner,
    S, |S|, ce = 1 + (c - 1)|S| and S s."""
    sg = S[k]
    touched = sg.abs()
    return P.to(torch.int32)[k].long(), sg, touched, \
        1.0 + (c[k] - 1.0) * touched, sg * s[k]


def _emulate_fwd(v0, c, s, P, S):
    cur = v0.clone()
    for k in range(c.shape[0]):
        p, _, _, ce, sf = _gate(P, S, k, c, s)
        cur = ce * cur + sf * cur[:, p]          # into the other buffer
    return cur


def _emulate_bwd(v, w, c, s, P, S):
    B, n = v.shape
    threads = pair_scan._plan(n, v.dtype)["threads"]
    vc, wc = v.clone(), w.clone()
    dth = torch.zeros(B, c.shape[0], dtype=v.dtype)
    for k in reversed(range(c.shape[0])):
        p, sg, touched, ce, sf = _gate(P, S, k, c, s)
        vk, pvk, wk, pw = vc, vc[:, p], wc, wc[:, p]
        vprev = ce * vk - sf * pvk
        pvprev = ce * pvk + sf * vk
        term = wk * ((-s[k] * touched) * vprev + (sg * c[k]) * pvprev)
        dth[:, k] = _block_sum(term, threads)
        vc, wc = vprev, ce * wk - sf * pw
    return wc, dth


# -- (a) the plain route of apply_rev_pairs -----------------------------------

@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", ["h2", "h4", "n6_32"])
def test_plain_route_matches_jax(case, batch):
    (th, v0, ct), (out_ref, dv0_ref, dth_ref) = _reference(case, batch)
    P, S = _tables(case)
    pair_scan.reset_launch_counts()
    v, t = _t(v0).requires_grad_(), _t(th).requires_grad_()
    out = pair_scan.apply_rev_pairs(v, t, P, S)
    torch.autograd.backward(out, _t(ct))
    assert pair_scan.launch_counts()["pair_scan.apply_rev_pairs"] == 0
    _close(out.detach(), out_ref)
    _close(v.grad, dv0_ref)
    _close(t.grad, dth_ref)


def test_tables_equal_the_jax_packages():
    for case in ("h4", "n6_32"):
        js, ts = _sectors(case)
        np.testing.assert_array_equal(ts._PARTNER, js._PARTNER)
        np.testing.assert_array_equal(ts._SFIELD, js._SFIELD)


def test_sector_apply_takes_the_wrapper():
    """SectorUCC(kernel='pairs').apply on the CPU: the wrapper's plain
    route, the JAX sector's state to 1e-12."""
    js, ts = _sectors("h4")
    th, v0, _ = _inputs(ts, None, seed=3)
    tabs = ts.device_tables(torch.float64, device="cpu")
    ref = js.apply(jnp.asarray(v0), jnp.asarray(th))
    _close(ts.apply(_t(v0), _t(th), tabs), ref)
    _close(pair_scan.apply_rev_pairs(_t(v0), _t(th), tabs["PARTNER"],
                                     tabs["SFIELD"]), ref)


def test_a_zero_angle_scan_is_the_identity():
    """Gates at theta = 0 leave the state bit for bit, on the plain route
    and in the kernel's arithmetic."""
    _, ts = _sectors("n6_32")
    _, v0, _ = _inputs(ts, 2, seed=5)
    P, S = _tables("n6_32")
    th = torch.zeros(len(ts._excs), dtype=torch.float64)
    v0 = _t(v0)
    assert torch.equal(pair_scan.apply_rev_pairs(v0, th, P, S), v0)
    assert torch.equal(_emulate_fwd(v0, torch.cos(th), torch.sin(th), P, S),
                       v0)


def test_a_device_without_kernels_raises(monkeypatch):
    """A tensor neither on the CPU nor on the card is refused, not sent to
    the plain version; past the device check a kernel that fails to build
    raises (no fallback)."""
    _, ts = _sectors("h2")
    P, S = _tables("h2")
    meta = dict(dtype=torch.float64, device="meta")
    v0 = torch.zeros(ts.dim + 1, **meta)
    th = torch.zeros(len(ts._excs), **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        pair_scan.apply_rev_pairs(v0, th, P, S)

    def no_nvcc():
        raise RuntimeError("nvcc failed on csrc/pair_scan.cu")

    monkeypatch.setattr(pair_scan, "_check", lambda *args: None)
    monkeypatch.setattr(pair_scan, "_lib", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        pair_scan.apply_rev_pairs(v0, th, P.to("meta"), S.to("meta"))


# -- (b) the kernels' emulation -----------------------------------------------

@pytest.mark.parametrize("case,batch", [("h4", None), ("h4", 2),
                                        ("n6_32", None), ("n6_32", 2),
                                        ("n7_33", None)])
def test_kernel_emulation_matches_jax(case, batch):
    (th, v0, ct), (out_ref, dv0_ref, dth_ref) = _reference(case, batch)
    P, S = _tables(case)
    theta = _t(th)
    c, s = torch.cos(theta), torch.sin(theta)
    n = v0.shape[-1]
    out = _emulate_fwd(_t(v0).reshape(-1, n), c, s, P, S)
    w0, dth = _emulate_bwd(out, _t(ct).reshape(-1, n), c, s, P, S)
    _close(out.reshape(out_ref.shape), out_ref)
    _close(w0.reshape(dv0_ref.shape), dv0_ref)
    _close(dth.sum(0), dth_ref)


# -- (c) the route plan against the kernel's constants ------------------------

def _kernel_constants():
    path = os.path.join(os.path.dirname(pair_scan.__file__), "..", "csrc",
                        "pair_scan.cu")
    with open(path) as f:
        src = f.read()
    return {name: int(v) for name, v in re.findall(
        r"constexpr (?:int|size_t) (k\w+) = (\d+);", src)}


def test_plan_mirrors_the_kernel_constants():
    k = _kernel_constants()
    assert k["kMaxThreads"] == pair_scan._MAX_THREADS
    assert k["kMaxSmem"] == pair_scan._SMEM_LIMIT
    assert k["kFwdBuffers"] == pair_scan._FWD_BUFFERS
    assert k["kBwdBuffers"] == pair_scan._BWD_BUFFERS
    assert [pair_scan._threads(n) for n in (1, 5, 37, 226, 512, 4901)] == \
        [32, 32, 64, 256, 512, 512]


@pytest.mark.parametrize("n,dtype,fwd,bwd", [
    (226, torch.float32, "smem", "smem"),          # H8 -> 12
    (4901, torch.float64, "smem", "smem"),         # H8 -> 16
    (15877, torch.float32, "smem", "global"),      # n = 9, (4, 4)
    (15877, torch.float64, "global", "global"),
    (44101, torch.float32, "global", "global"),    # H8 -> 20
])
def test_plan_routes(n, dtype, fwd, bwd):
    item = 4 if dtype == torch.float32 else 8
    plan = pair_scan._plan(n, dtype)
    for direction, route, bufs in (("fwd", fwd, 2), ("bwd", bwd, 4)):
        got = plan[direction]
        assert got["route"] == route
        state = bufs * n if route == "smem" else 0
        assert got["smem"] == item * (state + 32) <= 232448
    if n == 4901:
        assert plan["bwd"]["smem"] == 157088            # 153 KB of state


def test_plan_refuses_what_neither_route_takes():
    with pytest.raises(ValueError, match="no route"):
        pair_scan._plan(2 ** 29, torch.float32)
    with pytest.raises(TypeError):
        pair_scan._plan(226, torch.float16)


def test_partner_cached_once_per_tables_dict():
    P, _ = _tables("h4")
    p32 = pair_scan._index32(P)
    assert p32.dtype == torch.int32
    assert pair_scan._index32(P) is p32
    assert torch.equal(p32.long(), P)
