"""The string gate scan K3 (esoo_torch/ops/gate_scan.py, csrc/gate_scan.cu)
on the CPU against the JAX package's `strings.apply_gates`
(`_apply_rev_str`, a custom_vjp over lax.scan with its reversible
backward), on the sector tables of UCCSD at H2 (2, (1, 1)), H4 (4, (2, 2),
the H4 6-31G -> 8 ansatz), synthetic n = 6 sectors at (3, 2) (nA = 20 !=
nB = 15) and (3, 3), and at n = 7, (3, 3) for the emulation's
multi-pair threads (up to 525 pairs a gate > 512 threads).  Inputs are
seeded numpy arrays; some theta are exactly 0 (ADAPT's padded slots).
Tolerance: 1e-12 * max(1, max|ref|) at float64, values and VJP; the two
packages round the update and sum dtheta in different orders.

The CUDA kernels run only on the card (tests/test_torch_cuda.py).  Here
(a) `gate_scan.apply_rev_str` on CPU tensors runs the plain
sim/strings.py::_ApplyRevStr; (b) `_emulate_fwd`/`_emulate_bwd` repeat
the kernels' schedule and arithmetic: per gate, only its touched pairs,
d = (DB[p / |DA|], DA[p % |DA|]) and its partner r = (QB, QA) from the
compressed lists of sim/strings.py::gate_lists, updated in place with
the plain version's expression at m = 1 and sigma = -fA fB at d, +fA fB
at r; dtheta summed per thread over its pairs (p = tid, tid + T, ...;
d's term, then r's) in order, then by the warps' __shfl_down_sync trees
(offsets 16 .. 1) and warp 0's tree over the warp sums, at the kernel's
block size T = _plan's "threads"; the lists rebuild every factored
table; (c) `_plan` and `records` against the constants and record layout
of csrc/gate_scan.cu."""

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
from esoo_torch.ops import gate_scan, launch_counts, reset_launch_counts
from esoo_torch.sim import HartreeFock, UCCSD
from esoo_torch.sim import strings as TS
from esoo_torch.sim.sector import SectorUCC

jax.config.update("jax_enable_x64", True)

CASES = {"h2": (2, (1, 1)), "h4": (4, (2, 2)), "n6_32": (6, (3, 2)),
         "n6_33": (6, (3, 3)), "n7_33": (7, (3, 3))}
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

def _pairs(lists, k, nA, dtype):
    """Gate k's touched pairs as the kernel forms them from its record:
    the flat indices of d = (DB[j], DA[i]) and r = (QB[j], QA[i]) for
    p = j |DA| + i, and fA(DA[i]) fB(DB[j]) (sigma at r; -sigma at d)."""
    nda, ndb = int(lists["NDA"][k]), int(lists["NDB"][k])
    p = torch.arange(nda * ndb)
    j, i = p // nda, p % nda
    da, qa, fa = (torch.as_tensor(lists[key][k, :nda]).long()
                  for key in ("DA", "QA", "FA"))
    db, qb, fb = (torch.as_tensor(lists[key][k, :ndb]).long()
                  for key in ("DB", "QB", "FB"))
    return db[j] * nA + da[i], qb[j] * nA + qa[i], \
        (fa[i] * fb[j]).to(dtype)


def _emulate_fwd(V0, c, s, tabs):
    B, nB, nA = V0.shape
    lists = TS.gate_lists(tabs)
    V = V0.reshape(B, nB * nA).clone()
    for k in range(c.shape[0]):
        ed, er, f = _pairs(lists, k, nA, V.dtype)
        cm1 = c[k] - 1.0
        vd, vr = V[:, ed], V[:, er]                   # in place, one buffer
        V[:, ed] = vd + cm1 * vd + s[k] * (-f * vr)
        V[:, er] = vr + cm1 * vr + s[k] * (f * vd)
    return V.reshape(B, nB, nA)


def _warp_tree(x):
    """Lane 0 of __shfl_down_sync with offsets 16, 8, 4, 2, 1 over the
    last axis (32 lanes)."""
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


def _threads_tree(acc):
    """The per-thread sums acc (B, threads) reduced as the kernels do:
    each warp's tree, then warp 0's tree over the warp sums (lanes past
    the last warp hold 0)."""
    B, threads = acc.shape
    warps = _warp_tree(acc.reshape(B, threads // 32, 32))
    lanes = torch.zeros(B, 32, dtype=acc.dtype)
    lanes[:, :warps.shape[1]] = warps
    return _warp_tree(lanes)


def _per_thread(x, threads):
    """x (B, n) as (B, J, threads): thread t's items t, t + T, ... in
    order, zero past n."""
    B, n = x.shape
    J = -(-n // threads)
    xs = torch.zeros(B, J * threads, dtype=x.dtype)
    xs[:, :n] = x
    return xs.reshape(B, J, threads)


def _block_sum(x, threads):
    """The kernel's reduction of x (B, n) over items: thread t sums its
    items t, t + T, ... in order; each warp's tree; warp 0's tree over
    the warp sums."""
    xs = _per_thread(x, threads)
    acc = torch.zeros(x.shape[0], threads, dtype=x.dtype)
    for j in range(xs.shape[1]):
        acc = acc + xs[:, j]
    return _threads_tree(acc)


def _pair_thread_sums(a, b, threads):
    """Each thread's sum over pairs (B, threads): thread t adds, for each
    of its pairs p = t, t + T, ... in order, a[p] and then b[p] (the
    pair's two terms)."""
    pa, pb = _per_thread(a, threads), _per_thread(b, threads)
    acc = torch.zeros(a.shape[0], threads, dtype=a.dtype)
    for j in range(pa.shape[1]):
        acc = acc + pa[:, j]
        acc = acc + pb[:, j]
    return acc


def _pair_block_sum(a, b, threads):
    """The gate scan's reduction over pairs: each thread's sum, then the
    warps' trees."""
    return _threads_tree(_pair_thread_sums(a, b, threads))


def _emulate_bwd(V, W, c, s, tabs):
    B, nB, nA = V.shape
    threads = gate_scan._plan(nB, nA, V.dtype)["threads"]
    lists = TS.gate_lists(tabs)
    vc, wc = V.reshape(B, -1).clone(), W.reshape(B, -1).clone()
    dth = torch.zeros(B, c.shape[0], dtype=V.dtype)
    for k in reversed(range(c.shape[0])):
        ed, er, f = _pairs(lists, k, nA, V.dtype)
        ck, sk, cm1 = c[k], s[k], c[k] - 1.0
        sd, sr = -f, f
        vd, vr, wd, wr = vc[:, ed], vc[:, er], wc[:, ed], wc[:, er]
        pd = vd + cm1 * vd - sk * (sd * vr)
        pr = vr + cm1 * vr - sk * (sr * vd)
        dth[:, k] = _pair_block_sum(wd * (-sk * pd + ck * (sd * pr)),
                                    wr * (-sk * pr + ck * (sr * pd)),
                                    threads)
        vc[:, ed], vc[:, er] = pd, pr
        wc[:, ed] = wd + cm1 * wd - sk * (sd * wr)
        wc[:, er] = wr + cm1 * wr - sk * (sr * wd)
    return wc.reshape(B, nB, nA), dth


# -- (a) the plain route of apply_rev_str ---------------------------------------

@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", ["h2", "h4", "n6_32"])
def test_plain_route_matches_jax(case, batch):
    _, ts = _sectors(case)
    (th, V0, ct), (V_ref, dV0_ref, dth_ref) = _reference(case, batch)
    tabs = ts.device_tables(torch.float64, device="cpu")
    reset_launch_counts()
    v, t = _t(V0).requires_grad_(), _t(th).requires_grad_()
    out = gate_scan.apply_rev_str(v, t, tabs)
    torch.autograd.backward(out, _t(ct))
    assert launch_counts() == {}
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
                                        ("n7_33", None), ("n6_33", None),
                                        ("n6_33", 2)])
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


@pytest.mark.parametrize("case,batch", [("h4", None), ("h4", 2),
                                        ("n6_33", 2), ("n7_33", None)])
def test_touched_pairs_emulation_matches_the_plain_scan(case, batch):
    """The touched-pairs, in-place schedule against the port's plain
    _ApplyRevStr (the CPU route of apply_rev_str) on the same inputs:
    values, the reversible backward's cotangent and dtheta."""
    _, ts = _sectors(case)
    (th, V0, ct), _ = _reference(case, batch)
    tabs = ts.device_tables(torch.float64, device="cpu")
    theta = _t(th)
    c, s = torch.cos(theta), torch.sin(theta)
    shape = (-1, ts.nB, ts.nA)
    V = _emulate_fwd(_t(V0).reshape(shape), c, s, tabs)
    W0, dth = _emulate_bwd(V, _t(ct).reshape(shape), c, s, tabs)
    v, t = _t(V0).requires_grad_(), theta.clone().requires_grad_()
    out = gate_scan.apply_rev_str(v, t, tabs)
    torch.autograd.backward(out, _t(ct))
    _close(V.reshape(out.shape), out.detach())
    _close(W0.reshape(v.grad.shape), v.grad)
    _close(dth.sum(0), t.grad)


def test_untouched_elements_are_never_read():
    """A gate reads and writes only its pairs: for each gate alone, NaN
    planted on every element it does not touch stays there, exactly, and
    reaches nothing else, forward and backward; every element it touches
    belongs to exactly one of its pairs."""
    _, ts = _sectors("n6_33")
    tabs = ts.device_tables(torch.float64, device="cpu")
    nd = ts.nB * ts.nA
    th, V0, ct = _inputs(ts, 2, seed=7)
    for k in (0, 9, len(ts._excs) - 1):            # singles and a double
        one = {key: tabs[key][k:k + 1] for key in (
            "PA", "PB", "AD", "AR", "UD", "UR", "BD", "BR", "VD", "VR")}
        ed, er, _ = _pairs(TS.gate_lists(one), 0, ts.nA, torch.float64)
        both = torch.cat([ed, er])
        assert len(torch.unique(both)) == len(both) < nd
        touched = torch.zeros(nd, dtype=torch.bool)
        touched[both] = True
        v0, w = _t(V0).reshape(2, nd), _t(ct).reshape(2, nd)
        v0[:, ~touched] = float("nan")
        w[:, ~touched] = float("nan")
        theta = _t(th[k:k + 1] + 0.3)
        c, s = torch.cos(theta), torch.sin(theta)
        shape = (2, ts.nB, ts.nA)
        V = _emulate_fwd(v0.reshape(shape), c, s, one)
        W0, dth = _emulate_bwd(V, w.reshape(shape), c, s, one)
        for out in (V.reshape(2, nd), W0.reshape(2, nd)):
            assert torch.isnan(out[:, ~touched]).all()
            assert torch.isfinite(out[:, touched]).all()
        assert torch.isfinite(dth).all()


@pytest.mark.parametrize("case", ["h2", "h4", "n6_32", "n6_33", "n7_33"])
def test_gate_lists_rebuild_the_factored_tables(case):
    """strings.gate_lists' compressed domains rebuild PA PB AD AR UD UR BD
    BR VD VR exactly: the partner maps the identity but on dom and ran
    (P[dom] = Q, P[Q] = dom), the masks 1 on dom and on Q, the sign
    factors F on dom and mirrored on Q; the JAX package's tables too."""
    js, ts = _sectors(case)
    for host in (ts._str_tabs._asdict(), js._str_tabs._asdict()):
        lists = TS.gate_lists(host)
        K = len(ts._excs)
        rebuilt = {key: np.zeros((K, n)) for key, n in (
            ("AD", ts.nA), ("AR", ts.nA), ("UD", ts.nA), ("UR", ts.nA),
            ("BD", ts.nB), ("BR", ts.nB), ("VD", ts.nB), ("VR", ts.nB))}
        rebuilt["PA"] = np.tile(np.arange(ts.nA), (K, 1))
        rebuilt["PB"] = np.tile(np.arange(ts.nB), (K, 1))
        for side, (P, D, R, U, W) in (("A", ("PA", "AD", "AR", "UD", "UR")),
                                      ("B", ("PB", "BD", "BR", "VD", "VR"))):
            for k in range(K):
                n = int(lists["ND" + side][k])
                d, q, f = (lists[key + side][k, :n] for key in "DQF")
                assert np.all(np.diff(d) > 0) and set(f) <= {-1, 1}
                rebuilt[P][k, d], rebuilt[P][k, q] = q, d
                rebuilt[D][k, d], rebuilt[R][k, q] = 1.0, 1.0
                rebuilt[U][k, d], rebuilt[W][k, q] = f, f
                assert not any(lists[key + side][k, n:].any()
                               for key in "DQF")
        for key, want in rebuilt.items():
            assert np.array_equal(np.asarray(host[key]), want), key


def test_records_pack_the_lists():
    """gate_scan.records: one int32 row a gate, [nda, ndb, LA, LB, 1 / nda
    (float32 bits), 0, 0, 0 | DA | QA | FA | DB | QB | FB | 0 ...], the
    sign factors as sign bits, 16-byte rows (the kernel's bulk copies);
    at H8 -> 16 (nA = nB = 70, 360 gates) LA = LB = 70 (a beta excitation
    leaves every alpha string in its domain), 428 words."""
    _, ts = _sectors("h4")
    lists = TS.gate_lists(ts._str_tabs._asdict())
    rec = gate_scan.records(lists)
    K, LA = lists["DA"].shape
    LB = lists["DB"].shape[1]
    assert rec.dtype == np.int32 and rec.shape == (K, gate_scan._words(LA, LB))
    assert rec.shape[1] % 4 == 0 and gate_scan._HEADER == 8
    assert np.array_equal(rec[:, 0], lists["NDA"])
    assert np.array_equal(rec[:, 1], lists["NDB"])
    assert np.all(rec[:, 2] == LA) and np.all(rec[:, 3] == LB)
    assert np.array_equal(rec[:, 4].view(np.float32),
                          np.float32(1) / lists["NDA"].astype(np.float32))
    assert not rec[:, 5:8].any()
    at = 8
    for key, width in (("DA", LA), ("QA", LA), ("FA", LA), ("DB", LB),
                       ("QB", LB), ("FB", LB)):
        want = lists[key]
        if key[0] == "F":       # +1 -> 0, -1 -> the sign bit, padding 0
            want = np.where(want < 0, np.int32(-2 ** 31), np.int32(0))
        assert np.array_equal(rec[:, at:at + width], want)
        at += width
    assert not rec[:, at:].any()
    assert gate_scan._words(70, 70) == 428


def test_pair_walk_of_the_records():
    """The kernel's walk over a gate's pairs p = t, t + T, ... takes j =
    floor(p / nda) and i = p - j nda from the record's float32 1 / nda,
    (p + 1/2) * (1 / nda) truncated, then steps by T without a division:
    exact for every domain size the kernel meets and every thread of a
    512-thread block (here in float32, as the card rounds it)."""
    for nda in range(1, 4097):
        rinv = np.float32(1) / np.float32(nda)
        t = np.arange(513, dtype=np.float32)
        j = ((t + np.float32(0.5)) * rinv).astype(np.int64)
        assert np.array_equal(j, np.arange(513) // nda), nda


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
    assert k["kFwdBuffers"] == gate_scan._FWD_BUFFERS == 1
    assert k["kBwdBuffers"] == gate_scan._BWD_BUFFERS == 2
    assert k["kMaxStages"] == gate_scan._MAX_STAGES
    assert k["kMinStages"] == gate_scan._MIN_STAGES
    assert k["kHeader"] == gate_scan._HEADER
    assert [gate_scan._threads(nd) for nd in (1, 4, 36, 300, 512, 4900)] == \
        [32, 32, 64, 320, 512, 512]


@pytest.mark.parametrize("shape,dtype,fwd,bwd", [
    ((6, 6), torch.float32, "smem", "smem"),            # H4
    ((70, 70), torch.float32, "smem", "smem"),          # H8 -> 16
    ((70, 70), torch.float64, "smem", "smem"),
    ((126, 126), torch.float32, "smem", "smem"),        # n = 9, (4, 4)
    ((126, 126), torch.float64, "smem", "global"),
])
def test_plan_routes(shape, dtype, fwd, bwd):
    """One state buffer forward and two backward (in place), beside a ring
    of 32 records (at their widest here) and the dtheta warp sums: n = 9
    at (4, 4) (nd = 15,876) takes shared memory at float32 both ways
    (63.5 KB and 127 KB of state) and forward at float64."""
    nB, nA = shape
    item = 4 if dtype == torch.float32 else 8
    plan = gate_scan._plan(nB, nA, dtype)
    words = plan["words"]
    assert words == -(-(8 + 3 * (nA + nB)) // 4) * 4
    for direction, route, bufs in (("fwd", fwd, 1), ("bwd", bwd, 2)):
        got = plan[direction]
        assert got["route"] == route and got["stages"] == 32
        state = bufs * nA * nB if route == "smem" else 0
        assert got["smem"] == 4 * words * 32 + 8 * 32 + \
            item * (state + 32) <= 232448
    if shape == (70, 70) and dtype == torch.float64:
        assert plan["bwd"]["smem"] == 4 * 428 * 32 + 256 + 8 * 9832


def test_plan_ring_depth_from_the_records():
    """All of H4's 26 records staged at the start; H8 -> 16's 360 in a
    ring of 32; a gate count under kMinStages stages every record; a
    record too wide for the ring beside the state moves the state to
    device memory."""
    plan = gate_scan._plan(6, 6, torch.float32, 26, 40)
    assert plan["fwd"]["stages"] == plan["bwd"]["stages"] == 26
    plan = gate_scan._plan(70, 70, torch.float32, 360, 428)
    assert plan["fwd"]["stages"] == plan["bwd"]["stages"] == 32
    assert plan["fwd"]["route"] == plan["bwd"]["route"] == "smem"
    plan = gate_scan._plan(6, 6, torch.float64, 3, 40)
    assert plan["fwd"]["stages"] == 3
    plan = gate_scan._plan(126, 126, torch.float32, 560, 10000)
    assert plan["fwd"]["route"] == "smem" and plan["fwd"]["stages"] == 4
    assert plan["bwd"]["route"] == "global" and plan["bwd"]["stages"] == 5


def test_plan_refuses_what_neither_route_takes():
    """n = 14 at (7, 7): 3,432 strings a spin; a ring of kMinStages
    records at their widest exceeds a block's shared memory."""
    for dtype in (torch.float32, torch.float64):
        with pytest.raises(ValueError, match="no route"):
            gate_scan._plan(3432, 3432, dtype)
    with pytest.raises(TypeError):
        gate_scan._plan(6, 6, torch.float16)


def test_partner_maps_cached_once_per_tables_dict():
    """Off the CPU the tables dict (cached per dtype and device) carries
    the gate records "GREC" (int32, built once with it), which hold the
    partner maps at each domain: PA[k, DA] and PB[k, DB]; the CPU tables
    keep the plain scan's fields instead."""
    _, ts = _sectors("h4")
    tabs = ts.device_tables(torch.float64, device="meta")
    assert ts.device_tables(torch.float64, device="meta") is tabs
    K = len(ts._excs)
    host = ts._str_tabs._asdict()
    rec = gate_scan.records(TS.gate_lists(host))
    assert tabs["GREC"].dtype == torch.int32
    assert tuple(tabs["GREC"].shape) == rec.shape and rec.shape[0] == K
    assert "M" not in tabs and "GREC" not in ts.device_tables(
        torch.float64, device="cpu")
    LA, LB = int(rec[0, 2]), int(rec[0, 3])
    h = gate_scan._HEADER
    for k in range(K):
        nda, ndb = rec[k, :2]
        da, qa = rec[k, h:h + nda], rec[k, h + LA:h + LA + nda]
        db = rec[k, h + 3 * LA:h + 3 * LA + ndb]
        qb = rec[k, h + 3 * LA + LB:h + 3 * LA + LB + ndb]
        assert np.array_equal(qa, host["PA"][k, da])
        assert np.array_equal(qb, host["PB"][k, db])
