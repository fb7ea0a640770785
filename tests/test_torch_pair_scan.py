"""The pairs gate scan (esoo_torch/ops/pair_scan.py, csrc/pair_scan.cu) on
the CPU against the JAX package's `sector._apply_rev` (a custom_vjp over
the lax.scan of `_apply_gates_tabled`, with its reversible backward), on
the PARTNER/SFIELD tables of UCCSD at H2 (2, (1, 1)), H4 (4, (2, 2)), a
synthetic n = 6, (3, 2) sector (nd + 1 = 301) and n = 7, (3, 3) (nd + 1
= 1,226, gates of up to 525 pairs: two a thread at the kernel's 512
threads).  Inputs are seeded numpy arrays; every fifth theta is exactly
0.  Tolerance: 1e-12 * max(1, max|ref|) at float64, values and VJP; the
two packages round the update and sum dtheta in different orders.

The CUDA kernels run only on the card (tests/test_torch_cuda.py).  Here
(a) `pair_scan.apply_rev_pairs` on CPU tensors runs the plain
sim/sector.py::_ApplyRev, and a tensor elsewhere raises rather than
taking it; (b) `_emulate_fwd`/`_emulate_bwd` repeat the kernels'
schedule and arithmetic: per gate, only its touched pairs (lo < hi =
PARTNER[k, lo] from `pair_scan.pair_lists`, which equal the sector's own
pair lists), updated in place with ce = 1 + (c - 1) and S s = sigma s at
lo and -sigma s at hi, the backward's inverse rotation of both ends, and
dtheta summed per thread over its pairs (p = tid, tid + T, ...; lo's term,
then hi's) in order, then by the warps' __shfl_down_sync trees (offsets
16 .. 1) and warp 0's tree over the warp sums, at the kernel's block size
T = _plan's "threads" (from the largest gate); `_ring_walk` repeats the
ring of record chunks (issue, wait, refill, the record's slot) forward
and backward; (c) `_plan` and `records` against the constants and record
layout of csrc/pair_scan.cu."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esoo_tpu.sim import HartreeFock as JHF, UCCSD as JUCCSD
from esoo_tpu.sim import sector as JS
from esoo_torch.ops import (_build, launch_counts, pair_scan,
                            reset_launch_counts)
from esoo_torch.sim import HartreeFock, UCCSD
from esoo_torch.sim import sector as TS
from test_torch_gate_scan import _pair_block_sum  # the dtheta tree

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

def _gates(P, S):
    """Each gate's pairs as the kernel reads them from its records: lo,
    hi and sigma = SFIELD[k, lo] (a sign bit in the record)."""
    lists = pair_scan.pair_lists(P, S)
    off = lists["off"].tolist()
    sigma = 1.0 - 2.0 * lists["neg"].double()
    return [(lists["lo"][a:b], lists["hi"][a:b], sigma[a:b])
            for a, b in zip(off[:-1], off[1:])], lists


def _threads(lists):
    return pair_scan._threads(int(torch.diff(lists["off"]).max()))


def _emulate_fwd(v0, c, s, P, S):
    V = v0.clone()
    for k, (lo, hi, sigma) in enumerate(_gates(P, S)[0]):
        ce, sf = 1.0 + (c[k] - 1.0), sigma.to(V.dtype) * s[k]
        vl, vh = V[:, lo], V[:, hi]                   # in place, one buffer
        V[:, lo] = ce * vl + sf * vh
        V[:, hi] = ce * vh - sf * vl
    return V


def _emulate_bwd(v, w, c, s, P, S):
    gates, lists = _gates(P, S)
    threads = _threads(lists)
    V, W = v.clone(), w.clone()
    dth = torch.zeros(v.shape[0], c.shape[0], dtype=v.dtype)
    for k in reversed(range(c.shape[0])):
        lo, hi, sigma = gates[k]
        sigma = sigma.to(v.dtype)
        ce, sf, cf = 1.0 + (c[k] - 1.0), sigma * s[k], sigma * c[k]
        vl, vh, wl, wh = V[:, lo], V[:, hi], W[:, lo], W[:, hi]
        pl = ce * vl - sf * vh
        ph = ce * vh + sf * vl
        dth[:, k] = _pair_block_sum(wl * (-s[k] * pl + cf * ph),
                                    wh * (-s[k] * ph - cf * pl), threads)
        V[:, lo], V[:, hi] = pl, ph
        W[:, lo] = ce * wl - sf * wh
        W[:, hi] = ce * wh + sf * wl
    return W, dth


def _ring_walk(off, log_chunk, chunks, stages, reverse, stream):
    """The kernel's ring (csrc/pair_scan.cu Ring), thread 0 and one
    waiting thread in step: chunks issued in sequence into stage q %
    stages, each gate waits for its chunks, reads each record from the
    slot `at` computes, and after the gate's barrier thread 0 refills
    every stage whose chunk lies before the next record.  Asserts that a
    gate's chunks are issued before it waits, that no stage is refilled
    while a chunk in it may still be read, and that every record read is
    the stream's; returns the records read, gate by gate."""
    K, C = len(off) - 1, 1 << log_chunk
    total = off[-1]
    ring = [None] * (stages * C)
    held = [None] * stages                       # the chunk a stage holds

    def seq(pos):
        c = pos >> log_chunk
        return chunks - 1 - c if reverse else c

    def issue(q):
        c = chunks - 1 - q if reverse else q
        st = q & (stages - 1)
        assert held[st] is None or held[st] < need, "refilled while needed"
        held[st] = q
        ring[st * C:(st + 1) * C] = stream[c * C:(c + 1) * C]

    need = 0
    issued = min(stages, chunks)
    for q in range(issued):
        issue(q)
    ready, read = -1, []
    for step in range(K):
        k = K - 1 - step if reverse else step
        a, b = off[k], off[k + 1]
        if b > a:
            last = seq(a) if reverse else seq(b - 1)
            assert last < issued, "a gate waits for a chunk never issued"
            ready = max(ready, last)
        got = []
        for p in range(a, b):
            q = seq(p)
            assert q <= ready and held[q & (stages - 1)] == q
            got.append(ring[((q & (stages - 1)) << log_chunk) | (p & (C - 1))])
        read.append(got)
        nxt = (a - 1 if a > 0 else None) if reverse else \
            (b if b < total else None)
        need = chunks if nxt is None else seq(nxt)
        while issued < min(need + stages, chunks):
            issue(issued)
            issued += 1
    assert ready == chunks - 1 or total == 0
    return read


# -- (a) the plain route of apply_rev_pairs -----------------------------------

@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("case", ["h2", "h4", "n6_32"])
def test_plain_route_matches_jax(case, batch):
    (th, v0, ct), (out_ref, dv0_ref, dth_ref) = _reference(case, batch)
    P, S = _tables(case)
    reset_launch_counts()
    v, t = _t(v0).requires_grad_(), _t(th).requires_grad_()
    out = pair_scan.apply_rev_pairs(v, t, P, S)
    torch.autograd.backward(out, _t(ct))
    assert launch_counts() == {}
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

    def no_nvcc(name):
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu")

    monkeypatch.setattr(pair_scan, "_check", lambda *args: None)
    monkeypatch.setattr(_build, "load", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        # the tables on the CPU: their pair lists are read before the
        # launch loads the kernel
        pair_scan.apply_rev_pairs(v0, th, P, S)


# -- (b) the kernels' emulation -----------------------------------------------

@pytest.mark.parametrize("case,batch", [("h2", None), ("h2", 2),
                                        ("h4", None), ("h4", 2),
                                        ("n6_32", None), ("n6_32", 2),
                                        ("n7_33", None), ("n7_33", 2)])
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


@pytest.mark.parametrize("case", ["h2", "h4", "n6_32", "n7_33"])
def test_pair_lists_equal_the_sector_builds(case):
    """pair_lists of the dense tables are, gate by gate, the sector's own
    pair lists (SectorUCC._build_pair_lists of both packages: domain lo,
    range hi and the sign sg, SFIELD = -sg at lo and +sg at hi) taken as
    (min, max) in ascending order, with the sign of SFIELD at the smaller
    end; the offsets count them."""
    js, ts = _sectors(case)
    P, S = _tables(case)
    lists = pair_scan.pair_lists(P, S)
    off = lists["off"].tolist()
    assert off[0] == 0 and len(off) == len(ts._excs) + 1
    for built in (ts._build_pair_lists(), js._build_pair_lists()):
        for k, (lo, hi, sg) in enumerate(zip(*built)):
            lo, hi, sg = (np.asarray(a) for a in (lo, hi, sg))
            first = np.minimum(lo, hi)
            neg = np.where(lo < hi, -sg, sg) < 0      # SFIELD at first < 0
            order = np.argsort(first)
            a, b = off[k], off[k + 1]
            assert b - a == len(lo)
            np.testing.assert_array_equal(lists["lo"][a:b], first[order])
            np.testing.assert_array_equal(lists["hi"][a:b],
                                          np.maximum(lo, hi)[order])
            np.testing.assert_array_equal(lists["neg"][a:b], neg[order])
    # and the JAX package's dense tables give the same lists
    again = pair_scan.pair_lists(torch.as_tensor(np.asarray(js._PARTNER)),
                                 torch.as_tensor(np.asarray(js._SFIELD)))
    for key in ("off", "lo", "hi", "neg"):
        assert torch.equal(again[key], lists[key])


def test_records_pack_the_lists():
    """records: one int32 (lo, hi) row a pair, hi's sign bit set where
    SFIELD[k, lo] = -1, zero past the last pair to a multiple of 4,096
    records (the largest chunk; 16-byte chunks for the bulk copies)."""
    P, S = _tables("n7_33")
    lists = pair_scan.pair_lists(P, S)
    rec = pair_scan.records(lists)
    total = len(lists["lo"])
    assert rec.dtype == torch.int32 and rec.shape[1] == 2
    assert rec.shape[0] % 4096 == 0 and total <= rec.shape[0] < total + 4096
    assert torch.equal(rec[:total, 0].long(), lists["lo"])
    assert torch.equal((rec[:total, 1] & 0x7fffffff).long(), lists["hi"])
    assert torch.equal(rec[:total, 1] < 0, lists["neg"])
    assert not rec[total:].any()
    assert 0 < lists["neg"].sum() < total


def test_pair_lists_refuse_what_is_not_a_bank():
    P, S = _tables("h4")
    S = S.clone()
    S[3, int(torch.nonzero(S[3])[0])] *= -1.0      # one end's sign flipped
    with pytest.raises(ValueError, match="disjoint Givens"):
        pair_scan.pair_lists(P, S)


def test_untouched_amplitudes_are_never_read():
    """A gate reads and writes only its pairs: for each gate alone, NaN
    planted on every amplitude it does not touch stays there, exactly, and
    reaches nothing else, forward and backward; every amplitude it touches
    belongs to exactly one of its pairs."""
    _, ts = _sectors("n7_33")
    P, S = _tables("n7_33")
    th, v0, ct = _inputs(ts, 2, seed=7)
    n = ts.dim + 1
    for k in (0, 9, len(ts._excs) - 1):
        Pk, Sk = P[k:k + 1], S[k:k + 1]
        (lo, hi, _), = _gates(Pk, Sk)[0]
        both = torch.cat([lo, hi])
        assert len(torch.unique(both)) == len(both) < n
        touched = torch.zeros(n, dtype=torch.bool)
        touched[both] = True
        v, w = _t(v0), _t(ct)
        v[:, ~touched] = float("nan")
        w[:, ~touched] = float("nan")
        theta = _t(th[k:k + 1] + 0.3)
        c, s = torch.cos(theta), torch.sin(theta)
        out = _emulate_fwd(v, c, s, Pk, Sk)
        w0, dth = _emulate_bwd(out, w, c, s, Pk, Sk)
        for x in (out, w0):
            assert torch.isnan(x[:, ~touched]).all()
            assert torch.isfinite(x[:, touched]).all()
        assert torch.isfinite(dth).all()


def test_a_gate_without_pairs():
    """A gate that touches nothing (PARTNER the identity, SFIELD 0) has
    an empty list: the emulation leaves the state to its neighbours and
    writes dtheta 0, as the plain scan."""
    _, ts = _sectors("n6_32")
    P, S = _tables("n6_32")
    P, S = P.clone(), S.clone()
    P[4] = torch.arange(P.shape[1])
    S[4] = 0.0
    lists = pair_scan.pair_lists(P, S)
    assert lists["off"][5] == lists["off"][4]
    th, v0, ct = _inputs(ts, 2, seed=9)
    theta = _t(th)
    c, s = torch.cos(theta), torch.sin(theta)
    out = _emulate_fwd(_t(v0), c, s, P, S)
    w0, dth = _emulate_bwd(out, _t(ct), c, s, P, S)
    v, t = _t(v0).requires_grad_(), theta.clone().requires_grad_()
    ref = pair_scan.apply_rev_pairs(v, t, P, S)
    torch.autograd.backward(ref, _t(ct))
    _close(out, ref.detach())
    _close(w0, v.grad)
    _close(dth.sum(0), t.grad)
    assert float(dth[:, 4].abs().max()) == 0.0


@pytest.mark.parametrize("case,log_chunk,stages", [
    ("n7_33", 9, 8),        # the plan's ring: the stream staged at once
    ("n7_33", 6, 16),       # 64-record chunks: the ring wraps, gates span
    ("n7_33", 7, 8),        #   up to 10 chunks
    ("h4", 4, 4),           # gates of 10-24 pairs over 16-record chunks
])
def test_ring_walk_reads_every_record(case, log_chunk, stages):
    """The ring of record chunks, forward and backward: every gate reads
    exactly its own records from the slots the kernel computes, each chunk
    issued before it is waited for and no stage refilled while it may be
    read, at the plan's ring and at rings that wrap many times."""
    P, S = _tables(case)
    lists = pair_scan.pair_lists(P, S)
    rec = pair_scan.records(lists)
    stream = [tuple(r) for r in rec.tolist()]
    off = lists["off"].tolist()
    C = 1 << log_chunk
    chunks = max(1, -(-off[-1] // C))
    span = (int(torch.diff(lists["off"]).max()) - 1) // C + 2
    assert stages >= min(span, chunks)
    for reverse in (False, True):
        read = _ring_walk(off, log_chunk, chunks, stages, reverse, stream)
        gates = range(len(off) - 1)
        for k, got in zip(reversed(gates) if reverse else gates, read):
            assert got == stream[off[k]:off[k + 1]]


def test_ring_plan_holds_the_widest_gate():
    """_ring: the smallest chunk whose ring (a power of two of stages, no
    more than the stream needs) holds the widest gate's span beside the
    state; the plan's ring at the card's shapes walks every record."""
    for n, K, mp, total, item, bufs in ((226, 92, 60, 2164, 4, 2),
                                        (4901, 360, 1400, 177440, 8, 2),
                                        (15877, 560, 4410, 817600, 8, 1),
                                        (15877, 560, 4410, 817600, 4, 2)):
        ring = pair_scan._ring(n, item, bufs, K, mp, total)
        C = 1 << ring["log_chunk"]
        st = ring["stages"]
        assert st & (st - 1) == 0 and st <= 32
        assert ring["chunks"] == -(-total // C)
        assert st >= min(ring["chunks"], (mp - 1) // C + 2)
        assert ring["smem"] == pair_scan._smem_bytes(
            n, item, bufs, ring["log_chunk"], st, K) <= 232448
    # gates of 1,400 and 400 pairs over the H8 -> 16 float64 backward's
    # ring of 512-record chunks
    off = np.cumsum([0, 1400, 400, 1400, 400, 400, 1400] * 30).tolist()
    ring = pair_scan._ring(4901, 8, 2, len(off) - 1, 1400, off[-1])
    stream = [(i, i) for i in range(ring["chunks"] << ring["log_chunk"])]
    for reverse in (False, True):
        _ring_walk(off, ring["log_chunk"], ring["chunks"], ring["stages"],
                   reverse, stream)


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
    assert k["kFwdBuffers"] == pair_scan._FWD_BUFFERS == 1
    assert k["kBwdBuffers"] == pair_scan._BWD_BUFFERS == 2
    assert k["kMaxStages"] == pair_scan._MAX_STAGES
    assert k["kMinLogChunk"] == pair_scan._MIN_LOG_CHUNK
    assert k["kMaxLogChunk"] == pair_scan._MAX_LOG_CHUNK
    assert k["kOneWarpPairs"] == pair_scan._ONE_WARP_PAIRS
    # the block size from the largest gate: H8 -> 12's 60 pairs, H8 ->
    # 16's 1,400, n = 9's 4,410
    assert [pair_scan._threads(p) for p in (0, 60, 65, 97, 1400, 4410)] == \
        [32, 32, 96, 128, 512, 512]


@pytest.mark.parametrize("n,dtype,K,max_pairs,total,fwd,bwd", [
    (226, torch.float32, 92, 60, 2164, "smem", "smem"),          # H8 -> 12
    (4901, torch.float64, 360, 1400, 177440, "smem", "smem"),    # H8 -> 16
    (15877, torch.float32, 560, 4410, 817600, "smem", "smem"),   # n = 9
    (15877, torch.float64, 560, 4410, 817600, "smem", "global"),
    (44101, torch.float32, 1500, 10000, 2000000, "global", "global"),
])
def test_plan_routes(n, dtype, K, max_pairs, total, fwd, bwd):
    """One state buffer forward and two backward (in place) beside the
    ring and the gate table: float32 keeps the state in shared memory
    both ways to n = 9 at (4, 4) (a 127 KB backward), float64 forward to
    n = 9 and backward to H8 -> 16 (78 KB); H8 -> 12's 17 KB stream is
    staged at once."""
    item = 4 if dtype == torch.float32 else 8
    plan = pair_scan._plan(n, dtype, K, max_pairs, total)
    assert plan["threads"] == pair_scan._threads(max_pairs)
    for direction, route, bufs in (("fwd", fwd, 1), ("bwd", bwd, 2)):
        got = plan[direction]
        assert got["route"] == route
        state = bufs if route == "smem" else 0
        assert got == dict(route=route, **pair_scan._ring(
            n, item, state, K, max_pairs, total))
        table = -(-(K * (2 * item + 4) + 4) // 16) * 16
        assert got["smem"] == 8 * (got["stages"] << got["log_chunk"]) + \
            8 * 32 + table + item * (state * n + 32) <= 232448
    if n == 226:
        assert plan["fwd"]["stages"] >= plan["fwd"]["chunks"] == 5
    if n == 4901:
        assert plan["bwd"]["stages"] == 32 and plan["bwd"]["chunks"] == 347


def test_plan_refuses_what_neither_route_takes():
    with pytest.raises(ValueError, match="no route"):
        pair_scan._plan(2 ** 30, torch.float32, 92, 60, 2164)
    with pytest.raises(ValueError, match="no route"):
        pair_scan._plan(4901, torch.float32, 360, 200000, 400000)
    with pytest.raises(ValueError, match="no route"):      # the gate table
        pair_scan._plan(226, torch.float64, 12000, 60, 2164)
    with pytest.raises(TypeError):
        pair_scan._plan(226, torch.float16, 92, 60, 2164)


def test_partner_cached_once_per_tables_dict():
    """The stream is built once per tables dict (keyed on its PARTNER
    tensor): the records, int32 offsets, the largest gate and the total."""
    P, S = _tables("h4")
    st = pair_scan._stream(P, S)
    assert pair_scan._stream(P, S) is st
    lists = pair_scan.pair_lists(P, S)
    assert st["off"].dtype == torch.int32
    assert torch.equal(st["off"].long(), lists["off"])
    assert torch.equal(st["rec"], pair_scan.records(lists))
    assert st["total"] == len(lists["lo"])
    assert st["max_pairs"] == int(torch.diff(lists["off"]).max())
