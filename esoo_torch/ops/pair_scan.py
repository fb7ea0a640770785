"""The pairs gate scan as hand-written CUDA kernels (csrc/pair_scan.cu).

Counterpart of esoo_tpu/sim/sector.py:141 `_apply_rev` (a jax.custom_vjp
over the lax.scan of :129 `_apply_gates_tabled`) and its reversible
backward (:161): the K Givens-bank gates of a UCC circuit on the (...,
nd + 1) padded sector amplitudes of the pairs kernel, one kernel launch
forward and one backward.

  * `apply_rev_pairs(v0, theta, PARTNER, SFIELD)`: a
    torch.autograd.Function whose forward is one launch of
    `pair_scan_fwd` and whose backward is one launch of `pair_scan_bwd`
    plus the sum of its (B, K) dtheta partials.  On the card the kernels
    read only each gate's touched pairs, never the dense (K, nd + 1)
    tables: `pair_lists` derives them from PARTNER and SFIELD and
    `records` packs them into one stream, once per tables dict (cached
    on the PARTNER tensor, `_stream`).
  * `pair_lists(PARTNER, SFIELD)`: the (K + 1,) gate offsets and, in gate
    order and ascending lo, each pair's lo < hi = PARTNER[k, lo] (SFIELD
    nonzero) and whether SFIELD[k, lo] is -1.
  * `records(lists)`: the (R, 2) int32 stream, one 8-byte record a pair,
    (lo, hi with the sign bit set when SFIELD[k, lo] = -1), zero past the
    last pair to a multiple of the largest chunk (16-byte chunks for the
    kernel's bulk copies).
  * `_plan(n, dtype, K, max_pairs, total)`: the block size (from the
    largest gate) and, for each direction, the route, "smem" (the state,
    updated in place, in shared memory) or "global" (in place in the
    output tensor; the backward's v in a scratch), and the ring of record
    chunks beside it and the gate table, mirroring the kernel's
    smem_bytes and block_threads; a shape that neither route takes
    raises.

The plain version is sim/sector.py::_ApplyRev.  `apply_rev_pairs` runs
it for tensors on the CPU; for CUDA tensors it launches the kernels or
raises.  ops/_build.py counts the launches by direction and route
(`pair_scan.pair_scan_fwd.smem`, `pair_scan.pair_scan_bwd.global`, ...).

Bound on an H100: the K-step serial dependence (see csrc/pair_scan.cu);
the bytes a direction must move (the 8-byte pair records, the offsets, c,
s and the states in and out: ~20 KB at H8 -> 12 in float32) take 6 ns at
3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.float64)
# csrc/pair_scan.cu's constants, mirrored by _plan
_MAX_THREADS = 512               # kMaxThreads
_MAX_WARPS = _MAX_THREADS // 32  # kMaxWarps
_SMEM_LIMIT = 232448             # kMaxSmem: shared memory a block may use
_FWD_BUFFERS = 1                 # kFwdBuffers: v, in place
_BWD_BUFFERS = 2                 # kBwdBuffers: v and w, in place
_MAX_STAGES = 32                 # kMaxStages: ring stages, at most
_MIN_LOG_CHUNK = 9               # kMinLogChunk: 512 records a chunk ...
_MAX_LOG_CHUNK = 12              # kMaxLogChunk: ... to 4,096
_ONE_WARP_PAIRS = 64             # kOneWarpPairs: one warp up to this gate
_RECORD = 8                      # bytes a record (int2)
_ROUTES = ("smem", "global")     # the kernel's route argument 0, 1


_INTS = [ctypes.c_int] * 8    # B K n log_chunk chunks stages route threads
_build.entries("pair_scan", {
    f"esoo_pair_scan_{d}_{t}": ([ctypes.c_void_p] * ptrs + _INTS, 1)
    for d, ptrs in (("fwd", 6), ("bwd", 9)) for t in ("f32", "f64")})


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pair_scan")
    lib.esoo_pair_scan_smem_bytes.restype = ctypes.c_longlong
    lib.esoo_pair_scan_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.esoo_pair_scan_threads.restype = ctypes.c_int
    lib.esoo_pair_scan_threads.argtypes = [ctypes.c_int]
    return lib


def pair_lists(PARTNER: torch.Tensor, SFIELD: torch.Tensor) -> dict:
    """Each gate's touched pairs, on PARTNER's device: {"off": (K + 1,)
    int64 offsets, "lo", "hi" (int64) and "neg" (bool, SFIELD[k, lo] <
    0) of every pair lo < hi = PARTNER[k, lo] with SFIELD[k, lo] != 0, in
    gate order and ascending lo}.  Raises unless every gate is a bank of
    disjoint rotations (PARTNER[k, hi] = lo, SFIELD[k, hi] = -SFIELD[k,
    lo], nothing else touched)."""
    K, n = PARTNER.shape
    idx = torch.arange(n, device=PARTNER.device)
    touched = SFIELD != 0
    mask = (PARTNER > idx) & touched
    k, lo = mask.nonzero(as_tuple=True)
    hi = PARTNER[k, lo]
    sg = SFIELD[k, lo]
    if not (torch.equal(PARTNER[k, hi], lo) and torch.equal(
            SFIELD[k, hi], -sg) and int(touched.sum()) == 2 * len(lo)):
        raise ValueError("pairs gate scan: PARTNER/SFIELD are not banks of "
                         "disjoint Givens rotations")
    off = torch.zeros(K + 1, dtype=torch.int64, device=PARTNER.device)
    off[1:] = mask.sum(1).cumsum(0)
    return dict(off=off, lo=lo, hi=hi, neg=sg < 0)


def records(lists: dict) -> torch.Tensor:
    """The (R, 2) int32 record stream of `pair_lists`: (lo, hi | sign bit)
    a pair, zero to R, a multiple of the largest chunk."""
    total = len(lists["lo"])
    chunk = 1 << _MAX_LOG_CHUNK
    R = max(1, -(-total // chunk)) * chunk
    rec = torch.zeros((R, 2), dtype=torch.int32, device=lists["lo"].device)
    rec[:total, 0] = lists["lo"]
    rec[:total, 1] = lists["hi"] - lists["neg"].long() * 2 ** 31
    return rec


# the kernels' stream a tables dict: id(PARTNER) -> (a weak reference to
# PARTNER, {"rec", "off" (int32), "max_pairs", "total", "plans": {(n,
# dtype): _plan}})
_STREAMS = {}


def _stream(PARTNER: torch.Tensor, SFIELD: torch.Tensor) -> dict:
    got = _STREAMS.get(id(PARTNER))
    if got is None or got[0]() is not PARTNER:
        lists = pair_lists(PARTNER, SFIELD)
        off = lists["off"]
        got = (weakref.ref(PARTNER), dict(
            rec=records(lists), off=off.to(torch.int32),
            max_pairs=int(torch.diff(off).max()), total=int(off[-1]),
            plans={}))
        _STREAMS[id(PARTNER)] = got
        weakref.finalize(PARTNER, _STREAMS.pop, id(PARTNER), None)
    return got[1]


def _threads(max_pairs: int) -> int:
    """The kernel's block size (block_threads) from the largest gate: one
    warp up to _ONE_WARP_PAIRS pairs, else the pairs rounded up to a warp,
    at most _MAX_THREADS."""
    if max_pairs <= _ONE_WARP_PAIRS:
        return 32
    return min(_MAX_THREADS, -(-max_pairs // 32) * 32)


def _gate_bytes(K: int, itemsize: int) -> int:
    """The kernel's gate table (gate_bytes): c and s of K gates and K + 1
    int32 offsets, rounded up to 16 bytes."""
    return -(-(K * (2 * itemsize + 4) + 4) // 16) * 16


def _smem_bytes(n: int, itemsize: int, bufs: int, log_chunk: int,
                stages: int, K: int) -> int:
    """The kernel's dynamic shared memory (smem_bytes): the ring of
    `stages` chunks of 2^log_chunk records, _MAX_STAGES 8-byte mbarriers,
    the gate table of K gates, 2 x _MAX_WARPS dtheta warp sums and `bufs`
    state buffers of n values (0 on the global route)."""
    return _RECORD * (stages << log_chunk) + 8 * _MAX_STAGES + \
        _gate_bytes(K, itemsize) + itemsize * (2 * _MAX_WARPS + bufs * n)


def _ring(n: int, itemsize: int, bufs: int, K: int, max_pairs: int,
          total: int) -> dict:
    """The ring beside `bufs` state buffers, for the smallest chunk that
    takes it: `chunks` chunks of 2^log_chunk records hold the stream, and
    `stages` (a power of two, at most _MAX_STAGES, no more than the
    stream needs) must hold the widest gate's span, (max_pairs - 1) //
    chunk + 2 chunks; None when no chunk size fits."""
    for log_chunk in range(_MIN_LOG_CHUNK, _MAX_LOG_CHUNK + 1):
        chunk = 1 << log_chunk
        chunks = max(1, -(-total // chunk))
        span = min(chunks, (max_pairs - 1) // chunk + 2) if max_pairs else 1
        free = _SMEM_LIMIT - _smem_bytes(n, itemsize, bufs, log_chunk, 0, K)
        stages = min(_MAX_STAGES, 1 << (chunks - 1).bit_length())
        while stages and stages * chunk * _RECORD > free:
            stages //= 2
        if stages >= span:
            return dict(log_chunk=log_chunk, chunks=chunks, stages=stages,
                        smem=_smem_bytes(n, itemsize, bufs, log_chunk,
                                         stages, K))
    return None


def _plan(n: int, dtype: torch.dtype, K: int, max_pairs: int,
          total: int) -> dict:
    """The launch of each direction for states of n = nd + 1 amplitudes
    through K gates of at most `max_pairs` pairs, `total` in all:
    {"threads": the block size, "fwd"/"bwd": {"route", "log_chunk",
    "chunks", "stages", "smem" (bytes)}}.  The state stays in shared
    memory when its buffers fit beside a ring; else in place in device
    memory, while its indices fit 32 bits and a ring alone fits; else
    ValueError."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the pairs gate scan kernel takes float32 or "
                        f"float64, got {dtype}")
    if n < 1:
        raise ValueError(f"empty pairs gate scan state (n = {n})")
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = {"threads": _threads(max_pairs)}
    for direction, bufs in (("fwd", _FWD_BUFFERS), ("bwd", _BWD_BUFFERS)):
        for route in _ROUTES:
            ring = _ring(n, itemsize, bufs if route == "smem" else 0, K,
                         max_pairs, total)
            if ring is not None:
                break
        if ring is None or bufs * n >= 2 ** 31:
            raise ValueError(
                f"the pairs gate scan kernel takes no route for {n} "
                f"amplitudes and gates of {max_pairs} pairs at {dtype}")
        plan[direction] = dict(route=route, **ring)
    return plan


def _check(v0: torch.Tensor, theta: torch.Tensor, PARTNER: torch.Tensor,
           SFIELD: torch.Tensor) -> None:
    dev = v0.device
    if dev.type != "cuda" or any(t.device != dev for t in (theta, PARTNER,
                                                           SFIELD)):
        raise ValueError(f"pairs gate scan: state on {dev}, theta on "
                         f"{theta.device}, tables on {PARTNER.device} and "
                         f"{SFIELD.device}; all must be on one CUDA device "
                         "(or all on the CPU)")
    if v0.dtype not in _KERNEL_DTYPES or theta.dtype != v0.dtype:
        raise TypeError(f"the pairs gate scan kernel takes float32 or "
                        f"float64 states and theta of the same type, got "
                        f"{v0.dtype} and {theta.dtype}")
    K = int(theta.shape[0])
    shape = (K, v0.shape[-1]) if v0.dim() else None
    if theta.dim() != 1 or tuple(PARTNER.shape) != shape or \
            tuple(SFIELD.shape) != shape:
        raise ValueError(
            f"pairs gate scan: states {tuple(v0.shape)} (..., nd + 1), "
            f"theta {tuple(theta.shape)}, PARTNER {tuple(PARTNER.shape)} "
            f"and SFIELD {tuple(SFIELD.shape)} do not agree")


def _launch(direction: str, v: torch.Tensor, tensors: list,
            c: torch.Tensor, s: torch.Tensor, PARTNER: torch.Tensor,
            SFIELD: torch.Tensor, route: str = None) -> None:
    """One launch of pair_scan_<direction> on B contiguous (B, n) states:
    `tensors` are its state arguments after the stream, offsets, c and s
    (forward: v0, out; backward: v, w, w0, dth).  `route` overrides the
    plan's (the card tests force the global route at small shapes)."""
    B, n = v.shape
    K = int(c.shape[0])
    st = _stream(PARTNER, SFIELD)
    plan = st["plans"].get((n, v.dtype))
    if plan is None:
        plan = st["plans"][n, v.dtype] = _plan(n, v.dtype, K,
                                               st["max_pairs"], st["total"])
    ring = plan[direction]
    if route is not None and route != ring["route"]:
        bufs = (_FWD_BUFFERS if direction == "fwd" else _BWD_BUFFERS) \
            if route == "smem" else 0
        ring = _ring(n, v.element_size(), bufs, K, st["max_pairs"],
                     st["total"])
        if ring is None:
            raise ValueError(f"pairs gate scan: the {route} route takes "
                             f"no ring for {n} amplitudes")
        ring = dict(route=route, **ring)
    route = ring["route"]
    scratch = torch.empty_like(v) \
        if route == "global" and direction == "bwd" else None
    if direction == "bwd":
        tensors = tensors + [scratch]
    _build.launch("pair_scan", f"esoo_pair_scan_{direction}_"
                  f"{_build.TAGS[v.dtype]}", v.device, st["rec"], st["off"],
                  c, s, *tensors, B, K, n, ring["log_chunk"], ring["chunks"],
                  ring["stages"], _ROUTES.index(route), plan["threads"],
                  route=route)


def _forward(v: torch.Tensor, c: torch.Tensor, s: torch.Tensor,
             PARTNER: torch.Tensor, SFIELD: torch.Tensor,
             route: str = None) -> torch.Tensor:
    """The states after all K gates: one pair_scan_fwd launch on
    contiguous (B, n) states v."""
    out = torch.empty_like(v)
    _launch("fwd", v, [v, out], c, s, PARTNER, SFIELD, route)
    return out


def _backward(v: torch.Tensor, w: torch.Tensor, c: torch.Tensor,
              s: torch.Tensor, PARTNER: torch.Tensor, SFIELD: torch.Tensor,
              route: str = None) -> tuple:
    """One pair_scan_bwd launch from the forward's output v and the
    cotangent w, both contiguous (B, n): (the cotangent of the initial
    states, the (B, K) dtheta partials)."""
    w0 = torch.empty_like(v)
    dth = torch.empty((v.shape[0], c.shape[0]), dtype=v.dtype,
                      device=v.device)
    _launch("bwd", v, [v, w, w0, dth], c, s, PARTNER, SFIELD, route)
    return w0, dth


class _PairScan(torch.autograd.Function):
    """The kernels at the autograd boundary of the plain _ApplyRev:
    forward one launch, backward one launch and the (B, K) sum; dtheta
    sums over the leading batch axes of v0."""

    @staticmethod
    def forward(ctx, v0, theta, PARTNER, SFIELD):
        shape = v0.shape
        v = v0.reshape(-1, shape[-1]).contiguous()
        c, s = torch.cos(theta).contiguous(), torch.sin(theta).contiguous()
        out = _forward(v, c, s, PARTNER, SFIELD).reshape(shape)
        ctx.save_for_backward(out)
        ctx.tables = (c, s, PARTNER, SFIELD)
        return out

    @staticmethod
    def backward(ctx, ct):
        out, = ctx.saved_tensors
        n = out.shape[-1]
        w0, dth = _backward(out.reshape(-1, n).contiguous(),
                            ct.reshape(-1, n).contiguous(), *ctx.tables)
        return w0.reshape(out.shape), dth.sum(0), None, None


def apply_rev_pairs(v0: torch.Tensor, theta: torch.Tensor,
                    PARTNER: torch.Tensor,
                    SFIELD: torch.Tensor) -> torch.Tensor:
    """The K gates of (PARTNER, SFIELD) applied to the padded sector
    amplitudes v0 (..., nd + 1), differentiable in v0 and theta through
    the reversible backward.  CUDA tensors launch csrc/pair_scan.cu
    (float32 or float64; raises on what it does not take); CPU tensors
    run the plain sim/sector.py::_ApplyRev."""
    if int(theta.shape[0]) == 0:
        return v0
    if all(t.device.type == "cpu" for t in (v0, theta, PARTNER, SFIELD)):
        from ..sim import sector
        return sector._ApplyRev.apply(v0, theta, PARTNER, SFIELD)
    _check(v0, theta, PARTNER, SFIELD)
    return _PairScan.apply(v0, theta, PARTNER, SFIELD)
