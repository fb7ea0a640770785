"""The string gate scan K3 as hand-written CUDA kernels (csrc/gate_scan.cu).

Counterpart of esoo_tpu/sim/strings.py:303 `_apply_rev_str` (a
jax.custom_vjp over lax.scan) and its reversible backward (:324): the K
factorized Givens banks of a UCC circuit on the (..., nB, nA) string
matrix, one kernel launch forward and one backward.

  * `apply_rev_str(V0, theta, tabs)`: a torch.autograd.Function whose
    forward is one launch of `gate_scan_fwd` and whose backward is one
    launch of `gate_scan_bwd` plus the sum of its (B, K) dtheta partials.
    `tabs` is the sector's string tables dict (sim/sector.py
    device_tables): on the card the kernel reads only "GREC", each gate's
    domain lists packed by `records` (convert.string_tables_from_numpy
    builds it from sim/strings.py::gate_lists), and visits only the pairs
    each gate touches, never the (K, nd) fields M, S, flat.
  * `records(lists)`: the (K, words) int32 gate records, one a gate:
    [nda, ndb, LA, LB, 1 / nda as float32 bits, 0, 0, 0 | DA | QA | FA |
    DB | QB | FB | 0 ...], each list padded to its side's largest count
    (LA, LB), the sign factors as sign bits (0 for +1, 0x80000000 for
    -1), words a multiple of 4 (16 bytes, for the kernel's bulk copies).
  * `_plan(nB, nA, dtype, K, words)`: the route of each direction, "smem"
    (the state, updated in place, in shared memory) or "global" (in
    place in the output tensor; the backward's V in a scratch), and the
    depth of the ring of gate records, mirroring the kernel's smem_bytes
    and block_threads; a shape that neither route takes raises.

The plain version is sim/strings.py::_ApplyRevStr.  `apply_rev_str` runs
it for tensors on the CPU; for CUDA tensors it launches the kernels or
raises.  ops/_build.py counts the launches by direction and route
(`gate_scan.gate_scan_fwd.smem`, `gate_scan.gate_scan_bwd.global`, ...).

Bound on an H100: the K-step serial dependence (see csrc/gate_scan.cu);
the bytes a direction must move (the factored tables and the states in
and out, ~1 MB at H8 -> 16 in float32) take 0.3 us at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.float64)
# csrc/gate_scan.cu's constants, mirrored by _plan
_MAX_THREADS = 512               # kMaxThreads
_MAX_WARPS = _MAX_THREADS // 32  # kMaxWarps
_SMEM_LIMIT = 232448             # kMaxSmem: shared memory a block may use
_FWD_BUFFERS = 1                 # kFwdBuffers: V, in place
_BWD_BUFFERS = 2                 # kBwdBuffers: V and W, in place
_MAX_STAGES = 32                 # kMaxStages: records in flight, at most
_MIN_STAGES = 4                  # kMinStages: or all K gates when fewer
_HEADER = 8                      # kHeader: nda ndb LA LB 1/nda 0 0 0
_ROUTES = ("smem", "global")     # the kernel's route argument 0, 1


_INTS = [ctypes.c_int] * 7                   # B K nA nB words stages route
_build.entries("gate_scan", {
    f"esoo_gate_scan_{d}_{t}": ([ctypes.c_void_p] * ptrs + _INTS, 1)
    for d, ptrs in (("fwd", 5), ("bwd", 8)) for t in ("f32", "f64")})


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gate_scan")
    lib.esoo_gate_scan_smem_bytes.restype = ctypes.c_longlong
    lib.esoo_gate_scan_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.esoo_gate_scan_threads.restype = ctypes.c_int
    lib.esoo_gate_scan_threads.argtypes = [ctypes.c_int]
    return lib


def _words(LA: int, LB: int) -> int:
    """A record's int32 words: the header and three lists a side, rounded
    up to a multiple of 4."""
    return -(-(_HEADER + 3 * (LA + LB)) // 4) * 4


def records(lists: dict) -> np.ndarray:
    """The (K, words) int32 gate records of sim/strings.py::gate_lists'
    lists: [nda, ndb, LA, LB, 1 / nda (float32 bits), 0, 0, 0 | DA | QA |
    FA | DB | QB | FB | 0 ...], FA and FB as sign bits."""
    K, LA = lists["DA"].shape
    LB = lists["DB"].shape[1]
    rec = np.zeros((K, _words(LA, LB)), dtype=np.int32)
    nda = np.asarray(lists["NDA"])
    rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3] = nda, lists["NDB"], LA, LB
    rec[:, 4] = (np.float32(1) / nda.astype(np.float32)).view(np.int32)
    at = _HEADER
    for key, width in (("DA", LA), ("QA", LA), ("FA", LA), ("DB", LB),
                       ("QB", LB), ("FB", LB)):
        block = np.asarray(lists[key])
        if key[0] == "F":
            block = np.where(block < 0, np.int32(-2 ** 31), np.int32(0))
        rec[:, at:at + width] = block
        at += width
    return rec


def _threads(nd: int) -> int:
    """The kernel's block size (block_threads): nd rounded up to a warp,
    at most _MAX_THREADS."""
    return min(_MAX_THREADS, -(-nd // 32) * 32)


def _smem_bytes(nB: int, nA: int, itemsize: int, bufs: int, words: int,
                stages: int) -> int:
    """The kernel's dynamic shared memory (smem_bytes): the ring of
    `stages` records of `words` int32, its _MAX_STAGES 8-byte mbarriers,
    2 x _MAX_WARPS dtheta warp sums, and `bufs` state buffers of nd
    values (0 on the global route)."""
    return 4 * words * stages + 8 * _MAX_STAGES + \
        itemsize * (2 * _MAX_WARPS + bufs * nA * nB)


def _stages(nB: int, nA: int, itemsize: int, bufs: int, K: int,
            words: int) -> int:
    """The ring's depth beside `bufs` state buffers: as many records as
    fit, at most K and _MAX_STAGES."""
    free = _SMEM_LIMIT - _smem_bytes(nB, nA, itemsize, bufs, 0, 0)
    return min(K, _MAX_STAGES, max(free, 0) // (4 * words))


def _plan(nB: int, nA: int, dtype: torch.dtype, K: int = _MAX_STAGES,
          words: int = None) -> dict:
    """Each direction's route for states of shape (nB, nA) through K gates
    whose records have `words` int32 (by default the widest, every string
    of both sides in each list): {"threads": the block size, "words",
    "fwd"/"bwd": {"route", "stages" (the ring's depth), "smem" (bytes)}}.
    The state stays in shared memory when its buffers fit beside a ring
    of at least min(K, _MIN_STAGES) records; else in place in device
    memory, when that ring alone fits; else ValueError."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the gate scan kernel takes float32 or float64, "
                        f"got {dtype}")
    if min(nB, nA, K) < 1:
        raise ValueError(f"empty gate scan shape (nB, nA)=({nB}, {nA}), "
                         f"{K} gates")
    itemsize = torch.empty((), dtype=dtype).element_size()
    words = _words(nA, nB) if words is None else words
    nd = nA * nB
    least = min(K, _MIN_STAGES)
    plan = {"threads": _threads(nd), "words": words}
    for direction, bufs in (("fwd", _FWD_BUFFERS), ("bwd", _BWD_BUFFERS)):
        for route in _ROUTES:
            state = bufs if route == "smem" else 0
            stages = _stages(nB, nA, itemsize, state, K, words)
            if stages >= least:
                break
        if stages < least or bufs * nd >= 2 ** 31:
            raise ValueError(
                f"the gate scan kernel takes no route for (nB, nA) = ({nB}, "
                f"{nA}) at {dtype}: a ring of {least} gate records of "
                f"{4 * words} bytes does not fit its {_SMEM_LIMIT} bytes of "
                "shared memory")
        plan[direction] = dict(
            route=route, stages=stages,
            smem=_smem_bytes(nB, nA, itemsize, state, words, stages))
    return plan


def _check(V0: torch.Tensor, theta: torch.Tensor, tabs: dict) -> None:
    if V0.device.type != "cuda" or theta.device != V0.device:
        raise ValueError(f"gate scan: state on {V0.device}, theta on "
                         f"{theta.device}; both must be on one CUDA device "
                         "(or both on the CPU)")
    if V0.dtype not in _KERNEL_DTYPES or theta.dtype != V0.dtype:
        raise TypeError(f"the gate scan kernel takes float32 or float64 "
                        f"states and theta of the same type, got {V0.dtype} "
                        f"and {theta.dtype}")
    K = int(theta.shape[0])
    if V0.dim() < 2 or theta.dim() != 1 or \
            tuple(tabs["PA"].shape) != (K, V0.shape[-1]) or \
            tuple(tabs["PB"].shape) != (K, V0.shape[-2]):
        raise ValueError(
            f"gate scan: states {tuple(V0.shape)} (..., nB, nA), theta "
            f"{tuple(theta.shape)}, PA {tuple(tabs['PA'].shape)} and PB "
            f"{tuple(tabs['PB'].shape)} do not agree")
    rec = tabs.get("GREC")
    if rec is None or rec.device != V0.device or rec.dtype != torch.int32 \
            or rec.dim() != 2 or rec.shape[0] != K or rec.shape[1] % 4:
        raise ValueError(
            "gate scan: the tables hold no gate records \"GREC\" (K, words) "
            f"int32 on {V0.device} (convert.string_tables_from_numpy "
            "builds them on the card)")


def _launch(direction: str, V: torch.Tensor, tensors: list,
            c: torch.Tensor, s: torch.Tensor, tabs: dict,
            route: str = None) -> None:
    """One launch of gate_scan_<direction> on B contiguous (B, nB, nA)
    states: `tensors` are its state arguments after the records, c and s
    (forward: V0, out; backward: V, W, w0, dth).  `route` overrides the
    plan's (the card tests force the global route at small shapes)."""
    B, nB, nA = V.shape
    rec = tabs["GREC"]
    K, words = (int(n) for n in rec.shape)
    plan = _plan(nB, nA, V.dtype, K, words)[direction]
    if route is not None and route != plan["route"]:
        bufs = (_FWD_BUFFERS if direction == "fwd" else _BWD_BUFFERS) \
            if route == "smem" else 0
        plan = dict(route=route, stages=_stages(nB, nA, V.element_size(),
                                                bufs, K, words))
    route = plan["route"]
    if c.device != V.device or s.device != V.device:
        raise ValueError(f"gate scan: c and s on {c.device}, the state on "
                         f"{V.device}; all must be on one CUDA device")
    scratch = torch.empty_like(V) \
        if route == "global" and direction == "bwd" else None
    if direction == "bwd":
        tensors = tensors + [scratch]
    _build.launch("gate_scan", f"esoo_gate_scan_{direction}_"
                  f"{_build.TAGS[V.dtype]}", V.device, rec, c, s, *tensors,
                  B, K, nA, nB, words, plan["stages"], _ROUTES.index(route),
                  route=route)


def _forward(V: torch.Tensor, c: torch.Tensor, s: torch.Tensor, tabs: dict,
             route: str = None) -> torch.Tensor:
    """The states after all K gates: one gate_scan_fwd launch on
    contiguous (B, nB, nA) states V."""
    out = torch.empty_like(V)
    _launch("fwd", V, [V, out], c, s, tabs, route)
    return out


def _backward(V: torch.Tensor, W: torch.Tensor, c: torch.Tensor,
              s: torch.Tensor, tabs: dict, route: str = None) -> tuple:
    """One gate_scan_bwd launch from the forward's output V and the
    cotangent W, both contiguous (B, nB, nA): (the cotangent of the
    initial states, the (B, K) dtheta partials)."""
    w0 = torch.empty_like(V)
    dth = torch.empty((V.shape[0], c.shape[0]), dtype=V.dtype,
                      device=V.device)
    _launch("bwd", V, [V, W, w0, dth], c, s, tabs, route)
    return w0, dth


class _GateScan(torch.autograd.Function):
    """The kernels at the autograd boundary of the plain _ApplyRevStr:
    forward one launch, backward one launch and the (B, K) sum; dtheta
    sums over the leading batch axes of V0."""

    @staticmethod
    def forward(ctx, V0, theta, tabs):
        shape = V0.shape
        V = V0.reshape((-1,) + tuple(shape[-2:])).contiguous()
        c, s = torch.cos(theta).contiguous(), torch.sin(theta).contiguous()
        out = _forward(V, c, s, tabs).reshape(shape)
        ctx.save_for_backward(out)
        ctx.cos_sin, ctx.tabs = (c, s), tabs
        return out

    @staticmethod
    def backward(ctx, ct):
        out, = ctx.saved_tensors
        shape = (-1,) + tuple(out.shape[-2:])
        w0, dth = _backward(out.reshape(shape).contiguous(),
                            ct.reshape(shape).contiguous(), *ctx.cos_sin,
                            ctx.tabs)
        return w0.reshape(out.shape), dth.sum(0), None


def apply_rev_str(V0: torch.Tensor, theta: torch.Tensor,
                  tabs: dict) -> torch.Tensor:
    """The K gates of `tabs` applied to the string matrices V0 (..., nB,
    nA), differentiable in V0 and theta through the reversible backward.
    CUDA tensors launch csrc/gate_scan.cu (float32 or float64; raises on
    what it does not take); CPU tensors run the plain
    sim/strings.py::_ApplyRevStr."""
    if int(theta.shape[0]) == 0:
        return V0
    if V0.device.type == "cpu" and theta.device.type == "cpu":
        from ..sim import strings
        # the tables' precomputed fields (convert.string_tables_from_numpy
        # on the CPU), else computed here
        M, S, flat = (tabs["M"], tabs["S"], tabs["flat"]) if "M" in tabs \
            else strings.gate_fields(tabs)
        return strings._ApplyRevStr.apply(V0, theta, M.to(V0.dtype),
                                          S.to(V0.dtype), flat)
    _check(V0, theta, tabs)
    return _GateScan.apply(V0, theta, tabs)
