"""The full-space Pauli-rotation scan K8 as hand-written CUDA kernels
(csrc/prot_scan.cu).

Counterpart of esoo_tpu/sim/statevector.py:287 `_apply_prot_scan` (a
lax.scan over :256 `_scan_gates`, in sqrt(K) jax.checkpoint chunks past
`_REMAT_RESIDUAL_BUDGET` elements): a run of K Pauli rotations on the
(..., 2^N) statevector, one kernel launch forward and one backward.

  * `apply_prot_scan(state, ang, tabs)`: a torch.autograd.Function
    whose forward is one launch of `prot_scan_fwd` (writing the
    checkpoints of the reverse mode when a gradient is needed) and whose
    backward is one launch of `prot_scan_bwd` plus the sum of its (B, K)
    dang partials.  `tabs` are the run's tables on the state's device
    (sim/statevector.py::_ScanRun.tables): on the card the (K,) int64 bit
    masks "x", "z", the (K,) factors "f" (+-1 at the real dtype for a
    real state; -i i^y at the complex dtype for a complex one), from
    which the kernel forms each sign (-1)^popcount((c ^ x) & z) in
    registers, reading no (K, 2^N) table, and the (G + 1,) int32 offsets
    "groups" of `group_offsets`.
  * `group_offsets(xs)`: the run cut into groups, maximal runs of
    consecutive rotations with equal X mask, at most _MAX_GROUP long.  A
    thread of the kernel applies a whole group to its pair of amplitudes
    {e, e ^ x} in registers, one barrier a group.
  * `_plan(dim, B, K, dtype, G)`: the route of each direction, "smem"
    (the state in shared memory, updated in place) or "global" (in place
    in the output tensor, L2-resident), mirroring the kernel's smem_bytes
    and block_threads, the rotations staged in shared memory at a time
    (the window), and the checkpoint stride in groups (every group while
    G * B * dim is within sim/statevector.py's _REMAT_RESIDUAL_BUDGET,
    else every isqrt(G)-th); a shape that neither route takes raises.

The plain version is sim/statevector.py::_ProtScan.  `apply_prot_scan`
runs it for tensors on the CPU (on the CPU tables' (K, 2^N) sign table
"FS" and flip axes "dims"); for CUDA tensors it launches the kernels or
raises.  ops/_build.py counts the launches by direction and route
(`prot_scan.prot_scan_fwd.smem`, `prot_scan.prot_scan_bwd.global`, ...).

Bound on an H100: the serial dependence (see csrc/prot_scan.cu); a
direction's operations (7.9 and 18.4 MFLOP at H8 -> 12 in float32) take
0.12 and 0.27 us at 67 TFLOP/s, its bytes (~51 KB) 15 ns.
"""

from __future__ import annotations

import ctypes
import functools
import importlib
import math

import numpy as np
import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.float64, torch.complex64,
                  torch.complex128)
_REAL = {torch.float32: torch.float32, torch.float64: torch.float64,
         torch.complex64: torch.float32, torch.complex128: torch.float64}
# csrc/prot_scan.cu's constants, mirrored by _plan
_MAX_THREADS = 512               # kMaxThreads
_MAX_WARPS = _MAX_THREADS // 32  # kMaxWarps
_SMEM_LIMIT = 232448             # kMaxSmem: shared memory a block may use
_BUFFERS = 1                     # kBuffers: the state or W, in place
_MAX_GROUP = 8                   # kMaxGroup: rotations a group, at most
_MAX_DIM = 1 << 30               # kMaxDim: 32-bit amplitude indices
_ROUTES = ("smem", "global")     # the kernel's route argument 0, 1


_INTS = [ctypes.c_int] * 7         # B K G dim stride window route
_build.entries("prot_scan", {
    f"esoo_prot_scan_{d}_{_build.TAGS[t]}":
        ([ctypes.c_void_p] * ptrs + _INTS, 1)
    for d, ptrs in (("fwd", 9), ("bwd", 11)) for t in _KERNEL_DTYPES})


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("prot_scan")
    lib.esoo_prot_scan_smem_bytes.restype = ctypes.c_longlong
    lib.esoo_prot_scan_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.esoo_prot_scan_threads.restype = ctypes.c_int
    lib.esoo_prot_scan_threads.argtypes = [ctypes.c_int]
    return lib


def group_offsets(xs) -> np.ndarray:
    """The (G + 1,) int32 offsets of the groups of a run of rotations
    with X masks `xs`: maximal runs of consecutive rotations with equal x,
    cut after _MAX_GROUP rotations; the order is never changed."""
    xs = np.asarray(xs, dtype=np.int64)
    cuts = [0]
    for k in range(1, len(xs)):
        if xs[k] != xs[k - 1] or k - cuts[-1] == _MAX_GROUP:
            cuts.append(k)
    cuts.append(len(xs))
    return np.asarray(cuts, dtype=np.int32)


def _threads(dim: int) -> int:
    """The kernel's block size (block_threads): a thread a pair of
    amplitudes, dim / 2 rounded up to a warp, at most _MAX_THREADS."""
    return min(_MAX_THREADS, -(-(dim // 2) // 32) * 32)


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _rotation_bytes(itemsize: int, realsize: int) -> int:
    """A staged rotation's shared memory: its Rot (the two factors with s
    folded in, c and the 32-bit z mask, rounded up to 16 bytes), its Fac
    (the two factors) and s."""
    return _round16(2 * itemsize + realsize + 4) + 2 * itemsize + realsize


def _smem_bytes(dim: int, itemsize: int, realsize: int, bufs: int,
                window: int) -> int:
    """The kernel's dynamic shared memory (smem_bytes): `bufs` state
    buffers of dim amplitudes (0 on the global route; rounded up to 16
    bytes), `window` staged rotations, and 2 x _MAX_GROUP x 2 x
    _MAX_WARPS 8-byte dang warp sums."""
    return _round16(itemsize * bufs * dim) + window * _rotation_bytes(
        itemsize, realsize) + 8 * 2 * _MAX_GROUP * 2 * _MAX_WARPS


def _window(K: int, free: int, itemsize: int, realsize: int) -> int:
    """The rotations staged at a time in `free` bytes: all K (rounded up
    to 4) when they fit, else as many multiples of 4 as fit."""
    fit = free // _rotation_bytes(itemsize, realsize) // 4 * 4
    return min(-(-K // 4) * 4, max(fit, 0))


def _statevector():
    """The sim/statevector.py module (the package's `statevector` name is
    its function), imported at first use: it imports this module.  The
    wrapper takes its plain _ProtScan and _REMAT_RESIDUAL_BUDGET."""
    return importlib.import_module("..sim.statevector", __package__)


def _stride(G: int, numel: int) -> int:
    """The checkpoint stride of the reverse mode, in groups: 1 (every
    group's input state) while G * numel is within sim/statevector.py's
    _REMAT_RESIDUAL_BUDGET, else isqrt(G) (_ProtScan.forward's chunks,
    counted in groups)."""
    if G * numel <= _statevector()._REMAT_RESIDUAL_BUDGET:
        return 1
    return max(1, math.isqrt(G))


def _plan(dim: int, B: int, K: int, dtype: torch.dtype,
          G: int = None) -> dict:
    """Each direction's route for B states of dim amplitudes through K
    rotations in G groups (K groups of one by default): {"threads": the
    block size, "groups": G, "stride": the checkpoint stride in groups,
    "checkpoints": their count, "window": the rotations staged in shared
    memory at a time, "fwd"/"bwd": {"route", "smem" (bytes)}}.  The state
    (or W) stays in shared memory when it fits beside a window of at
    least min(K, _MAX_GROUP) rotations; else it is updated in place in
    the output tensor; dim past 2^30 (32-bit indices) raises
    ValueError."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the Pauli-rotation scan kernel takes float32, "
                        f"float64, complex64 or complex128, got {dtype}")
    G = K if G is None else G
    if dim < 2 or dim & (dim - 1) or B < 1 or K < 1 or not 1 <= G <= K:
        raise ValueError(f"Pauli-rotation scan: {B} states of {dim} "
                         f"amplitudes (a power of two, at least 2) through "
                         f"{K} rotations in {G} groups")
    if dim > _MAX_DIM:
        raise ValueError(f"the Pauli-rotation scan kernel takes no route "
                         f"for {dim} amplitudes: its indices are 32-bit "
                         f"(at most {_MAX_DIM})")
    item = torch.empty((), dtype=dtype).element_size()
    ritem = torch.empty((), dtype=_REAL[dtype]).element_size()
    stride = _stride(G, B * dim)
    plan = {"threads": _threads(dim), "groups": G, "stride": stride,
            "checkpoints": -(-G // stride)}
    least = min(-(-K // 4) * 4, _MAX_GROUP)
    for route, bufs in (("smem", _BUFFERS), ("global", 0)):
        fixed = _smem_bytes(dim, item, ritem, bufs, 0)
        window = _window(K, _SMEM_LIMIT - fixed, item, ritem)
        if window >= least:
            break
    plan["window"] = window
    smem = _smem_bytes(dim, item, ritem, bufs, window)
    for direction in ("fwd", "bwd"):
        plan[direction] = dict(route=route, smem=smem)
    return plan


def _check(state: torch.Tensor, ang: torch.Tensor, xs: torch.Tensor,
           zs: torch.Tensor, factor: torch.Tensor,
           groups: torch.Tensor) -> None:
    dev = state.device
    if dev.type != "cuda" or any(t.device != dev for t in (ang, xs, zs,
                                                           factor, groups)):
        raise ValueError(f"Pauli-rotation scan: state on {dev}, angles on "
                         f"{ang.device}, masks on {xs.device} and "
                         f"{zs.device}, factors on {factor.device}, groups "
                         f"on {groups.device}; all must be on one CUDA "
                         "device (or all on the CPU)")
    if state.dtype not in _KERNEL_DTYPES or factor.dtype != state.dtype \
            or ang.dtype != _REAL[state.dtype]:
        raise TypeError(f"the Pauli-rotation scan kernel takes float32, "
                        f"float64, complex64 or complex128 states, factors "
                        f"of their type and angles of their real type, got "
                        f"{state.dtype}, {factor.dtype} and {ang.dtype}")
    K = int(ang.shape[0])
    dim = int(state.shape[-1]) if state.dim() else 0
    if ang.dim() != 1 or any(tuple(t.shape) != (K,) for t in (xs, zs,
                                                              factor)) \
            or xs.dtype != torch.int64 or zs.dtype != torch.int64 \
            or not (xs.is_contiguous() and zs.is_contiguous()) \
            or groups.dtype != torch.int32 or groups.dim() != 1 \
            or not 2 <= groups.shape[0] <= K + 1:
        raise ValueError(
            f"Pauli-rotation scan: angles {tuple(ang.shape)}, masks "
            f"{tuple(xs.shape)} {xs.dtype} and {tuple(zs.shape)} "
            f"{zs.dtype}, factors {tuple(factor.shape)}, group offsets "
            f"{tuple(groups.shape)} {groups.dtype} do not agree: (K,) "
            "each, the masks contiguous int64, the offsets (G + 1,) int32")
    if dim < 2 or dim & (dim - 1) or dim.bit_length() - 1 > 63:
        raise ValueError(f"Pauli-rotation scan: a state of {dim} "
                         "amplitudes; 2^N with 1 <= N <= 63")


def _launch(direction: str, B: int, dim: int, dtype, gates: list,
            tensors: list, stride: int, route: str = None,
            window: int = None) -> None:
    """One launch of prot_scan_<direction> on B states of dim amplitudes:
    `gates` are x, z, factor, c, s and the group offsets, and `tensors`
    the state arguments after them (forward: s0, out, ckpt or None;
    backward: ckpt, ct, w0, dang, rec or None).  `route` and `window`
    override the plan's (the card tests force the global route, and a
    window that the run outgrows, at small shapes)."""
    K, G = int(gates[0].shape[0]), int(gates[5].shape[0]) - 1
    plan = _plan(dim, B, K, dtype, G)
    route = route or plan[direction]["route"]
    item = torch.empty((), dtype=dtype).element_size()
    ritem = torch.empty((), dtype=_REAL[dtype]).element_size()
    fixed = _smem_bytes(dim, item, ritem, _BUFFERS if route == "smem" else 0,
                        0)
    window = window or _window(K, _SMEM_LIMIT - fixed, item, ritem)
    _build.launch("prot_scan", f"esoo_prot_scan_{direction}_"
                  f"{_build.TAGS[dtype]}", gates[0].device, *gates,
                  *tensors, B, K, G, dim, stride, window,
                  _ROUTES.index(route), route=route)


def _forward(S: torch.Tensor, gates: list, stride: int = None,
             checkpoints: bool = False, route: str = None,
             window: int = None) -> tuple:
    """One prot_scan_fwd launch on contiguous (B, dim) states S with
    `gates` = [x, z, factor, c, s, group offsets]: (the states after all
    K rotations, the (B, ceil(G / stride), dim) checkpoints or None)."""
    B, dim = S.shape
    K, G = int(gates[0].shape[0]), int(gates[5].shape[0]) - 1
    stride = stride or _plan(dim, B, K, S.dtype, G)["stride"]
    out = torch.empty_like(S)
    ckpt = torch.empty((B, -(-G // stride), dim), dtype=S.dtype,
                       device=S.device) if checkpoints else None
    _launch("fwd", B, dim, S.dtype, gates, [S, out, ckpt], stride, route,
            window)
    return out, ckpt


def _backward(ckpt: torch.Tensor, W: torch.Tensor, gates: list,
              stride: int, route: str = None, window: int = None) -> tuple:
    """One prot_scan_bwd launch from the forward's checkpoints and the
    cotangent W (B, dim): (the cotangent of the input states, the (B, K)
    dang partials)."""
    B, dim = W.shape
    K = int(gates[0].shape[0])
    w0 = torch.empty_like(W)
    dang = torch.empty((B, K), dtype=gates[3].dtype, device=W.device)
    rec = torch.empty((B, stride - 1, dim), dtype=W.dtype,
                      device=W.device) if stride > 1 else None
    _launch("bwd", B, dim, W.dtype, gates, [ckpt, W, w0, dang, rec], stride,
            route, window)
    return w0, dang


class _ProtScanKernel(torch.autograd.Function):
    """The kernels at the autograd boundary of the plain _ProtScan:
    forward one launch, backward one launch and the (B, K) sum; dang sums
    over the leading batch axes of the state."""

    @staticmethod
    def forward(ctx, state, ang, xs, zs, factor, groups):
        shape = state.shape
        S = state.reshape(-1, shape[-1]).contiguous()
        c = torch.cos(ang / 2).contiguous()
        sn = torch.sin(ang / 2).contiguous()
        gates = [xs, zs, factor.contiguous(), c, sn, groups]
        grad = any(ctx.needs_input_grad[:2])
        stride = _plan(S.shape[1], S.shape[0], int(ang.shape[0]), S.dtype,
                       int(groups.shape[0]) - 1)["stride"]
        out, ckpt = _forward(S, gates, stride, checkpoints=grad)
        if grad:
            ctx.save_for_backward(ckpt, *gates)
            ctx.stride = stride
        return out.reshape(shape)

    @staticmethod
    def backward(ctx, ct):
        ckpt, *gates = ctx.saved_tensors
        W = ct.reshape(-1, ct.shape[-1]).contiguous()
        w0, dang = _backward(ckpt, W, gates, ctx.stride)
        return w0.reshape(ct.shape), dang.sum(0), None, None, None, None


def apply_prot_scan(state: torch.Tensor, ang: torch.Tensor,
                    tabs: dict) -> torch.Tensor:
    """The K Pauli rotations exp(-i ang_k / 2 P_k) of the run whose tables
    on the state's device are `tabs` (sim/statevector.py::
    _ScanRun.tables) applied to `state` (..., 2^N), differentiable in
    state and ang.  CUDA tensors launch csrc/prot_scan.cu on the masks,
    factors and group offsets (raises on what it does not take); CPU
    tensors run the plain sim/statevector.py::_ProtScan on the sign
    table."""
    if int(ang.shape[0]) == 0:
        return state
    if state.device.type == "cpu" and ang.device.type == "cpu":
        return _statevector()._ProtScan.apply(
            state, ang, tabs["FS"], tabs["dims"],
            int(state.shape[-1]).bit_length() - 1)
    _check(state, ang, tabs["x"], tabs["z"], tabs["f"], tabs["groups"])
    return _ProtScanKernel.apply(state, ang, tabs["x"], tabs["z"],
                                 tabs["f"], tabs["groups"])
