"""The string gate scan K3 as hand-written CUDA kernels (csrc/gate_scan.cu).

Counterpart of esoo_tpu/sim/strings.py:303 `_apply_rev_str` (a
jax.custom_vjp over lax.scan) and its reversible backward (:324): the K
factorized Givens banks of a UCC circuit on the (..., nB, nA) string
matrix, one kernel launch forward and one backward.

  * `apply_rev_str(V0, theta, tabs)`: a torch.autograd.Function whose
    forward is one launch of `gate_scan_fwd` and whose backward is one
    launch of `gate_scan_bwd` plus the sum of its (B, K) dtheta partials.
    `tabs` is the sector's string tables dict (sim/sector.py
    device_tables): the kernel reads the factored per-gate tables PA, PB
    (as int32 copies, cached once per tables dict), AD AR UD UR BD BR VD
    VR, and never the (K, nd) fields M, S, flat.
  * `_plan(nB, nA, dtype)`: the route of each direction, "smem" (the
    state's ping-pong buffers in shared memory) or "global" (in an
    L2-resident scratch), mirroring the kernel's smem_bytes and
    block_threads; a shape that neither route takes raises.

The plain version is sim/strings.py::_ApplyRevStr.  `apply_rev_str` runs
it for tensors on the CPU; for CUDA tensors it launches the kernels or
raises.  `apply_rev_str.launches` counts the kernel launches (one a
direction), split by direction and route in `route_launch_counts`.

Bound on an H100: the K-step serial dependence (see csrc/gate_scan.cu);
the bytes a direction must move (the factored tables and the states in
and out, ~1 MB at H8 -> 16 in float32) take 0.3 us at 3.35 TB/s.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.float64)
# csrc/gate_scan.cu's constants, mirrored by _plan
_MAX_THREADS = 512               # kMaxThreads
_MAX_WARPS = _MAX_THREADS // 32  # kMaxWarps
_SMEM_LIMIT = 232448             # kMaxSmem: shared memory a block may use
_FWD_BUFFERS = 2                 # kFwdBuffers: V ping-pong
_BWD_BUFFERS = 4                 # kBwdBuffers: V and W ping-pong
_ROUTES = ("smem", "global")     # the kernel's route argument 0, 1
_FLOAT_KEYS = ("AD", "AR", "UD", "UR", "BD", "BR", "VD", "VR")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gate_scan")
    tables = [ctypes.c_void_p] * 12          # PA PB AD .. VR c s
    ints = [ctypes.c_int] * 5                # B K nA nB route
    for fn in (lib.esoo_gate_scan_fwd_f32, lib.esoo_gate_scan_fwd_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = tables + [ctypes.c_void_p] * 3 + ints + [
            ctypes.c_void_p]
    for fn in (lib.esoo_gate_scan_bwd_f32, lib.esoo_gate_scan_bwd_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = tables + [ctypes.c_void_p] * 5 + ints + [
            ctypes.c_void_p]
    lib.esoo_gate_scan_smem_bytes.restype = ctypes.c_longlong
    lib.esoo_gate_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.esoo_gate_scan_threads.restype = ctypes.c_int
    lib.esoo_gate_scan_threads.argtypes = [ctypes.c_int]
    return lib


def _threads(nd: int) -> int:
    """The kernel's block size (block_threads): nd rounded up to a warp,
    at most _MAX_THREADS."""
    return min(_MAX_THREADS, -(-nd // 32) * 32)


def _smem_bytes(nB: int, nA: int, itemsize: int, bufs: int) -> int:
    """The kernel's dynamic shared memory (smem_bytes): `bufs` state
    buffers of nd values (0 on the global route), the two-stage table
    ring of 4 (nA + nB) values a stage, 2 x _MAX_WARPS dtheta warp sums,
    and the ring's int32 partner maps (nA + nB a stage)."""
    ns = nA + nB
    return itemsize * (bufs * nA * nB + 8 * ns + 2 * _MAX_WARPS) + 4 * 2 * ns


def _plan(nB: int, nA: int, dtype: torch.dtype) -> dict:
    """Each direction's route for states of shape (nB, nA): {"threads":
    the block size, "fwd"/"bwd": {"route", "smem" (bytes)}}.  The state
    stays in shared memory when its buffers fit; else in a (B, buffers,
    nd) scratch in device memory, when the table ring alone fits; else
    ValueError."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the gate scan kernel takes float32 or float64, "
                        f"got {dtype}")
    if min(nB, nA) < 1:
        raise ValueError(f"empty gate scan shape (nB, nA)=({nB}, {nA})")
    itemsize = torch.empty((), dtype=dtype).element_size()
    nd = nA * nB
    plan = {"threads": _threads(nd)}
    for direction, bufs in (("fwd", _FWD_BUFFERS), ("bwd", _BWD_BUFFERS)):
        smem = _smem_bytes(nB, nA, itemsize, bufs)
        if smem <= _SMEM_LIMIT:
            plan[direction] = dict(route="smem", smem=smem)
            continue
        smem = _smem_bytes(nB, nA, itemsize, 0)
        if smem > _SMEM_LIMIT or bufs * nd >= 2 ** 31:
            raise ValueError(
                f"the gate scan kernel takes no route for (nB, nA) = ({nB}, "
                f"{nA}) at {dtype}: its table ring needs {smem} bytes of "
                f"shared memory (at most {_SMEM_LIMIT})")
        plan[direction] = dict(route="global", smem=smem)
    return plan


# int32 copies of the partner maps, once per tables dict: id(PA) ->
# (a weak reference to PA, PA as int32, PB as int32)
_INDEX32 = {}


def _index32(tabs: dict) -> tuple:
    key = tabs["PA"]
    got = _INDEX32.get(id(key))
    if got is None or got[0]() is not key:
        got = (weakref.ref(key), key.to(torch.int32).contiguous(),
               tabs["PB"].to(torch.int32).contiguous())
        _INDEX32[id(key)] = got
        weakref.finalize(key, _INDEX32.pop, id(key), None)
    return got[1:]


def _tables(tabs: dict, c: torch.Tensor, s: torch.Tensor, dev,
            dtype) -> list:
    """The kernel's table arguments: PA PB AD .. VR c s."""
    pa, pb = _index32(tabs)
    tables = [pa, pb, *(tabs[k].to(dtype).contiguous() for k in _FLOAT_KEYS),
              c, s]
    for t in tables:
        if t.device != dev:
            raise ValueError(f"gate scan: a table on {t.device}, the state "
                             f"on {dev}; all must be on one CUDA device")
    return tables


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


def _launch(direction: str, V: torch.Tensor, tensors: list,
            c: torch.Tensor, s: torch.Tensor, tabs: dict,
            route: str = None) -> None:
    """One launch of gate_scan_<direction> on B contiguous (B, nB, nA)
    states: `tensors` are its state arguments after the tables (forward:
    V0, out; backward: V, W, w0, dth).  `route` overrides the plan's (the
    card tests force the global route at small shapes)."""
    B, nB, nA = V.shape
    K = int(c.shape[0])
    route = route or _plan(nB, nA, V.dtype)[direction]["route"]
    bufs = _FWD_BUFFERS if direction == "fwd" else _BWD_BUFFERS
    scratch = torch.empty(B * bufs * nA * nB, dtype=V.dtype,
                          device=V.device) if route == "global" else None
    lib = _lib()
    fn = getattr(lib, f"esoo_gate_scan_{direction}_"
                 f"{'f32' if V.dtype == torch.float32 else 'f64'}")
    args = _tables(tabs, c, s, V.device, V.dtype) + tensors
    with torch.cuda.device(V.device):
        rc = fn(*(t.data_ptr() for t in args),
                None if scratch is None else scratch.data_ptr(), B, K, nA,
                nB, _ROUTES.index(route),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gate scan {direction} kernel launch failed: "
                           f"CUDA error {rc}")
    apply_rev_str.launches += 1
    apply_rev_str.direction_launches[direction] += 1
    apply_rev_str.route_launches[route] += 1


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


def reset_launch_counts() -> None:
    apply_rev_str.launches = 0
    apply_rev_str.direction_launches = {"fwd": 0, "bwd": 0}
    apply_rev_str.route_launches = dict.fromkeys(_ROUTES, 0)


def launch_counts() -> dict:
    return {"gate_scan.apply_rev_str": apply_rev_str.launches}


def route_launch_counts() -> dict:
    """The scan's launches by direction ("fwd", "bwd") and by route
    ("smem", "global")."""
    return {**apply_rev_str.direction_launches,
            **apply_rev_str.route_launches}


reset_launch_counts()
