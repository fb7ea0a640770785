"""The pairs gate scan as hand-written CUDA kernels (csrc/pair_scan.cu).

Counterpart of esoo_tpu/sim/sector.py:141 `_apply_rev` (a jax.custom_vjp
over the lax.scan of :129 `_apply_gates_tabled`) and its reversible
backward (:161): the K Givens-bank gates of a UCC circuit on the (...,
nd + 1) padded sector amplitudes of the pairs kernel, one kernel launch
forward and one backward.

  * `apply_rev_pairs(v0, theta, PARTNER, SFIELD)`: a
    torch.autograd.Function whose forward is one launch of
    `pair_scan_fwd` and whose backward is one launch of `pair_scan_bwd`
    plus the sum of its (B, K) dtheta partials.  The kernel reads
    PARTNER (K, nd + 1) as an int32 copy, cached once per tables dict
    (keyed on the PARTNER tensor), and SFIELD (K, nd + 1) at the state's
    type.
  * `_plan(n, dtype)`: the route of each direction for states of n = nd
    + 1 amplitudes, "smem" (the ping-pong buffers in shared memory) or
    "global" (in an L2-resident scratch), mirroring the kernel's
    smem_bytes and block_threads; a shape that neither route takes
    raises.

The plain version is sim/sector.py::_ApplyRev.  `apply_rev_pairs` runs
it for tensors on the CPU; for CUDA tensors it launches the kernels or
raises.  `apply_rev_pairs.launches` counts the kernel launches (one a
direction), split by direction and route in `route_launch_counts`.

Bound on an H100: the K-step serial dependence (see csrc/pair_scan.cu);
the bytes a direction must move (~0.17 MB at H8 -> 12 in float32) take
50 ns at 3.35 TB/s.
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
_FWD_BUFFERS = 2                 # kFwdBuffers: v ping-pong
_BWD_BUFFERS = 4                 # kBwdBuffers: v and w ping-pong
_ROUTES = ("smem", "global")     # the kernel's route argument 0, 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("pair_scan")
    ints = [ctypes.c_int] * 4                # B K n route
    for fn in (lib.esoo_pair_scan_fwd_f32, lib.esoo_pair_scan_fwd_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + ints + [ctypes.c_void_p]
    for fn in (lib.esoo_pair_scan_bwd_f32, lib.esoo_pair_scan_bwd_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 9 + ints + [ctypes.c_void_p]
    lib.esoo_pair_scan_smem_bytes.restype = ctypes.c_longlong
    lib.esoo_pair_scan_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.esoo_pair_scan_threads.restype = ctypes.c_int
    lib.esoo_pair_scan_threads.argtypes = [ctypes.c_int]
    return lib


def _threads(n: int) -> int:
    """The kernel's block size (block_threads): n rounded up to a warp, at
    most _MAX_THREADS."""
    return min(_MAX_THREADS, -(-n // 32) * 32)


def _smem_bytes(n: int, itemsize: int, bufs: int) -> int:
    """The kernel's dynamic shared memory (smem_bytes): `bufs` state
    buffers of n values (0 on the global route) and 2 x _MAX_WARPS dtheta
    warp sums."""
    return itemsize * (bufs * n + 2 * _MAX_WARPS)


def _plan(n: int, dtype: torch.dtype) -> dict:
    """Each direction's route for states of n = nd + 1 amplitudes:
    {"threads": the block size, "fwd"/"bwd": {"route", "smem" (bytes)}}.
    The state stays in shared memory when its buffers fit; else in a (B,
    buffers, n) scratch in device memory, while its indices fit 32 bits;
    else ValueError."""
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the pairs gate scan kernel takes float32 or "
                        f"float64, got {dtype}")
    if n < 1:
        raise ValueError(f"empty pairs gate scan state (n = {n})")
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = {"threads": _threads(n)}
    for direction, bufs in (("fwd", _FWD_BUFFERS), ("bwd", _BWD_BUFFERS)):
        smem = _smem_bytes(n, itemsize, bufs)
        if smem <= _SMEM_LIMIT:
            plan[direction] = dict(route="smem", smem=smem)
            continue
        if bufs * n >= 2 ** 31:
            raise ValueError(
                f"the pairs gate scan kernel takes no route for {n} "
                f"amplitudes: {bufs} buffers pass its 32-bit indices")
        plan[direction] = dict(route="global",
                               smem=_smem_bytes(n, itemsize, 0))
    return plan


# int32 copies of PARTNER, once per tables dict: id(PARTNER) -> (a weak
# reference to PARTNER, PARTNER as int32)
_INDEX32 = {}


def _index32(partner: torch.Tensor) -> torch.Tensor:
    got = _INDEX32.get(id(partner))
    if got is None or got[0]() is not partner:
        got = (weakref.ref(partner), partner.to(torch.int32).contiguous())
        _INDEX32[id(partner)] = got
        weakref.finalize(partner, _INDEX32.pop, id(partner), None)
    return got[1]


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
    `tensors` are its state arguments after the tables (forward: v0, out;
    backward: v, w, w0, dth).  `route` overrides the plan's (the card
    tests force the global route at small shapes)."""
    B, n = v.shape
    K = int(c.shape[0])
    route = route or _plan(n, v.dtype)[direction]["route"]
    bufs = _FWD_BUFFERS if direction == "fwd" else _BWD_BUFFERS
    scratch = torch.empty(B * bufs * n, dtype=v.dtype,
                          device=v.device) if route == "global" else None
    fn = getattr(_lib(), f"esoo_pair_scan_{direction}_"
                 f"{'f32' if v.dtype == torch.float32 else 'f64'}")
    args = [_index32(PARTNER), SFIELD.to(v.dtype).contiguous(), c,
            s] + tensors
    with torch.cuda.device(v.device):
        rc = fn(*(t.data_ptr() for t in args),
                None if scratch is None else scratch.data_ptr(), B, K, n,
                _ROUTES.index(route), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pairs gate scan {direction} kernel launch "
                           f"failed: CUDA error {rc}")
    apply_rev_pairs.launches += 1
    apply_rev_pairs.direction_launches[direction] += 1
    apply_rev_pairs.route_launches[route] += 1


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


def reset_launch_counts() -> None:
    apply_rev_pairs.launches = 0
    apply_rev_pairs.direction_launches = {"fwd": 0, "bwd": 0}
    apply_rev_pairs.route_launches = dict.fromkeys(_ROUTES, 0)


def launch_counts() -> dict:
    return {"pair_scan.apply_rev_pairs": apply_rev_pairs.launches}


def route_launch_counts() -> dict:
    """The scan's launches by direction ("fwd", "bwd") and by route
    ("smem", "global")."""
    return {**apply_rev_pairs.direction_launches,
            **apply_rev_pairs.route_launches}


reset_launch_counts()
