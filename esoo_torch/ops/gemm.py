"""Hand-written CUDA GEMM and the 4-index integral transform.

Counterparts of esoo_tpu/ops/pallas_kernels.py:

  * `matmul(x, y, trans_x=False)`  <- `matmul_pallas` (Pallas tiled GEMM,
    pl.pallas_call at pallas_kernels.py:80).  Kernel: csrc/gemm.cu.
  * `rotate_two_body_shard(g_loc, u, u_loc)`: one shard's partial
    transform for a g sharded on its last axis (parallel/sharded.py),
    four `matmul` launches at the shard's shapes.
  * `rotate_two_body_cuda(g, u)`   <- `rotate_two_body_pallas`
    (pallas_kernels.py:108).  For n <= 8 (and a ring of two slabs that
    fits in shared memory) one pass over g in one C call, two launches:
    csrc/transform.cu.  Otherwise `rotate_two_body_chain`: four `matmul`
    launches, each contracting the LEADING axis with trans_x=True, in the
    order of orbital_optimization.kernels.rotate_two_body.
    `_transform_plan` makes that choice.

Bound on an H100 (both kernels): bytes.  At the H4 cc-pVTZ headline shape
(m=56, n=4, float32) the transform must read the 39 MB g tensor once
(~12 us at 3.35 TB/s) and does ~86 MFLOP (~1.3 us at the 67 TFLOP/s
float32 CUDA-core peak); see the notes at the top of csrc/transform.cu
and csrc/gemm.cu for what each design does about it.

Each wrapper has a plain PyTorch twin (`matmul_plain`,
`rotate_two_body_plain`).  The wrapper runs the twin only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.  The launches
are counted by ops/_build.py: `gemm.matmul` (every K1 launch, the chain's
and a shard's too) and `transform.transform` (two a one-pass call).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.float64)
_NARROW_N = 16                   # trans_x and N <= 16: gemm_narrow_ring
# gemm_narrow_ring's constants (csrc/gemm.cu), mirrored by _narrow_plan
_NARROW_THREADS = 256            # kThreads
_NARROW_RING = 2                 # kRing: stages in the cp.async ring
_NARROW_STAGE_K = 16             # kStageK: k-rows of x a stage
_NARROW_Y_BYTES = 16384          # kYBytes: the y chunk
_NARROW_OUT_LANES = 8            # kOutLanes: lanes a warp stages a round
_MAX_TILE_ROWS = 65535 * 64      # gemm_tiled grid.y limit
_FUSED_MAX_N = 8                 # transform.cu: n^4 <= 16 accumulators x 256
_FUSED_MAX_M = 256               # transform.cu: a thread to a slab column
_MAX_STAGES = 8                  # transform.cu: slabs in the ring
_SMEM_LIMIT = 232448             # shared memory a block may use (227 KB)
_SMEM_TWO_BLOCKS = 115712        # (228 KB an SM - 1 KB a block) / 2


# x, y, out, M, K, N, trans_x; g, u, partials, out, m, n, blocks, stages
_build.entries("gemm", {
    f"esoo_matmul_{t}": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4, 1)
    for t in ("f32", "f64")})
_build.entries("transform", {
    f"esoo_transform_{t}": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4, 2)
    for t in ("f32", "f64")})


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gemm")
    lib.esoo_matmul_narrow_plan.restype = ctypes.c_int
    lib.esoo_matmul_narrow_plan.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    return lib


def _transform_smem(m: int, n: int, itemsize: int, stages: int) -> int:
    """Dynamic shared memory of csrc/transform.cu's pass: `stages` slabs
    (64 x 64 on its fast path: float32, n <= 4, m <= 64 and a multiple of
    4; else m^2 elements rounded up to 16 bytes), u as (m, nb) with nb = 4
    or 8 columns, 16 values of Y for each of 256 threads and V
    (nb, nb, nb)."""
    per16 = 16 // itemsize
    if itemsize == 4 and n <= 4 and m <= 64 and m % 4 == 0:
        stride = 64 * 64
    else:
        stride = -(-m * m // per16) * per16
    nb = 4 if n <= 4 else 8
    return itemsize * (stages * stride + m * nb + 256 * 16 + nb ** 3)


def _transform_plan(m: int, n: int, itemsize: int) -> tuple:
    """("fused", stages) for csrc/transform.cu, else ("chain", 0) for the
    four-launch K1 chain (n > 8, m > 256, or not even a ring of two slabs
    fits a block's shared memory).  The ring is as deep as lets two blocks
    share an SM (at most 8 slabs), or failing that as deep as fits one."""
    if 1 <= n <= _FUSED_MAX_N and m <= _FUSED_MAX_M:
        for limit in (_SMEM_TWO_BLOCKS, _SMEM_LIMIT):
            for stages in range(_MAX_STAGES, 1, -1):
                if _transform_smem(m, n, itemsize, stages) <= limit:
                    return "fused", stages
    return "chain", 0


def _narrow_plan(M: int, K: int, N: int, itemsize: int, sms: int,
                 per_sm: int) -> dict:
    """The launch plan of csrc/gemm.cu's gemm_narrow_ring for out = x^T y
    (x (K, M), y (K, N), N <= 16) on a card of `sms` SMs that holds
    `per_sm` blocks an SM: y padded to nb columns; `rows` rows of out a
    thread (16 bytes of x a k); a ring of `ring` stages of `stage_k`
    k-rows; y staged in chunks of `y_rows` rows; `smem` bytes of dynamic
    shared memory; a persistent 1-D grid of `blocks` blocks (at most one a
    warp's groups) over the G = `groups` groups of `rows` rows, which
    deals tiles of 256 groups to the blocks in rounds and splits the
    groups past the last full round evenly over them; `stages` ring
    stages a tile; 16-byte copies of x when its rows are 16-byte aligned
    (`vec`)."""
    nb = 4 if N <= 4 else (8 if N <= 8 else 16)
    rows = 16 // itemsize
    groups = -(-M // rows)
    smem = (_NARROW_RING * _NARROW_STAGE_K * _NARROW_THREADS * 16
            + _NARROW_Y_BYTES
            + _NARROW_THREADS // 32 * _NARROW_OUT_LANES * (nb + 1) * 16)
    return dict(nb=nb, rows=rows, stage_k=_NARROW_STAGE_K,
                ring=_NARROW_RING, y_rows=_NARROW_Y_BYTES // (nb * itemsize),
                smem=smem, sms=sms, per_sm=per_sm,
                blocks=min(sms * per_sm, -(-groups // 32)),
                stages=max(1, -(-K // _NARROW_STAGE_K)),
                vec=int(M * itemsize % 16 == 0), groups=groups)


def matmul_plain(x: torch.Tensor, y: torch.Tensor, *,
                 trans_x: bool = False) -> torch.Tensor:
    """Plain PyTorch version of `matmul`: x @ y, or x.T @ y."""
    return (x.T if trans_x else x) @ y


def matmul(x: torch.Tensor, y: torch.Tensor, *,
           trans_x: bool = False) -> torch.Tensor:
    """(M, K) @ (K, N) — or, with trans_x, x stored (K, M) row-major and
    contracted over its leading axis (x.T @ y without a transposed copy).

    CUDA tensors (float32 or float64, contiguous, same device) run the
    hand-written kernel; CPU tensors run `matmul_plain`."""
    if x.device.type == "cpu" and y.device.type == "cpu":
        return matmul_plain(x, y, trans_x=trans_x)
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError(f"matmul: tensors on {x.device} and {y.device}; "
                         "both must be on one CUDA device (or both on CPU)")
    if x.dtype != y.dtype or x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"matmul kernel takes float32 or float64 pairs, got "
                        f"{x.dtype} and {y.dtype}")
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError("matmul takes 2-D operands")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul kernel takes contiguous (row-major) operands")
    if trans_x:
        K, M = x.shape
    else:
        M, K = x.shape
    if y.shape[0] != K:
        raise ValueError(f"contraction mismatch: x gives K={K}, y is "
                         f"{tuple(y.shape)}")
    N = y.shape[1]
    tiled = not (trans_x and N <= _NARROW_N)      # see csrc/gemm.cu launch()
    if max(M, K, N) >= 2 ** 31 or (tiled and M > _MAX_TILE_ROWS):
        raise ValueError(f"matmul kernel shape out of range: M={M} K={K} "
                         f"N={N} trans_x={trans_x}")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _build.launch("gemm", f"esoo_matmul_{_build.TAGS[x.dtype]}", x.device,
                  x, y, out, M, K, N, int(bool(trans_x)))
    return out


def rotate_two_body_plain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `rotate_two_body_cuda` (the tensordot chain
    of orbital_optimization.kernels.rotate_two_body)."""
    t = torch.tensordot(g, u, dims=([0], [0]))       # (q, r, s, i)
    t = torch.tensordot(t, u, dims=([0], [0]))       # (r, s, i, j)
    t = torch.tensordot(t, u, dims=([0], [0]))       # (s, i, j, k)
    return torch.tensordot(t, u, dims=([0], [0]))    # (i, j, k, l)


def rotate_two_body_cuda(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """g_rot[i,j,k,l] = sum_pqrs g[p,q,r,s] u[p,i] u[q,j] u[r,k] u[s,l].

    CUDA tensors take the route of `_transform_plan`: one pass over g
    (csrc/transform.cu, two launches from one C call) or the four-launch
    K1 chain (`rotate_two_body_chain`).  Not differentiable: the BB
    descent's gradient comes from ops/orbital_vag.py where
    `orbital_vag.onepass_route` holds, else from autograd of
    orbital_optimization.kernels.rotate_two_body_auto.  CPU tensors run
    `rotate_two_body_plain`."""
    if g.device.type == "cpu" and u.device.type == "cpu":
        return rotate_two_body_plain(g, u)
    _check_transform_args(g, u)
    m, n = u.shape
    route, stages = _transform_plan(m, n, g.element_size())
    if route == "chain":
        return rotate_two_body_chain(g, u)
    u = u.contiguous()
    blocks = 2 * _build.sm_count(g.device)
    partials = torch.empty((blocks, n ** 4), dtype=g.dtype, device=g.device)
    out = torch.empty((n,) * 4, dtype=g.dtype, device=g.device)
    _build.launch("transform", f"esoo_transform_{_build.TAGS[g.dtype]}",
                  g.device, g, u, partials, out, m, n, blocks, stages)
    return out


def rotate_two_body_chain(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The transform as four `matmul` launches with trans_x=True: each
    stage reads its input as stored, (m, rest) row-major, and writes
    (rest, n), which is the next stage's (m, rest') layout, so no stage
    transposes anything.  CUDA tensors only."""
    _check_transform_args(g, u)
    m, n = u.shape
    u = u.contiguous()
    t = g
    rest = m * m * m
    for _ in range(4):
        t = matmul(t.reshape(m, rest), u, trans_x=True)
        rest = rest // m * n
    return t.reshape(n, n, n, n)


def rotate_two_body_shard_plain(g_loc: torch.Tensor, u: torch.Tensor,
                                u_loc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `rotate_two_body_shard`: the tensordot
    chain with u_loc in the last stage."""
    t = torch.tensordot(g_loc, u, dims=([0], [0]))     # (q, r, s_loc, i)
    t = torch.tensordot(t, u, dims=([0], [0]))         # (r, s_loc, i, j)
    t = torch.tensordot(t, u, dims=([0], [0]))         # (s_loc, i, j, k)
    return torch.tensordot(t, u_loc, dims=([0], [0]))  # (i, j, k, l)


def rotate_two_body_shard(g_loc: torch.Tensor, u: torch.Tensor,
                          u_loc: torch.Tensor) -> torch.Tensor:
    """One shard's partial transform for a g sharded on its last axis
    (parallel/sharded.py): g_loc (m, m, m, m_loc) holds g[..., s_d] and
    u_loc (m_loc, n) the rows s_d of u; the partial is
        sum_{pqr, s in s_d} g[p,q,r,s] u[p,i] u[q,j] u[r,k] u[s,l],
    and the shards' partials sum to the transform.  CUDA tensors run four
    `matmul` launches with trans_x=True, stage 4 contracting the local
    axis, (m_loc, n^3)^T (m_loc, n); CPU tensors run
    `rotate_two_body_shard_plain`.  Not differentiable."""
    if g_loc.device.type == "cpu" and u.device.type == "cpu" and \
            u_loc.device.type == "cpu":
        return rotate_two_body_shard_plain(g_loc, u, u_loc)
    _check_shard_args(g_loc, u, u_loc)
    m, n = u.shape
    m_loc = u_loc.shape[0]
    u = u.contiguous()
    t = matmul(g_loc.reshape(m, m * m * m_loc), u, trans_x=True)
    t = matmul(t.reshape(m, m * m_loc * n), u, trans_x=True)
    t = matmul(t.reshape(m, m_loc * n * n), u, trans_x=True)
    t = matmul(t.reshape(m_loc, n ** 3), u_loc.contiguous(), trans_x=True)
    return t.reshape(n, n, n, n)


def _check_shard_args(g_loc: torch.Tensor, u: torch.Tensor,
                      u_loc: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (g_loc, u, u_loc)):
        raise RuntimeError("rotate_two_body_shard has no backward; call it "
                           "under torch.no_grad() or on detached tensors")
    if g_loc.device.type != "cuda" or u.device != g_loc.device or \
            u_loc.device != g_loc.device:
        raise ValueError(
            f"rotate_two_body_shard: tensors on {g_loc.device}, {u.device} "
            f"and {u_loc.device}; all must be on one CUDA device (or all "
            "on CPU)")
    if not (g_loc.dtype == u.dtype == u_loc.dtype) or \
            g_loc.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"rotate_two_body_shard takes float32 or float64, "
                        f"got {g_loc.dtype}, {u.dtype} and {u_loc.dtype}")
    m, n = u.shape if u.dim() == 2 else (-1, -1)
    if g_loc.dim() != 4 or g_loc.shape[:3] != (m, m, m) or \
            u_loc.dim() != 2 or u_loc.shape != (g_loc.shape[3], n):
        raise ValueError(
            f"expected g_loc (m,m,m,m_loc), u (m,n) and u_loc (m_loc,n), "
            f"got {tuple(g_loc.shape)}, {tuple(u.shape)} and "
            f"{tuple(u_loc.shape)}")
    if not g_loc.is_contiguous():
        raise ValueError("rotate_two_body_shard takes a contiguous g_loc")


def _check_transform_args(g: torch.Tensor, u: torch.Tensor) -> None:
    if torch.is_grad_enabled() and (g.requires_grad or u.requires_grad):
        raise RuntimeError("rotate_two_body_cuda has no backward; call it "
                           "under torch.no_grad() or on detached tensors")
    if g.device.type != "cuda" or u.device != g.device:
        raise ValueError(f"rotate_two_body_cuda: tensors on {g.device} and "
                         f"{u.device}; both must be on one CUDA device (or "
                         "both on CPU)")
    if g.dtype != u.dtype or g.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"rotate_two_body_cuda takes float32 or float64 "
                        f"pairs, got {g.dtype} and {u.dtype}")
    if g.dim() != 4 or len(set(g.shape)) != 1 or u.dim() != 2 \
            or u.shape[0] != g.shape[0]:
        raise ValueError(f"expected g (m,m,m,m) and u (m,n), got "
                         f"{tuple(g.shape)} and {tuple(u.shape)}")
    if not g.is_contiguous():
        raise ValueError("rotate_two_body_cuda takes a contiguous g")
