"""Hand-written CUDA GEMM and the 4-index integral transform built on it.

Counterparts of esoo_tpu/ops/pallas_kernels.py:

  * `matmul(x, y, trans_x=False)`  <- `matmul_pallas` (Pallas tiled GEMM,
    pl.pallas_call at pallas_kernels.py:80).  Kernel: csrc/gemm.cu.
  * `rotate_two_body_cuda(g, u)`   <- `rotate_two_body_pallas`
    (pallas_kernels.py:108): four `matmul` launches, each contracting the
    LEADING axis with trans_x=True, in the order of
    orbital_optimization.kernels.rotate_two_body.

Bound on an H100 (both kernels): bytes.  At the H4 cc-pVTZ headline shape
(m=56, n=4, float32) the transform must read the 39 MB g tensor once
(~12 us at 3.35 TB/s) and does ~85 MFLOP (~1.3 us at the 67 TFLOP/s
float32 CUDA-core peak); see csrc/gemm.cu for what the design does about
it.

Each wrapper has a plain PyTorch twin (`matmul_plain`,
`rotate_two_body_plain`).  The wrapper runs the twin only for tensors on
the CPU; for CUDA tensors it launches the kernel or raises.  `launches`
on each wrapper counts its kernel launches (reset_launch_counts /
launch_counts), so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.float64)
_NARROW_N = 16                   # trans_x and N <= 16: gemm_narrow_tx, 1-D grid
_MAX_TILE_ROWS = 65535 * 64      # gemm_tiled grid.y limit


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("gemm")
    for fn in (lib.esoo_matmul_f32, lib.esoo_matmul_f64):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
    return lib


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
    lib = _lib()
    fn = lib.esoo_matmul_f32 if x.dtype == torch.float32 else \
        lib.esoo_matmul_f64
    with torch.cuda.device(x.device):             # launch on x's own device
        rc = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), M, K, N,
                int(bool(trans_x)), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gemm kernel launch failed: CUDA error {rc}")
    matmul.launches += 1
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

    Four `matmul` launches with trans_x=True: each stage reads its input
    as stored, (m, rest) row-major, and writes (rest, n) — which is the
    next stage's (m, rest') layout, so no stage transposes anything.
    Not differentiable (the orbital gradient path uses
    rotate_two_body_auto); CPU tensors run `rotate_two_body_plain`."""
    if g.device.type == "cpu" and u.device.type == "cpu":
        return rotate_two_body_plain(g, u)
    if torch.is_grad_enabled() and (g.requires_grad or u.requires_grad):
        raise RuntimeError("rotate_two_body_cuda has no backward; call it "
                           "under torch.no_grad() or on detached tensors")
    if g.dim() != 4 or len(set(g.shape)) != 1 or u.dim() != 2 \
            or u.shape[0] != g.shape[0]:
        raise ValueError(f"expected g (m,m,m,m) and u (m,n), got "
                         f"{tuple(g.shape)} and {tuple(u.shape)}")
    if not g.is_contiguous():
        raise ValueError("rotate_two_body_cuda takes a contiguous g")
    m, n = u.shape
    u = u.contiguous()
    t = g
    rest = m * m * m
    for _ in range(4):
        t = matmul(t.reshape(m, rest), u, trans_x=True)
        rotate_two_body_cuda.launches += 1
        rest = rest // m * n
    return t.reshape(n, n, n, n)


def reset_launch_counts() -> None:
    matmul.launches = 0
    rotate_two_body_cuda.launches = 0


def launch_counts() -> dict:
    return {"gemm.matmul": matmul.launches,
            "gemm.rotate_two_body_cuda": rotate_two_body_cuda.launches}


reset_launch_counts()
