"""The Davidson sigma's gathers over single-excitation lists as
hand-written CUDA kernels (csrc/sigma_lists.cu), with their plain twins.

A same-spin operator D_q = a+_p a_r of the string sector is a signed
partial permutation of one spin's strings: `src[q, j]` is the string it
moves to string j (int32, -1 where there is none) and `sgn[q, j]` the
Jordan-Wigner sign of that move (int8, 0 there); sim/strings.py::
one_body_lists reads both off the operator stacks.

  * `alpha_gather(V, src, sgn)`: T[q, r, j] = sgn[q, j] V[r, src[q, j]]
    for V (R, ns), i.e. T_q = V D_q^T, (q, R, ns).
  * `beta_gather(Y, src, sgn, base)`: out[k, j, i] = base[k, j, i] + sum
    over q ascending of sgn[q, j] Y[q, k, src[q, j], i] for Y (q, K, ns,
    C) and base (K, ns, C), i.e. base_k + sum_q D_q Y[q, k], the terms
    added in ascending q (src[q, j] = -1 adds nothing) in float64 at
    either precision and rounded once to the data's dtype.

They replace no TPU kernel: the JAX package's sigma (esoo_tpu/sim/
strings.py:683, K4) is jnp over the dense stacks.  What bounds each on an
H100 is in the source: the 1.57 GB of T written once (0.47 ms) and the
353 MB of Y read once (0.105 ms) at H8 -> 28, float64.

Each wrapper runs its plain version for tensors on the CPU; for CUDA
tensors it launches its kernel or raises; ops/_build.py counts the
launches (`sigma_lists.alpha_gather`, `sigma_lists.beta_gather`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.float64)
_MAX_OPS = 1024      # csrc/sigma_lists.cu's kMaxOps: beta_gather's operators
_INT_MAX = 2 ** 31 - 1


# alpha: V src sgn out q R ns; beta: Y src sgn base out q K ns C
_ALPHA = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
_BETA = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
_build.entries("sigma_lists", {
    f"esoo_{kind}_gather_{t}": (args, 1)
    for kind, args in (("alpha", _ALPHA), ("beta", _BETA))
    for t in ("f32", "f64")})


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("sigma_lists")
    lib.esoo_beta_gather_max_ops.restype = ctypes.c_int
    lib.esoo_beta_gather_max_ops.argtypes = []
    return lib


def alpha_gather_plain(V: torch.Tensor, src: torch.Tensor,
                       sgn: torch.Tensor) -> torch.Tensor:
    """T[q, r, j] = sgn[q, j] V[r, src[q, j]] (0 where src is -1)."""
    R, ns = V.shape
    q = src.shape[0]
    T = V[:, src.clamp(min=0).long().reshape(-1)].reshape(R, q, ns)
    return (T * sgn.to(V.dtype)).transpose(0, 1).contiguous()


def beta_gather_plain(Y: torch.Tensor, src: torch.Tensor, sgn: torch.Tensor,
                      base: torch.Tensor) -> torch.Tensor:
    """base[k, j] + sum_q sgn[q, j] Y[q, k, src[q, j]], the terms added in
    ascending q in float64 and rounded once to Y's dtype, as the kernel
    adds them."""
    f64 = torch.float64
    out = base.to(f64, copy=True)
    for q in range(src.shape[0]):
        j = torch.nonzero(src[q] >= 0).squeeze(1)
        out[:, j] += (sgn[q, j].to(f64)[:, None]
                      * Y[q][:, src[q, j].long()].to(f64))
    return out.to(Y.dtype)


def _check_lists(name: str, dev: torch.device, src: torch.Tensor,
                 sgn: torch.Tensor, ns: int) -> None:
    if src.dtype != torch.int32 or sgn.dtype != torch.int8:
        raise TypeError(f"{name}: src must be int32 and sgn int8, got "
                        f"{src.dtype} and {sgn.dtype}")
    if src.device != dev or sgn.device != dev:
        raise ValueError(f"{name}: lists on {src.device} and {sgn.device}, "
                         f"the data on {dev}")
    if src.dim() != 2 or src.shape != sgn.shape or src.shape[1] != ns:
        raise ValueError(f"{name}: lists of shapes {tuple(src.shape)} and "
                         f"{tuple(sgn.shape)} for {ns} strings")
    if not (src.is_contiguous() and sgn.is_contiguous()):
        raise ValueError(f"{name}: the lists must be contiguous")


def _check_data(name: str, *tensors: torch.Tensor) -> None:
    dt = tensors[0].dtype
    if dt not in _KERNEL_DTYPES:
        raise TypeError(f"the {name} kernel takes float32 or float64, "
                        f"got {dt}")
    for t in tensors:
        if t.dtype != dt or t.device != tensors[0].device:
            raise ValueError(f"{name}: operands of dtypes/devices "
                             f"{[(x.dtype, str(x.device)) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def alpha_gather(V: torch.Tensor, src: torch.Tensor,
                 sgn: torch.Tensor) -> torch.Tensor:
    """(q, R, ns) T_q = V D_q^T of V (R, ns): one launch of csrc/
    sigma_lists.cu's alpha_gather on CUDA tensors, alpha_gather_plain on
    the CPU."""
    if V.device.type == "cpu":
        return alpha_gather_plain(V, src, sgn)
    if V.dim() != 2:
        raise ValueError(f"alpha gather: V must be (R, ns), got "
                         f"{tuple(V.shape)}")
    R, ns = V.shape
    _check_data("alpha gather", V)
    _check_lists("alpha gather", V.device, src, sgn, ns)
    q = src.shape[0]
    if max(q, R, ns) > _INT_MAX:
        raise ValueError("alpha gather: a dimension past 32 bits")
    out = torch.empty((q, R, ns), dtype=V.dtype, device=V.device)
    _build.launch("sigma_lists", f"esoo_alpha_gather_{_build.TAGS[V.dtype]}",
                  V.device, V, src, sgn, out, q, R, ns)
    return out


def beta_gather(Y: torch.Tensor, src: torch.Tensor, sgn: torch.Tensor,
                base: torch.Tensor) -> torch.Tensor:
    """(K, ns, C) base_k + sum_q D_q Y[q, k] of Y (q, K, ns, C) and base
    (K, ns, C): one launch of csrc/sigma_lists.cu's beta_gather on CUDA
    tensors, beta_gather_plain on the CPU."""
    if Y.device.type == "cpu":
        return beta_gather_plain(Y, src, sgn, base)
    if Y.dim() != 4 or base.shape != Y.shape[1:]:
        raise ValueError(f"beta gather: Y {tuple(Y.shape)} must be (q, K, "
                         f"ns, C) and base {tuple(base.shape)} (K, ns, C)")
    q, K, ns, C = Y.shape
    _check_data("beta gather", Y, base)
    _check_lists("beta gather", Y.device, src, sgn, ns)
    if src.shape[0] != q:
        raise ValueError(f"beta gather: {src.shape[0]} operators' lists for "
                         f"{q} rows of Y")
    if q > _MAX_OPS:
        raise ValueError(f"beta gather: {q} operators, past the kernel's "
                         f"{_MAX_OPS}")
    if K * ns > _INT_MAX or C > _INT_MAX:
        raise ValueError("beta gather: a dimension past 32 bits")
    out = torch.empty_like(base)
    _build.launch("sigma_lists", f"esoo_beta_gather_{_build.TAGS[Y.dtype]}",
                  Y.device, Y, src, sgn, base, out, q, K, ns, C)
    return out
