"""The orbital step's value and gradient in one pass over g: a hand-written
CUDA kernel (csrc/orbital_vag.cu) and its plain PyTorch twin.

The BB descent over partial unitaries U (m, n) minimizes

    E(U) = sum (U^T h U) (.) gamma + sum (g x1 U x2 U x3 U x4 U) (.) Gamma

at fixed RDMs.  Differentiating the kron sandwich of
orbital_optimization.kernels.rotated_energy_spatial with autograd costs two
(m^2, m^2) x (m^2, n^2) GEMMs an evaluation (2 x 61.7 GFLOP at H8 cc-pVTZ
-> 28).  For a g with the pair symmetry g[p,q,r,s] = g[r,s,p,q] (every
real ERI tensor) the value and the gradient follow from the
half-transform X[p,q,k,l] = (U^T g[p,q] U)[k,l] of each slab and the
pair-symmetrised Gt = (Gamma + Gamma^(k,l,i,j)) / 2:

    W1[p,j,kl] = sum_q U[q,j] X[p,q,kl]     s1[p,i] = sum Gt[i,j,kl] W1[p,j,kl]
    W2[q,i,kl] = sum_p U[p,i] X[p,q,kl]     s2[q,j] = sum Gt[i,j,kl] W2[q,i,kl]
    E2 = sum U (.) s1,                      dE2/dU = 2 (s1 + s2)

and the kernel forms them in one read of g (the design and what bounds it:
the notes at the top of csrc/orbital_vag.cu).  The one-body part is plain
PyTorch (m x m).

  * `orbital_value_and_grad_cuda(U, gamma, Gamma, h, g)` -> (E, dE/dU),
    detached: the kernel on CUDA tensors, `orbital_value_and_grad_plain`
    (the same formulas with tensordot) on CPU tensors.
  * `onepass_route(device, dtype, m, n, pair_symmetric)`: whether the
    fused solvers' BB descent takes it (a CUDA device, float32 or
    float64, m <= 256, n <= 16, and a g that passed `pair_symmetric`).
  * `pair_symmetric(g)`: the check, `pair_asymmetry` (one read of g by
    csrc/orbital_vag.cu's pair_asym_tiles on the card) within `pair_rtol`.

It replaces no TPU kernel: the JAX package evaluates the energy with jnp
and differentiates it with jax.grad.  ops/_build.py counts the launches
(`orbital_vag.orbital_vag`, four a call; `orbital_vag.pair_asymmetry`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_KERNEL_DTYPES = (torch.float32, torch.float64)
_MAX_M = 256                # csrc/orbital_vag.cu kMaxM
_MAX_N = 16                 # kMaxN
# esoo_orbital_vag_plan's fields (csrc/orbital_vag.cu's Plan)
_PLAN_FIELDS = ("nb", "mp", "spb", "threads", "steps", "depth", "per_sm",
                "smem", "finish_smem", "work")
# |g - g^(r,s,p,q)| <= rtol max|g| at float64: well above the asymmetry
# that rounding leaves in an MO transform (3e-14 of max|g| at H4 cc-pVDZ,
# 1.2e-13 at H4 cc-pVTZ, growing with the basis), far below any asymmetry
# of a g that lacks the symmetry; the route's gradient then differs from
# autograd's by that relative order at most.  At float32: 4 units in the
# last place (a float32 cast of a symmetric float64 g differs by one)
_PAIR_RTOL_F64 = 1e-10
_PAIR_CHUNK = 1 << 23       # elements compared at once (64 MB at float64)


_VAG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3  # g u Gamma work out m n sms
_ASYM = [ctypes.c_void_p] * 2 + [ctypes.c_int]     # g partials m
# a value and gradient is four launches: orbital_sym, orbital_pass, _finish,
# _combine
_build.entries("orbital_vag", {
    f"esoo_{kernel}_{t}": spec
    for kernel, spec in (("orbital_vag", (_VAG, 4)),
                         ("pair_asymmetry", (_ASYM, 1)))
    for t in ("f32", "f64")})


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("orbital_vag")
    lib.esoo_orbital_vag_plan.restype = ctypes.c_int
    lib.esoo_orbital_vag_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    return lib


def _workspace(m: int, n: int) -> int:
    """Elements of the kernel's workspace: X (m^2 n^2), Gt (n^4), s1 and
    s2 (2 m n)."""
    return m * m * n * n + n ** 4 + 2 * m * n


def kernel_plan(m: int, n: int, itemsize: int) -> dict:
    """The launch plan as the built kernel makes it (esoo_orbital_vag_plan;
    the fields of csrc/orbital_vag.cu's Plan)."""
    out = (ctypes.c_int * len(_PLAN_FIELDS))()
    rc = _lib().esoo_orbital_vag_plan(m, n, itemsize, out)
    if rc != 0:
        raise ValueError(f"the orbital kernel refuses m={m}, n={n}, "
                         f"itemsize={itemsize}")
    return dict(zip(_PLAN_FIELDS, out))


def onepass_route(device, dtype: torch.dtype, m: int, n: int,
                  pair_symmetric: bool) -> bool:
    """Whether the BB descent's value and gradient take the kernel: a CUDA
    device, float32 or float64, m <= 256, n <= 16 and a g that passed the
    pair-symmetry check; anything else keeps autograd."""
    return (torch.device(device).type == "cuda" and dtype in _KERNEL_DTYPES
            and 1 <= m <= _MAX_M and 1 <= n <= _MAX_N
            and bool(pair_symmetric))


def pair_rtol(dtype: torch.dtype) -> float:
    """The pair-symmetry check's tolerance relative to max|g|."""
    return max(_PAIR_RTOL_F64, 4 * torch.finfo(dtype).eps)


def pair_asymmetry_plain(g: torch.Tensor) -> float:
    """max |g[p,q,r,s] - g[r,s,p,q]| / max|g|: the upper triangle of G2 = g
    as (m^2, m^2) against the lower, a band of rows at a time (at most 8M
    elements a band)."""
    mm = g.shape[0] ** 2
    G2 = g.reshape(mm, mm)
    lo, hi = torch.aminmax(G2)
    worst = torch.zeros((), dtype=g.dtype, device=g.device)
    rows = max(1, _PAIR_CHUNK // mm)
    for i in range(0, mm, rows):
        j = min(mm, i + rows)
        band = (G2[i:j, i:] - G2[i:, i:j].T).abs_().amax()
        worst = torch.maximum(worst, band)
    return float(worst / torch.maximum(lo.abs(), hi.abs()))


def pair_asymmetry(g: torch.Tensor) -> float:
    """max |g[p,q,r,s] - g[r,s,p,q]| / max|g| of an (m, m, m, m) g (inf for
    any other shape): csrc/orbital_vag.cu's pair_asym_tiles, one read of g
    and one sync, for a contiguous float32 or float64 g on the card with m
    <= 256; `pair_asymmetry_plain` for a CPU g."""
    m = g.shape[0]
    if g.dim() != 4 or g.shape != (m,) * 4:
        return float("inf")
    if g.device.type == "cpu":
        return pair_asymmetry_plain(g)
    if g.dtype not in _KERNEL_DTYPES or m > _MAX_M or not g.is_contiguous():
        raise ValueError(f"the pair-symmetry kernel takes a contiguous "
                         f"float32 or float64 g with m <= {_MAX_M}; got "
                         f"{g.dtype}, m={m}")
    tiles = -(-m * m // 32)
    partials = torch.empty((tiles * tiles, 2), dtype=g.dtype, device=g.device)
    _build.launch("orbital_vag", f"esoo_pair_asymmetry_{_build.TAGS[g.dtype]}",
                  g.device, g, partials, m)
    worst, scale = partials.amax(dim=0).tolist()
    return worst / scale if scale > 0 else float("nan")


def pair_symmetric(g: torch.Tensor) -> bool:
    """Whether g has the pair symmetry to pair_rtol(g.dtype)."""
    return pair_asymmetry(g) <= pair_rtol(g.dtype)


def _one_body(U, gamma, h):
    """(P, Q) = (h U gamma^T, h^T U gamma): E1 = sum (U^T h U) (.) gamma
    = sum U (.) P and dE1/dU = P + Q."""
    P = (h @ U) @ gamma.T
    return P, h.T @ (U @ gamma)


def orbital_value_and_grad_plain(U: torch.Tensor, gamma: torch.Tensor,
                                 Gamma: torch.Tensor, h: torch.Tensor,
                                 g: torch.Tensor):
    """(E, dE/dU) by the kernel's formulas, with tensordot: valid for a g
    with the pair symmetry."""
    U, gamma, Gamma, h, g = (t.detach() for t in (U, gamma, Gamma, h, g))
    Gt = 0.5 * (Gamma + Gamma.permute(2, 3, 0, 1))
    X = torch.tensordot(torch.tensordot(g, U, dims=([2], [0])), U,
                        dims=([2], [0]))                    # (p, q, k, l)
    W1 = torch.tensordot(U, X, dims=([0], [1]))             # (j, p, k, l)
    W2 = torch.tensordot(U, X, dims=([0], [0]))             # (i, q, k, l)
    s1 = torch.tensordot(W1, Gt, dims=([0, 2, 3], [1, 2, 3]))   # (p, i)
    s2 = torch.tensordot(W2, Gt, dims=([0, 2, 3], [0, 2, 3]))   # (q, j)
    P, Q = _one_body(U, gamma, h)
    return torch.sum(U * (P + s1)), P + Q + 2.0 * (s1 + s2)


def _check(U, gamma, Gamma, h, g) -> None:
    dev, dt = g.device, g.dtype
    if dev.type != "cuda":
        raise ValueError(f"orbital_value_and_grad_cuda: g on {dev}; the "
                         "kernel takes CUDA tensors (CPU tensors run the "
                         "plain twin)")
    if dt not in _KERNEL_DTYPES:
        raise TypeError(f"the orbital kernel takes float32 or float64, got "
                        f"{dt}")
    ops = (U, gamma, Gamma, h, g)
    if any(t.device != dev or t.dtype != dt for t in ops):
        raise ValueError(f"orbital_value_and_grad_cuda: operands of "
                         f"dtypes/devices "
                         f"{[(t.dtype, str(t.device)) for t in ops]}")
    m, n = U.shape if U.dim() == 2 else (-1, -1)
    if g.shape != (m,) * 4 or h.shape != (m, m) or gamma.shape != (n, n) \
            or Gamma.shape != (n,) * 4:
        raise ValueError(
            f"expected U (m,n), gamma (n,n), Gamma (n,n,n,n), h (m,m), g "
            f"(m,m,m,m); got {tuple(U.shape)}, {tuple(gamma.shape)}, "
            f"{tuple(Gamma.shape)}, {tuple(h.shape)}, {tuple(g.shape)}")
    if not (m <= _MAX_M and n <= _MAX_N):
        raise ValueError(f"the orbital kernel takes m <= {_MAX_M} and n <= "
                         f"{_MAX_N}; got m={m}, n={n}")
    if not g.is_contiguous():
        raise ValueError("orbital_value_and_grad_cuda takes a contiguous g")


def orbital_value_and_grad_cuda(U: torch.Tensor, gamma: torch.Tensor,
                                Gamma: torch.Tensor, h: torch.Tensor,
                                g: torch.Tensor):
    """(E, dE/dU) of the spatial orbital energy at U, detached, for a g
    with the pair symmetry (the caller's check): csrc/orbital_vag.cu's
    four launches from one C call for CUDA tensors, then the one-body part
    in PyTorch; `orbital_value_and_grad_plain` for CPU tensors."""
    if g.device.type == "cpu":
        return orbital_value_and_grad_plain(U, gamma, Gamma, h, g)
    U, gamma, Gamma, h = (t.detach() for t in (U, gamma, Gamma, h))
    _check(U, gamma, Gamma, h, g)
    m, n = U.shape
    U, Gamma = U.contiguous(), Gamma.contiguous()
    work = torch.empty(_workspace(m, n), dtype=g.dtype, device=g.device)
    out = torch.empty(m * n + 1, dtype=g.dtype, device=g.device)
    _build.launch("orbital_vag", f"esoo_orbital_vag_{_build.TAGS[g.dtype]}",
                  g.device, g, U, Gamma, work, out, m, n,
                  _build.sm_count(g.device))
    P = (h @ U) @ gamma.T
    G = out[:m * n].view(m, n).add_(P).addmm_(h.T, U @ gamma)
    return out[m * n] + torch.dot(U.reshape(-1), P.reshape(-1)), G
