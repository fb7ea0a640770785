"""Numerical guards and debug helpers.

Port of esoo_tpu/utils/debug.py.  The reference's closest analogues are
its correctness guards: imaginary-RDM residue detection via module-global
flags (base_opt_orb_solver.py:380-401, :470-493) and SSVQE's
initial-state orthogonality validation (ssvqe.py:484-494).  Here the
guards are explicit helpers on tensors (or NumPy arrays), plus an opt-in
NaN-debugging mode (autograd anomaly detection).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Iterator

import numpy as np
import torch


@contextlib.contextmanager
def nan_checks() -> Iterator[None]:
    """Autograd anomaly detection inside the block: a backward pass that
    produces a NaN raises at the operation whose forward made it, with
    that operation's traceback (the JAX package's jax_debug_nans)."""
    with torch.autograd.detect_anomaly(check_nan=True):
        yield


def check_imaginary_residue(tensor, atol: float = 1e-8, what: str = "RDM",
                            strip: bool = True):
    """Imaginary-residue detection (reference semantics: flags flipped when
    any RDM element has imaginary residue, base_opt_orb_solver.py:380-401).

    strip=True (the `wavefuntion_real` path) warns when the residue
    exceeds atol and returns the real part; strip=False returns the
    tensor intact (the complex-RDM objective path) without warning — the
    user never claimed the wavefunction was real.  Tensors stay on their
    device; NumPy arrays stay NumPy."""
    if torch.is_tensor(tensor):
        if not tensor.is_complex():
            return tensor
        if not strip:
            return tensor
        resid = float(tensor.imag.abs().max()) if tensor.numel() else 0.0
        real = tensor.real.contiguous()
    else:
        t = np.asarray(tensor)
        if not np.iscomplexobj(t):
            return t
        if not strip:
            return t
        resid = float(np.abs(t.imag).max(initial=0.0))
        real = np.ascontiguousarray(t.real)
    if resid > atol:
        warnings.warn(f"{what} has imaginary residue {resid:.2e} > "
                      f"{atol:.0e}; wavefunction may not be real",
                      stacklevel=2)
    return real


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def check_partial_unitary(U, atol: float = 1e-8) -> None:
    """Raise unless U^T U = I (columns orthonormal)."""
    U = _numpy(U)
    err = float(np.abs(U.T @ U - np.eye(U.shape[1])).max())
    if err > atol:
        raise ValueError(f"partial unitary violates U^T U = I by {err:.2e}")


def check_rdm_sanity(gamma, Gamma, num_particles: int,
                     atol: float = 1e-6) -> None:
    """Physicality checks: trace(gamma) = N_e, gamma Hermitian, Gamma
    antisymmetry Gamma[p,q,r,s] = -Gamma[q,p,r,s]."""
    gamma, Gamma = _numpy(gamma), _numpy(Gamma)
    tr = float(np.real(np.trace(gamma)))
    if abs(tr - num_particles) > atol:
        raise ValueError(f"trace(1-RDM) = {tr}, expected {num_particles}")
    if np.abs(gamma - gamma.conj().T).max() > atol:
        raise ValueError("1-RDM is not Hermitian")
    if np.abs(Gamma + Gamma.transpose(1, 0, 2, 3)).max() > atol:
        raise ValueError("2-RDM violates index antisymmetry")
