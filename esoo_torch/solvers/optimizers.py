"""Classical optimizers for variational parameter search.

Port of esoo_tpu/solvers/optimizers.py, which replaces
qiskit_algorithms.optimizers (the reference imports L_BFGS_B, COBYLA,
SLSQP, ... from there; tests/test_optorbvqe.py:9).  The SciPy-backed
wrappers keep SciPy's line searches on the host; the evaluation callbacks
they drive run on the eigensolver's device, so the host-device boundary
is one call per iterate.  GradientDescent, ADAM and SPSA are host loops
over those callbacks (SPSA's perturbations come from a seeded
numpy.random.Generator, the JAX package's stream).  `DeviceLBFGS` runs
the whole minimization on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from scipy.optimize import minimize as scipy_minimize

from ..utils.config import real_dtype, resolve_device


@dataclasses.dataclass
class OptimizerResult:
    x: np.ndarray
    fun: float
    nfev: int = 0
    njev: int = 0
    nit: int = 0


class Optimizer:
    """Base: subclasses implement minimize(fun, x0, jac=None, bounds=None)."""

    def minimize(self, fun, x0, jac=None, bounds=None) -> OptimizerResult:
        raise NotImplementedError


class _ScipyOptimizer(Optimizer):
    method: str = ""
    uses_jac: bool = True
    supports_bounds: bool = True

    def __init__(self, maxiter: Optional[int] = None, tol: Optional[float] = None,
                 options: Optional[dict] = None, **kwargs):
        self._options = dict(options or {})
        if maxiter is not None:
            self._options["maxiter"] = maxiter
        self._options.update(kwargs)
        self._tol = tol

    def minimize(self, fun, x0, jac=None, bounds=None) -> OptimizerResult:
        res = scipy_minimize(
            fun,
            np.asarray(x0, dtype=np.float64),
            jac=jac if self.uses_jac else None,
            bounds=bounds if self.supports_bounds else None,
            method=self.method,
            tol=self._tol,
            options=self._options or None,
        )
        return OptimizerResult(
            x=np.asarray(res.x), fun=float(res.fun),
            nfev=int(getattr(res, "nfev", 0)),
            njev=int(getattr(res, "njev", 0)),
            nit=int(getattr(res, "nit", 0)),
        )


class L_BFGS_B(_ScipyOptimizer):
    method = "L-BFGS-B"


class SLSQP(_ScipyOptimizer):
    method = "SLSQP"


class COBYLA(_ScipyOptimizer):
    method = "COBYLA"
    uses_jac = False


class NELDER_MEAD(_ScipyOptimizer):
    method = "Nelder-Mead"
    uses_jac = False


class POWELL(_ScipyOptimizer):
    method = "Powell"
    uses_jac = False


class CG(_ScipyOptimizer):
    method = "CG"
    supports_bounds = False  # scipy CG is unconstrained


class GradientDescent(Optimizer):
    def __init__(self, maxiter: int = 100, learning_rate: float = 0.01,
                 tol: float = 1e-7):
        self.maxiter = maxiter
        self.learning_rate = learning_rate
        self.tol = tol

    def minimize(self, fun, x0, jac=None, bounds=None) -> OptimizerResult:
        if jac is None:
            jac = _finite_diff(fun)
        x = np.asarray(x0, dtype=np.float64).copy()
        nfev = 0
        f = fun(x)
        nfev += 1
        it = -1
        for it in range(self.maxiter):
            g = np.asarray(jac(x))
            x = x - self.learning_rate * g
            f_new = fun(x)
            nfev += 1
            if abs(f_new - f) < self.tol:
                f = f_new
                break
            f = f_new
        return OptimizerResult(x=x, fun=float(f), nfev=nfev, nit=it + 1)


class ADAM(Optimizer):
    def __init__(self, maxiter: int = 200, learning_rate: float = 0.05,
                 beta1: float = 0.9, beta2: float = 0.999, eps: float = 1e-8,
                 tol: float = 1e-9):
        self.maxiter = maxiter
        self.lr = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        self.tol = tol

    def minimize(self, fun, x0, jac=None, bounds=None) -> OptimizerResult:
        if jac is None:
            jac = _finite_diff(fun)
        x = np.asarray(x0, dtype=np.float64).copy()
        m = np.zeros_like(x)
        v = np.zeros_like(x)
        f_prev = np.inf
        nfev = 0
        it = 0
        for it in range(1, self.maxiter + 1):
            g = np.asarray(jac(x))
            m = self.beta1 * m + (1 - self.beta1) * g
            v = self.beta2 * v + (1 - self.beta2) * g * g
            mh = m / (1 - self.beta1 ** it)
            vh = v / (1 - self.beta2 ** it)
            x = x - self.lr * mh / (np.sqrt(vh) + self.eps)
            f = fun(x)
            nfev += 1
            if abs(f - f_prev) < self.tol:
                break
            f_prev = f
        return OptimizerResult(x=x, fun=float(fun(x)), nfev=nfev + 1, nit=it)


class SPSA(Optimizer):
    """Simultaneous perturbation stochastic approximation."""

    def __init__(self, maxiter: int = 300, a: float = 0.1, c: float = 0.1,
                 seed: Optional[int] = None):
        self.maxiter = maxiter
        self.a = a
        self.c = c
        self._rng = np.random.default_rng(seed)

    def minimize(self, fun, x0, jac=None, bounds=None) -> OptimizerResult:
        x = np.asarray(x0, dtype=np.float64).copy()
        nfev = 0
        for k in range(self.maxiter):
            ak = self.a / (k + 1) ** 0.602
            ck = self.c / (k + 1) ** 0.101
            delta = self._rng.choice([-1.0, 1.0], size=x.shape)
            fp = fun(x + ck * delta)
            fm = fun(x - ck * delta)
            nfev += 2
            x = x - ak * (fp - fm) / (2 * ck) * delta
        return OptimizerResult(x=x, fun=float(fun(x)), nfev=nfev + 1,
                               nit=self.maxiter)


def _finite_diff(fun, eps: float = 1e-7):
    def jac(x):
        x = np.asarray(x, dtype=np.float64)
        g = np.empty_like(x)
        f0 = fun(x)
        for i in range(x.size):
            xp = x.copy()
            xp[i] += eps
            g[i] = (fun(xp) - f0) / eps
        return g
    return jac


class DeviceLBFGS(Optimizer):
    """On-device L-BFGS, the counterpart of esoo_tpu.solvers.JaxBFGS: the
    whole minimization runs on the device (solvers/lbfgs.py::
    lbfgs_minimize over the eigensolver's differentiable energy), with no
    host callback per iterate.  Eigensolvers detect this type
    (`is_device_native`) and hand it their energy function instead of
    host callbacks; per-iterate callbacks are not observable on this
    path.  `device` is where the minimization runs ("cuda" by default);
    an eigensolver on another device raises."""

    is_device_native = True

    def __init__(self, maxiter: int = 500, gtol: float = 1e-8,
                 device="cuda"):
        self.maxiter = maxiter
        self.gtol = gtol
        self.device = resolve_device(device)

    def minimize_on_device(self, energy_fn, x0, args=()) -> OptimizerResult:
        """energy_fn(theta, *args) -> differentiable scalar tensor; args
        are tensors on this optimizer's device."""
        from .lbfgs import lbfgs_minimize
        x0 = torch.as_tensor(np.asarray(x0, dtype=np.float64),
                             device=self.device).to(real_dtype())
        res = lbfgs_minimize(energy_fn, x0, args=tuple(args),
                             maxiter=self.maxiter, gtol=self.gtol)
        return OptimizerResult(x=res.x.detach().cpu().numpy(),
                               fun=float(res.fun), nfev=int(res.nfev),
                               nit=int(res.nit))

    def minimize(self, fun, x0, jac=None, bounds=None) -> OptimizerResult:
        # host-callback fallback (still correct, loses the on-device loop)
        res = scipy_minimize(fun, np.asarray(x0, dtype=np.float64), jac=jac,
                             method="BFGS",
                             options={"maxiter": self.maxiter,
                                      "gtol": self.gtol})
        return OptimizerResult(x=np.asarray(res.x), fun=float(res.fun),
                               nfev=int(res.nfev), nit=int(res.nit))


class Minimizer:
    """Marker type: any callable (fun, x0, jac, bounds) -> OptimizerResult."""
