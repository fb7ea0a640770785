"""Faults planted in the port underneath the timed path, shared by the
fault tests (CPU, small) and readings.py (the card, the cells' size).

Each is a function of a pytest-style `monkeypatch` (anything with
`setattr(obj, name, value)`)."""

from __future__ import annotations

import types

import torch


def orbitals_unchanged(monkeypatch) -> None:
    """The orbital step returns U as it got it: every request's U stays at
    its start."""
    from esoo_torch.orbital_optimization import fused
    monkeypatch.setattr(fused, "_inner_bb",
                        lambda vag, U0, *args, **kw: U0)


def _unchanged_lbfgs(fun, x0, args=(), **kw):
    return types.SimpleNamespace(x=x0, fun=fun(x0, *args), nit=0, nfev=1)


def _unchanged_davidson(matvec, diag, v0, **kw):
    v = v0 / torch.linalg.vector_norm(v0)
    hv = matvec(v)
    e = v @ hv
    return types.SimpleNamespace(eigenvector=v, eigenvalue=e, iterations=0,
                                 residual_norm=torch.linalg.vector_norm(
                                     hv - e * v))


def state_unchanged(monkeypatch) -> None:
    """The eigensolver step returns its state as it got it."""
    from esoo_torch.orbital_optimization import casscf, fused
    monkeypatch.setattr(fused, "lbfgs_minimize", _unchanged_lbfgs)
    monkeypatch.setattr(casscf, "davidson_ground", _unchanged_davidson)


def energy_altered(monkeypatch, delta: float) -> None:
    """The reported energy altered by `delta` where the loop produces it."""
    from esoo_torch.orbital_optimization import fused
    orig = fused._optorb_loop

    def loop(*args, **kw):
        es, state, U, it, trace = orig(*args, **kw)
        return es + delta, state, U, it, trace
    monkeypatch.setattr(fused, "_optorb_loop", loop)


def tf32(monkeypatch) -> None:
    """The control of a float32 cell: the port's float32 products allowed
    TF32, switched on in each request's construction (the session checks
    the configuration's precision at set-up)."""
    from portbench.harness import client
    issue = client.Client.issue

    def tf32_issue(self, req, spans):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        return issue(self, req, spans)
    monkeypatch.setattr(client.Client, "issue", tf32_issue)


def tf32_off() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Patch:
    """monkeypatch's setattr and undo, for use outside pytest."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)
