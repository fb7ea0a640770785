"""Device and dtype policy.

Entry points take `device=` (default "cuda") and `resolve_device` raises
instead of falling back to the CPU; `check_same_device` refuses a solver
whose parts were built for another device.  The dtype policy is the JAX
package's (esoo_tpu/utils/config.py): float64/complex128 by default, with
an opt-in 'fast' mode of float32/complex64.  Its readers are the
full-space statevector (sim/statevector.py), whose state dtype it sets
where the caller gives none, and the class-based solvers, whose
integrals, partial unitary and parameters take its real dtype.
"""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent
    (there is no silent CPU path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the host")
    return dev


def same_device(a, b) -> bool:
    """True iff `a` and `b` name one device ("cuda" is "cuda:0")."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def check_same_device(owner: str, device, **parts) -> None:
    """Raise unless every part that has a `device` sits on `device`: a
    solver never copies its parts' state across devices behind the
    caller's back."""
    for name, part in parts.items():
        dev = getattr(part, "device", None)
        if dev is not None and not same_device(dev, device):
            raise ValueError(
                f"{owner} runs on {torch.device(device)} but its {name} "
                f"({type(part).__name__}) runs on {torch.device(dev)}; "
                f"build both with the same device=")


@dataclasses.dataclass
class Precision:
    real_dtype: torch.dtype = torch.float64
    complex_dtype: torch.dtype = torch.complex128


_MODES = {"high": Precision(torch.float64, torch.complex128),
          "fast": Precision(torch.float32, torch.complex64)}
_precision = _MODES["high"]


def set_precision(mode: str = "high"):
    """mode: 'high' (f64/c128) or 'fast' (f32/c64)."""
    global _precision
    if mode not in _MODES:
        raise ValueError(f"unknown precision mode {mode!r}")
    _precision = _MODES[mode]


def real_dtype() -> torch.dtype:
    return _precision.real_dtype


def complex_dtype() -> torch.dtype:
    return _precision.complex_dtype


class precision_mode:
    """Context manager: temporarily switch the dtype policy.

    with precision_mode('fast'):   # f32/c64 statevectors
        ...
    """

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        global _precision
        self._saved = _precision
        set_precision(self.mode)
        return self

    def __exit__(self, *exc):
        global _precision
        _precision = self._saved
        return False
