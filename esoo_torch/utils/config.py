"""Device policy.

Entry points take `device=` (default "cuda") and `resolve_device` raises
instead of falling back to the CPU.  The JAX package's dtype policy
(esoo_tpu/utils/config.py precision_mode) has no reader in this package:
its only reader there is the full-space simulator, not ported yet.
"""

from __future__ import annotations

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
