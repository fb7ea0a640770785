"""Carry state across from the JAX package: NumPy arrays -> port tensors.

The port imports nothing of `esoo_tpu`; what crosses is plain NumPy, e.g.
`np.asarray` of an `esoo_tpu` FusedOptOrbVQE's `_h_sp`, `_g_sp`, `_U0`,
`_theta0`, of a FusedOptOrbCASSCF's `_v0` (FusedOptOrbSACASSCF: `_V0`,
`_weights`), or of a SectorUCC's `_str_tabs._asdict()`.  The parity tests
feed both packages the same state this way.
"""

from __future__ import annotations

import numpy as np
import torch

from .sim import strings as _strings


def tensors_from_numpy(*arrays, dtype: torch.dtype, device) -> tuple:
    """The arrays as contiguous tensors of `dtype` on `device` (copied:
    the arrays of the other package may be read-only).  A VQE solver's
    state is (h_sp, g_sp, U0, theta0); a CASSCF solver's (h_sp, g_sp,
    U0, v0), with the sector start vector v0 (nd,), or for the
    state-averaged solver (h_sp, g_sp, U0, V0, weights) with the (k, nd)
    start block."""
    return tuple(torch.as_tensor(np.array(a, dtype=np.float64, order="C"),
                                 device=device).to(dtype)
                 for a in arrays)


def string_tables_from_numpy(host: dict, *, dtype: torch.dtype,
                             device) -> dict:
    """String tables (a StringTables._asdict() of either package) as the
    port's device tables: index tables int64, float and operator-stack
    tables at `dtype`, plus the per-gate fields of strings.gate_fields
    under "M", "S" and "flat".  The host-only string bitmasks A/B are
    dropped."""
    out = {}
    for k, a in host.items():
        if k in ("A", "B"):
            continue
        a = np.asarray(a)
        if k in ("MA", "MB"):
            # the sign stacks cross as they are stored (int8) and are
            # cast on the device: every entry is 0 or +-1, so exact
            out[k] = torch.as_tensor(a, device=device).to(dtype)
        elif np.issubdtype(a.dtype, np.integer):
            out[k] = torch.as_tensor(a.astype(np.int64), device=device)
        else:
            out[k] = torch.as_tensor(a.astype(np.float64),
                                     device=device).to(dtype)
    out["M"], out["S"], out["flat"] = _strings.gate_fields(out)
    return out
