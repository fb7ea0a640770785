"""Carry state across from the JAX package: NumPy arrays -> port tensors.

The port imports nothing of `esoo_tpu`; what crosses is plain NumPy, e.g.
`np.asarray` of an `esoo_tpu` FusedOptOrbVQE's `_h_sp`, `_g_sp`, `_U0`,
`_theta0`, of a FusedOptOrbCASSCF's `_v0` (FusedOptOrbSACASSCF: `_V0`,
`_weights`), or of a SectorUCC's `_str_tabs._asdict()`; a whole
`esoo_tpu.chem` problem crosses as its fields (`problem_from_numpy`), a
circuit as its gates (`circuit_from_gates`) and a Pauli operator as its
masks and coefficients (`pauli_op_from_numpy`).  The class-based solvers
take the rest as the JAX package's own NumPy arrays: an initial point
(`VQE(initial_point=...)`), a partial unitary
(`initial_partial_unitary=`) and a checkpoint (`resume_from=`, the same
.npz layout in both packages).  The parity tests feed both packages the
same state this way.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import gate_scan as _gate_scan
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
    tables at `dtype`; on the CPU also the per-gate (K, nd) fields of
    strings.gate_fields under "M", "S" and "flat", which only the plain
    gate scan reads; elsewhere the gate scan kernel's packed per-gate
    lists under "GREC" (ops/gate_scan.py::records of strings.gate_lists),
    which the card's kernels read instead.  The host-only string bitmasks
    A/B are dropped."""
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
    if torch.device(device).type == "cpu":
        out["M"], out["S"], out["flat"] = _strings.gate_fields(out)
    elif "PA" in host:
        out["GREC"] = torch.as_tensor(
            _gate_scan.records(_strings.gate_lists(host)), device=device)
    return out


def problem_from_numpy(fields: dict):
    """The port's ElectronicStructureProblem from the fields of either
    package's problem (`dataclasses.asdict`, or `vars`, of an
    `esoo_tpu.chem` one).  Arrays are copied as float64 NumPy; `scf` and
    `ao_basis` cross as plain data: an SCFResult or AOBasisInfo of either
    package, or the dict `asdict` made of one, is rebuilt as the port's
    dataclass.  Fields the port's problem does not have raise."""
    import dataclasses

    from .chem.basis import Shell
    from .chem.driver import AOBasisInfo, ElectronicStructureProblem
    from .chem.scf import SCFResult

    def rebuild(cls, value):
        if value is None or isinstance(value, cls):
            return value
        if not isinstance(value, dict):
            value = {f.name: getattr(value, f.name)
                     for f in dataclasses.fields(cls)}
        return cls(**value)

    def shell(sh):
        if not isinstance(sh, dict):
            sh = {k: getattr(sh, k)
                  for k in ("l", "center", "exps", "coeffs", "pure")}
        return Shell(l=int(sh["l"]), center=np.array(sh["center"]),
                     exps=np.array(sh["exps"]),
                     coeffs=np.array(sh["coeffs"]), pure=bool(sh["pure"]))

    out = {}
    for k, v in fields.items():
        if k == "scf":
            v = rebuild(SCFResult, v)
        elif k == "ao_basis":
            v = rebuild(AOBasisInfo, v)
            if v is not None and v.shells is not None:
                v = dataclasses.replace(v, shells=[shell(sh)
                                                   for sh in v.shells])
        elif k == "num_particles":
            v = tuple(int(x) for x in v)
        elif isinstance(v, np.ndarray) or hasattr(v, "__array__"):
            v = np.array(v, dtype=np.float64)
        out[k] = v
    return ElectronicStructureProblem(**out)


def circuit_from_gates(num_qubits: int, gates, num_parameters=None,
                       **metadata):
    """The port's QuantumCircuit with the given gates: each gate is any
    object with `name`, `qubits`, `angle` and `data` (a Gate of either
    package), read as plain data.  The parameter count is the one the
    angles imply unless `num_parameters` says more; `metadata` sets
    attributes such as `parameter_bounds` or `_encoding`."""
    from .sim.circuit import Gate, QuantumCircuit
    qc = QuantumCircuit(num_qubits)
    for g in gates:
        angle = None if g.angle is None else tuple(
            x if isinstance(x, str) else (int(x) if i == 1 and
                                          g.angle[0] == "param" else float(x))
            for i, x in enumerate(g.angle))
        data = g.data
        if data is not None:
            data = ((np.array(data[0], dtype=np.complex128),)
                    if g.name == "init_sv" else tuple(int(d) for d in data))
        qc.gates.append(Gate(str(g.name), tuple(int(q) for q in g.qubits),
                             angle, data))
        if angle is not None and angle[0] == "param":
            qc._num_parameters = max(qc._num_parameters, angle[1] + 1)
    if num_parameters is not None:
        qc._num_parameters = max(qc._num_parameters, int(num_parameters))
    for k, v in metadata.items():
        setattr(qc, k, v)
    return qc


def pauli_op_from_numpy(xs, zs, coeffs, num_qubits: int):
    """The port's SparsePauliOp from (x, z) bitmask arrays and complex
    coefficients (`SparsePauliOp.mask_arrays()` of either package)."""
    from .ops.pauli import SparsePauliOp
    return SparsePauliOp(([int(x) for x in np.asarray(xs).ravel()],
                          [int(z) for z in np.asarray(zs).ravel()]),
                         np.asarray(coeffs, dtype=np.complex128),
                         num_qubits=int(num_qubits))
