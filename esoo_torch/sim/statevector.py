"""Full-space statevector simulation (2^N amplitudes) in PyTorch.

Port of esoo_tpu/sim/statevector.py, the simulator behind every
`simulation='full'` run, the Estimator and the hardware-efficient
circuits.  Qubit j is bit j of the amplitude index (little-endian).

Pauli-string operations use the bitmask identities of ops/pauli.py:
  (P s)[c] = i^y * (-1)^{popcount((c^x) & z)} * s[c ^ x]
PyTorch has no popcount, so parities are XOR-folds of the masked index
(`_parity`), and the permutation c -> c ^ x is a reversal of the qubit
axes set in x on a (2, ..., 2) view of the state (`_xor_perm`, one
`torch.flip`).

Real-safe circuits (HF preparation, RY/CX/CZ/H layers, JW-mapped UCC
rotations, whose Pauli strings carry an odd Y count) run on a real
statevector, as in the JAX package:

  exp(-i a/2 P) s = cos(a/2) s + f * sin(a/2) * sign ⊙ s[perm],
  f = +1 if |x&z| % 4 == 1 else -1          (odd-Y Pauli, real state)

Other circuits run on complex64/complex128.  A run of at least
`_SCAN_THRESHOLD` Pauli rotations (a UCC ansatz is nothing else) is a
`_ScanRun`.  On the card it launches the hand kernels of
ops/prot_scan.py (csrc/prot_scan.cu, one launch a direction, the signs
formed from the (K,) masks).  On the CPU it goes through `_ProtScan`, the
plain version: all K angles at once, a per-gate table FS_k = f_k *
sign_k built once per compiled circuit, dtype and device, and per gate
one flip, two products and one fused multiply-add.  Both read each
gate's input state in reverse mode (the numerics of the JAX package's
lax.scan residuals), in sqrt(K) recomputed chunks past
`_REMAT_RESIDUAL_BUDGET` elements.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from ..ops import prot_scan as _prot_scan
from ..utils.config import complex_dtype, real_dtype, resolve_device
from .circuit import QuantumCircuit

# ---------------------------------------------------------------------------
# primitive state operations
# ---------------------------------------------------------------------------


def _num_qubits(state: torch.Tensor) -> int:
    return int(state.shape[-1]).bit_length() - 1


def _parity(v: torch.Tensor, bits: int = 64) -> torch.Tensor:
    """popcount(v) & 1 of non-negative integers below 2**bits, by
    XOR-folding the halves onto the low bit."""
    width = 1
    while width < bits:
        width <<= 1
    shift = width >> 1
    while shift:
        v = v ^ (v >> shift)
        shift >>= 1
    return v & 1


def _flip_dims(x: int) -> tuple:
    """Axes of a (..., 2, ..., 2) view (qubit q <-> axis -(q+1)) whose
    reversal maps amplitude c to c ^ x."""
    return tuple(-(q + 1) for q in range(int(x).bit_length())
                 if (int(x) >> q) & 1)


def _flip(state: torch.Tensor, dims: tuple, nq: int) -> torch.Tensor:
    """state[..., c ^ x] for the x of `dims` (see _flip_dims)."""
    if not dims:
        return state
    shape = state.shape
    view = state.reshape(shape[:-1] + (2,) * nq)
    return torch.flip(view, dims).reshape(shape)


def _xor_perm(state: torch.Tensor, x: int) -> torch.Tensor:
    return _flip(state, _flip_dims(x), _num_qubits(state))


def _sign(dim: int, x: int, z: int, dtype, device) -> torch.Tensor:
    """(-1)^popcount((c ^ x) & z) for every index c."""
    idx = torch.arange(dim, device=device)
    par = _parity((idx ^ int(x)) & int(z), dim.bit_length())
    return (1 - 2 * par).to(dtype)


def zero_state(num_qubits: int, dtype=None, device="cuda") -> torch.Tensor:
    return basis_state(num_qubits, 0, dtype, device)


def basis_state(num_qubits: int, index: int, dtype=None,
                device="cuda") -> torch.Tensor:
    dtype = dtype or complex_dtype()
    s = torch.zeros(1 << num_qubits, dtype=dtype,
                    device=resolve_device(device))
    s[int(index)] = 1.0
    return s


def apply_x_mask(state: torch.Tensor, mask: int) -> torch.Tensor:
    """Product of X gates given by `mask` (a permutation of amplitudes)."""
    return _xor_perm(state, mask)


def pauli_action(state: torch.Tensor, x: int, z: int, y: int
                 ) -> torch.Tensor:
    """Apply letter-Pauli P(x, z) (with i^y phase for the Y's)."""
    sign = _sign(state.shape[-1], x, z, state.dtype, state.device)
    return ((1j) ** (y % 4)) * sign * _xor_perm(state, x)


def apply_pauli_rotation(state, x: int, z: int, y: int, angle
                         ) -> torch.Tensor:
    """exp(-i angle/2 P) |state>  =  cos(a/2) s  - i sin(a/2) P s."""
    angle = torch.as_tensor(angle, device=state.device)
    if not state.is_complex():
        if y % 2 == 0:
            raise ValueError("even-Y Pauli rotation leaves the real subspace")
        c = torch.cos(angle / 2).to(state.dtype)
        s = torch.sin(angle / 2).to(state.dtype)
        f = 1.0 if y % 4 == 1 else -1.0
        sign = _sign(state.shape[-1], x, z, state.dtype, state.device)
        return c * state + (f * s) * sign * _xor_perm(state, x)
    c = torch.cos(angle / 2).to(state.dtype)
    s = torch.sin(angle / 2).to(state.dtype)
    return c * state - 1j * s * pauli_action(state, x, z, y)


def apply_1q(state: torch.Tensor, U: torch.Tensor, q: int) -> torch.Tensor:
    dim = state.shape[-1]
    lo = 1 << q
    hi = dim // (2 * lo)
    sr = state.reshape(state.shape[:-1] + (hi, 2, lo))
    out = torch.einsum("ij,...hjl->...hil", U.to(state.dtype), sr)
    return out.reshape(state.shape)


def apply_2q(state: torch.Tensor, U4: torch.Tensor, qa: int, qb: int
             ) -> torch.Tensor:
    """Apply a 4x4 unitary on qubits (qa, qb); row index order (qa, qb)."""
    n = _num_qubits(state)
    nb = state.dim() - 1
    st = state.reshape(state.shape[:-1] + (2,) * n)
    axa, axb = nb + n - 1 - qa, nb + n - 1 - qb
    Ur = U4.reshape(2, 2, 2, 2).to(state.dtype)
    out = torch.tensordot(Ur, st, dims=([2, 3], [axa, axb]))
    # result axes: (qa_out, qb_out, batch..., remaining...) -> into place
    out = torch.movedim(out, (0, 1), (axa, axb))
    return out.reshape(state.shape)


def pauli_quadforms(state, xs, zs) -> torch.Tensor:
    """q_k = sum_c conj(s[c]) * sign_k[c] * s[c ^ x_k]   (no i^y phase).

    <s|P_k|s> = i^{y_k} * q_k; the phases are applied on the host (see
    expectation_pauli).  Terms go in blocks that keep the (terms, 2^N)
    index temporaries near 32 MB."""
    dim = state.shape[-1]
    dev = state.device
    xs = torch.as_tensor(np.asarray(xs, dtype=np.int64), device=dev)
    zs = torch.as_tensor(np.asarray(zs, dtype=np.int64), device=dev)
    idx = torch.arange(dim, device=dev)
    conj = torch.conj(state)
    rows = max(1, (1 << 22) // dim)
    out = []
    for lo in range(0, xs.shape[0], rows):
        perm = idx[None, :] ^ xs[lo:lo + rows, None]
        par = _parity(perm & zs[lo:lo + rows, None], dim.bit_length())
        sign = (1 - 2 * par).to(state.dtype)
        out.append(torch.sum(conj * sign * state[perm], dim=-1))
    if not out:
        return torch.zeros(0, dtype=state.dtype, device=dev)
    return torch.cat(out)


def expectation_pauli(state, xs, zs, ys, coeffs) -> complex:
    """<state| sum_k coeffs[k] P_k |state> (complex host scalar)."""
    q = pauli_quadforms(state, xs, zs).detach().cpu().numpy()
    phases = np.power(1j, np.asarray(ys) % 4)
    return complex(np.sum(np.asarray(coeffs) * phases * q))


# ---------------------------------------------------------------------------
# gate matrices
# ---------------------------------------------------------------------------

_SQ2 = 1.0 / math.sqrt(2.0)

_CONST_1Q = {
    "x": np.array([[0, 1], [1, 0]], dtype=np.complex128),
    "y": np.array([[0, -1j], [1j, 0]], dtype=np.complex128),
    "z": np.array([[1, 0], [0, -1]], dtype=np.complex128),
    "h": np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]], dtype=np.complex128),
    "s": np.array([[1, 0], [0, 1j]], dtype=np.complex128),
    "sdg": np.array([[1, 0], [0, -1j]], dtype=np.complex128),
    "t": np.array([[1, 0], [0, np.exp(1j * math.pi / 4)]], dtype=np.complex128),
}


def _rot_1q(name: str, angle, cdtype) -> torch.Tensor:
    a = angle.to(cdtype)
    c = torch.cos(a / 2)
    s = torch.sin(a / 2)
    if name == "rx":
        return torch.stack([torch.stack([c, -1j * s]),
                            torch.stack([-1j * s, c])])
    if name == "ry":
        return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    if name == "rz":
        e = torch.exp(-0.5j * a)
        return torch.diag(torch.stack([e, torch.conj(e)]))
    if name == "p":
        return torch.diag(torch.stack([torch.ones_like(a),
                                       torch.exp(1j * a)]))
    raise ValueError(name)


_CONST_2Q = {
    # row/col basis order |qa qb> = |00>,|01>,|10>,|11> with qa the first index
    "cx": np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                   dtype=np.complex128),
    "cz": np.diag([1, 1, 1, -1]).astype(np.complex128),
    "cy": np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, -1j], [0, 0, 1j, 0]],
                   dtype=np.complex128),
    "swap": np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                     dtype=np.complex128),
}


def _ctrl(U2: torch.Tensor) -> torch.Tensor:
    return torch.block_diag(torch.eye(2, dtype=U2.dtype, device=U2.device),
                            U2)


# ---------------------------------------------------------------------------
# circuit compilation
# ---------------------------------------------------------------------------


_REAL_SAFE_1Q = {"x", "z", "h"}
_REAL_SAFE_2Q = {"cx", "cz", "swap"}


def _circuit_is_real(gates) -> bool:
    """True iff every gate maps real statevectors to real statevectors."""
    for gt in gates:
        name = gt.name
        if name in _REAL_SAFE_1Q or name in _REAL_SAFE_2Q or name in ("ry", "cry"):
            continue
        if name == "prot":
            if gt.data[2] % 2 == 1:  # odd Y count: real rotation
                continue
            return False
        if name == "init_sv":
            if np.allclose(np.imag(gt.data[0]), 0.0):
                continue
            return False
        return False
    return True


def _ry_real(angle, dtype) -> torch.Tensor:
    c = torch.cos(angle / 2).to(dtype)
    s = torch.sin(angle / 2).to(dtype)
    return torch.stack([torch.stack([c, -s]), torch.stack([s, c])])


def _real_of(dtype: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def _angle_value(expr, params: torch.Tensor, dtype) -> torch.Tensor:
    """The gate angle as a 0-d tensor of the real `dtype` on the
    parameters' device."""
    if expr[0] == "const":
        return torch.tensor(expr[1], dtype=dtype, device=params.device)
    _, idx, mult, off = expr
    return mult * params[idx].to(dtype) + off


_SCAN_THRESHOLD = 48


def _prot_scan_arrays(gates):
    """Stack a run of 'prot' gates into host arrays for the scan."""
    xs = np.array([g.data[0] for g in gates], dtype=np.int64)
    zs = np.array([g.data[1] for g in gates], dtype=np.int64)
    ys = np.array([g.data[2] for g in gates], dtype=np.int64)
    idx = np.zeros(len(gates), dtype=np.int64)
    mult = np.zeros(len(gates))
    off = np.zeros(len(gates))
    for k, g in enumerate(gates):
        if g.angle[0] == "param":
            _, i, m, o = g.angle
            idx[k], mult[k], off[k] = i, m, o
        else:
            idx[k], mult[k], off[k] = 0, 0.0, g.angle[1]
    return xs, zs, ys, idx, mult, off


def _prot_signs(xs, zs, dim: int, device) -> torch.Tensor:
    """(K, dim) int8 signs (-1)^popcount((c ^ x_k) & z_k) of a run of
    Pauli rotations, built on `device` in blocks of gates whose int64
    temporaries stay near 32 MB."""
    idx = torch.arange(dim, device=device)
    X = torch.as_tensor(np.asarray(xs, dtype=np.int64), device=device)
    Z = torch.as_tensor(np.asarray(zs, dtype=np.int64), device=device)
    out = torch.empty((X.shape[0], dim), dtype=torch.int8, device=device)
    rows = max(1, (1 << 22) // dim)
    for lo in range(0, X.shape[0], rows):
        v = (idx[None, :] ^ X[lo:lo + rows, None]) & Z[lo:lo + rows, None]
        out[lo:lo + rows] = 1 - 2 * _parity(v, dim.bit_length())
    return out


# reverse mode through a K-gate scan keeps one state per gate; past this
# element budget (K * state size) the scan keeps only every sqrt(K)-th
# state and recomputes each chunk's states in the backward, cutting the
# residual memory from K to ~3 sqrt(K) states for one extra forward
# pass (the JAX package's jax.checkpoint chunks at the same budget)
_REMAT_RESIDUAL_BUDGET = 1 << 23


def _scan_chunk(s, c, sn, FS, dims, nq, k0, k1, S=None, F=None):
    """Gates k0..k1-1 applied to s; returns the output state.  With
    buffers (the backward's), S[j] receives gate k0+j's input state (S has
    one more row, the output) and F[j] its FS_k ⊙ s[perm] term."""
    if S is not None:
        S[0].copy_(s)
        s = S[0]
    for j, k in enumerate(range(k0, k1)):
        FG = torch.mul(FS[k], _flip(s, dims[k], nq),
                       out=None if F is None else F[j])
        s = torch.addcmul(s * c[k], FG, sn[k],
                          out=None if S is None else S[j + 1])
    return s


def _dot_re(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re sum(conj(a) * b) over every axis but the first."""
    p = (torch.conj(a) * b).flatten(1).sum(1)
    return p.real if p.is_complex() else p


class _ProtScan(torch.autograd.Function):
    """A run of K Pauli rotations s_{k+1} = c_k s_k + sn_k FS_k ⊙ P_k s_k
    (c_k, sn_k = cos, sin of half the angle; P_k the flip c -> c ^ x_k;
    FS_k the gate's sign table times f_k, or -i i^y_k on the complex
    path).  The state may carry leading batch axes (k states through one
    angle vector).  The backward runs the adjoint gate by gate,
    W_k = c_k W_{k+1} + sn_k P_k(conj(FS_k) ⊙ W_{k+1}), from each gate's
    saved input state, and reads dL/da_k = Re <W_{k+1}, ds_{k+1}/da_k>
    off the saved states in two batched reductions."""

    @staticmethod
    def forward(ctx, state, ang, FS, dims, nq):
        c = torch.cos(ang / 2).to(_real_of(state.dtype))
        sn = torch.sin(ang / 2).to(_real_of(state.dtype))
        K = ang.shape[0]
        if not any(ctx.needs_input_grad[:2]):
            return _scan_chunk(state, c, sn, FS, dims, nq, 0, K)
        cs = K
        if K * state.numel() > _REMAT_RESIDUAL_BUDGET:
            cs = max(1, math.isqrt(K))
        if cs == K:
            S = state.new_empty((K + 1,) + state.shape)
            F = state.new_empty((K,) + state.shape)
            out = _scan_chunk(state, c, sn, FS, dims, nq, 0, K, S, F)
            ctx.save_for_backward(c, sn, FS, S, F)
        else:
            bounds = [state]
            s = state
            for k0 in range(0, K, cs):
                s = _scan_chunk(s, c, sn, FS, dims, nq, k0, min(K, k0 + cs))
                bounds.append(s)
            out = bounds.pop()
            ctx.save_for_backward(c, sn, FS, torch.stack(bounds))
        ctx.dims, ctx.nq, ctx.cs = dims, nq, cs
        return out.clone() if cs == K else out

    @staticmethod
    def backward(ctx, ct):
        c, sn, FS, *saved = ctx.saved_tensors
        dims, nq, cs = ctx.dims, ctx.nq, ctx.cs
        K = c.shape[0]
        FSc = torch.conj(FS) if FS.is_complex() else FS
        dang = torch.empty(K, dtype=c.dtype, device=c.device)
        W = ct
        for k0 in reversed(range(0, K, cs)):
            k1 = min(K, k0 + cs)
            if cs == K:
                S, F = saved
            else:
                S = ct.new_empty((k1 - k0 + 1,) + ct.shape)
                F = ct.new_empty((k1 - k0,) + ct.shape)
                _scan_chunk(saved[0][k0 // cs], c, sn, FS, dims, nq, k0, k1,
                            S, F)
            Wb = ct.new_empty((k1 - k0 + 1,) + ct.shape)
            Wb[-1].copy_(W)
            for j in reversed(range(k1 - k0)):
                k = k0 + j
                Q = _flip(FSc[k] * Wb[j + 1], dims[k], nq)
                torch.addcmul(Wb[j + 1] * c[k], Q, sn[k], out=Wb[j])
            # ds_{k+1}/da_k = (c_k FS_k ⊙ P_k s_k - sn_k s_k) / 2
            dang[k0:k1] = 0.5 * (c[k0:k1] * _dot_re(Wb[1:], F)
                                 - sn[k0:k1] * _dot_re(Wb[1:], S[:-1]))
            W = Wb[0]
        return W, dang, None, None, None


class _ScanRun:
    """A run of at least _SCAN_THRESHOLD Pauli rotations (the JAX
    package's _apply_prot_scan, real and complex): its host arrays, and
    its device tables per (dim, dtype, device), built once; calling it
    applies the run through ops/prot_scan.py's wrapper (the hand kernels
    on the card, the plain _ProtScan on the CPU)."""

    def __init__(self, gates):
        (self.xs, self.zs, self.ys, self.idx, self.mult,
         self.off) = _prot_scan_arrays(gates)
        self.dims = [_flip_dims(x) for x in self.xs]
        self._tables = {}

    def _factor(self, dtype: torch.dtype) -> np.ndarray:
        """f_k: -i i^y_k on the complex path, +-1 on the real one."""
        if dtype.is_complex:
            return -1j * np.power(1j, self.ys % 4)
        if np.any(self.ys % 2 == 0):
            raise ValueError("even-Y Pauli rotation leaves the real subspace")
        return np.where(self.ys % 4 == 1, 1.0, -1.0)

    def tables(self, dim: int, dtype: torch.dtype, device) -> dict:
        """The run's tables on `device`: idx, mult, off, and on the CPU
        the plain scan's (K, dim) FS = f_k * sign_k at `dtype` and its
        flip axes dims; elsewhere the kernel's (K,) int64 masks x, z,
        factors f at `dtype` and (G + 1,) int32 group offsets groups
        (ops/prot_scan.py::group_offsets), no (K, dim) table."""
        device = torch.device(device)
        key = (dim, dtype, str(device))
        hit = self._tables.get(key)
        if hit is None:
            if int(np.max(self.xs | self.zs, initial=0)) >= dim:
                raise ValueError(f"a Pauli rotation's mask reaches past a "
                                 f"state of {dim} amplitudes")
            factor = torch.as_tensor(self._factor(dtype),
                                     device=device).to(dtype)
            rd = _real_of(dtype)
            hit = dict(idx=torch.as_tensor(self.idx, device=device),
                       mult=torch.as_tensor(self.mult, device=device).to(rd),
                       off=torch.as_tensor(self.off, device=device).to(rd))
            if device.type == "cpu":
                sign = _prot_signs(self.xs, self.zs, dim, device)
                hit.update(FS=factor[:, None] * sign.to(dtype),
                           dims=self.dims)
            else:
                hit.update(x=torch.as_tensor(self.xs, device=device),
                           z=torch.as_tensor(self.zs, device=device),
                           f=factor,
                           groups=torch.as_tensor(
                               _prot_scan.group_offsets(self.xs),
                               device=device))
            self._tables[key] = hit
        return hit

    def __call__(self, state: torch.Tensor, params: torch.Tensor
                 ) -> torch.Tensor:
        tabs = self.tables(state.shape[-1], state.dtype, state.device)
        mult, off = tabs["mult"], tabs["off"]
        if params.numel():
            ang = mult * params.to(mult.dtype)[tabs["idx"]] + off
        else:
            ang = off
        return _prot_scan.apply_prot_scan(state, ang, tabs)


def _plan(gates) -> list:
    """The gate list as a list of steps: a _ScanRun for each run of at
    least _SCAN_THRESHOLD Pauli rotations, else a list of gates for the
    unrolled path."""
    gates = list(gates)
    steps: List = []
    i = 0
    while i < len(gates):
        j = i
        while j < len(gates) and gates[j].name == "prot":
            j += 1
        if j - i >= _SCAN_THRESHOLD:
            steps.append(_ScanRun(gates[i:j]))
            i = j
            continue
        end = i + 1 if gates[i].name != "prot" else j
        if steps and isinstance(steps[-1], list):
            steps[-1].extend(gates[i:end])
        else:
            steps.append(list(gates[i:end]))
        i = end
    return steps


def _run_plan(steps, state, params, is_real, dtype):
    for step in steps:
        if isinstance(step, _ScanRun):
            state = step(state, params)
        else:
            state = _apply_gates_unrolled(state, params, step, is_real, dtype)
    return state


def _apply_gates(state, params, gates, is_real, dtype):
    """Apply a gate list to a statevector (long homogeneous runs of Pauli
    rotations through one scan, the rest unrolled)."""
    return _run_plan(_plan(gates), state, params, is_real, dtype)


def _apply_gates_unrolled(state, params, gates, is_real, dtype):
    """Gate-by-gate application (small circuits / mixed runs)."""
    rd = _real_of(dtype)
    cd = complex_dtype() if is_real else dtype
    for gt in gates:
        name = gt.name
        if name == "prot":
            x, z, y = gt.data
            ang = _angle_value(gt.angle, params, rd)
            state = apply_pauli_rotation(state, x, z, y, ang)
        elif name == "x":
            state = apply_x_mask(state, 1 << gt.qubits[0])
        elif name in _CONST_1Q:
            U = _CONST_1Q[name]
            U = torch.as_tensor(np.real(U) if is_real else U,
                                device=state.device).to(dtype)
            state = apply_1q(state, U, gt.qubits[0])
        elif name == "ry":
            ang = _angle_value(gt.angle, params, rd)
            state = apply_1q(state, _ry_real(ang, dtype), gt.qubits[0])
        elif name in ("rx", "rz", "p"):
            ang = _angle_value(gt.angle, params, rd)
            state = apply_1q(state, _rot_1q(name, ang, cd), gt.qubits[0])
        elif name in _CONST_2Q:
            U = _CONST_2Q[name]
            U = torch.as_tensor(np.real(U) if is_real else U,
                                device=state.device).to(dtype)
            state = apply_2q(state, U, gt.qubits[0], gt.qubits[1])
        elif name == "cry":
            ang = _angle_value(gt.angle, params, rd)
            eye = torch.eye(2, dtype=dtype, device=state.device)
            U = torch.block_diag(eye, _ry_real(ang, dtype))
            state = apply_2q(state, U, gt.qubits[0], gt.qubits[1])
        elif name in ("crx", "crz", "cp"):
            ang = _angle_value(gt.angle, params, rd)
            U = _ctrl(_rot_1q(name[1:], ang, cd))
            state = apply_2q(state, U, gt.qubits[0], gt.qubits[1])
        elif name == "init_sv":
            raise ValueError("init_sv must be the first gate")
        else:
            raise ValueError(f"unknown gate {name}")
    return state


class CompiledCircuit:
    """A circuit lowered to a function params -> statevector.

    Real-safe circuits are simulated with a real dtype, everything else
    with a complex one; the dtype policy (utils/config.py) picks the
    precision where the caller gives none.  The state lives on the
    parameters' device.  Scan tables are built once per dtype and
    device."""

    def __init__(self, circuit: QuantumCircuit, force_complex: bool = False):
        self.num_qubits = circuit.num_qubits
        self.num_parameters = circuit.num_parameters
        self._gates = list(circuit.gates)
        self.is_real = (not force_complex) and _circuit_is_real(self._gates)
        gates = self._gates
        # merge leading X gates into the initial basis index
        i, self._start_index, self._start_vector = 0, 0, None
        if gates and gates[0].name == "init_sv":
            self._start_vector = gates[0].data[0]
            i = 1
        else:
            while i < len(gates) and gates[i].name == "x":
                self._start_index ^= 1 << gates[i].qubits[0]
                i += 1
        self._state_steps = _plan(gates[i:])
        self._apply_steps = None

    def _dtype(self) -> torch.dtype:
        return real_dtype() if self.is_real else complex_dtype()

    def initial_state(self, dtype: torch.dtype, device) -> torch.Tensor:
        """The state before the first non-X gate (or the init_sv vector)."""
        if self._start_vector is not None:
            vec = self._start_vector
            vec = np.real(vec) if not dtype.is_complex else vec
            return torch.as_tensor(vec, device=device).to(dtype)
        return basis_state(self.num_qubits, self._start_index, dtype, device)

    def _state(self, params: torch.Tensor,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or self._dtype()
        state = self.initial_state(dtype, params.device)
        return _run_plan(self._state_steps, state, params,
                         not dtype.is_complex, dtype)

    def _apply(self, state: torch.Tensor, params: torch.Tensor
               ) -> torch.Tensor:
        """The circuit applied to `state` (leading batch axes allowed).
        Dtype follows the input (complex input forces the complex gate
        path even for a real-safe circuit)."""
        is_real = not state.is_complex()
        if is_real and not self.is_real:
            raise ValueError(
                "cannot apply a complex circuit to a real statevector")
        if self._apply_steps is None:
            self._apply_steps = _plan(self._gates)
        return _run_plan(self._apply_steps, state, params, is_real,
                         state.dtype)

    @property
    def apply_raw(self):
        """(state, params) -> state."""
        return self._apply

    @property
    def apply_fn(self):
        """(state, params) -> state (the JAX package's jitted form; the
        same function here)."""
        return self._apply

    @property
    def state_fn(self):
        """params -> state, differentiable in params."""
        return self._state

    def state(self, params=None, device=None) -> torch.Tensor:
        """The statevector at `params` (zeros by default): on the device
        of a tensor `params`, else on `device` ("cuda" by default)."""
        if torch.is_tensor(params) and device is None:
            return self._state(params)
        dev = resolve_device("cuda" if device is None else device)
        if params is None:
            params = np.zeros(self.num_parameters)
        if torch.is_tensor(params):
            return self._state(params.to(dev))
        return self._state(torch.as_tensor(
            np.asarray(params, dtype=np.float64), device=dev))


_compile_cache: dict = {}


def compile_circuit(circuit: QuantumCircuit) -> CompiledCircuit:
    key = circuit.fingerprint()
    hit = _compile_cache.get(key)
    if hit is None:
        hit = CompiledCircuit(circuit)
        _compile_cache[key] = hit
    return hit


def statevector(circuit: QuantumCircuit, params=None,
                device=None) -> torch.Tensor:
    return compile_circuit(circuit).state(params, device)
