"""Particle-number-sector simulation of UCC circuits (string kernels).

Port of the string-kernel path of esoo_tpu/sim/sector.py.  UCC-family
circuits conserve particle number per spin, so the state never leaves the
C(n, na) * C(n, nb) determinants of the initial occupation; each
excitation rotation exp(theta (T - T+)) acts on that basis as a bank of
2x2 Givens rotations, which the string factorization (sim/strings.py)
turns into per-gate operations on an (nB, nA) string matrix.

Only the string kernel is ported: a circuit whose sector does not
factorize raises (the pairwise gather kernels, kernel='pairs', are not
ported yet).  `SectorCI` is the gate-free full sector of exact CASSCF.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..initializations.ci import enumerate_determinants
from . import strings as _strings

_bitcount = _strings._bitcount


def _apply_ladder_chain(dets: np.ndarray, occ: Sequence[int],
                        vir: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized application of the excitation operator
    T = a+_{vir[0]} ... a+_{vir[-1]} a_{occ[-1]} ... a_{occ[0]}
    to a batch of determinants all inside T's domain.  Returns
    (new_dets, signs)."""
    d = dets.copy()
    sign = np.ones(len(dets), dtype=np.float64)
    # rightmost ladder operator acts first: a_{occ[0]}, a_{occ[1]}, ...,
    # then a+_{vir[-1]}, ..., a+_{vir[0]}
    for i in occ:                      # annihilate (bit guaranteed set)
        sign *= 1.0 - 2.0 * (_bitcount(d & ((1 << i) - 1)) & 1)
        d = d ^ (1 << i)
    for a in reversed(vir):            # create (bit guaranteed clear)
        sign *= 1.0 - 2.0 * (_bitcount(d & ((1 << a) - 1)) & 1)
        d = d | (1 << a)
    return d, sign


def _initial_mask_from_circuit(circ) -> int:
    """Occupation bitmask of an X-gates-only preparation circuit (the
    HartreeFock and OccupationState circuits of sim.ansatz)."""
    mask = 0
    if circ is None:
        return mask
    for gate in circ.gates:
        if gate.name == "barrier":
            continue
        if gate.name != "x":
            raise ValueError(
                "sector simulation requires an occupation-basis initial "
                f"state (X gates only); found '{gate.name}'")
        mask ^= 1 << gate.qubits[0]
    return mask


def _device_rdm_maps(cache: dict, n: int, device, q_pad=None) -> tuple:
    """strings.build_rdm_maps(n, q_pad) as tensors on `device`, cached in
    `cache` per (device, q_pad)."""
    key = (str(torch.device(device)), q_pad)
    maps = cache.get(key)
    if maps is None:
        IDX, SGN, CASE_A = _strings.build_rdm_maps(n, q_pad)
        maps = (torch.as_tensor(IDX, dtype=torch.int64, device=device),
                torch.as_tensor(SGN, device=device),
                torch.as_tensor(CASE_A, device=device))
        cache[key] = maps
    return maps


class SectorUCC:
    """Sector-basis form of a UCC/UCCSD ansatz (string kernels).

      state_matrix(theta) -> (nB, nA) string matrix of the prepared state
      state(theta)        -> sector amplitudes, shape (nd + 1,) (the
                             trailing slot mirrors the JAX package's pad)
      build_values(h_so, g_so) -> sigma-operator dict
      energy_values(theta, vals) -> <psi(theta)| H |psi(theta)>
      rdms(v)             -> spin-orbital (gamma, Gamma)
    """

    def __init__(self, ansatz, num_spin_orbitals: int,
                 num_particles: Optional[Tuple[int, int]] = None,
                 kernel: str = "auto"):
        if kernel not in ("auto", "strings"):
            raise NotImplementedError(
                f"kernel={kernel!r}: only the string kernel is ported (the "
                "pairwise gather kernels are not ported yet)")
        excs = getattr(ansatz, "_ucc_excitations", None)
        if excs is None:
            raise ValueError(
                "sector simulation requires a UCC-family ansatz built by "
                "sim.ansatz.UCC/UCCSD (carrying its excitation list)")
        if getattr(ansatz, "_encoding", "jw") != "jw":
            raise ValueError(
                "sector simulation requires the Jordan-Wigner encoding; "
                f"ansatz carries encoding {getattr(ansatz, '_encoding')!r}")
        if len(excs) != ansatz.num_parameters:
            raise ValueError(
                f"ansatz has {ansatz.num_parameters} parameters but "
                f"{len(excs)} excitation applications")
        N = num_spin_orbitals
        n = N // 2
        init_state = getattr(ansatz, "_ucc_initial_state", None)
        init_mask = _initial_mask_from_circuit(init_state)
        if num_particles is None:
            if init_state is None:
                raise ValueError(
                    "cannot infer the particle sector: the ansatz has no "
                    "initial state — pass num_particles= explicitly")
            na = int(_bitcount(np.asarray([init_mask & ((1 << n) - 1)]))[0])
            nb = int(_bitcount(np.asarray([init_mask >> n]))[0])
            num_particles = (na, nb)
        na, nb = num_particles
        self.num_qubits = N
        self.num_particles = (na, nb)

        dets = np.asarray(
            enumerate_determinants(N, (na, nb), max_excitation=na + nb),
            dtype=np.int64)
        self.dets = dets
        nd = len(dets)
        self.dim = nd
        self.init_index = None
        if init_state is not None:
            init_pos = int(np.searchsorted(dets, init_mask))
            if init_pos >= nd or dets[init_pos] != init_mask:
                raise ValueError(
                    "initial determinant not in the sector basis")
            self.init_index = init_pos

        self._excs = [tuple(e) for e in excs]
        pair_lo, pair_hi, pair_sg = self._build_pair_lists()
        # raises ValueError if the sector does not factorize over strings
        self._str_tabs = _strings.build_string_tables(
            dets, n, pair_lo, pair_hi, pair_sg)
        self.kernel = "strings"
        self.nA = len(self._str_tabs.A)
        self.nB = len(self._str_tabs.B)
        self._dev_tabs = {}
        self._rdm_maps = {}

    def _build_pair_lists(self):
        """Per-gate Givens pair lists (lo/hi determinant indices + JW
        sign), validating that each excitation maps the sector onto
        itself."""
        dets, nd = self.dets, self.dim
        pair_lo, pair_hi, pair_sg = [], [], []
        for occ, vir in self._excs:
            occ_mask = sum(1 << i for i in occ)
            vir_mask = sum(1 << a for a in vir)
            domain = (((dets & occ_mask) == occ_mask)
                      & ((dets & vir_mask) == 0))
            src = dets[domain]
            dst, sg = _apply_ladder_chain(src, occ, vir)
            lo = np.nonzero(domain)[0]
            hi = np.searchsorted(dets, dst)
            if (hi >= nd).any() or not np.array_equal(dets[hi], dst):
                raise ValueError("excitation left the sector basis — the "
                                 "ansatz does not conserve per-spin "
                                 "particle number")
            pair_lo.append(lo)
            pair_hi.append(hi)
            pair_sg.append(sg)
        return pair_lo, pair_hi, pair_sg

    def device_tables(self, dtype: torch.dtype = torch.float64, *,
                      device, storage: str = "dense") -> dict:
        """The string tables as tensors on `device` (float tables at
        `dtype`, index tables int64), plus the precomputed per-gate
        fields of strings.gate_fields under "M"/"S"/"flat".
        storage='int8' keeps the MA/MB operator stacks int8 under the
        dense keys (the dense kernels cast them on the device).  Cached
        per (dtype, device, storage)."""
        if storage not in ("dense", "int8"):
            raise ValueError("storage must be 'dense' or 'int8'")
        device = torch.device(device)
        key = (dtype, str(device), storage)
        tabs = self._dev_tabs.get(key)
        if tabs is None:
            from ..convert import string_tables_from_numpy
            tabs = string_tables_from_numpy(self._str_tabs._asdict(),
                                            dtype=dtype, device=device)
            if storage == "int8":
                for k in ("MA", "MB"):
                    tabs[k] = torch.as_tensor(getattr(self._str_tabs, k),
                                              device=device)
            self._dev_tabs[key] = tabs
        return tabs

    def rdm_maps(self, *, device) -> tuple:
        return _device_rdm_maps(self._rdm_maps, self.num_qubits // 2, device)

    # -- simulation ----------------------------------------------------------
    def project_full(self, vec_full: np.ndarray) -> np.ndarray:
        """Project a full 2^N vector onto the sector basis (host helper
        for initial states); returns shape (nd + 1,) with the padding
        slot.  Raises if the vector has support outside the sector."""
        vec_full = np.asarray(vec_full)
        v = vec_full[self.dets]
        if not np.isclose(float(v @ v), float(vec_full @ vec_full),
                          atol=1e-9):
            raise ValueError(
                "initial state has support outside the particle-number "
                "sector — sector simulation is invalid for it")
        return np.concatenate([v, [0.0]])

    def apply_matrix(self, V0: torch.Tensor, theta: torch.Tensor,
                     tables: dict = None) -> torch.Tensor:
        """The UCC rotations applied to string matrices V0, (nB, nA) or a
        stack (k, nB, nA) of k states through one theta (one gate scan
        for the stack); differentiable in theta."""
        tabs = tables if tables is not None else \
            self.device_tables(theta.dtype, device=theta.device)
        return _strings.apply_gates(V0.to(theta.dtype), theta, tabs,
                                    (tabs["M"], tabs["S"], tabs["flat"]))

    def apply(self, v0: torch.Tensor, theta: torch.Tensor,
              tables: dict = None) -> torch.Tensor:
        """The UCC rotations applied to sector amplitudes v0, shape
        (nd + 1,) with the trailing pad slot, or (k, nd + 1)."""
        V = self.apply_matrix(
            v0[..., : self.dim].reshape(v0.shape[:-1] + (self.nB, self.nA)),
            theta, tables)
        return torch.cat([V.flatten(-2), V.new_zeros(V.shape[:-2] + (1,))],
                         dim=-1)

    def state_matrix(self, theta: torch.Tensor, tables: dict = None
                     ) -> torch.Tensor:
        """(nB, nA) string matrix of the HF state after the UCC rotations
        (differentiable in theta through the reversible backward)."""
        V0 = torch.zeros(self.nB * self.nA, dtype=theta.dtype,
                         device=theta.device)
        V0[self.init_index] = 1.0
        return self.apply_matrix(V0.reshape(self.nB, self.nA), theta, tables)

    def state(self, theta: torch.Tensor, tables: dict = None
              ) -> torch.Tensor:
        """Sector amplitudes after the UCC rotations, shape (nd + 1,)."""
        V = self.state_matrix(theta, tables)
        return torch.cat([V.reshape(-1), V.new_zeros(1)])

    # -- sector Hamiltonian --------------------------------------------------
    def build_values(self, h_so: torch.Tensor, g_so: torch.Tensor,
                     tables: dict = None) -> dict:
        """Sigma-operator dict from spin-orbital (h, g) in the package
        convention E = sum h*gamma + sum g*Gamma (g = 1/2 physicist)."""
        tabs = tables if tables is not None else \
            self.device_tables(h_so.dtype, device=h_so.device)
        return _strings.build_ops(h_so, g_so, tabs)

    def energy_values(self, theta: torch.Tensor, vals: dict,
                      tables: dict = None) -> torch.Tensor:
        tabs = tables if tables is not None else \
            self.device_tables(theta.dtype, device=theta.device)
        return _strings.quadform(self.state_matrix(theta, tabs), vals, tabs)

    def quadform_values(self, V: torch.Tensor, vals: dict,
                        tables: dict = None) -> torch.Tensor:
        """<v|H|v> of string matrices V, (nB, nA) or (k, nB, nA) -> (k,)."""
        tabs = tables if tables is not None else \
            self.device_tables(V.dtype, device=V.device)
        return _strings.quadform(V, vals, tabs)

    # -- sector-native RDMs --------------------------------------------------
    def rdms(self, v: torch.Tensor, tables: dict = None):
        """Spin-orbital (gamma, Gamma) from sector amplitudes (nd or
        nd + 1 long, or an (nB, nA) string matrix)."""
        tabs = tables if tables is not None else \
            self.device_tables(v.dtype, device=v.device)
        V = v.reshape(-1)[: self.dim].reshape(self.nB, self.nA)
        return _strings.rdms(V, tabs, self.rdm_maps(device=v.device))

    def transition_rdm1(self, U: torch.Tensor, V: torch.Tensor,
                        tables: dict = None) -> torch.Tensor:
        """Spin-orbital transition 1-RDM gamma[p, s] = <u|a+_p a_s|v>
        between (nB, nA) string matrices; U may be batched (k, nB, nA)."""
        tabs = tables if tables is not None else \
            self.device_tables(V.dtype, device=V.device)
        return _strings.transition_rdm1(U, V, tabs)


class SectorCI:
    """Gate-free determinant sector (port of esoo_tpu sim/sector.py
    SectorCI): the string sigma/RDM/diagonal kernels over the full
    (na, nb) sector, the operator backbone of exact active-space
    diagonalization (orbital_optimization/casscf.py).

      device_tables(dtype, device=...)   -> operator stacks and pair maps
      build_values(h_so, g_so)           -> sigma-operator dict
      sigma_values(V, vals)              -> H @ V on the string grid
      diagonal_values(vals)              -> exact diag(H) over the grid
      rdms(V) / transition_rdm1(U, V)    -> spin-orbital RDMs
      hf_matrix(dtype, device=...)       -> HF unit vector as (nB, nA)

    Without `tables`, a method uses the tables at its input's dtype and
    device (built once and cached on the instance)."""

    def __init__(self, num_spin_orbitals: int,
                 num_particles: Tuple[int, int]):
        N = num_spin_orbitals
        n = N // 2
        na, nb = num_particles
        self.num_qubits = N
        self.num_particles = (int(na), int(nb))
        dets = np.asarray(
            enumerate_determinants(N, (na, nb), max_excitation=na + nb),
            dtype=np.int64)
        self.dets = dets
        self.dim = len(dets)
        # the full sector over both spins is always a product grid
        self._str_tabs = _strings.build_string_tables(dets, n, [], [], [])
        self.nA = len(self._str_tabs.A)
        self.nB = len(self._str_tabs.B)
        hf_mask = ((1 << na) - 1) | (((1 << nb) - 1) << n)
        self.init_index = int(np.searchsorted(dets, hf_mask))
        self._dev_tabs = {}
        self._rdm_maps = {}

    def device_tables(self, dtype: torch.dtype = torch.float64, *, device,
                      storage: str = "dense") -> dict:
        """The operator stacks and pair maps on `device`, cached per
        (dtype, device, storage):

          'dense'    MA/MB at `dtype` (sent as int8, cast on the device;
                     at N=28 each stack is 785 MB in float32);
          'compact'  int8 stacks under "MA8"/"MB8", padded to a multiple
                     of strings._OP_CHUNK operators: every kernel runs
                     its operator-chunked variant (1.7 GB of stacks at
                     N=32 against 6.8 GB dense in float32);
          'int8'     int8 stacks under the dense keys (the dense kernels
                     cast them on each call).

        CROSS is at `dtype`, the LIN pair maps int64."""
        if storage not in ("dense", "compact", "int8"):
            raise ValueError(
                "storage must be 'dense', 'compact', or 'int8'")
        device = torch.device(device)
        key = (dtype, str(device), storage)
        tabs = self._dev_tabs.get(key)
        if tabs is None:
            s = self._str_tabs
            if storage == "compact":
                tabs = _strings.compact_tables(s, dtype, device=device)
            else:
                stack = (lambda a: torch.as_tensor(a, device=device)) \
                    if storage == "int8" else \
                    (lambda a: torch.as_tensor(a, device=device).to(dtype))
                tabs = dict(
                    MA=stack(s.MA), MB=stack(s.MB),
                    LIN_A=torch.as_tensor(s.LIN_A.astype(np.int64),
                                          device=device),
                    LIN_B=torch.as_tensor(s.LIN_B.astype(np.int64),
                                          device=device),
                    CROSS=torch.as_tensor(s.CROSS, device=device).to(dtype))
            self._dev_tabs[key] = tabs
        return tabs

    def rdm_maps(self, *, device, q_pad: int = None) -> tuple:
        """build_rdm_maps for stacks of operator-axis length `q_pad`
        (default n^2), as tensors on `device`."""
        return _device_rdm_maps(self._rdm_maps, self.num_qubits // 2,
                                device, q_pad)

    def _tabs(self, tables, like: torch.Tensor) -> dict:
        return tables if tables is not None else \
            self.device_tables(like.dtype, device=like.device)

    def hf_matrix(self, dtype: torch.dtype, *, device) -> torch.Tensor:
        """The Hartree-Fock determinant as a unit (nB, nA) string matrix
        (the Davidson starting vector)."""
        v = torch.zeros(self.nB * self.nA, dtype=dtype, device=device)
        v[self.init_index] = 1.0
        return v.reshape(self.nB, self.nA)

    def build_values(self, h_so: torch.Tensor, g_so: torch.Tensor,
                     tables: dict = None) -> dict:
        """Sigma-operator dict from spin-orbital integrals (package
        convention E = sum h gamma + sum g Gamma)."""
        return _strings.build_ops(h_so, g_so, self._tabs(tables, h_so))

    def sigma_values(self, V: torch.Tensor, vals: dict,
                     tables: dict = None) -> torch.Tensor:
        return _strings.sigma(V, vals, self._tabs(tables, V))

    def quadform_values(self, V: torch.Tensor, vals: dict,
                        tables: dict = None) -> torch.Tensor:
        return _strings.quadform(V, vals, self._tabs(tables, V))

    def diagonal_values(self, vals: dict, tables: dict = None
                        ) -> torch.Tensor:
        return _strings.diagonal(vals, self._tabs(tables, vals["FA"]))

    def rdms(self, V: torch.Tensor, tables: dict = None):
        """Spin-orbital (gamma, Gamma) from a normalized (nB, nA) string
        matrix."""
        tabs = self._tabs(tables, V)
        q_pad = int(tabs["MA8" if "MA8" in tabs else "MA"].shape[0])
        return _strings.rdms(V, tabs, self.rdm_maps(device=V.device,
                                                    q_pad=q_pad))

    def transition_rdm1(self, U: torch.Tensor, V: torch.Tensor,
                        tables: dict = None) -> torch.Tensor:
        """Spin-orbital transition 1-RDM gamma[p, s] = <u|a+_p a_s|v>;
        U may be batched (k, nB, nA) -> (k, N, N)."""
        return _strings.transition_rdm1(U, V, self._tabs(tables, V))

    def to_full(self, V: torch.Tensor) -> torch.Tensor:
        """Scatter a (nB, nA) string matrix into the 2^N statevector."""
        full = torch.zeros(2 ** self.num_qubits, dtype=V.dtype,
                           device=V.device)
        full[torch.as_tensor(self.dets, device=V.device)] = V.reshape(-1)
        return full

