"""Particle-number-sector simulation of UCC circuits.

Port of esoo_tpu/sim/sector.py.  UCC-family circuits conserve particle
number per spin, so the state never leaves the C(n, na) * C(n, nb)
determinants of the initial occupation; each excitation rotation
exp(theta (T - T+)) acts on that basis as a bank of 2x2 Givens rotations.
Two kernels simulate it, as in the JAX package:

  * 'strings' (what 'auto' picks whenever the sector factorizes): the
    string factorization of sim/strings.py turns each gate into
    operations on an (nB, nA) string matrix, and the Hamiltonian acts
    through same-spin one-body operator stacks;
  * 'pairs' (the measured-equality oracle of the string kernels, and
    'auto''s fallback when the sector does not factorize): each gate is
    one gather and a few multiply-adds over the (nd + 1,) amplitude vector,
        v' = (1 + (cos th - 1) |S|) v + S sin th v[PARTNER],
    with a reversible backward (on the card the hand kernels of
    ops/pair_scan.py, one launch a direction; on the CPU the plain
    `_ApplyRev`), and the Hamiltonian is the sparse
    Slater-Condon value triple (diag, s_val, d_val) over the pairs of
    initializations/ci.py::slater_condon_structure, applied through
    padded per-row neighbour tables.

`ESOO_SECTOR_KERNEL` ('strings' or 'pairs') overrides the constructor's
`kernel`, in the JAX package's name.  States are kept in the kernel's
native layout (`state_shape`): (nB, nA) string matrices, or (nd + 1,)
vectors whose trailing slot is the gather pad (always zero).
`SectorCI` is the gate-free full sector of exact CASSCF (strings only).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..initializations.ci import (enumerate_determinants,
                                  slater_condon_structure)
from ..ops import pair_scan as _pair_scan
from ..utils.profiling import count
from . import strings as _strings
from .sharded_strings import ShardedStringTables

_bitcount = _strings._bitcount

# cache the O(nd^2) host-side Slater-Condon structure scan on disk past
# this determinant count (the JAX package's threshold)
_SC_CACHE_MIN_ND = 3000


def _slater_condon_structure_cached(dets, n: int) -> dict:
    """slater_condon_structure, cached on disk past _SC_CACHE_MIN_ND
    determinants under a content hash of the ordered determinant list
    (the structure is a pure function of it; the file name is the JAX
    package's).  A missing or unreadable file is rebuilt; writes are
    atomic (tmp + os.replace), and a failed write is skipped.  Cache
    directory: $ESOO_CACHE_DIR, else ~/.cache/esoo_torch."""
    if len(dets) < _SC_CACHE_MIN_ND:
        return slater_condon_structure(dets, n)
    arr = np.asarray(dets, dtype=np.int64)
    key = hashlib.sha1(arr.tobytes() + bytes([n])).hexdigest()[:16]
    cache_dir = os.environ.get(
        "ESOO_CACHE_DIR", os.path.expanduser("~/.cache/esoo_torch"))
    path = os.path.join(cache_dir,
                        f"sector_sc_n{n}_nd{len(dets)}_{key}.npz")
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except (OSError, ValueError, KeyError):
        pass
    out = slater_condon_structure(dets, n)
    try:
        os.makedirs(cache_dir, exist_ok=True)
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, **out)
        os.replace(tmp, path)
    except OSError:
        pass
    return out


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


# -- pairwise gather kernels ----------------------------------------------------

def _gather(v: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """v[..., index] over the amplitude (last) axis."""
    return v.index_select(-1, index)


def _gate_step(v, partner, sfield, th):
    """One Givens-bank gate: v' = c_eff*v + sfield*sin(th)*v[partner]."""
    touched = torch.abs(sfield)
    c_eff = 1.0 + (torch.cos(th) - 1.0) * touched
    return c_eff * v + sfield * torch.sin(th) * _gather(v, partner)


def _apply_gates_tabled(v0, theta, PARTNER, SFIELD):
    """The plain gate scan (differentiable by autograd: the oracle of
    _ApplyRev's backward)."""
    v = v0
    for k in range(theta.shape[0]):
        v = _gate_step(v, PARTNER[k], SFIELD[k], theta[k])
    return v


def _gate_coefficients(theta, SFIELD):
    """Per-gate (K, nd + 1) fields of the gate step at theta: c_eff =
    1 + (cos th - 1)|S| and S sin th (the backward also needs
    -sin th |S| and S cos th); a few launches for the whole scan instead
    of a few for every gate."""
    touched = torch.abs(SFIELD)
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    return 1.0 + (c - 1.0) * touched, SFIELD * s, touched, c, s


class _ApplyRev(torch.autograd.Function):
    """Gate application with the REVERSIBLE backward of esoo_tpu
    sim/sector.py::_apply_rev: each gate is orthogonal, so the backward
    rebuilds v_{k-1} = G(-th) v_k instead of storing K residuals, and the
    cotangent recursion w_{k-1} = G^T w_k is the same gather-only formula
    (G^T = G(-th)): no scatter forward or backward.  v0 may carry leading
    batch axes (k states through one theta); dtheta sums over the
    batch."""

    @staticmethod
    def forward(ctx, v0, theta, PARTNER, SFIELD):
        c_eff, s_field, _, _, _ = _gate_coefficients(theta, SFIELD)
        v = v0
        for k in range(theta.shape[0]):
            v = torch.addcmul(c_eff[k] * v, s_field[k],
                              _gather(v, PARTNER[k]))
        ctx.save_for_backward(v, theta, PARTNER, SFIELD)
        return v

    @staticmethod
    def backward(ctx, ct):
        v, theta, PARTNER, SFIELD = ctx.saved_tensors
        c_eff, s_field, touched, c, s = _gate_coefficients(theta, SFIELD)
        d_touched, d_field = -s * touched, SFIELD * c
        w, vk = ct, v
        dths = [None] * theta.shape[0]
        for k in reversed(range(theta.shape[0])):
            pvk, pw = _gather(vk, PARTNER[k]), _gather(w, PARTNER[k])
            # v_{k-1} = G(-th) v_k  (orthogonal inverse, gather-only);
            # v_{k-1}[partner] follows from the same gather (the partner
            # map is an involution under which |S| is even and S odd)
            v_prev = torch.addcmul(c_eff[k] * vk, s_field[k], pvk,
                                   value=-1.0)
            pv_prev = torch.addcmul(c_eff[k] * pvk, s_field[k], vk)
            # dL/dth_k = w . (dG/dth) v_{k-1}
            dG_v = torch.addcmul(d_touched[k] * v_prev, d_field[k], pv_prev)
            dths[k] = torch.dot(w.reshape(-1), dG_v.reshape(-1))
            # w_{k-1} = G^T w = G(-th) w
            w = torch.addcmul(c_eff[k] * w, s_field[k], pw, value=-1.0)
            vk = v_prev
        return w, torch.stack(dths), None, None


def _hv_tabled(v_pad, diag, s_val, d_val, VIDX, PTN):
    """H v over the padded row tables: diag v + sum_k VAL[VIDX] v[PTN]
    (gathers only)."""
    nd = diag.shape[0]
    vals = torch.cat([s_val, d_val, s_val.new_zeros(1)])
    return diag * v_pad[..., :nd] + torch.sum(
        vals[VIDX] * v_pad[..., PTN], dim=-1)


class _QFTabled(torch.autograd.Function):
    """<v|H|v> over the sparse Slater-Condon values (esoo_tpu
    sim/sector.py::_qf_tabled) with its analytic backward: grad_v =
    2 ct Hv (H symmetric), grad_diag = ct v^2, grad_val = 2 ct v[u] v[w]
    - gathers only.  v_pad may be a (k, nd + 1) stack (k values)."""

    @staticmethod
    def forward(ctx, v_pad, diag, s_val, d_val, VIDX, PTN, SU, SV, DU, DV):
        w = _hv_tabled(v_pad, diag, s_val, d_val, VIDX, PTN)
        ctx.save_for_backward(v_pad, w, SU, SV, DU, DV)
        return torch.sum(v_pad[..., : diag.shape[0]] * w, dim=-1)

    @staticmethod
    def backward(ctx, ct):
        v_pad, w, SU, SV, DU, DV = ctx.saved_tensors
        nd = w.shape[-1]
        v = v_pad[..., :nd]
        ct = ct[..., None]
        g_v = torch.cat([2.0 * ct * w, w.new_zeros(
            w.shape[:-1] + (v_pad.shape[-1] - nd,))], dim=-1)
        batch = tuple(range(v.dim() - 1))

        def total(x):
            return x.sum(dim=batch) if batch else x

        g_diag = total(ct * v * v)
        g_s = total(2.0 * ct * v[..., SU] * v[..., SV])
        g_d = total(2.0 * ct * v[..., DU] * v[..., DV])
        return (g_v, g_diag, g_s, g_d) + (None,) * 6


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


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _replicated(tabs):
    """The lead device's tables dict: a mesh's replicated tables
    (sharded_strings.ShardedStringTables.rep), or `tabs` itself."""
    return tabs.rep if isinstance(tabs, ShardedStringTables) else tabs


def _q_pad(tabs) -> int:
    """The operator-axis length of a string kernel's stacks: dense,
    compact ("MA8") or a mesh's shards."""
    if isinstance(tabs, ShardedStringTables):
        return tabs.q_pad
    return int(tabs["MA8" if "MA8" in tabs else "MA"].shape[0])


class SectorUCC:
    """Sector-basis form of a UCC/UCCSD ansatz, on the string kernels or
    the pairwise gather kernels (`kernel`; see the module docstring).

      state_matrix(theta) -> the prepared state in the native layout
                             (`state_shape`: (nB, nA) or (nd + 1,))
      state(theta)        -> sector amplitudes, shape (nd + 1,) (the
                             trailing slot mirrors the JAX package's pad)
      build_values(h_so, g_so) -> sigma-operator dict ('strings') or the
                             Slater-Condon triple ('pairs')
      energy_values(theta, vals) -> <psi(theta)| H |psi(theta)>
      rdms(v)             -> spin-orbital (gamma, Gamma)
      build_hamiltonian(h_so, g_so) -> the dense (nd, nd) matrix (oracle)
    """

    def __init__(self, ansatz, num_spin_orbitals: int,
                 num_particles: Optional[Tuple[int, int]] = None,
                 kernel: str = "auto"):
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
        kernel = os.environ.get("ESOO_SECTOR_KERNEL", kernel)
        if kernel not in ("auto", "strings", "pairs"):
            raise ValueError(
                f"kernel must be 'auto', 'strings' or 'pairs'; got "
                f"{kernel!r}")
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
        # 'auto' takes the string kernels wherever the sector and gate
        # tables factorize over alpha x beta strings, else the pairs
        self._str_tabs = None
        if kernel != "pairs":
            try:
                self._str_tabs = _strings.build_string_tables(
                    dets, n, pair_lo, pair_hi, pair_sg)
            except ValueError:
                if kernel == "strings":
                    raise
        self.kernel = "strings" if self._str_tabs is not None else "pairs"
        if self.kernel == "strings":
            self.nA = len(self._str_tabs.A)
            self.nB = len(self._str_tabs.B)
            self.state_shape = (self.nB, self.nA)
        else:
            self.state_shape = (nd + 1,)
        # the (K, nd + 1) gate fields and the O(nd^2) Slater-Condon scan
        # only serve the pairwise kernels: built at once for them, lazily
        # (oracle access) on a string sector
        self._pairs_fields_cache = None
        if self.kernel == "pairs":
            self._pairs_fields_cache = self._build_pairs_fields(
                pair_lo, pair_hi, pair_sg)
        self._sc_cache = None
        self._row_tabs = None
        self._rdm_tabs = None
        self._dev_tabs = {}
        self._rdm_maps = {}
        # construction is deterministic in (circuit, N, particles,
        # kernel): the JAX package's content key for __hash__/__eq__
        self._content_key = (ansatz.fingerprint(), N, (na, nb),
                             self.kernel)

    def __hash__(self):
        return hash(self._content_key)

    def __eq__(self, other):
        return (type(other) is type(self)
                and other._content_key == self._content_key)

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

    def _build_pairs_fields(self, pair_lo, pair_hi, pair_sg):
        """Gather-only gate fields of the pairwise apply:
        v' = cos_eff*v + SFIELD*sin(th)*v[PARTNER], (K, nd + 1) each;
        untouched entries (and the pad) keep PARTNER = identity and
        SFIELD = 0."""
        nd, K = self.dim, len(pair_lo)
        PARTNER = np.tile(np.arange(nd + 1, dtype=np.int64), (K, 1))
        SFIELD = np.zeros((K, nd + 1), dtype=np.float64)
        for k in range(K):
            lo, hi, sg = pair_lo[k], pair_hi[k], pair_sg[k]
            PARTNER[k, lo] = hi
            PARTNER[k, hi] = lo
            SFIELD[k, lo] = -sg      # lo' = cos*lo - sg*sin*hi
            SFIELD[k, hi] = +sg      # hi' = sg*sin*lo + cos*hi
        return PARTNER, SFIELD

    @property
    def _pairs_fields(self):
        if self._pairs_fields_cache is None:
            self._pairs_fields_cache = self._build_pairs_fields(
                *self._build_pair_lists())
        return self._pairs_fields_cache

    @property
    def _PARTNER(self) -> np.ndarray:
        return self._pairs_fields[0]

    @property
    def _SFIELD(self) -> np.ndarray:
        return self._pairs_fields[1]

    @property
    def _sc(self) -> dict:
        if self._sc_cache is None:
            self._sc_cache = _slater_condon_structure_cached(
                [int(d) for d in self.dets], self.num_qubits)
        return self._sc_cache

    def _row_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Padded per-determinant neighbour tables of the gather-only H v,
        cached: (VIDX, PTN), both (nd, maxdeg).  Row i lists every j with
        H[i, j] != 0: PTN[i, k] = j and VIDX[i, k] is the pair's slot in
        concat([s_val, d_val]) (each unordered pair sits in both rows).
        Padding points VIDX at a zero value slot and PTN at the pad."""
        if self._row_tabs is not None:
            return self._row_tabs
        st = self._sc
        nd = self.dim
        su, sv, du, dv = (np.asarray(st[k], dtype=np.int64)
                          for k in ("su", "sv", "du", "dv"))
        ns, ndbl = len(su), len(du)
        rows = np.concatenate([su, sv, du, dv])
        cols = np.concatenate([sv, su, dv, du])
        vslot = np.concatenate([np.arange(ns), np.arange(ns),
                                ns + np.arange(ndbl), ns + np.arange(ndbl)])
        deg = np.bincount(rows, minlength=nd) if len(rows) else \
            np.zeros(nd, dtype=np.int64)
        maxdeg = int(deg.max()) if len(rows) else 0
        VIDX = np.full((nd, maxdeg), ns + ndbl, dtype=np.int64)
        PTN = np.full((nd, maxdeg), nd, dtype=np.int64)
        if len(rows):
            order = np.argsort(rows, kind="stable")
            rows, cols, vslot = rows[order], cols[order], vslot[order]
            starts = np.zeros(nd + 1, dtype=np.int64)
            np.cumsum(deg, out=starts[1:])
            pos = np.arange(len(rows)) - starts[rows]
            VIDX[rows, pos] = vslot
            PTN[rows, pos] = cols
        self._row_tabs = (VIDX, PTN)
        return self._row_tabs

    def _rdm_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Gather tables of W[a, b] = a+_a a_b |v> over same-spin ordered
        pairs (the only ones that keep a fixed-(na, nb) state in its
        sector), cached: (SRC, SG), both (N*N, nd), W = SG * v_pad[SRC].
        Cross-spin rows point every entry at the zero pad slot."""
        if self._rdm_tabs is not None:
            return self._rdm_tabs
        N = self.num_qubits
        n = N // 2
        dets = self.dets
        nd = self.dim
        idx = np.arange(nd, dtype=np.int64)
        SRC = np.full((N * N, nd), nd, dtype=np.int64)
        SG = np.zeros((N * N, nd), dtype=np.float64)
        for sig in (0, 1):
            lo, hi = sig * n, sig * n + n
            for a in range(lo, hi):
                for b in range(lo, hi):
                    row = a * N + b
                    if a == b:
                        SRC[row] = idx
                        SG[row] = ((dets >> a) & 1).astype(np.float64)
                        continue
                    # a+_a a_b over the domain (b occupied, a empty), JW
                    # phases as in initializations.ci.excite
                    dom = (((dets >> b) & 1) == 1) & (((dets >> a) & 1) == 0)
                    src = idx[dom]
                    d0 = dets[dom]
                    s1 = 1.0 - 2.0 * (_bitcount(d0 & ((1 << b) - 1)) & 1)
                    d1 = d0 & ~(1 << b)
                    s2 = 1.0 - 2.0 * (_bitcount(d1 & ((1 << a) - 1)) & 1)
                    dst = np.searchsorted(dets, d1 | (1 << a))
                    SRC[row, dst] = src
                    SG[row, dst] = s1 * s2
        self._rdm_tabs = (SRC, SG)
        return self._rdm_tabs

    def device_tables(self, dtype: torch.dtype = torch.float64, *,
                      device, storage: str = "dense") -> dict:
        """The sector's tables as tensors on `device` (float tables at
        `dtype`, index tables int64), cached per (dtype, device,
        storage).  String kernel: the string tables (on the CPU plus the
        per-gate fields of strings.gate_fields under "M"/"S"/"flat", the
        plain gate scan's); storage='int8'
        keeps the MA/MB operator stacks int8 under the dense keys.  Pairs
        kernel: the JAX package's PARTNER/SFIELD gate fields, VIDX/PTN
        row tables, SU/SV/DU/DV pair indices, occf, rdm_SRC/rdm_SG and
        the s_*/d_* value-gather fields (storage 'dense' only)."""
        if storage not in ("dense", "int8"):
            raise ValueError("storage must be 'dense' or 'int8'")
        device = torch.device(device)
        key = (dtype, str(device), storage)
        tabs = self._dev_tabs.get(key)
        if tabs is not None:
            return tabs
        if self.kernel == "strings":
            from ..convert import string_tables_from_numpy
            tabs = string_tables_from_numpy(self._str_tabs._asdict(),
                                            dtype=dtype, device=device)
            if storage == "int8":
                for k in ("MA", "MB"):
                    tabs[k] = torch.as_tensor(getattr(self._str_tabs, k),
                                              device=device)
        elif storage == "int8":
            raise ValueError(
                "storage='int8' needs the string-factorized kernels "
                f"(kernel={self.kernel!r})")
        else:
            tabs = self._pairs_device_tables(dtype, device)
        self._dev_tabs[key] = tabs
        return tabs

    def replicated_tables(self, dtype: torch.dtype = torch.float64, *,
                          device) -> dict:
        """Every string table but the operator stacks MA/MB, on `device`
        (the part of a mesh's sector tables, parallel.shard_sector_tables,
        that the lead device holds whole)."""
        from ..convert import string_tables_from_numpy
        host = {k: v for k, v in self._str_tabs._asdict().items()
                if k not in ("MA", "MB")}
        return string_tables_from_numpy(host, dtype=dtype, device=device)

    def _pairs_device_tables(self, dtype: torch.dtype, device) -> dict:
        """The pairs kernel's device tables (device_tables on a pairs
        sector), cached per (dtype, device) on either kernel."""
        key = (dtype, str(torch.device(device)), "pairs")
        tabs = self._dev_tabs.get(key)
        if tabs is None:
            tabs = self._dev_tabs[key] = self._build_pairs_device_tables(
                dtype, device)
        return tabs

    def _build_pairs_device_tables(self, dtype: torch.dtype, device) -> dict:
        st = self._sc
        N = self.num_qubits
        VIDX, PTN = self._row_tables()
        SRC, SG = self._rdm_tables()

        def f(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   device=device).to(dtype)

        tabs = dict(
            PARTNER=_index(self._PARTNER, device), SFIELD=f(self._SFIELD),
            VIDX=_index(VIDX, device), PTN=_index(PTN, device),
            SU=_index(st["su"], device), SV=_index(st["sv"], device),
            DU=_index(st["du"], device), DV=_index(st["dv"], device),
            occf=f(st["occf"]),
            rdm_SRC=_index(SRC, device), rdm_SG=f(SG))
        if len(st["su"]):
            s_i, s_a = (np.asarray(st[k], np.int64) for k in ("s_i", "s_a"))
            tabs["s_lin"] = _index(s_i * N + s_a, device)
            tabs["s_common"] = f(st["s_common"])
            tabs["s_phase"] = f(st["s_phase"])
        else:
            tabs["s_lin"] = _index(np.zeros(0), device)
            tabs["s_common"] = f(np.zeros((0, N)))
            tabs["s_phase"] = f(np.zeros(0))
        if len(st["du"]):
            d_i, d_j, d_a, d_b = (np.asarray(st[k], np.int64)
                                  for k in ("d_i", "d_j", "d_a", "d_b"))
            base = (d_i * N + d_j) * N
            tabs["d_ijab"] = _index((base + d_a) * N + d_b, device)
            tabs["d_ijba"] = _index((base + d_b) * N + d_a, device)
            tabs["d_phase"] = f(st["d_phase"])
        else:
            tabs["d_ijab"] = tabs["d_ijba"] = _index(np.zeros(0), device)
            tabs["d_phase"] = f(np.zeros(0))
        return tabs

    def _tabs(self, tables, like: torch.Tensor) -> dict:
        return tables if tables is not None else \
            self.device_tables(like.dtype, device=like.device)

    def rdm_maps(self, *, device, q_pad: int = None) -> tuple:
        """build_rdm_maps for stacks of operator-axis length `q_pad`
        (default n^2), as tensors on `device`."""
        return _device_rdm_maps(self._rdm_maps, self.num_qubits // 2,
                                device, q_pad)

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

    def to_native(self, v):
        """Padded sector vectors (..., nd + 1) in the native layout
        (`state_shape`), NumPy or torch."""
        if self.kernel == "pairs":
            return v
        return v[..., : self.dim].reshape(v.shape[:-1] + self.state_shape)

    def _padded(self, v: torch.Tensor) -> torch.Tensor:
        """Sector amplitudes (..., nd), (..., nd + 1) or string matrices
        (..., nB, nA) as padded (..., nd + 1) vectors."""
        if self.kernel == "strings" and v.shape[-2:] == self.state_shape:
            v = v.flatten(-2)
        v = v[..., : self.dim]
        return torch.cat([v, v.new_zeros(v.shape[:-1] + (1,))], dim=-1)

    def apply_matrix(self, V0: torch.Tensor, theta: torch.Tensor,
                     tables: dict = None) -> torch.Tensor:
        """The UCC rotations applied to states V0 in the native layout,
        one state or a stack of k through one theta (one gate scan for
        the stack); differentiable in theta through the reversible
        backward."""
        tabs = self._tabs(tables, theta)
        V0 = V0.to(theta.dtype)
        if self.kernel == "pairs":
            return _pair_scan.apply_rev_pairs(V0, theta, tabs["PARTNER"],
                                              tabs["SFIELD"])
        return _strings.apply_gates(V0, theta, _replicated(tabs))

    def apply(self, v0: torch.Tensor, theta: torch.Tensor,
              tables: dict = None) -> torch.Tensor:
        """The UCC rotations applied to sector amplitudes v0, shape
        (nd + 1,) with the trailing pad slot, or (k, nd + 1)."""
        if self.kernel == "pairs":
            return self.apply_matrix(v0, theta, tables)
        V = self.apply_matrix(self.to_native(v0), theta, tables)
        return torch.cat([V.flatten(-2), V.new_zeros(V.shape[:-2] + (1,))],
                         dim=-1)

    def _initial(self, theta: torch.Tensor) -> torch.Tensor:
        v0 = torch.zeros(self.dim + 1, dtype=theta.dtype,
                         device=theta.device)
        v0[self.init_index] = 1.0
        return self.to_native(v0)

    def state_matrix(self, theta: torch.Tensor, tables: dict = None
                     ) -> torch.Tensor:
        """The HF state after the UCC rotations, in the native layout
        (differentiable in theta through the reversible backward)."""
        return self.apply_matrix(self._initial(theta), theta, tables)

    def state(self, theta: torch.Tensor, tables: dict = None
              ) -> torch.Tensor:
        """Sector amplitudes after the UCC rotations, shape (nd + 1,)."""
        return self._padded(self.state_matrix(theta, tables))

    def to_full(self, v: torch.Tensor) -> torch.Tensor:
        """Scatter sector amplitudes (any layout `_padded` takes, with
        leading batch axes) into the full 2^N statevector."""
        v = self._padded(v)[..., : self.dim]
        full = v.new_zeros(v.shape[:-1] + (2 ** self.num_qubits,))
        full[..., _index(self.dets, v.device)] = v
        return full

    def full_state(self, theta: torch.Tensor) -> torch.Tensor:
        return self.to_full(self.state(theta))

    # -- sector Hamiltonian --------------------------------------------------
    def build_values(self, h_so: torch.Tensor, g_so: torch.Tensor,
                     tables: dict = None):
        """The sector Hamiltonian's values from spin-orbital (h, g) in the
        package convention E = sum h*gamma + sum g*Gamma (g = 1/2
        physicist): the sigma-operator dict of sim/strings.py on the
        string kernel, the Slater-Condon triple (build_values_pairs) on
        the pairs.  quadform_values dispatches on the type."""
        if self.kernel == "strings":
            return _strings.build_ops(h_so, g_so, self._tabs(tables, h_so))
        return self.build_values_pairs(h_so, g_so,
                                       self._tabs(tables, h_so))

    def build_values_pairs(self, h_so: torch.Tensor, g_so: torch.Tensor,
                           tables: dict = None):
        """The Slater-Condon value triple (diag (nd,), s_val, d_val) over
        the singles/doubles pairs of the structure scan: O(nnz), no dense
        matrix.  With `tables` (the pairs device tables) the values are
        flat-index gathers; without, the structure's index arrays are
        sent to h_so's device on each call (the oracle)."""
        h, g = h_so, g_so
        N = self.num_qubits
        dtype, dev = h.dtype, h.device
        hdiag = torch.diagonal(h)
        J = 2.0 * (torch.einsum("pqpq->pq", g) - torch.einsum("pqqp->pq", g))
        if tables is not None:
            occf = tables["occf"]
            diag = occf @ hdiag + 0.5 * torch.einsum("mp,pq,mq->m",
                                                     occf, J, occf)
            C = 2.0 * (torch.einsum("prqr->pqr", g)
                       - torch.einsum("prrq->pqr", g))
            Air = C.reshape(N * N, N)[tables["s_lin"]]
            s_val = (h.reshape(-1)[tables["s_lin"]]
                     + torch.sum(Air * tables["s_common"], dim=1)) \
                * tables["s_phase"]
            gf = g.reshape(-1)
            d_val = 2.0 * (gf[tables["d_ijab"]] - gf[tables["d_ijba"]]) \
                * tables["d_phase"]
            return diag, s_val, d_val
        st = self._sc

        def f(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64),
                                   device=dev).to(dtype)

        occf = f(st["occf"])
        diag = occf @ hdiag + 0.5 * torch.einsum("mp,pq,mq->m", occf, J, occf)
        s_val = h.new_zeros(0)
        d_val = h.new_zeros(0)
        if len(st["su"]):
            i_idx, a_idx = _index(st["s_i"], dev), _index(st["s_a"], dev)
            C = 2.0 * (torch.einsum("prqr->pqr", g)
                       - torch.einsum("prrq->pqr", g))
            s_val = (h[i_idx, a_idx]
                     + torch.sum(C[i_idx, a_idx] * f(st["s_common"]), dim=1)
                     ) * f(st["s_phase"])
        if len(st["du"]):
            i, j, a, b = (_index(st[k], dev)
                          for k in ("d_i", "d_j", "d_a", "d_b"))
            d_val = 2.0 * (g[i, j, a, b] - g[i, j, b, a]) * f(st["d_phase"])
        return diag, s_val, d_val

    def build_hamiltonian(self, h_so: torch.Tensor,
                          g_so: torch.Tensor) -> torch.Tensor:
        """Dense (nd, nd) sector Hamiltonian (small-nd oracle; the energy
        path is the gather-only quadform over build_values)."""
        st = self._sc
        dev = h_so.device
        diag, s_val, d_val = self.build_values_pairs(h_so, g_so)
        H = torch.diag(diag)
        for (u, w), val in (((st["su"], st["sv"]), s_val),
                            ((st["du"], st["dv"]), d_val)):
            if len(u):
                u, w = _index(u, dev), _index(w, dev)
                H[u, w] = val
                H[w, u] = val
        return H

    def quadform_values(self, V: torch.Tensor, vals,
                        tables: dict = None) -> torch.Tensor:
        """<v|H|v> of states in the native layout, one or a stack of k
        (-> (k,)), from a build_values result: a sigma-operator dict runs
        the string kernel, a Slater-Condon triple the gather-only row
        kernel _QFTabled (also on a string sector, for oracle access).
        The JAX package's two forms of the latter, with the tables as
        program arguments (_qf_tabled) or as baked constants
        (_quadform_fn), are one here: every tensor is an argument."""
        if isinstance(vals, dict):
            return _strings.quadform(V, vals, self._tabs(tables, V))
        diag, s_val, d_val = vals
        v = self._padded(V)
        t = tables if tables is not None and "VIDX" in tables else \
            self._pairs_device_tables(v.dtype, v.device)
        return _QFTabled.apply(v, diag, s_val, d_val, t["VIDX"], t["PTN"],
                               t["SU"], t["SV"], t["DU"], t["DV"])

    def _quadform_pairs(self, v: torch.Tensor, vals) -> torch.Tensor:
        """Pairwise-sum quadform, differentiated by autograd (the oracle
        of quadform_values; its backward scatters)."""
        st = self._sc
        diag, s_val, d_val = vals
        v = self._padded(v)[: self.dim]
        e = torch.sum(diag * v * v)
        for (u, w), val in (((st["su"], st["sv"]), s_val),
                            ((st["du"], st["dv"]), d_val)):
            if len(u):
                e = e + 2.0 * torch.sum(val * v[_index(u, v.device)]
                                        * v[_index(w, v.device)])
        return e

    def energy_values(self, theta: torch.Tensor, vals,
                      tables: dict = None) -> torch.Tensor:
        tabs = self._tabs(tables, theta)
        return self.quadform_values(self.state_matrix(theta, tabs), vals,
                                    tabs)

    def quadform(self, v: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        """<v|H|v> over a dense (nd, nd) sector Hamiltonian
        (build_hamiltonian), v in any layout `_padded` takes."""
        v = self._padded(v)[: self.dim]
        return v @ (H @ v)

    def energy(self, theta: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
        return self.quadform(self.state(theta), H)

    # -- sector-native RDMs --------------------------------------------------
    def rdms(self, v: torch.Tensor, tables: dict = None):
        """Spin-orbital (gamma, Gamma) from sector amplitudes (nd or
        nd + 1 long, or an (nB, nA) string matrix).  Pairs kernel: one
        gather W[a, b] = a+_a a_b v over same-spin pairs, then
          gamma[p, q] = v . W[p, q],
          Gamma[p, q, r, s] = <W[r, p], W[q, s]> - delta_qr gamma[p, s]
        on the sigma(p)=sigma(r), sigma(q)=sigma(s) blocks, and the other
        S_z-allowed blocks by antisymmetry Gamma[pqrs] = -Gamma[pqsr]."""
        tabs = self._tabs(tables, v)
        if self.kernel == "strings":
            V = v.reshape(-1)[: self.dim].reshape(self.state_shape)
            return _strings.rdms(V, tabs, self.rdm_maps(
                device=v.device, q_pad=_q_pad(tabs)))
        N = self.num_qubits
        vp = self._padded(v.reshape(-1))
        v = vp[: self.dim]
        W = tabs["rdm_SG"] * vp[tabs["rdm_SRC"]]
        gamma = (W @ v).reshape(N, N)
        Q4 = (W @ W.T).reshape(N, N, N, N)          # Q4[r, p, q, s]
        eye = torch.eye(N, dtype=v.dtype, device=v.device)
        Gamma_c = (Q4.permute(1, 2, 0, 3)
                   - torch.einsum("qr,ps->pqrs", eye, gamma))
        spin = (np.arange(N) >= N // 2).astype(np.int64)
        sp, sq = spin[:, None, None, None], spin[None, :, None, None]
        sr, ss = spin[None, None, :, None], spin[None, None, None, :]
        case1 = torch.as_tensor((sp == sr) & (sq == ss), device=v.device)
        case2 = torch.as_tensor((sp == ss) & (sq == sr), device=v.device)
        Gamma = torch.where(
            case1, Gamma_c,
            torch.where(case2, -Gamma_c.permute(0, 1, 3, 2),
                        Gamma_c.new_zeros(())))
        return gamma, Gamma

    def transition_rdm1(self, U: torch.Tensor, V: torch.Tensor,
                        tables: dict = None) -> torch.Tensor:
        """Spin-orbital transition 1-RDM gamma[p, s] = <u|a+_p a_s|v>
        between (nB, nA) string matrices; U may be batched (k, nB, nA).
        String kernel only, as in the JAX package."""
        if self.kernel != "strings":
            raise ValueError(
                "transition_rdm1 requires the string kernel (product-"
                "grid sector); this sector runs the 'pairs' kernel")
        return _strings.transition_rdm1(U, V, self._tabs(tables, V))


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
        self.kernel = "strings"
        self.state_shape = (self.nB, self.nA)
        hf_mask = ((1 << na) - 1) | (((1 << nb) - 1) << n)
        self.init_index = int(np.searchsorted(dets, hf_mask))
        self._dev_tabs = {}
        self._host_lists = None
        self._rdm_maps = {}
        self._content_key = ("SectorCI", N, (int(na), int(nb)))

    def __hash__(self):
        return hash(self._content_key)

    def __eq__(self, other):
        return (type(other) is SectorCI
                and other._content_key == self._content_key)

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

        CROSS is at `dtype`, the LIN pair maps int64.  The 'dense' and
        'int8' tables also carry each spin's single-excitation lists
        (strings.LIST_KEYS, read off the stacks once per instance), which
        route build_values and sigma_values to the list path."""
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
                    CROSS=torch.as_tensor(s.CROSS, device=device).to(dtype),
                    **{k: torch.as_tensor(a, device=device)
                       for k, a in self._lists().items()})
            self._dev_tabs[key] = tabs
        return tabs

    def _lists(self) -> dict:
        """The host single-excitation lists of both spins, made once."""
        if self._host_lists is None:
            s = self._str_tabs
            (sa, ga), (sb, gb) = (_strings.one_body_lists(M)
                                  for M in (s.MA, s.MB))
            self._host_lists = dict(zip(_strings.LIST_KEYS,
                                        (sa, ga, sb, gb)))
        return self._host_lists

    def replicated_tables(self, dtype: torch.dtype = torch.float64, *,
                          device) -> dict:
        """The pair maps LIN_A/LIN_B (int64) and CROSS (at `dtype`) on
        `device`: every table but the operator stacks (the lead device's
        part of parallel.shard_sector_tables)."""
        s = self._str_tabs
        return dict(
            LIN_A=torch.as_tensor(s.LIN_A.astype(np.int64), device=device),
            LIN_B=torch.as_tensor(s.LIN_B.astype(np.int64), device=device),
            CROSS=torch.as_tensor(s.CROSS, device=device).to(dtype))

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
        convention E = sum h gamma + sum g Gamma): strings.build_list_ops
        where the tables carry the single-excitation lists, else
        strings.build_ops."""
        tabs = self._tabs(tables, h_so)
        if _strings.has_lists(tabs):
            return _strings.build_list_ops(h_so, g_so, tabs)
        return _strings.build_ops(h_so, g_so, tabs)

    def sigma_values(self, V: torch.Tensor, vals: dict,
                     tables: dict = None) -> torch.Tensor:
        """H @ V for V (nB, nA) or (k, nB, nA), `vals` from build_values
        on the same tables: strings.sigma_lists where the tables carry the
        lists (each state counted in the running solve's
        sigma_list_matvecs), else strings.sigma."""
        tabs = self._tabs(tables, V)
        if _strings.has_lists(tabs):
            count("sigma_list_matvecs", V.shape[0] if V.dim() == 3 else 1)
            return _strings.sigma_lists(V, vals, tabs)
        return _strings.sigma(V, vals, tabs)

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
        return _strings.rdms(V, tabs, self.rdm_maps(device=V.device,
                                                    q_pad=_q_pad(tabs)))

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

