"""Sharding of the orbital-optimization hot path over several devices.

Port of the integral-tensor half of esoo_tpu/parallel/sharded.py.  The
scale axis is the starting basis: the spatial two-electron tensor is m^4
values and the transform g . u (x) u (x) u (x) u is the O(m^4 n) hot spot.
The JAX package shards it over a `jax.sharding.Mesh` with one controller
driving every device; the port keeps that model with an in-process device
list (`OrbitalMesh`): one Python process launches each shard's work on its
own device, and no process group is involved.

Layout (the JAX package's):

  * g is sharded along its LAST index s: shard d holds g[:, :, :, s_d],
    (m, m, m, m_loc), on mesh device d.  Contracting p, q and r touches
    only local data; the fourth stage contracts the local s rows of u and
    leaves a partial (n, n, n, n) tensor on each device.  The partials
    are summed on the lead device (`torch.cuda.comm.reduce_add` across
    distinct cards, a plain sum when the shards share one): one n^4
    reduction per energy or rotation, the psum of the JAX package.
  * u, h and the spin-summed RDMs live on the lead device and are copied
    to each shard's device where a shard needs them (O(m n) and O(n^4)).
  * Memory per device drops from m^4 to m^4 / D.

Autograd runs through the copies and the reduction, so du of the sharded
energy arrives on the lead device.  A mesh may name one device several
times (logical shards on one card, or on the CPU in tests): the layout
and the arithmetic are the same, only the memory is not spread.

Not ported yet: operator-axis sharding of the sector tables
(`shard_sector_tables`) and the state axis of a 2-D state x orb mesh.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import gemm
from ..orbital_optimization.stiefel import (_bb_projected_descent, orth,
                                            value_and_grad)
from ..utils.config import resolve_device


class OrbitalMesh:
    """An in-process device mesh: `devices` in row-major order over the
    axes of `shape` ({axis name: size}); the first device leads (it holds
    u, h, the RDMs and every reduced result)."""

    def __init__(self, devices: Sequence, shape: dict):
        self.devices = tuple(torch.device(d) for d in devices)
        self.shape = dict(shape)
        if int(np.prod(list(self.shape.values()))) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} does not hold "
                             f"{len(self.devices)} devices")

    @property
    def device(self) -> torch.device:
        """The lead device."""
        return self.devices[0]


def _mesh_devices(count: Optional[int], devices) -> List[torch.device]:
    """`devices` (each resolved: no CUDA device without a card), or the
    first `count` visible CUDA devices (all of them by default)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_orbital_mesh: no CUDA device is visible; pass "
                "devices= (e.g. ['cpu'] * 4) to build a mesh elsewhere")
        have = torch.cuda.device_count()
        count = have if count is None else int(count)
        if not 1 <= count <= have:
            raise ValueError(f"need {count} CUDA devices, have {have}")
        return [torch.device("cuda", i) for i in range(count)]
    devs = [resolve_device(d) for d in devices]
    if count is not None and int(count) != len(devs):
        raise ValueError(f"n_devices={count} but {len(devs)} devices given")
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return devs


def make_orbital_mesh(n_devices: Optional[int] = None,
                      axis_name: str = "orb",
                      devices: Optional[Sequence] = None) -> OrbitalMesh:
    """1-D mesh over the orbital-shard axis: every visible CUDA device (or
    the first `n_devices`), or the explicit `devices`, which may repeat
    one device (["cuda:0"] * 4 is four logical shards on one card)."""
    devs = _mesh_devices(n_devices, devices)
    return OrbitalMesh(devs, {axis_name: len(devs)})


def make_orbital_state_mesh(n_orb: int, n_state: int,
                            orb_axis: str = "orb",
                            state_axis: str = "state",
                            devices: Optional[Sequence] = None
                            ) -> OrbitalMesh:
    """2-D (state x orb) mesh, the orb axis innermost, as the JAX
    package's.  The solvers refuse its state axis (data-parallel k-state
    simulation is not ported yet); the mesh itself is the layout."""
    devs = _mesh_devices(n_orb * n_state, devices)
    return OrbitalMesh(devs, {state_axis: n_state, orb_axis: n_orb})


def _orb_size(mesh: OrbitalMesh, axis_name: str) -> int:
    if not isinstance(mesh, OrbitalMesh):
        raise TypeError(f"mesh must be an esoo_torch.parallel.OrbitalMesh "
                        f"(make_orbital_mesh); got {type(mesh).__name__}")
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no {axis_name!r} axis: {mesh.shape}")
    return mesh.shape[axis_name]


def shard_problem_tensors(mesh: OrbitalMesh, h_sp, g_sp,
                          axis_name: str = "orb"):
    """(h on the lead device, [g shard d on mesh device d]): g's last axis
    zero-padded up to a multiple of the mesh size (zero columns add
    nothing to any contraction) and split into D shards of
    (m, m, m, m_loc).  Inputs are NumPy arrays or tensors and keep their
    dtype; each shard is sliced from g where it lies and sent to its
    device alone."""
    D = _orb_size(mesh, axis_name)
    h = torch.as_tensor(h_sp).to(mesh.device)
    g = torch.as_tensor(g_sp)
    m = g.shape[-1]
    m_loc = -(-m // D)
    shards = []
    for d, dev in enumerate(mesh.devices[:D]):
        blk = g[..., d * m_loc: min(m, (d + 1) * m_loc)]
        pad = m_loc - blk.shape[-1]
        if pad:
            blk = torch.nn.functional.pad(blk, (0, pad))
        shards.append(blk.to(dev).contiguous())
    return h, shards


def _shard_rows(u: torch.Tensor, g_shards) -> List[torch.Tensor]:
    """u's rows of each shard's s block (zero rows past m), each on its
    shard's device."""
    m_loc = g_shards[0].shape[-1]
    pad = m_loc * len(g_shards) - u.shape[0]
    u_pad = torch.nn.functional.pad(u, (0, 0, 0, pad)) if pad else u
    return [u_pad[d * m_loc:(d + 1) * m_loc].to(gl.device)
            for d, gl in enumerate(g_shards)]


class _ReduceAdd(torch.autograd.Function):
    """Sum of per-card partials onto the lead card
    (torch.cuda.comm.reduce_add); the gradient goes back to every card."""

    @staticmethod
    def forward(ctx, lead: int, *parts):
        from torch.cuda import comm
        ctx.devices = [p.device for p in parts]
        return comm.reduce_add(parts, destination=lead)

    @staticmethod
    def backward(ctx, grad):
        return (None,) + tuple(grad.to(d) for d in ctx.devices)


def _reduce_to_lead(mesh: OrbitalMesh, parts: List[torch.Tensor]
                    ) -> torch.Tensor:
    """The partials' sum on the lead device (in shard order)."""
    devs = [p.device for p in parts]
    if len(set(devs)) == len(devs) > 1 and \
            all(d.type == "cuda" for d in devs):
        return _ReduceAdd.apply(mesh.device.index or 0, *parts)
    return functools.reduce(torch.add, [p.to(mesh.device) for p in parts])


def sharded_rotated_energy(mesh: OrbitalMesh, axis_name: str = "orb"):
    """E(u; RDMs, integrals) with g sharded over `mesh`:
      energy(u, gamma_s, Gamma_s, h_sp, g_shards) -> scalar on the lead
    device, differentiable in u by autograd; the only traffic between
    devices is u out and one n^4 partial back per shard."""
    _orb_size(mesh, axis_name)

    def energy(u, gamma_s, Gamma_s, h_sp, g_shards):
        # each shard's staged chain: stages 1-3 contract p, q, r (local
        # data), stage 4 the shard's s rows (plain PyTorch, differentiable)
        parts = [gemm.rotate_two_body_shard_plain(gl, u.to(gl.device), ul)
                 for gl, ul in zip(g_shards, _shard_rows(u, g_shards))]
        g_rot = _reduce_to_lead(mesh, parts)
        e2 = torch.sum(g_rot * Gamma_s)
        e1 = torch.sum((u.T @ h_sp @ u) * gamma_s)
        return e1 + e2

    return energy


def _spatial_partial(g_loc: torch.Tensor, u: torch.Tensor,
                     u_loc: torch.Tensor) -> torch.Tensor:
    """One shard's part of kernels.rotate_two_body_auto, with the sum over
    s restricted to the shard's rows: the kron sandwich W^T (G2_d W_d)
    while n^2 <= 2m, else the minor-axis chain from the local axis (the
    unsharded rule and stage order; differentiable)."""
    m, n = u.shape
    m_loc = u_loc.shape[0]
    if n * n <= 2 * m:
        W = torch.einsum("pi,qj->pqij", u, u).reshape(m * m, n * n)
        W_d = torch.einsum("ri,sj->rsij", u, u_loc).reshape(m * m_loc,
                                                            n * n)
        G2_d = g_loc.reshape(m * m, m * m_loc)
        return (W.T @ (G2_d @ W_d)).reshape(n, n, n, n)
    t = torch.tensordot(g_loc, u_loc, dims=([3], [0]))   # (p, q, r, l)
    t = torch.tensordot(t, u, dims=([2], [0]))           # (p, q, l, k)
    t = torch.tensordot(t, u, dims=([1], [0]))           # (p, l, k, j)
    t = torch.tensordot(t, u, dims=([0], [0]))           # (l, k, j, i)
    return t.permute(3, 2, 1, 0)


def sharded_spatial_energy(mesh: OrbitalMesh, axis_name: str = "orb"):
    """The fused solvers' orbital energy, kernels.rotated_energy_spatial,
    over a sharded g:
      energy(u, gamma_s, Gamma_s, h_sp, g_shards) -> scalar on the lead
    device, differentiable in u.  Each shard runs the unsharded
    expression (`_spatial_partial`) over its s rows and the n^4 partials
    are summed on the lead device: the JAX package partitions the same
    expression over its mesh (GSPMD), and the arithmetic stays that of
    the unsharded BB loop but for the order of the sum over s.
    `sharded_rotated_energy` (the staged chain) is the class API's."""
    _orb_size(mesh, axis_name)

    def energy(u, gamma_s, Gamma_s, h_sp, g_shards):
        parts = [_spatial_partial(gl, u.to(gl.device), ul)
                 for gl, ul in zip(g_shards, _shard_rows(u, g_shards))]
        e1 = torch.sum((u.T @ h_sp @ u) * gamma_s)
        e2 = torch.sum(_reduce_to_lead(mesh, parts) * Gamma_s)
        return e1 + e2

    return energy


def rotate_two_body_sharded(mesh: OrbitalMesh, g_shards, u: torch.Tensor
                            ) -> torch.Tensor:
    """The rotated (n, n, n, n) tensor of a sharded g on the lead device:
    each shard's four-stage transform (ops/gemm.py::rotate_two_body_shard,
    the K1 kernel on a card), reduced.  Not differentiable."""
    parts = [gemm.rotate_two_body_shard(gl, u.to(gl.device), ul)
             for gl, ul in zip(g_shards, _shard_rows(u, g_shards))]
    return _reduce_to_lead(mesh, parts)


def sharded_bb_step(mesh: OrbitalMesh, axis_name: str = "orb"):
    """One Barzilai-Borwein projected-gradient step over the mesh:
      step(U, U_prev, G_prev, k, gamma_s, Gamma_s, h, g_shards)
        -> (U_next, U, G, E)
    (value-and-grad of the sharded energy, the BB1/BB2 step size by the
    parity of k, the polar retraction), as the JAX package's."""
    vag = value_and_grad(sharded_rotated_energy(mesh, axis_name))

    def step(U, U_prev, G_prev, k, gamma_s, Gamma_s, h_sp, g_shards):
        E, G = vag(U, gamma_s, Gamma_s, h_sp, g_shards)
        dU = U - U_prev
        dG = G - G_prev
        uu = torch.sum(dU * dU)
        ug = torch.abs(torch.sum(dU * dG))
        gg = torch.sum(dG * dG)
        eps = 1e-30
        tau = uu / (ug + eps) if int(k) % 2 == 1 else ug / (gg + eps)
        return orth(U - tau * G), U, G, E

    return step


class ShardedOrbitalOptimizer:
    """The BB descent of stiefel.py over a mesh-sharded g: the contract of
    PartialUnitaryProjectionOptimizer.compute_optimal_rotation at fixed
    spin-summed RDMs, for g tensors past one device's memory."""

    def __init__(self, mesh: OrbitalMesh, initial_BBstepsize: float = 1e-3,
                 stopping_tolerance: float = 1e-5, maxiter: int = 10000,
                 decay_factor: float = 0.8, axis_name: str = "orb"):
        self.mesh = mesh
        self.axis_name = axis_name
        self.BBstepsize = initial_BBstepsize
        self.stopping_tolerance = stopping_tolerance
        self.maxiter = maxiter
        self.decay_factor = decay_factor
        self._vag = value_and_grad(sharded_rotated_energy(mesh, axis_name))

    def compute_optimal_rotation(self, U0, gamma_s, Gamma_s, h_sp,
                                 g_shards) -> Tuple[torch.Tensor, float]:
        """(U_opt on the lead device, E_opt) from U0, the RDMs and h (on
        the lead device, or NumPy arrays to upload) and the g shards."""
        lead = self.mesh.device
        dtype = g_shards[0].dtype
        U0, gamma_s, Gamma_s, h_sp = (
            torch.as_tensor(a).to(device=lead, dtype=dtype)
            for a in (U0, gamma_s, Gamma_s, h_sp))

        def scalar(v):
            return torch.tensor(v, dtype=dtype, device=lead)

        U, E, _, _, _ = _bb_projected_descent(
            self._vag, U0, (gamma_s, Gamma_s, h_sp, g_shards),
            scalar(self.BBstepsize), scalar(self.stopping_tolerance),
            scalar(self.decay_factor), int(self.maxiter))
        return U, float(E)


def shard_sector_tables(mesh: OrbitalMesh, sector, dtype,
                        axis_name: str = "orb", storage: str = "dense"):
    """Operator-axis sharding of a sector's string tables (the JAX
    package's sigma and RDM split across devices): not ported yet.  The
    solvers keep the sector tables unsharded on the lead device."""
    raise NotImplementedError(
        "shard_sector_tables: operator-axis sharding of the sector "
        "tables, not ported yet")
