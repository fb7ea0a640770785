"""The string sector kernels over a mesh's operator-axis shards.

The JAX package places a sector's one-body operator stacks MA/MB sharded
over the mesh on their operator axis (parallel.shard_sector_tables,
P('orb', None, None)) and lets GSPMD partition sigma, the RDMs and the
diagonal.  The port writes the partition out.  With D shards and the
operator axis zero-padded to q_pad = D c, shard d holds the alpha
operators d c .. d c + c - 1 and the beta operators of the same slice,
on its own device; every other table is replicated on the lead device.

  * T: device d builds T_d = [D_a v] over its shard's 2c operators
    (alpha block, then beta), (2c, nd): 1/D of the whole T.
  * sigma: G2 couples every operator pair, so U_d = sum_e G2[d, e] T_e
    needs every shard's T.  Device d streams them, one T_e copied in at
    a time (a no-op for logical shards on one device), accumulates U_d,
    and back-contracts sum_{a in d} D_a U_a; the D partial sigmas are
    summed on the lead device (torch.cuda.comm.reduce_add across distinct
    cards).  A device holds its stacks, T_d, one streamed T_e and U_d:
    stacks / D + 3 T / D.
  * RDMs: the pair correlations T T^T block by block (d, e >= d) on
    device d, assembled on the lead; the pair sums T v a shard at a time.
  * diagonal: the same-spin term streams the stacks like sigma; the
    cross term needs only the stacks' diagonals, gathered to the lead.

Autograd runs through the copies and the reduction, so the VQE family's
L-BFGS differentiates quadform(apply_gates(V0, theta)) through the
sharded sigma; batched (k, nB, nA) states carry through.  Storage
'compact' keeps each shard int8 (the dense kernels' keys, cast on its own
device at each call).  The products by the stacks take the exact bf16
split under ops.split_precision.force_split(True), as the unsharded
ones do.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from . import strings as _s


class ShardedStringTables:
    """A sector's string tables on a mesh: `MA[d]`/`MB[d]`, shard d of
    each operator stack ((c, nA, nA) / (c, nB, nB), int8 for storage
    'compact', else at the tables' dtype) on its device, and `rep`, every
    other table, on the lead device (`device`, the first shard's).  On a
    2-D (state x orb) mesh, `rows[r]` is the same layout on state row r
    (rows[0] is this object)."""

    def __init__(self, rep: dict, MA: Sequence[torch.Tensor],
                 MB: Sequence[torch.Tensor], storage: str):
        self.rep = rep
        self.MA = list(MA)
        self.MB = list(MB)
        self.storage = storage
        self.c = int(self.MA[0].shape[0])
        self.q_pad = self.c * len(self.MA)
        self.devices = [M.device for M in self.MA]
        self.rows = (self,)

    @property
    def device(self) -> torch.device:
        """The lead device (the replicated tables and every result)."""
        return self.devices[0]


def _reduce(tabs: ShardedStringTables, parts: List[torch.Tensor]
            ) -> torch.Tensor:
    from ..parallel.sharded import reduce_to
    return reduce_to(tabs.device, parts)


def _operands(tabs: ShardedStringTables, d: int, dt: torch.dtype):
    """Shard d's stacks as the operands of their products
    (strings._stack_operand: cast on the shard's own device)."""
    return (_s._stack_operand(tabs.MA[d], dt),
            _s._stack_operand(tabs.MB[d], dt))


def _t_shards(V: torch.Tensor, tabs: ShardedStringTables
              ) -> List[torch.Tensor]:
    """T_d = [D_a v] over shard d's operators, (..., 2c, nd), on device d
    (the alpha operators, then the beta ones)."""
    return [_s._t_tensor(V.to(dev), *_operands(tabs, d, V.dtype))
            for d, dev in enumerate(tabs.devices)]


def _rows(tabs: ShardedStringTables, d: int, device) -> torch.Tensor:
    """The (2c,) rows of G2 (and of the pair-correlation matrix) that
    belong to shard d: its alpha operators, then its beta ones."""
    c, q = tabs.c, tabs.q_pad
    a = torch.arange(d * c, (d + 1) * c, device=device)
    return torch.cat([a, a + q])


def build_ops(h_so: torch.Tensor, g_so: torch.Tensor,
              tabs: ShardedStringTables) -> dict:
    """strings.build_ops over the shards: G2 embedded at q_pad on the lead
    device, with its (2c, 2c) blocks G2[d, e] on device d under
    "G2_blocks" (sigma's streaming), and FA/FB folded a shard at a time
    and summed on the lead device.  Differentiable in (h, g)."""
    dt = h_so.dtype
    c = tabs.c
    G2, hA, hB = _s._pair_coupling(h_so, g_so, tabs.rep, tabs.q_pad)

    def fold(hvec, stacks):
        return _reduce(tabs, [
            torch.einsum("q,qji->ji", hvec[d * c:(d + 1) * c].to(M.device),
                         M.to(dt)) for d, M in enumerate(stacks)])

    rows = [_rows(tabs, d, G2.device) for d in range(len(tabs.devices))]
    blocks = [[G2[rd][:, re].to(dev) for re in rows]
              for rd, dev in zip(rows, tabs.devices)]
    return {"G2": G2, "FA": fold(hA, tabs.MA), "FB": fold(hB, tabs.MB),
            "G2_blocks": blocks}


def _accumulate(U, blk: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    if U is None:
        return blk @ T
    if T.dim() == 2:
        return U.addmm_(blk, T)
    return U + blk @ T


def sigma(V: torch.Tensor, ops: dict, tabs: ShardedStringTables
          ) -> torch.Tensor:
    """H . v of strings.sigma, V (nB, nA) or (k, nB, nA) on the lead
    device, over the shards (see the module docstring)."""
    dt = V.dtype
    nB, nA = V.shape[-2:]
    c = tabs.c
    s1 = V @ ops["FA"].T + ops["FB"] @ V
    Ts = _t_shards(V, tabs)
    parts = []
    for d, dev in enumerate(tabs.devices):
        U = None
        for blk, T in zip(ops["G2_blocks"][d], Ts):
            U = _accumulate(U, blk, T.to(dev))
        U = U.unflatten(-1, (nB, nA))
        MA, MB = _operands(tabs, d, dt)
        parts.append(_s._stack_einsum(_s._BACK_EIN["A"], MA, U[..., :c, :, :])
                     + _s._stack_einsum(_s._BACK_EIN["B"], MB,
                                        U[..., c:, :, :]))
        del U
    return s1 + _reduce(tabs, parts)


def _by_spin(parts: List[torch.Tensor], c: int):
    """(alpha, beta) halves, in operator order, of per-shard (..., 2c)
    pair sums."""
    return (torch.cat([p[..., :c] for p in parts], dim=-1),
            torch.cat([p[..., c:] for p in parts], dim=-1))


def rdms(V: torch.Tensor, tabs: ShardedStringTables, maps):
    """strings.rdms over the shards: the pair sums T_d v and the pair
    correlations T_d T_e^T (e >= d, on device d), assembled on the lead
    device in the unsharded (2 q_pad)^2 order that `maps` (for q_pad)
    reads."""
    dt, lead = V.dtype, tabs.device
    Ts = _t_shards(V, tabs)
    v = V.reshape(-1)
    gp_a, gp_b = _by_spin([(T @ v.to(T.device)).to(lead) for T in Ts],
                          tabs.c)
    D = len(Ts)
    blocks = [[None] * D for _ in range(D)]
    for d in range(D):
        for e in range(d, D):
            blk = (Ts[d] @ Ts[e].to(Ts[d].device).T).to(lead)
            blocks[d][e], blocks[e][d] = blk, blk.T
    in_shard_order = torch.cat([torch.cat(r, dim=1) for r in blocks])
    order = torch.cat([_rows(tabs, d, lead) for d in range(D)])
    P = 2 * tabs.q_pad
    G2f = in_shard_order.new_zeros((P, P))
    G2f[order[:, None], order[None, :]] = in_shard_order
    return _s._assemble_rdms(gp_a, gp_b, G2f.reshape(-1), maps, dt)


def transition_rdm1(U: torch.Tensor, V: torch.Tensor,
                    tabs: ShardedStringTables) -> torch.Tensor:
    """strings.transition_rdm1 over the shards: each shard's T_d of the
    ket against the whole bra stack, (k, 2c) pair sums to the lead."""
    batched = U.dim() == 3
    Uf = (U if batched else U[None]).flatten(1)
    ga, gb = _by_spin([(Uf.to(T.device) @ T.T).to(tabs.device)
                       for T in _t_shards(V, tabs)], tabs.c)
    gamma = _s._transition_gamma(ga, gb, tabs.rep)
    return gamma if batched else gamma[0]


def _diag_same_spin(G: torch.Tensor, stacks: List[torch.Tensor], c: int,
                    dt: torch.dtype, tabs: ShardedStringTables
                    ) -> torch.Tensor:
    """d2[i] = sum_ab G[a,b] sum_j M[a,i,j] M[b,j,i] over one spin's
    (q_pad, q_pad) block G: device d forms W[a, j, i] = sum_b G[a, b]
    M[b, j, i] for its operators a, streaming every shard's stack in, and
    contracts it with its own."""
    parts = []
    for d, Md in enumerate(stacks):
        dev, ns = Md.device, Md.shape[1]
        W = torch.zeros((c, ns * ns), dtype=dt, device=dev)
        for e, Me in enumerate(stacks):
            W.addmm_(G[d * c:(d + 1) * c, e * c:(e + 1) * c].to(dev),
                     Me.to(dev).to(dt).reshape(c, -1))
        parts.append((Md.to(dt).mT * W.reshape(c, ns, ns)).sum(dim=(0, 1)))
    return _reduce(tabs, parts)


def diagonal(ops: dict, tabs: ShardedStringTables) -> torch.Tensor:
    """strings.diagonal over the shards (see the module docstring)."""
    dt = ops["FA"].dtype
    qp, c, lead = tabs.q_pad, tabs.c, tabs.device
    G2 = ops["G2"]
    W_cross = G2[:qp, qp:] + G2[qp:, :qp].T

    def diagonals(stacks):
        return torch.cat([torch.diagonal(M, dim1=1, dim2=2).to(lead)
                          for M in stacks]).to(dt)

    cross = torch.einsum("ab,ai,bj->ji", W_cross, diagonals(tabs.MA),
                         diagonals(tabs.MB))
    dA = torch.diagonal(ops["FA"]) + _diag_same_spin(G2[:qp, :qp], tabs.MA,
                                                     c, dt, tabs)
    dB = torch.diagonal(ops["FB"]) + _diag_same_spin(G2[qp:, qp:], tabs.MB,
                                                     c, dt, tabs)
    return dA[None, :] + dB[:, None] + cross
