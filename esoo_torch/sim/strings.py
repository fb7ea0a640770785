"""String-factorized sector kernels.

Port of esoo_tpu/sim/strings.py.  The particle-number sector of a UCC
circuit is the product space {beta string} x {alpha string}: with the
block-spin Jordan-Wigner ordering the sorted determinant list is the
row-major (beta, alpha) grid, so sector amplitudes are a string matrix
V[ib, ia] of shape (nB, nA), and

  * one UCC excitation is a factorized Givens bank
        V' = V + (cos th - 1) * M (.) V + sin th * S (.) V[pB][:, pA]
    with M the touched mask, S the sign field and (pA, pB) the partner
    permutations (the JAX package forms the permutation sandwich
    EB V EA^T as two one-hot GEMMs for the TPU's matrix unit; here it is
    an index gather, which gives the same numbers exactly);
  * the sector Hamiltonian acts through same-spin one-body operators
    D_pq = a+_p a_q, each a signed string permutation, so
        H v = V FA^T + FB V + sum_a D_a (sum_b g~[a, b] D_b v)
    is a few batched products over the P = 2 n^2 same-spin pairs.

Host builders (`build_string_tables`, `_one_body_matrices`,
`_build_pair_tables`, `build_rdm_maps`) are NumPy copies of the JAX
package's; device kernels take a tables dict of tensors
(sector.SectorUCC.device_tables or convert.string_tables_from_numpy).
Compact tables (`compact_tables`: int8 stacks under "MA8"/"MB8") route
build_ops, sigma, rdms, transition_rdm1 and diagonal to their
operator-chunked variants.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def _bitcount(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a).astype(np.uint64)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(a).astype(np.int64)
    # SWAR popcount (NumPy < 2.0)
    a = a - ((a >> np.uint64(1)) & np.uint64(0x5555555555555555))
    a = (a & np.uint64(0x3333333333333333)) + \
        ((a >> np.uint64(2)) & np.uint64(0x3333333333333333))
    a = (a + (a >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((a * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
        np.int64)


def _parity_below(masks: np.ndarray, pos: int) -> np.ndarray:
    """(-1)^(number of set bits below `pos`) for an array of bitmasks."""
    return 1.0 - 2.0 * (_bitcount(masks & ((1 << pos) - 1)) & 1)


class StringTables(NamedTuple):
    """Host-side constant tables for the string-factorized kernels."""
    # string basis
    A: np.ndarray            # (nA,) sorted alpha-string bitmasks
    B: np.ndarray            # (nB,) sorted beta-string bitmasks
    # per-gate factorized Givens tables, all (K, nA) / (K, nB)
    PA: np.ndarray           # int32 partner permutation on alpha strings
    PB: np.ndarray           # int32 partner permutation on beta strings
    AD: np.ndarray           # alpha dom mask (0/1 float)
    AR: np.ndarray           # alpha ran mask
    UD: np.ndarray           # alpha dom mask * alpha sign factor
    UR: np.ndarray           # alpha ran mask * alpha sign factor
    BD: np.ndarray           # beta dom mask
    BR: np.ndarray           # beta ran mask
    VD: np.ndarray           # beta dom mask * beta sign factor
    VR: np.ndarray           # beta ran mask * beta sign factor
    # same-spin one-body operator matrices, (n^2, nA, nA) / (n^2, nB, nB)
    MA: np.ndarray
    MB: np.ndarray
    # pair-coupling index tables for the on-device g~ assembly, (P, P)
    LIN_A: np.ndarray        # int32 flat indices into g.reshape(-1)
    LIN_B: np.ndarray        # int32 flat indices (cross-pairing term)
    CROSS: np.ndarray        # float 0/1 mask (cross-spin pair rows/cols)


def build_string_tables(dets: np.ndarray, n: int,
                        pair_lo, pair_hi, pair_sg) -> StringTables:
    """Factorize the sector + its per-gate Givens tables over alpha/beta
    strings.  Raises ValueError if the determinant set is not a full
    product grid or a gate's pair table does not factorize."""
    dets = np.asarray(dets, dtype=np.int64)
    nd = len(dets)
    A = np.unique(dets & ((1 << n) - 1))
    B = np.unique(dets >> n)
    nA, nB = len(A), len(B)
    if nA * nB != nd:
        raise ValueError("sector is not an alpha x beta product grid")
    grid = ((B[:, None] << n) | A[None, :]).ravel()
    if not np.array_equal(dets, grid):
        raise ValueError("determinant order is not the row-major "
                         "(beta, alpha) product grid")

    K = len(pair_lo)
    PA = np.tile(np.arange(nA, dtype=np.int32), (K, 1))
    PB = np.tile(np.arange(nB, dtype=np.int32), (K, 1))
    AD = np.zeros((K, nA)); AR = np.zeros((K, nA))
    UD = np.zeros((K, nA)); UR = np.zeros((K, nA))
    BD = np.zeros((K, nB)); BR = np.zeros((K, nB))
    VD = np.zeros((K, nB)); VR = np.zeros((K, nB))

    for k in range(K):
        lo = np.asarray(pair_lo[k], dtype=np.int64)
        hi = np.asarray(pair_hi[k], dtype=np.int64)
        sg = np.asarray(pair_sg[k], dtype=np.float64)
        if len(lo) == 0:
            raise ValueError(f"gate {k} has an empty domain")
        ibl, ial = lo // nA, lo % nA
        ibh, iah = hi // nA, hi % nA
        domA = np.unique(ial); domB = np.unique(ibl)
        ranA = np.unique(iah); ranB = np.unique(ibh)
        if len(domA) * len(domB) != len(lo):
            raise ValueError(f"gate {k} domain is not a product set")
        # partner maps must be consistent functions of one side alone
        pa = np.full(nA, -1, dtype=np.int64)
        pb = np.full(nB, -1, dtype=np.int64)
        pa[ial] = iah          # last write wins; verify below
        pb[ibl] = ibh
        if not (np.all(pa[ial] == iah) and np.all(pb[ibl] == ibh)):
            raise ValueError(f"gate {k} partner map does not factorize")
        # sign factorization sg(ia, ib) = fA(ia) * fB(ib)
        ib0, ia0 = domB[0], domA[0]
        fA = np.zeros(nA)
        fA[ial[ibl == ib0]] = sg[ibl == ib0]
        fB = np.zeros(nB)
        fB[ibl[ial == ia0]] = sg[ial == ia0] * fA[ia0]
        if not np.allclose(sg, fA[ial] * fB[ibl]):
            raise ValueError(f"gate {k} sign field does not factorize")
        # dom/ran products must be disjoint (T^2 = 0 on the sector):
        # overlap requires BOTH per-side intersections to be non-empty
        if (np.intersect1d(domA, ranA).size
                and np.intersect1d(domB, ranB).size):
            raise ValueError(f"gate {k} dom/ran products overlap")
        AD[k, domA] = 1.0; AR[k, ranA] = 1.0
        BD[k, domB] = 1.0; BR[k, ranB] = 1.0
        UD[k, domA] = fA[domA]
        VD[k, domB] = fB[domB]
        # ran-side factors mirror their dom partner's factor
        PA[k, domA] = pa[domA]
        PA[k, pa[domA]] = domA
        PB[k, domB] = pb[domB]
        PB[k, pb[domB]] = domB
        UR[k, pa[domA]] = fA[domA]
        VR[k, pb[domB]] = fB[domB]

    MA = _one_body_matrices(A, n)
    MB = _one_body_matrices(B, n)
    LIN_A, LIN_B, CROSS = _build_pair_tables(n)
    return StringTables(A=A, B=B, PA=PA, PB=PB,
                        AD=AD, AR=AR, UD=UD, UR=UR,
                        BD=BD, BR=BR, VD=VD, VR=VR,
                        MA=MA, MB=MB,
                        LIN_A=LIN_A, LIN_B=LIN_B, CROSS=CROSS)


def _one_body_matrices(S: np.ndarray, n: int) -> np.ndarray:
    """M[(p*n + r), j, i] = <S[j]| a+_p a_r |S[i]> over one spin's
    strings, with the within-block JW phases.  Stored int8: every entry
    is a JW sign in {0, +-1}."""
    ns = len(S)
    M = np.zeros((n * n, ns, ns), dtype=np.int8)
    index = {int(s): i for i, s in enumerate(S)}
    for r in range(n):
        occ_r = ((S >> r) & 1) == 1
        src = np.nonzero(occ_r)[0]
        s1 = S[src] & ~(1 << r)
        sgn1 = _parity_below(S[src], r)
        for p in range(n):
            if p == r:
                M[p * n + r, src, src] = 1.0
                continue
            free_p = ((s1 >> p) & 1) == 0
            s2 = s1[free_p] | (1 << p)
            sgn = sgn1[free_p] * _parity_below(s1[free_p], p)
            dst = np.array([index[int(x)] for x in s2], dtype=np.int64)
            M[p * n + r, dst, src[free_p]] = sgn
    return M


def _build_pair_tables(n: int):
    """Index tables assembling the (P, P) pair-coupling matrix g~ from
    g_so.reshape(-1), P = 2 n^2 same-spin pairs (alpha pairs (p, r) ->
    p*n + r first, then beta):

      sigma(p)=sigma(r), sigma(q)=sigma(s):
          a+_p a+_q a_s a_r = D_pr D_qs - delta_qr D_ps
          -> g~[(p,r), (q,s)] += g_pqrs      (LIN_A; the delta term is
             folded into h~ = h - sum_q g[p,q,q,s] by build_ops)
      sigma(p)=sigma(s) != sigma(q)=sigma(r):
          a+_p a+_q a_s a_r = -D_qr D_ps
          -> g~[(q,r), (p,s)] -= g_pqrs      (LIN_B on CROSS entries)"""
    N = 2 * n
    # pair t -> spin-orbital indices (x1, x2) = (creation, annihilation)
    p_ = np.arange(n)
    x1 = np.concatenate([np.repeat(p_, n), np.repeat(p_ + n, n)])
    x2 = np.concatenate([np.tile(p_, n), np.tile(p_ + n, n)])
    spin = np.concatenate([np.zeros(n * n, np.int64),
                           np.ones(n * n, np.int64)])
    # LIN_A[a, b] = flat index of g[pa, qb, ra, sb]
    pa, ra = x1[:, None], x2[:, None]
    qb, sb = x1[None, :], x2[None, :]
    LIN_A = (((pa * N + qb) * N + ra) * N + sb).astype(np.int32)
    # LIN_B[a, b] = flat index of g[y1, x1a, x2a, y2] with a=(x1a,x2a),
    # b=(y1,y2) of opposite spin
    y1, y2 = x1[None, :], x2[None, :]
    x1a, x2a = x1[:, None], x2[:, None]
    LIN_B = (((y1 * N + x1a) * N + x2a) * N + y2).astype(np.int32)
    CROSS = (spin[:, None] != spin[None, :]).astype(np.float64)
    return LIN_A, LIN_B, CROSS


# -- gate application -------------------------------------------------------

def gate_fields(tabs: dict):
    """Per-gate (K, nB, nA) touched mask M = bD aD^T + bR aR^T and sign
    field S = vR uR^T - vD uD^T, and the (K, nB*nA) flat partner index of
    the permutation V -> V[pB][:, pA].  Entries of M and S are 0/+-1, so
    precomputing them changes no value."""
    M = (tabs["BD"][:, :, None] * tabs["AD"][:, None, :]
         + tabs["BR"][:, :, None] * tabs["AR"][:, None, :])
    S = (tabs["VR"][:, :, None] * tabs["UR"][:, None, :]
         - tabs["VD"][:, :, None] * tabs["UD"][:, None, :])
    nA = tabs["PA"].shape[1]
    flat = (tabs["PB"][:, :, None] * nA + tabs["PA"][:, None, :]).reshape(
        tabs["PA"].shape[0], -1)
    return M, S, flat


def _perm(V: torch.Tensor, flat_k: torch.Tensor) -> torch.Tensor:
    """V[pB][:, pA] for one gate (the JAX package's EB V EA^T), over the
    last two axes."""
    return V.flatten(-2)[..., flat_k].reshape(V.shape)


def _gate_step_str(V, flat_k, M_k, S_k, c_k, s_k):
    """One factorized Givens-bank gate on the string matrix V (nB, nA),
    given c_k = cos th and s_k = sin th:
        V' = V + (cos th - 1) * M (.) V + sin th * S (.) V[pB][:, pA]"""
    G = _perm(V, flat_k)
    return V + (c_k - 1.0) * (M_k * V) + s_k * (S_k * G)


class _ApplyRevStr(torch.autograd.Function):
    """Factorized gate application with the REVERSIBLE backward of
    esoo_tpu sim/strings.py::_apply_rev_str_bwd: gates are orthogonal, so
    the backward rebuilds V_{k-1} by inverse rotation (O(1) residual
    memory) and the cotangent recursion W <- G^T W is the same formula
    with th -> -th.  One batched permutation of (V_k, W) per gate; the
    permutation of V_{k-1} follows from it exactly (perm is an involution
    mapping dom <-> ran, under which M is even and S odd).  V0 may carry
    leading batch axes (k states through one theta): each state's
    amplitudes are those of its own run, and dtheta sums over the batch."""

    @staticmethod
    def forward(ctx, V0, theta, M, S, flat):
        c = torch.cos(theta)
        s = torch.sin(theta)
        V = V0
        for k in range(theta.shape[0]):
            V = _gate_step_str(V, flat[k], M[k], S[k], c[k], s[k])
        ctx.save_for_backward(V, theta, M, S, flat)
        return V

    @staticmethod
    def backward(ctx, ct):
        V, theta, M, S, flat = ctx.saved_tensors
        c = torch.cos(theta)
        s = torch.sin(theta)
        W, Vk = ct, V
        dths = [None] * theta.shape[0]
        for k in reversed(range(theta.shape[0])):
            ck1, sk, Mk, Sk = c[k] - 1.0, s[k], M[k], S[k]
            GX = torch.stack([Vk, W]).flatten(-2)[..., flat[k]].reshape(
                (2,) + Vk.shape)
            G_k, GW = GX[0], GX[1]
            # V_{k-1} = G(-th) V_k (orthogonal inverse)
            V_prev = Vk + ck1 * (Mk * Vk) - sk * (Sk * G_k)
            perm_V_prev = G_k + ck1 * (Mk * G_k) + sk * (Sk * Vk)
            # dL/dth_k = W . (dG/dth) V_{k-1}
            dG_V = -sk * (Mk * V_prev) + c[k] * (Sk * perm_V_prev)
            dths[k] = torch.sum(W * dG_V)
            # W_{k-1} = G^T W = G(-th) W
            W = W + ck1 * (Mk * W) - sk * (Sk * GW)
            Vk = V_prev
        return W, torch.stack(dths), None, None, None


def apply_gates(V0: torch.Tensor, theta: torch.Tensor, tabs: dict,
                fields=None) -> torch.Tensor:
    """Gate application on the string matrix with the reversible backward.
    `fields` (from `gate_fields`) may be passed precomputed."""
    if int(theta.shape[0]) == 0:
        return V0
    M, S, flat = gate_fields(tabs) if fields is None else fields
    return _ApplyRevStr.apply(V0, theta, M.to(V0.dtype), S.to(V0.dtype),
                              flat)


# -- compact (int8-stack, operator-chunked) kernel variants -----------------
#
# Port of the compact section of esoo_tpu/sim/strings.py.  The dense
# kernels hold the float stacks MA/MB ((n^2, ns, ns) per spin) and the
# whole (2 q, nd) T tensor; at N=32 (nA = 1820, nd = 3.31M) that is 2 x
# 3.4 GB of float32 stacks and 6.8 GB of T.  Every stack entry is a JW
# sign in {0, +-1}, so compact tables keep them int8 (keys "MA8"/"MB8",
# the operator axis zero-padded to a multiple of _OP_CHUNK) and the
# kernels below cast one chunk of _OP_CHUNK operators at a time, in a
# Python loop over chunks.  Only one (q_pad, nd) T half is live at a time:
# the second half is built after the first is deleted.  Key presence
# ("MA8" in tabs) selects these variants, as in the JAX package.

_OP_CHUNK = 32


def compact_tables(s: StringTables, dtype: torch.dtype, *, device) -> dict:
    """Compact tables dict from a StringTables: int8 operator stacks under
    "MA8"/"MB8" (operator axis zero-padded to a multiple of _OP_CHUNK),
    the LIN pair maps int64 and CROSS at `dtype`, on `device`.  Gate
    tables are not carried (the compact path serves the gate-free
    SectorCI)."""
    q = s.MA.shape[0]
    pad = [(0, -q % _OP_CHUNK), (0, 0), (0, 0)]
    return dict(
        MA8=torch.as_tensor(np.pad(np.asarray(s.MA, np.int8), pad),
                            device=device),
        MB8=torch.as_tensor(np.pad(np.asarray(s.MB, np.int8), pad),
                            device=device),
        LIN_A=torch.as_tensor(s.LIN_A.astype(np.int64), device=device),
        LIN_B=torch.as_tensor(s.LIN_B.astype(np.int64), device=device),
        CROSS=torch.as_tensor(s.CROSS, device=device).to(dtype))


def _chunks(M8: torch.Tensor):
    """(start, float-castable int8 chunk) over the operator axis."""
    c = min(_OP_CHUNK, M8.shape[0])
    return ((q0, M8[q0:q0 + c]) for q0 in range(0, M8.shape[0], c))


def _fold_one_body(hvec: torch.Tensor, M8: torch.Tensor, dt) -> torch.Tensor:
    """F = sum_q hvec[q] M8[q] without materializing the float stack."""
    ns = M8.shape[1]
    F = torch.zeros((ns, ns), dtype=dt, device=M8.device)
    for q0, Mc in _chunks(M8):
        F = F + torch.einsum("q,qji->ji", hvec[q0:q0 + Mc.shape[0]],
                             Mc.to(dt))
    return F


def _t_chunk(V: torch.Tensor, Mc: torch.Tensor, spin: str, out=None):
    """D_a v for one int8 chunk of operators, (c, nB, nA).  spin 'A':
    T[q, b, j] = sum_i M[q, j, i] V[b, i]; 'B': T[q, j, a] =
    sum_i M[q, j, i] V[i, a]."""
    Mf = Mc.to(V.dtype)
    if spin == "A":
        return torch.matmul(V, Mf.mT, out=out)
    return torch.matmul(Mf, V, out=out)


def _t_half(V: torch.Tensor, M8: torch.Tensor, spin: str) -> torch.Tensor:
    """One (q_pad, nd) T half T_a = D_a v, written chunk by chunk into a
    preallocated buffer."""
    nB, nA = V.shape
    T = torch.empty((M8.shape[0], nB, nA), dtype=V.dtype, device=V.device)
    for q0, Mc in _chunks(M8):
        _t_chunk(V, Mc, spin, out=T[q0:q0 + Mc.shape[0]])
    return T.reshape(M8.shape[0], nB * nA)


def _back_contract(Tf: torch.Tensor, G2blk: torch.Tensor, M8: torch.Tensor,
                   spin: str, nB: int, nA: int) -> torch.Tensor:
    """sum_a D_a^T-side contraction of U = G2blk @ Tf, formed one operator
    chunk of rows at a time and contracted back at once (U is never
    whole).  spin 'A': out[b, j] = sum_{q,i} M[q, j, i] U[q, b, i];
    'B': out[j, a] = sum_{q,i} M[q, j, i] U[q, i, a]."""
    acc = torch.zeros((nB, nA), dtype=Tf.dtype, device=Tf.device)
    for q0, Mc in _chunks(M8):
        Mf = Mc.to(Tf.dtype)
        Uc = (G2blk[q0:q0 + Mc.shape[0]] @ Tf).reshape(-1, nB, nA)
        for Mq, Uq in zip(Mf, Uc):
            if spin == "A":
                acc.addmm_(Uq, Mq.T)
            else:
                acc.addmm_(Mq, Uq)
    return acc


def _sigma_compact(V: torch.Tensor, ops: dict, tabs: dict) -> torch.Tensor:
    """H . v with int8 stacks: the math of `sigma`, streamed over operator
    chunks.  G2 is split into its four spin blocks; the alpha half TAf is
    consumed (AA and BA blocks) and deleted before the beta half is
    built, so one (q_pad, nd) half is live at a time."""
    MA8, MB8 = tabs["MA8"], tabs["MB8"]
    nB, nA = V.shape
    q = MA8.shape[0]
    G2 = ops["G2"]
    s = V @ ops["FA"].T + ops["FB"] @ V
    TAf = _t_half(V, MA8, "A")
    s = s + _back_contract(TAf, G2[:q, :q], MA8, "A", nB, nA)
    s = s + _back_contract(TAf, G2[q:, :q], MB8, "B", nB, nA)
    del TAf
    TBf = _t_half(V, MB8, "B")
    s = s + _back_contract(TBf, G2[:q, q:], MA8, "A", nB, nA)
    return s + _back_contract(TBf, G2[q:, q:], MB8, "B", nB, nA)


def _assemble_rdms(gp_a, gp_b, G2f, maps, dt):
    """(gamma, Gamma) from the pair sums T v (alpha, beta halves) and the
    flat pair-correlation matrix, through the build_rdm_maps triple."""
    IDX, SGN, CASE_A = maps
    N = CASE_A.shape[0]
    nsp = N // 2
    gamma = torch.zeros((N, N), dtype=dt, device=G2f.device)
    gamma[:nsp, :nsp] = gp_a[: nsp * nsp].reshape(nsp, nsp)
    gamma[nsp:, nsp:] = gp_b[: nsp * nsp].reshape(nsp, nsp)
    Gamma = (SGN.to(dt) * G2f[IDX.long()]).reshape(N, N, N, N)
    eye = torch.eye(N, dtype=dt, device=G2f.device)
    Gamma = Gamma - CASE_A.to(dt) * torch.einsum("qr,ps->pqrs", eye, gamma)
    return gamma, Gamma


def _rdms_compact(V: torch.Tensor, tabs: dict, maps):
    """`rdms` with int8 stacks: the (2 q_pad)^2 pair-correlation matrix by
    spin blocks with one T half live at a time (the cross block
    TAf TBf^T streams beta chunks recomputed on the fly; BA = AB^T)."""
    MA8, MB8 = tabs["MA8"], tabs["MB8"]
    v = V.reshape(-1)
    TAf = _t_half(V, MA8, "A")
    gp_a = TAf @ v
    AA = TAf @ TAf.T
    AB = torch.cat([TAf @ _t_chunk(V, Mc, "B").flatten(1).T
                    for _, Mc in _chunks(MB8)], dim=1)
    del TAf
    TBf = _t_half(V, MB8, "B")
    gp_b = TBf @ v
    BB = TBf @ TBf.T
    del TBf
    G2f = torch.cat([torch.cat([AA, AB], dim=1),
                     torch.cat([AB.T, BB], dim=1)], dim=0).reshape(-1)
    return _assemble_rdms(gp_a, gp_b, G2f, maps, V.dtype)


def _diag_same_spin(G2blk: torch.Tensor, M8: torch.Tensor, dt):
    """d2[i] = sum_ab G2blk[a,b] sum_j M[a,i,j] M[b,j,i], both operator
    axes streamed in chunks: W[a, j, i] = sum_b G2blk[a, b] M[b, j, i] is
    accumulated for one chunk of a, then contracted with M[a, i, j]."""
    ns = M8.shape[1]
    d2 = torch.zeros((ns,), dtype=dt, device=M8.device)
    for a0, Ma in _chunks(M8):
        ca = Ma.shape[0]
        W = torch.zeros((ca, ns * ns), dtype=dt, device=M8.device)
        for b0, Mb in _chunks(M8):
            W.addmm_(G2blk[a0:a0 + ca, b0:b0 + Mb.shape[0]],
                     Mb.to(dt).reshape(Mb.shape[0], -1))
        d2 = d2 + (Ma.to(dt).mT * W.reshape(ca, ns, ns)).sum(dim=(0, 1))
    return d2


def _diagonal_compact(ops: dict, tabs: dict) -> torch.Tensor:
    """Exact diag(H) with int8 stacks (the identity of `diagonal`)."""
    dt = ops["FA"].dtype
    MA8, MB8 = tabs["MA8"], tabs["MB8"]
    q = MA8.shape[0]
    G2 = ops["G2"]
    W_cross = G2[:q, q:] + G2[q:, :q].T
    DA = torch.diagonal(MA8, dim1=1, dim2=2).to(dt)
    DB = torch.diagonal(MB8, dim1=1, dim2=2).to(dt)
    dA = torch.diagonal(ops["FA"]) + _diag_same_spin(G2[:q, :q], MA8, dt)
    dB = torch.diagonal(ops["FB"]) + _diag_same_spin(G2[q:, q:], MB8, dt)
    cross = torch.einsum("ab,ai,bj->ji", W_cross, DA, DB)
    return dA[None, :] + dB[:, None] + cross


# -- sigma / quadform -------------------------------------------------------

def build_ops(h_so: torch.Tensor, g_so: torch.Tensor, tabs: dict) -> dict:
    """Sigma-operator dict from spin-orbital integrals in the package
    convention E = sum h gamma + sum g Gamma: the (P, P) pair coupling
    G2 = g~ (gathered from g via the LIN tables) and the one-body string
    matrices F = sum h~ D with h~ = h - sum_q g[p, q, q, s] over same-spin
    q.  Differentiable in (h, g).  With stacks padded on their operator
    axis (compact tables), G2 is embedded at the padded block offsets
    with zero rows and columns for the zero operators."""
    dt = h_so.dtype
    compact = "MA8" in tabs
    P_half = tabs["CROSS"].shape[0] // 2
    nsp = int(round(np.sqrt(P_half)))               # spatial orbitals
    q = tabs["MA8" if compact else "MA"].shape[0]
    gf = g_so.reshape(-1)
    G2 = gf[tabs["LIN_A"]] - tabs["CROSS"].to(dt) * gf[tabs["LIN_B"]]
    if q != P_half:
        G2p = G2.new_zeros((2 * q, 2 * q))
        for r, c in ((0, 0), (0, 1), (1, 0), (1, 1)):
            G2p[r * q:r * q + P_half, c * q:c * q + P_half] = \
                G2[r * P_half:(r + 1) * P_half, c * P_half:(c + 1) * P_half]
        G2 = G2p
    # delta correction over SAME-SPIN q only: cross-spin q = r terms are
    # expanded through the cross-pairing identity and live in G2
    sA = torch.einsum("pqqs->ps", g_so[:, :nsp, :nsp, :])
    sB = torch.einsum("pqqs->ps", g_so[:, nsp:, nsp:, :])
    hA = torch.nn.functional.pad((h_so - sA)[:nsp, :nsp].reshape(-1),
                                 (0, q - P_half))
    hB = torch.nn.functional.pad((h_so - sB)[nsp:, nsp:].reshape(-1),
                                 (0, q - P_half))
    if compact:
        FA = _fold_one_body(hA, tabs["MA8"], dt)
        FB = _fold_one_body(hB, tabs["MB8"], dt)
    else:
        FA = torch.einsum("q,qji->ji", hA, tabs["MA"].to(dt))
        FB = torch.einsum("q,qji->ji", hB, tabs["MB"].to(dt))
    return {"G2": G2, "FA": FA, "FB": FB}


def _t_tensor(V: torch.Tensor, MA: torch.Tensor, MB: torch.Tensor):
    """T = [D_a v]_a over the 2 n^2 same-spin operators, (2 P_A, nB*nA);
    leading batch axes of V carry through, (..., 2 P_A, nB*nA)."""
    TA = torch.einsum("qji,...bi->...qbj", MA, V)
    TB = torch.einsum("qji,...ia->...qja", MB, V)
    return torch.cat([TA, TB], dim=-3).flatten(-2)


def sigma(V: torch.Tensor, ops: dict, tabs: dict) -> torch.Tensor:
    """H . v on the string matrix:
    sigma = V FA^T + FB V + sum_a D_a (sum_b g~[a,b] D_b v).
    V (nB, nA), or (k, nB, nA) for k states at once (dense tables)."""
    if "MA8" in tabs:
        return _sigma_compact(V, ops, tabs)
    dt = V.dtype
    nB, nA = V.shape[-2:]
    MA = tabs["MA"].to(dt)
    MB = tabs["MB"].to(dt)
    P_A = MA.shape[0]
    s1 = V @ ops["FA"].T + ops["FB"] @ V
    T = _t_tensor(V, MA, MB)
    U = (ops["G2"] @ T).unflatten(-1, (nB, nA))
    s2A = torch.einsum("qji,...qbi->...bj", MA, U[..., :P_A, :, :])
    s2B = torch.einsum("qji,...qia->...ja", MB, U[..., P_A:, :, :])
    return s1 + s2A + s2B


def quadform(V: torch.Tensor, ops: dict, tabs: dict) -> torch.Tensor:
    """<v|H|v> = vec(V) . vec(sigma(V)) (gradients from autograd); one
    value per state for a (k, nB, nA) stack."""
    return torch.sum(V * sigma(V, ops, tabs), dim=(-2, -1))


# -- RDMs -------------------------------------------------------------------

def build_rdm_maps(n: int, q_pad: int = None):
    """Host-side maps turning the pair-correlation matrix
    G2f[a, b] = (D_a v) . (D_b v) into the spin-orbital 2-RDM
    Gamma[p, q, r, s] = <a+_p a+_q a_s a_r>:

      sigma(p)=sigma(r), sigma(q)=sigma(s):
          Gamma = G2f[(r,p), (q,s)] - delta_qr gamma[p, s]
      sigma(p)=sigma(s) != sigma(q)=sigma(r):
          Gamma = -G2f[(r,q), (p,s)]
      otherwise 0.

    `q_pad` is the per-spin operator-axis length of the stacks (default
    n^2; compact stacks are padded), where the beta block of T starts.
    Returns (IDX, SGN, CASE_A): IDX (N^4,) int32 into G2f.reshape(-1),
    SGN (N^4,) in {0, +-1}, CASE_A the (N, N, N, N) 0/1 delta mask."""
    N = 2 * n
    sp = (np.arange(N) >= n).astype(np.int64)
    if q_pad is None:
        q_pad = n * n
    P = 2 * q_pad

    def pair(x, y):
        # same-spin pair index in the MA/MB ordering (alpha block first)
        return sp[x] * q_pad + (x % n) * n + (y % n)

    p = np.arange(N)[:, None, None, None]
    q = np.arange(N)[None, :, None, None]
    r = np.arange(N)[None, None, :, None]
    s = np.arange(N)[None, None, None, :]
    case_a = (sp[p] == sp[r]) & (sp[q] == sp[s])
    case_b = (sp[p] == sp[s]) & (sp[q] == sp[r]) & (sp[p] != sp[q])
    idx_a = pair(r, p) * P + pair(q, s)
    idx_b = pair(r, q) * P + pair(p, s)
    IDX = np.where(case_a, idx_a, np.where(case_b, idx_b, 0))
    SGN = np.where(case_a, 1.0, np.where(case_b, -1.0, 0.0))
    return (IDX.reshape(-1).astype(np.int32),
            SGN.reshape(-1),
            case_a.astype(np.float64))


def rdms(V: torch.Tensor, tabs: dict, maps):
    """Spin-orbital (gamma, Gamma) from the string matrix: products plus
    one constant-index gather of the (P, P) pair-correlation matrix.
    `maps` is a build_rdm_maps triple (as tensors or arrays) for the
    tables' operator-axis length q_pad."""
    maps = tuple(torch.as_tensor(a, device=V.device) for a in maps)
    if "MA8" in tabs:
        return _rdms_compact(V, tabs, maps)
    dt = V.dtype
    MA = tabs["MA"].to(dt)
    q = MA.shape[0]
    T = _t_tensor(V, MA, tabs["MB"].to(dt))
    gpairs = T @ V.reshape(-1)                       # (2 q,)
    G2f = (T @ T.T).reshape(-1)                      # (P*P,)
    return _assemble_rdms(gpairs[:q], gpairs[q:], G2f, maps, dt)


def transition_rdm1(U: torch.Tensor, V: torch.Tensor,
                    tabs: dict) -> torch.Tensor:
    """Spin-orbital transition 1-RDM gamma[p, s] = <u| a+_p a_s |v>
    between two states on the same string grid (only the same-spin
    blocks are nonzero).  U may carry a leading batch axis
    (k, nB, nA) -> (k, N, N): one T build against the whole bra stack.
    transition_rdm1(v, v, tabs) equals rdms(v)[0]."""
    dt = V.dtype
    batched = U.dim() == 3
    Ub = U if batched else U[None]
    P_half = tabs["CROSS"].shape[0] // 2
    nsp = int(round(np.sqrt(P_half)))
    N = 2 * nsp
    k = Ub.shape[0]
    if "MA8" in tabs:
        # one (c, nd) chunk of T live at a time
        Uf = Ub.reshape(k, -1)

        def pairs(M8, spin):
            return torch.cat([Uf @ _t_chunk(V, Mc, spin).flatten(1).T
                              for _, Mc in _chunks(M8)], dim=1)

        ga, gb = pairs(tabs["MA8"], "A"), pairs(tabs["MB8"], "B")
    else:
        MA = tabs["MA"].to(dt)
        MB = tabs["MB"].to(dt)
        ga = torch.einsum("qbj,kbj->kq",
                          torch.einsum("qji,bi->qbj", MA, V), Ub)
        gb = torch.einsum("qja,kja->kq",
                          torch.einsum("qji,ia->qja", MB, V), Ub)
    gamma = torch.zeros((k, N, N), dtype=dt, device=V.device)
    gamma[:, :nsp, :nsp] = ga[:, : nsp * nsp].reshape(k, nsp, nsp)
    gamma[:, nsp:, nsp:] = gb[:, : nsp * nsp].reshape(k, nsp, nsp)
    return gamma if batched else gamma[0]


def diagonal(ops: dict, tabs: dict) -> torch.Tensor:
    """Exact diagonal of the sector Hamiltonian over the (nB, nA) string
    grid, the Davidson preconditioner (solvers/davidson.py):

    diag(ib, ia) = FA[ia,ia] + FB[ib,ib]
                 + sum_{a,b alpha} G2[a,b] (MA[a] MA[b])[ia,ia]
                 + sum_{a,b beta}  G2[a,b] (MB[a] MB[b])[ib,ib]
                 + sum_{a alpha, b beta} (G2[a,b] + G2[b,a])
                       diag(MA[a])[ia] diag(MB[b])[ib]

    (same-spin products need the full intermediate sum over j of
    M[a,i,j] M[b,j,i]; cross-spin products factor over the grid)."""
    if "MA8" in tabs:
        return _diagonal_compact(ops, tabs)
    dt = ops["FA"].dtype
    MA = tabs["MA"].to(dt)
    MB = tabs["MB"].to(dt)
    qp = MA.shape[0]
    G2 = ops["G2"]
    AA = G2[:qp, :qp]
    BB = G2[qp:, qp:]
    W_cross = G2[:qp, qp:] + G2[qp:, :qp].T          # (qp, qp)
    dA1 = torch.diagonal(ops["FA"])                  # (nA,)
    dB1 = torch.diagonal(ops["FB"])                  # (nB,)
    DA = torch.diagonal(MA, dim1=1, dim2=2)          # (qp, nA)
    DB = torch.diagonal(MB, dim1=1, dim2=2)          # (qp, nB)
    # same-spin: d2[i] = sum_ab G2[a,b] sum_j M[a,i,j] M[b,j,i]
    WA = torch.einsum("ab,bji->aij", AA, MA)
    dA2 = torch.einsum("aij,aij->i", MA, WA)
    WB = torch.einsum("ab,bji->aij", BB, MB)
    dB2 = torch.einsum("aij,aij->i", MB, WB)
    cross = torch.einsum("ab,ai,bj->ji", W_cross, DA, DB)   # (nB, nA)
    return (dA1 + dA2)[None, :] + (dB1 + dB2)[:, None] + cross
