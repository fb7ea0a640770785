"""McMurchie-Davidson Gaussian integral engine (host-side, numpy float64).

Copy of esoo_tpu/chem/integrals.py: overlap (S), kinetic (T), nuclear
attraction (V), Cartesian multipoles (dipole, second moments) and
two-electron repulsion integrals (ERI, chemist notation (pq|rs)) over
contracted cartesian Gaussians of arbitrary angular momentum, with
spherical (pure) transformation for l >= 2 shells.  Integrals are computed once per
molecule on the host; the OptOrb loop works with the transformed MO
tensors.  The ERI runs in the native C++ engine (esoo_torch/native) when
g++ can build it, and in the pure-Python code below otherwise.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
from scipy.special import hyp1f1

from .basis import (
    Shell,
    cart_to_pure_matrix,
    cartesian_components,
)


def boys(n_max: int, T: float) -> np.ndarray:
    """Boys function F_n(T) for n = 0..n_max."""
    out = np.empty(n_max + 1)
    if T < 1e-13:
        for n in range(n_max + 1):
            out[n] = 1.0 / (2 * n + 1)
        return out
    # downward recursion from the hypergeometric representation at n_max
    out[n_max] = hyp1f1(n_max + 0.5, n_max + 1.5, -T) / (2 * n_max + 1)
    expT = math.exp(-T)
    for n in range(n_max - 1, -1, -1):
        out[n] = (2 * T * out[n + 1] + expT) / (2 * n + 1)
    return out


def hermite_coefs(la: int, lb: int, AB: float, a: float, b: float) -> np.ndarray:
    """Hermite expansion coefficients E[i, j, t] for one cartesian direction.

    Recurrences from McMurchie & Davidson (J. Comput. Phys. 26, 218 (1978)).
    """
    p = a + b
    q = a * b / p
    E = np.zeros((la + 1, lb + 1, la + lb + 1))
    E[0, 0, 0] = math.exp(-q * AB * AB)
    for i in range(la + 1):
        for j in range(lb + 1):
            if i == 0 and j == 0:
                continue
            for t in range(i + j + 1):
                if j == 0:
                    # build up i
                    v = 0.0
                    if t - 1 >= 0:
                        v += E[i - 1, j, t - 1] / (2 * p)
                    v -= (q * AB / a) * E[i - 1, j, t]
                    if t + 1 <= i + j - 1:
                        v += (t + 1) * E[i - 1, j, t + 1]
                else:
                    v = 0.0
                    if t - 1 >= 0:
                        v += E[i, j - 1, t - 1] / (2 * p)
                    v += (q * AB / b) * E[i, j - 1, t]
                    if t + 1 <= i + j - 1:
                        v += (t + 1) * E[i, j - 1, t + 1]
                E[i, j, t] = v
    return E


def hermite_coulomb(tmax: int, umax: int, vmax: int, p: float,
                    PC: np.ndarray) -> np.ndarray:
    """Hermite Coulomb integrals R^0_{t,u,v} up to the given orders."""
    nmax = tmax + umax + vmax
    F = boys(nmax, p * float(PC @ PC))
    # R[n, t, u, v], built by downward recursion in n
    R = np.zeros((nmax + 1, tmax + 1, umax + 1, vmax + 1))
    for n in range(nmax + 1):
        R[n, 0, 0, 0] = (-2.0 * p) ** n * F[n]
    for total in range(1, tmax + umax + vmax + 1):
        for t in range(min(total, tmax) + 1):
            for u in range(min(total - t, umax) + 1):
                v = total - t - u
                if v < 0 or v > vmax:
                    continue
                for n in range(nmax - total + 1):
                    if t > 0:
                        val = PC[0] * R[n + 1, t - 1, u, v]
                        if t > 1:
                            val += (t - 1) * R[n + 1, t - 2, u, v]
                    elif u > 0:
                        val = PC[1] * R[n + 1, t, u - 1, v]
                        if u > 1:
                            val += (u - 1) * R[n + 1, t, u - 2, v]
                    else:
                        val = PC[2] * R[n + 1, t, u, v - 1]
                        if v > 1:
                            val += (v - 1) * R[n + 1, t, u, v - 2]
                    R[n, t, u, v] = val
    return R[0]


def _pair_E3(sha: Shell, shb: Shell, ia: int, ib: int) -> np.ndarray:
    """E3[ca, cb, t, u, v] Hermite expansion tensor for one primitive pair."""
    a, b = sha.exps[ia], shb.exps[ib]
    A, B = sha.center, shb.center
    la, lb = sha.l, shb.l
    Ex = hermite_coefs(la, lb, A[0] - B[0], a, b)
    Ey = hermite_coefs(la, lb, A[1] - B[1], a, b)
    Ez = hermite_coefs(la, lb, A[2] - B[2], a, b)
    ca = cartesian_components(la)
    cb = cartesian_components(lb)
    nt = la + lb + 1
    E3 = np.zeros((len(ca), len(cb), nt, nt, nt))
    for i, (ix, iy, iz) in enumerate(ca):
        for j, (jx, jy, jz) in enumerate(cb):
            E3[i, j] = _outer3(Ex[ix, jx], Ey[iy, jy], Ez[iz, jz], nt)
    return E3


def _outer3(ex, ey, ez, nt):
    out = np.zeros((nt, nt, nt))
    out[: len(ex), : len(ey), : len(ez)] = (
        ex[:, None, None] * ey[None, :, None] * ez[None, None, :]
    )
    return out


def _cart_norm_factors(shell: Shell) -> np.ndarray:
    """Per-cartesian-component normalization relative to the (l,0,0) component.

    Shell.cnorm folds in the (l,0,0) primitive norms; other components need
    the ratio N(lx,ly,lz)/N(l,0,0), which is exponent-independent.
    """
    comps = cartesian_components(shell.l)
    ref = comps[0]
    # ratio of double factorials only (the alpha-dependent parts cancel)
    def df(c):
        from .basis import double_factorial
        return math.sqrt(
            double_factorial(2 * c[0] - 1)
            * double_factorial(2 * c[1] - 1)
            * double_factorial(2 * c[2] - 1)
        )
    ref_df = df(ref)
    return np.array([ref_df / df(c) for c in comps])


def _shell_pair_blocks(sha: Shell, shb: Shell):
    """Iterate primitive pairs yielding (p, P, cc, E3) with contraction weights."""
    fa = _cart_norm_factors(sha)
    fb = _cart_norm_factors(shb)
    for ia, ca in enumerate(sha.cnorm):
        for ib, cb in enumerate(shb.cnorm):
            a, b = sha.exps[ia], shb.exps[ib]
            p = a + b
            P = (a * sha.center + b * shb.center) / p
            E3 = _pair_E3(sha, shb, ia, ib)
            E3 = E3 * fa[:, None, None, None, None] * fb[None, :, None, None, None]
            yield p, P, ca * cb, E3


def overlap_kinetic_block(sha: Shell, shb: Shell):
    """Contracted overlap and kinetic blocks (cartesian components)."""
    la, lb = sha.l, shb.l
    ca = cartesian_components(la)
    cb = cartesian_components(lb)
    fa = _cart_norm_factors(sha)
    fb = _cart_norm_factors(shb)
    S = np.zeros((len(ca), len(cb)))
    T = np.zeros((len(ca), len(cb)))
    A, B = sha.center, shb.center
    for ia, wa in enumerate(sha.cnorm):
        for ib, wb in enumerate(shb.cnorm):
            a, b = sha.exps[ia], shb.exps[ib]
            p = a + b
            pref = (math.pi / p) ** 1.5
            # per-dimension E tables up to lb+2 for the kinetic terms
            Ex = hermite_coefs(la, lb + 2, A[0] - B[0], a, b)
            Ey = hermite_coefs(la, lb + 2, A[1] - B[1], a, b)
            Ez = hermite_coefs(la, lb + 2, A[2] - B[2], a, b)
            Es = (Ex, Ey, Ez)
            for i, ci in enumerate(ca):
                for j, cj in enumerate(cb):
                    s1d = [Es[d][ci[d], cj[d], 0] for d in range(3)]
                    S[i, j] += wa * wb * fa[i] * fb[j] * pref * s1d[0] * s1d[1] * s1d[2]
                    # kinetic 1D: T_ij = b(2j+1)S_ij - 2b^2 S_{i,j+2} - j(j-1)/2 S_{i,j-2}
                    t1d = []
                    for d in range(3):
                        jj = cj[d]
                        t = b * (2 * jj + 1) * Es[d][ci[d], jj, 0]
                        t -= 2 * b * b * Es[d][ci[d], jj + 2, 0]
                        if jj >= 2:
                            t -= 0.5 * jj * (jj - 1) * Es[d][ci[d], jj - 2, 0]
                        t1d.append(t)
                    T[i, j] += (
                        wa * wb * fa[i] * fb[j] * pref
                        * (t1d[0] * s1d[1] * s1d[2]
                           + s1d[0] * t1d[1] * s1d[2]
                           + s1d[0] * s1d[1] * t1d[2])
                    )
    return S, T



def nuclear_block(sha: Shell, shb: Shell, charges, centers):
    """Contracted nuclear-attraction block (cartesian components)."""
    la, lb = sha.l, shb.l
    nca = sha.ncart
    ncb = shb.ncart
    V = np.zeros((nca, ncb))
    L = la + lb
    for p, P, cc, E3 in _shell_pair_blocks(sha, shb):
        for Z, C in zip(charges, centers):
            R = hermite_coulomb(L, L, L, p, P - C)
            V += -Z * cc * (2.0 * math.pi / p) * np.einsum(
                "abtuv,tuv->ab", E3, R[: L + 1, : L + 1, : L + 1], optimize=True
            )
    return V


def _moment_1d(p: float, XPC: float, e: int, tmax: int) -> np.ndarray:
    """1-D Hermite multipole integrals M^e_t = ∫ x_C^e Λ_t(x; p, P) dx
    for t = 0..tmax, with X_PC = P_x - C_x (Helgaker/Jørgensen/Olsen
    eq. 9.5.31-9.5.36):

        M^0_t    = δ_t0 √(π/p)
        M^{e+1}_t = t·M^e_{t-1} + X_PC·M^e_t + M^e_{t+1}/(2p)
    """
    T = tmax + e + 1          # each order consumes one Hermite index
    M = np.zeros((e + 1, T))
    M[0, 0] = math.sqrt(math.pi / p)
    for o in range(e):
        for t in range(T - 1):
            v = XPC * M[o, t] + M[o, t + 1] / (2.0 * p)
            if t >= 1:
                v += t * M[o, t - 1]
            M[o + 1, t] = v
    return M[e, : tmax + 1]


def moment_block(sha: Shell, shb: Shell, comps, origin) -> np.ndarray:
    """Contracted Cartesian-moment blocks ⟨a|Π_d (x_d − origin_d)^{e_d}|b⟩
    for each exponent triple in `comps` (cartesian shell components).

    comps = [(1,0,0), (0,1,0), (0,0,1)] gives the three dipole blocks;
    higher orders (quadrupole etc.) follow from the same 1-D recursion.
    They come from the same Hermite expansion as the overlap
    (McMurchie-Davidson)."""
    la, lb = sha.l, shb.l
    ca = cartesian_components(la)
    cb = cartesian_components(lb)
    fa = _cart_norm_factors(sha)
    fb = _cart_norm_factors(shb)
    origin = np.asarray(origin, dtype=np.float64)
    out = np.zeros((len(comps), len(ca), len(cb)))
    A, B = sha.center, shb.center
    emax = [max(c[d] for c in comps) for d in range(3)]
    for ia, wa in enumerate(sha.cnorm):
        for ib, wb in enumerate(shb.cnorm):
            a, b = sha.exps[ia], shb.exps[ib]
            p = a + b
            P = (a * A + b * B) / p
            Es = [hermite_coefs(la, lb, A[d] - B[d], a, b)
                  for d in range(3)]
            # per-dimension M^e_t vectors, shared across comps
            Ms = [[_moment_1d(p, P[d] - origin[d], e, la + lb)
                   for e in range(emax[d] + 1)] for d in range(3)]
            for icmp, ce in enumerate(comps):
                for i, ci in enumerate(ca):
                    for j, cj in enumerate(cb):
                        m3 = wa * wb * fa[i] * fb[j]
                        for d in range(3):
                            Ed = Es[d][ci[d], cj[d]]
                            m3 *= float(Ed @ Ms[d][ce[d]])
                        out[icmp, i, j] += m3
    return out


def nuclear_block(sha: Shell, shb: Shell, charges, centers):
    """Contracted nuclear-attraction block (cartesian components)."""
    la, lb = sha.l, shb.l
    nca = sha.ncart
    ncb = shb.ncart
    V = np.zeros((nca, ncb))
    L = la + lb
    for p, P, cc, E3 in _shell_pair_blocks(sha, shb):
        for Z, C in zip(charges, centers):
            R = hermite_coulomb(L, L, L, p, P - C)
            V += -Z * cc * (2.0 * math.pi / p) * np.einsum(
                "abtuv,tuv->ab", E3, R[: L + 1, : L + 1, : L + 1], optimize=True
            )
    return V


def eri_block(sha: Shell, shb: Shell, shc: Shell, shd: Shell) -> np.ndarray:
    """Contracted ERI block (ab|cd) in chemist notation, cartesian components."""
    Lab = sha.l + shb.l
    Lcd = shc.l + shd.l
    nca, ncb = sha.ncart, shb.ncart
    ncc, ncd = shc.ncart, shd.ncart
    out = np.zeros((nca, ncb, ncc, ncd))

    # parity factor (-1)^{tau+nu+phi} for the ket Hermite indices
    par = np.ones((Lcd + 1, Lcd + 1, Lcd + 1))
    for t in range(Lcd + 1):
        for u in range(Lcd + 1):
            for v in range(Lcd + 1):
                if (t + u + v) % 2:
                    par[t, u, v] = -1.0

    bra = list(_shell_pair_blocks(sha, shb))
    ket = list(_shell_pair_blocks(shc, shd))
    for p, P, ccab, E3ab in bra:
        for q, Q, cccd, E3cd in ket:
            alpha = p * q / (p + q)
            pref = 2.0 * math.pi ** 2.5 / (p * q * math.sqrt(p + q))
            R = hermite_coulomb(Lab + Lcd, Lab + Lcd, Lab + Lcd, alpha, P - Q)
            # combined R2[t,u,v, tau,nu,phi] = R[t+tau, u+nu, v+phi]
            R2 = np.empty((Lab + 1, Lab + 1, Lab + 1, Lcd + 1, Lcd + 1, Lcd + 1))
            for t in range(Lab + 1):
                for u in range(Lab + 1):
                    for v in range(Lab + 1):
                        R2[t, u, v] = R[t: t + Lcd + 1, u: u + Lcd + 1, v: v + Lcd + 1]
            Ecd_signed = E3cd * par[None, None]
            out += (ccab * cccd * pref) * np.einsum(
                "abtuv,tuvxyz,cdxyz->abcd", E3ab, R2, Ecd_signed, optimize=True
            )
    return out


class IntegralEngine:
    """Computes S, T, V, ERI matrices over a list of shells.

    Shells with l >= 2 and pure=True are transformed to spherical components.
    """

    def __init__(self, shells: List[Shell], charges, centers):
        self.shells = shells
        self.charges = np.asarray(charges, dtype=np.float64)
        self.centers = np.asarray(centers, dtype=np.float64)
        self._offsets = []
        n = 0
        for sh in shells:
            self._offsets.append(n)
            n += sh.nfunc
        self.nbf = n
        self._pure_mats = {}

    def _pure_matrix(self, sh: Shell):
        """Spherical transformation for one shell (None if cartesian kept)."""
        if not (sh.pure and sh.l >= 2):
            return None
        key = id(sh)
        if key not in self._pure_mats:
            # cartesian self-overlap of this shell (contracted, normalized comps)
            Scc, _ = overlap_kinetic_block(sh, sh)
            # Our cartesian basis functions factor as chi_c = f_c * monomial_c
            # * radial(r) with a component-independent radial part (because
            # N_i(c) = N_i(l00) * f_c), so a solid-harmonic polynomial
            # sum_c p_c monomial_c maps to sum_c (p_c / f_c) chi_c.
            f = _cart_norm_factors(sh)
            self._pure_mats[key] = cart_to_pure_matrix(sh.l, Scc, f)
        return self._pure_mats[key]

    def _transform(self, sh: Shell, block: np.ndarray, axis: int) -> np.ndarray:
        M = self._pure_matrix(sh)
        if M is None:
            return block
        return np.tensordot(M, block, axes=([1], [axis])).transpose(
            _restore_axis(axis, block.ndim)
        )

    def one_electron(self):
        """Returns (S, T, V) matrices (nbf x nbf)."""
        n = self.nbf
        S = np.zeros((n, n))
        T = np.zeros((n, n))
        V = np.zeros((n, n))
        ns = len(self.shells)
        for i in range(ns):
            for j in range(i + 1):
                shi, shj = self.shells[i], self.shells[j]
                s, t = overlap_kinetic_block(shi, shj)
                v = nuclear_block(shi, shj, self.charges, self.centers)
                for arr, blk in ((S, s), (T, t), (V, v)):
                    b = self._transform(shi, blk, 0)
                    b = self._transform(shj, b, 1)
                    oi, oj = self._offsets[i], self._offsets[j]
                    arr[oi: oi + shi.nfunc, oj: oj + shj.nfunc] = b
                    if i != j:
                        arr[oj: oj + shj.nfunc, oi: oi + shi.nfunc] = b.T
        return S, T, V

    def moments(self, comps, origin=(0.0, 0.0, 0.0)) -> np.ndarray:
        """Multipole matrices ⟨μ|Π_d (x_d − origin_d)^{e_d}|ν⟩, one
        (nbf, nbf) matrix per exponent triple in `comps`."""
        n = self.nbf
        out = np.zeros((len(comps), n, n))
        ns = len(self.shells)
        for i in range(ns):
            for j in range(i + 1):
                shi, shj = self.shells[i], self.shells[j]
                blk = moment_block(shi, shj, comps, origin)
                for c in range(len(comps)):
                    b = self._transform(shi, blk[c], 0)
                    b = self._transform(shj, b, 1)
                    oi, oj = self._offsets[i], self._offsets[j]
                    out[c, oi: oi + shi.nfunc, oj: oj + shj.nfunc] = b
                    if i != j:
                        out[c, oj: oj + shj.nfunc, oi: oi + shi.nfunc] = b.T
        return out

    def dipole(self, origin=(0.0, 0.0, 0.0)) -> np.ndarray:
        """AO dipole-operator matrices ⟨μ|r_d − origin_d|ν⟩, shape
        (3, nbf, nbf).  (Electric dipole = −e·r; the sign convention is
        applied at the property level, chem/properties.py.)"""
        return self.moments([(1, 0, 0), (0, 1, 0), (0, 0, 1)], origin)

    # second-moment component order (upper triangle, row-major)
    QUAD_COMPS = ((2, 0, 0), (1, 1, 0), (1, 0, 1),
                  (0, 2, 0), (0, 1, 1), (0, 0, 2))

    def quadrupole(self, origin=(0.0, 0.0, 0.0)) -> np.ndarray:
        """AO second-moment matrices ⟨μ|(r_a−o_a)(r_b−o_b)|ν⟩ for the
        six unique (a, b) pairs in QUAD_COMPS order (xx, xy, xz, yy,
        yz, zz), shape (6, nbf, nbf)."""
        return self.moments(list(self.QUAD_COMPS), origin)

    def _global_pure_matrix(self) -> Optional[np.ndarray]:
        """Block-diagonal (nbf_sph, nbf_cart) cartesian->final transform,
        or None if every shell is already in its final representation."""
        blocks = []
        any_pure = False
        for sh in self.shells:
            M = self._pure_matrix(sh)
            if M is None:
                blocks.append(np.eye(sh.ncart))
            else:
                blocks.append(M)
                any_pure = True
        if not any_pure:
            return None
        nc = sum(sh.ncart for sh in self.shells)
        out = np.zeros((self.nbf, nc))
        r = c = 0
        for blk in blocks:
            out[r: r + blk.shape[0], c: c + blk.shape[1]] = blk
            r += blk.shape[0]
            c += blk.shape[1]
        return out

    def eri(self, use_native: bool = True) -> np.ndarray:
        """Full ERI tensor (pq|rs), chemist notation, using 8-fold symmetry.

        Dispatches to the native C++ engine (esoo_torch/native/mcmurchie.cpp)
        when available; the pure-Python path below is the oracle/fallback.
        `self.eri_engine` records which one ran ("native" or "python").
        """
        if use_native:
            from ..native import get_native_eri
            native = get_native_eri()
            if native is not None:
                self.eri_engine = "native"
                G = native(self.shells)
                M = self._global_pure_matrix()
                if M is not None:
                    G = np.tensordot(M, G, axes=[[1], [0]])
                    G = np.tensordot(M, G, axes=[[1], [1]]).transpose(1, 0, 2, 3)
                    G = np.tensordot(M, G, axes=[[1], [2]]).transpose(1, 2, 0, 3)
                    G = np.tensordot(M, G, axes=[[1], [3]]).transpose(1, 2, 3, 0)
                return np.ascontiguousarray(G)
        self.eri_engine = "python"
        n = self.nbf
        G = np.zeros((n, n, n, n))
        ns = len(self.shells)
        pairs = [(i, j) for i in range(ns) for j in range(i + 1)]
        for ij, (i, j) in enumerate(pairs):
            for kl in range(ij + 1):
                k, l = pairs[kl]
                shi, shj, shk, shl = (self.shells[x] for x in (i, j, k, l))
                blk = eri_block(shi, shj, shk, shl)
                blk = self._transform(shi, blk, 0)
                blk = self._transform(shj, blk, 1)
                blk = self._transform(shk, blk, 2)
                blk = self._transform(shl, blk, 3)
                oi, oj, ok, ol = (self._offsets[x] for x in (i, j, k, l))
                ni, nj, nk, nl = (self.shells[x].nfunc for x in (i, j, k, l))
                for (a, b, c, d, t) in _eri_perms():
                    off = (oi, oj, ok, ol)
                    dim = (ni, nj, nk, nl)
                    sl = tuple(
                        slice(off[x], off[x] + dim[x]) for x in (a, b, c, d)
                    )
                    G[sl] = blk.transpose(t)
        return G


def _restore_axis(axis, ndim):
    """Permutation restoring tensordot-moved axis back to `axis`."""
    order = list(range(1, ndim))
    order.insert(axis, 0)
    return order


def _eri_perms():
    """(index permutation, transpose) pairs for 8-fold ERI symmetry."""
    return [
        (0, 1, 2, 3, (0, 1, 2, 3)),
        (1, 0, 2, 3, (1, 0, 2, 3)),
        (0, 1, 3, 2, (0, 1, 3, 2)),
        (1, 0, 3, 2, (1, 0, 3, 2)),
        (2, 3, 0, 1, (2, 3, 0, 1)),
        (3, 2, 0, 1, (3, 2, 0, 1)),
        (2, 3, 1, 0, (2, 3, 1, 0)),
        (3, 2, 1, 0, (3, 2, 1, 0)),
    ]
