"""Real-space evaluation + Gaussian cube-file export.

Copy of esoo_tpu/chem/cube.py (host NumPy).

Evaluate the contracted-Gaussian AO basis, molecular orbitals, and RDM
densities on arbitrary point grids, and write standard cube files
(readable by VMD/PyMOL/Avogadro/...).  The visualization capability
every quantum-chemistry package ships; the reference computes no
real-space quantities at all.

The AO values here are EXACTLY the functions the integral engine
integrates: per-cartesian-component norms (`_cart_norm_factors`) and
the solid-harmonic pure transform (`cart_to_pure_matrix`) are reused
from the same machinery, and tests/test_cube.py closes the loop by
quadrature — the numerically integrated ⟨φ_μ|φ_ν⟩ reproduces the
engine's analytic overlap matrix through d shells.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .basis import cart_to_pure_matrix, cartesian_components
from .integrals import _cart_norm_factors, overlap_kinetic_block

_PURE_CACHE = {}


def _shell_pure_matrix(sh):
    """The engine's (2l+1, ncart) pure transform for one shell (None
    when cartesian is kept), cached by shell identity — the ONE place
    this module derives it; the quadrature-closure tests pin it against
    the IntegralEngine's own matrices."""
    if not (sh.pure and sh.l >= 2):
        return None
    key = id(sh)
    if key not in _PURE_CACHE:
        Scc, _ = overlap_kinetic_block(sh, sh)
        _PURE_CACHE[key] = (sh, cart_to_pure_matrix(
            sh.l, Scc, _cart_norm_factors(sh)))
    return _PURE_CACHE[key][1]


def evaluate_aos(shells, points: np.ndarray) -> np.ndarray:
    """AO values φ_μ(r) at `points` (npts, 3) bohr → (npts, nbf),
    columns in the integral engine's AO order (pure components for
    l ≥ 2 shells with pure=True)."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    cols = []
    for sh in shells:
        d = pts - sh.center                       # (npts, 3)
        r2 = np.einsum("pd,pd->p", d, d)
        # component-independent radial contraction
        radial = np.exp(-np.outer(r2, sh.exps)) @ sh.cnorm   # (npts,)
        comps = cartesian_components(sh.l)
        f = _cart_norm_factors(sh)
        cart = np.empty((pts.shape[0], len(comps)))
        for i, (lx, ly, lz) in enumerate(comps):
            cart[:, i] = (f[i] * d[:, 0] ** lx * d[:, 1] ** ly
                          * d[:, 2] ** lz) * radial
        M = _shell_pure_matrix(sh)
        if M is not None:
            cart = cart @ M.T
        cols.append(cart)
    return np.concatenate(cols, axis=1)


def _require_shells(problem):
    ao = getattr(problem, "ao_basis", None)
    if ao is None or getattr(ao, "shells", None) is None:
        raise ValueError(
            "problem carries no basis shells (ao_basis.shells is None); "
            "build it with chem.MoleculeDriver")
    return ao


def density_values(problem, points: np.ndarray,
                   gamma_spatial: Optional[np.ndarray] = None,
                   partial_unitary: Optional[np.ndarray] = None,
                   spin: bool = False) -> np.ndarray:
    """Electron density ρ(r) (or the SPIN density with spin=True and a
    γ_αα − γ_ββ `gamma_spatial`) at `points` (npts, 3) bohr, from the
    same AO density matrix the population analysis uses.  Default γ is
    the mean-field density; OptOrb results pass their 1-RDM + U."""
    from .properties import density_ao

    ao = _require_shells(problem)
    if spin:
        if gamma_spatial is None:
            raise ValueError(
                "spin=True needs an explicit SPIN density gamma_spatial "
                "(gamma_aa - gamma_bb, e.g. a result's "
                "spin_density_spatial) — the default mean-field gamma "
                "is the spin-SUMMED density")
        g = np.asarray(gamma_spatial)
        n_act = (np.asarray(problem.mo_coeff_ao).shape[1]
                 if partial_unitary is None
                 else np.asarray(partial_unitary).shape[1])
        if g.shape[0] != n_act:
            raise ValueError(
                f"spin=True needs the SPATIAL spin density "
                f"({n_act}x{n_act}); got {g.shape} — a spin-orbital RDM "
                f"would be silently spin-SUMMED here")
    P = density_ao(problem, gamma_spatial, partial_unitary,
                   include_core=not spin)
    phi = evaluate_aos(ao.shells, points)
    return np.einsum("pu,uv,pv->p", phi, P, phi, optimize=True)


def orbital_values(problem, points: np.ndarray,
                   coeff_ao: np.ndarray) -> np.ndarray:
    """Molecular-orbital value(s) at `points`: `coeff_ao` is (nbf,) or
    (nbf, k) AO coefficients (e.g. columns of chem.natural_orbitals'
    output) → (npts,) or (npts, k)."""
    ao = _require_shells(problem)
    return evaluate_aos(ao.shells, points) @ np.asarray(coeff_ao,
                                                        dtype=np.float64)


def _default_grid(coords: np.ndarray, spacing: float, margin: float):
    lo = coords.min(axis=0) - margin
    hi = coords.max(axis=0) + margin
    shape = np.maximum(np.ceil((hi - lo) / spacing).astype(int) + 1, 2)
    axes = np.diag([spacing] * 3)
    return lo, axes, shape


def grid_points(origin, axes, shape) -> np.ndarray:
    """The (n1*n2*n3, 3) cube-ordered point list (z fastest) for an
    origin + 3 step vectors + per-axis counts."""
    i, j, k = [np.arange(n) for n in shape]
    I, J, K = np.meshgrid(i, j, k, indexing="ij")
    idx = np.stack([I.ravel(), J.ravel(), K.ravel()], axis=1)
    return np.asarray(origin) + idx @ np.asarray(axes)


def write_cube(path: str, problem, values: np.ndarray, origin, axes,
               shape, comment: str = "esoo_torch") -> None:
    """Write a Gaussian cube file: `values` must be cube-ordered
    (z fastest), length prod(shape)."""
    ao = getattr(problem, "ao_basis", None)
    if ao is None:
        raise ValueError("problem carries no AO metadata (ao_basis)")
    shape = [int(n) for n in shape]
    vals = np.asarray(values, dtype=np.float64).reshape(-1)
    if vals.size != shape[0] * shape[1] * shape[2]:
        raise ValueError(f"values has {vals.size} entries for shape "
                         f"{shape}")
    axes = np.asarray(axes, dtype=np.float64)
    with open(path, "w") as f:
        f.write(f"{comment}\n")
        f.write("electron density (bohr grid)\n")
        natom = len(ao.symbols)
        f.write(f"{natom:5d} {origin[0]:11.6f} {origin[1]:11.6f} "
                f"{origin[2]:11.6f}\n")
        for n, ax in zip(shape, axes):
            f.write(f"{n:5d} {ax[0]:11.6f} {ax[1]:11.6f} "
                    f"{ax[2]:11.6f}\n")
        for z, r in zip(ao.atomic_numbers, ao.coords):
            f.write(f"{int(z):5d} {float(z):11.6f} {r[0]:11.6f} "
                    f"{r[1]:11.6f} {r[2]:11.6f}\n")
        per_row = 6
        nz = shape[2]
        flat = vals.reshape(shape[0] * shape[1], nz)
        for row in flat:
            for s in range(0, nz, per_row):
                f.write(" ".join(f"{v:12.5E}"
                                 for v in row[s: s + per_row]) + "\n")


def read_cube(path: str):
    """Parse a cube file → dict(origin, axes, shape, values (flat,
    z fastest), atomic_numbers, coords).  For tests/round trips."""
    with open(path) as f:
        f.readline()
        f.readline()
        parts = f.readline().split()
        natom = int(parts[0])
        origin = np.array([float(x) for x in parts[1:4]])
        shape, axes = [], []
        for _ in range(3):
            parts = f.readline().split()
            shape.append(int(parts[0]))
            axes.append([float(x) for x in parts[1:4]])
        zs, coords = [], []
        for _ in range(natom):
            parts = f.readline().split()
            zs.append(int(parts[0]))
            coords.append([float(x) for x in parts[2:5]])
        values = np.fromstring(f.read(), sep=" ")
    return {"origin": origin, "axes": np.array(axes),
            "shape": tuple(shape), "values": values,
            "atomic_numbers": np.array(zs), "coords": np.array(coords)}


def cube_density(problem, path: str,
                 gamma_spatial: Optional[np.ndarray] = None,
                 partial_unitary: Optional[np.ndarray] = None,
                 spacing: float = 0.25, margin: float = 4.0,
                 spin: bool = False) -> dict:
    """Batteries-included density cube: builds a rectangular grid
    `margin` bohr beyond the molecule at `spacing` bohr, evaluates the
    (spin-)density of the given MO-basis 1-RDM, writes `path`, and
    returns {n_electrons (the grid integral — a built-in sanity check),
    origin, axes, shape}."""
    ao = _require_shells(problem)
    origin, axes, shape = _default_grid(np.asarray(ao.coords),
                                        spacing, margin)
    pts = grid_points(origin, axes, shape)
    rho = density_values(problem, pts, gamma_spatial, partial_unitary,
                         spin=spin)
    write_cube(path, problem, rho, origin, axes, shape,
               comment=f"esoo_torch {'spin ' if spin else ''}density")
    dv = float(abs(np.linalg.det(axes)))
    return {"n_electrons": float(rho.sum() * dv), "origin": origin,
            "axes": axes, "shape": tuple(shape)}


def _esp_pair_data(shells):
    """Point-INDEPENDENT setup for the per-point potential matrices:
    per shell pair, the primitive (p, P, cc, E3) Hermite data (the
    expensive part of nuclear_block) plus pure transforms and offsets —
    computed once per shell list and cached by identity."""
    from .integrals import _shell_pair_blocks

    key = tuple(id(sh) for sh in shells)
    hit = _ESP_PAIR_CACHE.get(key)
    if hit is not None:
        return hit
    pures = [_shell_pure_matrix(sh) for sh in shells]
    offs = np.cumsum([0] + [sh.nfunc for sh in shells])
    pairs = []
    for a, sha in enumerate(shells):
        for b in range(a + 1):
            shb = shells[b]
            pairs.append((a, b, sha.l + shb.l,
                          list(_shell_pair_blocks(sha, shb))))
    data = (shells, pures, offs, pairs, int(offs[-1]))
    _ESP_PAIR_CACHE[key] = data
    return data


_ESP_PAIR_CACHE = {}


def _point_potential_matrix(shells, r0: np.ndarray) -> np.ndarray:
    """⟨μ| 1/|r−r0| |ν⟩ over the AO basis (pure components): only the
    Boys-function R tensor depends on the point; everything else comes
    from the cached pair data."""
    from .integrals import hermite_coulomb

    _, pures, offs, pairs, nbf = _esp_pair_data(shells)
    r0 = np.asarray(r0, dtype=np.float64)
    V = np.zeros((nbf, nbf))
    for a, b, L, prim in pairs:
        blk = 0.0
        for p, P, cc, E3 in prim:
            R = hermite_coulomb(L, L, L, p, P - r0)
            blk = blk + cc * (2.0 * np.pi / p) * np.einsum(
                "abtuv,tuv->ab", E3, R[: L + 1, : L + 1, : L + 1],
                optimize=True)
        if pures[a] is not None:
            blk = pures[a] @ blk
        if pures[b] is not None:
            blk = blk @ pures[b].T
        V[offs[a]: offs[a + 1], offs[b]: offs[b + 1]] = blk
        V[offs[b]: offs[b + 1], offs[a]: offs[a + 1]] = blk.T
    return V


def esp_values(problem, points: np.ndarray,
               gamma_spatial: Optional[np.ndarray] = None,
               partial_unitary: Optional[np.ndarray] = None,
               _P: Optional[np.ndarray] = None) -> np.ndarray:
    """Molecular electrostatic potential V(r0) = Σ_A Z_A/|r0−R_A| −
    Σ_μν P_μν ⟨μ|1/|r−r0||ν⟩ at `points` (npts, 3) bohr, in a.u.  The
    electron term is an ANALYTIC Coulomb integral per point (Boys-
    function machinery, no quadrature) — cost is one one-electron
    matrix per point, so use surface/line grids rather than full cubes."""
    from .properties import density_ao

    ao = _require_shells(problem)
    P = _P if _P is not None else density_ao(problem, gamma_spatial,
                                             partial_unitary)
    Z = np.asarray(ao.atomic_numbers, dtype=np.float64)
    R = np.asarray(ao.coords, dtype=np.float64)
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    out = np.empty(pts.shape[0])
    for ip, r0 in enumerate(pts):
        d = np.linalg.norm(R - r0, axis=1)
        if np.any(d < 1e-10):
            out[ip] = np.inf
            continue
        nuc = float((Z / d).sum())
        out[ip] = nuc - float(np.sum(
            P * _point_potential_matrix(ao.shells, r0)))
    return out


# Bondi-ish van der Waals radii (bohr) for the MK-style ESP surface
_VDW_BOHR = {"H": 2.27, "He": 2.65, "Li": 3.44, "Be": 2.89, "B": 3.63,
             "C": 3.21, "N": 2.93, "O": 2.87, "F": 2.78, "Ne": 2.91,
             "Na": 4.29, "Mg": 3.27, "Al": 3.48, "Si": 3.97, "P": 3.40,
             "S": 3.40, "Cl": 3.31, "Ar": 3.55}


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + np.sqrt(5.0)) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1)


def esp_charges(problem,
                gamma_spatial: Optional[np.ndarray] = None,
                partial_unitary: Optional[np.ndarray] = None,
                scales=(1.4, 1.6, 1.8, 2.0),
                points_per_shell: int = 80):
    """ESP-fitted atomic point charges (Merz–Kollman-style): sample the
    potential on scaled-vdW-radius shells (keeping only points outside
    every scaled sphere), then least-squares fit Σ_A q_A/|r−R_A| with
    the total charge constrained exactly (Lagrange).  Returns
    (charges (natom,), rrms — the relative RMS fit residual)."""
    ao = _require_shells(problem)
    R = np.asarray(ao.coords, dtype=np.float64)
    radii = np.array([_VDW_BOHR.get(s, 3.4) for s in ao.symbols])
    pts = []
    for scale in scales:
        for A in range(len(R)):
            cand = R[A] + scale * radii[A] * _fibonacci_sphere(
                points_per_shell)
            d = np.linalg.norm(cand[:, None, :] - R[None, :, :], axis=2)
            keep = np.all(d >= scale * radii[None, :] - 1e-8, axis=1)
            pts.append(cand[keep])
    pts = np.concatenate(pts)
    from .properties import density_ao

    P = density_ao(problem, gamma_spatial, partial_unitary)
    V = esp_values(problem, pts, _P=P)
    A_mat = 1.0 / np.linalg.norm(pts[:, None, :] - R[None, :, :], axis=2)
    natom = len(R)
    # total molecular charge = sum(Z) - tr(PS), the constraint value
    PS = P @ np.asarray(ao.overlap, dtype=np.float64)
    total = float(np.asarray(ao.atomic_numbers).sum() - np.trace(PS))
    # KKT system: [2AᵀA, 1; 1ᵀ, 0] [q; λ] = [2AᵀV; Q_total]
    K = np.zeros((natom + 1, natom + 1))
    K[:natom, :natom] = 2.0 * (A_mat.T @ A_mat)
    K[:natom, natom] = 1.0
    K[natom, :natom] = 1.0
    rhs = np.concatenate([2.0 * A_mat.T @ V, [total]])
    q = np.linalg.solve(K, rhs)[:natom]
    resid = A_mat @ q - V
    rrms = float(np.sqrt((resid ** 2).sum() / (V ** 2).sum()))
    return q, rrms
