"""Gaussian basis set data and shell construction (host NumPy).

Copy of the part of esoo_tpu/chem/basis.py that hydrogen chains need:
STO-3G (H-Ne), 6-31G (H, He) and cc-pVTZ (H), the Shell normalization and
the cartesian-to-spherical transform.  The rest of the JAX package's basis
library (further elements and sets, .gbs files, ghost atoms) is still to
be ported (ROADMAP queue 1, item 12).

``BASIS_SETS[name][element]`` is a list of shells, each a dict
``{"l": 0, "prims": [(exponent, coefficient), ...]}``; SP shells are
stored expanded into separate S and P shells that share exponents.
Coefficients are the published values for normalized primitives
(basis-set-exchange data); contraction renormalization happens in
`Shell.__post_init__`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Published basis data (exponent, coefficient) per shell.
# ---------------------------------------------------------------------------

_STO3G_S_COEFFS = (0.15432897, 0.53532814, 0.44463454)
_STO3G_2S_COEFFS = (-0.09996723, 0.39951283, 0.70011547)
_STO3G_2P_COEFFS = (0.15591627, 0.60768372, 0.39195739)


def _sto3g(elem_exps_1s, elem_exps_2sp=None):
    shells = [{"l": 0, "prims": list(zip(elem_exps_1s, _STO3G_S_COEFFS))}]
    if elem_exps_2sp is not None:
        shells.append({"l": 0, "prims": list(zip(elem_exps_2sp, _STO3G_2S_COEFFS))})
        shells.append({"l": 1, "prims": list(zip(elem_exps_2sp, _STO3G_2P_COEFFS))})
    return shells


STO3G = {
    "H": _sto3g((3.42525091, 0.62391373, 0.16885540)),
    "He": _sto3g((6.36242139, 1.15892300, 0.31364979)),
    "Li": _sto3g((16.1195750, 2.9362007, 0.7946505), (0.6362897, 0.1478601, 0.0480887)),
    "Be": _sto3g((30.1678710, 5.4951153, 1.4871927), (1.3148331, 0.3055389, 0.0993707)),
    "B": _sto3g((48.7911130, 8.8873622, 2.4052670), (2.2369561, 0.5198205, 0.1690618)),
    "C": _sto3g((71.6168370, 13.0450960, 3.5305122), (2.9412494, 0.6834831, 0.2222899)),
    "N": _sto3g((99.1061690, 18.0523120, 4.8856602), (3.7804559, 0.8784966, 0.2857144)),
    "O": _sto3g((130.7093200, 23.8088610, 6.4436083), (5.0331513, 1.1695961, 0.3803890)),
    "F": _sto3g((166.6791300, 30.3608120, 8.2168207), (6.4648032, 1.4860455, 0.4885885)),
    "Ne": _sto3g((207.0156100, 37.7081510, 10.2052970), (8.2463151, 1.9162662, 0.6232293)),
}

SIX31G = {
    "H": [
        {"l": 0, "prims": [(18.7311370, 0.03349460),
                           (2.8253937, 0.23472695),
                           (0.6401217, 0.81375733)]},
        {"l": 0, "prims": [(0.1612778, 1.0)]},
    ],
    "He": [
        {"l": 0, "prims": [(38.4216340, 0.0237660),
                           (5.7780300, 0.1546790),
                           (1.2417740, 0.4696300)]},
        {"l": 0, "prims": [(0.2979640, 1.0)]},
    ],
}


CCPVTZ = {
    "H": [
        {"l": 0, "prims": [(33.8700, 0.0060680), (5.0950, 0.0453080),
                           (1.1590, 0.2028220)]},
        {"l": 0, "prims": [(0.3258, 1.0)]},
        {"l": 0, "prims": [(0.1027, 1.0)]},
        {"l": 1, "prims": [(1.4070, 1.0)]},
        {"l": 1, "prims": [(0.3880, 1.0)]},
        {"l": 2, "prims": [(1.0570, 1.0)]},
    ],
}


BASIS_SETS = {
    "sto-3g": STO3G,
    "sto3g": STO3G,
    "6-31g": SIX31G,
    "631g": SIX31G,
    "cc-pvtz": CCPVTZ,
    "ccpvtz": CCPVTZ,
}

ATOMIC_NUMBERS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5,
    "C": 6, "N": 7, "O": 8, "F": 9, "Ne": 10,
}


ANGSTROM_TO_BOHR = 1.0 / 0.52917721092


def double_factorial(n: int) -> int:
    if n <= 0:
        return 1
    out = 1
    while n > 0:
        out *= n
        n -= 2
    return out


def primitive_norm(alpha: float, lx: int, ly: int, lz: int) -> float:
    """Normalization constant of a cartesian Gaussian primitive."""
    l = lx + ly + lz
    num = (2.0 * alpha / math.pi) ** 0.75 * (4.0 * alpha) ** (l / 2.0)
    den = math.sqrt(
        double_factorial(2 * lx - 1)
        * double_factorial(2 * ly - 1)
        * double_factorial(2 * lz - 1)
    )
    return num / den


def cartesian_components(l: int) -> List[Tuple[int, int, int]]:
    """Cartesian (lx, ly, lz) components of a shell, lexicographic in x>=y>=z order."""
    return [
        (lx, ly, l - lx - ly)
        for lx in range(l, -1, -1)
        for ly in range(l - lx, -1, -1)
    ]


@dataclasses.dataclass
class Shell:
    """A contracted Gaussian shell on one atomic center."""

    l: int
    center: np.ndarray          # (3,) in Bohr
    exps: np.ndarray            # (nprim,)
    coeffs: np.ndarray          # (nprim,) raw published coefficients
    pure: bool = True           # spherical (pure) vs cartesian representation

    def __post_init__(self):
        self.center = np.asarray(self.center, dtype=np.float64)
        self.exps = np.asarray(self.exps, dtype=np.float64)
        self.coeffs = np.asarray(self.coeffs, dtype=np.float64)
        # Fold primitive norms (of the (l,0,0) component) into coefficients,
        # then renormalize the contraction so the (l,0,0) component has unit
        # self-overlap.
        l = self.l
        cn = np.array([primitive_norm(a, l, 0, 0) for a in self.exps])
        c = self.coeffs * cn
        # contracted self-overlap of the (l,0,0)x(l,0,0) pair:
        #   S_ab = c_a c_b * s(alpha_a, alpha_b) with the analytic 1D formula
        a = self.exps[:, None]
        b = self.exps[None, :]
        p = a + b
        # <x^l e^-a r^2 | x^l e^-b r^2> = (pi/p)^{3/2} (2l-1)!! / (2p)^l
        s_pair = (math.pi / p) ** 1.5 * double_factorial(2 * l - 1) / (2 * p) ** l
        norm2 = float(c @ s_pair @ c)
        self._cnorm = c / math.sqrt(norm2)

    @property
    def cnorm(self) -> np.ndarray:
        """Contraction coefficients with primitive + contraction norms folded in."""
        return self._cnorm

    @property
    def ncart(self) -> int:
        return (self.l + 1) * (self.l + 2) // 2

    @property
    def nfunc(self) -> int:
        if self.pure and self.l >= 2:
            return 2 * self.l + 1
        return self.ncart


def _solid_harmonic_poly(l: int, m: int) -> dict:
    """Polynomial coefficients of the real solid harmonic r^l S_lm.

    Returns {(lx,ly,lz): coeff}.  Uses the standard expansion (Helgaker,
    Jorgensen & Olsen, 'Molecular Electronic-Structure Theory', eq. 6.4.47):
    relative coefficients only; absolute normalization is fixed numerically
    downstream against the cartesian overlap matrix.
    """
    am = abs(m)
    poly = {}
    # Pi_{l,am}(z, r^2) = sum_k gamma_k r^{2k} z^{l-am-2k}
    for k in range((l - am) // 2 + 1):
        gamma = (
            (-1) ** k
            * 2.0 ** (-l)
            * math.comb(l, k)
            * math.comb(2 * l - 2 * k, l)
            * math.factorial(l - 2 * k)
            / math.factorial(l - 2 * k - am)
        )
        # expand r^{2k} = (x^2+y^2+z^2)^k multinomially
        for i in range(k + 1):
            for j in range(k - i + 1):
                h = k - i - j
                c_r = (
                    math.factorial(k)
                    / (math.factorial(i) * math.factorial(j) * math.factorial(h))
                )
                # A_m = Re[(x+iy)^am], B_m = Im[(x+iy)^am]
                for t in range(am + 1):
                    phase = 1j ** t
                    if m >= 0:
                        w = (math.comb(am, t) * phase).real
                    else:
                        w = (math.comb(am, t) * phase).imag
                    if w == 0.0:
                        continue
                    key = (2 * i + am - t, 2 * j + t, 2 * h + l - am - 2 * k)
                    poly[key] = poly.get(key, 0.0) + gamma * c_r * w
    return {k: v for k, v in poly.items() if abs(v) > 1e-14}


def cart_to_pure_matrix(l: int, cart_overlap: np.ndarray,
                        cart_norms: Sequence[float]) -> np.ndarray:
    """(2l+1, ncart) matrix mapping normalized-cartesian components to
    normalized spherical (pure) components.

    m ordering: -l, ..., 0, ..., +l (matching common chemistry convention).

    Args:
        cart_overlap: self-overlap matrix of the *contracted, normalized*
            cartesian components of the shell (ncart x ncart).
        cart_norms: the normalization constants that were applied to each
            cartesian component (relative to raw monomial primitives).
    """
    comps = cartesian_components(l)
    nc = len(comps)
    rows = []
    for m in range(-l, l + 1):
        poly = _solid_harmonic_poly(l, m)
        v = np.zeros(nc)
        for idx, key in enumerate(comps):
            if key in poly:
                # spherical = sum_c p_c * monomial_c; our basis functions are
                # N_c * monomial_c, so the coefficient on the basis function
                # is p_c / N_c
                v[idx] = poly[key] / cart_norms[idx]
        n2 = float(v @ cart_overlap @ v)
        rows.append(v / math.sqrt(n2))
    return np.array(rows)


def parse_geometry(atom: str):
    """Parse 'H 0 0 0; H 0 0 0.735' (Angstrom) into (symbols, coords_bohr)."""
    symbols, coords = [], []
    for part in atom.split(";"):
        toks = part.split()
        if not toks:
            continue
        symbols.append(toks[0])
        coords.append([float(x) for x in toks[1:4]])
    return symbols, np.asarray(coords, dtype=np.float64) * ANGSTROM_TO_BOHR


def build_shells(atom: str, basis: str, custom_basis: dict | None = None):
    """Build the shell list for a molecule.

    Args:
        atom: geometry string in Angstrom, e.g. "H 0 0 0; H 0 0 0.735".
        basis: basis set name (case-insensitive) from `BASIS_SETS`.
        custom_basis: optional {element: [shell dicts]} overriding the table.

    Returns:
        (shells, symbols, coords_bohr)
    """
    symbols, coords = parse_geometry(atom)
    if custom_basis is not None:
        table = custom_basis
    elif basis.lower() not in BASIS_SETS:
        raise ValueError(
            f"unknown basis {basis!r}: choose from "
            f"{sorted(set(BASIS_SETS))} or pass custom_basis=")
    else:
        table = BASIS_SETS[basis.lower()]
    shells = []
    for sym, xyz in zip(symbols, coords):
        if sym not in table:
            raise ValueError(
                f"No {basis} data for element {sym}; pass custom_basis= "
                f"with published exponents/coefficients.")
        for sh in table[sym]:
            prims = sh["prims"]
            shells.append(
                Shell(
                    l=sh["l"],
                    center=xyz,
                    exps=[p[0] for p in prims],
                    coeffs=[p[1] for p in prims],
                    pure=sh.get("pure", True),
                )
            )
    return shells, symbols, coords
