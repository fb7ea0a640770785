"""Gaussian94 basis-set file (.gbs) parser and writer.

Frozen copy of esoo_torch/chem/gbs.py (host NumPy): the package ships its own
integral engine, so any element and basis is reached by reading the
standard interchange format every basis repository (Basis Set Exchange)
exports.

Format::

    ! comment lines
    ****
    H     0
    S   3   1.00
          3.42525091             0.15432897
          0.62391373             0.53532814
          0.16885540             0.44463454
    ****
    O     0
    S   8   1.00
          ...
    SP   3   1.00
          5.0331513             -0.09996723             0.15591627
          ...
    D   1   1.00
          2.3140000              1.0000000
    ****

Parsed into the ``BASIS_SETS`` shell-dict layout of chem/basis.py:
``{element: [{"l": int, "prims": [(exp, coeff), ...]}, ...]}`` with SP
shells expanded into separate S and P shells sharing exponents.
Fortran D-exponents (1.0D+03) are accepted.
"""

from __future__ import annotations

from typing import Dict, List

_ANGULAR = {"S": 0, "P": 1, "D": 2, "F": 3, "G": 4, "H": 5, "I": 6}


def _num(tok: str) -> float:
    """Float with Fortran D/d exponent support."""
    return float(tok.replace("D", "E").replace("d", "e"))


def parse_gbs(text: str) -> Dict[str, list]:
    """Parse Gaussian94-format basis text -> {element: [shell dicts]}."""
    out: Dict[str, list] = {}
    # strip comments / blanks; keep **** separators
    lines: List[str] = []
    for raw in text.splitlines():
        line = raw.split("!", 1)[0].rstrip()
        if line.strip():
            lines.append(line.strip())

    i = 0
    n = len(lines)
    while i < n:
        if lines[i] == "****":
            i += 1
            continue
        # element header: "Sym 0"
        head = lines[i].split()
        if len(head) < 1 or head[0].upper() == "BASIS":
            i += 1
            continue
        elem = head[0].capitalize()
        i += 1
        shells = []
        while i < n and lines[i] != "****":
            sh = lines[i].split()
            ltok = sh[0].upper()
            if ltok not in _ANGULAR and ltok != "SP":
                raise ValueError(
                    f"unrecognized shell type {sh[0]!r} for element {elem} "
                    f"(line: {lines[i]!r})")
            nprim = int(sh[1])
            scale = _num(sh[2]) if len(sh) > 2 else 1.0
            i += 1
            rows = []
            for _ in range(nprim):
                if i >= n:
                    raise ValueError(
                        f"truncated shell block for element {elem}")
                rows.append([_num(t) for t in lines[i].split()])
                i += 1
            s2 = scale * scale           # Gaussian scale factor convention
            if ltok == "SP":
                if any(len(r) != 3 for r in rows):
                    raise ValueError(
                        f"SP shell for {elem} needs exponent + 2 coeffs")
                shells.append({"l": 0, "prims": [(r[0] * s2, r[1])
                                                 for r in rows]})
                shells.append({"l": 1, "prims": [(r[0] * s2, r[2])
                                                 for r in rows]})
            else:
                if any(len(r) != 2 for r in rows):
                    raise ValueError(
                        f"{ltok} shell for {elem} needs exponent + 1 coeff")
                shells.append({"l": _ANGULAR[ltok],
                               "prims": [(r[0] * s2, r[1]) for r in rows]})
        if not shells:
            raise ValueError(f"element {elem} has no shells")
        out[elem] = shells
    if not out:
        raise ValueError("no basis entries found in .gbs text")
    return out


def load_gbs(path: str) -> Dict[str, list]:
    """Parse a .gbs file from disk."""
    with open(path) as f:
        return parse_gbs(f.read())


_LETTERS = {v: k for k, v in _ANGULAR.items()}


def format_gbs(table: Dict[str, list]) -> str:
    """Write a {element: [shell dicts]} table as Gaussian94 text (the
    round-trip inverse of parse_gbs; SP recombination is not attempted —
    S and P shells are emitted separately, which Gaussian94 allows)."""
    parts = ["****"]
    for elem, shells in table.items():
        parts.append(f"{elem}     0")
        for sh in shells:
            prims = sh["prims"]
            parts.append(f"{_LETTERS[sh['l']]}   {len(prims)}   1.00")
            for e, c in prims:
                parts.append(f"      {e:< .10E}      {c:< .10E}")
        parts.append("****")
    return "\n".join(parts) + "\n"
