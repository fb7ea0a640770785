"""Gaussian basis set data and shell construction (host NumPy).

Frozen copy of esoo_torch/chem/basis.py (the benchmark's inputs): STO-3G (H-Ar), 6-31G, 6-31G* and 6-31G**
(Pople cartesian d), cc-pVDZ, cc-pVTZ and cc-pVQZ, ATOMIC_NUMBERS to Kr,
ghost atoms ('@He' or 'ghost:He': basis functions without a nucleus) and
any Gaussian94 .gbs file (gbs.py).  The basis data is embedded
here; nothing is downloaded.

Data layout
-----------
``BASIS_SETS[name][element]`` is a list of shells, each shell a dict::

    {"l": 0, "prims": [(exponent, coefficient), ...]}

SP shells (as in STO-3G) are stored expanded into separate S and P shells
that share exponents.  Coefficients are the published values for *normalized
primitives*; contraction renormalization happens in `Shell.__post_init__`.

All values are the standard published basis-set-exchange parameters
(public domain data).
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

# third row: (1s)(2sp)(3sp); the 3sp expansion coefficients are the
# universal STO-3G fit constants (Hehre/Stewart/Pople), exponents are the
# published per-atom values (validated in tests against literature
# molecular RHF energies, e.g. HCl)
_STO3G_3S_COEFFS = (-0.2196203936, 0.2255954336, 0.9003984260)
_STO3G_3P_COEFFS = (0.0105876043, 0.5951670053, 0.4620010120)


def _sto3g3(exps_1s, exps_2sp, exps_3sp):
    return [
        {"l": 0, "prims": list(zip(exps_1s, _STO3G_S_COEFFS))},
        {"l": 0, "prims": list(zip(exps_2sp, _STO3G_2S_COEFFS))},
        {"l": 1, "prims": list(zip(exps_2sp, _STO3G_2P_COEFFS))},
        {"l": 0, "prims": list(zip(exps_3sp, _STO3G_3S_COEFFS))},
        {"l": 1, "prims": list(zip(exps_3sp, _STO3G_3P_COEFFS))},
    ]


STO3G.update({
    "Si": _sto3g3((407.7975514, 74.28083305, 20.10329229),
                  (23.19365606, 5.389706871, 1.752899952),
                  (1.4787406220, 0.4125648801, 0.1614750979)),
    "P": _sto3g3((468.3656378, 85.31338559, 23.09131500),
                 (28.03263958, 6.514182577, 2.118614352),
                 (1.7431032310, 0.4863213771, 0.1903428909)),
    "S": _sto3g3((533.1257359, 97.10951830, 26.28162542),
                 (33.32975173, 7.745117521, 2.518952599),
                 (2.0291942740, 0.5661400518, 0.2215833792)),
    "Cl": _sto3g3((601.3456136, 109.5358542, 29.64467686),
                  (38.96041889, 9.053563477, 2.944499834),
                  (2.1293864950, 0.5940934274, 0.2325241410)),
    "Ar": _sto3g3((674.4465184, 122.8512753, 33.24834945),
                  (45.16424392, 10.49519900, 3.413364448),
                  (2.6213665180, 0.7313546050, 0.2862472356)),
})

def _pople_631g(s6_exps, s6_coeffs, sp3_exps, sp3_s, sp3_p, sp1_exp):
    """First-row 6-31G shell structure: (10s4p) -> [3s2p].

    Core 6s contraction; inner-valence SP shell (3 primitives, shared
    exponents, separate s/p coefficients, stored expanded); outer-valence
    single-primitive SP shell.  Data: Hehre, Ditchfield & Pople,
    J. Chem. Phys. 56, 2257 (1972); Li/Be: Dill & Pople, J. Chem. Phys.
    62, 2921 (1975).
    """
    return [
        {"l": 0, "prims": list(zip(s6_exps, s6_coeffs))},
        {"l": 0, "prims": list(zip(sp3_exps, sp3_s))},
        {"l": 1, "prims": list(zip(sp3_exps, sp3_p))},
        {"l": 0, "prims": [(sp1_exp, 1.0)]},
        {"l": 1, "prims": [(sp1_exp, 1.0)]},
    ]


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
    "Li": _pople_631g(
        (642.41892, 96.798515, 22.091121, 6.2010703, 1.9351177, 0.6367358),
        (0.0021426, 0.0162089, 0.0773156, 0.2457860, 0.4701890, 0.3454708),
        (2.3249184, 0.6324306, 0.0790534),
        (-0.0350917, -0.1912328, 1.0839878),
        (0.0089415, 0.1410095, 0.9453637),
        0.0359620),
    "Be": _pople_631g(
        (1264.5857, 189.93681, 43.159089, 12.098663, 3.8063232, 1.2728903),
        (0.0019448, 0.0148351, 0.0720906, 0.2371542, 0.4691987, 0.3565202),
        (3.1964631, 0.7478133, 0.2199663),
        (-0.1126487, -0.2295064, 1.1869167),
        (0.0559802, 0.2615506, 0.7939723),
        0.0823099),
    "B": _pople_631g(
        (2068.8823, 310.64957, 70.683033, 19.861080, 6.2993048, 2.1270270),
        (0.0018663, 0.0142515, 0.0695516, 0.2325729, 0.4670787, 0.3634314),
        (4.7279710, 1.1903377, 0.3594117),
        (-0.1303938, -0.1307889, 1.1309444),
        (0.0745976, 0.3078467, 0.7434568),
        0.1267512),
    "C": _pople_631g(
        (3047.5249, 457.36951, 103.94869, 29.210155, 9.2866630, 3.1639270),
        (0.0018347, 0.0140373, 0.0688426, 0.2321844, 0.4679413, 0.3623120),
        (7.8682724, 1.8812885, 0.5442493),
        (-0.1193324, -0.1608542, 1.1434564),
        (0.0689991, 0.3164240, 0.7443083),
        0.1687144),
    "N": _pople_631g(
        (4173.5110, 627.45790, 142.90210, 40.234330, 12.820210, 4.3904370),
        (0.0018348, 0.0139950, 0.0685870, 0.2322410, 0.4690700, 0.3604550),
        (11.626358, 2.7162800, 0.7722180),
        (-0.1149610, -0.1691180, 1.1458520),
        (0.0675800, 0.3239070, 0.7408950),
        0.2120313),
    "O": _pople_631g(
        (5484.6717, 825.23495, 188.04696, 52.964500, 16.897570, 5.7996353),
        (0.0018311, 0.0139501, 0.0684451, 0.2327143, 0.4701930, 0.3585209),
        (15.539616, 3.5999336, 1.0137618),
        (-0.1107775, -0.1480263, 1.1307670),
        (0.0708743, 0.3397528, 0.7271586),
        0.2700058),
    "F": _pople_631g(
        (7001.7130, 1051.3660, 239.28569, 67.397445, 21.519957, 7.4031013),
        (0.0018196, 0.0139161, 0.0684053, 0.2331858, 0.4712674, 0.3566185),
        (20.847952, 4.8083083, 1.3440698),
        (-0.1085070, -0.1464517, 1.1286886),
        (0.0716287, 0.3459121, 0.7224700),
        0.3581514),
    "Ne": _pople_631g(
        (8425.8515, 1268.5194, 289.62141, 80.859596, 25.945130, 8.8468607),
        (0.0018843, 0.0143369, 0.0701096, 0.2373733, 0.4730071, 0.3484012),
        (26.532131, 6.1755501, 1.8391377),
        (-0.1071183, -0.1461638, 1.1277735),
        (0.0719096, 0.3495134, 0.7199405),
        0.4829340),
}

def _dunning_vdz(s_exps, s_c1, s_c2, p_exps, p_c, d_exp):
    """First-row cc-pVDZ shell structure: (9s4p1d) -> [3s2p1d].

    Two general s contractions over the first len(s_c1) primitives, one
    free outer s; one p contraction over the first len(p_c) primitives,
    one free outer p; one free d.  Data: Dunning, J. Chem. Phys. 90,
    1007 (1989) for B-Ne; Li/Be: Prascher et al., Theor. Chem. Acc. 128,
    69 (2011).
    """
    return [
        {"l": 0, "prims": list(zip(s_exps, s_c1))},
        {"l": 0, "prims": list(zip(s_exps, s_c2))},
        {"l": 0, "prims": [(s_exps[-1], 1.0)]},
        {"l": 1, "prims": list(zip(p_exps, p_c))},
        {"l": 1, "prims": [(p_exps[-1], 1.0)]},
        {"l": 2, "prims": [(d_exp, 1.0)]},
    ]


CCPVDZ = {
    "H": [
        {"l": 0, "prims": [(13.0100, 0.0196850), (1.9620, 0.1379770),
                           (0.4446, 0.4781480), (0.1220, 0.5012400)]},
        {"l": 0, "prims": [(0.1220, 1.0)]},
        {"l": 1, "prims": [(0.7270, 1.0)]},
    ],
    "He": [
        {"l": 0, "prims": [(38.3600, 0.0238090), (5.7700, 0.1548910),
                           (1.2400, 0.4699870), (0.2976, 0.5130270)]},
        {"l": 0, "prims": [(0.2976, 1.0)]},
        {"l": 1, "prims": [(1.2750, 1.0)]},
    ],
    "Li": _dunning_vdz(
        (1469.0, 220.5, 50.26, 14.24, 4.581, 1.580, 0.5640, 0.0734500,
         0.0280500),
        (0.000766, 0.005892, 0.029671, 0.109180, 0.282789, 0.453123,
         0.274774, 0.009751),
        (-0.000120, -0.000923, -0.004689, -0.017682, -0.048902, -0.096009,
         -0.136380, 0.575102),
        (1.534, 0.2749, 0.07362, 0.0240300),
        (0.022784, 0.139107, 0.500375),
        0.1144),
    "Be": _dunning_vdz(
        (2940.0, 441.2, 100.5, 28.43, 9.169, 3.196, 1.159, 0.1811,
         0.0589000),
        (0.000680, 0.005236, 0.026606, 0.099993, 0.269702, 0.451469,
         0.295074, 0.012587),
        (-0.000123, -0.000966, -0.004831, -0.018798, -0.052925, -0.109726,
         -0.165043, 0.570563),
        (3.619, 0.7110, 0.1951, 0.0601800),
        (0.029110, 0.169365, 0.513458),
        0.2354),
    "B": _dunning_vdz(
        (4570.0, 685.9, 156.5, 44.47, 14.48, 5.131, 1.898, 0.3329, 0.1043),
        (0.000696, 0.005353, 0.027134, 0.101380, 0.272055, 0.448403,
         0.290123, 0.014322),
        (-0.000139, -0.001097, -0.005444, -0.021916, -0.059751, -0.138732,
         -0.131482, 0.539526),
        (6.001, 1.241, 0.3364, 0.0953800),
        (0.035481, 0.198072, 0.505230),
        0.3430),
    "C": _dunning_vdz(
        (6665.0, 1000.0, 228.0, 64.71, 21.06, 7.495, 2.797, 0.5215, 0.1596),
        (0.000692, 0.005329, 0.027077, 0.101718, 0.274740, 0.448564,
         0.285074, 0.015204),
        (-0.000146, -0.001154, -0.005725, -0.023312, -0.063955, -0.149981,
         -0.127262, 0.544529),
        (9.439, 2.002, 0.5456, 0.1517),
        (0.038109, 0.209480, 0.508557),
        0.5500),
    "N": _dunning_vdz(
        (9046.0, 1357.0, 309.3, 87.73, 28.56, 10.21, 3.838, 0.7466, 0.2248),
        (0.000700, 0.005389, 0.027406, 0.103207, 0.278723, 0.448540,
         0.278238, 0.015440),
        (-0.000153, -0.001208, -0.005992, -0.024544, -0.067459, -0.158078,
         -0.121831, 0.549003),
        (13.55, 2.917, 0.7973, 0.2185),
        (0.039919, 0.217169, 0.510319),
        0.8170),
    "O": _dunning_vdz(
        (11720.0, 1759.0, 400.8, 113.7, 37.03, 13.27, 5.025, 1.013, 0.3023),
        (0.000710, 0.005470, 0.027837, 0.104800, 0.283062, 0.448719,
         0.270952, 0.015458),
        (-0.000160, -0.001263, -0.006267, -0.025716, -0.070924, -0.165411,
         -0.116955, 0.557368),
        (17.70, 3.854, 1.046, 0.2753),
        (0.043018, 0.228913, 0.508728),
        1.1850),
    "F": _dunning_vdz(
        (14710.0, 2207.0, 502.8, 142.6, 46.47, 16.70, 6.356, 1.316, 0.3897),
        (0.000721, 0.005553, 0.028267, 0.106444, 0.286814, 0.448641,
         0.264761, 0.015333),
        (-0.000165, -0.001308, -0.006495, -0.026691, -0.073690, -0.170776,
         -0.112327, 0.562814),
        (22.67, 4.977, 1.347, 0.3471),
        (0.044878, 0.235718, 0.508521),
        1.6400),
    "Ne": _dunning_vdz(
        (17880.0, 2683.0, 611.5, 173.5, 56.64, 20.42, 7.810, 1.653, 0.4869),
        (0.000738, 0.005677, 0.028883, 0.108540, 0.290907, 0.448324,
         0.258026, 0.015063),
        (-0.000172, -0.001357, -0.006737, -0.027663, -0.076208, -0.175227,
         -0.107038, 0.567050),
        (28.39, 6.270, 1.695, 0.4317),
        (0.046087, 0.240181, 0.508744),
        2.2020),
}

def _dunning_vtz_row1(s_exps, s_c1, s_c2, s_free1, s_free2,
                      p_exps, p_c, p_free1, p_free2, d1, d2, f1):
    """First-row cc-pVTZ shell structure: (10s5p2d1f) -> [4s3p2d1f].

    Two general s contractions over the 8 listed primitives, two free s;
    one p contraction over 3 primitives, two free p; two free d, one free
    f.  Data: Dunning, J. Chem. Phys. 90, 1007 (1989) / EMSL exchange;
    validated against literature RHF energies in tests (H2O cc-pVTZ)."""
    return [
        {"l": 0, "prims": list(zip(s_exps, s_c1))},
        {"l": 0, "prims": list(zip(s_exps, s_c2))},
        {"l": 0, "prims": [(s_free1, 1.0)]},
        {"l": 0, "prims": [(s_free2, 1.0)]},
        {"l": 1, "prims": list(zip(p_exps, p_c))},
        {"l": 1, "prims": [(p_free1, 1.0)]},
        {"l": 1, "prims": [(p_free2, 1.0)]},
        {"l": 2, "prims": [(d1, 1.0)]},
        {"l": 2, "prims": [(d2, 1.0)]},
        {"l": 3, "prims": [(f1, 1.0)]},
    ]


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
    "C": _dunning_vtz_row1(
        (8236.0, 1235.0, 280.8, 79.27, 25.59, 8.997, 3.319, 0.3643),
        (0.000531, 0.004108, 0.021087, 0.081853, 0.234817, 0.434401,
         0.346129, -0.008983),
        (-0.000113, -0.000878, -0.004540, -0.018133, -0.055760, -0.126895,
         -0.170352, 0.598684),
        0.9059, 0.1285,
        (18.71, 4.133, 1.200), (0.014031, 0.086866, 0.290216),
        0.3827, 0.1209, 1.097, 0.318, 0.761),
    "N": _dunning_vtz_row1(
        (11420.0, 1712.0, 389.3, 110.0, 35.57, 12.54, 4.644, 0.5118),
        (0.000523, 0.004045, 0.020775, 0.080727, 0.233074, 0.433501,
         0.347472, -0.008508),
        (-0.000115, -0.000895, -0.004624, -0.018528, -0.057339, -0.132076,
         -0.172510, 0.599944),
        1.293, 0.1787,
        (26.63, 5.948, 1.742), (0.014670, 0.091764, 0.298683),
        0.555, 0.1725, 1.654, 0.469, 1.093),
    "O": _dunning_vtz_row1(
        (15330.0, 2299.0, 522.4, 147.3, 47.55, 16.76, 6.207, 0.6882),
        (0.000508, 0.003929, 0.020243, 0.079181, 0.230687, 0.433118,
         0.350260, -0.008154),
        (-0.000115, -0.000895, -0.004636, -0.018724, -0.058463, -0.136463,
         -0.175740, 0.603418),
        1.752, 0.2384,
        (34.46, 7.749, 2.280), (0.015928, 0.099740, 0.310492),
        0.7156, 0.2140, 2.314, 0.645, 1.428),
    "F": _dunning_vtz_row1(
        (19500.0, 2923.0, 664.5, 187.5, 60.62, 21.42, 7.950, 0.8815),
        (0.000507, 0.003923, 0.020200, 0.079010, 0.230439, 0.432872,
         0.349964, -0.007892),
        (-0.000117, -0.000912, -0.004717, -0.019086, -0.059655, -0.140010,
         -0.176782, 0.605043),
        2.257, 0.3041,
        (43.88, 9.926, 2.930), (0.016665, 0.104472, 0.317260),
        0.9132, 0.2672, 3.107, 0.855, 1.917),
    "Ne": _dunning_vtz_row1(
        (24350.0, 3650.0, 829.6, 237.0, 75.61, 26.73, 9.927, 1.102),
        (0.000502, 0.003881, 0.019977, 0.078418, 0.229676, 0.432722,
         0.350642, -0.007645),
        (-0.000118, -0.000915, -0.004737, -0.019233, -0.060269, -0.142508,
         -0.177878, 0.605836),
        2.836, 0.3782,
        (54.70, 12.43, 3.679), (0.017151, 0.108656, 0.324669),
        1.143, 0.3300, 4.014, 1.096, 2.544),
}

CCPVQZ = {
    # Dunning cc-pVQZ for H (EMSL basis-set-exchange values).  Validated
    # variationally in tests: E_FCI(QZ) < E_FCI(TZ) and above the exact
    # Born-Oppenheimer limit.
    "H": [
        {"l": 0, "prims": [(82.6400, 0.0020060), (12.4100, 0.0153430),
                           (2.8240, 0.0755790), (0.7977, 0.2568750),
                           (0.2581, 0.4973680), (0.0898900, 0.2961330)]},
        {"l": 0, "prims": [(0.7977, 1.0)]},
        {"l": 0, "prims": [(0.2581, 1.0)]},
        {"l": 0, "prims": [(0.0898900, 1.0)]},
        {"l": 1, "prims": [(2.2920, 1.0)]},
        {"l": 1, "prims": [(0.8380, 1.0)]},
        {"l": 1, "prims": [(0.2920, 1.0)]},
        {"l": 2, "prims": [(2.0620, 1.0)]},
        {"l": 2, "prims": [(0.6620, 1.0)]},
        {"l": 3, "prims": [(1.3970, 1.0)]},
    ],
}

# 6-31G* / 6-31G**: 6-31G plus single polarization shells (Hariharan &
# Pople, Theor. Chim. Acta 28, 213 (1973)): one cartesian-d on Li-Ne
# (standard exponents below), one p (exponent 1.1) on H/He for **.
_POL_D_EXP = {"Li": 0.200, "Be": 0.400, "B": 0.600, "C": 0.800,
              "N": 0.800, "O": 0.800, "F": 0.800, "Ne": 0.800}


def _with_polarization(base: dict, hydrogen_p: bool) -> dict:
    out = {}
    for el, shells in base.items():
        shells = [dict(sh) for sh in shells]
        if el in _POL_D_EXP:
            # Pople-convention polarization d: CARTESIAN (6 components) —
            # published 6-31G* energies assume 6d
            shells.append({"l": 2, "prims": [(_POL_D_EXP[el], 1.0)],
                           "pure": False})
        elif el in ("H", "He") and hydrogen_p:
            shells.append({"l": 1, "prims": [(1.100, 1.0)]})
        out[el] = shells
    return out


SIX31G_STAR = _with_polarization(SIX31G, hydrogen_p=False)
SIX31G_STARSTAR = _with_polarization(SIX31G, hydrogen_p=True)

BASIS_SETS = {
    "sto-3g": STO3G,
    "sto3g": STO3G,
    "6-31g": SIX31G,
    "631g": SIX31G,
    "6-31g*": SIX31G_STAR,
    "631g*": SIX31G_STAR,
    "6-31g(d)": SIX31G_STAR,
    "6-31g**": SIX31G_STARSTAR,
    "631g**": SIX31G_STARSTAR,
    "6-31g(d,p)": SIX31G_STARSTAR,
    "cc-pvdz": CCPVDZ,
    "ccpvdz": CCPVDZ,
    "cc-pvtz": CCPVTZ,
    "ccpvtz": CCPVTZ,
    "cc-pvqz": CCPVQZ,
    "ccpvqz": CCPVQZ,
}

ATOMIC_NUMBERS = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5,
    "C": 6, "N": 7, "O": 8, "F": 9, "Ne": 10,
    "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18,
    # fourth row — reachable via .gbs basis files (chem/gbs.py)
    "K": 19, "Ca": 20, "Sc": 21, "Ti": 22, "V": 23, "Cr": 24,
    "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29, "Zn": 30,
    "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
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


def is_ghost(symbol: str) -> bool:
    """Ghost-atom marker: '@He' or 'ghost:He' — basis functions at the
    center, no nucleus and no electrons (counterpoise corrections)."""
    return symbol.startswith("@") or symbol.lower().startswith("ghost:")


def element_symbol(symbol: str) -> str:
    """The element behind a (possibly ghost-marked) atom symbol."""
    if symbol.startswith("@"):
        return symbol[1:]
    if symbol.lower().startswith("ghost:"):
        return symbol[6:]
    return symbol


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
    elif basis.lower().endswith(".gbs"):
        # universal ingestion: any Gaussian94 basis file (the interchange
        # format the Basis Set Exchange exports for every published set)
        from .gbs import load_gbs
        table = load_gbs(basis)
    elif basis.lower() not in BASIS_SETS:
        raise ValueError(
            f"unknown basis {basis!r}: choose from "
            f"{sorted(set(BASIS_SETS))}, pass a .gbs file path, or pass "
            f"custom_basis=")
    else:
        table = BASIS_SETS[basis.lower()]
    shells = []
    for sym, xyz in zip(symbols, coords):
        el = element_symbol(sym)
        if el not in table:
            raise ValueError(
                f"No {basis} data for element {el}; pass custom_basis= with "
                f"published exponents/coefficients."
            )
        for sh in table[el]:
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
