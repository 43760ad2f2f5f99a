"""Synthetic CHNO inputs generated from a seed.

Writes everything a run needs, with no external data:

    ffield       ReaxFF-format force field for C, H, O, N (one fixed table
                 below, of the magnitudes published CHNO ReaxFF sets use;
                 the header says it is synthetic)
    ffield.lg    the same table in the ReaxFF-lg layout (dispersion and
                 inner-core columns added)
    pqeq1.par    PQEq core/shell parameters for the same four types
    input.xyz    a 168-atom orthorhombic cell of eight C3H6N6O6 molecules
                 (RDX's composition, Z=8 and cell size, ~1.8 g/cm^3); the
                 molecules are built from bond lengths and angles, their
                 orientations and placements come from the seed.  It is NOT
                 the RDX crystal structure.
    rxmd.in      a run deck

    python -m rxmd_tpu.tools.geninputs -o inputs/ [--seed 0]

Only NumPy is used and every number is written at fixed precision, so a
given seed writes the same bytes on every run.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

HEADER = ("Reactive MD-force field: synthetic CHNO "
          "(rxmd_tpu.tools.geninputs; not a published fit)")

# 39 general parameters (index = position in the file, 1-based)
GENERAL = (
    (50.0000, "Overcoordination parameter"),
    (9.5469, "Overcoordination parameter"),
    (26.5405, "Valency angle conjugation parameter"),
    (1.7224, "Triple bond stabilisation parameter"),
    (6.8702, "Triple bond stabilisation parameter"),
    (60.4850, "C2-correction"),
    (1.0588, "Undercoordination parameter"),
    (4.6000, "Triple bond stabilisation parameter"),
    (12.1176, "Undercoordination parameter"),
    (13.3056, "Undercoordination parameter"),
    (-70.5044, "Triple bond stabilization energy"),
    (0.0000, "Lower Taper-radius"),
    (10.0000, "Upper Taper-radius"),
    (2.8793, "Not used"),
    (33.8667, "Valency undercoordination"),
    (6.0891, "Valency angle/lone pair parameter"),
    (1.0563, "Valency angle"),
    (2.0384, "Valency angle parameter"),
    (6.1431, "Not used"),
    (6.9290, "Double bond/angle parameter"),
    (0.3989, "Double bond/angle parameter: overcoord"),
    (3.9954, "Double bond/angle parameter: overcoord"),
    (-2.4837, "Not used"),
    (5.7796, "Torsion/BO parameter"),
    (10.0000, "Torsion overcoordination"),
    (1.9487, "Torsion overcoordination"),
    (-1.2327, "Conjugation 0 (not used)"),
    (2.1645, "Conjugation"),
    (1.5591, "vdWaals shielding"),
    (0.1000, "Cutoff for bond order (*100)"),
    (2.1365, "Valency angle conjugation parameter"),
    (0.6991, "Overcoordination parameter"),
    (50.0000, "Overcoordination parameter"),
    (1.8512, "Valency/lone pair parameter"),
    (0.5000, "Not used"),
    (20.0000, "Not used"),
    (5.0000, "Molecular energy (not used)"),
    (0.0000, "Molecular energy (not used)"),
    (2.6962, "Valency angle conjugation parameter"),
)

# per atom type, four lines of eight (the ffield's own layout):
#   ro(sigma) valency mass Rvdw Evdw gammaEEM ro(pi) #electrons
#   alfa gammavdW valency Eunder n.u. chiEEM etaEEM n.u.
#   ro(pipi) Elp heat-incr pboc4 pboc3 pboc5 n.u. n.u.
#   ov/un val1 n.u. val3 val4 n.u. n.u. n.u.
ATOMS = (
    ("C", (1.3825, 4.0000, 12.0000, 1.9133, 0.1853, 0.9000, 1.1359, 4.0000,
           9.7602, 2.1346, 4.0000, 33.2433, 79.5548, 5.8678, 7.0000, 0.0000,
           1.2104, 0.0000, 199.0303, 8.6991, 34.7289, 13.3894, 0.8563, 0.0,
           -2.8983, 2.5000, 1.0564, 4.0000, 2.9663, 0.0, 0.0, 0.0)),
    ("H", (0.7853, 1.0000, 1.0080, 1.5904, 0.0419, 1.0206, -0.1000, 1.0000,
           9.3557, 5.0518, 1.0000, 0.0000, 121.1250, 3.7248, 9.6093, 1.0000,
           -0.1000, 0.0000, 62.4879, 1.9771, 3.3517, 0.7571, 1.0698, 0.0,
           -15.7683, 2.1488, 1.0338, 1.0000, 2.8793, 0.0, 0.0, 0.0)),
    ("O", (1.2450, 2.0000, 15.9990, 1.8500, 0.1000, 1.0898, 1.0548, 6.0000,
           9.7300, 13.8449, 4.0000, 37.5000, 116.0768, 8.5000, 8.3122, 2.0,
           0.9049, 0.4056, 59.0626, 3.5027, 0.7640, 0.0021, 0.9745, 0.0,
           -3.5500, 2.9000, 1.0493, 4.0000, 2.9225, 0.0, 0.0, 0.0)),
    ("N", (1.2333, 3.0000, 14.0000, 1.8500, 0.1376, 0.8596, 1.1748, 5.0000,
           10.0667, 7.8431, 4.0000, 32.2482, 100.0000, 6.8418, 6.3404, 2.0,
           1.0433, 13.7673, 119.9837, 2.1961, 3.0696, 2.7683, 0.9745, 0.0,
           -4.3875, 2.6192, 1.0183, 4.0000, 2.8793, 0.0, 0.0, 0.0)),
)

# bonds (1-based types), two lines of eight:
#   Edis1 Edis2 Edis3 pbe1 pbo5 13corr pbo6 kov
#   pbe2 pbo3 pbo4 n.u. pbo1 pbo2 ovcorr n.u.
BONDS = (
    ((1, 1), (158.2004, 99.1897, 78.0000, -0.7738, -0.4550, 1.0, 37.6117,
              0.4147, 0.4590, -0.1000, 9.1628, 1.0, -0.0777, 6.7268, 1.0,
              0.0)),
    ((1, 2), (169.4760, 0.0, 0.0, -0.6083, 0.0, 1.0, 6.0, 0.7652,
              5.2290, 1.0, 0.0, 1.0, -0.0500, 6.9136, 0.0, 0.0)),
    ((2, 2), (153.3934, 0.0, 0.0, -0.4600, 0.0, 1.0, 6.0, 0.7300,
              6.2500, 1.0, 0.0, 1.0, -0.0790, 6.0552, 0.0, 0.0)),
    ((1, 3), (164.4303, 82.6772, 60.8077, -0.3739, -0.2351, 1.0, 10.5036,
              1.0000, 0.4475, -0.2288, 7.0250, 1.0, -0.1363, 6.0000, 0.0,
              0.0)),
    ((3, 3), (142.2858, 145.0000, 50.8293, 0.2506, -0.1000, 1.0, 29.7503,
              0.6051, 0.3451, -0.1055, 9.0000, 1.0, -0.1225, 7.0000, 1.0,
              0.0)),
    ((2, 3), (160.0000, 0.0, 0.0, -0.5725, 0.0, 1.0, 6.0, 0.5626,
              1.1150, 1.0, 0.0, 0.0, -0.0920, 6.0000, 0.0, 0.0)),
    ((1, 4), (134.1215, 140.2179, 79.9745, 0.0163, -0.1387, 1.0, 27.0617,
              0.2000, 0.1387, -0.3681, 7.1611, 1.0, -0.1000, 6.0000, 1.0,
              0.0)),
    ((2, 4), (231.8173, 0.0, 0.0, -0.3364, 0.0, 1.0, 6.0, 0.4125,
              15.8910, 1.0, 0.0, 1.0, -0.0657, 7.0000, 0.0, 0.0)),
    ((3, 4), (130.8596, 169.4551, 40.0000, 0.3837, -0.1639, 1.0, 35.0000,
              0.0500, 1.0000, -0.3579, 7.0004, 1.0, -0.1193, 6.8773, 1.0,
              0.0)),
    ((4, 4), (157.9384, 82.5526, 152.5336, 0.4010, -0.1034, 1.0, 12.4261,
              0.1000, 0.1578, -0.1509, 11.9186, 1.0, -0.0861, 6.0000, 1.0,
              0.0)),
)

# off-diagonal overrides: Ediss Ro gamma rsigma rpi rpi2 (-1 = keep default)
OFFDIAG = (
    ((1, 2), (0.1239, 1.4004, 9.8467, 1.1210, -1.0, -1.0)),
    ((2, 3), (0.0283, 1.2885, 10.9190, 0.9215, -1.0, -1.0)),
    ((1, 3), (0.1345, 1.7500, 9.7725, 1.2835, 1.1576, 1.0637)),
    ((1, 4), (0.1447, 1.7500, 9.7990, 1.3436, 1.1885, 1.1363)),
    ((2, 4), (0.0480, 1.5000, 10.3000, -1.0, -1.0, -1.0)),
    ((3, 4), (0.1048, 1.7000, 10.1575, -1.0, -1.0, -1.0)),
)

# valence angles i-j-k (j is the center):
#   theta00 ka kb pcoa1 pval7 ppen1 pval4
ANGLES = (
    ((1, 1, 1), (59.0573, 30.7029, 0.7606, 0.0, 0.7180, 6.2933, 1.1244)),
    ((1, 1, 2), (65.7758, 14.5234, 6.2481, 0.0, 0.5665, 0.0, 1.6255)),
    ((2, 1, 2), (70.2607, 25.2202, 3.7312, 0.0, 0.0050, 0.0, 2.7500)),
    ((1, 1, 3), (49.6811, 7.1713, 4.3889, 0.0, 0.7171, 10.2661, 1.0463)),
    ((3, 1, 3), (77.7473, 40.1718, 2.9802, -25.3063, 1.6170, -46.1315,
                 2.2503)),
    ((2, 1, 3), (65.0000, 14.2057, 4.8649, 0.0, 0.3504, 0.0, 1.7185)),
    ((1, 1, 4), (66.0000, 20.0000, 2.0000, 0.0, 0.5000, 0.0, 1.5000)),
    ((4, 1, 4), (68.0000, 30.0000, 1.5000, 0.0, 0.5000, 0.0, 1.2000)),
    ((2, 1, 4), (66.0000, 20.0000, 2.5000, 0.0, 0.5000, 0.0, 1.6000)),
    ((3, 1, 4), (70.0000, 30.0000, 1.5000, 0.0, 0.5000, 0.0, 1.2000)),
    ((1, 2, 1), (0.0, 3.4110, 7.7350, 0.0, 0.0, 0.0, 1.0400)),
    ((1, 2, 2), (0.0, 0.0, 6.0000, 0.0, 0.0, 0.0, 1.0400)),
    ((2, 2, 2), (0.0, 27.9213, 5.8635, 0.0, 0.0, 0.0, 1.0400)),
    ((1, 2, 3), (0.0, 25.0000, 3.0000, 0.0, 1.0000, 0.0, 1.0400)),
    ((3, 2, 3), (0.0, 15.0000, 2.8900, 0.0, 0.0, 0.0, 2.8774)),
    ((2, 2, 3), (0.0, 8.5744, 3.0000, 0.0, 0.0, 0.0, 1.0421)),
    ((1, 3, 1), (74.3994, 44.7500, 0.7982, 0.0, 3.0000, 0.0, 1.0528)),
    ((1, 3, 3), (77.9854, 36.6201, 2.0201, 0.0, 0.7434, 67.0264, 3.0000)),
    ((3, 3, 3), (80.7324, 30.4554, 0.9953, 0.0, 1.6310, 50.0000, 1.0783)),
    ((1, 3, 2), (71.5018, 21.7062, 0.4735, 0.0, 0.5186, 0.0, 1.1793)),
    ((2, 3, 3), (84.9468, 23.3540, 1.5057, 0.0, 2.6374, 0.0, 1.3023)),
    ((2, 3, 2), (77.0645, 10.4737, 1.2895, 0.0, 0.9924, 0.0, 1.1043)),
    ((1, 3, 4), (75.0000, 30.0000, 2.0000, 0.0, 1.0000, 0.0, 1.2000)),
    ((4, 3, 4), (75.0000, 30.0000, 2.0000, 0.0, 1.0000, 0.0, 1.2000)),
    ((2, 3, 4), (75.0000, 20.0000, 2.0000, 0.0, 1.0000, 0.0, 1.2000)),
    ((1, 4, 1), (70.0000, 25.0000, 2.0000, 0.0, 1.0000, 0.0, 1.2000)),
    ((1, 4, 4), (70.0000, 25.0000, 2.0000, 0.0, 1.0000, 0.0, 1.2000)),
    ((1, 4, 3), (70.0000, 25.0000, 2.0000, 0.0, 1.0000, 0.0, 1.2000)),
    ((4, 4, 3), (67.0000, 30.0000, 2.5000, 0.0, 1.0000, 0.0, 1.2000)),
    ((3, 4, 3), (67.0000, 35.0000, 2.0000, -18.0000, 1.0000, 20.0000,
                 1.5000)),
    ((4, 4, 4), (70.0000, 25.0000, 2.0000, 0.0, 1.0000, 0.0, 1.2000)),
    ((1, 4, 2), (70.0000, 15.0000, 2.5000, 0.0, 0.5000, 0.0, 1.2000)),
    ((2, 4, 2), (70.0000, 15.0000, 2.5000, 0.0, 0.5000, 0.0, 1.2000)),
    ((2, 4, 3), (70.0000, 15.0000, 2.5000, 0.0, 0.5000, 0.0, 1.2000)),
    ((2, 4, 4), (70.0000, 15.0000, 2.5000, 0.0, 0.5000, 0.0, 1.2000)),
)

# torsions i-j-k-l (0 = wildcard end): V1 V2 V3 ptor1 pcot1
TORSIONS = (
    ((1, 1, 1, 1), (-0.2500, 34.7453, 0.0288, -6.3507, -1.6000)),
    ((1, 1, 1, 2), (-0.2500, 29.2131, 0.2945, -4.9581, -2.1802)),
    ((2, 1, 1, 2), (-0.2500, 31.2081, 0.4539, -4.8923, -2.2677)),
    ((0, 1, 1, 0), (0.0000, 50.0000, 0.3000, -4.0000, -2.0000)),
    ((0, 1, 2, 0), (0.0, 0.0, 0.0, 0.0, 0.0)),
    ((0, 2, 2, 0), (0.0, 0.0, 0.0, 0.0, 0.0)),
    ((0, 1, 3, 0), (0.5511, 25.4150, 1.1330, -5.1903, -1.0000)),
    ((0, 2, 3, 0), (0.0, 0.1000, 0.0200, -2.5415, 0.0)),
    ((0, 3, 3, 0), (0.5000, 30.0000, 0.5000, -5.0000, -1.0000)),
    ((0, 1, 4, 0), (-0.5000, 40.0000, 0.4000, -6.0000, -2.0000)),
    ((0, 2, 4, 0), (0.0, 0.0, 0.0, 0.0, 0.0)),
    ((0, 3, 4, 0), (0.5000, 80.0000, 0.5000, -5.0000, -1.0000)),
    ((0, 4, 4, 0), (0.5000, 60.0000, 0.5000, -6.0000, -2.0000)),
)

# hydrogen bonds donor-H-acceptor: r0hb phb1 phb2 phb3
HBONDS = (
    ((3, 2, 3), (2.1200, -3.5800, 1.4500, 19.5000)),
    ((3, 2, 4), (2.0000, -3.0000, 1.4500, 19.5000)),
    ((4, 2, 3), (2.0000, -3.0000, 1.4500, 19.5000)),
    ((4, 2, 4), (2.0000, -3.0000, 1.4500, 19.5000)),
    ((1, 2, 3), (2.2000, -1.0000, 1.4500, 19.5000)),
    ((1, 2, 4), (2.2000, -1.0000, 1.4500, 19.5000)),
)

# ReaxFF-lg columns per type: rcore ecore acore (inner-core wall) and
# C_lg [kcal A^6/mol], Re_lg [A] (London dispersion)
LG = {
    "C": (2.0000, 0.0200, 10.0000, 650.0000, 1.9000),
    "H": (1.4000, 0.0100, 10.0000, 35.0000, 1.4500),
    "O": (1.8000, 0.0200, 10.0000, 300.0000, 1.8000),
    "N": (1.9000, 0.0200, 10.0000, 400.0000, 1.8500),
}

# PQEq core/shell parameters: X0 [eV] J0 [eV] Z Rc [A] Rs [A] Ks
# (C and H at the published PQEq1 values, O and N at their magnitudes)
PQEQ = (
    ("C", 5.50813, 9.81186, 1.0, 0.75900, 0.75900, 198.84054),
    ("H", 4.72484, 15.57338, 1.0, 0.37100, 0.37100, 2037.20061),
    ("O", 8.74100, 13.36400, 1.0, 0.66900, 0.66900, 375.00000),
    ("N", 6.89900, 11.76000, 1.0, 0.70000, 0.70000, 300.00000),
)

# molecule geometry [A, degrees]: ring C-N bond and chair pucker, C-H bond
# and H-C-H angle, N-N bond and its tilt below the ring plane, N-O bond
# and O-N-O angle.  These are the values at which a single molecule sits
# at the minimum of the table above (an isolated molecule built from them
# relaxes by about 0.03 kcal/mol/atom).
GEOM = {"cn": 1.449, "pucker": 0.155, "ch": 1.095, "hch": 110.8,
        "nn": 1.515, "tilt": 52.8, "no": 1.220, "ono": 120.6}

# the reference's conf/init.rdx cell: Z=8 molecules, orthorhombic
CELL = (13.18, 11.57, 10.71)
NMOL = 8


def _f9(vals):
    return "".join(f"{v:9.4f}" for v in vals)


def ffield_text(lg: bool = False) -> str:
    """The force field in the ReaxFF file layout `ffield.parse_ffield`
    reads (lg=True: the ReaxFF-lg layout)."""
    out = [HEADER + (" lg" if lg else ""),
           f"{len(GENERAL):3d}       ! Number of general parameters"]
    out += [f"{v:10.4f} !{c}" for v, c in GENERAL]
    out += [f"{len(ATOMS):3d}    ! Nr of atoms; cov.r; valency;a.m;Rvdw;"
            "Evdw;gammaEEM;cov.r2;#",
            "            alfa;gammavdW;valency;Eunder;Eover;chiEEM;etaEEM;"
            "n.u.",
            "            cov r3;Elp;Heat inc.;n.u.;n.u.;n.u.;n.u.",
            "            ov/un;val1;n.u.;val3,vval4"]
    for name, v in ATOMS:
        v = list(v)
        if lg:
            v[29:32] = LG[name][:3]
        out.append(f" {name:<2s}" + _f9(v[0:8]))
        for k in (8, 16, 24):
            out.append("   " + _f9(v[k:k + 8]))
        if lg:
            out.append("   " + _f9(LG[name][3:5]))
    out += [f"{len(BONDS):3d}      ! Nr of bonds; Edis1;LPpen;n.u.;pbe1;"
            "pbo5;13corr;pbo6",
            "                         pbe2;pbo3;pbo4;n.u.;pbo1;pbo2;ovcorr"]
    for (i, j), v in BONDS:
        out.append(f"{i:3d}{j:3d}" + _f9(v[:8]))
        out.append("      " + _f9(v[8:]))
    out.append(f"{len(OFFDIAG):3d}    ! Nr of off-diagonal terms; Ediss;Ro;"
               "gamma;rsigma;rpi;rpi2")
    names = [a for a, _ in ATOMS]
    for (i, j), v in OFFDIAG:
        extra = ()
        if lg:
            ci, cj = LG[names[i - 1]][3], LG[names[j - 1]][3]
            extra = (float(np.sqrt(ci * cj)),)
        out.append(f"{i:3d}{j:3d}" + _f9(v + extra))
    out.append(f"{len(ANGLES):3d}    ! Nr of angles;at1;at2;at3;Thetao,o;"
               "ka;kb;pv1;pv2")
    for (i, j, k), v in ANGLES:
        out.append(f"{i:3d}{j:3d}{k:3d}" + _f9(v))
    out.append(f"{len(TORSIONS):3d}    ! Nr of torsions;at1;at2;at3;at4;"
               ";V1;V2;V3;V2(BO);vconj;n.u;n")
    for (i, j, k, l_), v in TORSIONS:
        out.append(f"{i:3d}{j:3d}{k:3d}{l_:3d}" + _f9(v + (0.0, 0.0)))
    out.append(f"{len(HBONDS):3d}    ! Nr of hydrogen bonds;at1;at2;at3;"
               "Rhb;Dehb;vhb1")
    for (i, j, k), v in HBONDS:
        out.append(f"{i:3d}{j:3d}{k:3d}" + _f9(v))
    return "\n".join(out) + "\n"


def pqeq_text() -> str:
    out = ["# synthetic PQEq parameters (rxmd_tpu.tools.geninputs)",
           "# name P X0 J0 Z Rc Rs Ks",
           f"NPARMS {len(PQEQ)}"]
    for name, *v in PQEQ:
        out.append(f"{name:<2s} 1 " + " ".join(f"{x:12.5f}" for x in v))
    return "\n".join(out) + "\n"


def _unit(v):
    return v / np.linalg.norm(v)


def rdx_molecule():
    """One C3H6N6O6 molecule built from bond lengths and angles: a chair
    1,3,5-triazinane ring (C up, N down), two H on each C, an NO2 group on
    each ring N.  Returns (names (21,), xyz (21, 3)) centered on the ring."""
    d = np.deg2rad
    g = GEOM
    h = g["pucker"]
    R = np.sqrt(g["cn"] ** 2 - (2.0 * h) ** 2)
    ring = np.array([[R * np.cos(k * np.pi / 3), R * np.sin(k * np.pi / 3),
                      h if k % 2 == 0 else -h] for k in range(6)])
    names = ["C" if k % 2 == 0 else "N" for k in range(6)]
    xyz = list(ring)
    for k in range(6):
        p, a, b = ring[k], ring[k - 1], ring[(k + 1) % 6]
        out_ = _unit(2.0 * p - a - b)            # bisector, outward
        if k % 2 == 0:                           # CH2
            nrm = _unit(np.cross(b - p, a - p))
            half = d(g["hch"]) / 2.0
            for s in (1.0, -1.0):
                xyz.append(p + g["ch"] * (np.cos(half) * out_
                                          + s * np.sin(half) * nrm))
                names.append("H")
        else:                                    # N-NO2
            tilt = d(g["tilt"])
            ax = _unit(np.cos(tilt) * out_
                       - np.sin(tilt) * np.array([0.0, 0.0, 1.0]))
            nn = p + g["nn"] * ax
            xyz.append(nn)
            names.append("N")
            tng = _unit(b - a)
            tng = _unit(tng - np.dot(tng, ax) * ax)
            phi = d(g["ono"]) / 2.0
            for s in (1.0, -1.0):
                xyz.append(nn + g["no"] * (np.cos(phi) * ax
                                           + s * np.sin(phi) * tng))
                names.append("O")
    xyz = np.array(xyz)
    return np.array(names), xyz - xyz[:6].mean(axis=0)


def _rotation(rng):
    """Uniform random rotation (quaternion method)."""
    u1, u2, u3 = rng.random(3)
    q = np.array([np.sqrt(1 - u1) * np.sin(2 * np.pi * u2),
                  np.sqrt(1 - u1) * np.cos(2 * np.pi * u2),
                  np.sqrt(u1) * np.sin(2 * np.pi * u3),
                  np.sqrt(u1) * np.cos(2 * np.pi * u3)])
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _small_rotation(rng, angle):
    axis = _unit(rng.normal(size=3))
    t = angle * rng.normal()
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * K @ K


# closest allowed intermolecular contacts [A], indexed by the number of
# heavy (non-H) atoms in the pair: H-H, H-heavy, heavy-heavy.  A pair is
# also kept 0.3 A outside its sigma bond-order cutoff, so that no
# intermolecular pair starts near the cutoff, where ReaxFF's bond energy
# is discontinuous.
_CONTACT = np.array([2.1, 2.3, 2.8])
_BO_MARGIN = 0.3


def bond_cutoffs():
    """(nso, nso) sigma bond-order cutoff radii of the table above: where
    exp(pbo1 (r/r0)^pbo2) falls to 1e-3 (cf. ffield._finalize_cutoffs)."""
    names = [a for a, _ in ATOMS]
    rat = np.array([v[0] for _, v in ATOMS])
    r0 = 0.5 * (rat[:, None] + rat[None, :])
    for (i, j), v in OFFDIAG:
        if v[3] > 0.0:
            r0[i - 1, j - 1] = r0[j - 1, i - 1] = v[3]
    rc = np.zeros((len(names), len(names)))
    for (i, j), v in BONDS:
        pbo1, pbo2 = v[12], v[13]
        rc[i - 1, j - 1] = rc[j - 1, i - 1] = (
            r0[i - 1, j - 1] * (np.log(1e-3) / pbo1) ** (1.0 / pbo2))
    return rc


# the eight general positions of space group Pbca (x -> S x + t), the
# symmetry RDX crystallizes in; the generated cell shares only the symmetry
_PBCA = (((1, 1, 1), (0.0, 0.0, 0.0)), ((-1, -1, 1), (0.5, 0.0, 0.5)),
         ((-1, 1, -1), (0.0, 0.5, 0.5)), ((1, -1, -1), (0.5, 0.5, 0.0)),
         ((-1, -1, -1), (0.0, 0.0, 0.0)), ((1, 1, -1), (0.5, 0.0, 0.5)),
         ((1, -1, 1), (0.0, 0.5, 0.5)), ((-1, 1, 1), (0.5, 0.5, 0.0)))


def crystal(seed: int = 0):
    """Eight molecules in the orthorhombic cell: one molecule at a seeded
    random orientation and position, its seven Pbca images, then a seeded
    Monte-Carlo over that one molecule's rigid moves until no
    intermolecular contact is closer than its limit (up to 400 moves from
    each of up to 200 fresh seeded starts), and 400 more moves that push
    the contacts toward 0.2 A beyond their limits while keeping them.
    Returns (names (168,), frac (168, 3), cell)."""
    steps, restarts, spread = 400, 200, 400
    rng = np.random.default_rng(seed)
    L = np.array(CELL)
    names, mol = rdx_molecule()
    S = np.array([o[0] for o in _PBCA], float)
    T = np.array([o[1] for o in _PBCA])
    heavy = np.tile((names != "H").astype(int), NMOL)
    nat = len(names)
    tix = {a: k for k, (a, _) in enumerate(ATOMS)}
    ty = np.tile([tix[a] for a in names], NMOL)
    # by symmetry every molecule pair maps onto a pair with molecule 0
    lim = np.maximum(_CONTACT[heavy[:nat, None] + heavy[None, nat:]],
                     bond_cutoffs()[ty[:nat, None], ty[None, nat:]]
                     + _BO_MARGIN)

    def build(R, c):
        f0 = c + (mol @ R.T) / L
        return np.concatenate([f0 * S[k] + T[k] for k in range(NMOL)])

    def cost(R, c, pad=0.0):
        f = build(R, c)
        d = f[:nat, None] - f[None, nat:]
        d = (d - np.round(d)) * L
        r = np.sqrt((d * d).sum(-1))
        return float((np.maximum(lim + pad - r, 0.0) ** 2).sum())

    def move(R, c, a):
        return (_small_rotation(rng, a) @ R,
                c + a * rng.normal(size=3) / L)

    for _ in range(restarts):
        R, c = _rotation(rng), rng.random(3)
        co = cost(R, c)
        for s in range(steps):
            if co == 0.0:
                break
            R1, c1 = move(R, c, 0.3 * (1.0 - s / steps) + 0.02)
            co1 = cost(R1, c1)
            if co1 <= co:
                R, c, co = R1, c1, co1
        if co == 0.0:
            break
    else:
        raise RuntimeError(f"seed {seed}: no packing without close contacts")
    soft = cost(R, c, 0.2)
    for _ in range(spread):
        R1, c1 = move(R, c, 0.02)
        if cost(R1, c1) == 0.0:
            soft1 = cost(R1, c1, 0.2)
            if soft1 < soft:
                R, c, soft = R1, c1, soft1
    return (np.tile(names, NMOL), build(R, c) % 1.0,
            (CELL[0], CELL[1], CELL[2], 90.0, 90.0, 90.0))


def min_contact(frac, names, cell=CELL):
    """Shortest intermolecular distance per contact kind (diagnostic)."""
    L = np.array(cell[:3])
    pos = frac * L
    mol_id = np.repeat(np.arange(len(pos) // 21), 21)
    d = pos[:, None] - pos[None]
    d -= L * np.round(d / L)
    r = np.sqrt((d * d).sum(-1))
    inter = mol_id[:, None] != mol_id[None]
    heavy = names != "H"
    kind = heavy[:, None].astype(int) + heavy[None].astype(int)
    return {k: float(r[inter & (kind == k)].min()) for k in (0, 1, 2)}


def cell_text(names, frac, cell) -> str:
    out = [f"{len(names)}  synthetic C3H6N6O6 x8 cell "
           "(rxmd_tpu.tools.geninputs)",
           " ".join(f"{c:.6f}" for c in cell)]
    for nm, f in zip(names, frac):
        out.append(f"{nm:<2s} {f[0]:.8f} {f[1]:.8f} {f[2]:.8f}")
    return "\n".join(out) + "\n"


def deck_text() -> str:
    return "\n".join([
        "mdmode      1               <mdmode>",
        "time        0.25 200        <dt [fs]> <ntime_step>",
        "temperature 300.0 1.0 100   <treq [K]> <vsfact> <sstep>",
        "io_step     100 50          <fstep> <pstep>",
        "io_type     F F F F         <isBinary> <isBondFile> <isPDB> <isXYZ>",
        "processors  1 1 1           <vprocs>",
        "QEq         1 500 1.0d-7 1  <isQEq> <NMAXQEq> <QEq_tol> <qstep>",
        "exL         1.0 2.0         <Lex_fqs> <Lex_k>",
        "CG_tol      1.0d-6          <ftol>",
    ]) + "\n"


FILES = ("ffield", "ffield.lg", "pqeq1.par", "input.xyz", "rxmd.in")


def write_inputs(outdir: str, seed: int = 0) -> dict:
    """Write all inputs into `outdir`; returns {name: path}."""
    os.makedirs(outdir, exist_ok=True)
    names, frac, cell = crystal(seed)
    texts = {"ffield": ffield_text(), "ffield.lg": ffield_text(lg=True),
             "pqeq1.par": pqeq_text(), "input.xyz": cell_text(names, frac,
                                                              cell),
             "rxmd.in": deck_text()}
    paths = {}
    for name in FILES:
        paths[name] = os.path.join(outdir, name)
        with open(paths[name], "w") as fh:
            fh.write(texts[name])
    return paths


def load(mc=(1, 1, 1), dtype=np.float64, seed: int = 0):
    """(ForceField, State) of the generated cell replicated `mc` times."""
    import tempfile
    from .. import ffield, system
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_inputs(tmp, seed)
        ff = ffield.parse_ffield(paths["ffield"])
        st = system.from_cellfile(paths["input.xyz"], ff.name_to_type,
                                  mc=tuple(mc), dtype=dtype)
    return ff, st


def main(argv=None):
    p = argparse.ArgumentParser(prog="geninputs")
    p.add_argument("-o", "--outdir", default="inputs")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    paths = write_inputs(args.outdir, args.seed)
    print(f"geninputs: seed {args.seed} -> "
          + ", ".join(paths[k] for k in FILES))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
