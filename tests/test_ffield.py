"""Force-field ingestion.

The generated ffield must parse back to the generator's own table
(rxmd_tpu.tools.geninputs), section by section.  Golden values of the
reference's nitramine ffield come from its console banner (ref:
README.md:127-155: atom ordering C,H,O,N,...; maxrc = 3.160 once cutoffs of
absent types are zeroed, ref: init.F90:404-416) and need the reference tree
(RXMD_REFERENCE_DIR).
"""
import os

import numpy as np
import pytest

from rxmd_tpu import ffield
from rxmd_tpu.tools import geninputs as gi


@pytest.fixture(scope="module")
def ff(inputs):
    return ffield.parse_ffield(inputs["ffield"])


@pytest.fixture(scope="module")
def ff_lg(inputs):
    return ffield.parse_ffield(inputs["ffield.lg"], lg=True)


def test_parse_basic(reference_dir):
    ff = ffield.parse_ffield(os.path.join(reference_dir, "ffield"))
    assert ff.nso == 7
    assert ff.atom_names == ["C", "H", "O", "N", "S", "Si", "X"]
    assert ff.header.startswith("Reactive MD-force field: nitramines")
    assert ff.nboty == 18


def test_cutoffs_match_reference_banner(reference_dir):
    ff = ffield.parse_ffield(os.path.join(reference_dir, "ffield"))
    # README.md:149 prints "maxrc, lcsize [A]: 3.160 ..." for the CHON-only
    # RDX system
    types_chon = np.array([0, 1, 2, 3])
    assert abs(ffield.effective_maxrc(ff, types_chon) - 3.160) < 1e-9


def test_masses_and_valences(ff):
    assert np.allclose(ff.mass[:4], [12.0, 1.008, 15.999, 14.0], atol=0.2)
    assert np.allclose(ff.Val[:4], [4.0, 1.0, 2.0, 3.0])
    # H has no pi bonds: switch(2:3) must be 0 for any pair involving H
    h = 1
    for j in range(4):
        b = ff.inxn2[h, j]
        assert ff.switch[b, 1] == 0.0 and ff.switch[b, 2] == 0.0


def test_eta_doubling_and_units(ff):
    # eta stored doubled (ref: param.F90:361); raw file values are ~6-10 eV
    assert (ff.eta[:4] > 10.0).all() and (ff.eta[:4] < 30.0).all()


def test_tables_smooth_at_cutoff(ff):
    tbl = ffield.build_tables(ff)
    # taper makes the kernels vanish at r = rctap
    assert np.allclose(tbl["evdw"][:, -1], 0.0, atol=1e-8)
    assert np.allclose(tbl["eclmb"][:, -1], 0.0, atol=1e-8)
    # and the Coulomb kernel is positive and decreasing in the midrange
    b = ff.inxn2[0, 0]
    mid = tbl["eclmb"][b, 100:4000]
    assert (mid > 0).all()
    assert (np.diff(mid) < 0).all()


def _t(i):
    return i - 1


@pytest.mark.parametrize("section", [
    "general", "atoms", "bonds", "offdiag", "angles", "torsions", "hbonds",
    "cutoffs"])
def test_roundtrip_generator_table(ff, section):
    """Each ffield section parses back to the generator's table."""
    assert ff.header == gi.HEADER
    names = [a for a, _ in gi.ATOMS]
    assert ff.atom_names == names
    if section == "general":
        v = {k + 1: x for k, (x, _) in enumerate(gi.GENERAL)}
        assert ff.vpar1 == v[1] and ff.vpar2 == v[2]
        assert ff.pvdW1 == v[29] and ff.vpar30 == v[30]
        assert (ff.plp1 == v[16]).all() and (ff.povun3 == v[33]).all()
        assert (ff.pval6 == v[15]).all() and (ff.ptor2 == v[24]).all()
    elif section == "atoms":
        for i, (_, v) in enumerate(gi.ATOMS):
            assert (ff.rat[i], ff.Val[i], ff.mass[i]) == v[0:3]
            assert ff.gam[i] == v[5] and ff.rapt[i] == v[6]
            assert ff.Vale[i] == v[7] and ff.chi[i] == v[13]
            assert ff.eta[i] == 2.0 * v[14]                # doubled
            assert ff.vnq[i] == v[16] and ff.plp2[i] == v[17]
            assert ff.povun2[i] == v[24] and ff.pval3[i] == v[25]
            assert ff.Valval[i] == v[27] and ff.pval5[i] == v[28]
    elif section == "bonds":
        assert ff.nboty == len(gi.BONDS)
        for (i, j), v in gi.BONDS:
            b = ff.inxn2[_t(i), _t(j)]
            assert b == ff.inxn2[_t(j), _t(i)] >= 0
            assert (ff.Desig[b], ff.Depi[b], ff.Depipi[b]) == v[0:3]
            assert (ff.pbe1[b], ff.pbo5[b], ff.pbo6[b]) == (v[3], v[4], v[6])
            assert (ff.pbe2[b], ff.pbo3[b], ff.pbo4[b]) == v[8:11]
            assert (ff.pbo1[b], ff.pbo2[b]) == v[12:14]
    elif section == "offdiag":
        for (i, j), v in gi.OFFDIAG:
            a, b = _t(i), _t(j)
            assert ff.Dij[a, b] == ff.Dij[b, a] == v[0]
            assert ff.rvdW[a, b] == 2.0 * v[1] and ff.alpij[a, b] == v[2]
            if v[3] > 0:
                assert ff.r0s[a, b] == v[3]
    elif section == "angles":
        assert ff.nvaty == len(gi.ANGLES)
        for (i, j, k), v in gi.ANGLES:
            a = ff.inxn3[_t(i), _t(j), _t(k)]
            assert a == ff.inxn3[_t(k), _t(j), _t(i)] >= 0
            assert np.isclose(ff.theta00[a], np.deg2rad(v[0]))
            assert (ff.pval1[a], ff.pval2[a], ff.pcoa1[a]) == v[1:4]
            assert (ff.pval7[a], ff.ppen1[a], ff.pval4[a]) == v[4:7]
    elif section == "torsions":
        assert ff.ntoty == len(gi.TORSIONS)
        for t, ((i, j, k, l_), v) in enumerate(gi.TORSIONS):
            assert (ff.V1[t], ff.V2[t], ff.V3[t]) == v[0:3]
            assert (ff.ptor1[t], ff.pcot1[t]) == v[3:5]
            if i > 0:
                assert ff.inxn4[_t(i), _t(j), _t(k), _t(l_)] == t
    elif section == "hbonds":
        assert ff.nhbty == len(gi.HBONDS)
        for h, ((i, j, k), v) in enumerate(gi.HBONDS):
            assert ff.inxn3hb[_t(i), _t(j), _t(k)] == h
            assert (ff.r0hb[h], ff.phb1[h], ff.phb2[h], ff.phb3[h]) == v
    else:
        # the generator's closed-form cutoffs agree with the parser's
        # incremental 0.01 A scan (ref: init.F90:363-418)
        rc = gi.bond_cutoffs()
        for (i, j), _ in gi.BONDS:
            b = ff.inxn2[_t(i), _t(j)]
            assert 0.0 <= ff.rc[b] - rc[_t(i), _t(j)] < 0.011


def test_roundtrip_lg_columns(ff, ff_lg):
    """The lg layout carries the same table plus the dispersion and
    inner-core columns."""
    for name in ("rat", "Val", "chi", "eta", "Desig", "pbo1", "V2", "r0hb"):
        assert np.array_equal(getattr(ff, name), getattr(ff_lg, name))
    for i, (a, _) in enumerate(gi.ATOMS):
        rcore, ecore, acore, c_lg, re_lg = gi.LG[a]
        assert ff_lg.Re_lg[i] == re_lg
        assert np.isclose(ff_lg.rcore[i, i], rcore)
        assert np.isclose(ff_lg.ecore[i, i], ecore)
        assert np.isclose(ff_lg.acore[i, i], acore)
        assert np.isclose(ff_lg.C_lg[i, i], c_lg)
