"""Analysis tools: g(r)/S(q)/angles, bond lifetime, geninit, LG parsing."""
import numpy as np
import pytest

from rxmd_tpu import ffield, system
from rxmd_tpu.tools import stat


@pytest.fixture(scope="module")
def crystal(inputs):
    ff = ffield.parse_ffield(inputs["ffield"])
    return ff, system.from_cellfile(inputs["input.xyz"], ff.name_to_type)


def test_gr_ideal_gas_like():
    """g(r) of a random (ideal-gas) configuration ~ 1 at large r."""
    rng = np.random.default_rng(0)
    box = np.array([20.0, 20.0, 20.0])
    pos = rng.uniform(0, 1, size=(600, 3)) * box
    types = np.zeros(600, np.int32)
    pa = stat.PairAnalysis(["X"], rcut=8.0, dr=0.2)
    pa.add_frame(pos, types, box)
    res = pa.results()
    mid = res["gr"][0, 0, 20:]   # r > 4 A
    assert abs(mid.mean() - 1.0) < 0.1


def test_gr_crystal_peaks(crystal):
    """C3H6N6O6 crystal g(r) has a C-H bond peak near 1.1 A and N-O near
    1.2."""
    ff, st = crystal
    box = np.array([13.18, 11.57, 10.71])
    pa = stat.PairAnalysis(ff.atom_names[:4], rcut=5.0, dr=0.05)
    pa.add_frame(np.asarray(st.pos), np.asarray(st.types), box)
    res = pa.results()
    r = res["r"]
    ch = res["gr"][1, 0]        # H-C
    no = res["gr"][3, 2]        # N-O
    assert r[np.argmax(ch)] < 1.3
    assert 1.0 < r[np.argmax(no)] < 1.5


def test_bond_angle_distribution(crystal):
    ff, st = crystal
    box = np.array([13.18, 11.57, 10.71])
    rcuts = {(a, b): 1.8 for a in range(4) for b in range(4)}
    hists = stat.bond_angle_distribution(np.asarray(st.pos),
                                         np.asarray(st.types), box, rcuts)
    # H-C-H angles around 109 deg exist in the CH2 groups
    key = (1, 0, 1)
    assert key in hists
    peak = np.argmax(hists[key]) * (180 / len(hists[key]))
    assert 90 < peak < 130


def test_lg_ffield_parses_and_tables(inputs):
    """ReaxFF-lg variant: dispersion+core tables (ref: init.F90:496-514)."""
    ff = ffield.parse_ffield(inputs["ffield.lg"], lg=True)
    assert ff.is_lg and ff.C_lg is not None
    assert (ff.C_lg.diagonal()[2:4] > 100).all()   # O,N dispersion coeffs
    tbl = ffield.build_tables(ff)
    assert np.isfinite(tbl["evdw"]).all()
    # the -C6/(r^6+d^6) dispersion makes the midrange tail more attractive
    # than the same field without the LG term
    ff.is_lg = False
    tbl0 = ffield.build_tables(ff)
    ff.is_lg = True
    b = ff.inxn2[2, 3]   # O-N
    k = 2500             # r^2 = 50 A^2 ~ 7.1 A
    assert tbl["evdw"][b, k] < tbl0["evdw"][b, k]


def test_geninit_roundtrip(inputs, tmp_path):
    from rxmd_tpu.tools import geninit
    out = str(tmp_path)
    geninit.main(["-i", inputs["input.xyz"],
                  "-f", inputs["ffield"], "-o", out,
                  "-mc", "2", "1", "1"])
    from rxmd_tpu.io import refbin
    st, meta = refbin.read_rxff_bin(out + "/rxff.bin")
    assert st.n == 336
    assert abs(meta["cell"][0] - 2 * 13.18) < 1e-6


def test_plot_tool(crystal, tmp_path):
    """Plot + csv tooling (ref: util/stat/plot.py, util/script/csv.py):
    one command turns stat output into the standard figures."""
    from rxmd_tpu.tools import plot
    ff, st = crystal
    box = np.array([13.18, 11.57, 10.71])
    pa = stat.PairAnalysis(ff.atom_names[:4], rcut=5.0, dr=0.1)
    pa.add_frame(np.asarray(st.pos), np.asarray(st.types), box)
    d = str(tmp_path)
    pa.save(gr_path=d + "/gr.dat", sq_path=d + "/sq.dat")
    types = np.asarray(st.types)
    rcuts = {(a, b): 1.8 for a in range(4) for b in range(4)}
    hists = stat.bond_angle_distribution(np.asarray(st.pos), types, box,
                                         rcuts)
    plot.write_ba_dat(hists, ff.atom_names, d + "/ba-bonds.dat")
    outs = plot.gr_plot(d) + plot.sq_plot(d) + plot.ba_plot(d)
    import os
    assert len(outs) >= 4           # gr, Gnr, snq, ba panels
    assert all(os.path.getsize(o) > 5000 for o in outs)
    csv = plot.to_csv(d + "/sq.dat")
    head = open(csv).readline().strip().split(",")
    assert head[0] == "wave_number" and head[1] == "Snq"
