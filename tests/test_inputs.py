"""The seeded input generator (rxmd_tpu.tools.geninputs): determinism, the
cell it builds, and stable NVE dynamics on it."""
import os

import numpy as np
import pytest

from rxmd_tpu import config, ffield, md, system
from rxmd_tpu.config import RunConfig
from rxmd_tpu.tools import geninputs


def test_generator_is_deterministic(tmp_path):
    a = geninputs.write_inputs(str(tmp_path / "a"), seed=0)
    b = geninputs.write_inputs(str(tmp_path / "b"), seed=0)
    c = geninputs.write_inputs(str(tmp_path / "c"), seed=1)
    for name in geninputs.FILES:
        assert open(a[name], "rb").read() == open(b[name], "rb").read()
    # the seed moves the molecules, never the force field
    assert open(a["ffield"]).read() == open(c["ffield"]).read()
    assert open(a["input.xyz"]).read() != open(c["input.xyz"]).read()


def test_cli_writes_every_file(tmp_path):
    assert geninputs.main(["-o", str(tmp_path), "--seed", "0"]) == 0
    assert sorted(os.listdir(tmp_path)) == sorted(geninputs.FILES)


def test_generated_cell(inputs):
    """Eight C3H6N6O6 molecules in RDX's cell at ~1.8 g/cm^3, with every
    intermolecular contact outside its limit."""
    ff = ffield.parse_ffield(inputs["ffield"])
    frac, types, cell = system.read_geninit_xyz(inputs["input.xyz"],
                                                ff.name_to_type)
    assert len(types) == 168
    counts = np.bincount(types, minlength=4)
    assert dict(zip(ff.atom_names, counts)) == {"C": 24, "H": 48, "O": 48,
                                                "N": 48}
    assert cell == (13.18, 11.57, 10.71, 90.0, 90.0, 90.0)
    rho = ff.mass[types].sum() / np.prod(cell[:3]) * 1.66053886
    assert 1.75 < rho < 1.85
    names = np.array(ff.atom_names)[types]
    got = geninputs.min_contact(frac, names)
    for kind, lim in enumerate(geninputs._CONTACT):
        assert got[kind] >= lim - 1e-6, (kind, got)


def test_deck_parses(inputs):
    cfg = config.parse_rxmd_in(inputs["rxmd.in"])
    assert (cfg.mdmode, cfg.dt_fs, cfg.isQEq, cfg.QEq_tol) == (1, 0.25, 1,
                                                               1e-7)
    assert cfg.vprocs == (1, 1, 1)


@pytest.fixture(scope="module")
def engine(inputs):
    ff = ffield.parse_ffield(inputs["ffield"])
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type)
    cfg = RunConfig(mdmode=1, dt_fs=0.25, pstep=10**6, sstep=10**6,
                    isQEq=1, QEq_tol=1e-7)
    eng = md.Engine(ff, st, cfg)
    eng.prepare()
    return eng


def test_every_energy_term_active(engine):
    """Bond, lone pair, over/under-coordination, valence, penalty,
    coalition, torsion, conjugation, hbond, vdW, Coulomb and charge
    energies are all nonzero on the generated cell."""
    comps = np.asarray(engine.comps) / engine.state.n
    assert (np.abs(comps[1:]) > 1e-4).all(), comps


def test_nve_stability(engine):
    """200 NVE steps at dt 0.25 fs from v=0 in f64: |TE(t) - TE(0)| stays
    under 1e-3 kcal/mol/atom at every step, with no list, row or cell
    overflow (the engine raises on any)."""
    eng = engine
    n = eng.state.n

    def te():
        s = eng.state
        ke = float((eng.hmas[s.types] * (s.vel * s.vel).sum(1)).sum())
        return (ke + float(eng.comps[0])) / n

    te0 = te()
    drift = []
    for _ in range(200):
        eng.run(1, log=None)
        drift.append(abs(te() - te0))
    assert max(drift) < 1e-3, max(drift)
    assert eng.timers.ncalls["neighbor rebuild"] >= 1
    for name, (used, cap) in eng.timers.peaks.items():
        assert used <= cap, (name, used, cap)
