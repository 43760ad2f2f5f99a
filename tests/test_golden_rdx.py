"""End-to-end tests on the 168-atom cell.

Invariants (forces are the exact gradient, forces sum to zero, neighbor
counts of a dense molecular crystal) run on the generated C3H6N6O6 cell.
The golden digits come from the reference's RDX trace (ref:
README.md:156-159: positions from conf/init.rdx/input.xyz, v=0, q=0,
mdmode=1, dt=0.25 fs, QEq tol 1e-7) and run only against the reference's
own input files (RXMD_REFERENCE_DIR).
"""
import os

import numpy as np
import pytest

from rxmd_tpu import ffield, system, neighbors, reax, qeq, units, md
from rxmd_tpu.config import RunConfig


# ang/tor are TOTAL flat-list capacities (168 atoms: ~1k angles, ~2k
# torsion entries); hb is the per-donor capacity of the grid enumeration
CAPS = {"ang": 2048, "tor": 4096, "hb": 1024}


def _setup(ff_path, cell_path):
    ff = ffield.parse_ffield(ff_path)
    st = system.from_cellfile(cell_path, ff.name_to_type)
    ffd = reax.ffdev_from(ff)
    img = neighbors.make_image_table(
        st.n, neighbors.nimg_for_cutoff(np.asarray(st.H), units.RCTAP0))
    nbrs = neighbors.build_neighbors_brute(
        st.pos, st.H, st.types, img, ffd.rc2b, ffd.rctap2, 20, 768)
    return ff, st, ffd, img, nbrs


@pytest.fixture(scope="module")
def setup(inputs):
    return _setup(inputs["ffield"], inputs["input.xyz"])


@pytest.fixture(scope="module")
def golden(reference_dir):
    return _setup(os.path.join(reference_dir, "ffield"),
                  os.path.join(reference_dir, "conf/init.rdx/input.xyz"))


def test_neighbor_counts(setup):
    _, st, _, _, nbrs = setup
    mb, mnb = neighbors.check_overflow(nbrs)
    # dense molecular crystal: O(10) bonded, O(450) nonbonded at 10 A
    assert 6 <= mb <= 16
    assert 350 <= mnb <= 512


def test_step0_bonded_energies(golden):
    """Bonded terms are charge-independent -> checkable with q=0."""
    _, st, ffd, img, nbrs = golden
    comps = np.asarray(reax.energy_components(
        st.pos, st.q, st.H, st.types, st.gid, img, nbrs, ffd, caps=CAPS)) / st.n
    assert abs(comps[1] - (-136.8986)) < 2e-3          # Ebond -1.369E+02
    assert abs(comps[2:5].sum() - 1.287) < 2e-3        # Elp+Eover+Eunder
    assert abs(comps[5:8].sum() - (-1.362)) < 2e-3     # Eval+Epen+Ecoa
    assert abs(comps[8:10].sum() - 0.5208) < 2e-3      # Etors+Econj
    assert abs(comps[10] - (-1.398e-3)) < 2e-5         # Ehb


def test_step0_qeq_and_total(golden):
    _, st, ffd, img, nbrs = golden
    res = qeq.solve(st.pos, st.q, st.qsfp, st.H, st.types, img, nbrs, ffd,
                    tol=1e-7, nmax=500)
    q = np.asarray(res.q)
    assert abs(q.sum()) < 1e-10                        # charge neutrality
    assert 10 <= int(res.iters) <= 60                  # golden: 41
    comps = np.asarray(reax.energy_components(
        st.pos, res.q, st.H, st.types, st.gid, img, nbrs, ffd,
        caps=CAPS)) / st.n
    assert abs(comps[0] - (-98.2464)) < 2e-4           # total PE per atom
    assert abs(comps[11:14].sum() - 38.21) < 1e-2      # Evdw+Eclmb+Echarge


def test_forces_are_exact_gradient(setup):
    """Central finite differences vs autodiff, per energy component.

    Bonded terms are smooth -> tight tolerance.  The tabulated nonbonded
    kernels are piecewise-linear in r^2, so their FD check is loose (slope
    kinks of O(1e-5..1e-3) at table-cell boundaries are a property of the
    reference's tables, ref: init.F90:444-445, not of the gradient)."""
    import jax
    import jax.numpy as jnp
    _, st, ffd, img, nbrs = setup
    res = qeq.solve(st.pos, st.q, st.qsfp, st.H, st.types, img, nbrs, ffd,
                    tol=1e-8, nmax=500)
    q = res.q

    ecomp = jax.jit(lambda p: reax.energy_components(
        p, q, st.H, st.types, st.gid, img, nbrs, ffd, caps=CAPS))
    J = jax.jacrev(lambda p: ecomp(p))(st.pos)   # (14, N, 3)
    h = 1e-6
    for (i, k) in [(0, 0), (17, 1), (100, 2), (167, 0)]:
        dp = jnp.zeros_like(st.pos).at[i, k].set(h)
        fd = (np.asarray(ecomp(st.pos + dp))
              - np.asarray(ecomp(st.pos - dp))) / (2 * h)
        an = np.asarray(J)[:, i, k]
        for c in range(1, 11):       # bonded terms: tight
            assert abs(fd[c] - an[c]) < 1e-5 * max(1.0, abs(an[c])), (
                i, k, c, fd[c], an[c])
        for c in (11, 12):           # table terms: limited by lerp kinks
            assert abs(fd[c] - an[c]) < 2e-3 * max(1.0, abs(an[c])), (
                i, k, c, fd[c], an[c])


def test_forces_sum_to_zero(setup):
    _, st, ffd, img, nbrs = setup
    _, f = reax.energy_and_forces(st.pos, st.q, st.H, st.types, st.gid, img,
                                  nbrs, ffd, caps=CAPS)
    assert np.abs(np.asarray(f).sum(axis=0)).max() < 1e-9


@pytest.mark.slow
def test_nve_short_trajectory(reference_dir):
    """20-step NVE: total energy drift bounded like the reference trace
    (README.md:157-159 shows |dTE| <~ 2e-4 per 100 steps)."""
    ff = ffield.parse_ffield(os.path.join(reference_dir, "ffield"))
    st = system.from_cellfile(
        os.path.join(reference_dir, "conf/init.rdx/input.xyz"),
        ff.name_to_type)
    cfg = RunConfig(mdmode=1, dt_fs=0.25, ntime_step=20, pstep=100, sstep=1000)
    eng = md.Engine(ff, st, cfg)
    eng.prepare()
    pe0 = float(eng.comps[0]) / st.n
    assert abs(pe0 - (-98.2464)) < 2e-4
    eng.run(20, log=None)
    s = eng.state
    ke = float((eng.hmas[s.types] * (s.vel * s.vel).sum(1)).sum()) / s.n
    pe = float(eng.comps[0]) / s.n
    te = ke + pe
    assert abs(te - pe0) < 5e-4
