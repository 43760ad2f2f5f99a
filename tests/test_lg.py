"""ReaxFF-lg (London dispersion + inner core) validation on the generated
lg ffield and cell (the reference's own lg deck is conf/init.rdx.lg).

The reference publishes no console trace for the lg variant, so validation
is built from independent internal implementations + invariants:
  - the r^2-interpolation tables (ffield.py, the reference's POTENTIALTABLE
    init.F90:496-514 re-derivation) vs the closed-form kernels
    (reax.cf_nonbond's is_lg branch) — two separate codings of the same
    physics;
  - FD force checks through the full energy with lg terms active;
  - dispersion lowers Evdw relative to the non-lg ffield on the same
    geometry;
  - a short NVE trajectory conserves energy.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rxmd_tpu import ffield, system, neighbors, reax, qeq, units, md
from rxmd_tpu.config import RunConfig



@pytest.fixture(scope="module")
def setup(inputs):
    ff = ffield.parse_ffield(inputs["ffield.lg"], lg=True)
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type)
    ffd = reax.ffdev_from(ff)
    img = neighbors.make_image_table(
        st.n, neighbors.nimg_for_cutoff(np.asarray(st.H), units.RCTAP0))
    nbrs = neighbors.build_neighbors_brute(
        st.pos, st.H, st.types, img, ffd.rc2b, ffd.rctap2, 20, 768)
    res = qeq.solve(st.pos, st.q, st.qsfp, st.H, st.types, img, nbrs, ffd,
                    tol=1e-8, nmax=500)
    return ff, st, ffd, img, nbrs, res.q


def test_lg_table_vs_closed_form(setup):
    """Two independent implementations of the lg vdW kernel agree."""
    _, st, ffd, img, nbrs, q = setup
    amask = jnp.ones(st.n, bool)
    ctx = reax.nb_ctx(st.pos, q, st.H, st.types, img, nbrs, st.gid,
                      amask, ffd)
    et = reax.nonbond_tbl_energy_forces(ctx, q, st.types, amask, ffd)
    ec = reax.nonbond_cf_energy_forces(ctx, q, st.types, amask, ffd)
    # evdw incl. dispersion+core: table lerp error only
    assert abs(float(et[0]) - float(ec[0])) < 5e-3 * abs(float(ec[0]))
    f_t, f_c = np.asarray(et[3]), np.asarray(ec[3])
    assert np.abs(f_t - f_c).max() < 5e-3 * np.abs(f_c).max()


def test_lg_dispersion_is_attractive(setup):
    """Toggling the lg branch off in the closed-form kernel isolates the
    dispersion+core contribution; the -C6/(r^6+d^6) dispersion dominates
    and must LOWER Evdw (ref: Elg term, init.F90:496-507)."""
    _, st, ffd, img, nbrs, q = setup
    amask = jnp.ones(st.n, bool)
    ctx = reax.nb_ctx(st.pos, q, st.H, st.types, img, nbrs, st.gid,
                      amask, ffd)
    e_full = reax.nonbond_cf_energy_forces(ctx, q, st.types, amask, ffd)
    ffd_nolg = ffd._replace(is_lg=False)
    e_nolg = reax.nonbond_cf_energy_forces(ctx, q, st.types, amask,
                                           ffd_nolg)
    disp = float(e_full[0]) - float(e_nolg[0])
    # molecular crystal: dispersion of order -1 to -20 kcal/mol/atom
    assert -30.0 < disp / st.n < -0.1, disp / st.n


def test_lg_fd_forces(setup):
    """The lg nonbond analytic derivative columns (dispersion + inner
    core) match FD of the closed-form energy — tight, since both sides
    are the same analytic function (no table lerp)."""
    _, st, ffd, img, nbrs, q = setup
    amask = jnp.ones(st.n, bool)

    def e_nb(p):
        ctx = reax.nb_ctx(p, q, st.H, st.types, img, nbrs, st.gid, amask,
                          ffd)
        evdw, eclmb, echg, _ = reax.nonbond_cf_energy_forces(
            ctx, q, st.types, amask, ffd)
        return float(evdw + eclmb)

    ctx = reax.nb_ctx(st.pos, q, st.H, st.types, img, nbrs, st.gid, amask,
                      ffd)
    _, _, _, f = reax.nonbond_cf_energy_forces(ctx, q, st.types, amask,
                                               ffd)
    f = np.asarray(f)
    h = 1e-5
    for (i, k) in [(3, 0), (60, 2), (100, 1)]:
        pp = st.pos.at[i, k].add(h)
        pm = st.pos.at[i, k].add(-h)
        fd = -(e_nb(pp) - e_nb(pm)) / (2 * h)
        assert abs(fd - f[i, k]) < 2e-5 * max(1.0, abs(fd)), (i, k, fd,
                                                             f[i, k])


@pytest.mark.slow
def test_lg_nve_conserves(inputs):
    """10-step NVE on the lg deck: total energy drift bounded."""
    ff = ffield.parse_ffield(inputs["ffield.lg"], lg=True)
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type)
    cfg = RunConfig(mdmode=1, dt_fs=0.25, ntime_step=10, isQEq=1,
                    QEq_tol=1e-7, qstep=1, pstep=100, sstep=10000)
    eng = md.Engine(ff, st, cfg)
    eng.prepare()
    te0 = float(eng.comps[0]) / st.n
    eng.run(10, log=None)
    s = eng.state
    ke = float(jnp.sum(eng.hmas[s.types] * jnp.sum(s.vel ** 2, axis=1)))
    te1 = (ke + float(eng.comps[0])) / s.n
    assert np.isfinite(te1)
    # the lg deck's cell is strained for this parametrization: starting
    # from v=0 the first ~10 steps show a few-mkcal TE oscillation that
    # recovers (verified identical with closed-form forces, so it is the
    # stiff transient, not force inconsistency); bound it loosely
    assert abs(te1 - te0) < 1e-2, (te0, te1)
