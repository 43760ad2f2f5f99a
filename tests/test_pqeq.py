"""PQEq (polarizable charge equilibration) validation.

The reference ships no golden trace for the PQEq deck, so validation is
built from first principles on the generated C3H6N6O6 cell and PQEq
parameters (rxmd_tpu.tools.geninputs; the reference's own deck is
examples/3-reaxpq+/{input.xyz,pqeq1.par,rxmd.in}):

  - parameter-file ingestion against the generator's table
  - FD force checks through the full PQEq energy (core/shell 4-term
    Coulomb, ref: ENbond_PQEq pot.F90:784-923)
  - FD check of the shell-relaxation force (ref: pqeq.F90:187-259)
  - CG solve invariants: charge neutrality, idempotency, convergence
  - eField force on shells (ref: pqeq.F90:205) and cores
    (ref: EEfield module.F90:359-383) with per-step momentum correction
    (ref: main.F90:70-71)
  - 2-device sharded PQEq trajectory match vs single device
"""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rxmd_tpu import ffield, system, neighbors, reax, pqeq, units, md
from rxmd_tpu.config import RunConfig
from rxmd_tpu.tools import geninputs

# caps for the 672-atom supercell (total flat-list sizes; hb is per donor)
CAPS = {"ang": 8192, "tor": 16384, "hb": 1536}


@pytest.fixture(scope="module")
def setup(inputs):
    ff = ffield.parse_ffield(inputs["ffield"])
    par = pqeq.parse_pqeq_par(inputs["pqeq1.par"])
    pqeq.apply_to_ff(ff, par)
    pq = pqeq.make_pqeq(par, dtype=jnp.float64)
    # 1x2x2 supercell (672 atoms, 13.2 x 23.1 x 21.4 A): every box
    # dimension exceeds the 12.5 A PQEq cutoff, so no atom interacts with
    # its own periodic image.  (The reference drops equal-global-id pairs
    # from ENbond_PQEq, pot.F90:813 l2g rule, but keeps them in the shell
    # force and hessian — force-vs-energy-gradient comparisons are only
    # clean when self-images are out of range.)
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type,
                              mc=(1, 2, 2))
    ffd = reax.ffdev_from(ff, rctap=units.RCTAP0_PQEQ)
    img = neighbors.make_image_table(
        st.n, neighbors.nimg_for_cutoff(np.asarray(st.H),
                                        units.RCTAP0_PQEQ))
    nbrs = neighbors.build_neighbors_brute(
        st.pos, st.H, st.types, img, ffd.rc2b, ffd.rctap2, 20, 2048)
    return ff, par, pq, st, ffd, img, nbrs


def test_parse_pqeq_par(setup):
    """The parameter file parses back to the generator's table
    (ref: cmdline.F90:168-236 parser)."""
    _, par, pq, *_ = setup
    table = np.array([row[1:] for row in geninputs.PQEQ])
    assert par["names"] == tuple(row[0] for row in geninputs.PQEQ)
    for k, key in enumerate(("X0", "J0", "Z", "Rc", "Rs", "Ks")):
        np.testing.assert_array_equal(par[key], table[:, k])
    # C and H carry the published PQEq1 values
    np.testing.assert_allclose(par["X0"][:2], [5.50813, 4.72484])
    np.testing.assert_allclose(par["Ks"][:2], [198.84054, 2037.20061])
    # screening alphas: symmetric combination rule (ref: module.F90:448-485)
    a = np.asarray(pq.alphacc)
    assert np.allclose(a, a.T)
    lam = units.LAMBDA_PQEQ
    acc = 0.5 * lam / 0.759 ** 2
    assert abs(a[0, 0] - np.sqrt(acc * acc / (acc + acc))) < 1e-12


def test_chi_eta_override(setup):
    """Polarizable types get X0 / 2*J0 chi/eta (ref: module.F90:502-523)."""
    ff, par, *_ = setup
    assert abs(ff.chi[0] - 5.50813) < 1e-12
    assert abs(ff.eta[0] - 2.0 * 9.81186) < 1e-12
    assert abs(ff.eta[1] - 2.0 * 15.57338) < 1e-12
    np.testing.assert_array_equal(ff.chi, par["X0"])
    np.testing.assert_array_equal(ff.eta, 2.0 * par["J0"])


def test_pqeq_kernel_tables_match_closed_form(setup):
    """Tabulated erf-screened kernels vs direct evaluation
    (ref: initialize_pqeq module.F90:537-612)."""
    import math
    _, _, pq, *_ = setup
    ctap = units.taper_coeffs(units.RCTAP0_PQEQ)
    for r in (1.3, 3.7, 8.2):
        dvec = jnp.asarray([[r, 0.0, 0.0]])
        got = float(pqeq.pqeq_kernels(pq, pq.pcc, jnp.asarray([0]),
                                      jnp.asarray([0]), dvec,
                                      jnp.asarray([True]))[0])
        a = float(pq.alphacc[0, 0])
        tap = sum(ctap[k] * r ** k for k in (0, 4, 5, 6, 7))
        want = math.erf(a * r) / r * tap
        assert abs(got - want) < 5e-4 * abs(want) + 1e-6


def test_fd_forces_full_pqeq_energy(setup):
    """Forces from the full PQEq energy (all ReaxFF terms + 4-term
    core/shell Coulomb) match central finite differences."""
    _, _, pq, st, ffd, img, nbrs = setup
    rng = np.random.default_rng(3)
    spos = jnp.asarray(rng.normal(scale=5e-3, size=(st.n, 3)))
    q = jnp.asarray(rng.normal(scale=0.05, size=st.n))
    q = q - q.mean()
    caps = CAPS

    comps, f = reax.energy_and_forces(
        st.pos, q, st.H, st.types, st.gid, img, nbrs, ffd, caps=caps,
        pq=pq, spos=spos)
    f = np.asarray(f)

    def etot(pos):
        return float(reax.total_energy(pos, q, st.H, st.types, st.gid,
                                       img, nbrs, ffd, caps=caps, pq=pq,
                                       spos=spos))

    h = 1e-5
    for i in (0, 7, 25):
        for ax in range(3):
            pp = st.pos.at[i, ax].add(h)
            pm = st.pos.at[i, ax].add(-h)
            fd = -(etot(pp) - etot(pm)) / (2 * h)
            # tolerance admits the r^2-table lerp kinks a central
            # difference can straddle (worst at the steep vdW wall of
            # bonded-distance pairs, which ReaxFF keeps in the nonbond
            # list); a wiring error would be orders of magnitude larger
            assert abs(fd - f[i, ax]) < 0.03 + 2.5e-3 * abs(fd), \
                (i, ax, fd, f[i, ax])


def test_shell_force_matches_energy_gradient(setup):
    """The shell-relaxation force (ref: pqeq.F90:197-238, Eqs. 37-38)
    equals -d/dspos of [shell spring + sc + ss screened Coulomb].

    The energy gradient is evaluated in CLOSED FORM (erf kernels, the
    analytic content of the reference's tables, module.F90:573-607) —
    the dpsc/dpss derivative tables lerp exactly this function, so the
    comparison is tight (unlike autodiff of the value-table lerp, whose
    piecewise slope differs by a few % at bonding distances)."""
    from jax.scipy.special import erf
    _, _, pq, st, ffd, img, nbrs = setup
    rng = np.random.default_rng(5)
    spos = jnp.asarray(rng.normal(scale=2e-3, size=(st.n, 3)))
    q = jnp.asarray(rng.normal(scale=0.05, size=st.n))
    q = q - q.mean()
    amask = jnp.ones(st.n, bool)

    sforce = np.asarray(pqeq.shell_forces(
        st.pos, spos, q, st.H, st.types, img, nbrs, pq, amask))

    pose = neighbors.ext_positions(st.pos, st.H, img)
    mask = nbrs.masknb
    idx = jnp.where(mask, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    ti, tj = st.types[:, None], st.types[oj]
    zi = pq.Z[st.types]
    zj = pq.Z[tj]
    qjc = jnp.where(mask, q[oj], 0.0) + zj
    polar_j = pq.is_polar[tj]
    ctap = units.taper_coeffs(units.RCTAP0_PQEQ)

    def kern(alpha, dvec, m):
        r2 = jnp.sum(dvec * dvec, axis=-1)
        m = m & (r2 <= pq.rctap2)
        r = jnp.sqrt(jnp.where(m, r2, 1.0))
        tap = (ctap[7] * r**7 + ctap[6] * r**6 + ctap[5] * r**5
               + ctap[4] * r**4 + ctap[0])
        return jnp.where(m, erf(alpha * r) / r * tap, 0.0)

    def etot_cf(sp):
        spose = sp[img.owner]
        shelli = st.pos + sp
        drsc = shelli[:, None, :] - pose[idx]
        drss = drsc - spose[idx]
        # full directed enumeration: sc appears once per row (its mirror
        # is the row-j cs term, which has no spos_i dependence... it does
        # via spose — covered because we sum ALL rows); ss appears twice
        esc = -units.CCLMB0 * kern(pq.alphasc[ti, tj], drsc, mask) \
            * zi[:, None] * qjc
        ess = 0.5 * units.CCLMB0 * kern(pq.alphass[ti, tj], drss,
                                        mask & polar_j) * zi[:, None] * zj
        espr = 0.5 * jnp.sum(pq.Ks[st.types] * jnp.sum(sp * sp, axis=-1))
        return jnp.sum(esc + ess) + espr

    want = -np.asarray(jax.grad(etot_cf)(spos))
    scale = np.abs(want).max()
    np.testing.assert_allclose(sforce, want, atol=2e-3 * scale)


def test_shell_displacement_cap(setup):
    """Per-call shell displacement is capped at 1e-3 A
    (ref: pqeq.F90:190,249-253)."""
    _, _, pq, st, ffd, img, nbrs = setup
    q = jnp.ones(st.n) * 0.2
    q = q - q.mean()
    spos = jnp.zeros((st.n, 3))
    amask = jnp.ones(st.n, bool)
    s1 = pqeq.update_shells(st.pos, spos, q, st.H, st.types, img, nbrs,
                            pq, amask)
    d = np.linalg.norm(np.asarray(s1 - spos), axis=1)
    assert d.max() <= 1e-3 + 1e-12


def test_pqeq_solve_invariants(setup):
    """Full CG solve: charge neutrality, convergence, idempotency
    (ref: pqeq.F90:99-167 termination semantics)."""
    _, _, pq, st, ffd, img, nbrs = setup
    q0 = jnp.zeros(st.n)
    spos0 = jnp.zeros((st.n, 3))
    q1, spos1, it1, est1 = pqeq.solve(
        st.pos, spos0, q0, q0, st.H, st.types, img, nbrs, ffd, pq,
        isqeq=1, nmax=500, tol=1e-9)
    q1 = np.asarray(q1)
    assert abs(q1.sum()) < 1e-9
    assert 0 < int(it1) < 500
    assert np.isfinite(float(est1))
    # electronegativity order: O (X0 8.7 eV) ends up more negative than
    # N (6.9 eV), which ends up more negative than H (4.7 eV)
    tys = np.asarray(st.types)
    qo, qn, qh = (q1[tys == t].mean() for t in (2, 3, 1))
    assert qo < qn < qh
    # restart from the converged charges (shells relaxed one step): same
    # charges.  Only the s vector is warm; t starts at zero in every solve
    # (ref: qeq.F90:39-48), so the restart saves no iterations here.
    q2, _, it2, _ = pqeq.solve(
        st.pos, spos1, jnp.asarray(q1), jnp.asarray(q1), st.H, st.types,
        img, nbrs, ffd, pq, isqeq=1, nmax=500, tol=1e-9)
    assert 0 < int(it2) <= int(it1) + 2
    assert np.abs(np.asarray(q2) - q1).max() < 5e-4


def test_shell_relaxation_fixed_point(setup):
    """Repeated solve calls drive the shell displacement to a fixed point
    (the reference relaxes one damped step per MD step)."""
    _, _, pq, st, ffd, img, nbrs = setup
    q = jnp.zeros(st.n)
    spos = jnp.zeros((st.n, 3))
    qs, qsfp = q, q
    deltas = []
    for _ in range(60):
        qs, spos_new, _, _ = pqeq.solve(
            st.pos, spos, qs, qs, st.H, st.types, img, nbrs, ffd, pq,
            isqeq=1, nmax=200, tol=1e-8)
        deltas.append(float(jnp.abs(spos_new - spos).max()))
        spos = spos_new
    assert deltas[-1] < 0.3 * deltas[0]
    assert deltas[-1] < 2e-4


def test_efield_moves_shells(setup):
    """eField adds -Z*E*Eev_kcal to the shell force along the field axis
    (ref: pqeq.F90:205); at equilibrium the extra displacement is
    -Z*E*Eev_kcal/Ks."""
    _, _, pq, st, ffd, img, nbrs = setup
    q = jnp.zeros(st.n)
    spos = jnp.zeros((st.n, 3))
    amask = jnp.ones(st.n, bool)
    s0 = pqeq.update_shells(st.pos, spos, q, st.H, st.types, img, nbrs,
                            pq, amask)
    # field weak enough that no displacement hits the 1e-3 A cap
    E0 = 0.005
    sE = pqeq.update_shells(st.pos, spos, q, st.H, st.types, img, nbrs,
                            pq, amask, efield_dir=0, efield_strength=E0)
    d = np.asarray(sE - s0)
    tys = np.asarray(st.types)
    z = np.asarray(pq.Z)[tys]
    ks = np.asarray(pq.Ks)[tys]
    want = -z * E0 * units.EEV_KCAL / ks
    np.testing.assert_allclose(d[:, 0], want, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(d[:, 1:], 0.0, atol=1e-14)


@pytest.mark.slow
def test_pqeq_md_runs_and_conserves(inputs):
    """The 3-reaxpq+ configuration (PQEq + eField) through md.Engine on
    the generated cell: runs, conserves energy reasonably, and keeps net
    momentum zero (per-step LinearMomentum under eField,
    ref: main.F90:70-71)."""
    ff = ffield.parse_ffield(inputs["ffield"])
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type,
                              mc=(1, 2, 2))
    cfg = RunConfig(mdmode=1, dt_fs=0.25, ntime_step=10, isQEq=1,
                    QEq_tol=1e-7, qstep=1, pstep=100, sstep=10000,
                    isPQEq=True, pqeq_parm_path=inputs["pqeq1.par"],
                    isEfield=True, eFieldDir=0, eFieldStrength=0.01)
    eng = md.Engine(ff, st, cfg)
    eng.prepare()
    te = []
    # the field exerts a net force -E*Sigma(q_i+Z_i) on the cores; without
    # the per-step LinearMomentum correction the net momentum would grow by
    # ~dt*|F_net| every step.  With it, only the final half-kick's impulse
    # remains: |p| <= dt/2 * |F_net|.
    zsum = st.n * 1.0                       # Z=1 for every type
    fnet = zsum * 0.01 * units.EEV_KCAL
    pbound = 0.75 * eng.dt * fnet            # dt/2 with 50% slack
    for _ in range(6):
        eng.run(1, log=None)
        s = eng.state
        ke = float(jnp.sum(eng.hmas[s.types] * jnp.sum(s.vel ** 2, axis=1)))
        te.append((ke + float(eng.comps[0])) / s.n)
        m = np.asarray(2.0 * eng.hmas)[np.asarray(s.types)]
        pmom = (m[:, None] * np.asarray(s.vel)).sum(axis=0)
        assert np.abs(pmom).max() < pbound, (pmom, pbound)
    assert np.isfinite(te).all()
    # eField does work on the charges (no energy term in the reference
    # either, module.F90:372); only a loose drift bound applies
    assert abs(te[-1] - te[0]) < 2e-2, te
    assert abs(float(eng.state.q.sum())) < 1e-6
    # shells actually polarized
    assert float(jnp.abs(eng.state.spos).max()) > 1e-6


@pytest.mark.slow
def test_pqeq_two_device_matches_single(inputs):
    """Sharded PQEq: 2-device domain-decomposed PQEq trajectory matches
    the single-device engine."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    from rxmd_tpu.parallel.engine import ShardedEngine
    ff = ffield.parse_ffield(inputs["ffield"])
    # 2x2x2 supercell (1344 atoms, 26.4 x 23.1 x 21.4 A) so each half-box
    # exceeds the 12.5 A PQEq skin on the split axis
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type,
                              mc=(2, 2, 2))
    cfg = RunConfig(mdmode=1, dt_fs=0.25, isQEq=1, QEq_tol=1e-10, qstep=1,
                    pstep=100, sstep=10000, isPQEq=True,
                    pqeq_parm_path=inputs["pqeq1.par"], qeq_dense_max=0)

    e1 = md.Engine(ff, st, cfg)
    e1.prepare()
    e1.run(2, log=None)
    s1 = e1.state

    e2 = ShardedEngine(ff, st, cfg, mesh_shape=(2, 1, 1),
                       devices=jax.devices()[:2])
    e2.prepare()
    e2.run(2)
    s2 = e2.to_state()

    assert s2.n == s1.n
    Hi = np.linalg.inv(np.asarray(st.H))
    f1 = (np.asarray(s1.pos) @ Hi.T) % 1.0
    f2 = (np.asarray(s2.pos) @ Hi.T) % 1.0
    d = np.abs(f1 - f2)
    d = np.minimum(d, 1.0 - d)
    assert d.max() < 5e-7, d.max()
    assert np.abs(np.asarray(s1.q) - np.asarray(s2.q)).max() < 1e-6
    assert np.abs(np.asarray(s1.spos) - np.asarray(s2.spos)).max() < 1e-7
