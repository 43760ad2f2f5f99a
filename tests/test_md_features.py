"""Thermostats, extended-Lagrangian QEq, optimizer, trajectory output."""
import numpy as np
import pytest

from rxmd_tpu import ffield, system, md
from rxmd_tpu.config import RunConfig


@pytest.fixture(scope="module")
def paths(inputs):
    return inputs["ffield"], inputs["input.xyz"]


def _engine(paths, **kw):
    ff = ffield.parse_ffield(paths[0])
    st = system.from_cellfile(paths[1], ff.name_to_type)
    cfg = RunConfig(dt_fs=0.25, pstep=1000, **kw)
    return ff, st, md.Engine(ff, st, cfg)


@pytest.mark.slow
def test_berendsen_like_scaling_mdmode4(paths):
    """mdmode=4 velocity scaling by vsfact each sstep (ref: main.F90:45-46)."""
    ff, st, eng = _engine(paths, mdmode=4, vsfact=0.5, sstep=1, ntime_step=5,
                          isQEq=2)
    eng.prepare()
    eng.run(5, log=None)
    # with aggressive scaling the temperature stays near zero
    ke = float((eng.hmas[eng.state.types]
                * (eng.state.vel ** 2).sum(1)).sum()) / st.n
    assert ke < 1e-3


@pytest.mark.slow
def test_extended_lagrangian_tracks_cg(paths):
    """isQEq=2 charges stay close to the fully converged CG charges."""
    import jax.numpy as jnp
    from rxmd_tpu import neighbors, qeq, reax, units
    ff, st, eng = _engine(paths, mdmode=1, isQEq=2, ntime_step=5, sstep=1000)
    eng.prepare()
    eng.run(5, log=None)
    s = eng.state
    nbrs = eng._build_nbrs(s.pos, s.H, s.types)
    res = qeq.solve(s.pos, s.q, s.qsfp, s.H, s.types, eng.img, nbrs,
                    eng.ffd, tol=1e-8, nmax=500)
    dq = np.abs(np.asarray(res.q) - np.asarray(s.q)).max()
    assert dq < 5e-3


@pytest.mark.slow
def test_cg_optimizer_reduces_energy(paths):
    from rxmd_tpu import opt
    ff, st, eng = _engine(paths, mdmode=10, isQEq=1, ntime_step=1, sstep=1000)
    # perturb positions so there is something to minimize
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    import dataclasses
    eng.state = dataclasses.replace(
        eng.state, pos=eng.state.pos + jnp.asarray(
            rng.normal(scale=0.03, size=(st.n, 3))))
    e0 = None

    logs = []
    pe = opt.conjugate_gradient(eng, max_iter=3, ftol=1e-9,
                                log=logs.append)
    first = float(logs[0].split("PE0=")[1])
    assert pe < first


@pytest.mark.slow
def test_write_frame_formats(paths, tmp_path):
    ff, st, eng = _engine(paths, mdmode=1, isQEq=1, ntime_step=1, sstep=1000)
    eng.cfg.is_xyz = eng.cfg.is_pdb = eng.cfg.is_bondfile = True
    eng.cfg.is_binary = True
    eng.prepare()
    base = str(tmp_path / "frame")
    eng.write_frame(base)
    from rxmd_tpu.io import traj, refbin
    frames = list(traj.read_xyz_frames(base + ".xyz", ff.name_to_type))
    assert frames[0]["pos"].shape == (168, 3)
    st2, _ = refbin.read_rxff_bin(base + ".bin")
    assert st2.n == 168
    # bnd: every atom has >=1 strong bond; C has up to 4
    from rxmd_tpu.tools.bondlifetime import read_bnd
    rows = read_bnd(base + ".bnd")
    assert len(rows) == 168
    counts = [len(b) for _, _, b in rows]
    assert max(counts) >= 3 and min(counts) >= 1


@pytest.mark.slow
def test_timers_and_run_profile(paths, tmp_path):
    """Per-phase timing table + run-profile file (ref: it_timer
    module.F90:215-217, FinalizeMD main.F90:128-186, saveRunProfile
    module.F90:271-273)."""
    prof = tmp_path / "profile.dat"
    ff, st, eng = _engine(paths, mdmode=1, isQEq=2, ntime_step=4,
                          save_run_profile=True,
                          run_profile_path=str(prof))
    eng.run(4, log=None)
    lines = eng.summary()
    text = "\n".join(lines)
    assert "MD step (dispatch)" in text
    assert "QEq iterations" in text
    assert "first force (compile)" in text
    body = prof.read_text().splitlines()
    assert body[0].startswith("# step")
    assert len(body) >= 2  # at least steps 0 and 2 recorded


@pytest.mark.slow
def test_dense_direct_matches_ell_path(paths):
    """The dense minimum-image fast path (reax.qeq_dense_direct +
    reax.nonbond_dense: no gathers, dense matvecs) reproduces the gather-
    based ELL closed-form path: same charges, energies and forces after
    two steps on a box with min(L) > 2*rctap."""
    import jax.numpy as jnp
    import dataclasses
    ff = ffield.parse_ffield(paths[0])
    st = system.from_cellfile(paths[1], ff.name_to_type, mc=(2, 2, 2),
                              dtype=jnp.float32)

    def run(dd_max):
        cfg = RunConfig(mdmode=1, dt_fs=0.25, isQEq=1, QEq_tol=1e-7,
                        qstep=1, pstep=1000, sstep=10000, dtype="float32",
                        dense_direct_max=dd_max)
        eng = md.Engine(ff, st, cfg, dtype=jnp.float32)
        eng.prepare()
        eng.run(2, log=None)
        return eng

    e_ell = run(0)
    e_dd = run(8192)
    assert e_ell.dense_direct is False and e_dd.dense_direct is True
    c1 = np.asarray(e_ell.comps)
    c2 = np.asarray(e_dd.comps)
    n = st.n
    # identical physics, different summation order: f32 roundoff only.
    # Eclmb (12) and Echarge (13) co-move with the CG-iterate jitter in q
    # (|dq| up to 3e-3 is allowed below) and can individually drift
    # ~5e-4/atom while their SUM — the physical observable — cancels;
    # bound the sum and the q-independent components strictly.
    d = np.abs(c1 - c2) / n
    assert d[:12].max() < 2e-4, (c1 - c2) / n
    assert abs((c1[12] + c1[13]) - (c2[12] + c2[13])) / n < 2e-4, \
        (c1 - c2) / n
    assert d[12:].max() < 2e-3, (c1 - c2) / n
    # identical kernels (f64 agreement ~1e-12, see reax.qeq_dense_direct
    # check); f32 CG amplifies matvec reassociation to ~1e-3 in q
    assert np.abs(np.asarray(e_ell.state.q)
                  - np.asarray(e_dd.state.q)).max() < 3e-3
    f1 = np.asarray(e_ell.force)
    f2 = np.asarray(e_dd.force)
    assert np.abs(f1 - f2).max() < 5e-2, np.abs(f1 - f2).max()
    p1 = np.asarray(e_ell.state.pos)
    p2 = np.asarray(e_dd.state.pos)
    assert np.abs(p1 - p2).max() < 1e-4
