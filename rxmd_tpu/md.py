"""MD engine: velocity-Verlet + QEq cadence + thermostats + observables.

Single jitted step reproducing the reference main loop ordering exactly
(ref: main.F90:37-100): thermostat -> half kick -> extended-Lagrangian charge
DOF leapfrog -> drift -> [migration] -> QEq (every qstep) -> FORCE -> kinetic
stress -> half kick.  The whole step, including the QEq CG while-loop and the
neighbor rebuild, is one XLA computation; the host loop only handles printing
and I/O cadence.
"""
from __future__ import annotations

import functools
import time
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from . import units, qeq, reax, neighbors
from .config import RunConfig
from .ffield import ForceField
from .system import State
from .utils import Timers


def _round_up(x, m):
    return int(-(-x // m) * m)


def probe_capacities(ff: ForceField, state: State, ffd, rctap, dtype,
                     skin: float = 0.0, term_slack: float = 1.0,
                     term_margin: float = 0.0):
    """Measure neighbor and interaction-list occupancies of a configuration
    on this process's default device and derive padded static capacities
    (the analog of the reference's maxas headroom statistics,
    main.F90:128-146)."""
    import jax as _jax
    import numpy as _np
    H = _np.asarray(state.H)
    nimg = neighbors.nimg_for_cutoff(H, rctap + skin)
    rc2b_p = _np.asarray(ffd.rc2b)
    rc2b_p = jnp.asarray((_np.sqrt(rc2b_p) + skin) ** 2 * (rc2b_p > 0),
                         dtype)
    rctap2_p = jnp.asarray((rctap + skin) ** 2, dtype)
    dev = default_device()
    with _jax.default_device(dev):
        # operands must live on the probe device or the ops follow them
        state = _jax.device_put(state, dev)
        ffd = _jax.device_put(ffd, dev)
        rc2b_p = _jax.device_put(rc2b_p, dev)
        rctap2_p = _jax.device_put(rctap2_p, dev)
        img = neighbors.make_image_table(state.n, nimg, dtype)
        from .ffield import effective_maxrc
        maxrc = effective_maxrc(ff, _np.asarray(state.types))
        ortho = _np.allclose(H, _np.diag(_np.diag(H)))
        grid = None
        if ortho and state.n >= 400:
            L = _np.diag(H)
            grid = neighbors.make_cell_grid(
                -_np.asarray(nimg) * L, (1.0 + _np.asarray(nimg)) * L,
                max(maxrc + skin, 2.0), rctap + skin)

        def build(pkb, pknb):
            if grid is not None:
                pose = neighbors.ext_positions(state.pos, state.H, img)
                nbrs, _ = neighbors.build_neighbors_cells(
                    pose, jnp.ones(pose.shape[0], bool),
                    state.types[img.owner], grid, rc2b_p, rctap2_p,
                    pkb, pknb, nrows=state.n)
                return nbrs
            return neighbors.build_neighbors_brute(
                state.pos, state.H, state.types, img, rc2b_p, rctap2_p,
                pkb, pknb)

        probe = build(32, 2048)
        mb, mnb = neighbors.check_overflow(probe)
        kb = _round_up(int(mb * 1.5) + 2, 4)
        knb = min(_round_up(int(mnb * 1.3) + 8, 64), 4096)
        nbrs_skinned = build(kb, knb)
        # tight (no-skin) occupancies for the per-step compacted lists
        tight = neighbors.tighten(state.pos, state.H, state.types, img,
                                  nbrs_skinned, ffd.rc2b, ffd.rctap2,
                                  kb, knb)
        kb_t = _round_up(int(tight.cntb.max() * 1.3) + 2, 4)
        knb_t = min(_round_up(int(tight.cntnb.max() * 1.2) + 8, 64), 4096)
        tc = reax.term_counts(state.pos, state.H, state.types, state.gid,
                              img, nbrs_skinned, ffd, slack=term_slack,
                              margin=term_margin)
    # margins sized for EVOLVING dynamics, not the t=0 snapshot: on a 5k-
    # step 300 K RDX NVE run the angle/torsion counts crept +8% over the
    # first ps and the hbond candidate network grew past 1.4x (observed
    # 113.5k vs a 111.4k cap).  Flat-list memory is cheap; the reference
    # aborts on overflow just like we do (main.F90:402-407), so headroom
    # is pure robustness.
    caps = {"ang": _round_up(int(tc["ang"] * 1.5) + 64, 256),
            "tor": _round_up(int(tc["tor"] * 1.5) + 64, 512),
            "hb": max(_round_up(int(tc["hb"] * 1.8) + 2, 4), 4),
            "hbf": max(_round_up(int(tc["hbf"] * 1.8) + 64, 256), 256),
            "ks": _round_up(tc["degmax"] + 2, 2),
            "kh": max(_round_up(tc.get("h_slots", 4) + 1, 2), 2),
            "kb_t": kb_t, "knb_t": knb_t,
            # per-center maxima for the two-stage list pack (rowcap):
            # generous headroom — the staging table is cheap (n*rowcap
            # int32) and a row overflow aborts the run like a cap
            # overflow.  2.2x: per-center counts fluctuate much harder
            # than the system totals (a 5k-step 300 K NVE run tripped a
            # 1.6x hb_row around step 1000)
            "ang_row": _round_up(int(tc["ang_row"] * 2.2) + 8, 8),
            "tor_row": _round_up(int(tc["tor_row"] * 2.2) + 8, 8),
            "hb_row": max(_round_up(int(tc["hb"] * 2.2) + 16, 8), 16)}
    return kb, knb, caps


def default_device():
    """The device new arrays go to: the `jax.default_device` in effect,
    else this process's first device (in a multi-process world
    jax.devices()[0] may belong to another process)."""
    dev = jax.config.jax_default_device
    if isinstance(dev, str):
        return jax.local_devices(backend=dev)[0]
    return dev if dev is not None else jax.local_devices()[0]


def require_dtype(dtype):
    """Refuse a float64 run that JAX would silently compute in float32:
    float64 arrays exist only with `jax_enable_x64` on (the CLI turns it on
    for --dtype float64 before any array exists)."""
    if jnp.dtype(dtype) == jnp.float64 and not jax.config.jax_enable_x64:
        raise ValueError(
            "float64 requested but jax_enable_x64 is off, so every array "
            "would be float32: set JAX_ENABLE_X64=1 or call "
            "jax.config.update('jax_enable_x64', True) before building "
            "any array")


def _bond_table_from(bo, nbrs, gid, img, bo_cutoff):
    """(partner gids, bond orders, counts) rows compacted to the front
    (ref: WriteBND fileio.F90:27-148, BNDcutoff=0.3)."""
    keep = bo.mask & (bo.bo[..., 0] > bo_cutoff)
    idx = jnp.where(bo.mask, nbrs.idxb, 0)
    gids = jnp.where(keep, gid[img.owner[idx]], -1)
    order = jnp.argsort(~keep, axis=1, stable=True)
    gids = jnp.take_along_axis(gids, order, axis=1)
    bos = jnp.take_along_axis(jnp.where(keep, bo.bo[..., 0], 0.0), order,
                              axis=1)
    return gids, bos, keep.sum(axis=1)


def bond_table(ffd, state: State, ff: ForceField, bo_cutoff=0.3, kb=32,
               knb=64):
    """Engine-independent bond table for .bnd output on a host-ordered
    State (used by the sharded engine's gathered output path)."""
    from .ffield import effective_maxrc
    H = np.asarray(state.H)
    maxrc = effective_maxrc(ff, np.asarray(state.types))
    nimg = neighbors.nimg_for_cutoff(H, maxrc)
    img = neighbors.make_image_table(state.n, nimg, state.pos.dtype)
    rctap2 = jnp.asarray(maxrc * maxrc, state.pos.dtype)
    nbrs = neighbors.build_neighbors_brute(
        state.pos, state.H, state.types, img, ffd.rc2b, rctap2, kb, knb)
    bo = reax.bond_order(state.pos, state.H, state.types, img, nbrs, ffd)
    return _bond_table_from(bo, nbrs, state.gid, img, bo_cutoff)


class Engine:
    """Single-device MD engine (the multi-device engine shards this same
    step over a mesh — see parallel/)."""

    def __init__(self, ff: ForceField, state: State, cfg: RunConfig,
                 dtype=None):
        self.ff = ff
        self.cfg = cfg
        if cfg.mdmode == 0:
            cfg.isQEq = 1      # ref: init.F90:56-63
        self.dtype = dtype or jnp.dtype(cfg.dtype)
        require_dtype(self.dtype)
        rctap = units.RCTAP0_PQEQ if cfg.isPQEq else units.RCTAP0
        self.rctap = rctap
        self.pq = None
        if cfg.isPQEq:
            from . import pqeq as pqeq_mod
            par = pqeq_mod.parse_pqeq_par(cfg.pqeq_parm_path)
            pqeq_mod.apply_to_ff(ff, par)   # chi/eta overrides before ffdev
            self.pq = pqeq_mod.make_pqeq(par, dtype=self.dtype, rctap=rctap)
            tmax = int(np.asarray(state.types).max())
            if tmax >= self.pq.ntype:
                # PQEq params are matched to ffield types by row order
                # (ref: cmdline.F90:213-226); an atom type beyond the table
                # would silently gather-clamp — fail loudly instead
                raise ValueError(
                    f"atom type {tmax} has no PQEq parameters "
                    f"({self.pq.ntype} rows in {cfg.pqeq_parm_path})")
        self.ffd = reax.ffdev_from(ff, dtype=self.dtype, rctap=rctap)
        self.state = state.astype(self.dtype)

        # time step and derived constants (ref: init.F90:66-69,102-108)
        self.dt = cfg.dt_fs / units.UTIME
        self.lex_w2 = 2.0 * cfg.Lex_k / self.dt / self.dt
        self.dthm = jnp.asarray(self.dt * 0.5 / ff.mass, self.dtype)
        self.hmas = jnp.asarray(0.5 * ff.mass, self.dtype)
        self.treq_red = cfg.treq / units.UTEMP0

        # image table sized for the skinned taper cutoff
        H = np.asarray(state.H)
        nimg = neighbors.nimg_for_cutoff(H, rctap + cfg.nbr_skin)
        self.img = neighbors.make_image_table(state.n, nimg, self.dtype)

        # large orthogonal systems: O(N) cell-list neighbor search; small or
        # triclinic ones: brute force over the image set
        from .ffield import effective_maxrc
        maxrc = effective_maxrc(ff, np.asarray(state.types))
        ortho = np.allclose(H, np.diag(np.diag(H)))
        self.grid = None
        if ortho and state.n >= 400:
            L = np.diag(H)
            lo = -np.asarray(nimg) * L
            hi = (1.0 + np.asarray(nimg)) * L
            self.grid = neighbors.make_cell_grid(
                lo, hi, max(maxrc + cfg.nbr_skin, 2.0), rctap + cfg.nbr_skin)

        # auto-size neighbor capacities from the initial configuration with
        # headroom (the reference uses fixed caps MAXNEIGHBS/MAXNEIGHBS10,
        # module.F90:81-82; we measure and pad)
        # Verlet skin: neighbor lists are built with extended cutoffs and
        # reused for `rebuild_every` steps; the energy kernels re-check the
        # true cutoffs (bo.F90:65 / pot.F90:720 semantics preserved)
        self.skin = cfg.nbr_skin
        self.rebuild_every = cfg.rebuild_every
        # closed-form nonbond/QEq kernels in f32 production; interpolation
        # tables (bit-parity with the reference) in f64 validation
        self.closed_form = (cfg.nonbond_closed_form
                            if cfg.nonbond_closed_form is not None
                            else self.dtype == jnp.dtype(jnp.float32))
        rc2b = np.asarray(self.ffd.rc2b)
        rcb_ext = (np.sqrt(rc2b) + self.skin) ** 2 * (rc2b > 0)
        self.rc2b_ext = jnp.asarray(rcb_ext, self.dtype)
        self.rctap2_ext = jnp.asarray((rctap + self.skin) ** 2, self.dtype)

        # many-body list caching: slackened gates at build, exact live gates
        # at evaluate; staleness bounded by the drift-triggered rebuild.
        # (Incompatible with per-step list tightening, which renumbers the
        # neighbor slots the cached lists index into.)
        self.term_cache = cfg.term_cache and not cfg.tighten_lists
        self.term_slack = cfg.term_slack if self.term_cache else 1.0
        self.term_margin = cfg.term_margin if self.term_cache else 0.0
        kb, knb, self.caps = probe_capacities(ff, self.state, self.ffd,
                                              rctap, self.dtype,
                                              skin=self.skin,
                                              term_slack=self.term_slack,
                                              term_margin=self.term_margin)
        self.kb = cfg.kb_cap or kb
        self.knb = cfg.knb_cap or knb
        # dense minimum-image fast path: replaces the gather-bound ELL
        # QEq matvecs and nonbond sweep with (n,n) elementwise work and
        # matmuls (see reax.qeq_dense_direct / reax.nonbond_dense).
        # Requires an orthogonal box with min(L) > 2*rctap so every pair
        # has a unique minimum image; O(n^2) caps it at
        # cfg.dense_direct_max.
        L = np.diag(H)
        self.dense_direct = bool(
            self.closed_form and self.pq is None and ortho
            and float(L.min()) > 2.0 * rctap
            and state.n <= cfg.dense_direct_max)

        # rebuild trigger: pair lists are valid while drift < skin/2, cached
        # term lists while drift < term_margin/2 (ref rebuilds every step,
        # pot.F90:30-34; the monitor makes the reuse provably safe)
        lim = self.skin
        if self.term_cache and self.term_margin > 0.0:
            lim = min(lim, self.term_margin)
        self.drift_trigger = 0.5 * lim
        # drift-monitor polling cadence: each poll is a device->host scalar
        # read, which stalls the dispatch pipeline
        self.drift_check_from = 4
        self.drift_check_every = 2

        # spring restraints toward the initial configuration
        # (ref: SpringForce pot.F90:95-110, ipos init.F90:231-232)
        self.ipos = self.state.pos if cfg.spring_const else None
        self._spring_mask = (
            jnp.isin(self.state.types,
                     jnp.asarray(list(cfg.spring_types), jnp.int32))
            if cfg.spring_const and cfg.spring_types
            else jnp.ones((state.n,), bool))

        self._step_fn = self._make_step()
        self._step = jax.jit(self._step_fn)
        self._prepare = jax.jit(self._make_prepare())
        self._rebuild = self._make_rebuild()   # split multi-program rebuild
        # multi-step blocks: K steps per dispatch via lax.scan, so each
        # dispatch and host read is paid once per K steps.  One block size
        # → one extra compile.  Blocks end exactly on print/write/
        # thermostat/rebuild boundaries so the host-side cadence logic is
        # unchanged.
        self.block_steps = max(int(cfg.block_steps), 1)
        self._mstep = None

        # per-phase wall-clock accounting (ref: it_timer module.F90:215-217,
        # FinalizeMD report main.F90:128-186)
        self.timers = Timers()

    # ------------------------------------------------------------------
    def _tight_nbrs(self, pos, H, types, nbrs):
        """Per-step compaction of the skinned lists to the true cutoffs
        (optional: the energy kernels re-check the true cutoffs themselves,
        and the compaction's sorts/gathers may cost more than the ~1.4x
        larger term shapes save)."""
        if not self.cfg.tighten_lists:
            return nbrs
        return neighbors.tighten(pos, H, types, self.img, nbrs,
                                 self.ffd.rc2b, self.ffd.rctap2,
                                 self.caps["kb_t"], self.caps["knb_t"])

    def _build_nbrs(self, pos, H, types, with_occupancy=False):
        """Neighbor lists with the Verlet-skin-extended cutoffs
        (with_occupancy: also the fullest cell's atom count, 0 without a
        cell grid)."""
        occ = jnp.int32(0)
        if self.grid is not None:
            pose = neighbors.ext_positions(pos, H, self.img)
            valid = jnp.ones(pose.shape[0], bool)
            nbrs, occ = neighbors.build_neighbors_cells(
                pose, valid, types[self.img.owner], self.grid, self.rc2b_ext,
                self.rctap2_ext, self.kb, self.knb, nrows=pos.shape[0],
                row_chunk=(self.cfg.list_chunk
                           if 0 < self.cfg.list_chunk < pos.shape[0] else 0))
        else:
            nbrs = neighbors.build_neighbors_brute(
                pos, H, types, self.img, self.rc2b_ext, self.rctap2_ext,
                self.kb, self.knb)
        return (nbrs, occ) if with_occupancy else nbrs

    def path_names(self):
        """(pair path, QEq path) this engine runs, as the run banner
        prints them."""
        cfg = self.cfg
        if self.dense_direct:
            return "dense minimum-image", "dense minimum-image"
        pair = "ELL gather" + (" (closed form)" if self.closed_form
                               else " (tables)")
        if self.pq is not None:
            return pair, "PQEq ELL gather"
        if cfg.isQEq == 0:
            return pair, "off"
        if cfg.isQEq == 1 and self.state.n <= cfg.qeq_dense_max:
            return pair, "dense matrix from ELL"
        return pair, "ELL gather"

    def _wrap(self, pos, H):
        """Wrap positions into the primary cell (the reference keeps
        coordinates in-box through migration PBC shifts, comm.F90:531-548)."""
        Hi = jnp.linalg.inv(H)
        frac = (pos @ Hi.T) % 1.0
        return frac @ H.T

    def _qeq_step(self, pos, q, qsfp, qsfv, H, types, nbrs, isqeq=None,
                  spos=None, pre=None):
        cfg = self.cfg
        isqeq = cfg.isQEq if isqeq is None else isqeq
        if isqeq == 0:
            return q, qsfp, qsfv, jnp.int32(0), spos
        if self.pq is not None:
            from . import pqeq as pqeq_mod
            qn, spos_n, iters, _ = pqeq_mod.solve(
                pos, spos, q, qsfp, H, types, self.img, nbrs, self.ffd,
                self.pq, isqeq=isqeq, nmax=cfg.NMAXQEq, tol=cfg.QEq_tol,
                lex_fqs=cfg.Lex_fqs,
                efield_dir=cfg.eFieldDir if cfg.isEfield else None,
                efield_strength=cfg.eFieldStrength)
            if isqeq == 1:
                return qn, q, jnp.zeros_like(qsfv), iters, spos_n
            return qn, qsfp, qsfv, iters, spos_n
        res = qeq.solve(pos, q, qsfp, H, types, self.img, nbrs, self.ffd,
                        isqeq=isqeq, nmax=cfg.NMAXQEq, tol=cfg.QEq_tol,
                        lex_fqs=cfg.Lex_fqs, pre=pre,
                        closed_form=self.closed_form,
                        dense_max=cfg.qeq_dense_max,
                        direct=self.dense_direct)
        if isqeq == 1:
            # fictitious charges re-seeded from pre-QEq q (ref: qeq.F90:42-43)
            return res.q, q, jnp.zeros_like(qsfv), res.iters, spos
        return res.q, qsfp, qsfv, res.iters, spos

    def _forces(self, pos, q, H, types, gid, nbrs, spos=None, lists=(),
                with_virial=False, ctx=None, rows_pre=None,
                external_nonbond=None):
        out = reax.energy_and_forces(pos, q, H, types, gid, self.img,
                                     nbrs, self.ffd, caps=self.caps,
                                     pq=self.pq, spos=spos,
                                     lists=lists or None,
                                     with_virial=with_virial,
                                     closed_form=self.closed_form,
                                     ctx=ctx, rows_pre=rows_pre,
                                     external_nonbond=external_nonbond)
        comps, f = out[0], out[1]
        w = out[2] if with_virial else None
        f_extra = None
        if self.cfg.isEfield:
            # constant-field force on core charges (ref: module.F90:359-383)
            qc = q
            if self.pq is not None:
                qc = q + self.pq.Z[types]   # ref: EEfield module.F90:374-378
            fe = -qc * self.cfg.eFieldStrength * units.EEV_KCAL
            f_extra = jnp.zeros_like(f).at[:, self.cfg.eFieldDir].add(fe)
        if self.cfg.spring_const:
            # harmonic restraint toward the initial positions
            # (ref: SpringForce pot.F90:95-110)
            fs = -self.cfg.spring_const * (pos - self.ipos)
            fs = jnp.where(self._spring_mask[:, None], fs, 0.0)
            f_extra = fs if f_extra is None else f_extra + fs
        if f_extra is not None:
            f = f + f_extra
            if with_virial:
                # reference includes every force in the Σ pos·f stress
                # accumulation (pot.F90:60-72)
                w = w + jnp.einsum("ia,ib->ab", f_extra, pos)
        if with_virial:
            return comps, f, w
        return comps, f

    def _thermostat(self, s: State, do_scale):
        """mdmode-dispatched velocity scaling (ref: main.F90:45-61)."""
        cfg = self.cfg
        v = s.vel
        if cfg.mdmode == 4:
            v = jnp.where(do_scale, cfg.vsfact * v, v)
        elif cfg.mdmode == 5:
            ke = jnp.sum(self.hmas[s.types] * jnp.sum(v * v, axis=1))
            gke = ke / s.n
            ctmp = (self.treq_red * units.UTEMP0) / (gke * units.UTEMP)
            v = jnp.where(do_scale, jnp.sqrt(ctmp) * v, v)
        elif cfg.mdmode == 7:
            # per-element rescale to treq (ref: main.F90:722-763)
            nso = self.hmas.shape[0]
            cnt = jnp.zeros(nso, v.dtype).at[s.types].add(1.0)
            ket = jnp.zeros(nso, v.dtype).at[s.types].add(
                self.hmas[s.types] * jnp.sum(v * v, axis=1))
            ctmp = jnp.where(cnt > 1.0, ket / jnp.maximum(cnt, 1.0), 1.0)
            fac = jnp.where(
                cnt > 1.0,
                jnp.sqrt((self.treq_red * units.UTEMP0) / (ctmp * units.UTEMP)),
                0.0)
            v2 = fac[s.types][:, None] * v
            v2 = self._zero_momentum(s.types, v2)
            v = jnp.where(do_scale, v2, v)
        elif cfg.mdmode == 8:
            # rescale only if >5% off target (ref: main.F90:684-718)
            ke = jnp.sum(self.hmas[s.types] * jnp.sum(v * v, axis=1)) / s.n
            ctmp = jnp.sqrt((self.treq_red * units.UTEMP0) / (ke * units.UTEMP))
            need = jnp.abs(ctmp - 1.0) > 0.05
            v2 = self._zero_momentum(s.types, ctmp * v)
            v = jnp.where(do_scale & need, v2, v)
        return dataclasses.replace(s, vel=v)

    def _zero_momentum(self, types, v):
        """Remove center-of-mass momentum (ref: main.F90:766-797)."""
        m = (2.0 * self.hmas)[types]
        vcm = jnp.sum(m[:, None] * v, axis=0) / jnp.sum(m)
        return v - vcm[None, :]

    def remove_angular_momentum(self):
        """Remove rigid rotation about the center of mass: subtract
        (I^-1 L) x r from every velocity (the intended behavior of the
        reference's `angular_momentum`, main.F90:480-553; that routine is
        dead code there — never called — and its accumulation loops are
        broken, so we implement the physics it documents, not its bugs)."""
        s = self.state
        m = (2.0 * self.hmas)[s.types]
        com = jnp.sum(m[:, None] * s.pos, axis=0) / jnp.sum(m)
        dr = s.pos - com
        L = jnp.sum(m[:, None] * jnp.cross(dr, s.vel), axis=0)
        r2 = jnp.sum(dr * dr, axis=1)
        inert = (jnp.eye(3, dtype=s.pos.dtype) * jnp.sum(m * r2)
                 - jnp.einsum("i,ia,ib->ab", m, dr, dr))
        omega = jnp.linalg.solve(inert, L)
        self.state = dataclasses.replace(
            self.state, vel=s.vel - jnp.cross(omega[None, :], dr))

    # ------------------------------------------------------------------
    def _make_rebuild(self):
        """Wrap positions into the box, rebuild the skinned neighbor lists,
        and rebuild the cached many-body interaction lists (slackened gates;
        see build_angle_list/build_torsion_list).  Called on the rebuild
        cadence or when the drift monitor trips; between rebuilds the
        positions evolve unwrapped so the stale image assignments stay
        geometrically consistent.

        The rebuild is SPLIT into several independently-jitted programs
        (nbrs / bond-order / each list build), which bounds each program's
        peak memory and compile time at large N.  Rebuilds run every
        ~25-40 steps, the dispatches are enqueued asynchronously, and no
        host read sits between them."""
        def wrap_nbrs(pos0, H, types):
            pos = self._wrap(pos0, H)
            return (pos, *self._build_nbrs(pos, H, types,
                                           with_occupancy=True))

        jwrap_nbrs = jax.jit(wrap_nbrs)
        jbo = jax.jit(lambda pos, H, types, nbrs: reax.bond_order(
            pos, H, types, self.img, nbrs, self.ffd))
        jang = jax.jit(lambda types, nbrs, bo: reax.build_angle_list(
            types, self.img, nbrs, bo, jnp.ones(bo.mask.shape[0], bool),
            self.ffd, cap=self.caps["ang"], ks=self.caps["ks"],
            slack=self.term_slack, margin=self.term_margin,
            rowcap=self.caps.get("ang_row", 0)))
        # row-chunked torsion/hbond builds above list_chunk atoms:
        # chunking is bit-identical and bounds peak memory
        chunk = (self.cfg.list_chunk
                 if 0 < self.cfg.list_chunk < self.state.n else 0)
        jtor = jax.jit(lambda types, gid, nbrs, bo: reax.build_torsion_list(
            types, gid, self.img, nbrs, bo,
            jnp.ones(bo.mask.shape[0], bool), self.ffd,
            cap=self.caps["tor"], ks=self.caps["ks"],
            slack=self.term_slack, margin=self.term_margin,
            rowcap=self.caps.get("tor_row", 0), chunk=chunk))
        jhb = jax.jit(lambda pos, H, types, nbrs, bo: reax.build_hbond_list(
            pos, H, types, self.img, nbrs, bo,
            jnp.ones(bo.mask.shape[0], bool), self.ffd,
            cap=self.caps["hbf"], kh=self.caps["kh"],
            slack=self.term_slack, margin=self.term_margin,
            rowcap=self.caps.get("hb_row", 0), chunk=chunk))

        def rebuild(s: State):
            pos, nbrs, self._cell_occ = jwrap_nbrs(s.pos, s.H, s.types)
            lists = ()
            if self.term_cache:
                bo = jbo(pos, s.H, s.types, nbrs)
                al = jang(s.types, nbrs, bo)
                tl = jtor(s.types, s.gid, nbrs, bo)
                hl = jhb(pos, s.H, s.types, nbrs, bo)
                lists = (al, tl, hl)
            return dataclasses.replace(s, pos=pos), nbrs, lists
        return rebuild

    def _make_prepare(self):
        """Initial QEq + FORCE before the main loop (ref: main.F90:27-32)."""
        def prepare(s: State, nbrs, lists):
            nbrs = self._tight_nbrs(s.pos, s.H, s.types, nbrs)
            # cold-start extended Lagrangian: one full CG solve to seed the
            # fictitious charge DOF (production restarts load qsfp from the
            # checkpoint instead, ref: fileio.F90:534-535)
            isq = 1 if self.cfg.isQEq == 2 else None
            q, qsfp, qsfv, nq, spos = self._qeq_step(
                s.pos, s.q, s.qsfp, s.qsfv, s.H, s.types, nbrs, isqeq=isq,
                spos=s.spos)
            if self.cfg.isQEq == 2:
                qsfp, qsfv = q, jnp.zeros_like(qsfv)
            ext_nb = None
            if self.dense_direct:
                ext_nb = (*reax.nonbond_dense(
                    s.pos, q, s.H, s.types,
                    jnp.ones(s.pos.shape[0], bool), self.ffd), None)
            comps, f = self._forces(s.pos, q, s.H, s.types, s.gid, nbrs,
                                    spos=spos, lists=lists,
                                    external_nonbond=ext_nb)
            s = dataclasses.replace(s, q=q, qsfp=qsfp, qsfv=qsfv, spos=spos)
            return s, f, comps, nq
        return prepare

    def _make_step(self):
        cfg = self.cfg
        dt = self.dt

        def step(s: State, f, nbrs, lists, pos_ref, astr):
            do_scale = (s.step % cfg.sstep) == 0
            s = self._thermostat(s, do_scale)

            # first half kick (ref: main.F90:64, vkick main.F90:192-207)
            v = s.vel + self.dthm[s.types][:, None] * f
            # extended-Lagrangian charge DOF leapfrog (ref: main.F90:67-68)
            qsfv = s.qsfv + 0.5 * dt * self.lex_w2 * (s.q - s.qsfp)
            qsfp = s.qsfp + dt * qsfv
            if cfg.isEfield:
                # the field pumps net momentum into the charged system;
                # correct it every step (ref: main.F90:70-71)
                v = self._zero_momentum(s.types, v)
            # drift (ref: main.F90:72); wrapping happens at list rebuilds
            pos = s.pos + dt * v

            nbrs = self._tight_nbrs(pos, s.H, s.types, nbrs)
            # ONE pair context + table-row gather per step, shared by the
            # QEq hessian and the nonbond force kernel (both walk the same
            # pair list — the analog of the reference reusing nbplist)
            ctx = rows_pre = None
            if self.pq is None and not self.dense_direct:
                amask = jnp.ones(pos.shape[0], bool)
                ctx = reax.nb_ctx(pos, None, s.H, s.types, self.img, nbrs,
                                  s.gid, amask, self.ffd)
                if not self.closed_form:
                    rows_pre = reax.pair_rows(ctx, s.types, self.ffd)
            do_qeq = (s.step % cfg.qstep) == 0
            pre = None
            if ctx is not None:
                pre = (ctx, *rows_pre) if rows_pre else (ctx, None, None)
            q, qsfp, qsfv, nq, spos = jax.lax.cond(
                do_qeq,
                lambda: self._qeq_step(pos, s.q, qsfp, qsfv, s.H, s.types,
                                       nbrs, spos=s.spos, pre=pre),
                lambda: (s.q, qsfp, qsfv, jnp.int32(0), s.spos))

            ext_nb = None
            if self.dense_direct:
                ext_nb = reax.nonbond_dense(
                    pos, q, s.H, s.types, jnp.ones(pos.shape[0], bool),
                    self.ffd, with_virial=True)
            comps, f2, w = self._forces(pos, q, s.H, s.types, s.gid, nbrs,
                                        spos=spos, lists=lists,
                                        with_virial=True, ctx=ctx,
                                        rows_pre=rows_pre,
                                        external_nonbond=ext_nb)

            # per-step stress accumulation: kinetic m v_a v_b with the
            # half-kicked velocity + potential virial (ref: main.F90:86-94
            # + pot.F90:65-72); components ordered (xx,yy,zz,yz,zx,xy)
            m = (2.0 * self.hmas)[s.types]
            kin = jnp.einsum("i,ia,ib->ab", m, v, v,
                             preferred_element_type=v.dtype)
            sw = kin + 0.5 * (w + w.T)
            astr = astr + jnp.stack([sw[0, 0], sw[1, 1], sw[2, 2],
                                     sw[1, 2], sw[2, 0], sw[0, 1]])

            # second half kick (ref: main.F90:97-98)
            v = v + self.dthm[s.types][:, None] * f2
            qsfv = qsfv + 0.5 * dt * self.lex_w2 * (q - qsfp)

            ke = jnp.sum(self.hmas[s.types] * jnp.sum(v * v, axis=1))
            # Verlet-drift monitor: max displacement since the last rebuild
            # bounds the validity of the skinned/cached lists (the safe
            # analog of the reference's every-step rebuild, pot.F90:30-34)
            maxdr2 = jnp.max(jnp.sum((pos - pos_ref) ** 2, axis=1))
            s2 = dataclasses.replace(
                s, pos=pos, vel=v, q=q, qsfp=qsfp, qsfv=qsfv, spos=spos,
                step=s.step + 1)
            return s2, f2, comps, nq, ke, maxdr2, astr
        return step

    def _make_multi_step(self, B: int):
        """K steps in one XLA program (lax.scan over the step body).
        Returns the last step's observables, the accumulated stress, and
        the block's running drift maximum + final max velocity (for the
        host's drift-budget scheduling)."""
        step = self._step_fn
        dtype = self.dtype

        def multi(s: State, f, nbrs, lists, pos_ref, astr):
            def body(carry, _):
                s, f, astr, mdr = carry
                s2, f2, comps, nq, ke, maxdr2, astr = step(
                    s, f, nbrs, lists, pos_ref, astr)
                return ((s2, f2, astr, jnp.maximum(mdr, maxdr2)),
                        (comps, nq, ke))
            (s, f, astr, mdr), outs = jax.lax.scan(
                body, (s, f, astr, jnp.zeros((), dtype)), None, length=B)
            comps, nq, ke = (o[-1] for o in outs)
            vmax2 = jnp.max(jnp.sum(s.vel * s.vel, axis=1))
            return s, f, comps, nq, ke, mdr, astr, vmax2

        return jax.jit(multi)

    # ------------------------------------------------------------------
    def bond_table(self, bo_cutoff=0.3):
        """(partner gids (N,kb), bond orders, counts) for .bnd output
        (ref: WriteBND fileio.F90:27-148, BNDcutoff=0.3)."""
        s = self.state
        nbrs = self._build_nbrs(s.pos, s.H, s.types)
        bo = reax.bond_order(s.pos, s.H, s.types, self.img, nbrs, self.ffd)
        return _bond_table_from(bo, nbrs, s.gid, self.img, bo_cutoff)

    def write_frame(self, base_path: str):
        """Write configured trajectory formats (ref: OUTPUT fileio.F90:5-20)."""
        from .io import traj, refbin, checkpoint
        cfg = self.cfg
        names = self.ff.atom_names
        if cfg.is_xyz:
            traj.write_xyz(base_path + ".xyz", self.state, names)
        if cfg.is_pdb:
            traj.write_pdb(base_path + ".pdb", self.state, names)
        if cfg.is_bondfile:
            g, b, c = self.bond_table()
            traj.write_bnd(base_path + ".bnd", self.state, g, b, c)
        if cfg.is_binary:
            refbin.write_rxff_bin(base_path + ".bin", self.state)

    # ------------------------------------------------------------------
    def _check_list_overflow(self):
        """Abort on neighbor, cell or interaction-list overflow like the
        reference (ref: main.F90:402-407); silent truncation is never
        acceptable."""
        mb, mnb = neighbors.check_overflow(self.nbrs)
        self.timers.peak("bonded nbr list", mb, self.kb)
        self.timers.peak("nonbonded nbr list", mnb, self.knb)
        if self.grid is not None:
            occ = int(self._cell_occ)
            if occ > self.grid.ccap:
                raise RuntimeError(
                    f"neighbor cell overflow: {occ} atoms in one cell > "
                    f"capacity {self.grid.ccap}")
            self.timers.peak("cell occupancy", occ, self.grid.ccap)
        if self.tlists:
            al, tl, hl = self.tlists
            na, nt, nh = int(al.cnt), int(tl.cnt), int(hl.cnt)
            names = ("ang_row", "tor_row", "hb_row")
            rows = [nm for nm, c in zip(names, (na, nt, nh))
                    if c >= reax.ROW_OVERFLOW]
            if rows:
                raise RuntimeError(
                    "interaction-list PER-ROW overflow in "
                    f"{'/'.join(rows)} — raise the corresponding "
                    f"*_row capacities (caps={self.caps}); the total "
                    "ang/tor/hbf caps are not the limiting knob here")
            if (na > al.valid.shape[0] or nt > tl.valid.shape[0]
                    or nh > hl.valid.shape[0]):
                raise RuntimeError(
                    f"interaction-list overflow: angles {na}/"
                    f"{al.valid.shape[0]} torsions {nt}/{tl.valid.shape[0]}"
                    f" hbonds {nh}/{hl.valid.shape[0]}"
                    " — raise caps (ref aborts too, main.F90:402-407)")
            self.timers.peak("angle list", na, al.valid.shape[0])
            self.timers.peak("torsion list", nt, tl.valid.shape[0])
            self.timers.peak("hbond list", nh, hl.valid.shape[0])

    def prepare(self):
        self.state, self.nbrs, self.tlists = self._rebuild(self.state)
        self._check_list_overflow()
        self._pos_ref = self.state.pos
        self._steps_since_rebuild = 0
        s, f, comps, nq = self._prepare(self.state, self.nbrs, self.tlists)
        self.state = s
        self.force = f
        self.comps = comps
        self.nqeq = nq
        self._astr = jnp.zeros((6,), self.dtype)
        self._astr_steps = 0
        self._host_step = int(s.step)
        return comps

    def stress(self):
        """Stress tensor [GPa]: kinetic term + potential virial as the
        strain derivative of the total energy (the autodiff analog of the
        reference's Σ pos·f accumulation, pot.F90:65-72 + main.F90:86-94).
        Returns the symmetric 3x3 tensor; pressure = trace/3."""
        s = self.state
        nbrs = getattr(self, "nbrs", None)
        if nbrs is None:
            self.state, self.nbrs, self.tlists = self._rebuild(self.state)
            nbrs = self.nbrs
            s = self.state
        nbrs = self._tight_nbrs(s.pos, s.H, s.types, nbrs)

        def e_strained(eps):
            strain = jnp.eye(3, dtype=self.dtype) + eps
            pos = s.pos @ strain.T
            H = strain @ s.H
            return reax.total_energy(pos, s.q, H, s.types, s.gid, self.img,
                                     nbrs, self.ffd, caps=self.caps,
                                     pq=self.pq, spos=s.spos)

        virial = -jax.grad(e_strained)(jnp.zeros((3, 3), self.dtype))
        m = (2.0 * self.hmas)[s.types]
        kin = jnp.einsum("i,ia,ib->ab", m, s.vel, s.vel)
        vol = jnp.abs(jnp.linalg.det(s.H))
        sym = 0.5 * (virial + virial.T)
        return np.asarray((kin + sym) / vol * units.USTRS)

    def pressure_gpa(self, reset=True):
        """Pressure [GPa] from the per-step accumulated stress, normalized
        exactly like the reference PRINTE: tr(astr)/3 / volume * USTRS
        / pstep (ref: main.F90:252-253); the accumulator resets after each
        print (ref: main.F90:269)."""
        astr = np.asarray(getattr(self, "_astr", np.zeros(6)))
        vol = abs(float(jnp.linalg.det(self.state.H)))
        # normalize by the actual number of accumulated steps; at the pstep
        # cadence this equals the reference's /pstep (main.F90:252-253), and
        # off-cadence calls (end-of-run partial window) stay correct
        nst = getattr(self, "_astr_steps", 0) or max(self.cfg.pstep, 1)
        ss = astr[:3].sum() / 3.0 / vol * units.USTRS / nst
        if reset:
            self._astr = jnp.zeros((6,), self.dtype)
            self._astr_steps = 0
        return float(ss)

    def printe_line(self):
        """PRINTE-format observables (ref: main.F90:210-263)."""
        s = self.state
        n = s.n
        ke = float(jnp.sum(self.hmas[s.types] * jnp.sum(s.vel * s.vel,
                                                        axis=1))) / n
        pe = np.asarray(self.comps) / n
        te = ke + pe[0]
        tt = ke * units.UTEMP
        ss = self.pressure_gpa()
        qq = float(s.q.sum())
        return (f"MDstep: {int(s.step):9d} {te: .5E} {pe[0]: .5E} {ke: .5E} "
                f"{pe[1]: .3E} {pe[2:5].sum(): .3E} {pe[5:8].sum(): .3E} "
                f"{pe[8:10].sum(): .3E} {pe[10]: .3E} {pe[11:14].sum(): .3E} "
                f"{tt:8.2f} {ss:8.2f} {qq:8.2f} {int(self.nqeq):4d}")

    def init_velocity(self, seed=0):
        """Gaussian velocities scaled to treq with zero net momentum
        (ref: INITVELOCITY init.F90:292-360)."""
        s = self.state
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(s.n, 3))
        m = np.asarray(2.0 * self.hmas)[np.asarray(s.types)]
        v -= (m[:, None] * v).sum(0) / m.sum()
        ke = 0.5 * (m * (v * v).sum(1)).sum() / s.n
        v *= np.sqrt(1.5 * self.treq_red / ke)
        self.state = dataclasses.replace(
            self.state, vel=jnp.asarray(v, self.dtype))

    def run(self, nsteps=None, log=print, writer=None):
        """Host driver loop (ref: main.F90:37-103)."""
        cfg = self.cfg
        tm = self.timers
        nsteps = nsteps if nsteps is not None else cfg.ntime_step
        if not hasattr(self, "force"):
            if cfg.mdmode in (0, 6):
                self.init_velocity()
            with tm("first force (compile)"):
                self.prepare()
        profile = None
        if cfg.save_run_profile:
            from .utils.timers import RunProfile
            profile = RunProfile(cfg.run_profile_path, self.state.n)
        # per-step device->host reads serialize the dispatch pipeline —
        # the step counter is tracked host-side and the drift monitor is
        # polled on a cadence, never every step
        if not hasattr(self, "_host_step"):
            self._host_step = int(self.state.step)
        t0 = time.time()
        self._last_maxdr = getattr(self, "_last_maxdr", None)
        self._vmax = getattr(self, "_vmax", None)
        k = 0
        while k < nsteps:
            stepno = self._host_step
            if cfg.mdmode in (0, 6) and stepno % cfg.sstep == 0 and k > 0:
                # periodic Maxwell-Boltzmann redraw (ref: main.F90:53-54)
                self.init_velocity(seed=stepno)
                self._vmax = None
            if stepno % cfg.pstep == 0:
                nq = int(self.nqeq)
                tm.count("QEq iterations", nq)
                if log:
                    with tm("PRINTE"):
                        log(self.printe_line())
                if profile is not None:
                    profile.record(stepno, nq)
            if writer is not None and stepno % cfg.fstep == 0:
                with tm("trajectory output"):
                    writer(self.state, self.comps)
            # drift check: block dispatches read the running block maximum
            # synchronously (one round trip per block); single-step
            # dispatches poll lazily on a cadence as before.  The trigger
            # at 0.8x of the half-skin bound absorbs the lag.
            prev_dr2 = getattr(self, "_maxdr2_dev", None)
            poll = (prev_dr2 is not None
                    and self._steps_since_rebuild >= self.drift_check_from
                    and self._steps_since_rebuild % self.drift_check_every
                    == 0)
            drifted = (poll
                       and float(prev_dr2) ** 0.5 > 0.8 * self.drift_trigger)
            if self._last_maxdr is not None \
                    and self._last_maxdr > 0.8 * self.drift_trigger:
                drifted = True
            if self._steps_since_rebuild >= self.rebuild_every or drifted:
                if drifted:
                    tm.count("drift-triggered rebuilds", 1)
                with tm("neighbor rebuild"):
                    self.state, self.nbrs, self.tlists = self._rebuild(
                        self.state)
                self._check_list_overflow()
                self._pos_ref = self.state.pos
                self._steps_since_rebuild = 0
                self._maxdr2_dev = None
                self._last_maxdr = None

            # steps until the next host-side boundary (print, frame,
            # velocity redraw, rebuild cadence, run end)
            nb = nsteps - k
            nb = min(nb, cfg.pstep - stepno % cfg.pstep)
            if writer is not None:
                nb = min(nb, cfg.fstep - stepno % cfg.fstep)
            if cfg.mdmode in (0, 6):
                nb = min(nb, cfg.sstep - stepno % cfg.sstep)
            nb = min(nb, self.rebuild_every - self._steps_since_rebuild)
            # drift budget: max displacement grows at most ~vmax*dt/step;
            # cap the block so the skinned lists provably stay valid
            if self._vmax is None and nb >= self.block_steps > 1:
                # no velocity bound yet (fresh start/redraw): one read
                self._vmax = float(jnp.max(
                    jnp.sum(self.state.vel * self.state.vel,
                            axis=1))) ** 0.5
            if self._vmax is not None and self._vmax > 0.0:
                room = 0.8 * self.drift_trigger - (self._last_maxdr or 0.0)
                budget = int(room / (1.25 * self._vmax * self.dt))
                nb = min(nb, max(budget, 1))

            if nb >= self.block_steps > 1:
                if self._mstep is None:
                    self._mstep = self._make_multi_step(self.block_steps)
                with tm("MD block (dispatch)"):
                    out = self._mstep(self.state, self.force, self.nbrs,
                                      self.tlists, self._pos_ref,
                                      self._astr)
                (self.state, self.force, self.comps, self.nqeq, self._ke,
                 mdr, self._astr, vmax2) = out
                self._last_maxdr = float(mdr) ** 0.5
                self._vmax = float(vmax2) ** 0.5
                self._maxdr2_dev = None
                nadv = self.block_steps
            else:
                with tm("MD step (dispatch)"):
                    out = self._step(self.state, self.force, self.nbrs,
                                     self.tlists, self._pos_ref, self._astr)
                (self.state, self.force, self.comps, self.nqeq, self._ke,
                 self._maxdr2_dev, self._astr) = out
                nadv = 1
            self._astr_steps += nadv
            self._steps_since_rebuild += nadv
            self._host_step += nadv
            k += nadv
            tm.count("MD steps", nadv)
        jax.block_until_ready(self.state.pos)
        wall = time.time() - t0
        tm.add("MD loop (wall)", wall, nsteps)
        if profile is not None:
            profile.close()
        if log:
            log(self.printe_line())
            log(f"total (sec): {wall:.4f}  "
                f"atom-steps/s: {self.state.n * nsteps / wall:.3e}")
        return wall

    def summary(self):
        """End-of-run per-phase timing / occupancy / memory report
        (ref: FinalizeMD main.F90:128-186)."""
        dev = None
        try:
            dev = self.state.pos.devices().pop()
        except Exception:
            pass
        return self.timers.summary_lines(device=dev)
