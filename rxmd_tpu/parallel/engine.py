"""Sharded MD engine: 3-D spatial domain decomposition over a device mesh.

The JAX equivalent of the reference's MPI rank grid
(ref: init.F90:75-100): a `jax.sharding.Mesh` with axes ("x","y","z"), one
spatial subdomain per device, fixed per-device atom capacity.

Cadence architecture (same as the single-device engine, md.Engine):

  REBUILD (every `rebuild_every` steps or on drift trigger — one sharded
  program): wrap -> migration (COPYATOMS MODE_MOVE, comm.F90:232-270)
  -> halo plan construction (MODE_COPY, pot.F90:28) -> cell-list neighbor
  build with Verlet-skin-extended cutoffs -> cached many-body term lists
  (slackened gates, re-gated live at evaluation).

  STEP (every step — one sharded program): thermostat -> kick -> drift ->
  ghost refresh through the SAVED plan -> shared pair context -> QEq CG
  with psum reductions and per-iteration ghost refresh (MODE_QCOPY1/2,
  qeq.F90:86-164) -> forces as grad of the psum'd total energy (ghost-force
  copy-back MODE_CPBK arises as the transpose of the halo ppermutes) ->
  velocity-Verlet kicks + drift monitor.

The reference rebuilds its lists every step (pot.F90:30-34); the drift
monitor makes the reuse provably safe (atoms move < skin/2 between
rebuilds), exactly like md.Engine.  Within-shard compute reuses the exact
same `reax` potential as the single-device engine, in "identity image"
mode: rows = residents + ghosts, energies summed over resident rows only.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from .. import units, qeq, reax, neighbors
from ..config import RunConfig
from ..ffield import ForceField
from ..system import State
from . import halo


def identity_image(m: int, dtype) -> neighbors.ImageTable:
    """Ext rows are real atoms (residents + exchanged ghosts): owner is the
    identity and shifts are zero."""
    return neighbors.ImageTable(owner=jnp.arange(m, dtype=jnp.int32),
                                shift=jnp.zeros((m, 3), dtype), nimg=(0, 0, 0))


class ShardedState(NamedTuple):
    """Per-atom state in device-block layout: arrays of shape
    (ndev*ncap, ...), block d holding device d's residents."""
    frac: jax.Array      # global fractional coordinates
    vel: jax.Array
    q: jax.Array
    qsfp: jax.Array
    qsfv: jax.Array
    spos: jax.Array      # PQEq shell displacement from core (zeros if QEq)
    frac0: jax.Array     # initial coordinates (spring restraint reference,
                         # ref: ipos init.F90:231-232); migrates with atoms
    types: jax.Array
    gid: jax.Array
    valid: jax.Array


NFIELDS = len(ShardedState._fields)


def _tree_specP(tree):
    """Shard every array leaf along its leading axis over the full mesh
    (per-device blocks stacked)."""
    return jax.tree.map(lambda _: P(("x", "y", "z")), tree,
                        is_leaf=lambda x: isinstance(x, jax.Array))


def factor_mesh(n: int):
    """Factor n into a 3-tuple, largest axis first (like choosing vprocs)."""
    best = (n, 1, 1)
    for a in range(1, n + 1):
        if n % a:
            continue
        for b in range(1, n // a + 1):
            if (n // a) % b:
                continue
            c = n // a // b
            cand = tuple(sorted((a, b, c), reverse=True))
            if max(cand) - min(cand) < max(best) - min(best):
                best = cand
    return best


def distribute(state: State, mesh_shape, ncap) -> ShardedState:
    """Assign atoms to device blocks by spatial subdomain (host-side;
    the analog of geninit's binning, ref: geninit.F90:493-527)."""
    H = np.asarray(state.H)
    Hi = np.linalg.inv(H)
    frac = (np.asarray(state.pos) @ Hi.T) % 1.0
    nx, ny, nz = mesh_shape
    ndev = nx * ny * nz
    cell = np.minimum((frac * [nx, ny, nz]).astype(int),
                      np.array([nx, ny, nz]) - 1)
    lin = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]

    def blk(arr, fill=0):
        arr = np.asarray(arr)
        out = np.full((ndev * ncap,) + arr.shape[1:], fill, arr.dtype)
        for d in range(ndev):
            sel = np.where(lin == d)[0]
            if len(sel) > ncap:
                raise RuntimeError(f"device {d} overflows ncap={ncap}")
            out[d * ncap:d * ncap + len(sel)] = arr[sel]
        return out

    valid = np.zeros(ndev * ncap, bool)
    for d in range(ndev):
        valid[d * ncap:d * ncap + int((lin == d).sum())] = True
    fblk = jnp.asarray(blk(frac))
    return ShardedState(
        frac=fblk, vel=jnp.asarray(blk(state.vel)),
        q=jnp.asarray(blk(state.q)), qsfp=jnp.asarray(blk(state.qsfp)),
        qsfv=jnp.asarray(blk(state.qsfv)),
        spos=jnp.asarray(blk(state.spos)), frac0=fblk,
        types=jnp.asarray(blk(state.types)),
        gid=jnp.asarray(blk(state.gid)), valid=jnp.asarray(valid))


class ShardedEngine:
    """Multi-device MD engine over a 3-D mesh."""

    def __init__(self, ff: ForceField, state: State, cfg: RunConfig,
                 mesh_shape=None, devices=None, dtype=None,
                 ncap=None, bcap=None, mcap=None, rctap=None,
                 skin_layers=3.0):
        self.ff = ff
        self.cfg = cfg
        if cfg.mdmode == 0:
            cfg.isQEq = 1      # ref: init.F90:56-63
        self.dtype = dtype or jnp.dtype(cfg.dtype)
        from ..md import require_dtype
        require_dtype(self.dtype)
        devices = devices if devices is not None else jax.devices()
        if mesh_shape is None:
            mesh_shape = factor_mesh(len(devices))
        self.mesh_shape = tuple(mesh_shape)
        ndev = int(np.prod(mesh_shape))
        self.ndev = ndev
        self.mesh = Mesh(np.asarray(devices[:ndev]).reshape(mesh_shape),
                         ("x", "y", "z"))

        # rctap/skin_layers are engineering knobs: rctap < RCTAP0 truncates
        # the nonbonded/QEq cutoff, skin_layers < 3 truncates the bonded
        # ghost dependency chain — exact physics requires the defaults;
        # reduced values are for compile/execution validation on tiny
        # virtual-device meshes (the driver's dryrun).
        if rctap is None:
            rctap = units.RCTAP0_PQEQ if cfg.isPQEq else units.RCTAP0
        rctap = float(rctap)
        self.rctap = rctap
        self.pq = None
        if cfg.isPQEq:
            from .. import pqeq as pqeq_mod
            par = pqeq_mod.parse_pqeq_par(cfg.pqeq_parm_path)
            pqeq_mod.apply_to_ff(ff, par)   # chi/eta overrides before ffdev
            self.pq = pqeq_mod.make_pqeq(par, dtype=self.dtype, rctap=rctap)
            tmax = int(np.asarray(state.types).max())
            if tmax >= self.pq.ntype:
                raise ValueError(
                    f"atom type {tmax} has no PQEq parameters "
                    f"({self.pq.ntype} rows in {cfg.pqeq_parm_path})")
        self.ffd = reax.ffdev_from(ff, dtype=self.dtype, rctap=rctap)
        self.state0 = state.astype(self.dtype)
        H = np.asarray(state.H)
        if not np.allclose(H, np.diag(np.diag(H))):
            raise NotImplementedError(
                "ShardedEngine assumes an orthogonal box (the fractional "
                "halo skins are per-axis slabs); use md.Engine for "
                "triclinic cells")
        self.Hg = jnp.asarray(H, self.dtype)
        self.Hi = jnp.asarray(np.linalg.inv(H), self.dtype)
        L = np.diag(H)

        # closed-form nonbond/QEq kernels in f32 production; interpolation
        # tables (bit-parity with the reference) in f64 validation — the
        # same selection rule as md.Engine
        self.closed_form = (cfg.nonbond_closed_form
                            if cfg.nonbond_closed_form is not None
                            else self.dtype == jnp.dtype(jnp.float32))

        from ..ffield import effective_maxrc
        maxrc = effective_maxrc(ff, np.asarray(state.types))
        # Verlet skin: lists built with extended cutoffs, reused for up to
        # rebuild_every steps; the energy kernels re-check the true cutoffs
        self.skin_nb = cfg.nbr_skin
        # ghost skin: 3*maxrc covers the deepest bonded dependency chain
        # (resident energy -> BO(k,l) with l at 2rc -> deltap(l) needing
        # positions at 3rc); the taper cutoff covers nonbonded/QEq; plus
        # the Verlet drift margin.  (The reference uses NMINCELL cell
        # layers, pot.F90:28.)
        skin = max(float(skin_layers) * maxrc, rctap) + self.skin_nb + 0.1
        self.skin = skin
        local = L / np.asarray(mesh_shape)
        if (local < skin).any() and max(mesh_shape) > 1:
            raise RuntimeError(
                f"local box {local} smaller than skin {skin}; use fewer "
                "devices or a larger system (same constraint as the "
                "reference's cell decomposition)")

        if ncap is None:
            ncap = int(np.ceil(state.n / ndev * 1.6 / 8)) * 8
        self.ncap = ncap
        # ghost buffer: volume ratio of the skin expansion, with margin
        if bcap is None:
            grow = np.prod(1 + 2 * skin / local) - 1.0
            bcap = int(np.ceil(ncap * max(grow, 1.0) / 3.0)) + 32
        self.bcap = bcap
        # migration buffer: atoms crossing during a whole rebuild window
        self.mcap = min(mcap or max(64, ncap // 4), ncap)
        self.spec = halo.HaloSpec(
            axes=("x", "y", "z"), mesh_shape=self.mesh_shape,
            skin_frac=tuple(skin / L), ncap=ncap, bcap=bcap)
        self.mext = ncap + 6 * bcap

        # many-body list caching (same contract as md.Engine)
        self.term_cache = cfg.term_cache
        self.term_slack = cfg.term_slack if self.term_cache else 1.0
        self.term_margin = cfg.term_margin if self.term_cache else 0.0

        # neighbor/term capacities from a single-device probe (on host CPU)
        from ..md import probe_capacities
        self.kb, self.knb, caps_g = probe_capacities(
            ff, self.state0, self.ffd, rctap, self.dtype,
            skin=self.skin_nb, term_slack=self.term_slack,
            term_margin=self.term_margin)
        # flat term-list capacities are per-shard: resident centers divide
        # across devices (4x headroom absorbs density imbalance; overflow
        # is checked every rebuild and aborts loudly)
        def _shard_cap(v):
            return min(v, -(-v * 4 // ndev) + 256) if ndev > 1 else v
        self.caps = dict(caps_g)
        for k in ("ang", "tor", "hbf"):
            self.caps[k] = _shard_cap(caps_g[k])

        # skinned cutoffs for the neighbor build (re-gated at evaluation)
        rc2b = np.asarray(self.ffd.rc2b)
        rcb_ext = (np.sqrt(rc2b) + self.skin_nb) ** 2 * (rc2b > 0)
        self.rc2b_ext = jnp.asarray(rcb_ext, self.dtype)
        self.rctap2_ext = jnp.asarray((rctap + self.skin_nb) ** 2, self.dtype)

        # local cell grid over the skin-extended subdomain (frac-relative)
        lo = -skin * np.ones(3)
        hi = local + skin
        self.grid = neighbors.make_cell_grid(
            lo, hi, max(maxrc + self.skin_nb, 2.0), rctap + self.skin_nb)

        # integration constants
        self.dt = cfg.dt_fs / units.UTIME
        self.lex_w2 = 2.0 * cfg.Lex_k / self.dt / self.dt
        self.dthm = jnp.asarray(self.dt * 0.5 / ff.mass, self.dtype)
        self.hmas = jnp.asarray(0.5 * ff.mass, self.dtype)

        # rebuild trigger (same rule as md.Engine)
        self.rebuild_every = cfg.rebuild_every
        lim = self.skin_nb
        if self.term_cache and self.term_margin > 0.0:
            lim = min(lim, self.term_margin)
        self.drift_trigger = 0.5 * lim
        self.drift_check_from = 4
        self.drift_check_every = 2

        self.sstate = distribute(self.state0, self.mesh_shape, ncap)
        if jax.process_count() > 1:
            # multi-host mesh (the DCN/ICI analog of the reference's MPI
            # world, ref: SURVEY 5.8): every process computed the identical
            # host-side state; commit it as a global array so jit+shard_map
            # spans process boundaries
            self.sstate = jax.tree.map(self._commit, self.sstate)
        self._build_programs()

    # ------------------------------------------------------------------
    def _commit(self, a):
        """Host array -> global device array sharded over the mesh (every
        process holds the identical host copy)."""
        from jax.sharding import NamedSharding
        sh = NamedSharding(self.mesh, P(("x", "y", "z")))
        arr = np.asarray(a)
        return jax.make_array_from_callback(arr.shape, sh,
                                            lambda idx: arr[idx])

    def _local_frame(self):
        """Per-device offset of the subdomain origin in fractional coords."""
        nx, ny, nz = self.mesh_shape
        ix = jax.lax.axis_index("x").astype(self.dtype)
        iy = jax.lax.axis_index("y").astype(self.dtype)
        iz = jax.lax.axis_index("z").astype(self.dtype)
        return jnp.stack([ix / nx, iy / ny, iz / nz])

    def _psum(self, x):
        return jax.lax.psum(x, ("x", "y", "z"))

    def _migrate(self, s: ShardedState, extras: dict = None):
        """Move atoms whose coordinate left the local box to the face
        neighbor, one axis at a time (COPYATOMS MODE_MOVE semantics,
        comm.F90:232-270,440).  `extras` are additional (ncap, ...) arrays
        that ride with the atoms — the analog of the reference optimizer's
        MigrateVec3D (ref: cg.F90:292-314).  Returns (state, extras,
        mig_max): the max send count over phases so the caller can abort on
        buffer overflow like the reference (ref: comm.F90:467-472) instead
        of dropping atoms."""
        nxs = self.mesh_shape
        mcap = self.mcap
        payload = s._asdict()
        valid = payload.pop("valid")
        payload.update(extras or {})
        mig_max = jnp.int32(0)
        for ax, name in ((0, "x"), (1, "y"), (2, "z")):
            n = nxs[ax]
            if n == 1:
                continue
            my = jax.lax.axis_index(name)
            target = jnp.clip((payload["frac"][:, ax] * n).astype(jnp.int32),
                              0, n - 1)
            for d in (+1, -1):
                dest = (my + d) % n
                go = valid & (target == dest)
                if n == 2 and d == -1:
                    go = go & False       # both directions coincide; send once
                vals, sel = jax.lax.top_k(go.astype(jnp.int32), mcap)
                cnt = go.sum(dtype=jnp.int32)
                mig_max = jnp.maximum(mig_max, cnt)
                ok = vals > 0
                send = {k: jnp.where(
                    ok.reshape((mcap,) + (1,) * (v.ndim - 1)),
                    v[jnp.where(ok, sel, 0)], 0)
                    for k, v in payload.items()}
                recv = jax.tree.map(
                    lambda a: jax.lax.ppermute(a, name, halo._perm(n, d)),
                    send)
                rcnt = jax.lax.ppermute(cnt, name, halo._perm(n, d))
                rvalid = jnp.arange(mcap) < rcnt
                # drop senders, then place received atoms into free slots
                valid = valid & ~go
                fvals, fsel = jax.lax.top_k((~valid).astype(jnp.int32), mcap)
                place = rvalid & (fvals > 0)
                dst = jnp.where(place, fsel, self.ncap)  # ncap: scratch slot
                for k in payload:
                    pv = payload[k]
                    payload[k] = pv.at[dst].set(
                        jnp.where(place.reshape((mcap,) + (1,) *
                                                (pv.ndim - 1)),
                                  recv[k], pv[dst]), mode="drop")
                valid = valid.at[dst].set(
                    jnp.where(place, True, valid[dst]), mode="drop")
        out_extras = {k: payload.pop(k) for k in (extras or {})}
        payload["valid"] = valid
        return ShardedState(**payload), out_extras, mig_max

    # ------------------------------------------------------------------
    def _zero_momentum(self, s: ShardedState, v):
        """Remove global center-of-mass momentum (ref: main.F90:766-797)."""
        m = jnp.where(s.valid, (2.0 * self.hmas)[s.types], 0.0)
        psum = self._psum
        vcm = psum(jnp.sum(m[:, None] * v, axis=0)) / psum(jnp.sum(m))
        return jnp.where(s.valid[:, None], v - vcm[None, :], 0.0)

    def _thermostat(self, s: ShardedState, do_scale):
        """mdmode-dispatched velocity scaling with global psum reductions
        (ref: main.F90:45-61; the sharded analog of md.Engine._thermostat)."""
        cfg = self.cfg
        v = s.vel
        psum = self._psum
        treq_red = cfg.treq / units.UTEMP0
        if cfg.mdmode == 4:
            v = jnp.where(do_scale, cfg.vsfact * v, v)
        elif cfg.mdmode == 5:
            ke = psum(jnp.sum(jnp.where(
                s.valid, self.hmas[s.types] * jnp.sum(v * v, axis=1), 0.0)))
            gn = psum(s.valid.sum(dtype=v.dtype))
            ctmp = (treq_red * units.UTEMP0) / (ke / gn * units.UTEMP)
            v = jnp.where(do_scale, jnp.sqrt(ctmp) * v, v)
        elif cfg.mdmode == 7:
            # per-element rescale to treq (ref: main.F90:722-763)
            nso = self.hmas.shape[0]
            w = s.valid.astype(v.dtype)
            cnt = psum(jnp.zeros(nso, v.dtype).at[s.types].add(w))
            ket = psum(jnp.zeros(nso, v.dtype).at[s.types].add(
                w * self.hmas[s.types] * jnp.sum(v * v, axis=1)))
            ctmp = jnp.where(cnt > 1.0, ket / jnp.maximum(cnt, 1.0), 1.0)
            fac = jnp.where(
                cnt > 1.0,
                jnp.sqrt((treq_red * units.UTEMP0) / (ctmp * units.UTEMP)),
                0.0)
            v2 = self._zero_momentum(s, fac[s.types][:, None] * v)
            v = jnp.where(do_scale, v2, v)
        elif cfg.mdmode == 8:
            # rescale only if >5% off target (ref: main.F90:684-718)
            ke = psum(jnp.sum(jnp.where(
                s.valid, self.hmas[s.types] * jnp.sum(v * v, axis=1), 0.0)))
            gn = psum(s.valid.sum(dtype=v.dtype))
            ctmp = jnp.sqrt((treq_red * units.UTEMP0)
                            / (ke / gn * units.UTEMP))
            need = jnp.abs(ctmp - 1.0) > 0.05
            v2 = self._zero_momentum(s, ctmp * v)
            v = jnp.where(do_scale & need, v2, v)
        return s._replace(vel=jnp.where(s.valid[:, None], v, 0.0))

    # ------------------------------------------------------------------
    def _rebuild_block(self, s: ShardedState, extras: dict = None):
        """Wrap + migrate + halo plan + skinned neighbor lists + cached
        term lists (the sharded analog of md.Engine._make_rebuild)."""
        spec = self.spec
        frac = jnp.where(s.valid[:, None], s.frac % 1.0, 0.0)
        s = s._replace(frac=frac)
        s, extras, mig_max = self._migrate(s, extras)

        plan, frac_ext, valid_ext = halo.build_plan(s.frac, s.valid, spec)
        tex = halo.apply_plan(plan, s.types, spec)
        gex = halo.apply_plan(plan, s.gid, spec)
        mylo = self._local_frame()
        pos_rel = (frac_ext - mylo[None, :]) @ self.Hg.T
        nbrs, cell_ovf = neighbors.build_neighbors_cells(
            pos_rel, valid_ext, tex, self.grid, self.rc2b_ext,
            self.rctap2_ext, self.kb, self.knb,
            row_chunk=(self.cfg.list_chunk
                       if 0 < self.cfg.list_chunk < self.mext else 0))

        lists = ()
        cnts = [jnp.int32(0)] * 3
        if self.term_cache:
            img = identity_image(self.mext, self.dtype)
            amask = jnp.zeros(self.mext, bool).at[:spec.ncap].set(s.valid)
            bo = reax.bond_order(pos_rel, self.Hg, tex, img, nbrs, self.ffd)
            al = reax.build_angle_list(
                tex, img, nbrs, bo, amask, self.ffd, cap=self.caps["ang"],
                ks=self.caps["ks"], slack=self.term_slack,
                margin=self.term_margin,
                rowcap=self.caps.get("ang_row", 0))
            # row-chunked builds above list_chunk local rows bound the
            # builds' peak memory; chunking is bit-identical
            chunk = (self.cfg.list_chunk
                     if 0 < self.cfg.list_chunk < self.mext else 0)
            tl = reax.build_torsion_list(
                tex, gex, img, nbrs, bo, amask, self.ffd,
                cap=self.caps["tor"], ks=self.caps["ks"],
                slack=self.term_slack, margin=self.term_margin,
                rowcap=self.caps.get("tor_row", 0), chunk=chunk)
            hl = reax.build_hbond_list(
                pos_rel, self.Hg, tex, img, nbrs, bo, amask, self.ffd,
                cap=self.caps["hbf"], kh=self.caps["kh"],
                slack=self.term_slack, margin=self.term_margin,
                rowcap=self.caps.get("hb_row", 0), chunk=chunk)
            cnts = [al.cnt, tl.cnt, hl.cnt]
            # scalar leaves can't ride the stacked block sharding
            lists = tuple(x._replace(cnt=x.cnt[None]) for x in (al, tl, hl))

        # rebuild diagnostics: mesh-wide maxima, replicated so the host
        # check is addressable on every process (multi-host safe)
        diag = jax.lax.pmax(jnp.stack([
            mig_max, plan.cnt_send.max(), cell_ovf.astype(jnp.int32),
            nbrs.cntb.max(), nbrs.cntnb.max(), *cnts]),
            ("x", "y", "z"))[None, :]
        return s, extras, tex, gex, plan, nbrs, lists, diag

    # ------------------------------------------------------------------
    def _compute(self, s: ShardedState, tex, gex, plan, nbrs, lists,
                 do_qeq, prep=False):
        """Ghost refresh + shared pair context + QEq/PQEq + forces + virial
        for the current configuration, using the saved halo plan and cached
        lists.  Returns (new q/qsfp/qsfv/spos, force on residents, comps,
        virial (3,3), nqeq)."""
        spec = self.spec
        ncap, mext = self.ncap, self.mext
        dtype = self.dtype
        mylo = self._local_frame()

        frac_ext = halo.apply_plan(plan, s.frac, spec, is_frac=True)
        resident_ext = jnp.zeros(mext, bool).at[:ncap].set(s.valid)
        amask = resident_ext
        img = identity_image(mext, dtype)
        pos_rel = (frac_ext - mylo[None, :]) @ self.Hg.T

        refresh = lambda x: halo.apply_plan(plan, x[:ncap], spec)

        cfg = self.cfg
        q_ext = refresh(s.q)
        spos_ext = halo.apply_plan(plan, s.spos, spec)
        spos_new = s.spos

        # ONE pair context per step, shared by the QEq hessian and the
        # nonbond kernels (the analog of the reference reusing nbplist,
        # pot.F90:34 + qeq.F90:183) — QEq path only, like md.Engine
        ctx = rows_pre = pre = None
        use_fast_nb = self.pq is None
        if use_fast_nb:
            ctx = reax.nb_ctx(pos_rel, None, self.Hg, tex, img, nbrs,
                              gex, amask, self.ffd)
            if not self.closed_form:
                rows_pre = reax.pair_rows(ctx, tex, self.ffd)
            pre = (ctx, *rows_pre) if rows_pre else (ctx, None, None)

        isqeq = 1 if (prep and cfg.isQEq == 2) else cfg.isQEq
        if cfg.isQEq and do_qeq:
            if self.pq is not None:
                # sharded PQEq: same psum/halo hooks as QEq; the shell
                # displacement rides the ghost exchange like q
                # (ref: pqeq.F90:89-165 + comm.F90:187-212)
                from .. import pqeq as pqeq_mod
                qn, sp_ext, nq, _ = pqeq_mod.solve(
                    pos_rel, spos_ext, q_ext, refresh(s.qsfp), self.Hg,
                    tex, img, nbrs, self.ffd, self.pq, amask=amask,
                    isqeq=isqeq, nmax=cfg.NMAXQEq, tol=cfg.QEq_tol,
                    lex_fqs=cfg.Lex_fqs, allreduce=self._psum,
                    refresh=refresh,
                    efield_dir=cfg.eFieldDir if cfg.isEfield else None,
                    efield_strength=cfg.eFieldStrength)
                q_new = jnp.where(s.valid, qn[:ncap], 0.0)
                spos_new = jnp.where(s.valid[:, None], sp_ext[:ncap], 0.0)
                spos_ext = halo.apply_plan(plan, spos_new, spec)
            else:
                res = qeq.solve(
                    pos_rel, q_ext, refresh(s.qsfp), self.Hg, tex,
                    img, nbrs, self.ffd, amask=amask, isqeq=isqeq,
                    nmax=cfg.NMAXQEq, tol=cfg.QEq_tol, lex_fqs=cfg.Lex_fqs,
                    allreduce=self._psum, refresh=refresh,
                    resident_ext=resident_ext,
                    closed_form=self.closed_form, pre=pre)
                q_new, nq = jnp.where(s.valid, res.q[:ncap], 0.0), res.iters
        else:
            q_new, nq = s.q, jnp.int32(0)
        if (isqeq == 1 and do_qeq) and not (prep and cfg.isQEq == 2):
            qsfp, qsfv = s.q, jnp.zeros_like(s.qsfv)
        elif prep and cfg.isQEq == 2:
            qsfp, qsfv = q_new, jnp.zeros_like(s.qsfv)
        else:
            qsfp, qsfv = s.qsfp, s.qsfv
        q_ext_new = refresh(q_new)

        def etot(frac_res, eps):
            strain = jnp.eye(3, dtype=dtype) + eps
            fx = halo.apply_plan(plan, frac_res, spec, is_frac=True)
            pr = ((fx - mylo[None, :]) @ self.Hg.T) @ strain.T
            comps = reax.energy_components(
                pr, q_ext_new, strain @ self.Hg, tex, gex, img,
                nbrs, self.ffd, amask=amask, caps=self.caps,
                include_nonbond=not use_fast_nb, pq=self.pq,
                spos=spos_ext, lists=lists or None)
            comps = self._psum(comps)
            return comps[0], comps

        eps0 = jnp.zeros((3, 3), dtype)
        (_, comps), (g, ge) = jax.value_and_grad(
            etot, argnums=(0, 1), has_aux=True)(s.frac, eps0)
        # d E/d pos = Hi^T dE/dfrac  (pos = frac @ H^T)
        f = -(g @ self.Hi)
        # potential virial W = -dE/deps.  eps is REPLICATED across the mesh,
        # so shard_map's backward pass already psums its cotangent: -ge is
        # the GLOBAL bonded virial (do not psum it again); the explicit
        # local pair sums below still need their psum.
        w = -ge
        if use_fast_nb:
            # nonbonded term: directed-pair enumeration gives complete
            # row-local forces on residents — no ghost-force copy-back
            if self.closed_form:
                evdw, eclmb, echarge, f_nb, w_nb = \
                    reax.nonbond_cf_energy_forces(
                        ctx, q_ext_new, tex, amask, self.ffd,
                        with_virial=True, img=img)
            else:
                evdw, eclmb, echarge, f_nb, w_nb = \
                    reax.nonbond_tbl_energy_forces(
                        ctx, q_ext_new, tex, amask, self.ffd,
                        with_virial=True, pre=rows_pre, img=img)
            comps = (comps.at[11].set(self._psum(evdw))
                     .at[12].set(self._psum(eclmb))
                     .at[13].set(self._psum(echarge)))
            comps = comps.at[0].set(jnp.sum(comps[1:]))
            f = f + f_nb[:ncap]
            w = w + self._psum(w_nb)

        # extra forces: constant eField on core charges + spring restraints
        # (ref: pot.F90:60-61; EEfield module.F90:359-383)
        f_extra = None
        if cfg.isEfield:
            qc = q_new
            if self.pq is not None:
                qc = q_new + self.pq.Z[s.types]  # ref: module.F90:374-378
            fe = -qc * cfg.eFieldStrength * units.EEV_KCAL
            f_extra = jnp.zeros_like(f).at[:, cfg.eFieldDir].add(
                jnp.where(s.valid, fe, 0.0))
        if cfg.spring_const:
            # minimum-image displacement from the initial configuration
            # (ref: SpringForce pot.F90:95-110)
            dfr = s.frac - s.frac0
            dfr = dfr - jnp.round(dfr)
            fs = -cfg.spring_const * (dfr @ self.Hg.T)
            if cfg.spring_types:
                smask = jnp.isin(
                    s.types, jnp.asarray(list(cfg.spring_types), jnp.int32))
                fs = jnp.where(smask[:, None], fs, 0.0)
            fs = jnp.where(s.valid[:, None], fs, 0.0)
            f_extra = fs if f_extra is None else f_extra + fs
        if f_extra is not None:
            f = f + f_extra
            # all forces enter the Σ pos·f stress accumulation
            # (ref: pot.F90:60-72); use absolute positions like md.Engine
            pos_abs = s.frac @ self.Hg.T
            w = w + self._psum(jnp.einsum("ia,ib->ab", f_extra, pos_abs))

        f = jnp.where(s.valid[:, None], f, 0.0)
        return q_new, qsfp, qsfv, spos_new, f, comps, w, nq

    # ------------------------------------------------------------------
    def _build_programs(self):
        cfg = self.cfg
        dt = self.dt
        mesh = self.mesh
        specP = P(("x", "y", "z"))
        sspec = ShardedState(*(specP,) * NFIELDS)

        # shapes of the rebuild products (for shard_map out_specs); built
        # by evaluating the block shape on abstract inputs is overkill —
        # every leaf simply shards along its leading axis
        def rebuild_fn(s: ShardedState):
            s, _, tex, gex, plan, nbrs, lists, diag = self._rebuild_block(s)
            return s, tex, gex, plan, nbrs, lists, diag

        self._rebuild = jax.jit(jax.shard_map(
            rebuild_fn, mesh=mesh, in_specs=(sspec,),
            out_specs=self._rb_specs()))

        def make(do_qeq: bool, nsteps: int = 1):
            def step_block(s: ShardedState, f, tex, gex, plan, nbrs, lists,
                           frac_ref, do_scale):
                s = self._thermostat(s, do_scale)
                w = s.valid
                v = s.vel + self.dthm[s.types][:, None] * f
                v = jnp.where(w[:, None], v, 0.0)
                qsfv = s.qsfv + 0.5 * dt * self.lex_w2 * (s.q - s.qsfp)
                qsfp = s.qsfp + dt * qsfv
                if cfg.isEfield:
                    # the field pumps net momentum into the charged system;
                    # correct it every step (ref: main.F90:70-71)
                    v = self._zero_momentum(s, v)
                # drift in fractional space; wrap/migration happen at
                # rebuilds so the saved plan stays index-consistent
                frac = s.frac + (v @ self.Hi.T) * dt
                frac = jnp.where(w[:, None], frac, 0.0)
                s = s._replace(frac=frac, vel=v, qsfp=qsfp, qsfv=qsfv)

                out = self._compute(s, tex, gex, plan, nbrs, lists, do_qeq)
                q, qsfp, qsfv, spos, f2, comps, wvir, nq = out
                # per-step stress: kinetic m v_a v_b with the half-kicked
                # velocity + potential virial (ref: main.F90:86-94 +
                # pot.F90:65-72); components (xx,yy,zz,yz,zx,xy)
                m = jnp.where(s.valid, (2.0 * self.hmas)[s.types], 0.0)
                kin = jnp.einsum("i,ia,ib->ab", m, s.vel, s.vel,
                                 preferred_element_type=s.vel.dtype)
                # wvir from _compute is already global; only kin is local
                sw = self._psum(kin) + 0.5 * (wvir + wvir.T)
                dastr = jnp.stack([sw[0, 0], sw[1, 1], sw[2, 2],
                                   sw[1, 2], sw[2, 0], sw[0, 1]])
                v = s.vel + self.dthm[s.types][:, None] * f2
                v = jnp.where(s.valid[:, None], v, 0.0)
                qsfv = qsfv + 0.5 * dt * self.lex_w2 * (q - qsfp)
                s = s._replace(vel=v, q=q, qsfp=qsfp, qsfv=qsfv, spos=spos)
                ke = self._psum(jnp.sum(
                    jnp.where(s.valid, self.hmas[s.types]
                              * jnp.sum(v * v, axis=1), 0.0)))
                # atom-count conservation (ref: main.F90:402-407 analog)
                diag = self._psum(s.valid.sum(dtype=jnp.int32))[None]
                # Verlet-drift monitor: max displacement since the rebuild
                # bounds the validity of the skinned lists and of the halo
                # plan's ghost selection
                dr = (s.frac - frac_ref) @ self.Hg.T
                dr2 = jnp.sum(dr * dr, axis=1)
                maxdr2 = jax.lax.pmax(
                    jnp.max(jnp.where(s.valid, dr2, 0.0)), ("x", "y", "z"))
                return s, f2, comps, nq, ke, dastr, diag, maxdr2

            def multi_block(s, f, tex, gex, plan, nbrs, lists, frac_ref,
                            step0):
                """nsteps fused into one program (lax.scan): amortizes the
                per-dispatch round trip like md.Engine's multi-step; the
                thermostat cadence is computed in-device from step0+i."""
                dtype = self.dtype

                def body(carry, i):
                    s, f, astr_acc, mdr = carry
                    do_scale = ((step0 + i) % cfg.sstep) == 0
                    out = step_block(s, f, tex, gex, plan, nbrs, lists,
                                     frac_ref, do_scale)
                    s, f, comps, nq, ke, dastr, diag, maxdr2 = out
                    return ((s, f, astr_acc + dastr,
                             jnp.maximum(mdr, maxdr2)),
                            (comps, nq, ke, diag))
                (s, f, astr, mdr), outs = jax.lax.scan(
                    body, (s, f, jnp.zeros((6,), dtype),
                           jnp.zeros((), dtype)),
                    jnp.arange(nsteps), length=nsteps)
                comps, nq, ke, diag = (o[-1] for o in outs)
                vmax2 = jax.lax.pmax(
                    jnp.max(jnp.where(s.valid,
                                      jnp.sum(s.vel * s.vel, axis=1), 0.0)),
                    ("x", "y", "z"))
                return s, f, comps, nq, ke, astr, diag, mdr, vmax2

            lspec = _tree_specP(self._lists_struct())
            common = (sspec, specP, specP, specP,
                      _tree_specP(halo.HaloPlan(0, 0, 0, 0)),
                      _tree_specP(neighbors.Neighbors(0, 0, 0, 0)),
                      lspec, specP, P())
            if nsteps == 1:
                smap = jax.shard_map(
                    step_block, mesh=mesh, in_specs=common,
                    out_specs=(sspec, specP, P(), P(), P(), P(), P(), P()))
            else:
                smap = jax.shard_map(
                    multi_block, mesh=mesh, in_specs=common,
                    out_specs=(sspec, specP, P(), P(), P(), P(), P(), P(),
                               P()))
            return jax.jit(smap)

        self._make_step_program = make
        self._step_qeq = make(True)
        self._step_noqeq = make(False) if cfg.qstep > 1 else self._step_qeq
        self._mstep = None
        self.block_steps = max(int(cfg.block_steps), 1)

        def prep_block(s: ShardedState, tex, gex, plan, nbrs, lists):
            out = self._compute(s, tex, gex, plan, nbrs, lists, True,
                                prep=True)
            q, qsfp, qsfv, spos, f, comps, _w, nq = out
            return (s._replace(q=q, qsfp=qsfp, qsfv=qsfv, spos=spos),
                    f, comps, nq)

        self._prepare = jax.jit(jax.shard_map(
            prep_block, mesh=mesh,
            in_specs=(sspec, specP, specP,
                      _tree_specP(halo.HaloPlan(0, 0, 0, 0)),
                      _tree_specP(neighbors.Neighbors(0, 0, 0, 0)),
                      _tree_specP(self._lists_struct())),
            out_specs=(sspec, specP, P(), P())))

    def _lists_struct(self):
        """Structural template of the cached-lists pytree (for specs)."""
        if not self.term_cache:
            return ()
        return (reax.AngleList(0, 0, 0, 0, 0, 0, 0, 0),
                reax.TorsionList(0, 0, 0, 0, 0, 0, 0, 0),
                reax.HBondList(0, 0, 0, 0, 0, 0))

    def _rb_specs(self):
        specP = P(("x", "y", "z"))
        sspec = ShardedState(*(specP,) * NFIELDS)
        return (sspec, specP, specP,
                _tree_specP(halo.HaloPlan(0, 0, 0, 0)),
                _tree_specP(neighbors.Neighbors(0, 0, 0, 0)),
                _tree_specP(self._lists_struct()), P())

    # ------------------------------------------------------------------
    def rebuild(self):
        (self.sstate, self._tex, self._gex, self._plan, self._nbrs,
         self._tlists, diag) = self._rebuild(self.sstate)
        self._frac_ref = self.sstate.frac
        self._steps_since_rebuild = 0
        self._maxdr2_dev = None
        self._check_rebuild_diag(diag)

    def _check_rebuild_diag(self, diag):
        """Abort on buffer/list overflow (ref: comm.F90:467-472,
        main.F90:402-407) — silent truncation is never acceptable."""
        d = np.asarray(diag)            # (ndev, 8)
        mig, hal, cell = d[:, 0].max(), d[:, 1].max(), d[:, 2].max()
        if mig > self.mcap:
            raise RuntimeError(
                f"migration buffer overflow: {mig} > mcap={self.mcap} "
                "(the reference aborts too, comm.F90:467-472)")
        if hal > self.bcap:
            raise RuntimeError(
                f"ghost buffer overflow: {hal} > bcap={self.bcap} "
                "(the reference aborts too, comm.F90:467-472)")
        if cell > self.grid.ccap:
            raise RuntimeError(
                f"cell-list overflow: {cell} > ccap={self.grid.ccap}")
        if d[:, 3].max() > self.kb or d[:, 4].max() > self.knb:
            raise RuntimeError(
                f"neighbor-list overflow: bonded {d[:, 3].max()}/{self.kb} "
                f"nonbonded {d[:, 4].max()}/{self.knb}")
        if self.term_cache:
            caps = (self.caps["ang"], self.caps["tor"], self.caps["hbf"])
            got = (d[:, 5].max(), d[:, 6].max(), d[:, 7].max())
            rows = [nm for nm, g in zip(("ang_row", "tor_row", "hb_row"), got)
                    if g >= reax.ROW_OVERFLOW]
            if rows:
                raise RuntimeError(
                    "interaction-list PER-ROW overflow in "
                    f"{'/'.join(rows)} — raise the corresponding *_row "
                    f"capacities (caps={self.caps}); the total ang/tor/hbf "
                    "caps are not the limiting knob here")
            if any(g > c for g, c in zip(got, caps)):
                raise RuntimeError(
                    f"interaction-list overflow: angles {got[0]}/{caps[0]} "
                    f"torsions {got[1]}/{caps[1]} hbonds {got[2]}/{caps[2]}"
                    " — raise caps (ref aborts too, main.F90:402-407)")

    def prepare(self):
        """Initial QEq + FORCE (ref: main.F90:27-32) via the sharded path."""
        self.rebuild()
        (self.sstate, self.force, self.comps, self.nqeq) = self._prepare(
            self.sstate, self._tex, self._gex, self._plan, self._nbrs,
            self._tlists)
        self.step_count = int(self.state0.step)
        self.ke = jnp.zeros((), self.dtype)
        self._astr = jnp.zeros((6,), self.dtype)
        self._astr_steps = 0
        return self.comps

    def run(self, nsteps, step0: int = None, log=None, writer=None):
        if not hasattr(self, "force"):
            if self.cfg.mdmode in (0, 6):
                self.init_velocity()
            self.prepare()
            if log:
                log(self.printe_line())
        if not hasattr(self, "_plan"):
            # caller seeded `force` directly (e.g. a zero-force smoke run)
            self.rebuild()
        if not hasattr(self, "_astr"):
            self._astr = jnp.zeros((6,), self.dtype)
            self._astr_steps = 0
        cfg = self.cfg
        if step0 is None:
            step0 = getattr(self, "step_count", 0)
        prev_nat = None
        self._last_maxdr = getattr(self, "_last_maxdr", None)
        self._vmax = getattr(self, "_vmax", None)
        k = 0
        while k < nsteps:
            stepno = step0 + k
            if cfg.mdmode in (0, 6) and stepno % cfg.sstep == 0 and k > 0:
                # periodic Maxwell-Boltzmann redraw (ref: main.F90:53-54)
                self.init_velocity(seed=stepno)
                self._vmax = None
            # drift check lags one step and is polled on a cadence (each
            # poll is a device->host read); the 0.8x trigger absorbs both
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
                self.rebuild()
                self._last_maxdr = None

            # steps until the next host boundary (same scheduling as
            # md.Engine.run; blocks only when every step does QEq)
            nb = nsteps - k
            if log:
                nb = min(nb, cfg.pstep - stepno % cfg.pstep)
            if writer is not None:
                nb = min(nb, cfg.fstep - stepno % cfg.fstep)
            if cfg.mdmode in (0, 6):
                nb = min(nb, cfg.sstep - stepno % cfg.sstep)
            nb = min(nb, self.rebuild_every - self._steps_since_rebuild)
            if cfg.qstep > 1:
                nb = 1
            if self._vmax is None and nb >= self.block_steps > 1:
                self._vmax = float(jnp.max(jnp.where(
                    self.sstate.valid,
                    jnp.sum(self.sstate.vel * self.sstate.vel, axis=1),
                    0.0))) ** 0.5
            if self._vmax is not None and self._vmax > 0.0:
                room = 0.8 * self.drift_trigger - (self._last_maxdr or 0.0)
                budget = int(room / (1.25 * self._vmax * self.dt))
                nb = min(nb, max(budget, 1))

            if nb >= self.block_steps > 1:
                if self._mstep is None:
                    self._mstep = self._make_step_program(
                        True, self.block_steps)
                out = self._mstep(self.sstate, self.force, self._tex,
                                  self._gex, self._plan, self._nbrs,
                                  self._tlists, self._frac_ref,
                                  jnp.int32(stepno))
                (self.sstate, self.force, self.comps, self.nqeq, self.ke,
                 dastr, nat, mdr, vmax2) = out
                self._last_maxdr = float(mdr) ** 0.5
                self._vmax = float(vmax2) ** 0.5
                self._maxdr2_dev = None
                nadv = self.block_steps
            else:
                fn = (self._step_qeq if stepno % cfg.qstep == 0
                      else self._step_noqeq)
                do_scale = jnp.asarray(stepno % cfg.sstep == 0)
                out = fn(self.sstate, self.force, self._tex, self._gex,
                         self._plan, self._nbrs, self._tlists,
                         self._frac_ref, do_scale)
                (self.sstate, self.force, self.comps, self.nqeq, self.ke,
                 dastr, nat, self._maxdr2_dev) = out
                nadv = 1
            self._astr = self._astr + dastr
            self._astr_steps += nadv
            self._steps_since_rebuild += nadv
            k += nadv
            self.step_count = stepno + nadv
            emit_log = log and self.step_count % cfg.pstep == 0
            emit_frame = writer is not None and \
                self.step_count % cfg.fstep == 0
            if emit_log or emit_frame:
                natoms = int(np.asarray(nat)[0])
                if natoms != self.state0.n:
                    raise RuntimeError(
                        f"atom count changed: {natoms} != {self.state0.n}")
                prev_nat = None
            else:
                if prev_nat is not None:
                    natoms = int(np.asarray(prev_nat)[0])
                    if natoms != self.state0.n:
                        raise RuntimeError(
                            f"atom count changed: {natoms} != "
                            f"{self.state0.n}")
                prev_nat = nat
            if emit_log:
                log(self.printe_line())
            if emit_frame:
                writer(self)
        jax.block_until_ready(self.sstate.frac)
        if prev_nat is not None:
            natoms = int(np.asarray(prev_nat)[0])
            if natoms != self.state0.n:
                raise RuntimeError(
                    f"atom count changed: {natoms} != {self.state0.n}")
        return self.comps

    # ------------------------------------------------------------------
    # Structural-optimization surface (mdmode 10; ref: cg.F90).  The CG
    # loop in opt.py drives these through an adapter: `cg_evaluate` is the
    # sharded EvaluateEnergyWithStep (ref: cg.F90:358-387) and `cg_resync`
    # migrates the CG direction/gradient vectors with their atoms
    # (ref: MigrateVec3D cg.F90:292-314).
    def _build_cg_programs(self):
        specP = P(("x", "y", "z"))
        sspec = ShardedState(*(specP,) * NFIELDS)

        def eval_block(s: ShardedState, pos_blk):
            frac = jnp.where(s.valid[:, None], pos_blk @ self.Hi.T, 0.0)
            s = s._replace(frac=frac)
            # fresh plan + lists every evaluation, like the reference's
            # full FORCE per probe (cg.F90:376-384); no migration — slots
            # must stay aligned with the caller's direction vectors
            spec = self.spec
            plan, frac_ext, valid_ext = halo.build_plan(s.frac, s.valid,
                                                        spec)
            tex = halo.apply_plan(plan, s.types, spec)
            gex = halo.apply_plan(plan, s.gid, spec)
            mylo = self._local_frame()
            pos_rel = (frac_ext - mylo[None, :]) @ self.Hg.T
            nbrs, _ = neighbors.build_neighbors_cells(
                pos_rel, valid_ext, tex, self.grid, self.rc2b_ext,
                self.rctap2_ext, self.kb, self.knb,
                row_chunk=(self.cfg.list_chunk
                           if 0 < self.cfg.list_chunk < self.mext else 0))
            out = self._compute(s, tex, gex, plan, nbrs, (), True,
                                prep=(self.cfg.isQEq == 2))
            q, _qsfp, _qsfv, _spos, f, comps, _w, _nq = out
            return comps[0], f, q

        self._cg_eval = jax.jit(jax.shard_map(
            eval_block, mesh=self.mesh, in_specs=(sspec, specP),
            out_specs=(P(), specP, specP)))

        def resync_block(s: ShardedState, pos_blk, g, p):
            frac = jnp.where(s.valid[:, None], (pos_blk @ self.Hi.T) % 1.0,
                             0.0)
            s = s._replace(frac=frac)
            s, ex, mig_max = self._migrate(s, {"g": g, "p": p})
            pos2 = jnp.where(s.valid[:, None], s.frac @ self.Hg.T, 0.0)
            return (s, pos2, ex["g"], ex["p"],
                    jax.lax.pmax(mig_max, ("x", "y", "z")))

        self._cg_resync = jax.jit(jax.shard_map(
            resync_block, mesh=self.mesh,
            in_specs=(sspec, specP, specP, specP),
            out_specs=(sspec, specP, specP, specP, P())))

    def cg_positions(self):
        """Block-layout absolute positions (invalid slots zero)."""
        return jnp.where(self.sstate.valid[:, None],
                         self.sstate.frac @ self.Hg.T, 0.0)

    def cg_evaluate(self, pos_blk):
        """(total PE, forces, charges) at the given block positions."""
        if not hasattr(self, "_cg_eval"):
            self._build_cg_programs()
        return self._cg_eval(self.sstate, pos_blk)

    def cg_resync(self, pos_blk, g, p):
        """Commit positions, migrate atoms + CG vectors across the mesh."""
        if not hasattr(self, "_cg_eval"):
            self._build_cg_programs()
        self.sstate, pos2, g2, p2, mig = self._cg_resync(
            self.sstate, pos_blk, g, p)
        if int(mig) > self.mcap:
            raise RuntimeError(
                f"migration buffer overflow: {int(mig)} > mcap={self.mcap}")
        return pos2, g2, p2

    def cg_commit(self, pos_blk, q_blk):
        """Write optimized positions/charges back into the engine state."""
        frac = jnp.where(self.sstate.valid[:, None],
                         (pos_blk @ self.Hi.T) % 1.0, 0.0)
        self.sstate = self.sstate._replace(
            frac=frac, q=jnp.where(self.sstate.valid, q_blk, 0.0))

    # ------------------------------------------------------------------
    def init_velocity(self, seed=0):
        """Gaussian velocities scaled to treq with zero net momentum
        (ref: INITVELOCITY init.F90:292-360).  gid-deterministic: the draw
        is made in global-atom-id order with the same RNG as
        md.Engine.init_velocity, so sharded and single-device trajectories
        match bit-for-bit in f64."""
        n = self.state0.n
        rng = np.random.default_rng(seed)
        v = rng.normal(size=(n, 3))
        types_g = np.zeros(n, np.int32)
        gid_h, types_h, valid_h = (np.asarray(self._gather_field(x))
                                   for x in (self.sstate.gid,
                                             self.sstate.types,
                                             self.sstate.valid))
        types_g[gid_h[valid_h]] = types_h[valid_h]
        m = np.asarray(2.0 * self.hmas)[types_g]
        v -= (m[:, None] * v).sum(0) / m.sum()
        ke = 0.5 * (m * (v * v).sum(1)).sum() / n
        v *= np.sqrt(1.5 * (self.cfg.treq / units.UTEMP0) / ke)
        vblk = np.zeros((self.ndev * self.ncap, 3))
        vblk[valid_h] = v[gid_h[valid_h]]
        self.sstate = self.sstate._replace(
            vel=self._commit(vblk.astype(self.dtype)))

    def _gather_field(self, arr):
        """Full copy of one sharded field on every host (used only for the
        rare velocity redraws and gathered output)."""
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            return multihost_utils.process_allgather(arr, tiled=True)
        return jax.device_get(arr)

    # ------------------------------------------------------------------
    # Output surface.  `to_state` gathers to the host (the fallback path);
    # `write_frame_slab` in io/slab.py writes per-process slabs without
    # gathering positions (the analog of the reference's MPI-IO offsets,
    # fileio.F90:81-95).
    def to_state(self) -> State:
        """Gather the sharded state into a host-ordered State (sorted by
        global atom id), e.g. for trajectory/checkpoint output.  On a
        multi-host mesh every process receives the full gathered state
        (the analog of the reference's MPI-IO shared file each rank can
        read back, fileio.F90:444-555)."""
        from ..system import make_state
        ss = jax.tree.map(np.asarray,
                          jax.tree.map(self._gather_field, self.sstate))
        sel = np.where(ss.valid)[0]
        order = sel[np.argsort(ss.gid[sel], kind="stable")]
        frac = ss.frac[order] % 1.0
        pos = frac @ np.asarray(self.Hg).T
        return make_state(
            pos=pos, types=ss.types[order], H=np.asarray(self.Hg),
            vel=ss.vel[order], q=ss.q[order], qsfp=ss.qsfp[order],
            qsfv=ss.qsfv[order], gid=ss.gid[order],
            spos=ss.spos[order],
            step=getattr(self, "step_count", 0), dtype=self.dtype)

    def pressure_gpa(self, reset=True):
        """Pressure [GPa] from the per-step accumulated stress, normalized
        like the reference PRINTE (ref: main.F90:252-253,269); same
        semantics as md.Engine.pressure_gpa."""
        astr = np.asarray(getattr(self, "_astr", np.zeros(6)))
        vol = abs(float(jnp.linalg.det(self.Hg)))
        nst = getattr(self, "_astr_steps", 0) or max(self.cfg.pstep, 1)
        ss = astr[:3].sum() / 3.0 / vol * units.USTRS / nst
        if reset:
            self._astr = jnp.zeros((6,), self.dtype)
            self._astr_steps = 0
        return float(ss)

    def printe_line(self):
        """PRINTE-format observables, column-for-column identical to the
        single-device engine (ref: main.F90:210-263)."""
        n = self.state0.n
        ke = float(self.ke) / n
        pe = np.asarray(self.comps) / n
        te = ke + pe[0]
        tt = ke * units.UTEMP
        ss = self.pressure_gpa()
        qq = float(jnp.sum(jnp.where(self.sstate.valid, self.sstate.q, 0.0)))
        return (f"MDstep: {getattr(self, 'step_count', 0):9d} {te: .5E} "
                f"{pe[0]: .5E} {ke: .5E} "
                f"{pe[1]: .3E} {pe[2:5].sum(): .3E} {pe[5:8].sum(): .3E} "
                f"{pe[8:10].sum(): .3E} {pe[10]: .3E} {pe[11:14].sum(): .3E} "
                f"{tt:8.2f} {ss:8.2f} {qq:8.2f} {int(self.nqeq):4d}")

    def write_frame(self, base_path: str, st: State = None):
        """Write configured trajectory formats from the gathered state
        (ref: OUTPUT fileio.F90:5-20).  Pass `st` when the caller already
        gathered (to_state is a cross-host collective: every process must
        call it the same number of times)."""
        from ..io import traj, refbin
        from ..md import bond_table
        cfg = self.cfg
        if st is None:
            st = self.to_state()
        names = self.ff.atom_names
        if cfg.is_xyz:
            traj.write_xyz(base_path + ".xyz", st, names)
        if cfg.is_pdb:
            traj.write_pdb(base_path + ".pdb", st, names)
        if cfg.is_bondfile:
            # bond table from the gathered state (ref: WriteBND
            # fileio.F90:27-148)
            g, b, c = bond_table(self.ffd, st, self.ff, kb=self.kb)
            traj.write_bnd(base_path + ".bnd", st, g, b, c)
        if cfg.is_binary:
            refbin.write_rxff_bin(base_path + ".bin", st)

    def write_frame_slab(self, base_path: str):
        """Scalable output: every process writes ONLY its own residents at
        precomputed offsets (the MPI-IO analog, ref: fileio.F90:81-95);
        no position allgather.  Formats: .xyz (gid-indexed fixed-width
        records, byte-identical to the serial writer) and the reference
        rxff.bin (per-device slabs, restartable by the reference at the
        mesh's vprocs layout)."""
        from ..io import slab
        cfg = self.cfg
        if cfg.is_xyz:
            slab.write_xyz_slab(base_path + ".xyz", self)
        if cfg.is_binary:
            slab.write_bin_slab(base_path + ".bin", self)

    @property
    def n_atoms(self):
        return int(self.sstate.valid.sum())
