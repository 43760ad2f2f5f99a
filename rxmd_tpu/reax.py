"""ReaxFF potential: bond-order pipeline and all energy terms.

A JAX re-design of the reference's force kernels (ref: src/bo.F90,
src/pot.F90).  Everything operates on fixed-shape padded neighbor arrays and
is fully vectorized; there are no per-atom loops.  The reference's
`!$omp atomic` force scatters become the transpose of gathers under
`jax.grad`: scatter-adds, which XLA lowers to segment sums on the CPU and
to atomics on a GPU (so GPU sums may differ between runs in the last bits).

Energy expressions reproduce the reference *exactly* (including the
cutoff_vpar30 energy/force split, BO floors, and cutof2_esub shifts) so the
RDX golden trace (ref: README.md:156-159) is matched.  Forces are the exact
negative gradient of this energy — self-consistent by construction, which
gives equal-or-better NVE conservation than the reference's hand-coded
derivative chain (ref: pot.F90:1230-1521).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import units
from .ffield import ForceField, build_tables
from .neighbors import ImageTable, Neighbors, ext_positions


class FFDev(NamedTuple):
    """Force-field constants as device arrays (built once per run)."""
    # scalars
    vpar1: jax.Array
    vpar2: jax.Array
    cutoff_vpar30: jax.Array
    # per-type (nso,)
    Val: jax.Array
    Valboc: jax.Array
    Vale: jax.Array
    Valangle: jax.Array
    Valval: jax.Array
    mass: jax.Array
    plp1: jax.Array
    plp2: jax.Array
    nlpopt: jax.Array
    povun2: jax.Array
    povun3: jax.Array
    povun4: jax.Array
    povun5: jax.Array
    povun6: jax.Array
    povun7: jax.Array
    povun8: jax.Array
    pval3: jax.Array
    pval5: jax.Array
    chi: jax.Array
    eta: jax.Array
    # per-bond-type (nboty,)
    inxn2: jax.Array          # (nso, nso) int32, -1 = none
    rc2b: jax.Array           # (nso, nso) squared bond cutoff (0 if none)
    cBOp1: jax.Array
    cBOp3: jax.Array
    cBOp5: jax.Array
    pbo2h: jax.Array
    pbo4h: jax.Array
    pbo6h: jax.Array
    switch: jax.Array         # (nboty, 3)
    ovc: jax.Array
    v13cor: jax.Array
    pboc3: jax.Array
    pboc4: jax.Array
    pboc5: jax.Array
    Desig: jax.Array
    Depi: jax.Array
    Depipi: jax.Array
    pbe1: jax.Array
    pbe2: jax.Array
    povun1: jax.Array
    # angle types
    inxn3: jax.Array          # (nso,nso,nso) int32
    theta00: jax.Array
    pval1: jax.Array
    pval2: jax.Array
    pval4: jax.Array
    pval6: jax.Array
    pval7: jax.Array
    pval8: jax.Array
    pval9: jax.Array
    pval10: jax.Array
    ppen1: jax.Array
    ppen2: jax.Array
    ppen3: jax.Array
    ppen4: jax.Array
    pcoa1: jax.Array
    pcoa2: jax.Array
    pcoa3: jax.Array
    pcoa4: jax.Array
    # torsion types
    inxn4: jax.Array          # (nso,nso,nso,nso) int32
    V1: jax.Array
    V2: jax.Array
    V3: jax.Array
    ptor1: jax.Array
    ptor2: jax.Array
    ptor3: jax.Array
    ptor4: jax.Array
    pcot1: jax.Array
    pcot2: jax.Array
    # hydrogen bond types
    inxn3hb: jax.Array        # (nso,nso,nso) int32 (directional)
    r0hb: jax.Array
    phb1: jax.Array
    phb2: jax.Array
    phb3: jax.Array
    h_type: int               # type index of hydrogen (static)
    # nonbonded tables, (nboty, NTABLE+1)
    tbl_evdw: jax.Array
    tbl_eclmb: jax.Array
    tbl_devdw: jax.Array      # (dE/dr)/r columns (ref: TBL_*(1,..))
    tbl_declmb: jax.Array
    tbl_eclmb_qeq: jax.Array
    udr: jax.Array
    udri: jax.Array
    rctap2: jax.Array
    # --- closed-form nonbond kernels (production path; the tables above are
    # kept for bit-parity validation against the reference's interpolation,
    # ref: init.F90:421-522): evaluating the analytic kernel and selecting
    # per-pair-type params with a one-hot matmul replaces 8 table-value
    # gathers per pair.
    pvdW1h: jax.Array         # () scalar
    pvdW1inv: jax.Array
    ctap: jax.Array           # (8,) taper coefficients
    cf_pair: jax.Array        # (nso, nso, 11): [exists, gamW^-p, alpha,
                              #  1/rvdW, Dij, gamij, C_lg, dr6_lg, ecore,
                              #  acore, 1/rcore]
    is_lg: bool               # static
    # packed per-interaction-type parameter rows (one row gather replaces
    # 9-17 separate small-table gathers)
    angprm: jax.Array         # (nanty, 17)
    torprm: jax.Array         # (ntoty, 9)
    hbprm: jax.Array          # (nhbty, 4)
    hbok: jax.Array           # (nso, nso, nso) 1.0 where an hbond type exists
    t4ok: jax.Array           # (nso, nso, nso, nso) 1.0 where torsion exists
    # row-packed nonbond tables: (nboty*(NTABLE+1), 5) columns
    # [evdw, eclmb, devdw, declmb, eclmb_qeq] — interpolation needs only TWO
    # row gathers instead of 8-10 scalar gathers, with values bit-identical
    # to the reference's tables
    tblpack: jax.Array


def ffdev_from(ff: ForceField, dtype=jnp.float64, rctap: float = None,
               tables: dict = None) -> FFDev:
    if rctap is None:
        rctap = units.RCTAP0
    if tables is None:
        tables = build_tables(ff, rctap=rctap)
    rc2b = np.zeros((ff.nso, ff.nso))
    for i in range(ff.nso):
        for j in range(ff.nso):
            b = ff.inxn2[i, j]
            if b >= 0:
                rc2b[i, j] = ff.rc2[b]
    try:
        h_type = ff.atom_names.index("H")
    except ValueError:
        h_type = 1  # the reference hardcodes type 2 (1-based) as H
                    # (ref: pot.F90:595 and comment pot.F90:561-567)
    f = lambda a: jnp.asarray(a, dtype)
    i32 = lambda a: jnp.asarray(a, jnp.int32)

    # closed-form pair parameter tensor (see FFDev.cf_pair)
    nso = ff.nso
    cf = np.zeros((nso, nso, 11))
    for i in range(nso):
        for j in range(nso):
            b = ff.inxn2[i, j]
            if b < 0:
                continue
            cf[i, j, 0] = 1.0
            cf[i, j, 1] = (1.0 / ff.gamW[i, j]) ** ff.pvdW1
            cf[i, j, 2] = ff.alpij[i, j]
            cf[i, j, 3] = 1.0 / ff.rvdW[i, j]
            cf[i, j, 4] = ff.Dij[i, j]
            cf[i, j, 5] = ff.gamij[i, j]
            if ff.is_lg and i < 4 and j < 4:
                cf[i, j, 6] = ff.C_lg[i, j]
                cf[i, j, 7] = (2.0 * np.sqrt(ff.Re_lg[i] * ff.Re_lg[j])) ** 6
                cf[i, j, 8] = ff.ecore[i, j]
                cf[i, j, 9] = ff.acore[i, j]
                cf[i, j, 10] = 1.0 / ff.rcore[i, j] if ff.rcore[i, j] else 0.0

    angprm = np.stack([
        ff.theta00, ff.pval1, ff.pval2, ff.pval4, ff.pval6, ff.pval7,
        ff.pval8, ff.pval9, ff.pval10, ff.ppen1, ff.ppen2, ff.ppen3,
        ff.ppen4, ff.pcoa1, ff.pcoa2, ff.pcoa3, ff.pcoa4], axis=-1)
    torprm = np.stack([ff.V1, ff.V2, ff.V3, ff.ptor1, ff.ptor2, ff.ptor3,
                       ff.ptor4, ff.pcot1, ff.pcot2], axis=-1)
    if ff.r0hb.shape[0] > 0:
        hbprm = np.stack([ff.r0hb, ff.phb1, ff.phb2, ff.phb3], axis=-1)
    else:
        hbprm = np.zeros((0, 4))

    return FFDev(
        vpar1=f(ff.vpar1), vpar2=f(ff.vpar2),
        cutoff_vpar30=f(ff.cutoff_vpar30),
        Val=f(ff.Val), Valboc=f(ff.Valboc), Vale=f(ff.Vale),
        Valangle=f(ff.Valangle), Valval=f(ff.Valval), mass=f(ff.mass),
        plp1=f(ff.plp1), plp2=f(ff.plp2), nlpopt=f(ff.nlpopt),
        povun2=f(ff.povun2), povun3=f(ff.povun3), povun4=f(ff.povun4),
        povun5=f(ff.povun5), povun6=f(ff.povun6), povun7=f(ff.povun7),
        povun8=f(ff.povun8), pval3=f(ff.pval3), pval5=f(ff.pval5),
        chi=f(ff.chi), eta=f(ff.eta),
        inxn2=i32(ff.inxn2), rc2b=f(rc2b),
        cBOp1=f(ff.cBOp1), cBOp3=f(ff.cBOp3), cBOp5=f(ff.cBOp5),
        pbo2h=f(ff.pbo2h), pbo4h=f(ff.pbo4h), pbo6h=f(ff.pbo6h),
        switch=f(ff.switch), ovc=f(ff.ovc), v13cor=f(ff.v13cor),
        pboc3=f(ff.pboc3), pboc4=f(ff.pboc4), pboc5=f(ff.pboc5),
        Desig=f(ff.Desig), Depi=f(ff.Depi), Depipi=f(ff.Depipi),
        pbe1=f(ff.pbe1), pbe2=f(ff.pbe2), povun1=f(ff.povun1),
        inxn3=i32(ff.inxn3), theta00=f(ff.theta00), pval1=f(ff.pval1),
        pval2=f(ff.pval2), pval4=f(ff.pval4), pval6=f(ff.pval6),
        pval7=f(ff.pval7), pval8=f(ff.pval8), pval9=f(ff.pval9),
        pval10=f(ff.pval10), ppen1=f(ff.ppen1), ppen2=f(ff.ppen2),
        ppen3=f(ff.ppen3), ppen4=f(ff.ppen4), pcoa1=f(ff.pcoa1),
        pcoa2=f(ff.pcoa2), pcoa3=f(ff.pcoa3), pcoa4=f(ff.pcoa4),
        inxn4=i32(ff.inxn4), V1=f(ff.V1), V2=f(ff.V2), V3=f(ff.V3),
        ptor1=f(ff.ptor1), ptor2=f(ff.ptor2), ptor3=f(ff.ptor3),
        ptor4=f(ff.ptor4), pcot1=f(ff.pcot1), pcot2=f(ff.pcot2),
        inxn3hb=i32(ff.inxn3hb), r0hb=f(ff.r0hb), phb1=f(ff.phb1),
        phb2=f(ff.phb2), phb3=f(ff.phb3), h_type=h_type,
        tbl_evdw=f(tables["evdw"]), tbl_eclmb=f(tables["eclmb"]),
        tbl_devdw=f(tables["devdw"]), tbl_declmb=f(tables["declmb"]),
        tbl_eclmb_qeq=f(tables["eclmb_qeq"]),
        udr=f(tables["udr"]), udri=f(tables["udri"]),
        rctap2=f(tables["rctap2"]),
        pvdW1h=f(0.5 * ff.pvdW1), pvdW1inv=f(1.0 / ff.pvdW1),
        ctap=f(np.array(units.taper_coeffs(rctap))),
        cf_pair=f(cf), is_lg=bool(ff.is_lg),
        angprm=f(angprm), torprm=f(torprm), hbprm=f(hbprm),
        hbok=f((ff.inxn3hb >= 0).astype(np.float64)),
        t4ok=f((ff.inxn4 >= 0).astype(np.float64)),
        tblpack=f(np.stack(
            [tables["evdw"], tables["eclmb"], tables["devdw"],
             tables["declmb"], tables["eclmb_qeq"]],
            axis=-1).reshape(-1, 5)),
    )


# ----------------------------------------------------------------------------
# small numerics helpers (NaN-safe under grad)
# ----------------------------------------------------------------------------

def _safe(x, mask, safe_val=1.0):
    """Replace masked-out lanes with a benign value before nonlinear ops so
    neither the forward pass nor the gradient produces NaN/Inf there."""
    return jnp.where(mask, x, safe_val)


def _powm(x, p, mask):
    """x**p with masked lanes forced to a safe base."""
    return jnp.where(mask, _safe(x, mask) ** p, 0.0)


# Overflow-safe exponentials for delta-dependent terms.  Padding rows in the
# fixed-capacity sharded layout (and outermost halo ghosts with truncated
# neighbor lists) carry delta ~= -Val; with e.g. vpar1=50 the reference's
# unguarded exp (bo.F90:156-217) would evaluate exp(200) there — finite in the
# reference's f64, but +inf in f32, which poisons every gradient through
# masked lanes (inf * 0 = NaN).  The clamp at +-85 (exp(85)=8.2e36 < f32 max)
# is a no-op for every physically reachable argument, so f64 golden traces
# are unchanged.
_EXP_CAP = 85.0


def _exp(x):
    return jnp.exp(jnp.clip(x, -_EXP_CAP, _EXP_CAP))


def _ratio23(a, b):
    """(2 + e^a) / (1 + e^a + e^b), overflow-free in the forward AND the
    backward pass (softmax-style max-shift: every exponent <= 0).

    The naive form's backward pass squares e^a in the quotient rule; with
    ReaxFF exponents like pval6=33.9 (FeS) the f32 intermediate overflows
    and fabricates O(10^3) forces while the VALUE stays finite — observed
    as an f32-only NVE blowup on pyrite (f64 conserved)."""
    m = jnp.maximum(jnp.maximum(a, b), 0.0)
    ea = jnp.exp(a - m)
    eb = jnp.exp(b - m)
    e0 = jnp.exp(-m)
    return (2.0 * e0 + ea) / (e0 + ea + eb)


def _logistic(u):
    """1/(1+exp(u)) via sigmoid: overflow-free forward AND backward."""
    return jax.nn.sigmoid(-u)


# ----------------------------------------------------------------------------
# Shared nonbonded pair context.
#
# The pair terms are bound by random gathers from device memory, not by
# flops.  So: gather all per-neighbor data (position, charge, type) in ONE
# packed row gather, derive everything else arithmetically, and select
# per-pair-type parameters with a one-hot matmul instead of a small-table
# gather.
# ----------------------------------------------------------------------------

class NbCtx(NamedTuple):
    idx: jax.Array      # (n, knb) clamped ext indices
    mask: jax.Array     # (n, knb) slot valid & within taper & live row
    notself: jax.Array  # (n, knb) excludes periodic self-images (gid rule,
                        # ref: pot.F90:715) — QEq keeps them, ENbond drops
    dr: jax.Array       # (3, n, knb) r_i - r_j, CHANNEL-MAJOR (stop-grad):
                        # keeps the size-3 axis out of the minor dimension,
                        # which tiled layouts pad
    dr2: jax.Array      # (n, knb)
    qj: jax.Array       # (n, knb)
    tjf: jax.Array      # (n, knb) neighbor type as float (gathered col)
    nso: int            # number of atom types (static)


def ctx_tjoh(ctx: NbCtx):
    """Neighbor-type one-hot (n, knb, nso), computed on the fly from the
    gathered float type column (an elementwise compare, cheaper than
    gathering nso one-hot columns per pair)."""
    t = jax.lax.broadcasted_iota(ctx.tjf.dtype, (ctx.nso,), 0)
    return (ctx.tjf[..., None] == t).astype(ctx.tjf.dtype)


def ctx_prm(ctx: NbCtx, types, ffd: FFDev):
    """Closed-form pair params (n, knb, P) for the analytic kernels:
    one-hot x per-row param matrix (batched matmul, exact)."""
    prow = ffd.cf_pair[types]                # (n, nso, P): tiny gather
    return jnp.einsum("nkc,ncp->nkp", ctx_tjoh(ctx), prow,
                      preferred_element_type=prow.dtype)


def ctx_qj(ctx: NbCtx, q, img: ImageTable):
    """Neighbor charges (n, knb) for a given charge vector — a 1-column
    gather, so QEq (pre-solve q) and the nonbond kernels (post-solve q) can
    share one geometry context."""
    # gather by OWNER (q is image-independent) in 2-column row-gather form
    # (a lowering choice; see _rowgather2).  The barrier hides that the
    # columns are identical (XLA would narrow the gather back to one
    # column), and averaging them keeps both used.
    oj = img.owner_of(ctx.idx)
    qpack = jax.lax.optimization_barrier(jnp.stack([q, q], axis=1))
    rows = qpack[oj]
    return 0.5 * (rows[..., 0] + rows[..., 1])


def pair_rows(ctx: NbCtx, types, ffd: FFDev):
    """All 5 packed interpolation-table columns over the pair context
    (Evdw, Eclmb, dEvdw, dEclmb, Hqeq — ref: POTENTIALTABLE init.F90:421-522)
    plus the pair-exists mask.  Built ONCE per step and shared by the QEq
    hessian and the nonbond kernels (they walk the same pair list)."""
    bc = pair_bond_type(ctx, types, ffd)
    ok = ctx.mask & (bc >= 0)
    rows = _table_rows(ffd, jnp.where(ok, bc, 0), ctx.dr2, ok)
    return rows, ok


def nb_ctx(pos, q, H, types, img: ImageTable, nbrs: Neighbors, gid, amask,
           ffd: FFDev) -> NbCtx:
    """Build the shared nonbonded pair data with a single packed row gather
    of 4-5 columns (pose, [q,] type); type-dependent per-pair params are
    derived on demand (`ctx_tjoh`/`ctx_prm`), and q=None omits the charge
    column (gather it later with `ctx_qj`).  Not differentiable (the fast
    force paths use the analytic derivative columns instead of autodiff,
    ref: pot.F90:736-761)."""
    n = pos.shape[0]
    nso = ffd.cf_pair.shape[0]
    dtype = pos.dtype
    pos = jax.lax.stop_gradient(pos)
    pose = ext_positions(pos, H, img)
    S = img.n_images
    tf = types.astype(dtype)
    tfe = jnp.tile(tf, S) if S > 1 else tf
    cols = [pose, tfe[:, None]]
    if q is not None:
        qe = jnp.tile(q, S) if S > 1 else q
        cols.insert(1, qe[:, None])
    packed = jnp.concatenate(cols, axis=1)
    masks = nbrs.masknb
    idx = jnp.where(masks, nbrs.idxnb, 0)
    rows = packed[idx]                       # (n, knb, 4|5): the ONE gather
    # channel-major displacements: (3, n, knb) tiles cleanly; (n, knb, 3)
    # would materialize with its minor dim padded 3 -> 128 (42.7x HBM)
    dr = jnp.moveaxis(pos[:, None, :] - rows[..., :3], -1, 0)
    dr2 = jnp.sum(dr * dr, axis=0)
    qj = rows[..., 3] if q is not None else None
    tjf = rows[..., -1]
    if S > 1:
        # image mode: same owner <=> same global id
        notself = img.owner_of(idx) != jnp.arange(n)[:, None]
    else:
        notself = gid[idx] != gid[:, None]   # sharded: ghosts carry gids
    mask = masks & (dr2 <= ffd.rctap2) & amask[:, None]
    return NbCtx(idx=idx, mask=mask, notself=notself, dr=dr, dr2=dr2,
                 qj=qj, tjf=tjf, nso=nso)


def _taper_pair(dr2, dr1, ctap):
    """Taper polynomial and its r-derivative/r (ref: init.F90:437-439)."""
    dr3 = dr1 * dr2
    dr4 = dr2 * dr2
    dr5 = dr1 * dr4
    dr6 = dr2 * dr4
    dr7 = dr1 * dr6
    tap = (ctap[7] * dr7 + ctap[6] * dr6 + ctap[5] * dr5 + ctap[4] * dr4
           + ctap[0])
    dtap = (7.0 * ctap[7] * dr5 + 6.0 * ctap[6] * dr4 + 5.0 * ctap[5] * dr3
            + 4.0 * ctap[4] * dr2)
    return tap, dtap


def cf_nonbond(dr2, prm, ffd: FFDev, mask):
    """Closed-form vdW and Coulomb kernels + (dE/dr)/r derivative columns —
    the analytic content of the reference's tables (ref: init.F90:440-514,
    incl. the LG dispersion + inner-core terms init.F90:496-514)."""
    ok = mask & (prm[..., 0] > 0.5)
    dr2s = _safe(dr2, ok)
    dr1 = jnp.sqrt(dr2s)
    tap, dtap = _taper_pair(dr2s, dr1, ffd.ctap)
    gamwinvp = prm[..., 1]
    alpha = prm[..., 2]
    rvdwi = prm[..., 3]
    dij = prm[..., 4]
    gamij = prm[..., 5]
    rij_vd1 = dr2s ** ffd.pvdW1h
    fn13 = (rij_vd1 + _safe(gamwinvp, ok)) ** ffd.pvdW1inv
    exp1 = jnp.exp(alpha * (1.0 - fn13 * rvdwi))
    exp2 = jnp.sqrt(exp1)
    dr3 = dr1 * dr2s
    dr3gam = (dr3 + _safe(gamij, ok)) ** (-1.0 / 3.0)
    evdw = tap * dij * (exp1 - 2.0 * exp2)
    eclmb1 = tap * units.CCLMB0 * dr3gam          # per unit q_i q_j
    dfn13 = ((rij_vd1 + _safe(gamwinvp, ok)) ** (ffd.pvdW1inv - 1.0)
             * dr2s ** (ffd.pvdW1h - 1.0))
    devdw = dij * (dtap * (exp1 - 2.0 * exp2)
                   - tap * (alpha * rvdwi) * (exp1 - exp2) * dfn13)
    declmb1 = units.CCLMB0 * dr3gam * (dtap - dr3gam ** 3 * tap * dr1)
    if ffd.is_lg:
        dr6 = dr3 * dr3
        dr6lg = prm[..., 7]
        clg = prm[..., 6]
        elg = -clg / (dr6 + _safe(dr6lg, ok))
        ecore = prm[..., 8] * jnp.exp(prm[..., 9] * (1.0 - dr1 * prm[..., 10]))
        delg = clg * 6.0 * dr2s * dr2s / (dr6 + _safe(dr6lg, ok)) ** 2
        decore = -prm[..., 9] * ecore * prm[..., 10] / dr1
        evdw = evdw + tap * (elg + ecore)
        devdw = devdw + dtap * (elg + ecore) + tap * (delg + decore)
    return evdw, eclmb1, devdw, declmb1, ok


def cf_qeq_kernel(dr2, prm, ffd: FFDev, mask):
    """Closed-form QEq hessian kernel Tap(r) * 14.4 / (r^3+gamma)^(1/3)
    (ref: qeq kernel of POTENTIALTABLE, init.F90:487-489)."""
    ok = mask & (prm[..., 0] > 0.5)
    dr2s = _safe(dr2, ok)
    dr1 = jnp.sqrt(dr2s)
    tap, _ = _taper_pair(dr2s, dr1, ffd.ctap)
    dr3gam = (dr1 * dr2s + _safe(prm[..., 5], ok)) ** (-1.0 / 3.0)
    return jnp.where(ok, tap * units.CCLMB0_QEQ * dr3gam, 0.0)


# ----------------------------------------------------------------------------
# Dense minimum-image nonbonded kernels (fast path for moderate N).
#
# The ELL neighbor-list formulation is bound by dynamic row gathers.  For
# moderate system sizes an O(N^2) dense evaluation with minimum-image
# wrapping has NO gathers at all: per-pair type parameters come from tiny
# one-hot matmuls, the pair kernel is elementwise work, and the QEq CG
# matvecs become (n,n)@(n,2) matmuls that stream from device memory.
# Valid when the box is orthogonal and min(L) > 2*rctap (every pair has at
# most one image within the cutoff); selected by the engine for
# n <= cfg.dense_direct_max.  Physics is identical to the closed-form ELL
# path (same kernels, same cutoffs); only the summation order differs.
# ----------------------------------------------------------------------------

def _type_prm_dense(types, P):
    """(n, n) per-pair parameter matrix  P[t_i, t_j]  via two one-hot
    matmuls (never a 20M-element small-table gather)."""
    nso = P.shape[0]
    dtype = P.dtype
    oh = (types[:, None] == jnp.arange(nso)[None, :]).astype(dtype)  # (n,nso)
    return (oh @ P) @ oh.T


def _min_image_ax(pos, H, ax):
    """Per-axis raw difference and wrap count (diagonal box)."""
    La = H[ax, ax]
    d = pos[:, None, ax] - pos[None, :, ax]
    s = jnp.round(d / La)
    return d - s * La, s


def qeq_dense_direct(pos, H, types, ffd: FFDev, resident_weight=True):
    """(H, Hw): the dense (n, n) QEq 'hessian' Tap(r)*14.4/(r^3+gam)^(1/3)
    (ref kernel: init.F90:487-489, row build qeq.F90:183-268) evaluated
    directly from minimum-image pair distances, and its Est-weighted copy
    (weight 1.0 for unwrapped pairs, 0.5 for image pairs —
    ref: qeq.F90:304-306 semantics, identical to the ELL idxnb<n rule)."""
    n = pos.shape[0]
    dx, sx = _min_image_ax(pos, H, 0)
    dy, sy = _min_image_ax(pos, H, 1)
    dz, sz = _min_image_ax(pos, H, 2)
    dr2 = dx * dx + dy * dy + dz * dz
    unwrapped = (sx == 0) & (sy == 0) & (sz == 0)
    exists = _type_prm_dense(types, ffd.cf_pair[..., 0]) > 0.5
    ok = exists & (dr2 < ffd.rctap2) & ~jnp.eye(n, dtype=bool)
    dr2s = _safe(dr2, ok)
    dr1 = jnp.sqrt(dr2s)
    tap, _ = _taper_pair(dr2s, dr1, ffd.ctap)
    gam = _safe(_type_prm_dense(types, ffd.cf_pair[..., 5]), ok)
    hm = jnp.where(ok, tap * units.CCLMB0_QEQ
                   * (dr1 * dr2s + gam) ** (-1.0 / 3.0), 0.0)
    w = jnp.where(unwrapped, 1.0, 0.5) if resident_weight else 1.0
    return hm, hm * w


def nonbond_dense(pos, q, H, types, amask, ffd: FFDev, with_virial=False):
    """Dense minimum-image closed-form vdW + Coulomb: energies, row-local
    forces and pair virial with zero gathers (the dense analog of
    `nonbond_cf_energy_forces`; force expression ref: pot.F90:736-761)."""
    n = pos.shape[0]
    dx, sx = _min_image_ax(pos, H, 0)
    dy, sy = _min_image_ax(pos, H, 1)
    dz, sz = _min_image_ax(pos, H, 2)
    dr2 = dx * dx + dy * dy + dz * dz
    mask = (dr2 <= ffd.rctap2) & ~jnp.eye(n, dtype=bool) \
        & amask[:, None] & amask[None, :]
    prm = jnp.stack([_type_prm_dense(types, ffd.cf_pair[..., k])
                     for k in range(ffd.cf_pair.shape[-1])], axis=-1)
    evdw_p, eclmb1, devdw, declmb1, ok = cf_nonbond(dr2, prm, ffd, mask)
    m = mask & ok
    qq = q[:, None] * q[None, :]
    evdw = 0.5 * jnp.sum(jnp.where(m, evdw_p, 0.0))
    eclmb = 0.5 * jnp.sum(jnp.where(m, eclmb1 * qq, 0.0))
    ffac = jnp.where(m, devdw + declmb1 * qq, 0.0)
    f = -jnp.stack([jnp.sum(ffac * dx, axis=1),
                    jnp.sum(ffac * dy, axis=1),
                    jnp.sum(ffac * dz, axis=1)], axis=-1)
    echarge = jnp.sum(jnp.where(
        amask,
        units.CECHRGE * (ffd.chi[types] * q + 0.5 * ffd.eta[types] * q * q),
        0.0))
    if with_virial:
        ds = (dx, dy, dz)
        w = -0.5 * jnp.asarray(
            [[jnp.sum(ffac * ds[a] * ds[b]) for b in range(3)]
             for a in range(3)])
        return evdw, eclmb, echarge, f, w
    return evdw, eclmb, echarge, f


def pair_bond_type(ctx: NbCtx, types, ffd: FFDev):
    """Per-pair bond-type index via one-hot contraction (exact: one-hot x
    integer values), avoiding a 2.6M-element (nso,nso) table gather."""
    bcrow = ffd.inxn2[types].astype(ctx.tjf.dtype)        # (n, nso) tiny
    bcf = jnp.einsum("nkc,nc->nk", ctx_tjoh(ctx), bcrow,
                     preferred_element_type=ctx.tjf.dtype)
    return jnp.round(bcf).astype(jnp.int32)


def _table_rows(ffd: FFDev, bc, dr2, mask):
    """All 5 tabulated kernel columns at r^2, via two packed row gathers —
    bit-identical to per-table interpolation (ref: pot.F90:729-743)."""
    nrows_per_type = ffd.tbl_evdw.shape[1]                # NTABLE+1
    x = _safe(dr2, mask, 0.5 * ffd.udr) * ffd.udri
    itb = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, nrows_per_type - 2)
    w = (x - itb)[..., None]
    base = bc * nrows_per_type + itb
    r0 = ffd.tblpack[base]                                # (n, knb, 5)
    r1 = ffd.tblpack[base + 1]
    return (1.0 - w) * r0 + w * r1


def _pair_virial(ffac, dr):
    """Pair virial W_ab = -dE/deps_ab over directed rows: each undirected
    pair appears twice, hence the 0.5 (the analog of the reference's
    Σ pos·f accumulation incl. ghost rows, pot.F90:65-72).  `dr` is
    channel-major (3, n, knb)."""
    return -0.5 * jnp.einsum("nk,ank,bnk->ab", ffac, dr, dr,
                             preferred_element_type=dr.dtype)


def nonbond_tbl_energy_forces(ctx: NbCtx, q, types, amask, ffd: FFDev,
                              with_virial=False, pre=None, img=None):
    """van der Waals + Coulomb energies AND explicit forces from the
    reference's derivative tables (ref: pot.F90:736-761) over the shared
    pair context.  Values are bit-identical to the reference's table
    interpolation; forces accumulate row-locally (no backward scatter).
    `pre=(rows, ok)` reuses table rows already gathered by `pair_rows`
    (shared with the QEq hessian)."""
    if pre is not None:
        rows, ok = pre
        m = ok & ctx.notself & ctx.mask
    else:
        bc = pair_bond_type(ctx, types, ffd)
        m = ctx.mask & ctx.notself & (bc >= 0)
        rows = _table_rows(ffd, jnp.where(m, bc, 0), ctx.dr2, m)
    qj = ctx.qj if ctx.qj is not None else ctx_qj(ctx, q, img)
    qq = q[:, None] * qj
    evdw = 0.5 * jnp.sum(jnp.where(m, rows[..., 0], 0.0))
    eclmb = 0.5 * jnp.sum(jnp.where(m, rows[..., 1] * qq, 0.0))
    ffac = jnp.where(m, rows[..., 2] + rows[..., 3] * qq, 0.0)
    f = -jnp.einsum("nk,ank->na", ffac, ctx.dr,
                    preferred_element_type=ffac.dtype)
    echarge = jnp.sum(jnp.where(
        amask,
        units.CECHRGE * (ffd.chi[types] * q + 0.5 * ffd.eta[types] * q * q),
        0.0))
    if with_virial:
        return evdw, eclmb, echarge, f, _pair_virial(ffac, ctx.dr)
    return evdw, eclmb, echarge, f


def nonbond_cf_energy_forces(ctx: NbCtx, q, types, amask, ffd: FFDev,
                             with_virial=False, img=None):
    """vdW + Coulomb energies and row-local forces from the closed-form
    kernels.  Directed-pair enumeration: forces accumulate on the row atom
    only (no backward scatter); energies carry the 0.5 double-count factor.
    Production analog of `nonbond_tbl_energy_forces` (same force expression
    as ref pot.F90:736-761, analytic instead of interpolated)."""
    m = ctx.mask & ctx.notself
    evdw_p, eclmb1, devdw, declmb1, ok = cf_nonbond(
        ctx.dr2, ctx_prm(ctx, types, ffd), ffd, m)
    m = m & ok
    qj = ctx.qj if ctx.qj is not None else ctx_qj(ctx, q, img)
    qq = q[:, None] * qj
    evdw = 0.5 * jnp.sum(jnp.where(m, evdw_p, 0.0))
    eclmb = 0.5 * jnp.sum(jnp.where(m, eclmb1 * qq, 0.0))
    ffac = jnp.where(m, devdw + declmb1 * qq, 0.0)
    f = -jnp.einsum("nk,ank->na", ffac, ctx.dr,
                    preferred_element_type=ffac.dtype)
    echarge = jnp.sum(jnp.where(
        amask,
        units.CECHRGE * (ffd.chi[types] * q + 0.5 * ffd.eta[types] * q * q),
        0.0))
    if with_virial:
        return evdw, eclmb, echarge, f, _pair_virial(ffac, ctx.dr)
    return evdw, eclmb, echarge, f


# ----------------------------------------------------------------------------
# Bond-order pipeline (ref: bo.F90)
# ----------------------------------------------------------------------------

class BondOrder(NamedTuple):
    bo: jax.Array        # (N, kb, 4): full BO, sigma, pi, pipi   [energy defs]
    delta: jax.Array     # (N,) -Val + sum BO0   (ref: bo.F90:291-296)
    deltap1: jax.Array   # (N,) uncorrected Delta' (ref: bo.F90:41-45)
    mask: jax.Array      # (N, kb) pair validity (includes BO'>cutoff gate)
    drb: jax.Array       # (N, kb, 3) r_center - r_neighbor, differentiable —
                         # the shared geometry table for all many-body terms


@jax.custom_vjp
def _rowtake(tab, idx):
    """Row gather `tab[idx]` whose gather and VJP scatter-add each stay a
    standalone operation: optimization barriers keep XLA from fusing them
    into their consumers.  (A lowering choice made for another backend;
    whether it helps XLA:GPU is not yet measured.)"""
    return jax.lax.optimization_barrier(
        jax.lax.optimization_barrier(tab)[idx])


def _rowtake_fwd(tab, idx):
    return _rowtake(tab, idx), (idx, tab.shape)


def _rowtake_bwd(res, ct):
    idx, shape = res
    R, C = shape
    ct = jax.lax.optimization_barrier(ct)
    # 2-D row scatter-add (one scatter for all C columns)
    g = jnp.zeros((R, C), ct.dtype).at[idx].add(ct)
    return jax.lax.optimization_barrier(g), np.zeros(idx.shape,
                                                     jax.dtypes.float0)


_rowtake.defvjp(_rowtake_fwd, _rowtake_bwd)


def _rowgather1(vec, idx):
    """Single-vector per-atom -> per-pair pick in 2-column row-gather
    form (both columns consumed so XLA cannot narrow the gather back to
    one column; cf. ctx_qj)."""
    a, b = _rowgather2(vec, vec, idx)
    return 0.5 * (a + b)


def _rowgather2(veca, vecb, idx):
    """Gather TWO per-atom vectors to pair slots with one 2-column
    row-gather behind an optimization barrier, which stops XLA from fusing
    the gather into its consumers (cf. _rowtake)."""
    pack = jax.lax.optimization_barrier(jnp.stack([veca, vecb], axis=1))
    rows = _rowtake(pack, idx)
    return rows[..., 0], rows[..., 1]


def bond_order(pos, H, types, img: ImageTable, nbrs: Neighbors,
               ffd: FFDev) -> BondOrder:
    """BO' then corrected BO per directed bonded pair (ref: bo.F90:28-298).

    Works on owner rows only; ghost-side per-atom quantities are recovered by
    gathering the owner's value (exact by periodic translation invariance).
    """
    n = pos.shape[0]
    mask = nbrs.maskb
    idx = jnp.where(mask, nbrs.idxb, 0)

    oj = img.owner_of(idx)                       # (N, kb) owning atom of neighbor
    ti = types[:, None]
    tj = types[oj]
    b = ffd.inxn2[ti, tj]                     # bond type; valid where mask

    # pair displacements via the CONSTANT shift table: dr = pos_i -
    # (pos[owner] + shift@H^T).  Differentiating pose=ext_positions(pos)
    # instead would back-scatter cotangents into the (S*n, 3) extended
    # table and image-reduce it; this form
    # scatters straight into the (n, 3) owner rows, and the H-gradient
    # (strain virial) becomes an einsum against the gathered shifts.
    shg = img.shift.astype(pos.dtype)[idx]       # (N, kb, 3), constant
    dr = pos[:, None, :] - _rowtake(pos, oj) - jnp.einsum(
        "nka,ba->nkb", shg, H, preferred_element_type=pos.dtype)
    dr2 = jnp.sum(dr * dr, axis=-1)
    # re-check the true sigma-bond cutoff (ref: bo.F90:65) — neighbor lists
    # may carry a Verlet skin margin
    mask = mask & (dr2 <= ffd.rc2b[ti, tj])
    dr2s = _safe(dr2, mask)

    # --- BO' (ref: bo.F90:62-110)
    arg1 = ffd.cBOp1[b] * _powm(dr2s, ffd.pbo2h[b], mask)
    arg2 = ffd.cBOp3[b] * _powm(dr2s, ffd.pbo4h[b], mask)
    arg3 = ffd.cBOp5[b] * _powm(dr2s, ffd.pbo6h[b], mask)
    bop1 = ffd.switch[b, 0] * jnp.exp(arg1)
    bop2 = ffd.switch[b, 1] * jnp.exp(arg2)
    bop3 = ffd.switch[b, 2] * jnp.exp(arg3)
    # sigma-prime energy modification (ref: bo.F90:73-99)
    bop1 = (1.0 + ffd.cutoff_vpar30) * bop1
    above = (bop1 + bop2 + bop3) > ffd.cutoff_vpar30
    gate = mask & above
    bop1 = jnp.where(gate, bop1 - ffd.cutoff_vpar30, 0.0)
    bop2 = jnp.where(gate, bop2, 0.0)
    bop3 = jnp.where(gate, bop3, 0.0)
    bop0 = bop1 + bop2 + bop3

    deltap1 = -ffd.Val[types] + jnp.sum(bop0, axis=1)
    deltap2 = deltap1 + ffd.Val[types] - ffd.Valval[types]  # (bo.F90:151)

    # --- corrected BO (ref: bo.F90:156-217)
    d1i = deltap1[:, None]
    d1j, dp2j = _rowgather2(deltap1, deltap2, oj)
    e1i = _exp(-ffd.vpar1 * d1i)
    e1j = _exp(-ffd.vpar1 * d1j)
    e2i = _exp(-ffd.vpar2 * d1i)
    e2j = _exp(-ffd.vpar2 * d1j)
    fn2 = e1i + e1j
    fn3 = (-1.0 / ffd.vpar2) * jnp.log(0.5 * (e2i + e2j))
    fn23 = fn2 + fn3
    vi = ffd.Val[ti]
    vj = ffd.Val[tj]
    fn1 = 0.5 * ((vi + fn2) / (vi + fn23) + (vj + fn2) / (vj + fn23))
    fn1 = jnp.where(ffd.ovc[b] < 1e-3, 1.0, fn1)

    bopsqr = bop0 * bop0
    u4 = -ffd.pboc3[b] * (ffd.pboc4[b] * bopsqr - deltap2[:, None]) + ffd.pboc5[b]
    u5 = -ffd.pboc3[b] * (ffd.pboc4[b] * bopsqr - dp2j) + ffd.pboc5[b]
    fn4 = _logistic(u4)
    fn5 = _logistic(u5)
    no_v13 = ffd.v13cor[b] < 1e-3
    fn4 = jnp.where(no_v13, 1.0, fn4)
    fn5 = jnp.where(no_v13, 1.0, fn5)

    fn45 = fn4 * fn5
    fn145 = fn1 * fn45
    fn1145 = fn1 * fn145

    bo0 = bop0 * fn145
    bo2 = bop2 * fn1145
    bo3 = bop3 * fn1145
    bo0 = jnp.where(bo0 < 1e-10, 0.0, bo0)       # floors (bo.F90:210-212)
    bo2 = jnp.where(bo2 < 1e-10, 0.0, bo2)
    bo3 = jnp.where(bo3 < 1e-10, 0.0, bo3)
    bo1 = bo0 - bo2 - bo3
    bo = jnp.stack([bo0, bo1, bo2, bo3], axis=-1)
    bo = jnp.where(gate[..., None], bo, 0.0)

    delta = -ffd.Val[types] + jnp.sum(bo[..., 0], axis=1)
    return BondOrder(bo=bo, delta=delta, deltap1=deltap1, mask=gate, drb=dr)


# ----------------------------------------------------------------------------
# Lone pair preparation (shared by Elnpr and E3b; ref: pot.F90:181-209)
# ----------------------------------------------------------------------------

class LonePair(NamedTuple):
    nlp: jax.Array       # (N,)
    deltalp: jax.Array   # (N,)
    dDlp: jax.Array      # (N,) dnlp/ddelta (used by the reference's forces
                         # and by E3b's SBO — energy-relevant via nlp only)


def lone_pair(types, delta, ffd: FFDev) -> LonePair:
    deltaE = -ffd.Vale[types] + ffd.Val[types] + delta
    dEh = 0.5 * deltaE
    idEh = jnp.trunc(dEh)                        # Fortran int() truncation
    idEh = jax.lax.stop_gradient(idEh)
    x = 2.0 + deltaE - 2.0 * idEh
    explp1 = jnp.exp(-ffd.plp1[types] * x * x)
    clp = 2.0 * ffd.plp1[types] * explp1 * x
    nlp = explp1 - idEh
    deltalp = ffd.nlpopt[types] - nlp
    deltalp = jnp.where(ffd.mass[types] > 21.0, 0.0, deltalp)  # pot.F90:207
    return LonePair(nlp=nlp, deltalp=deltalp, dDlp=clp)


# ----------------------------------------------------------------------------
# Energy terms.  Each returns scalar or per-slot contributions summed over
# *resident* atoms.  `amask` marks live atoms (padding support for the
# fixed-capacity multi-device layout).
# ----------------------------------------------------------------------------

def e_bond(types, img, nbrs, bo: BondOrder, gid, amask, ffd: FFDev):
    """Sigma/pi/pipi bond energy (ref: pot.F90:926-977)."""
    mask = bo.mask
    idx = jnp.where(mask, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    b = ffd.inxn2[types[:, None], types[oj]]
    # count each bond once via global-id ordering (ref: pot.F90:949)
    mask = mask & (gid[oj] < gid[:, None]) & amask[:, None]
    bo1, bo2, bo3 = bo.bo[..., 1], bo.bo[..., 2], bo.bo[..., 3]
    # guard sigma-BO**pbe2 against 0**(p-1) gradient blowup at BO1 == 0
    mpos = mask & (bo1 > 0.0)
    exp_be12 = jnp.exp(ffd.pbe1[b] * (1.0 - _powm(bo1, ffd.pbe2[b], mpos)))
    pebo = (-ffd.Desig[b] * bo1 * exp_be12
            - ffd.Depi[b] * bo2 - ffd.Depipi[b] * bo3)
    return jnp.sum(jnp.where(mask, pebo, 0.0))


def e_lnpr(types, img, nbrs, bo: BondOrder, lp: LonePair, amask,
           ffd: FFDev):
    """Lone-pair, over- and under-coordination energies
    (ref: pot.F90:213-259)."""
    mask = bo.mask & amask[:, None]
    idx = jnp.where(bo.mask, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    t = types
    b = ffd.inxn2[t[:, None], types[oj]]

    sum_ovun1 = jnp.sum(
        jnp.where(bo.mask, ffd.povun1[b] * ffd.Desig[b] * bo.bo[..., 0], 0.0),
        axis=1)
    # row-gather form for the per-atom -> per-pair pick (cf. _rowgather2)
    dmj, dlj = _rowgather2(bo.delta, lp.deltalp, oj)
    dmdlp_j = dmj - dlj
    sum_ovun2 = jnp.sum(
        jnp.where(bo.mask, dmdlp_j * (bo.bo[..., 2] + bo.bo[..., 3]), 0.0),
        axis=1)

    pelp = ffd.plp2[t] * lp.deltalp * _logistic(-75.0 * lp.deltalp)

    expovun1 = ffd.povun3[t] * _exp(ffd.povun4[t] * sum_ovun2)
    deltalpcorr = bo.delta - lp.deltalp / (1.0 + expovun1)
    expovun2 = _exp(ffd.povun2[t] * deltalpcorr)
    dlpv = 1.0 / (deltalpcorr + ffd.Val[t] + 1e-8)
    expovun2n = _exp(-ffd.povun2[t] * deltalpcorr)
    expovun6 = _exp(ffd.povun6[t] * deltalpcorr)
    expovun8 = ffd.povun7[t] * _exp(ffd.povun8[t] * sum_ovun2)

    peover = sum_ovun1 * dlpv * deltalpcorr / (1.0 + expovun2)
    peunder = (-ffd.povun5[t] * (1.0 - expovun6)
               / (1.0 + expovun2n) / (1.0 + expovun8))

    w = amask.astype(pelp.dtype)
    return (jnp.sum(w * pelp), jnp.sum(w * peover), jnp.sum(w * peunder))


def _shift_code(shift):
    """Pack an integer periodic shift (components in [-4,4]) into one int."""
    si = jnp.round(shift).astype(jnp.int32)
    return ((si[..., 0] + 4) * 9 + (si[..., 1] + 4)) * 9 + (si[..., 2] + 4)


def _ext_key(img):
    """Unique integer identity of each extended entry: owner * 729 + packed
    shift.  Two ext entries are the same physical atom instance iff their
    keys match (used for the i!=l / j!=l torsion exclusions)."""
    return img.owner.astype(jnp.int32) * 729 + _shift_code(img.shift)


def _row_topk_slots(mask2d, cap):
    """Per-row compaction: indices of up to `cap` True entries of a (n, S)
    boolean mask, lowest index first.  Returns (idx (n,cap), valid (n,cap),
    counts (n,)).  Replaces the reference's dynamic interaction
    enumeration loops — fixed shapes, data-parallel."""
    vals, idx = jax.lax.top_k(mask2d.astype(jnp.int32), cap)
    valid = vals > 0
    return jnp.where(valid, idx, 0), valid, mask2d.sum(axis=1, dtype=jnp.int32)


def _cos_bound(dtype):
    """Angle clamp (ref: module.F90:85-86).  The reference's 1-1e-12 is below
    f32 resolution (would round to exactly 1 and blow up d/dcos sqrt(1-c^2));
    widen it for single precision."""
    return units.MAXANGLE if jnp.dtype(dtype) == jnp.float64 else 1.0 - 2e-6


def _clip_cos(cos):
    b = _cos_bound(cos.dtype)
    return jnp.clip(cos, -b, b)


def _angle_cos(rij, rjk, mask):
    """cos(theta_ijk) = -rij.rjk/(|rij||rjk|) with reference clamping
    (ref: pot.F90:394-396)."""
    nij = jnp.sqrt(_safe(jnp.sum(rij * rij, axis=-1), mask))
    njk = jnp.sqrt(_safe(jnp.sum(rjk * rjk, axis=-1), mask))
    cos = -jnp.sum(rij * rjk, axis=-1) / (nij * njk)
    return _clip_cos(cos), nij, njk


def strong_slots(bo: BondOrder, ks: int):
    """Per-atom compaction of bonded slots with BO0 > cutof2_esub — almost
    all many-body enumeration only involves these 'real' bonds (typ. <= 10),
    so list construction runs on (n, ks..) instead of (n, kb..) grids."""
    bo0_sg = jax.lax.stop_gradient(bo.bo[..., 0])
    okb = bo.mask & (bo0_sg > units.CUTOF2_ESUB)
    sslot, svalid, cnt = _row_topk_slots(okb, ks)
    return sslot, svalid, cnt


# ----------------------------------------------------------------------------
# Many-body interaction lists: build / evaluate split.
#
# The reference enumerates valence-angle and torsion participants inside the
# energy routines every step (ref: pot.F90:369-399, 1019-1081).  Here list
# construction (integer slot selection, non-differentiable) is separated from
# evaluation so the engine can CACHE the lists on the neighbor-rebuild
# cadence: lists are built with *slackened* BO gates (thresholds scaled by
# `slack` < 1) plus a geometric `margin` around the sigma-bond cutoff (bonds
# that could form before the next rebuild), then re-gated EXACTLY with live
# bond orders at evaluation.  With slack=1, margin=0 the list equals the
# per-step enumeration and the energies are bit-identical to building fresh.
# Staleness is bounded by the engine's drift-triggered rebuild (atoms may
# move at most margin/2 between rebuilds), the same contract as the Verlet
# skin on the pair lists.
# ----------------------------------------------------------------------------

def _flat_compact(mask_flat, cap):
    """Pack the indices of True entries of a flat mask into a fixed-size
    list, in index order (cumsum + scatter — O(S), no sort).  Returns
    (idx (cap,), valid (cap,), count).  Entries past `cap` are dropped;
    the caller surfaces cnt > cap as a capacity overflow."""
    pos = jnp.cumsum(mask_flat) - 1
    src = jnp.arange(mask_flat.shape[0], dtype=jnp.int32)
    dst = jnp.where(mask_flat, pos, cap).astype(jnp.int32)
    idx = jnp.zeros((cap,), jnp.int32).at[dst].set(src, mode="drop")
    cnt = mask_flat.sum(dtype=jnp.int32)
    valid = jnp.arange(cap) < cnt
    return idx, valid, cnt


# sentinel returned as `cnt` by _flat_compact_rows when a single row exceeds
# its rowcap: distinguishable from a total-capacity overflow so the engine's
# error message can name the right knob (ang_row/tor_row/hb_row, not ang/tor/hbf)
ROW_OVERFLOW = 2 ** 30


def _flat_compact_rows(mask, cap, rowcap):
    """Two-stage pack of a (R, S) mask into flat R*S indices — output
    identical to `_flat_compact(mask.reshape(-1), cap)` as long as no row
    holds more than `rowcap` true entries.

    Stage 1 front-packs each row's true flat indices into an (R, rowcap)
    staging table (per-row cumsum + one flat scatter); stage 2 runs the
    plain flat pack over the staging table.  This replaces the global
    cumsum over R*S elements (S = ks^3 for torsions, kh*knb for hbonds —
    tens of millions at production N) with a per-row scan plus a pack
    over R*rowcap elements, typically 15-50x smaller.

    A row overflowing `rowcap` cannot be packed faithfully; it is
    surfaced by returning a sentinel cnt (2^30) so every existing
    `cnt > cap` overflow check trips loudly (the caller aborts like the
    reference, main.F90:402-407)."""
    R, S = mask.shape
    rowcap = int(min(rowcap, S))
    posr = jnp.cumsum(mask, axis=1, dtype=jnp.int32) - 1        # (R, S)
    rowmax = jnp.max(posr[:, -1]) + 1
    src = (jnp.arange(R, dtype=jnp.int32)[:, None] * S
           + jnp.arange(S, dtype=jnp.int32)[None, :])
    dst = jnp.where(mask & (posr < rowcap),
                    jnp.arange(R, dtype=jnp.int32)[:, None] * rowcap + posr,
                    R * rowcap).astype(jnp.int32)
    stage = jnp.full((R * rowcap,), -1, jnp.int32
                     ).at[dst.reshape(-1)].set(src.reshape(-1), mode="drop")
    m2 = stage >= 0
    pos2 = jnp.cumsum(m2, dtype=jnp.int32) - 1
    dst2 = jnp.where(m2, pos2, cap).astype(jnp.int32)
    idx = jnp.zeros((cap,), jnp.int32).at[dst2].set(stage, mode="drop")
    cnt_true = mask.sum(dtype=jnp.int32)
    cnt = jnp.where(rowmax > rowcap, jnp.int32(ROW_OVERFLOW), cnt_true)
    valid = jnp.arange(cap) < cnt
    return idx, valid, cnt


def _flat_compact_mapped(mask_rows_fn, n, S, cap, rowcap, chunk):
    """Two-stage pack over a VIRTUAL (n, S) mask computed on demand in row
    chunks: `mask_rows_fn(rows)` returns the (B, S) mask for the given
    center rows.  Output is identical to
    `_flat_compact_rows(stack_of_all_rows, cap, rowcap)`, but the (n, S)
    mask and its stage-1 intermediates never exist at once — peak
    footprint is (chunk, S), which bounds the torsion/hbond list builds'
    memory at large N."""
    nblk = -(-n // int(min(chunk, n)))
    B = -(-n // nblk)            # balanced blocks: waste < nblk rows
    npad = nblk * B
    rows_blocks = jnp.arange(npad, dtype=jnp.int32).reshape(nblk, B)
    aS = jnp.arange(S, dtype=jnp.int32)
    aB = jnp.arange(B, dtype=jnp.int32)

    def body(rows):
        ok_row = rows < n
        m = mask_rows_fn(jnp.minimum(rows, n - 1)) & ok_row[:, None]
        posr = jnp.cumsum(m, axis=1, dtype=jnp.int32) - 1
        src = rows[:, None] * S + aS[None, :]
        dst = jnp.where(m & (posr < rowcap),
                        aB[:, None] * rowcap + posr, B * rowcap)
        stage = jnp.full((B * rowcap,), -1, jnp.int32
                         ).at[dst.reshape(-1)].set(src.reshape(-1),
                                                   mode="drop")
        return stage.reshape(B, rowcap), posr[:, -1] + 1

    stages, rowcnts = jax.lax.map(body, rows_blocks)
    stage = stages.reshape(npad * rowcap)
    m2 = stage >= 0
    pos2 = jnp.cumsum(m2, dtype=jnp.int32) - 1
    dst2 = jnp.where(m2, pos2, cap).astype(jnp.int32)
    idx = jnp.zeros((cap,), jnp.int32).at[dst2].set(stage, mode="drop")
    cnt_true = rowcnts.sum(dtype=jnp.int32)          # pad rows count 0
    cnt = jnp.where(rowcnts.max() > rowcap, jnp.int32(ROW_OVERFLOW),
                    cnt_true)
    valid = jnp.arange(cap) < cnt
    return idx, valid, cnt


class AngleList(NamedTuple):
    """Flat valence-angle list: one entry per (center j, bond a, bond c).
    Flat (not per-atom-padded) because interaction counts are very uneven
    across atoms: padding to the per-atom max costs ~5-8x the total count."""
    j: jax.Array        # (M,) center row
    a: jax.Array        # (M,) slot of bond j-i in nbrs.idxb
    c: jax.Array        # (M,) slot of bond j-k
    oi: jax.Array       # (M,) owner row of i
    ok: jax.Array       # (M,) owner row of k
    valid: jax.Array    # (M,)
    prm: jax.Array      # (M, 17) angle-type params (type-static)
    cnt: jax.Array      # () true count (overflow check: cnt <= M)


class TorsionList(NamedTuple):
    """Flat torsion list: one entry per (center j, a, c, e) with e indexing
    owner(k)'s bonded list."""
    j: jax.Array        # (M,) center row
    a: jax.Array        # (M,) slot of i in j's bonded list
    c: jax.Array        # (M,) slot of k in j's bonded list
    ok: jax.Array       # (M,) owner row of k
    e: jax.Array        # (M,) slot of l in owner(k)'s bonded list
    valid: jax.Array
    prm: jax.Array      # (M, 9) torsion-type params (type-static)
    cnt: jax.Array


def _term_candidates(types, img, nbrs, bo: BondOrder, ffd: FFDev, ks: int,
                     slack: float, margin: float):
    """Bonded-slot candidates for many-body enumeration: strong now
    (BO > slack*cutof2_esub) or within `margin` [A] of the sigma cutoff.
    Geometric candidates get an effective BO of ~0.11 so every product gate
    they could later satisfy passes at build time."""
    maskb = nbrs.maskb
    idx = jnp.where(maskb, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    bo0 = jax.lax.stop_gradient(bo.bo[..., 0])
    strong = bo.mask & (bo0 > units.CUTOF2_ESUB * slack)
    if margin > 0.0:
        dr2 = jax.lax.stop_gradient(jnp.sum(bo.drb * bo.drb, axis=-1))
        rcm2 = (jnp.sqrt(ffd.rc2b[types[:, None], types[oj]]) + margin) ** 2
        cand = maskb & (strong | (dr2 <= rcm2))
        bo_eff = jnp.where(cand, jnp.maximum(bo0, 0.11), 0.0)
    else:
        cand = strong
        bo_eff = jnp.where(cand, bo0, 0.0)
    sslot, svalid, cnt = _row_topk_slots(cand, min(ks, maskb.shape[1]))
    return sslot, svalid, cnt, bo_eff, oj, idx


def _angle_mask(types, img, nbrs, bo, amask, ffd, ks, slack, margin):
    """(n, ks, ks) build-time angle validity on the candidate sublist."""
    n = nbrs.idxb.shape[0]
    row = jnp.arange(n)[:, None]
    sslot, svalid, cnt, bo_eff, oj, idx = _term_candidates(
        types, img, nbrs, bo, ffd, ks, slack, margin)
    ks = sslot.shape[1]
    bo_s = bo_eff[row, sslot]
    tn_s = types[oj][row, sslot]
    pm = (svalid[:, :, None] & svalid[:, None, :]
          & (sslot[:, :, None] < sslot[:, None, :])
          & (bo_s[:, :, None] * bo_s[:, None, :]
             > units.CUTOF2_ESUB * slack)
          & amask[:, None, None])
    a3_s = ffd.inxn3[tn_s[:, :, None],
                     jnp.broadcast_to(types[:, None, None], pm.shape),
                     tn_s[:, None, :]]
    pm = pm & (a3_s >= 0)
    return pm, sslot, cnt


def build_angle_list(types, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
                     cap: int = 4096, ks: int = 12, slack: float = 1.0,
                     margin: float = 0.0, rowcap: int = 0) -> AngleList:
    """Compact flat angle list (ref enumeration: pot.F90:369-399).
    `cap` is the TOTAL entry capacity across all atoms; `rowcap` > 0
    bounds the per-center count and selects the two-stage pack."""
    n, kb = nbrs.idxb.shape
    pm, sslot, _ = _angle_mask(types, img, nbrs, bo, amask, ffd, ks, slack,
                               margin)
    ks = sslot.shape[1]
    if rowcap > 0:
        fidx, valid, cnt = _flat_compact_rows(pm.reshape(n, -1), cap, rowcap)
    else:
        fidx, valid, cnt = _flat_compact(pm.reshape(-1), cap)
    j = fidx // (ks * ks)
    s = fidx % (ks * ks)
    a = sslot[j, s // ks]
    c = sslot[j, s % ks]
    idx = jnp.where(nbrs.maskb, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    tnbr = types[oj]
    a3 = ffd.inxn3[tnbr[j, a], types[j], tnbr[j, c]]
    a3 = jnp.where(valid & (a3 >= 0), a3, 0)
    return AngleList(j=j, a=a, c=c, oi=oj[j, a], ok=oj[j, c], valid=valid,
                     prm=ffd.angprm[a3], cnt=cnt)


def e_3body(pos, H, types, img, nbrs, bo: BondOrder, lp: LonePair, amask,
            ffd: FFDev, cap: int = 4096, ks: int = 12,
            al: AngleList = None):
    """Valence angle + penalty + 3-body conjugation (ref: pot.F90:355-549).

    Evaluates the (possibly cached) flat angle list; validity is re-gated
    with live bond orders so a cached superset list yields the same energy
    as per-step enumeration.  Geometry comes from the differentiable
    per-bond displacement table bo.drb.
    """
    if al is None:
        al = build_angle_list(types, img, nbrs, bo, amask, ffd, cap, ks)
    j, a, c = al.j, al.a, al.c
    bo0 = bo.bo[..., 0]
    esub = units.CUTOF2_ESUB
    maskp = bo.mask
    n, kb = bo0.shape

    # center sums (ref: pot.F90:359-365), (n,) then gathered per entry
    sum_bo8 = jnp.sum(jnp.where(maskp, -_powm(bo0, 8.0, maskp), 0.0), axis=1)
    prod_sbo = jnp.exp(sum_bo8)
    sum_sbo1 = jnp.sum(jnp.where(maskp, bo.bo[..., 2] + bo.bo[..., 3], 0.0),
                       axis=1)
    delta_ang_n = bo.delta + ffd.Val[types] - ffd.Valangle[types]

    # packed row gathers: ONE (M, 4) bond-row gather per leg and ONE
    # (M, 8) center-row gather replace ~14 flat 1-D gathers
    bpack = jnp.concatenate([bo.bo[..., 0:1], bo.drb],
                            axis=-1).reshape(n * kb, 4)
    rowa = _rowtake(bpack, j * kb + a)
    rowc = _rowtake(bpack, j * kb + c)
    dpv = bo.delta + ffd.Val[types]
    cpack = jnp.stack([
        ffd.pval3[types], ffd.pval5[types], delta_ang_n, sum_sbo1,
        prod_sbo, lp.nlp, bo.delta,
        dpv - ffd.Valval[types], dpv], axis=-1)         # (n, 9)
    rj = _rowtake(cpack, j)
    dv = _rowtake(cpack, al.oi)[:, 8]
    dk = _rowtake(cpack, al.ok)[:, 8]

    boij_raw = rowa[:, 0]
    bojk_raw = rowc[:, 0]
    # live gates: exact reference semantics regardless of list staleness
    valid = (al.valid & (boij_raw > esub) & (bojk_raw > esub)
             & (boij_raw * bojk_raw > esub))
    boij = boij_raw - esub
    bojk = bojk_raw - esub

    ap = al.prm                                         # (M, 17)
    (theta00_, pval1_, pval2_, pval4_, pval6_, pval7_, pval8_, pval9_,
     pval10_, ppen1_, ppen2_, ppen3_, ppen4_, pcoa1_, pcoa2_, pcoa3_,
     pcoa4_) = [ap[..., k] for k in range(17)]

    rij = -rowa[:, 1:4]                                # (M, 3)
    rjk = rowc[:, 1:4]
    # theta via atan2(|rij x rjk|, -rij.rjk): numerically stable at the
    # linear limit.  The arccos(clipped cos) form (ref: pot.F90:394-400)
    # is fine in f64 but in f32 rounding pushes near-linear angles into
    # the clamp, where the d(arccos)/dcos ~ 1/sqrt(1-c^2) factor
    # fabricates O(10^3) kcal/mol/A forces (observed: FeS pyrite NVE blew
    # up in f32 while conserving in f64; atan2 forces match f64 to 1e-4)
    dotp = -jnp.sum(rij * rjk, axis=-1)
    crs = jnp.cross(rij, rjk)
    floor = 1e-20 if rij.dtype == jnp.float64 else 1e-12
    sn = jnp.sqrt(jnp.maximum(_safe(jnp.sum(crs * crs, axis=-1), valid),
                              floor))
    theta = jnp.arctan2(sn, dotp)

    boij_s = _safe(boij, valid)
    bojk_s = _safe(bojk, valid)

    # --- PEval (ref: pot.F90:404-427)
    pv4 = pval4_
    pv3j = rj[:, 0]
    fn7ij = 1.0 - jnp.exp(-pv3j * _powm(boij_s, pv4, valid))
    fn7jk = 1.0 - jnp.exp(-pv3j * _powm(bojk_s, pv4, valid))
    da = rj[:, 2]
    pv5j = rj[:, 1]
    fn8j = pv5j - (pv5j - 1.0) * _ratio23(pval6_ * da, -pval7_ * da)

    sbo = rj[:, 3] + (1.0 - rj[:, 4]) * (-da - pval8_ * rj[:, 5])
    pv9 = pval9_
    sbo_s = jnp.clip(sbo, 0.0, 2.0)
    sbo2 = jnp.where(
        sbo <= 0.0, 0.0,
        jnp.where(sbo <= 1.0, _powm(sbo_s, pv9, valid & (sbo > 0.0)),
                  jnp.where(sbo <= 2.0,
                            2.0 - _powm(2.0 - sbo_s, pv9,
                                        valid & (sbo < 2.0)), 2.0)))
    theta0 = jnp.pi - theta00_ * (
        1.0 - jnp.exp(-pval10_ * (2.0 - sbo2)))
    tdiff = theta0 - theta
    exp2 = jnp.exp(-pval2_ * tdiff * tdiff)
    peval = fn7ij * fn7jk * fn8j * (pval1_ - pval1_ * exp2)

    # --- PEpen (ref: pot.F90:460-466)
    dj = rj[:, 6]
    fn9 = _ratio23(-ppen3_ * dj, ppen4_ * dj)
    pepen = (ppen1_ * fn9
             * jnp.exp(-ppen2_ * (boij - 2.0) ** 2)
             * jnp.exp(-ppen2_ * (bojk - 2.0) ** 2))

    # --- PEcoa (ref: pot.F90:479-489)
    delta_val = rj[:, 7]
    pecoa = (pcoa1_ * _logistic(pcoa2_ * delta_val)
             * jnp.exp(-pcoa3_ * (-boij + dv) ** 2)
             * jnp.exp(-pcoa3_ * (-bojk + dk) ** 2)
             * jnp.exp(-pcoa4_ * (boij - 1.5) ** 2)
             * jnp.exp(-pcoa4_ * (bojk - 1.5) ** 2))

    return (jnp.sum(jnp.where(valid, peval, 0.0)),
            jnp.sum(jnp.where(valid, pepen, 0.0)),
            jnp.sum(jnp.where(valid, pecoa, 0.0)))


def _unit_cross(u, v, mask):
    """Cross product of *normalized* inputs with norm floored at NSMALL
    (ref: pot.F90:1524-1543).  The floor is applied inside the sqrt so the
    gradient is cut (not infinite) for collinear bonds."""
    c = jnp.cross(u, v)
    floor = 1e-20 if c.dtype == jnp.float64 else 1e-12
    nrm = jnp.sqrt(jnp.maximum(_safe(jnp.sum(c * c, axis=-1), mask), floor))
    return c, jnp.maximum(nrm, units.NSMALL)


def _torsion_mask_rows(rows, cand, types, gid, img, bo: BondOrder, amask,
                       ffd: FFDev, slack: float):
    """(B, a, c, e) torsion validity for the given center rows, over the
    global candidate tables `cand` (from _term_candidates).  Row-separable
    by construction: the l-side indexes the GLOBAL tables through oj_s, so
    any subset of rows yields exactly the corresponding mask rows — the
    basis of the chunked large-N build."""
    sslot, svalid, _, bo_eff, oj, idx = cand
    ks = sslot.shape[1]
    esub = units.CUTOF2_ESUB * slack
    r = rows[:, None]
    sslot_r = sslot[rows]                              # (B, ks)
    svalid_r = svalid[rows]
    bo_s = bo_eff[r, sslot_r]                          # (B, ks)
    idx_s = idx[r, sslot_r]                            # ext index per slot
    oj_s = oj[r, sslot_r]                              # owner rows (global)
    key_ext = _ext_key(img)

    # l-side: candidate slots of owner(k), translated by k's shift
    sslot_l = sslot[oj_s]                              # (B, c, e)
    svalid_l = svalid[oj_s]
    bo_kl = bo_eff[oj_s[:, :, None], sslot_l]
    idx_le = idx[oj_s[:, :, None], sslot_l]            # ext index of l
    shift_k = img.shift[idx_s]                         # (B, c, 3)
    key_l = (img.owner_of(idx_le).astype(jnp.int32) * 729
             + _shift_code(img.shift[idx_le] + shift_k[:, :, None, :]))

    def A(x):
        return x[:, :, None, None]

    def E(x):
        return x[:, None, :, :]

    mask_jk = svalid_r & (gid[rows][:, None] < gid[oj_s]) & amask[rows][:, None]
    same_ik = (jnp.arange(ks)[:, None]
               == jnp.arange(ks)[None, :])[None, :, :, None]
    key_j = (rows * 729 + _shift_code(jnp.zeros(3)))[:, None, None]
    mask4 = (A(svalid_r) & mask_jk[:, None, :, None] & E(svalid_l)
             & (bo_s[:, :, None, None] * bo_s[:, None, :, None] > esub)
             & (bo_s[:, None, :, None] * E(bo_kl) > esub)
             & ~same_ik
             & (bo_s[:, :, None, None] * bo_s[:, None, :, None] ** 2
                * E(bo_kl) > units.MINBO0 * slack)
             & (A(key_ext[idx_s]) != E(key_l))          # i != l
             & (key_j[:, None] != E(key_l)))            # j != l
    # torsion-type existence on the (a,c,e) grid: a row gather over (c,e)
    # plus a one-hot contraction over the i-type axis instead of a
    # 7.8M-element 4-D table gather.
    ti_s = types[oj_s]                                  # (B, ks)
    tle = types[img.owner_of(idx_le)]                   # (B, c, e)
    t4okT = jnp.moveaxis(ffd.t4ok, 0, -1)               # (j, k, l, i-type)
    X = t4okT[types[rows][:, None, None], ti_s[:, :, None], tle]
    ioh = jax.nn.one_hot(ti_s, ffd.t4ok.shape[0], dtype=X.dtype)
    exists4 = jnp.einsum("nax,ncex->nace", ioh, X,
                         preferred_element_type=X.dtype) > 0.5
    return mask4 & exists4


def _torsion_mask(types, gid, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
                  ks: int = 12, slack: float = 1.0, margin: float = 0.0):
    """Compact (n, a, c, e) torsion validity mask over candidate sublists,
    on stop-gradient data (all reference enumeration gates,
    ref: pot.F90:1019-1081).  Axes index the per-atom candidate lists;
    returns (mask, sslot, svalid) for mapping back to original slots."""
    n, kb = nbrs.idxb.shape
    cand = _term_candidates(types, img, nbrs, bo, ffd, ks, slack, margin)
    mask4 = _torsion_mask_rows(jnp.arange(n), cand, types, gid, img, bo,
                               amask, ffd, slack)
    return mask4, cand[0], cand[1]


def build_torsion_list(types, gid, img, nbrs, bo: BondOrder, amask,
                       ffd: FFDev, cap: int = 8192, ks: int = 12,
                       slack: float = 1.0, margin: float = 0.0,
                       rowcap: int = 0, chunk: int = 0) -> TorsionList:
    """Compact flat torsion list (ref enumeration: pot.F90:1019-1081).

    Center j, bond c -> k (counted once via gid(j) < gid(k)), slot a -> i in
    j's list, slot e -> l in owner(k)'s list.  `cap` is the TOTAL entry
    capacity across all atoms.  `chunk` > 0 (with rowcap > 0) computes the
    candidate mask in row chunks of that size (bit-identical output,
    bounded peak memory/compile size — the large-N path).
    """
    n, kb = nbrs.idxb.shape
    if chunk > 0 and rowcap > 0:
        cand = _term_candidates(types, img, nbrs, bo, ffd, ks, slack,
                                margin)
        sslot = cand[0]
        ks = sslot.shape[1]
        fidx, valid, cnt = _flat_compact_mapped(
            lambda rows: _torsion_mask_rows(
                rows, cand, types, gid, img, bo, amask, ffd,
                slack).reshape(rows.shape[0], -1),
            n, ks * ks * ks, cap, rowcap, chunk)
    else:
        mask4, sslot, svalid = _torsion_mask(types, gid, img, nbrs, bo,
                                             amask, ffd, ks, slack, margin)
        ks = sslot.shape[1]
        if rowcap > 0:
            fidx, valid, cnt = _flat_compact_rows(mask4.reshape(n, -1), cap,
                                                  rowcap)
        else:
            fidx, valid, cnt = _flat_compact(mask4.reshape(-1), cap)
    j = fidx // (ks * ks * ks)
    s = fidx % (ks * ks * ks)
    a = sslot[j, s // (ks * ks)]
    c = sslot[j, (s // ks) % ks]
    idx = jnp.where(nbrs.maskb, nbrs.idxb, 0)
    oj = img.owner_of(idx)
    ok = oj[j, c]
    e = sslot[ok, s % ks]
    idx_l = idx[ok, e]
    t4 = ffd.inxn4[types[oj[j, a]], types[j], types[ok],
                   types[img.owner_of(idx_l)]]
    t4 = jnp.where(valid & (t4 >= 0), t4, 0)
    return TorsionList(j=j, a=a, c=c, ok=ok, e=e, valid=valid,
                       prm=ffd.torprm[t4], cnt=cnt)


def e_4body(pos, H, types, img, nbrs, bo: BondOrder, amask, gid,
            ffd: FFDev, cap: int = 8192, ks: int = 12,
            tl: TorsionList = None):
    """Torsion + 4-body conjugation (ref: pot.F90:1012-1219).

    Evaluates the (possibly cached) flat torsion list with live BO
    re-gating; all four bond legs come from the differentiable per-bond
    displacement table bo.drb (translation invariance makes l's leg
    shift-free: drb[owner(k), e] equals r_k - r_l for the actual image
    of k).
    """
    if tl is None:
        tl = build_torsion_list(types, gid, img, nbrs, bo, amask, ffd,
                                cap, ks)
    j, a, c, ok, e = tl.j, tl.a, tl.c, tl.ok, tl.e
    bo0 = bo.bo[..., 0]
    esub = units.CUTOF2_ESUB
    n, kb = bo0.shape
    delta_ang_n = bo.delta + ffd.Val[types] - ffd.Valangle[types]

    # packed row gathers (one (M,5) row per bond leg; cf. e_3body)
    bpack = jnp.concatenate([bo.bo[..., 0:1], bo.bo[..., 2:3], bo.drb],
                            axis=-1).reshape(n * kb, 5)
    rowa = _rowtake(bpack, j * kb + a)
    rowc = _rowtake(bpack, j * kb + c)
    rowe = _rowtake(bpack, ok * kb + e)
    boij_raw = rowa[:, 0]
    bojk_raw = rowc[:, 0]
    bokl_raw = rowe[:, 0]
    # live gates (exact reference semantics under list staleness)
    valid = (tl.valid
             & (boij_raw > esub) & (bojk_raw > esub) & (bokl_raw > esub)
             & (boij_raw * bojk_raw > esub)
             & (bojk_raw * bokl_raw > esub)
             & (boij_raw * bojk_raw * bojk_raw * bokl_raw > units.MINBO0))
    boij = boij_raw - esub
    bojk = bojk_raw - esub
    bokl = bokl_raw - esub
    bo_pi_jk = rowc[:, 1]
    tp = tl.prm                                        # (M, 9)
    (V1_, V2_, V3_, ptor1_, ptor2_, ptor3_, ptor4_, pcot1_,
     pcot2_) = [tp[..., k] for k in range(9)]

    rij = -rowa[:, 2:5]                                # r_i - r_j
    rjk = rowc[:, 2:5]                                 # r_j - r_k
    rkl = rowe[:, 2:5]                                 # r_k - r_l

    cos_ijk, nij, njk = _angle_cos(rij, rjk, valid)
    cos_jkl, _, nkl = _angle_cos(rjk, rkl, valid)
    sin_ijk = jnp.sqrt(jnp.maximum(1.0 - cos_ijk * cos_ijk, 0.0))
    sin_jkl = jnp.sqrt(jnp.maximum(1.0 - cos_jkl * cos_jkl, 0.0))

    uij = rij / nij[..., None]
    ujk = rjk / njk[..., None]
    ukl = rkl / nkl[..., None]
    crs1, n1 = _unit_cross(uij, ujk, valid)
    crs2, n2 = _unit_cross(ujk, ukl, valid)
    cos_w = _clip_cos(jnp.sum(crs1 * crs2, axis=-1) / (n1 * n2))
    omega = jnp.arccos(cos_w)
    cos_2w = jnp.cos(2.0 * omega)
    cos_3w = jnp.cos(3.0 * omega)

    # --- torsion energy (ref: pot.F90:1086-1129)
    boij_s = _safe(boij, valid, 1.0)
    bojk_s = _safe(bojk, valid, 1.0)
    bokl_s = _safe(bokl, valid, 1.0)
    exp_tor2_ij = jnp.exp(-ptor2_ * boij_s)
    exp_tor2_jk = jnp.exp(-ptor2_ * bojk_s)
    exp_tor2_kl = jnp.exp(-ptor2_ * bokl_s)
    # 2-col row gathers (the flat 1-D form takes the scalar path; the
    # barrier keeps XLA from narrowing the duplicated column — cf. ctx_qj)
    dpack = jnp.stack([delta_ang_n, delta_ang_n], axis=-1)
    dajk = _rowtake(dpack, j)[:, 0] + _rowtake(dpack, ok)[:, 1]
    fn10 = (1.0 - exp_tor2_ij) * (1.0 - exp_tor2_jk) * (1.0 - exp_tor2_kl)
    fn11 = _ratio23(-ptor3_ * dajk, ptor4_ * dajk)
    fn12 = jnp.exp(-pcot2_ * ((boij_s - 1.5) ** 2
                              + (bojk_s - 1.5) ** 2
                              + (bokl_s - 1.5) ** 2))
    # uses the raw pi BO of the j-k bond (ref: pot.F90:1102 remark)
    btb2 = 2.0 - bo_pi_jk - fn11
    exp_tor1 = jnp.exp(ptor1_ * btb2 * btb2)

    petors = 0.5 * fn10 * sin_ijk * sin_jkl * (
        V1_ * (1.0 + cos_w)
        + V2_ * exp_tor1 * (1.0 - cos_2w)
        + V3_ * (1.0 + cos_3w))
    peconj = (pcot1_ * fn12
              * (1.0 + (cos_w * cos_w - 1.0) * sin_ijk * sin_jkl))

    return (jnp.sum(jnp.where(valid, petors, 0.0)),
            jnp.sum(jnp.where(valid, peconj, 0.0)))


class HBondList(NamedTuple):
    """Flat hydrogen-bond list: one entry per (donor i, H-slot a, acceptor
    slot c).  Built on the rebuild cadence with slackened gates and
    re-gated live at evaluation (same caching contract as Angle/Torsion
    lists)."""
    i: jax.Array        # (M,) donor row
    a: jax.Array        # (M,) bonded slot of hydrogen j in nbrs.idxb[i]
    c: jax.Array        # (M,) nonbonded slot of acceptor k in nbrs.idxnb[i]
    prm: jax.Array      # (M, 4) r0, phb1, phb2, phb3
    valid: jax.Array    # (M,)
    cnt: jax.Array      # () true candidate count (overflow surfaced)


def _hbond_tables(pos, H, types, img, nbrs, bo: BondOrder, amask,
                  ffd: FFDev, kh: int, slack: float):
    """Global per-atom tables shared by the one-shot and chunked hbond
    builds: compacted central-H slots, nonbonded indices, ext positions,
    acceptor types."""
    kh = min(kh, nbrs.idxb.shape[1])
    maskb = bo.mask
    idxb = jnp.where(maskb, nbrs.idxb, 0)
    tj = types[img.owner_of(idxb)]
    bo0_sg = jax.lax.stop_gradient(bo.bo[..., 0])
    mask_ij = (maskb & (tj == ffd.h_type)
               & (bo0_sg > units.MINBO0 * slack) & amask[:, None])
    hslot, hvalid, _ = _row_topk_slots(mask_ij, kh)
    row = jnp.arange(maskb.shape[0])[:, None]
    idx_h = idxb[row, hslot]
    th = tj[row, hslot]
    idxnb = jnp.where(nbrs.masknb, nbrs.idxnb, 0)
    pose = jax.lax.stop_gradient(ext_positions(pos, H, img))
    tk = types[img.owner_of(idxnb)]                        # (n, knb)
    return hslot, hvalid, idx_h, th, idxnb, pose, tk


def _hbond_mask(pos, H, types, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
                kh: int, slack: float = 1.0, margin: float = 0.0):
    """(n, kh, knb) hbond candidate validity over compacted H slots
    (ref enumeration: pot.F90:587-631; donor i, central H j bonded to i,
    acceptor k from i's nonbonded list within rchb)."""
    tab = _hbond_tables(pos, H, types, img, nbrs, bo, amask, ffd, kh, slack)
    hslot, hvalid, idx_h, th, idxnb, pose, tk = tab
    n = nbrs.idxb.shape[0]
    m = _hbond_rows_m(jnp.arange(n), tab, pos, types, nbrs, ffd, margin)
    return m, hslot, tk


def _hbond_rows_m(rows, tab, pos, types, nbrs, ffd: FFDev, margin: float):
    """(B, kh, knb) mask for the given donor rows (see _hbond_mask)."""
    hslot, hvalid, idx_h, th, idxnb, pose, tk = tab
    hvalid_r = hvalid[rows]
    idx_h_r = idx_h[rows]
    th_r = th[rows]
    idxnb_r = idxnb[rows]
    masknb_r = nbrs.masknb[rows]
    tk_r = tk[rows]
    rik = jax.lax.stop_gradient(pos)[rows][:, None, :] - pose[idxnb_r]
    rik2 = jnp.sum(rik * rik, axis=-1)
    rchb2_m = (float(np.sqrt(units.RCHB2)) + margin) ** 2
    nso = ffd.hbok.shape[0]
    # acceptor one-hot laid out (B, nso, knb), NOT (B, knb, nso): a small
    # nso minor dimension pads badly in tiled layouts when materialized as
    # an einsum operand
    tkoh = (tk_r[:, None, :] == jnp.arange(nso)[:, None]).astype(pos.dtype)
    hbrow = ffd.hbok[types[rows][:, None], th_r]           # (B, kh, nso)
    ok_t = jnp.einsum("nck,nhc->nhk", tkoh, hbrow,
                      preferred_element_type=pos.dtype) > 0.5
    return (hvalid_r[:, :, None] & masknb_r[:, None, :] & ok_t
            & (idx_h_r[:, :, None] != idxnb_r[:, None, :])
            & (rik2 < rchb2_m)[:, None, :])


def build_hbond_list(pos, H, types, img, nbrs, bo: BondOrder, amask,
                     ffd: FFDev, cap: int = 1024, kh: int = 4,
                     slack: float = 1.0, margin: float = 0.0,
                     rowcap: int = 0, chunk: int = 0) -> HBondList:
    """Compact flat hbond list; `cap` is the TOTAL entry capacity.
    `chunk` > 0 (with rowcap > 0) computes the candidate mask in row
    chunks (bit-identical output, bounded peak memory — large-N path)."""
    n, kb = nbrs.idxb.shape
    if ffd.r0hb.shape[0] == 0:
        z = jnp.zeros((cap,), jnp.int32)
        return HBondList(i=z, a=z, c=z, prm=jnp.zeros((cap, 4), pos.dtype),
                         valid=jnp.zeros((cap,), bool), cnt=jnp.int32(0))
    knb = nbrs.idxnb.shape[1]
    if chunk > 0 and rowcap > 0:
        tab = _hbond_tables(pos, H, types, img, nbrs, bo, amask, ffd, kh,
                            slack)
        hslot, tk = tab[0], tab[6]
        kh = hslot.shape[1]
        fidx, valid, cnt = _flat_compact_mapped(
            lambda rows: _hbond_rows_m(
                rows, tab, pos, types, nbrs, ffd,
                margin).reshape(rows.shape[0], -1),
            n, kh * knb, cap, rowcap, chunk)
    else:
        m, hslot, tk = _hbond_mask(pos, H, types, img, nbrs, bo, amask,
                                   ffd, kh, slack, margin)
        kh = hslot.shape[1]
        if rowcap > 0:
            fidx, valid, cnt = _flat_compact_rows(m.reshape(n, -1), cap,
                                                  rowcap)
        else:
            fidx, valid, cnt = _flat_compact(m.reshape(-1), cap)
    i = fidx // (kh * knb)
    s = fidx % (kh * knb)
    a_h = s // knb
    c = (s % knb).astype(jnp.int32)
    a = hslot[i, a_h].astype(jnp.int32)
    # hbond type looked up only for the compacted entries (the dense
    # (n, kh, knb) gather is the expensive form; cf. _hbond_mask)
    th_c = types[img.owner_of(jnp.where(valid, nbrs.idxb[i, a], 0))]
    hbty_c = ffd.inxn3hb[types[i], th_c, tk[i, c]]
    prm = ffd.hbprm[jnp.where(valid & (hbty_c >= 0), hbty_c, 0)]
    return HBondList(i=i.astype(jnp.int32), a=a, c=c, prm=prm,
                     valid=valid, cnt=cnt)


def e_hbond_list(pos, H, types, img, nbrs, bo: BondOrder, hl: HBondList,
                 ffd: FFDev):
    """Hydrogen-bond energy over a (possibly cached) flat list with live
    re-gating — identical energies to the per-step grid enumeration
    (ref: pot.F90:587-665)."""
    if ffd.r0hb.shape[0] == 0:
        return jnp.asarray(0.0, pos.dtype)
    i, a, c = hl.i, hl.a, hl.c
    j_idx = jnp.where(hl.valid, nbrs.idxb[i, a], 0)
    k_idx = jnp.where(hl.valid, nbrs.idxnb[i, c], 0)
    n, kb = bo.mask.shape
    bo_ij = _rowtake(
        jnp.concatenate([bo.bo[..., 0:1], bo.bo[..., 0:1]],
                        axis=-1).reshape(n * kb, 2), i * kb + a)[:, 0]
    # ghost positions via the CONSTANT shift table (cf. bond_order): the
    # backward scatters into the (n, 3) owner rows directly instead of
    # the (S*n, 3) extended table + image reduction
    shift = img.shift.astype(pos.dtype)
    pj = _rowtake(pos, img.owner_of(j_idx)) + shift[j_idx] @ H.T
    pk = _rowtake(pos, img.owner_of(k_idx)) + shift[k_idx] @ H.T
    # live gates: exact reference semantics under list staleness
    rik = _rowtake(pos, i) - pk
    rik2_sg = jax.lax.stop_gradient(jnp.sum(rik * rik, axis=-1))
    valid = (hl.valid
             & (jax.lax.stop_gradient(bo_ij) > units.MINBO0)
             & (rik2_sg < units.RCHB2))
    r0, phb1_, phb2_, phb3_ = [hl.prm[:, k] for k in range(4)]
    rij = _rowtake(pos, i) - pj
    rjk = pj - pk
    cos_ijk, _, njk = _angle_cos(rij, rjk, valid)
    sin_xhz4 = ((1.0 - cos_ijk) * 0.5) ** 2        # sin^4(theta/2)
    exp_hb2 = jnp.exp(-phb2_ * bo_ij)
    r0 = jnp.where(valid & (r0 > 0.0), r0, 1.0)
    exp_hb3 = jnp.exp(-phb3_ * (r0 / njk + njk / r0 - 2.0))
    pehb = phb1_ * (1.0 - exp_hb2) * exp_hb3 * sin_xhz4
    return jnp.sum(jnp.where(valid, pehb, 0.0))


def e_hbond(pos, H, types, img, nbrs, bo: BondOrder, amask, ffd: FFDev,
            cap: int = 64, kh: int = 6, ctx: NbCtx = None):
    """Hydrogen bond energy (ref: pot.F90:587-665).

    Donor heavy atom i (resident), central hydrogen j (bonded to i),
    acceptor k from i's nonbonded list within rchb.  Valid (j-slot, k-slot)
    pairs per donor are compacted into a per-atom list of capacity `cap`.
    With `ctx`, acceptor type/distance data is reused from the shared pair
    context and the (n, kh, knb) acceptor-type test becomes a one-hot
    contraction instead of a ~10M-element table gather.
    """
    if ffd.r0hb.shape[0] == 0:
        return jnp.asarray(0.0, pos.dtype)
    n, kb = nbrs.idxb.shape
    knb = nbrs.idxnb.shape[1]
    pose = ext_positions(pos, H, img)
    maskb = bo.mask
    idxb = jnp.where(maskb, nbrs.idxb, 0)
    masknb = nbrs.masknb
    idxnb = jnp.where(masknb, nbrs.idxnb, 0)

    tj = types[img.owner_of(idxb)]                        # (n, kb)
    bo0_sg = jax.lax.stop_gradient(bo.bo[..., 0])
    mask_ij = (maskb & (tj == ffd.h_type) & (bo0_sg > units.MINBO0)
               & amask[:, None])
    # compact the (few) bonded-hydrogen slots per donor first
    kh = min(kh, kb)
    hslot, hvalid, _ = _row_topk_slots(mask_ij, kh)
    row = jnp.arange(n)[:, None]
    idx_h = idxb[row, hslot]                           # (n, kh)
    th = tj[row, hslot]

    if ctx is not None:
        # ---- grid mode: evaluate directly on the (n, kh, knb) lanes.
        # Compaction would save flops but add gathers on a mostly-empty
        # padded list; the dense grid is elementwise work plus one
        # differentiable acceptor row gather shared across all H slots.
        hbrow = ffd.hbok[types[:, None], th]           # (n, kh, nso) tiny
        okt = jnp.einsum("nkc,nhc->nhk", ctx_tjoh(ctx), hbrow,
                         preferred_element_type=hbrow.dtype) > 0.5
        valid = (hvalid[:, :, None] & masknb[:, None, :] & okt
                 & (idx_h[:, :, None] != idxnb[:, None, :])   # j != k
                 & (ctx.dr2 < units.RCHB2)[:, None, :])
        # per-lane params via one-hot contraction over the acceptor type
        hbP = ffd.hbprm[ffd.inxn3hb[types[:, None], th]]   # (n, kh, nso, 4)
        prm = jnp.einsum("nkc,nhcp->nhkp", ctx_tjoh(ctx), hbP,
                         preferred_element_type=hbP.dtype)
        r0 = jnp.where(valid & (prm[..., 0] > 0.0), prm[..., 0], 1.0)
        phb1_, phb2_, phb3_ = prm[..., 1], prm[..., 2], prm[..., 3]

        pose_j = pose[idx_h]                           # (n, kh, 3) small
        pose_k = pose[idxnb]                           # (n, knb, 3) one row
        rij = pos[:, None, :] - pose_j                 # (n, kh, 3)
        rjk = pose_j[:, :, None, :] - pose_k[:, None, :, :]  # (n,kh,knb,3)
        cos_ijk, _, njk = _angle_cos(rij[:, :, None, :], rjk, valid)
        sin_xhz4 = ((1.0 - cos_ijk) * 0.5) ** 2        # sin^4(theta/2)

        bo_ij = bo.bo[..., 0][row, hslot]              # (n, kh)
        exp_hb2 = jnp.exp(-phb2_ * bo_ij[:, :, None])
        exp_hb3 = jnp.exp(-phb3_ * (r0 / njk + njk / r0 - 2.0))
        pehb = phb1_ * (1.0 - exp_hb2) * exp_hb3 * sin_xhz4
        return jnp.sum(jnp.where(valid, pehb, 0.0))

    # ---- compacted mode (no shared ctx): per-donor padded pair list
    tk_full = types[img.owner_of(idxnb)]               # (n, knb)
    okt = ffd.inxn3hb[types[:, None, None],
                      th[:, :, None], tk_full[:, None, :]] >= 0
    rik = jax.lax.stop_gradient(pos)[:, None, :] - \
        jax.lax.stop_gradient(pose)[idxnb]
    rik2 = jnp.sum(rik * rik, axis=-1)
    mask = (hvalid[:, :, None] & masknb[:, None, :] & okt
            & (idx_h[:, :, None] != idxnb[:, None, :])  # j != k
            & (rik2 < units.RCHB2)[:, None, :])

    s, valid, _ = _row_topk_slots(mask.reshape(n, kh * knb), cap)
    b_slot = hslot[row, s // knb]
    k_slot = s % knb

    idx_j = idxb[row, b_slot]
    idx_k = idxnb[row, k_slot]
    tk_sel = types[img.owner_of(idx_k)]                # (n, cap) small
    hbt = ffd.inxn3hb[types[:, None], tj[row, b_slot], tk_sel]
    hbt = jnp.where(valid & (hbt >= 0), hbt, 0)
    hp = ffd.hbprm[hbt]                                # (n, cap, 4): one row
    r0, phb1_, phb2_, phb3_ = [hp[..., k] for k in range(4)]
    bo_ij = bo.bo[..., 0][row, b_slot]

    rij = pos[:, None, :] - pose[idx_j]                # (n, cap, 3)
    rjk = pose[idx_j] - pose[idx_k]
    cos_ijk, _, njk = _angle_cos(rij, rjk, valid)
    sin_xhz4 = ((1.0 - cos_ijk) * 0.5) ** 2            # sin^4(theta/2)

    exp_hb2 = jnp.exp(-phb2_ * bo_ij)
    r0 = jnp.where(valid & (r0 > 0.0), r0, 1.0)
    exp_hb3 = jnp.exp(-phb3_ * (r0 / njk + njk / r0 - 2.0))
    pehb = phb1_ * (1.0 - exp_hb2) * exp_hb3 * sin_xhz4
    return jnp.sum(jnp.where(valid, pehb, 0.0))


def _table_lerp(tbl, b, dr2, udr, udri, mask):
    """r^2-indexed linear interpolation (ref: pot.F90:729-743)."""
    x = _safe(dr2, mask, 0.5 * udr) * udri
    itb = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, tbl.shape[1] - 2)
    w = x - itb.astype(x.dtype)
    return (1.0 - w) * tbl[b, itb] + w * tbl[b, itb + 1]


def e_nonbond(pos, q, H, types, img, nbrs, gid, amask, ffd: FFDev):
    """van der Waals + Coulomb from tables + charge self-energy
    (ref: pot.F90:702-773)."""
    pose = ext_positions(pos, H, img)
    masknb = nbrs.masknb
    idx = jnp.where(masknb, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    # each unordered (image) pair counted once (ref: pot.F90:715 jid<iid)
    mask = masknb & (gid[oj] < gid[:, None]) & amask[:, None]

    dr = pos[:, None, :] - pose[idx]
    dr2 = jnp.sum(dr * dr, axis=-1)
    mask = mask & (dr2 <= ffd.rctap2)
    b = ffd.inxn2[types[:, None], types[oj]]
    bc = jnp.where(b >= 0, b, 0)

    pevdw = _table_lerp(ffd.tbl_evdw, bc, dr2, ffd.udr, ffd.udri, mask)
    peclmb = _table_lerp(ffd.tbl_eclmb, bc, dr2, ffd.udr, ffd.udri, mask)
    peclmb = peclmb * q[:, None] * q[oj]

    evdw = jnp.sum(jnp.where(mask, pevdw, 0.0))
    eclmb = jnp.sum(jnp.where(mask, peclmb, 0.0))

    # charge self-energy, eV->kcal (ref: pot.F90:708)
    echarge = jnp.sum(jnp.where(
        amask,
        units.CECHRGE * (ffd.chi[types] * q + 0.5 * ffd.eta[types] * q * q),
        0.0))
    return evdw, eclmb, echarge


def e_nonbond_pqeq(pos, spos, q, H, types, img, nbrs, gid, amask, ffd: FFDev,
                   pq):
    """van der Waals + 4-term core/shell Coulomb + charge/shell self-energy
    (ref: ENbond_PQEq pot.F90:784-923)."""
    from .pqeq import pqeq_kernels
    masknb = nbrs.masknb
    idx = jnp.where(masknb, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    mask = masknb & (gid[oj] < gid[:, None]) & amask[:, None]

    # owner-row pair geometry via the constant shift table (cf.
    # bond_order): gradients scatter into (n, 3) rows, never into the
    # (S*n, 3) extended table
    shg = img.shift.astype(pos.dtype)[idx]
    dr = pos[:, None, :] - _rowtake(pos, oj) - jnp.einsum(
        "nka,ba->nkb", shg, H, preferred_element_type=pos.dtype)
    spose_r = _rowtake(spos, oj)     # shells ride their owner's image
    dr2 = jnp.sum(dr * dr, axis=-1)
    mask = mask & (dr2 <= ffd.rctap2)
    b = ffd.inxn2[types[:, None], types[oj]]
    bc = jnp.where(b >= 0, b, 0)

    pevdw = _table_lerp(ffd.tbl_evdw, bc, dr2, ffd.udr, ffd.udri, mask)
    evdw = jnp.sum(jnp.where(mask, pevdw, 0.0))

    ti = types[:, None]
    tj = types[oj]
    zi = pq.Z[types][:, None]
    zj = pq.Z[tj]
    qic = q[:, None] + zi
    qjc = jnp.where(mask, _rowgather1(q, oj), 0.0) + zj
    polar_i = pq.is_polar[types][:, None]
    polar_j = pq.is_polar[tj]
    C0 = units.CCLMB0

    ecc = C0 * pqeq_kernels(pq, pq.pcc, ti, tj, dr, mask) * qic * qjc
    drsc = dr + spos[:, None, :]
    esc = jnp.where(mask & polar_i,
                    -C0 * pqeq_kernels(pq, pq.psc, ti, tj, drsc, mask)
                    * zi * qjc, 0.0)
    drcs = dr - spose_r
    ecs = jnp.where(mask & polar_j,
                    -C0 * pqeq_kernels(pq, pq.psc, tj, ti, drcs, mask)
                    * qic * zj, 0.0)
    drss = drsc - spose_r
    ess = jnp.where(mask & polar_i & polar_j,
                    C0 * pqeq_kernels(pq, pq.pss, ti, tj, drss, mask)
                    * zi * zj, 0.0)
    eclmb = jnp.sum(jnp.where(mask, ecc + esc + ecs + ess, 0.0))

    # self-energy + shell spring (ref: pot.F90:819-825)
    eshell = jnp.where(pq.is_polar[types],
                      0.5 * pq.Ks[types] * jnp.sum(spos * spos, axis=-1),
                      0.0)
    echarge = jnp.sum(jnp.where(
        amask,
        units.CECHRGE * (ffd.chi[types] * q + 0.5 * ffd.eta[types] * q * q)
        + eshell, 0.0))
    return evdw, eclmb, echarge


# ----------------------------------------------------------------------------
# assembly
# ----------------------------------------------------------------------------

# "ang"/"tor" are TOTAL flat-list capacities (see AngleList/TorsionList);
# "hb" is the per-donor pair capacity of e_hbond's compacted mode
DEFAULT_CAPS = {"ang": 4096, "tor": 8192, "hb": 64, "ks": 12, "kh": 6}


def energy_components(pos, q, H, types, gid, img: ImageTable,
                      nbrs: Neighbors, ffd: FFDev, amask=None, caps=None,
                      pq=None, spos=None, include_nonbond=True, ctx=None,
                      lists=None):
    """All potential-energy components as a (14,) vector using the
    reference's PE slot convention (ref: module.F90:143-146):
      0=total 1=Ebond 2=Elp 3=Eover 4=Eunder 5=Eval 6=Epen 7=Ecoa
      8=Etors 9=Econj 10=Ehb 11=Evdw 12=Eclmb 13=Echarge
    `caps` sets the per-atom angle/torsion/hbond list capacities.
    """
    caps = {**DEFAULT_CAPS, **(caps or {})}
    if amask is None:
        amask = jnp.ones(pos.shape[0], dtype=bool)
    if ctx is None:
        ctx = nb_ctx(pos, q, H, types, img, nbrs, gid, amask, ffd)
    bo = bond_order(pos, H, types, img, nbrs, ffd)
    lp = lone_pair(types, bo.delta, ffd)

    al, tl, hl = (tuple(lists) + (None,) * 3)[:3] if lists is not None \
        else (None, None, None)
    ebond = e_bond(types, img, nbrs, bo, gid, amask, ffd)
    elp, eover, eunder = e_lnpr(types, img, nbrs, bo, lp, amask, ffd)
    eval_, epen, ecoa = e_3body(pos, H, types, img, nbrs, bo, lp, amask, ffd,
                                cap=caps["ang"], ks=caps["ks"], al=al)
    etors, econj = e_4body(pos, H, types, img, nbrs, bo, amask, gid, ffd,
                           cap=caps["tor"], ks=caps["ks"], tl=tl)
    if hl is not None:
        ehb = e_hbond_list(pos, H, types, img, nbrs, bo, hl, ffd)
    else:
        ehb = e_hbond(pos, H, types, img, nbrs, bo, amask, ffd,
                      cap=caps["hb"], kh=caps["kh"], ctx=ctx)
    if not include_nonbond:
        z = jnp.zeros_like(ebond)
        evdw = eclmb = echarge = z
    elif pq is not None:
        evdw, eclmb, echarge = e_nonbond_pqeq(pos, spos, q, H, types, img,
                                              nbrs, gid, amask, ffd, pq)
    else:
        evdw, eclmb, echarge = e_nonbond(pos, q, H, types, img, nbrs, gid,
                                         amask, ffd)

    comps = jnp.stack([
        jnp.zeros_like(ebond), ebond, elp, eover, eunder, eval_, epen, ecoa,
        etors, econj, ehb, evdw, eclmb, echarge])
    comps = comps.at[0].set(jnp.sum(comps[1:]))
    return comps


def total_energy(pos, q, H, types, gid, img, nbrs, ffd, amask=None,
                 caps=None, pq=None, spos=None):
    return energy_components(pos, q, H, types, gid, img, nbrs, ffd, amask,
                             caps, pq, spos)[0]


def energy_and_forces(pos, q, H, types, gid, img, nbrs, ffd, amask=None,
                      caps=None, pq=None, spos=None, fast_nonbond=True,
                      closed_form=None, lists=None, with_virial=False,
                      ctx=None, rows_pre=None, external_nonbond=None):
    """(PE components, forces[, virial]).

    Bonded forces are exact -dE/dpos via autodiff; the ghost-force reduction
    (reference MODE_CPBK, comm.F90:74-78) happens automatically in the
    backward pass of the ghost-position gather.  With `fast_nonbond` (QEq
    path only) the nonbonded term uses the analytic derivative columns with
    row-only force accumulation — exactly the reference's force expression
    (pot.F90:736-761) and roughly half the gather/scatter traffic.

    `closed_form` selects the analytic nonbond kernels vs the reference's
    interpolation tables.  Both ride the shared pair context; the packed
    tables are bit-identical to the reference's interpolation AND fast (two
    row gathers), so they are the default.  The closed form is the exact
    analytic kernel — physically cleaner, but it differs from the golden
    trace by the reference table's own interpolation error (~2e-3/atom).

    `with_virial` additionally returns the (3, 3) potential virial
    W_ab = -dE/deps_ab via the strain gradient, sharing the force backward
    pass (the autodiff analog of the reference's per-step Σ pos·f stress
    accumulation, pot.F90:65-72).
    """
    use_fast = fast_nonbond and pq is None and external_nonbond is None
    if closed_form is None:
        closed_form = False
    if amask is None:
        amask = jnp.ones(pos.shape[0], dtype=bool)
    if ctx is None and external_nonbond is None:
        ctx = nb_ctx(pos, q, H, types, img, nbrs, gid, amask, ffd)

    include_nb = not use_fast and external_nonbond is None

    def ecomps(p, H_):
        return energy_components(p, q, H_, types, gid, img, nbrs, ffd,
                                 amask, caps, pq, spos,
                                 include_nonbond=include_nb,
                                 ctx=ctx, lists=lists)

    w = None
    if with_virial:
        def etot(p, eps):
            strain = jnp.eye(3, dtype=pos.dtype) + eps
            c = ecomps(p @ strain.T, strain @ H)
            return c[0], c
        eps0 = jnp.zeros((3, 3), pos.dtype)
        (_, comps), (gp, ge) = jax.value_and_grad(
            etot, argnums=(0, 1), has_aux=True)(pos, eps0)
        f = -gp
        w = -ge
    else:
        def etot(p):
            c = ecomps(p, H)
            return c[0], c
        (_, comps), grad = jax.value_and_grad(etot, has_aux=True)(pos)
        f = -grad
    if external_nonbond is not None:
        # nonbond computed outside (the dense minimum-image path,
        # `nonbond_dense`); splice energies, row forces and pair virial in
        evdw, eclmb, echarge, f_nb, w_nb = external_nonbond
        comps = comps.at[11].set(evdw).at[12].set(eclmb).at[13].set(echarge)
        comps = comps.at[0].set(jnp.sum(comps[1:]))
        f = f + f_nb
        if with_virial and w_nb is not None:
            w = w + w_nb
    elif use_fast:
        if closed_form:
            out = nonbond_cf_energy_forces(ctx, q, types, amask, ffd,
                                           with_virial=with_virial, img=img)
        else:
            out = nonbond_tbl_energy_forces(ctx, q, types, amask, ffd,
                                            with_virial=with_virial,
                                            pre=rows_pre, img=img)
        evdw, eclmb, echarge, f_nb = out[:4]
        comps = comps.at[11].set(evdw).at[12].set(eclmb).at[13].set(echarge)
        comps = comps.at[0].set(jnp.sum(comps[1:]))
        f = f + f_nb
        if with_virial:
            w = w + out[4]
    if with_virial:
        return comps, f, w
    return comps, f


def term_counts(pos, H, types, gid, img, nbrs, ffd, amask=None,
                slack: float = 1.0, margin: float = 0.0):
    """Host-side probe of actual per-atom interaction-list occupancies, used
    to auto-size the angle/torsion/hbond caps (analog of the reference's
    maxas stats, main.F90:128-146).  Upper bounds, cheap to compute.
    `slack`/`margin` must match the engine's list-caching gates so the caps
    cover the slackened candidate sets."""
    n = pos.shape[0]
    if amask is None:
        amask = jnp.ones(n, dtype=bool)
    bo = bond_order(pos, H, types, img, nbrs, ffd)
    kb = bo.mask.shape[1]
    bo0 = bo.bo[..., 0]
    esub = units.CUTOF2_ESUB
    _, _, cand_cnt, _, _, _ = _term_candidates(types, img, nbrs, bo, ffd,
                                               kb, slack, margin)
    degmax = int(cand_cnt.max())
    ksp = min(degmax + 2, kb)
    pm, _, _ = _angle_mask(types, img, nbrs, bo, amask, ffd, ksp, slack,
                           margin)
    ang = int(pm.sum())                        # TOTAL entries (flat lists)
    ang_row = int(pm.sum(axis=(1, 2)).max())   # per-center max (rowcap)
    # probe the torsion occupancy on the candidate sublist only (kb can be
    # much larger than the real bond degree when lists carry a Verlet skin)
    mask4, _, _ = _torsion_mask(types, gid, img, nbrs, bo, amask, ffd,
                                ks=ksp, slack=slack, margin=margin)
    tor = int(mask4.sum())                     # TOTAL entries (flat lists)
    tor_row = int(mask4.sum(axis=(1, 2, 3)).max())
    # hbond: count H-bonded slots, per-donor pair occupancy (compacted
    # per-atom mode) and the TOTAL flat candidate count (cached flat list),
    # with the same slack/margin gates the builder will use
    idx = jnp.where(bo.mask, nbrs.idxb, 0)
    is_h = (types[img.owner_of(idx)] == ffd.h_type) & bo.mask \
        & (bo0 > units.MINBO0 * slack)
    h_slots = int(is_h.sum(axis=1).max())
    hb = hbf = 0
    if ffd.r0hb.shape[0] > 0 and h_slots > 0:
        kh = min(h_slots, kb)
        m, _, _ = _hbond_mask(pos, H, types, img, nbrs, bo, amask, ffd,
                              kh, slack, margin)
        hb = int(m.sum(axis=(1, 2)).max())
        hbf = int(m.sum())
    return {"ang": ang, "tor": tor, "hb": hb, "hbf": hbf, "degmax": degmax,
            "h_slots": h_slots, "ang_row": ang_row, "tor_row": tor_row}
