"""Polarizable charge equilibration (PQEq) — core/shell model.

A JAX re-design of the reference solver (ref: src/pqeq.F90) and its
helpers (ref: module.F90:336-613).  Each polarizable atom carries a Gaussian
core of charge q_i + Z_i at pos and a shell of charge -Z_i at pos + spos.
Charges are solved by the same two-vector CG as QEq but with erf-screened
Coulomb kernels and an extra constant gradient term (Eq. 30 of the PQEq
paper, ref: pqeq.F90:326-334); shell positions are relaxed by one damped
steepest-descent step per call, capped at 1e-3 A (ref: pqeq.F90:187-259).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import units
from .neighbors import ImageTable, Neighbors, ext_positions
from .reax import FFDev, _rowgather1


class PQEqParams(NamedTuple):
    ntype: int
    names: tuple
    is_polar: jax.Array      # (nt,) bool
    X0: jax.Array            # electronegativity override [eV]
    J0: jax.Array            # hardness override [eV]
    Z: jax.Array             # core charge
    Ks: jax.Array            # shell spring constant
    alphacc: jax.Array       # (nt, nt) screening parameters
    alphasc: jax.Array
    alphass: jax.Array
    # kernels on the r^2 grid, (nt, nt, NTABLE+1): value and derivative/r
    pcc: jax.Array
    dpcc: jax.Array
    psc: jax.Array
    dpsc: jax.Array
    pss: jax.Array
    dpss: jax.Array
    udr: jax.Array
    udri: jax.Array
    rctap2: jax.Array


def parse_pqeq_par(path: str):
    """Parse a pqeq1.par file (ref: cmdline.F90:168-236).  Note: the
    reference ignores the 'P' column and marks every listed type polarizable
    (cmdline.F90:216); we mirror that."""
    rows = []
    nparms = None
    with open(path) as fh:
        for line in fh:
            t = line.strip()
            if not t or t.startswith("#"):
                continue
            if t.startswith("NPARMS"):
                nparms = int(t.split()[1])
                continue
            tok = t.split()
            rows.append((tok[0], True, *(float(x) for x in tok[2:8])))
            if nparms and len(rows) == nparms:
                break
    names = tuple(r[0] for r in rows)
    arr = np.array([r[2:] for r in rows])
    return {
        "names": names,
        "is_polar": np.array([r[1] for r in rows]),
        "X0": arr[:, 0], "J0": arr[:, 1], "Z": arr[:, 2],
        "Rc": arr[:, 3], "Rs": arr[:, 4], "Ks": arr[:, 5],
    }


def make_pqeq(par: dict, dtype=jnp.float64, rctap: float = None,
              ntable: int = units.NTABLE) -> PQEqParams:
    """Screening alphas (ref: module.F90:448-485) and tabulated kernels
    (ref: initialize_pqeq module.F90:537-612)."""
    if rctap is None:
        rctap = units.RCTAP0_PQEQ
    nt = len(par["names"])
    polar = np.asarray(par["is_polar"], bool)
    Z = np.where(polar, par["Z"], 0.0)        # ref: module.F90:503-507
    Ks = np.where(polar, par["Ks"], 0.0)
    lam = units.LAMBDA_PQEQ
    a_c = 0.5 * lam / np.asarray(par["Rc"]) ** 2
    a_s = 0.5 * lam / np.asarray(par["Rs"]) ** 2
    comb = lambda x, y: np.sqrt(x[:, None] * y[None, :]
                                / (x[:, None] + y[None, :]))
    alphacc = comb(a_c, a_c)
    alphass = np.where(polar[:, None] & polar[None, :], comb(a_s, a_s), 0.0)
    alphasc = np.where(polar[:, None], comb(a_s, a_c), 0.0)

    ctap = np.array(units.taper_coeffs(rctap))
    udr = rctap * rctap / ntable
    k = np.arange(ntable + 1, dtype=np.float64)
    dr2 = np.maximum(udr * k, 1e-12)
    dr1 = np.sqrt(dr2)
    dr3, dr4 = dr1 * dr2, dr2 * dr2
    dr5 = dr1 * dr4
    dr6 = dr2 * dr4
    dr7 = dr1 * dr6
    Tap = ctap[7] * dr7 + ctap[6] * dr6 + ctap[5] * dr5 + ctap[4] * dr4 + ctap[0]
    dTap = 7 * ctap[7] * dr5 + 6 * ctap[6] * dr4 + 5 * ctap[5] * dr3 + 4 * ctap[4] * dr2

    import math
    _erf = np.vectorize(math.erf)

    def kernel(alpha):
        # E = erf(a r)/r * Tap;  dE = (dE/dr)/r  (ref: module.F90:573-607)
        clmb = 1.0 / dr1
        dclmb = -clmb ** 3
        screen = _erf(alpha * dr1)
        dscreen = 2.0 * alpha / np.sqrt(np.pi) * np.exp(-alpha * alpha * dr2) / dr1
        E = clmb * screen * Tap
        dE = dclmb * screen * Tap + clmb * dscreen * Tap + clmb * screen * dTap
        return E, dE

    pcc = np.zeros((nt, nt, ntable + 1)); dpcc = np.zeros_like(pcc)
    psc = np.zeros_like(pcc); dpsc = np.zeros_like(pcc)
    pss = np.zeros_like(pcc); dpss = np.zeros_like(pcc)
    for i in range(nt):
        for j in range(nt):
            pcc[i, j], dpcc[i, j] = kernel(max(alphacc[i, j], 1e-10))
            psc[i, j], dpsc[i, j] = kernel(max(alphasc[i, j], 1e-10))
            pss[i, j], dpss[i, j] = kernel(max(alphass[i, j], 1e-10))

    f = lambda a: jnp.asarray(a, dtype)
    return PQEqParams(
        ntype=nt, names=par["names"], is_polar=jnp.asarray(polar),
        X0=f(par["X0"]), J0=f(par["J0"]), Z=f(Z), Ks=f(Ks),
        alphacc=f(alphacc), alphasc=f(alphasc), alphass=f(alphass),
        pcc=f(pcc), dpcc=f(dpcc), psc=f(psc), dpsc=f(dpsc),
        pss=f(pss), dpss=f(dpss),
        udr=f(udr), udri=f(1.0 / udr), rctap2=f(rctap * rctap))


def apply_to_ff(ff, par):
    """Override chi/eta for polarizable types (ref: module.F90:502-523,
    including the 2x eta convention)."""
    for i, polar in enumerate(par["is_polar"]):
        if i >= ff.nso:
            break
        if polar:
            ff.chi[i] = par["X0"][i]
            ff.eta[i] = 2.0 * par["J0"][i]
    return ff


def _lerp2(tblE, ti, tj, dr2, udr, udri, mask):
    x = jnp.where(mask, dr2, 0.5 * udr) * udri
    itb = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, tblE.shape[-1] - 2)
    w = x - itb.astype(x.dtype)
    return (1.0 - w) * tblE[ti, tj, itb] + w * tblE[ti, tj, itb + 1]


def pqeq_kernels(pq: PQEqParams, tblE, ti, tj, dvec, mask):
    """Tabulated screened-Coulomb value for displacement vectors `dvec`
    (zero beyond the taper cutoff, ref: module.F90:399-416)."""
    dr2 = jnp.sum(dvec * dvec, axis=-1)
    m = mask & (dr2 <= pq.rctap2)
    return jnp.where(m, _lerp2(tblE, ti, tj, dr2, pq.udr, pq.udri, m), 0.0)


def solve(pos, spos, q, qsfp, H, types, img: ImageTable, nbrs: Neighbors,
          ffd: FFDev, pq: PQEqParams, amask=None, isqeq: int = 1,
          nmax: int = 500, tol: float = 1e-7, lex_fqs: float = 1.0,
          allreduce=None, refresh=None, resident_ext=None,
          efield_dir=None, efield_strength: float = 0.0,
          lmin_f32: bool = False):
    """PQEq CG solve + one shell relaxation step (ref: pqeq.F90:2-259).
    Returns (q, spos_new, iters, Est).

    `efield_dir`/`efield_strength`: constant electric field acting on the
    shell charges during relaxation (ref: pqeq.F90:205).  `lmin_f32`
    mirrors the reference's real(4) line-minimization step (pqeq.F90:27)
    so CG iteration counts can be matched bit-for-bit in f64 validation.
    Multi-device: `allreduce`/`refresh` are the psum / per-iteration ghost
    halo hooks (ref: MODE_QCOPY1/2, pqeq.F90:89-165, comm.F90:187-212)."""
    if allreduce is None:
        allreduce = lambda x: x
    if refresh is None:
        refresh = lambda x: x
    n = pos.shape[0]
    dtype = pos.dtype
    # f32 floor on the relative-change termination tests (see qeq.solve)
    tol = max(tol, 20.0 * float(jnp.finfo(dtype).eps))
    if amask is None:
        amask = jnp.ones((n,), dtype=bool)
    w = amask.astype(dtype)

    pose = ext_positions(pos, H, img)
    spose = spos[img.owner]          # shells ride their owner's displacement
    mask = nbrs.masknb
    idx = jnp.where(mask, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    ti = types[:, None]
    tj = types[oj]
    dr = pos[:, None, :] - pose[idx]
    dr2 = jnp.sum(dr * dr, axis=-1)
    mask = mask & (dr2 < pq.rctap2)

    # hessian rows: core-core screened kernel in eV (ref: pqeq.F90:322-324)
    hcc = units.CCLMB0_QEQ * pqeq_kernels(pq, pq.pcc, ti, tj, dr, mask)

    # constant gradient term fpqeq (Eq. 30, ref: pqeq.F90:326-334)
    drcs = dr - spose[idx]           # core(i) - shell(j)
    psc_ji = units.CCLMB0_QEQ * pqeq_kernels(pq, pq.psc, tj, ti, drcs, mask)
    zj = pq.Z[tj]
    polar_j = pq.is_polar[tj]
    fpqeq = jnp.sum(jnp.where(mask, hcc * zj, 0.0)
                    - jnp.where(mask & polar_j, psc_ji * zj, 0.0), axis=1)
    fpqeq = jnp.where(amask, fpqeq, 0.0)

    eta = jnp.where(amask, ffd.eta[types], 0.0)
    chi = jnp.where(amask, ffd.chi[types], 0.0)

    def matvec(x):
        x = refresh(x)
        # 2-column row-gather form: the flat x[oj] embeds in a fusion as
        # a serial scalar loop (cf. reax._rowgather1)
        xs = jnp.where(mask, _rowgather1(x, oj), 0.0)
        return eta * x + jnp.sum(hcc * xs, axis=1)

    def gradient(qs, qt):
        gs = jnp.where(amask, -chi - matvec(qs) - fpqeq, 0.0)
        gt = jnp.where(amask, -1.0 * w - matvec(qt), 0.0)
        gnew = jnp.stack([allreduce(jnp.sum(gs * gs)),
                          allreduce(jnp.sum(gt * gt))])
        return gs, gt, gnew

    # electrostatic energy (ref: get_hsh pqeq.F90:361-435): every directed
    # pair counted once with weight 0.5 for cc and ss, 1.0 for sc
    zi = pq.Z[types][:, None]
    polar_i = pq.is_polar[types][:, None]
    shell_i = spos[:, None, :]
    drsc = dr + shell_i              # shell(i) - core(j)
    drss = drsc - spose[idx]         # shell(i) - shell(j)
    csc = jnp.where(
        mask & polar_i,
        -units.CCLMB0_QEQ * pqeq_kernels(pq, pq.psc, ti, tj, drsc, mask) * zi,
        0.0)
    css = jnp.where(
        mask & polar_i & polar_j,
        units.CCLMB0_QEQ * pqeq_kernels(pq, pq.pss, ti, tj, drss, mask)
        * zi * zj, 0.0)

    def electrostatic(qcur):
        qcur = refresh(qcur)
        qic = qcur + pq.Z[types]
        qjc = jnp.where(mask, _rowgather1(qcur, oj), 0.0) + zj
        pair = (0.5 * (hcc * qic[:, None] * qjc + css) + csc * qjc)
        per_atom = (chi * qcur + 0.5 * eta * qcur * qcur
                    + jnp.sum(jnp.where(mask, pair, 0.0), axis=1))
        return allreduce(jnp.sum(jnp.where(amask, per_atom, 0.0)))

    if isqeq == 2:
        qs0 = jnp.where(amask, lex_fqs * qsfp + (1.0 - lex_fqs) * q, 0.0)
        nmax_eff = 1
    else:
        qs0 = jnp.where(amask, q, 0.0)
        nmax_eff = nmax
    qt0 = jnp.zeros_like(q)
    gs0, gt0, gnew0 = gradient(qs0, qt0)
    hs0, ht0 = gs0, gt0

    def gsafe(g):
        return jnp.where(jnp.abs(g) > 0.0, g, 1.0)

    # sentinel (ref GEst2=1.d99, pqeq.F90:98): dtype max avoids f32 overflow
    init = (jnp.int32(0), qs0, qt0, q, hs0, ht0, gs0, gt0, gnew0,
            jnp.asarray(jnp.finfo(dtype).max, dtype),
            jnp.asarray(0.0, dtype), False)

    def cond(c):
        it, *_, done = c
        return (it < nmax_eff) & jnp.logical_not(done)

    def body(c):
        (it, qs, qt, qcur, hs, ht, gs, gt, gnew, gest2, _, done) = c
        est = electrostatic(qcur)
        ex1 = 0.5 * (jnp.abs(gest2) + jnp.abs(est)) < tol
        ex2 = (jnp.abs(gest2) > 0.0) & (jnp.abs(est / gest2 - 1.0) < tol)
        stop = ex1 | ex2
        hshs_v = matvec(hs)
        hsht_v = matvec(ht)
        g_h = jnp.stack([allreduce(jnp.sum(gs * hs)),
                         allreduce(jnp.sum(gt * ht))])
        h_hsh = jnp.stack([allreduce(jnp.sum(hs * hshs_v)),
                           allreduce(jnp.sum(ht * hsht_v))])
        lmin = g_h / jnp.where(h_hsh != 0.0, h_hsh, 1.0)
        if lmin_f32:
            lmin = lmin.astype(jnp.float32).astype(dtype)  # ref: pqeq.F90:27
        qs1 = qs + lmin[0] * hs
        qt1 = qt + lmin[1] * ht
        mu = allreduce(jnp.sum(qs1)) / allreduce(jnp.sum(qt1))
        q1 = jnp.where(amask, qs1 - mu * qt1, 0.0)
        gs1, gt1, gnew1 = gradient(qs1, qt1)
        hs1 = gs1 + (gnew1[0] / gsafe(gnew[0])) * hs
        ht1 = gt1 + (gnew1[1] / gsafe(gnew[1])) * ht
        sel = lambda a, b: jax.tree.map(lambda x, y: jnp.where(stop, x, y),
                                        a, b)
        new = (it + 1, qs1, qt1, q1, hs1, ht1, gs1, gt1, gnew1, est, est,
               False)
        old = (it, qs, qt, qcur, hs, ht, gs, gt, gnew, gest2, est, True)
        return sel(old, new)

    out = jax.lax.while_loop(cond, body, init)
    qf = out[3]
    est = out[10]

    spos_new = update_shells(pos, spos, refresh(qf), H, types, img, nbrs, pq,
                             amask, efield_dir=efield_dir,
                             efield_strength=efield_strength)
    return qf, spos_new, out[0], est


def shell_forces(pos, spos, q, H, types, img, nbrs, pq: PQEqParams, amask,
                 efield_dir=None, efield_strength=0.0):
    """Total force on each shell: spring + screened Coulomb from every
    neighbor core and shell, + optional eField
    (ref: pqeq.F90:197-238 Eqs. 37-38 + :205)."""
    pose = ext_positions(pos, H, img)
    spose = spos[img.owner]
    mask = nbrs.masknb
    idx = jnp.where(mask, nbrs.idxnb, 0)
    oj = img.owner_of(idx)
    ti = types[:, None]
    tj = types[oj]
    zi = pq.Z[types]
    zj = pq.Z[tj]
    qjc = jnp.where(mask, q[oj], 0.0) + zj

    shelli = pos + spos
    drsc = shelli[:, None, :] - pose[idx]            # shell(i) - core(j)
    drss = drsc - spose[idx]                         # shell(i) - shell(j)

    def dkern(tbl, ta, tb, dvec):
        dr2 = jnp.sum(dvec * dvec, axis=-1)
        m = mask & (dr2 <= pq.rctap2)
        return jnp.where(m, _lerp2(tbl, ta, tb, dr2, pq.udr, pq.udri, m), 0.0)

    dsc = dkern(pq.dpsc, ti, tj, drsc)[..., None] * drsc
    ff_sc = -units.CCLMB0 * dsc * (qjc * zi[:, None])[..., None]
    dss = dkern(pq.dpss, ti, tj, drss)[..., None] * drss
    polar_j = pq.is_polar[tj]
    ff_ss = jnp.where((polar_j)[..., None],
                      units.CCLMB0 * dss * (zi[:, None] * zj)[..., None], 0.0)

    sforce = -pq.Ks[types][:, None] * spos \
        - jnp.sum(ff_sc + ff_ss, axis=1)
    if efield_dir is not None and efield_strength != 0.0:
        sforce = sforce.at[:, efield_dir].add(
            -zi * efield_strength * units.EEV_KCAL)
    return sforce


def update_shells(pos, spos, q, H, types, img, nbrs, pq: PQEqParams, amask,
                  efield_dir=None, efield_strength=0.0):
    """One damped steepest-descent shell relaxation, displacement capped at
    1e-3 A (ref: update_shell_positions pqeq.F90:187-259, Eq. 39)."""
    max_disp = 1e-3
    sforce = shell_forces(pos, spos, q, H, types, img, nbrs, pq, amask,
                          efield_dir, efield_strength)
    ks = jnp.maximum(pq.Ks[types], 1e-10)
    dr = sforce / ks[:, None]
    ddr = jnp.sqrt(jnp.maximum(jnp.sum(dr * dr, axis=-1), 1e-30))
    scale = jnp.where(ddr > max_disp, max_disp / ddr, 1.0)
    dr = dr * scale[:, None]
    polar_i = pq.is_polar[types] & amask
    return jnp.where(polar_i[:, None], spos + dr, spos)
