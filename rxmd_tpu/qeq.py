"""Charge equilibration (QEq) — two-vector conjugate-gradient solver.

A JAX re-design of the reference solver (ref: src/qeq.F90).  The
(s, t) vectors are solved jointly as one (N, 2) stacked state: every matvec
is a single row gather + fused multiply-add, and the per-iteration dot
products collapse into ONE fused allreduce (the reference already batches
its 4 scalars into one MPI buffer, ref: qeq.F90:126-131 — we take that to
its conclusion).  The sparse "hessian" rows are the taper*shielded-Coulomb
kernel over the nonbonded pair list (ref: qeq.F90:183-268), evaluated either
closed-form (production; the analytic content of the reference's table,
init.F90:487-489) or by table interpolation (validation/bit-parity).

The CG iteration runs entirely on-device inside a `lax.while_loop` with the
exact termination semantics of the reference (two tests on the electrostatic
energy, ref: qeq.F90:114-115).  Reductions go through a pluggable `allreduce`
hook so the identical code runs single-chip (identity) and under shard_map
(`psum`) — the JAX analog of the reference's nompi/MPI duality
(ref: nompi.f90, qeq.F90:107-144).

On a single shard with a full CG solve (isQEq=1) the sparse rows are folded
into a dense (N, N) matrix once and every matvec is one matmul; for the
extended-Lagrangian mode (isQEq=2, one iteration — the reference's scaling
configuration, conf/bg-bench/rxmd.in) the ELL form is cheaper.

The reference stores the line-minimization step in real(4) (qeq.F90:23);
we optionally mirror that (`lmin_f32=True`) so iteration counts match.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .neighbors import ImageTable, Neighbors, ext_positions
from . import reax
from .reax import (FFDev, _table_lerp, _table_rows, _safe, nb_ctx,
                   cf_qeq_kernel, pair_bond_type, ctx_prm)


def dense_matvec(A, x):
    """The dense QEq matvec A @ x (one matmul; its operands are what a
    reduced-precision matmul, e.g. TF32 on a GPU, would round)."""
    return A @ x


class QEqResult(NamedTuple):
    q: jax.Array          # (N,) converged charges
    qs: jax.Array
    qt: jax.Array
    iters: jax.Array      # () int32 — number of completed CG updates
    est: jax.Array        # () final electrostatic energy [eV]


def solve(pos, q, qsfp, H, types, img: ImageTable, nbrs: Neighbors,
          ffd: FFDev, amask=None, isqeq: int = 1, nmax: int = 500,
          tol: float = 1e-7, lex_fqs: float = 1.0, allreduce=None,
          lmin_f32: bool = False, refresh=None,
          resident_ext=None, closed_form=None, pre=None,
          dense_max: int = 8192, direct: bool = False) -> QEqResult:
    """Solve for charges.  isqeq=1: full CG (ref: qeq.F90:39-48);
    isqeq=2: extended-Lagrangian warm start, one iteration
    (ref: qeq.F90:51-57).

    Multi-device hooks: `allreduce` (psum under shard_map), `refresh`
    (re-exchange ghost entries of a per-atom vector — the reference's
    per-iteration MODE_QCOPY1/2 halos, ref: qeq.F90:86-164) and
    `resident_ext` (which extended-index entries are locally resident,
    for the Est pair weights, ref: qeq.F90:304-306).

    `closed_form` selects the analytic hessian kernel (production) vs the
    reference's interpolation table (validation).  Default: closed form in
    float32, table in float64.
    """
    local_only = refresh is None
    if allreduce is None:
        allreduce = lambda x: x
    if refresh is None:
        refresh = lambda x: x
    n = pos.shape[0]
    dtype = pos.dtype
    # the termination tests are RELATIVE energy changes (qeq.F90:114-115);
    # below ~20 ulp of the working precision they can never trigger and the
    # CG stalls, burning iterations on rounding noise (observed: f32 takes
    # 37-49 iters where f64 takes 4-8).  Floor the tolerance accordingly —
    # f64 validation keeps the reference semantics exactly.
    tol = max(tol, 20.0 * float(jnp.finfo(dtype).eps))
    if closed_form is None:
        closed_form = False
    if amask is None:
        amask = jnp.ones((n,), dtype=bool)
    w = amask.astype(dtype)

    if direct and local_only:
        # dense minimum-image hessian (no neighbor list, no gathers): the
        # matrix build is elementwise work plus one-hot matmuls and every
        # CG matvec is an (n,n)@(n,2) matmul streaming from device memory
        # (in place of the reference's gather-bound get_hsh,
        # qeq.F90:271-318).  The engine enables this for orthogonal boxes
        # with min(L) > 2*rctap and n <= dense_direct_max.
        from .reax import qeq_dense_direct
        Hd, Hw = qeq_dense_direct(pos, H, types, ffd)
        eta = jnp.where(amask, ffd.eta[types], 0.0)
        chi = jnp.where(amask, ffd.chi[types], 0.0)

        def matvec2(X):
            return eta[:, None] * X + dense_matvec(Hd, X)

        def matvec2_and_est(Hv, qcur):
            per_atom = (chi * qcur + 0.5 * eta * qcur * qcur
                        + dense_matvec(Hw, qcur) * qcur)
            return matvec2(Hv), jnp.sum(jnp.where(amask, per_atom, 0.0))

        def gradient(X):
            rhs = jnp.stack([-chi, -w], axis=1)
            return jnp.where(amask[:, None], rhs - matvec2(X), 0.0)

        return _cg(q, qsfp, amask, dtype, isqeq, nmax, tol, lex_fqs,
                   lmin_f32, allreduce, matvec2_and_est, gradient)

    if pre is not None:
        # shared per-step pair context (+ table rows when interpolating) —
        # the QEq hessian column rides the same gather/geometry as the
        # nonbond kernels; rows=None means closed-form production kernels
        ctx, rows, ok = pre
        if rows is None:
            in_range = ctx.mask & (ctx.dr2 < ffd.rctap2)
            hess = cf_qeq_kernel(ctx.dr2, ctx_prm(ctx, types, ffd), ffd,
                                 in_range)
        else:
            hess = jnp.where(ok & (ctx.dr2 < ffd.rctap2), rows[..., 4], 0.0)
    else:
        # gid is only used by ctx for the self-image exclusion mask, which
        # QEq does NOT apply (the reference's qeq pair list keeps periodic
        # self-images, qeq.F90:200-256) — pass a dummy
        gid0 = jnp.zeros(pos.shape[0], jnp.int32)
        ctx = nb_ctx(pos, None, H, types, img, nbrs, gid0, amask, ffd)
        in_range = nbrs.masknb & (ctx.dr2 < ffd.rctap2)
        if closed_form:
            hess = cf_qeq_kernel(ctx.dr2, ctx_prm(ctx, types, ffd), ffd,
                                 in_range)
        else:
            bc = pair_bond_type(ctx, types, ffd)
            ok = in_range & (bc >= 0)
            rows = _table_rows(ffd, jnp.where(ok, bc, 0), ctx.dr2, ok)
            hess = jnp.where(ok, rows[..., 4], 0.0)
    mask = nbrs.masknb
    oj = img.owner_of(ctx.idx)
    eta = jnp.where(amask, ffd.eta[types], 0.0)
    chi = jnp.where(amask, ffd.chi[types], 0.0)

    # Est pair weight: 0.5 per directed entry plus another 0.5 when the
    # neighbor is locally resident (ref: qeq.F90:304-306).  With the
    # image-table layout residency is just `ext index < n` — a compare, not
    # a gather; the sharded engine passes its own resident mask.
    idxnb = jnp.where(mask, nbrs.idxnb, 0)
    if resident_ext is None:
        est_w = jnp.where(idxnb < n, 1.0, 0.5)
    else:
        est_w = jnp.where(resident_ext[idxnb], 1.0, 0.5)
    hz = jnp.where(mask, hess, 0.0)

    def pair_energy(qcur):
        """Σ_k est_w·H_ik·q_k per atom i, ELL form (one row gather per
        call — it runs once per CG iteration, so a dense fold would cost
        more to build than it saves).  2-column row-gather form
        (cf. reax._rowgather1)."""
        qr = refresh(qcur)
        qj = jnp.where(mask, reax._rowgather1(qr, oj), 0.0)
        return jnp.sum(est_w * hz * qj, axis=1) * qcur

    # On a single shard a long CG solve is gather-bound in ELL form; fold
    # the owner mapping into a dense matrix once and matmul instead.
    # The 1-iteration extended-Lagrangian mode does only ~3 matvec sweeps,
    # where three (n,knb,2) row gathers are cheaper than one dense scatter
    # build — it stays in ELL form.  Memory caps the dense path at
    # n <= dense_max (256 MB f32 at the default 8192); dense_max=0 forces
    # ELL everywhere, e.g. for bit-comparing against the sharded path.
    dense = local_only and n <= dense_max and not (isqeq == 2)
    if dense:
        row = jnp.broadcast_to(jnp.arange(n)[:, None], oj.shape)
        Hd = jnp.zeros((n, n), dtype).at[row, oj].add(hz)

        def matvec2(X):                      # X: (n, 2)
            return eta[:, None] * X + dense_matvec(Hd, X)
    else:
        def matvec2(X):
            """(eta*I + H) X for stacked vectors, ghosts refreshed."""
            Xr = refresh(X)
            Xs = jnp.where(mask[..., None], Xr[oj], 0.0)   # (n, knb, 2)
            return (eta[:, None] * X
                    + jnp.einsum("nk,nkc->nc", hz, Xs,
                                 preferred_element_type=dtype))

    def gradient(X):
        rhs = jnp.stack([-chi, -w], axis=1)            # (n, 2)
        return jnp.where(amask[:, None], rhs - matvec2(X), 0.0)

    def electrostatic(qcur):
        per_atom = chi * qcur + 0.5 * eta * qcur * qcur + pair_energy(qcur)
        return jnp.sum(jnp.where(amask, per_atom, 0.0))

    if dense:
        def matvec2_and_est(Hv, qcur):
            return matvec2(Hv), electrostatic(qcur)
    else:
        def matvec2_and_est(Hv, qcur):
            """Fused CG-body sweep: ONE (n, knb, 3) row gather feeds both
            the matvec H·(hs,ht) and the Est pair energy (the analog of the
            reference's single get_hsh pass computing hshs/hsht AND Est,
            ref: qeq.F90:271-318)."""
            Y = jnp.concatenate([Hv, qcur[:, None]], axis=1)   # (n, 3)
            Ys = jnp.where(mask[..., None], refresh(Y)[oj], 0.0)
            mv = (eta[:, None] * Hv
                  + jnp.einsum("nk,nkc->nc", hz, Ys[..., :2],
                               preferred_element_type=dtype))
            pair = jnp.sum(est_w * hz * Ys[..., 2], axis=1) * qcur
            per_atom = chi * qcur + 0.5 * eta * qcur * qcur + pair
            return mv, jnp.sum(jnp.where(amask, per_atom, 0.0))

    return _cg(q, qsfp, amask, dtype, isqeq, nmax, tol, lex_fqs,
               lmin_f32, allreduce, matvec2_and_est, gradient)


def _cg(q, qsfp, amask, dtype, isqeq, nmax, tol, lex_fqs, lmin_f32,
        allreduce, matvec2_and_est, gradient):
    """Two-vector CG with the reference's exact termination semantics
    (ref: qeq.F90:96-166), parameterized over the matvec/Est implementation
    (ELL row gathers or a dense matmul)."""
    if isqeq == 2:
        qs0 = jnp.where(amask, lex_fqs * qsfp + (1.0 - lex_fqs) * q, 0.0)
        nmax_eff = 1
    else:
        qs0 = jnp.where(amask, q, 0.0)
        nmax_eff = nmax
    X0 = jnp.stack([qs0, jnp.zeros_like(q)], axis=1)   # (n, 2) = (qs, qt)
    # hide the known-zero qt column: XLA otherwise splits the stacked
    # 2-column matvec gather into a slow flat 1-D gather of qs alone
    X0 = jax.lax.optimization_barrier(X0)

    G0 = gradient(X0)
    gnew0 = allreduce(jnp.sum(G0 * G0, axis=0))        # (2,)
    H0 = G0

    def gnew_safe(g):
        return jnp.where(jnp.abs(g) > 0.0, g, 1.0)

    # "never converged yet" sentinel (ref GEst2=1.d99, qeq.F90:98) — use the
    # dtype's own max so the f32 production path doesn't overflow in cast
    big = jnp.asarray(jnp.finfo(dtype).max, dtype)
    init = (jnp.int32(0), X0, q, H0, G0, gnew0,
            big, jnp.asarray(0.0, dtype), False)

    def cond(c):
        it, *_, done = c
        return (it < nmax_eff) & jnp.logical_not(done)

    def body(c):
        (it, X, qcur, Hv, G, gnew, gest2, _, done) = c
        HH, est_l = matvec2_and_est(Hv, qcur)          # (n, 2), ()
        # one fused allreduce for: est, g.h (2), h.Hh (2) — the analog of
        # the reference's batched 4-scalar MPI buffer (qeq.F90:126-131)
        red = allreduce(jnp.concatenate([
            est_l[None], jnp.sum(G * Hv, axis=0), jnp.sum(Hv * HH, axis=0)]))
        est, g_h, h_hsh = red[0], red[1:3], red[3:5]
        ex1 = 0.5 * (jnp.abs(gest2) + jnp.abs(est)) < tol
        ex2 = (jnp.abs(gest2) > 0.0) & (jnp.abs(est / gest2 - 1.0) < tol)
        stop = ex1 | ex2

        lmin = g_h / jnp.where(h_hsh != 0.0, h_hsh, 1.0)
        if lmin_f32:
            lmin = lmin.astype(jnp.float32).astype(dtype)  # ref: qeq.F90:23
        X1 = X + lmin[None, :] * Hv
        st = allreduce(jnp.sum(X1, axis=0))            # (2,): Σqs, Σqt
        mu = st[0] / st[1]
        q1 = jnp.where(amask, X1[:, 0] - mu * X1[:, 1], 0.0)
        # CG residual recurrence: gradient(X1) = gradient(X) - lmin*A·Hv,
        # and A·Hv = HH was just computed — this saves the second full
        # matvec sweep per iteration that the reference spends in an
        # explicit get_gradient call (ref: qeq.F90:157); identical values
        # in exact arithmetic, standard CG practice in floating point
        G1 = jnp.where(amask[:, None], G - lmin[None, :] * HH, 0.0)
        gnew1 = allreduce(jnp.sum(G1 * G1, axis=0))
        H1 = G1 + (gnew1 / gnew_safe(gnew))[None, :] * Hv

        sel = lambda a, b_: jax.tree.map(
            lambda x, y: jnp.where(stop, x, y), a, b_)
        new = (it + 1, X1, q1, H1, G1, gnew1, est, est, False)
        old = (it, X, qcur, Hv, G, gnew, gest2, est, True)
        return sel(old, new)

    out = jax.lax.while_loop(cond, body, init)
    it, X, qcur, *_rest = out
    est_last = out[7]
    return QEqResult(q=qcur, qs=X[:, 0], qt=X[:, 1], iters=it, est=est_last)
