"""Per-phase timing of the production step path (run it on the GPU).

    MC=4,4,3 python scripts/prof_step.py

Mirrors bench.py's config (isQEq=2, term_cache on) and times each stage of
the step: QEq-exL, forces fwd+bwd, per-term pieces, and the rebuild path.
"""
import os, sys, time
import jax
import jax.numpy as jnp
import numpy as np
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from rxmd_tpu import md, reax, qeq
from rxmd_tpu.config import RunConfig
from rxmd_tpu.tools import geninputs

dtype = jnp.float32
mc = tuple(int(x) for x in os.environ.get("MC", "3,3,3").split(","))
ff, st = geninputs.load(mc, dtype)
cfg = RunConfig(mdmode=1, dt_fs=0.25, ntime_step=20, pstep=1000, sstep=10000,
                isQEq=2, QEq_tol=1e-7, dtype="float32")
eng = md.Engine(ff, st, cfg, dtype=dtype)
print(f"N={st.n} kb={eng.kb} knb={eng.knb} caps={eng.caps} "
      f"term_cache={eng.term_cache}", flush=True)
eng.prepare()
s = eng.state
nbrs = eng.nbrs
lists = eng.tlists
img = eng.img
ffd = eng.ffd
caps = eng.caps
amask = jnp.ones(s.n, bool)


def timeit(name, fn, reps=10):
    r = fn(); jax.block_until_ready(jax.tree.leaves(r)[0])
    t0 = time.time()
    for _ in range(reps):
        r = fn()
    jax.block_until_ready(jax.tree.leaves(r)[0])
    print(f"{name:32s}: {(time.time()-t0)/reps*1000:8.2f} ms", flush=True)
    return r


# --- full step ---
step = eng._step
timeit("FULL STEP", lambda: step(s, eng.force, nbrs, lists, eng._pos_ref, eng._astr))

# --- rebuild ---
timeit("rebuild (nbrs+lists)", lambda: eng._rebuild(s), reps=3)

# --- QEq exL ---
qeqf = jax.jit(lambda p, q, qs: qeq.solve(
    p, q, qs, s.H, s.types, img, nbrs, ffd, isqeq=2, nmax=cfg.NMAXQEq,
    tol=cfg.QEq_tol, lex_fqs=cfg.Lex_fqs))
timeit("QEq exL (1 CG iter)", lambda: qeqf(s.pos, s.q, s.qsfp))

# --- forces: fwd+bwd with cached lists ---
eff = jax.jit(lambda p, q: reax.energy_and_forces(
    p, q, s.H, s.types, s.gid, img, nbrs, ffd, caps=caps, lists=lists))
timeit("energy_and_forces (cached)", lambda: eff(s.pos, s.q))

# forward only
etot = jax.jit(lambda p, q: reax.total_energy(
    p, q, s.H, s.types, s.gid, img, nbrs, ffd, caps=caps))
timeit("total_energy fwd (no lists)", lambda: etot(s.pos, s.q))

# --- pieces ---
bofn = jax.jit(lambda p: reax.bond_order(p, s.H, s.types, img, nbrs, ffd))
bov = timeit("bond_order fwd", lambda: bofn(s.pos))

al, tl, hl0 = lists

def _sum(x):
    if isinstance(x, tuple):
        return sum(x)
    return x

def _ebd(p):
    bo = reax.bond_order(p, s.H, s.types, img, nbrs, ffd)
    return _sum(reax.e_bond(s.types, img, nbrs, bo, s.gid, amask, ffd))
g_ebd = jax.jit(jax.grad(_ebd))
timeit("grad(e_bond+BO)", lambda: g_ebd(s.pos))

def _elp(p):
    bo = reax.bond_order(p, s.H, s.types, img, nbrs, ffd)
    lp = reax.lone_pair(s.types, bo.delta, ffd)
    return _sum(reax.e_lnpr(s.types, img, nbrs, bo, lp, amask, ffd))
g_elp = jax.jit(jax.grad(_elp))
timeit("grad(e_lnpr+BO)", lambda: g_elp(s.pos))

def _e3(p):
    bo = reax.bond_order(p, s.H, s.types, img, nbrs, ffd)
    lp = reax.lone_pair(s.types, bo.delta, ffd)
    return _sum(reax.e_3body(p, s.H, s.types, img, nbrs, bo, lp, amask, ffd,
                        cap=caps["ang"], ks=caps["ks"], al=al))
g_e3 = jax.jit(jax.grad(_e3))
timeit("grad(e_3body+BO, cached)", lambda: g_e3(s.pos))

def _e4(p):
    bo = reax.bond_order(p, s.H, s.types, img, nbrs, ffd)
    return _sum(reax.e_4body(p, s.H, s.types, img, nbrs, bo, amask, s.gid, ffd,
                        cap=caps["tor"], ks=caps["ks"], tl=tl))
g_e4 = jax.jit(jax.grad(_e4))
timeit("grad(e_4body+BO, cached)", lambda: g_e4(s.pos))

def _ehb(p):
    bo = reax.bond_order(p, s.H, s.types, img, nbrs, ffd)
    return _sum(reax.e_hbond(p, s.H, s.types, img, nbrs, bo, amask, ffd,
                        cap=caps["hb"], kh=caps["kh"]))
g_ehb = jax.jit(jax.grad(_ehb))
timeit("grad(e_hbond+BO)", lambda: g_ehb(s.pos))

ctx = jax.jit(lambda p, q: reax.nb_ctx(p, q, s.H, s.types, img, nbrs,
                                       s.gid, amask, ffd))
timeit("nb_ctx", lambda: ctx(s.pos, s.q))
nbf = jax.jit(lambda p, q: reax.nonbond_tbl_energy_forces(
    reax.nb_ctx(p, q, s.H, s.types, img, nbrs, s.gid, amask, ffd),
    q, s.types, amask, ffd))
timeit("nonbond tbl e+f (incl ctx)", lambda: nbf(s.pos, s.q))

qeqf1 = jax.jit(lambda p, q, qs: qeq.solve(
    p, q, qs, s.H, s.types, img, nbrs, ffd, isqeq=1, nmax=cfg.NMAXQEq,
    tol=cfg.QEq_tol, closed_form=eng.closed_form))
timeit("QEq full CG (dense)", lambda: qeqf1(s.pos, s.q, s.qsfp), reps=3)

nbcf = jax.jit(lambda p, q: reax.nonbond_cf_energy_forces(
    reax.nb_ctx(p, None, s.H, s.types, img, nbrs, s.gid, amask, ffd),
    q, s.types, amask, ffd, with_virial=True, img=img))
timeit("nonbond cf e+f+w (incl ctx)", lambda: nbcf(s.pos, s.q))

hl = lists[2]
def _ehl(p):
    bo = reax.bond_order(p, s.H, s.types, img, nbrs, ffd)
    return reax.e_hbond_list(p, s.H, s.types, img, nbrs, bo, hl, ffd)
g_ehl = jax.jit(jax.grad(_ehl))
timeit("grad(e_hbond_list+BO)", lambda: g_ehl(s.pos))
