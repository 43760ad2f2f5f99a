"""Full-step wall time vs system size (run it on the GPU).

    MCS="2,2,2;4,4,3;6,6,6" ISQ=2 python scripts/prof_scaling.py
"""
import os, sys, time
import jax
import jax.numpy as jnp
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from rxmd_tpu import md
from rxmd_tpu.config import RunConfig
from rxmd_tpu.tools import geninputs

dtype = jnp.float32
mcs = os.environ.get("MCS", "2,2,2;3,3,3;4,4,3;4,4,4;5,5,4;6,5,5;6,6,6").split(";")
isq = int(os.environ.get("ISQ", "2"))
for mcstr in mcs:
    mc = tuple(int(x) for x in mcstr.split(","))
    try:
        ff, st = geninputs.load(mc, dtype)
        cfg = RunConfig(mdmode=1, dt_fs=0.25, ntime_step=20, pstep=10**9,
                        sstep=10**9, isQEq=isq, QEq_tol=1e-7,
                        dtype="float32")
        t0 = time.time()
        eng = md.Engine(ff, st, cfg, dtype=dtype)
        eng.prepare()
        eng.run(2 + eng.block_steps, log=None)
        t_setup = time.time() - t0
        t0 = time.time()
        nst = int(os.environ.get("NST", "40"))
        eng.run(nst, log=None)
        w = time.time() - t0
        print(f"mc={mc} N={st.n:7d}: {w/nst*1000:8.1f} ms/step "
              f"{st.n*nst/w:10.0f} atom-steps/s  (setup {t_setup:.0f}s) "
              f"dense={eng.dense_direct}", flush=True)
    except Exception as e:
        print(f"mc={mc}: FAILED {type(e).__name__}: {e}", flush=True)
