"""Dump the compiled HLO of the production step and print named ops.

    MC=3,3,3 python scripts/prof_hlo.py [op names...]

Writes chiprun_out/step_hlo.txt.
"""
import os, sys, re
import jax
import jax.numpy as jnp
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from rxmd_tpu import md
from rxmd_tpu.config import RunConfig
from rxmd_tpu.tools import geninputs

dtype = jnp.float32
mc = tuple(int(x) for x in os.environ.get("MC", "3,3,3").split(","))
ff, st = geninputs.load(mc, dtype)
cfg = RunConfig(mdmode=1, dt_fs=0.25, ntime_step=20, pstep=10**9,
                sstep=10**9, isQEq=2, QEq_tol=1e-7, dtype="float32")
eng = md.Engine(ff, st, cfg, dtype=dtype)
eng.prepare()
args = (eng.state, eng.force, eng.nbrs, eng.tlists, eng._pos_ref, eng._astr)
txt = eng._step.lower(*args).compile().as_text()
os.makedirs("chiprun_out", exist_ok=True)
with open(os.path.join("chiprun_out", "step_hlo.txt"), "w") as fh:
    fh.write(txt)
print("bytes:", len(txt))
want = set(sys.argv[1:]) or {"fusion.55", "fusion.73", "fusion.74",
                             "fusion.54", "fusion.50", "fusion.46",
                             "fusion.53", "fusion.48", "fusion.52",
                             "fusion.1", "fusion.49", "slice.824",
                             "sort.1"}
# print the definition line of each wanted op and its computation body head
lines = txt.splitlines()
for i, ln in enumerate(lines):
    m = re.match(r"\s*%?([\w.\-]+) = .*", ln)
    if m and m.group(1) in want:
        print("=" * 100)
        print(ln.strip()[:700])
