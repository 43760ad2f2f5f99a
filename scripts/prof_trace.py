"""jax.profiler trace of the production step; prints the top device ops.

    MC=3,3,3 python scripts/prof_trace.py      # on the GPU

Writes the trace under chiprun_out/jaxtrace.
"""
import os, sys, glob, gzip, json, collections, shutil
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
eng.run(3, log=None)

outdir = os.path.join("chiprun_out", "jaxtrace")
shutil.rmtree(outdir, ignore_errors=True)
with jax.profiler.trace(outdir):
    eng.run(5, log=None)

# parse the trace: sum the op durations on the GPU device planes
files = glob.glob(outdir + "/**/*.trace.json.gz", recursive=True)
print("trace files:", files, flush=True)
ev = []
for fp in files:
    with gzip.open(fp, "rt") as f:
        data = json.load(f)
    ev.extend(data.get("traceEvents", []))
pid_names = {e["pid"]: e["args"].get("name", "") for e in ev
             if e.get("ph") == "M" and e.get("name") == "process_name"
             and "args" in e}
# device planes are named "/device:GPU:<n> ..."; host threads are not
dev_pids = {p for p, nm in pid_names.items()
            if nm.lower().startswith("/device:gpu")}
print("device planes:", sorted(pid_names[p] for p in dev_pids))
agg = collections.Counter()
cnt = collections.Counter()
for e in ev:
    if e.get("ph") == "X" and e.get("pid") in dev_pids:
        agg[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
tot = sum(agg.values())
print(f"total device us: {tot} over 5 steps -> {tot/5/1000:.1f} ms/step")
for name, us in agg.most_common(45):
    print(f"{us/5/1000:9.2f} ms  x{cnt[name]//5:<4d} {name[:120]}")
