#!/usr/bin/env python
"""Benchmark: MD throughput of the generated C3H6N6O6 crystal on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.

The inputs come from rxmd_tpu.tools.geninputs (seed 0), replicated
BENCH_MC (default 4,4,3: N=8,064).  The headline `value` is measured with
full QEq CG (isQEq=1, tol 1e-7), the reference's own configuration;
the extended-Lagrangian mode (isQEq=2, 1 CG iteration/step — the
reference's scaling deck, conf/bg-bench/rxmd.in) is reported alongside as
`exl_atom_steps_per_sec`.  `vs_baseline` divides by the reference's
single-rank CPU rate on its RDX deck (BASELINE.md: 5.6e3 atom-steps/s), a
different system of the same size class.

Refuses to run without a GPU.  One process drives the card.
"""
import json
import os
import subprocess
import sys
import time


def run_mode(ff, st, isqeq, nsteps):
    import jax.numpy as jnp
    from rxmd_tpu import md
    from rxmd_tpu.config import RunConfig

    cfg = RunConfig(mdmode=1, dt_fs=0.25, ntime_step=nsteps, pstep=10**9,
                    sstep=10**9, isQEq=isqeq, QEq_tol=1e-7, dtype="float32")
    t0 = time.time()
    eng = md.Engine(ff, st, cfg, dtype=jnp.float32)
    eng.prepare()
    prep = time.time() - t0
    # warmup: cover the single-step AND the fused-block step programs
    eng.run(2 + eng.block_steps, log=None)
    t0 = time.time()
    eng.run(nsteps, log=None)
    wall = time.time() - t0
    return st.n * nsteps / wall, prep


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found platform {dev.platform!r}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    import jax.numpy as jnp
    from rxmd_tpu.tools import geninputs

    mc = tuple(int(x) for x in os.environ.get("BENCH_MC", "4,4,3").split(","))
    nsteps = int(os.environ.get("BENCH_STEPS", "50"))
    ff, st = geninputs.load(mc, jnp.float32)

    def note(msg, t0=[time.time()]):
        print(f"[bench +{time.time() - t0[0]:.0f}s] {msg}", file=sys.stderr,
              flush=True)

    note(f"{card}: N={st.n} atoms (mc={mc}), {nsteps} timed steps per mode")
    aps1, prep1 = run_mode(ff, st, 1, nsteps)
    note(f"isQEq=1: {aps1:.4e} atom-steps/s  (prepare {prep1:.1f}s)")
    aps2, prep2 = run_mode(ff, st, 2, nsteps)
    note(f"isQEq=2: {aps2:.4e} atom-steps/s  (prepare {prep2:.1f}s)")

    baseline = 5.6e3  # reference atom-steps/s, isQEq=1 (BASELINE.md)
    print(json.dumps({
        "metric": "atom_steps_per_sec_per_gpu",
        "value": aps1,
        "unit": "atom*step/s",
        "vs_baseline": aps1 / baseline,
        "exl_atom_steps_per_sec": aps2,
        "natoms": st.n,
        "prepare_sec": max(prep1, prep2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
