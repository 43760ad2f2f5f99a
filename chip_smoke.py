#!/usr/bin/env python
"""Smoke check of the main MD path on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --four     # four-card domain decomposition only

One process drives the card.  Inputs are generated from a fixed seed into
--out (default chiprun_out/chip_smoke).  Phases:

  1. device: JAX must report platform "gpu"; there is no CPU fallback
  2. dense regime through the CLI (rxmd_tpu.__main__.main): N=8,064,
     f32, full-CG QEq then extended Lagrangian, 200 steps each
  3. ELL regime through md.Engine: N=36,288, f32, extended Lagrangian
  4. plain f64 reference (tables, ELL QEq, per-step list enumeration,
     bonded forces by autodiff) against the f32 production evaluation on
     phase 2's final state; at 168 atoms the f64 reference on the card
     against the same evaluation on the CPU backend
  5. determinism: one production step run twice from the same state
  --four: the CLI's `processors 2 2 1` run on four cards against
     one-card md.Engine on device 0, N=36,288, f32, extended Lagrangian

Every line with numbers names the card and its power limit.  The last line
is one JSON object: {"ok": true, "device": {...}}.  Any failed check ends
the run with a non-zero exit and no JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

SEED = 0
CARD = "cpu (no card)"       # replaced by nvidia-smi's line on a GPU

# phase 4 tolerances, f32 production vs the f64 plain reference.  Measured
# on the CPU (tests/test_chip_smoke.py): at 168 atoms (ELL path) and 1,344
# atoms (dense path) charges differ by <= 4.0e-7 e (the production solve
# starts from the reference's charges, see reference_check), energy
# components by <= 3.5e-3 kcal/mol/atom (vdW: the closed-form kernel
# against the reference's r^2-interpolation table), forces by <= 1.2e-2 of
# the RMS force.  The energy and force bounds leave ~3x room above those;
# all three are below what TF32 operands (10-bit mantissa) in the dense
# QEq matvec and the one-hot parameter products give at the same sizes:
# 1.8e-3 e, >= 3.0e-2 kcal/mol/atom and >= 0.17 of the RMS force.
TOL_Q = 2e-5                 # max |dq| [e]
TOL_E = 1e-2                 # max |dE_component| / N [kcal/mol/atom]
TOL_F = 4e-2                 # max |dF| / rms(F_ref)

# phase 4 at 168 atoms: the same f64 evaluation on the card and on the CPU
# backend differs only in summation order.  f64 rounding (1e-16), carried
# through the CG iterations, reaches ~3e-9 e in q and ~1e-7 of the RMS
# force on an H100; any difference of physics would show at >= 1e-5.
TOL_F64 = 1e-6               # max of |dq|, |dE|/N and |dF|/rms(F)

# phase 2: total-energy drift over 200 f32 NVE steps from v=0.  The f64
# CPU check at 168 atoms stays under 1e-3 kcal/mol/atom; f32 sums and the
# extended Lagrangian's lagging charges add noise of the same order.
TOL_DRIFT = 5e-3             # max |TE(t) - TE(0)| [kcal/mol/atom]

# --four: sharded vs one-card energies, f32 (summation order differs).
TOL_SHARD_PREP = 2e-4        # after prepare() [kcal/mol/atom]
TOL_SHARD_RUN = 2e-3         # after the run: trajectories drift apart


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def say(phase, **numbers):
    body = " ".join(f"{k}={v}" for k, v in numbers.items())
    print(f"[{phase}] {CARD} | {body}", flush=True)


def card_line():
    """name, power.limit of every card, as nvidia-smi prints them (in a
    child process that does not use JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return [line.strip() for line in out]


# ----------------------------------------------------------------------------
def phase_device(count):
    """Phase 1: the GPUs JAX reports (no CPU fallback)."""
    import jax
    devs = jax.devices()
    plat = devs[0].platform
    check(plat == "gpu", f"JAX found no GPU (platform {plat!r})")
    check(len(devs) >= count, f"need {count} GPUs, JAX found {len(devs)}")
    return devs


class _Record:
    """Keep every engine the CLI builds, with its prepare() energies."""

    def __init__(self):
        self.engines = []

    @contextlib.contextmanager
    def patch(self):
        from rxmd_tpu import md
        from rxmd_tpu.parallel import engine as peng
        rec = self

        def recording(base):
            class Recorded(base):
                def __init__(self, *a, **k):
                    super().__init__(*a, **k)
                    rec.engines.append(self)

                def prepare(self):
                    comps = super().prepare()
                    self.prepared_comps = np.asarray(comps)
                    return comps
            return Recorded

        saved = md.Engine, peng.ShardedEngine
        md.Engine = recording(saved[0])
        peng.ShardedEngine = recording(saved[1])
        try:
            yield
        finally:
            md.Engine, peng.ShardedEngine = saved


def run_cli(argv, log_path):
    """rxmd_tpu.__main__.main in this process, its output captured into
    `log_path` (its lines carry no card name); returns (output, engine)."""
    from rxmd_tpu import __main__ as cli
    rec = _Record()
    buf = io.StringIO()
    with rec.patch(), contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as fh:
        fh.write(buf.getvalue())
    check(rc == 0, f"rxmd_tpu exited {rc} (output in {log_path})")
    check(len(rec.engines) == 1, "the CLI built no engine")
    return buf.getvalue(), rec.engines[0]


def _summary_value(text, name, col):
    m = re.search(rf"^\s*{re.escape(name)}\s+(.*)$", text, re.M)
    check(m is not None, f"summary has no {name!r} line")
    return float(m.group(1).split()[col])


def _te_series(text):
    return [(int(t[1]), float(t[2])) for t in
            (line.split() for line in text.splitlines())
            if t and t[0] == "MDstep:"]


def memory_line(eng):
    """compiled.memory_analysis() of the fused step block, and the
    device's peak bytes in use."""
    args = (eng.state, eng.force, eng.nbrs, eng.tlists, eng._pos_ref,
            eng._astr)
    prog = eng._mstep if eng._mstep is not None else eng._step
    ma = prog.lower(*args).compile().memory_analysis()
    mb = lambda b: f"{b / 2**20:.1f}"
    out = {}
    if ma is not None:
        out.update(step_args_MB=mb(ma.argument_size_in_bytes),
                   step_out_MB=mb(ma.output_size_in_bytes),
                   step_temp_MB=mb(ma.temp_size_in_bytes),
                   step_code_MB=mb(ma.generated_code_size_in_bytes))
    stats = eng.state.pos.devices().pop().memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        out["peak_bytes_in_use"] = stats["peak_bytes_in_use"]
    return out


def phase_cli(inputs, mc, isqeq, steps, pstep, outdir, expect_pair, phase,
              steady=50):
    """Phase 2: one CLI run, then `steady` more steps timed with the step
    programs compiled; returns (engine, output directory)."""
    datdir = os.path.join(outdir, f"DAT_q{isqeq}")
    text, eng = run_cli([
        "--rxmdin", inputs["rxmd.in"], "--ffield", inputs["ffield"],
        "--run_from_xyz", inputs["input.xyz"], "--mc", *map(str, mc),
        "--dtype", "float32", "--isQEq", str(isqeq), "--QEq_tol", "1e-7",
        "--ntime_step", str(steps), "--pstep", str(pstep),
        "--outDir", datdir], os.path.join(datdir, "cli.log"))
    m = re.search(r"pair path, QEq path:\s*(.*?); (.*)$", text, re.M)
    check(m is not None, "banner names no pair/QEq path")
    check(m.group(1) == expect_pair,
          f"pair path {m.group(1)!r}, expected {expect_pair!r}")
    rebuilds = int(_summary_value(text, "neighbor rebuild", 1))
    check(rebuilds >= 1, "no neighbor rebuild ran in the window")
    check(os.path.exists(os.path.join(datdir, "rxff.npz")),
          "checkpoint rxff.npz not written")
    for used, cap in re.findall(r"(\d+) /\s*(\d+) \(", text):
        check(int(used) <= int(cap), f"capacity overflow {used}/{cap}")
    te = _te_series(text)
    check(len(te) >= 2, "fewer than two MDstep lines")
    drift = max(abs(t - te[0][1]) for _, t in te)
    s = eng.state
    n = s.n
    ke = float((eng.hmas[s.types] * (s.vel * s.vel).sum(1)).sum())
    drift_end = abs((ke + float(eng.comps[0])) / n
                    - eng.prepared_comps[0] / n)
    check(max(drift, drift_end) < TOL_DRIFT,
          f"TE drift {max(drift, drift_end):.2e} >= {TOL_DRIFT:.0e}")
    rate = float(re.search(r"atom-steps/s:\s*(\S+)", text).group(1))
    # the CLI's window includes compiling the step programs; time a
    # window of compiled steps as well
    mem = memory_line(eng)
    wall = eng.run(steady, log=None)
    say(phase, natoms=n, isQEq=isqeq, steps=steps, pair_path=repr(m.group(1)),
        qeq_path=repr(m.group(2)), cli_atom_steps_per_s=f"{rate:.4e}",
        steady_atom_steps_per_s=f"{n * steady / wall:.4e}",
        steady_steps=steady,
        prepare_s=f"{_summary_value(text, 'first force (compile)', 0):.2f}",
        qeq_iters_at_prints=int(_summary_value(text, "QEq iterations", 0)),
        last_qeq_iters=int(eng.nqeq), rebuilds=rebuilds,
        max_abs_dTE_per_atom=f"{max(drift, drift_end):.3e}", **mem)
    return eng, datdir


def phase_ell(inputs, mc, steps, phase, list_chunk=None):
    """Phase 3: md.Engine on the O(N) ELL gather path (list_chunk: the
    row-chunk size of the list builds, RunConfig's default if None)."""
    import jax.numpy as jnp
    from rxmd_tpu import ffield, md, system
    from rxmd_tpu.config import RunConfig
    ff = ffield.parse_ffield(inputs["ffield"])
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type, mc=mc,
                              dtype=jnp.float32)
    cfg = RunConfig(mdmode=1, dt_fs=0.25, ntime_step=steps, isQEq=2,
                    QEq_tol=1e-7, pstep=steps, sstep=10**9, dtype="float32")
    if list_chunk is not None:
        cfg.list_chunk = list_chunk
    t0 = time.time()
    eng = md.Engine(ff, st, cfg, dtype=jnp.float32)
    eng.prepare()
    prep = time.time() - t0
    check(not eng.dense_direct, "ELL phase took the dense path")
    check(eng.grid is not None, "no cell-list neighbor build")
    check(0 < cfg.list_chunk < st.n and eng.caps["tor_row"] > 0,
          "list builds are not row-chunked")
    warm = 2 + eng.block_steps               # compiles both step programs
    eng.run(warm, log=None)
    before = eng.timers.ncalls.get("neighbor rebuild", 0)
    wall = eng.run(steps - warm, log=None)
    rebuilds = eng.timers.ncalls.get("neighbor rebuild", 0) - before
    check(rebuilds >= 1, "no neighbor rebuild inside the window")
    check(np.isfinite(float(eng.comps[0])), "non-finite energy")
    pair, qeq_path = eng.path_names()
    say(phase, natoms=st.n, isQEq=2, steps=steps, pair_path=repr(pair),
        qeq_path=repr(qeq_path), window_steps=steps - warm,
        atom_steps_per_s=f"{st.n * (steps - warm) / wall:.4e}",
        prepare_s=f"{prep:.2f}", last_qeq_iters=int(eng.nqeq),
        rebuilds=rebuilds, **memory_line(eng))
    return eng


def reference_eval(ff_path, state, device=None):
    """The plain f64 reference on `state`: interpolation tables, ELL QEq
    (converged to 1e-10), per-step list enumeration, bonded forces by
    autodiff, nonbond forces from the reference's derivative tables
    (autodiff of the r^2-lerp energy gives each table cell's secant
    slope, which at bonded distances is off by up to ~0.5 of the RMS
    force).  Returns (q, comps, forces) as NumPy arrays."""
    import jax
    from rxmd_tpu import ffield, md, qeq, reax
    from rxmd_tpu.config import RunConfig
    ctx = (jax.default_device(device) if device is not None
           else contextlib.nullcontext())
    with jax.enable_x64(True), ctx:
        ff = ffield.parse_ffield(ff_path)
        st = state.astype(np.float64)
        st = jax.tree.map(lambda a: jax.numpy.asarray(np.asarray(a)), st)
        cfg = RunConfig(dtype="float64", isQEq=1, qeq_dense_max=0,
                        term_cache=False, nonbond_closed_form=False)
        eng = md.Engine(ff, st, cfg, dtype=np.float64)

        @jax.jit
        def evaluate(s):
            nbrs = eng._build_nbrs(s.pos, s.H, s.types)
            res = qeq.solve(s.pos, s.q, s.qsfp, s.H, s.types, eng.img,
                            nbrs, eng.ffd, tol=1e-10, nmax=2000,
                            closed_form=False, dense_max=0)
            comps, f = reax.energy_and_forces(
                s.pos, res.q, s.H, s.types, s.gid, eng.img, nbrs, eng.ffd,
                caps=eng.caps, fast_nonbond=True, closed_form=False)
            return res.q, comps, f

        return tuple(np.asarray(x) for x in evaluate(eng.state))


def production_eval(ff_path, state):
    """The f32 production evaluation (the engine's own path choice) on
    `state`: full-CG QEq to 1e-7 and the step's energies and forces."""
    import jax.numpy as jnp
    from rxmd_tpu import ffield, md
    from rxmd_tpu.config import RunConfig
    ff = ffield.parse_ffield(ff_path)
    cfg = RunConfig(dtype="float32", isQEq=1, QEq_tol=1e-7)
    eng = md.Engine(ff, state.astype(jnp.float32), cfg, dtype=jnp.float32)
    comps = eng.prepare()
    return (np.asarray(eng.state.q, np.float64), np.asarray(comps, np.float64),
            np.asarray(eng.force, np.float64), eng)


def reference_check(ff_path, state):
    """(max |dq|, max |dE_k|/N, max |dF|/rms(F_ref), production engine) of
    the f32 production evaluation against the f64 plain reference on
    `state`.  The production QEq starts from the reference's converged
    charges, so dq says where the production solver's minimum lies, not
    where its energy-change test happened to stop (from a cold start, f32
    charges stop up to ~1e-3 e short of the minimum)."""
    import dataclasses
    import jax.numpy as jnp
    ref = reference_eval(ff_path, state)
    q = jnp.asarray(ref[0], jnp.float32)
    prod = production_eval(ff_path, dataclasses.replace(state, q=q, qsfp=q))
    return (*compare(prod, ref, state.n), prod[3])


def compare(prod, ref, n):
    """(max |dq|, max |dE_k|/N, max |dF|/rms(F_ref))."""
    q1, c1, f1 = prod[:3]
    q0, c0, f0 = ref[:3]
    rms = float(np.sqrt((f0 ** 2).mean()))
    return (float(np.abs(q1 - q0).max()),
            float(np.abs(c1 - c0).max() / n),
            float(np.abs(f1 - f0).max() / rms))


def phase_reference(ff_path, ckpt, phase, small_state=None):
    """Phase 4."""
    import jax
    from rxmd_tpu.io import checkpoint
    st = checkpoint.load(ckpt, np.float32)
    dq, de, df, prod = reference_check(ff_path, st)
    say(phase, natoms=st.n, production=repr(" / ".join(prod.path_names())),
        max_dq=f"{dq:.3e}", max_dE_per_atom=f"{de:.3e}",
        max_dF_over_rmsF=f"{df:.3e}", tol=f"{TOL_Q:.0e}/{TOL_E:.0e}/"
        f"{TOL_F:.0e}")
    check(dq < TOL_Q, f"charges differ by {dq:.2e} >= {TOL_Q:.0e}")
    check(de < TOL_E, f"energies differ by {de:.2e} >= {TOL_E:.0e}")
    check(df < TOL_F, f"forces differ by {df:.2e} >= {TOL_F:.0e}")
    if small_state is not None:
        cpu = jax.devices("cpu")[0]
        on_dev = reference_eval(ff_path, small_state)
        on_cpu = reference_eval(ff_path, small_state, device=cpu)
        dq, de, df = compare(on_dev, on_cpu, small_state.n)
        say(phase + " f64 card vs cpu", natoms=small_state.n,
            max_dq=f"{dq:.3e}", max_dE_per_atom=f"{de:.3e}",
            max_dF_over_rmsF=f"{df:.3e}", tol=f"{TOL_F64:.0e}")
        check(max(dq, de, df) < TOL_F64, "f64 card and cpu results differ "
              f"beyond summation order: {dq:.1e} {de:.1e} {df:.1e}")


def phase_determinism(eng, phase):
    """Phase 5: one production step twice from the same state."""
    args = (eng.state, eng.force, eng.nbrs, eng.tlists, eng._pos_ref,
            eng._astr)
    a = eng._step(*args)
    b = eng._step(*args)
    df = float(np.abs(np.asarray(a[1]) - np.asarray(b[1])).max())
    dq = float(np.abs(np.asarray(a[0].q) - np.asarray(b[0].q)).max())
    rms = float(np.sqrt((np.asarray(a[1]) ** 2).mean()))
    say(phase, natoms=eng.state.n, max_dF=f"{df:.3e}", rms_F=f"{rms:.3e}",
        max_dq=f"{dq:.3e}", bit_identical=df == 0.0 and dq == 0.0)
    return df, dq


def phase_four(inputs, mc, steps, outdir, phase):
    """--four: the CLI's processors 2 2 1 on four devices against one-card
    md.Engine on device 0."""
    import jax
    import jax.numpy as jnp
    from rxmd_tpu import ffield, md, system
    from rxmd_tpu.config import RunConfig
    _, sh = run_cli([
        "--rxmdin", inputs["rxmd.in"], "--ffield", inputs["ffield"],
        "--run_from_xyz", inputs["input.xyz"], "--mc", *map(str, mc),
        "--dtype", "float32", "--isQEq", "2", "--ntime_step", str(steps),
        "--pstep", str(steps), "--vprocs", "2", "2", "1",
        "--outDir", os.path.join(outdir, "DAT_four")],
        os.path.join(outdir, "DAT_four", "cli.log"))
    check(sh.ndev == 4, f"sharded engine on {sh.ndev} devices")
    ff = ffield.parse_ffield(inputs["ffield"])
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type, mc=mc,
                              dtype=jnp.float32)
    cfg = RunConfig(mdmode=1, dt_fs=0.25, isQEq=2, QEq_tol=1e-7,
                    pstep=steps, sstep=10**9, dtype="float32")
    with jax.default_device(jax.devices()[0]):
        one = md.Engine(ff, st, cfg, dtype=jnp.float32)
        c1 = np.asarray(one.prepare())
        one.run(steps, log=None)
        c1_end = np.asarray(one.comps)
    n = st.n
    d_prep = float(np.abs(sh.prepared_comps - c1).max() / n)
    d_end = float(np.abs(np.asarray(sh.comps) - c1_end).max() / n)
    say(phase, natoms=n, devices=sh.ndev, mesh=sh.mesh_shape, steps=steps,
        max_dE_prepare_per_atom=f"{d_prep:.3e}",
        max_dE_end_per_atom=f"{d_end:.3e}",
        tol=f"{TOL_SHARD_PREP:.0e}/{TOL_SHARD_RUN:.0e}")
    check(d_prep < TOL_SHARD_PREP,
          f"prepare energies differ by {d_prep:.2e}")
    check(d_end < TOL_SHARD_RUN, f"step-{steps} energies differ by {d_end:.2e}")


# ----------------------------------------------------------------------------
def main(argv=None):
    global CARD
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card path and its comparison")
    p.add_argument("--out", default=os.path.join("chiprun_out", "chip_smoke"))
    args = p.parse_args(argv)
    count = 4 if args.four else 1
    devs = phase_device(count)                   # before any repo import
    cards = card_line()
    print("\n".join(cards), flush=True)
    CARD = "; ".join(cards)
    say("phase 1 device", platform=devs[0].platform,
        kind=repr(devs[0].device_kind), count=len(devs))

    from rxmd_tpu.tools import geninputs
    inputs = geninputs.write_inputs(os.path.join(args.out, "inputs"), SEED)
    t0 = time.time()
    if args.four:
        phase_four(inputs, (6, 6, 6), 40, args.out, "four cards")
    else:
        for isqeq in (1, 2):
            eng, _ = phase_cli(inputs, (4, 4, 3), isqeq, 200, 50, args.out,
                               "dense minimum-image",
                               f"phase 2 CLI isQEq={isqeq}")
        phase_ell(inputs, (6, 6, 6), 120, "phase 3 ELL")
        _, small = geninputs.load((1, 1, 1), np.float32)
        phase_reference(inputs["ffield"],
                        os.path.join(args.out, "DAT_q1", "rxff.npz"),
                        "phase 4 reference", small_state=small)
        phase_determinism(eng, "phase 5 determinism")
    say("done", wall_s=f"{time.time() - t0:.1f}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
