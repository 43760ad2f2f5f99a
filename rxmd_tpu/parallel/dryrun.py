"""Multi-chip dry run: one full sharded MD step on an n-device mesh.

Used by __graft_entry__.dryrun_multichip: run with N virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu) it
checks that the full MD step (spatial domain decomposition + halo exchange
+ QEq psum + grad-through-ppermute forces + migration) compiles and
executes without N physical devices.

The run is full physics on the generated cell replicated 2x2x2 (1,344
atoms), and its energies are checked against the single-device md.Engine
on the same configuration.  Exact-physics multi-device validation at f64
lives in tests/test_parallel.py and tests/test_sharded_product.py (the
analog of the reference's examples/2-reaxff-dc check).
"""
import time

import numpy as np


def run(n_devices: int) -> None:
    t0 = time.time()
    import jax
    if len(jax.devices()) < n_devices:
        raise RuntimeError(
            f"need {n_devices} devices, have {len(jax.devices())} "
            "(set XLA_FLAGS=--xla_force_host_platform_device_count=N)")
    import jax.numpy as jnp
    from rxmd_tpu import md
    from rxmd_tpu.config import RunConfig
    from rxmd_tpu.parallel.engine import ShardedEngine, factor_mesh
    from rxmd_tpu.tools import geninputs

    mesh_shape = factor_mesh(n_devices)
    # FULL physics: mc=(2,2,2) so every local box exceeds the complete
    # ghost skin (taper rctap=10 A + 3-layer bonded dependency chain) on a
    # 2x2x2 mesh — the same configuration the value-parity test drives
    # (tests/test_sharded_product.py::test_2x2x2_full_physics...); ref
    # transitive-corner forwarding comm.F90:282-287
    ff, st = geninputs.load((2, 2, 2), jnp.float32)
    # extended-Lagrangian charges (isQEq=2): one CG iteration per step —
    # the reference's scaling configuration (conf/bg-bench/rxmd.in)
    cfg = RunConfig(mdmode=1, dt_fs=0.25, isQEq=2, qstep=1, dtype="float32")
    eng = ShardedEngine(ff, st, cfg, mesh_shape=mesh_shape,
                        devices=jax.devices()[:n_devices])
    assert eng.skin > 10.0, eng.skin      # full physics, not a reduced deck
    print(f"[dryrun +{time.time()-t0:.0f}s] engine built: mesh={mesh_shape} "
          f"atoms={st.n} ncap={eng.ncap} mext={eng.mext} "
          f"skin={eng.skin:.1f}", flush=True)
    # prepare = the cold-start full CG charge solve + first force
    # (ref: main.F90:27-32), then one full MD step — charges are
    # converged, so the PE value check below is meaningful
    eng.prepare()
    print(f"[dryrun +{time.time()-t0:.0f}s] prepared: "
          f"PE/atom={float(eng.comps[0])/st.n:.4f}", flush=True)
    eng.run(1)
    pe = float(eng.comps[0]) / st.n
    ke = float(eng.ke) / st.n
    n_after = eng.n_atoms
    print(f"[dryrun +{time.time()-t0:.0f}s] step done: PE/atom={pe:.4f} "
          f"KE/atom={ke:.3e} nqeq={int(eng.nqeq)} atoms={n_after}",
          flush=True)
    assert np.isfinite(pe), "non-finite energy"
    assert np.isfinite(ke), "non-finite kinetic energy"
    assert n_after == st.n, f"atom count changed: {n_after} != {st.n}"
    # VALUE check, not just finiteness: the same configuration on one
    # device.  f32 with another summation order: per-atom energies agree
    # to ~1e-4 kcal/mol (bound 1e-3)
    one = md.Engine(ff, st, cfg, dtype=jnp.float32)
    one.prepare()
    one.run(1, log=None)
    pe1 = float(one.comps[0]) / st.n
    print(f"[dryrun +{time.time()-t0:.0f}s] one device: PE/atom={pe1:.4f}",
          flush=True)
    assert abs(pe - pe1) < 1e-3, (pe, pe1)
