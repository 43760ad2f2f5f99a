"""Multi-device domain-decomposition tests on a virtual CPU mesh.

The 2-device (2,1,1) mesh is the analog of the reference's 2-rank
domain-decomposition check (examples/2-reaxff-dc: vprocs `2 1 1`,
examples/2-reaxff-dc/Makefile:5): full-physics match against the
single-device engine plus one conserving MD step, exercising inter-device
halo exchange, distributed QEq, grad-through-ppermute force copy-back, and
migration between two real shards.

The 8-device (2,2,2) test runs the identical step graph on tiny shapes
(reduced cutoffs — the subdomains of a single 168-atom cell cannot hold the
full 10 A taper skin): it validates that all three mesh axes compile and
execute, conserve the atom count, and stay finite in float32.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from rxmd_tpu import ffield, system, md
from rxmd_tpu.config import RunConfig
from rxmd_tpu.parallel.engine import ShardedEngine, factor_mesh


def test_factor_mesh():
    assert factor_mesh(8) == (2, 2, 2)
    assert factor_mesh(4) == (2, 2, 1)
    assert factor_mesh(1) == (1, 1, 1)


@pytest.mark.slow
def test_mesh2_dc_matches_golden_and_conserves(inputs):
    """2-device domain decomposition, exact physics (ref: examples/2-reaxff-dc):
    step-0 energies match the single-device engine."""
    ff = ffield.parse_ffield(inputs["ffield"])
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type,
                              mc=(2, 1, 1))
    cfg = RunConfig(mdmode=1, dt_fs=0.25, isQEq=1, QEq_tol=1e-10,
                    qeq_dense_max=0)
    ref = np.asarray(md.Engine(ff, st, cfg).prepare()) / st.n
    eng = ShardedEngine(ff, st, cfg, mesh_shape=(2, 1, 1),
                        devices=jax.devices()[:2])
    comps = eng.prepare()
    c = np.asarray(comps) / st.n
    assert abs(c[0] - ref[0]) < 2e-6           # total PE per atom
    assert abs(c[1] - ref[1]) < 2e-6           # Ebond component
    pe0 = c[0]
    eng.run(1)
    assert eng.n_atoms == st.n                 # no atoms lost
    te = (float(eng.comps[0]) + float(eng.ke)) / st.n
    assert abs(te - pe0) < 5e-4                # energy conserved over the step


def test_mesh8_tiny_step_conserves_and_finite(inputs):
    """All three mesh axes on 8 devices, tiny shapes (compile/exec gate)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    ff = ffield.parse_ffield(inputs["ffield"])
    st = system.from_cellfile(inputs["input.xyz"], ff.name_to_type,
                              dtype=jnp.float32)
    cfg = RunConfig(mdmode=1, dt_fs=0.25, isQEq=2, qstep=1, dtype="float32",
                    nbr_skin=0.1)   # the tiny 2x2x2 box barely fits the skin
    eng = ShardedEngine(ff, st, cfg, mesh_shape=(2, 2, 2),
                        devices=jax.devices()[:8],
                        rctap=5.0, skin_layers=1.0)
    eng.force = jnp.zeros((eng.sstate.frac.shape[0], 3), eng.dtype)
    eng.run(1)
    assert eng.n_atoms == st.n
    assert np.isfinite(float(eng.comps[0]))
    assert np.isfinite(float(eng.ke))
    assert bool(jnp.isfinite(eng.force).all())
