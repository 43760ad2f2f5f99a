"""chip_smoke.py on the CPU: it refuses to run without a GPU, and each of
its phase functions runs and checks at small size (168 atoms; 672 where a
phase needs a cell grid or four domains)."""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ELL = "ELL gather (closed form)"


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_exits_nonzero_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py", "--out",
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=300, cwd=ROOT, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "JAX found no GPU" in r.stderr


@pytest.fixture(scope="module")
def cli_runs(cs, inputs, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("smoke"))
    return {q: cs.phase_cli(inputs, (1, 1, 1), q, 200, 50, out, ELL,
                            f"phase 2 isQEq={q}") for q in (1, 2)}


@pytest.mark.parametrize("isqeq", [1, 2])
def test_phase_cli(cli_runs, isqeq):
    eng, datdir = cli_runs[isqeq]
    assert eng.state.n == 168 and eng.cfg.isQEq == isqeq
    assert int(eng.state.step) == 200 + 50     # CLI run + steady window
    assert os.path.exists(os.path.join(datdir, "rxff.npz"))


def test_phase_cli_checks_the_path(cs, inputs, tmp_path):
    with pytest.raises(cs.SmokeFailure, match="pair path"):
        cs.phase_cli(inputs, (1, 1, 1), 1, 1, 1, str(tmp_path),
                     "dense minimum-image", "phase 2")


def test_phase_ell(cs, inputs):
    # 672 atoms: enough for the cell grid; chunk 256 < N chunks the builds
    eng = cs.phase_ell(inputs, (1, 2, 2), 45, "phase 3", list_chunk=256)
    assert eng.state.n == 672 and not eng.dense_direct


def test_phase_reference(cs, inputs, cli_runs):
    from rxmd_tpu.tools import geninputs
    _, small = geninputs.load((1, 1, 1), np.float32)
    ckpt = os.path.join(cli_runs[1][1], "rxff.npz")
    cs.phase_reference(inputs["ffield"], ckpt, "phase 4", small_state=small)


def _tf32(x):
    """Round float32 to TF32's 10-bit mantissa (round to nearest)."""
    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        return x
    b = jax.lax.bitcast_convert_type(x, jnp.uint32)
    b = (b + jnp.uint32(0x1000)) & jnp.uint32(0xFFFFE000)
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def test_tf32_operands_fail_phase4_tolerances(cs, inputs, cli_runs,
                                              monkeypatch):
    """A GPU matmul in TF32 would break the phase 4 comparison: rounding
    the operands of the dense QEq matvec and of the one-hot parameter
    products to a 10-bit mantissa exceeds every tolerance."""
    from rxmd_tpu import qeq, reax
    from rxmd_tpu.io import checkpoint
    st = checkpoint.load(os.path.join(cli_runs[1][1], "rxff.npz"),
                         np.float32)
    dense_prm = reax._type_prm_dense

    def ctx_prm(ctx, types, ffd):
        prow = _tf32(ffd.cf_pair[types])
        return jnp.einsum("nkc,ncp->nkp", _tf32(reax.ctx_tjoh(ctx)), prow,
                          preferred_element_type=prow.dtype)

    monkeypatch.setattr(qeq, "dense_matvec",
                        lambda A, x: _tf32(A) @ _tf32(x))
    monkeypatch.setattr(reax, "ctx_prm", ctx_prm)
    monkeypatch.setattr(qeq, "ctx_prm", ctx_prm)
    monkeypatch.setattr(reax, "_type_prm_dense",
                        lambda types, P: dense_prm(types, _tf32(P)))
    # _tf32 leaves the f64 reference untouched
    dq, de, df, _ = cs.reference_check(inputs["ffield"], st)
    assert dq > cs.TOL_Q and de > cs.TOL_E and df > cs.TOL_F, (dq, de, df)


def test_phase_determinism(cs, cli_runs):
    df, dq = cs.phase_determinism(cli_runs[2][0], "phase 5")
    assert df == 0.0 and dq == 0.0        # the CPU sums in a fixed order


def test_phase_four(cs, inputs, tmp_path):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    # 2x2x1 cells: every domain of the 2x2x1 mesh holds the full ghost skin
    cs.phase_four(inputs, (2, 2, 1), 10, str(tmp_path), "four devices")
