"""Runtime rules the program sets for itself: float64 means float64, and
the compile cache lives where JAX_COMPILATION_CACHE_DIR says."""
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_ENABLE_X64", "JAX_COMPILATION_CACHE_DIR",
                        "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def _python(code, **env):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=ROOT, env=_env(**env))


def _cli(inputs, outdir, dtype):
    return subprocess.run(
        [sys.executable, "-m", "rxmd_tpu", "--rxmdin", inputs["rxmd.in"],
         "--ffield", inputs["ffield"], "--run_from_xyz", inputs["input.xyz"],
         "--dtype", dtype, "--ntime_step", "1", "--pstep", "1",
         "--outDir", str(outdir)],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=_env())


def test_cli_float64_computes_in_float64(inputs, tmp_path):
    r = _cli(inputs, tmp_path, "float64")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dtype float64" in r.stdout
    ck = np.load(tmp_path / "rxff.npz")
    assert ck["pos"].dtype == np.float64 and ck["q"].dtype == np.float64


def test_cli_float32_leaves_x64_off(inputs, tmp_path):
    r = _cli(inputs, tmp_path, "float32")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "dtype float32" in r.stdout
    assert np.load(tmp_path / "rxff.npz")["pos"].dtype == np.float32


def test_float64_without_x64_is_an_error():
    r = _python("from rxmd_tpu import md; md.require_dtype('float64')")
    assert r.returncode != 0
    assert "jax_enable_x64 is off" in r.stderr
    ok = _python("from rxmd_tpu import md; md.require_dtype('float32')")
    assert ok.returncode == 0, ok.stderr


def test_compile_cache_follows_env(tmp_path):
    code = ("import jax, rxmd_tpu; "
            "print(jax.config.jax_compilation_cache_dir)")
    r = _python(code, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)


def test_compile_cache_default_in_checkout():
    code = ("import jax, rxmd_tpu; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(rxmd_tpu.default_cache_dir())")
    r = _python(code)
    assert r.returncode == 0, r.stderr
    got, want = r.stdout.split()
    assert got == want
    assert got.startswith(os.path.join(ROOT, ".jax_cache") + os.sep)
