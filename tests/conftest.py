"""Test configuration: run on CPU with 8 virtual devices and f64 enabled,
on inputs generated once per session from a fixed seed.

The multi-device tests exercise the same shard_map code paths that run on a
multi-GPU mesh (the JAX analog of the reference's `nompi` serial backend is
a 1-device mesh — same code path by construction, ref: nompi.f90).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# the package sets the persistent compile cache (JAX_COMPILATION_CACHE_DIR
# when set, else <checkout>/.jax_cache): repeat suite runs compile less
import rxmd_tpu  # noqa: E402,F401

SEED = 0          # the seed chip_smoke.py and bench.py use too


@pytest.fixture(scope="session")
def inputs(tmp_path_factory):
    """{name: path} of the generated ffield, ffield.lg, pqeq1.par,
    input.xyz and rxmd.in (rxmd_tpu.tools.geninputs, seed SEED)."""
    from rxmd_tpu.tools import geninputs
    return geninputs.write_inputs(str(tmp_path_factory.mktemp("inputs")),
                                  SEED)


@pytest.fixture(scope="session")
def reference_dir():
    """Root of a USCCACS/RXMD reference tree (ffield, conf/, examples/),
    needed only by the golden-digit tests against the reference's RDX
    trace."""
    path = os.environ.get("RXMD_REFERENCE_DIR")
    if not path:
        pytest.skip("golden digits of the reference's RDX trace need its "
                    "input files: set RXMD_REFERENCE_DIR to a reference "
                    "tree")
    return path
