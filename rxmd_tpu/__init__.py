"""rxmd-tpu: reactive molecular dynamics (ReaxFF/QEq/PQEq) in JAX."""
import os as _os

import jax as _jax

# MD coordinate transforms (frac <-> real) and the dense QEq matvec are
# jnp matmuls.  On a GPU an f32 matmul may otherwise run in TF32, which
# keeps about 3 significant digits: positions would round to ~0.01 A and
# the QEq CG would stop converging.  The heavy compute here is elementwise
# work and gathers, which the setting does not touch.
_jax.config.update("jax_default_matmul_precision", "highest")


def _arch_tag():
    """CPU-microarchitecture tag for the default cache path: XLA:CPU AOT
    executables embed machine features and abort (SIGILL) when loaded on
    a host with different ones — cache entries must never cross hosts."""
    try:
        import hashlib
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    return hashlib.md5(line.encode()).hexdigest()[:8]
    except OSError:
        pass
    import platform
    return platform.machine()


def default_cache_dir():
    """Persistent compile cache used when JAX_COMPILATION_CACHE_DIR is not
    set: <checkout>/.jax_cache/<cpu features>."""
    root = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                         _os.pardir, ".jax_cache")
    return _os.path.join(_os.path.abspath(root), _arch_tag())


# Persistent compilation cache: the MD step is one large XLA program whose
# first compile takes a while at production sizes.  JAX reads
# JAX_COMPILATION_CACHE_DIR itself; only without it is a directory set here.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", default_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
_jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
