"""On-disk cache locations (compile cache + fidelity references).

Both live inside the checkout (``.cache/``, listed in .gitignore) unless
the environment names another place. A fixed path matters for the
compile cache: the directory is part of what makes a later run find its
entries.
"""

from __future__ import annotations

import os

from .. import CHECKOUT

_LOCAL = os.path.join(CHECKOUT, ".cache")


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <checkout>/.cache/jax."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_LOCAL, "jax"))


def ref_cache_dir() -> str:
    """Converged fidelity-reference dir (override: DRTS_FID_REF_DIR)."""
    return (os.environ.get("DRTS_FID_REF_DIR")
            or os.path.join(_LOCAL, "fidelity_refs"))


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compile cache at compile_cache_dir(): the
    full-frame programs take minutes to compile and are identical from
    run to run."""
    import jax

    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
