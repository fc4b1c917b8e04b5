"""Device and compile-cache helpers for the GPU entry points.

``chip_smoke.py``, ``bench.py`` and the pipeline CLI commands call these
before their first compile.
"""

from __future__ import annotations

import os
from pathlib import Path

# <checkout>/.jax_cache: a fixed path, so that the cache key (which holds
# the path) is the same from one run to the next. Listed in .gitignore.
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def require_gpu():
    """Return ``jax.devices()`` if JAX's devices are GPUs; raise otherwise.

    Measurement paths fail on a CPU-only process instead of timing the
    CPU backend under a device's name.
    """
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's devices are {devices[0].platform!r} "
            f"({devices[0].device_kind})"
        )
    return devices


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as it is (JAX reads
    it itself, and nothing is set here). Otherwise the cache lives in
    :data:`DEFAULT_CACHE_DIR`.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
