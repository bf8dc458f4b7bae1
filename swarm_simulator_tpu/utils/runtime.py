"""Process set-up shared by the entry points (CLI, bench, chip smoke
test): the persistent compilation cache and the accelerator check."""
from __future__ import annotations

import os
from pathlib import Path

#: the repository checkout this package runs from
CHECKOUT = Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.

    JAX reads JAX_COMPILATION_CACHE_DIR itself; when it is set, no
    directory is set here.  Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache`` (listed in .gitignore): the directory is
    part of the cache key, so a path that moved between runs would
    never hit."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = str(CHECKOUT / ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def require_gpu():
    """The first JAX device, which must be a GPU.  Measurement entry
    points call this so that a run without the card fails instead of
    reporting host numbers under a device's name."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this entry point measures the GPU "
            "and does not run on other backends")
    return dev
