"""Persistent XLA compilation cache setup.

One helper so the CLI, the examples, the benchmark scripts and
chip_smoke.py all share one cache location: the directory named by
JAX_COMPILATION_CACHE_DIR when it is set (JAX reads the variable itself),
otherwise the fixed <repo>/.jax_cache/<backend>. The path is part of what
makes a cache hit, so it is never built from a temporary name, a pid or
the time.
"""

from __future__ import annotations

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_persistent_cache(root: str | None = None) -> str | None:
    """Turn on JAX's persistent compilation cache. Safe to call multiple
    times; returns the cache directory, or None if the config rejected it.

    With JAX_COMPILATION_CACHE_DIR set, no directory is set here and that
    directory is returned. Otherwise the cache lives at
    <root or <repo>/.jax_cache>/<backend>."""
    import jax
    try:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
        env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
        if env:
            return env
        path = os.path.join(root or os.path.join(_REPO, ".jax_cache"),
                            jax.default_backend())
        jax.config.update("jax_compilation_cache_dir", path)
        return path
    except (AttributeError, ValueError, RuntimeError) as e:
        # config rejected (old jax / unknown option): visible, not silent
        import warnings
        warnings.warn(f"persistent compile cache disabled: {e!r}")
        return None
