"""Persistent XLA-executable cache.

The sampler compiles one chunk-agnostic executable per (model shape,
NSConfig) and reuses it for every chunk and every seed.  Across
*processes* that executable is recompiled from scratch unless JAX's
persistent compilation cache is enabled, which serializes the compiled
executable to disk keyed on the HLO, the jaxlib version and the backend,
so a repeat fit (a resumed run, a re-plot, a scan over seeds, CI) skips
straight to execution.

This module is the one place that decides where the cache lives, so the
CLI (``[run] compile_cache``), ``bench.py``, ``chip_smoke.py`` and library
users resolve it identically.

The reference has no equivalent (its PolyChord/MultiNest solvers are
Fortran binaries with no JIT; its jaxns path recompiles every run,
/root/reference/mcalf/cli.py:233-280).
"""

from __future__ import annotations

import os
from typing import Optional

_OFF = {"", "0", "off", "none", "false"}

#: Where the cache lives when nothing places it: a FIXED path inside the
#: checkout (listed in .gitignore).  The directory is part of what makes a
#: later process find the entries, so it never contains a temporary name,
#: a pid or a time.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def resolve_cache_dir(cache_dir: Optional[str] = None) -> Optional[str]:
    """The cache directory, or None when the cache is disabled.

    Order:

    1. ``JAX_COMPILATION_CACHE_DIR`` from the environment, when set: the
       cache is placed from outside and no other directory is used;
    2. otherwise the explicit ``cache_dir`` (``[run] compile_cache``); a
       value in ``{'', '0', 'off', 'none', 'false'}`` (case-insensitive)
       disables the cache;
    3. otherwise :data:`DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "").strip()
    if env:
        return env
    if cache_dir is not None:
        if cache_dir.strip().lower() in _OFF:
            return None
        return os.path.abspath(os.path.expanduser(cache_dir))
    return DEFAULT_CACHE_DIR


def enable_compile_cache(
    cache_dir: Optional[str] = None, min_compile_secs: float = 0.5
) -> Optional[str]:
    """Enable JAX's persistent compilation cache where
    :func:`resolve_cache_dir` says.

    Only executables whose compile took longer than ``min_compile_secs``
    are persisted, so tiny eager dispatches stay out of the directory
    while the sampler's mid-size programs (termination check, finalize,
    recluster) are kept.

    Returns the resolved directory, or None when disabled.  Call it before
    the first compile: JAX opens the cache once, at its first compile.
    """
    resolved = resolve_cache_dir(cache_dir)
    if resolved is None:
        return None
    os.makedirs(resolved, exist_ok=True)

    import jax

    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_compilation_cache_dir", resolved)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs)
    )
    return resolved
