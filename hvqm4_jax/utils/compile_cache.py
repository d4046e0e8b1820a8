"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, server, bench, scripts, tests and
`chip_smoke.py`): when `JAX_COMPILATION_CACHE_DIR` is set it is used as it
is and nothing else is configured in code; otherwise the cache lives at
`<checkout>/.jax_cache`, which `.gitignore` lists. XLA:CPU entries bind to
the compiling host's ISA, so CPU-only runs (the test suite) ask for a
subdirectory keyed by the host fingerprint.
"""

from __future__ import annotations

import os
import pathlib
import sys

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def use_compile_cache(cpu_host_key: bool = False) -> str:
    """Point JAX's persistent cache at the directory the rule above picks
    and return it. Safe to call before or after `import jax`."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    cache = CHECKOUT / ".jax_cache"
    if cpu_host_key:
        from ..native import _fingerprint

        cache = cache / f"cpu-{_fingerprint()}"
    cache.mkdir(parents=True, exist_ok=True)
    path = str(cache)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = path
    if "jax" in sys.modules:   # the env var is read once, at jax import
        sys.modules["jax"].config.update("jax_compilation_cache_dir", path)
    return path
