"""The compile-cache rule (`hvqm4_jax.utils.compile_cache`), checked in
fresh processes because JAX reads its cache directory at import."""

import json
import os
import subprocess
import sys

from .conftest import REPO

_PROBE = """
import json
from hvqm4_jax.utils.compile_cache import use_compile_cache
path = use_compile_cache()
import jax
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()
print(json.dumps({"path": path,
                  "jax": jax.config.jax_compilation_cache_dir}))
"""


def _probe(env):
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cache_dir_from_environment_is_used_as_is(tmp_path):
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    out = _probe(env)
    assert out == {"path": str(cache), "jax": str(cache)}
    assert any(cache.iterdir()), "the compiled program was not cached there"


def test_cache_dir_defaults_to_the_checkout():
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    out = _probe(env)
    want = str(REPO / ".jax_cache")
    assert out == {"path": want, "jax": want}
