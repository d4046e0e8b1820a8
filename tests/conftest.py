"""Test environment: CPU backend with 8 virtual devices (SURVEY.md §2.6).

The suite runs without an accelerator; sharding tests run on a virtual
8-device CPU mesh. Integer decode math is exact on every XLA backend, and
`chip_smoke.py` checks the same paths against the C oracle on the GPU.

Must run before any `import jax` anywhere in the test session.
"""

import os
import pathlib
import subprocess

import numpy as np
import pytest

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

# Persistent compilation cache: the suite is compile-dominated. Subprocesses
# the tests start inherit the directory through the environment.
from hvqm4_jax.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache(cpu_host_key=True)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="session")
def oracle_bin() -> pathlib.Path:
    """Build (if needed) and return the C oracle binary."""
    path = REPO / "oracle" / "hvqm4_oracle"
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    return path


def run_oracle(oracle_bin, clip: bytes, tmp_path, args=()) -> bytes:
    """Decode a clip via the C oracle, return the raw YUV byte stream."""
    inp = tmp_path / "in.h4m"
    out = tmp_path / "out.yuv"
    inp.write_bytes(clip)
    subprocess.run([str(oracle_bin), *args, str(inp), str(out)], check=True)
    return out.read_bytes()


def golden_decode(cfg, clip: bytes):
    """Decode a clip via planner + NumPy golden decoder → list of YUV frames.

    Mirrors the session rules: reference state resets at each GOP block
    (FORMAT.md §2).
    """
    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.planner import Planner
    from hvqm4_jax.refdec import GoldenDecoder

    d = Demuxer(clip)
    pl = Planner(cfg)
    dec = GoldenDecoder(cfg)
    frames = []
    cur_block = None
    for r in d.records():
        if r.media_type != 1:
            continue
        if r.block_index != cur_block:
            dec.reset()
            cur_block = r.block_index
        planes = dec.decode(pl.plan_frame(r.frame_char, r.payload))
        frames.append(np.concatenate([p.reshape(-1) for p in planes]))
    return frames
