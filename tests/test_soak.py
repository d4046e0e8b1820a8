"""Broad randomized conformance soak: many seeds, mixed parameters.

Each case is a fresh randomized clip (geometry, sampling, GOP shape, slices,
dc_shift) decoded by both independent implementations; any divergence fails
with the parameters needed to reproduce.
"""

import numpy as np
import pytest

from hvqm4_jax.config import SeqConfig
from tools.encoder import make_clip

from .conftest import golden_decode, run_oracle


# assurance tier: randomized 40-config conformance battery (docs/TESTING.md)
pytestmark = pytest.mark.assurance

@pytest.mark.parametrize("seed", range(100, 140))
def test_randomized_conformance(oracle_bin, tmp_path, seed):
    rng = np.random.default_rng(seed)
    w = 8 * int(rng.integers(1, 13))
    h = 8 * int(rng.integers(1, 13))
    samp = int(rng.choice([1, 2]))
    cfg = SeqConfig(w, h, samp, samp,
                    version=str(rng.choice(["1.3", "1.5"])))
    n_anchor = int(rng.integers(1, 4))
    pattern = "I"
    for _ in range(n_anchor):
        pattern += str(rng.choice(["P", "BP", "BBP", ""]))
    mh = cfg.mb_grid[0]
    slices = int(rng.integers(1, min(mh, 6) + 1))
    clip = make_clip(cfg, [pattern], seed=seed,
                     dc_shift=int(rng.integers(0, 8)), slices=slices)
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    got = b"".join(f.tobytes() for f in golden_decode(cfg, clip))
    assert got == oracle_yuv, (
        f"seed={seed} {w}x{h} samp={samp} pattern={pattern} slices={slices}")


@pytest.mark.parametrize("seed", range(200, 225))
def test_randomized_native_vs_python(seed):
    """The C++ planner (post sparse-pool/batch rewrites) must emit exactly
    the Python planner's FramePlan on randomized streams."""
    native = pytest.importorskip("hvqm4_jax.native")
    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.planner import Planner

    rng = np.random.default_rng(seed)
    w = 8 * int(rng.integers(1, 10))
    h = 8 * int(rng.integers(1, 10))
    samp = int(rng.choice([1, 2]))
    cfg = SeqConfig(w, h, samp, samp)
    mh = cfg.mb_grid[0]
    pattern = "I" + str(rng.choice(["PB", "P", "BP", "BBP", ""]))
    clip = make_clip(cfg, [pattern], seed=seed,
                     dc_shift=int(rng.integers(0, 8)),
                     slices=int(rng.integers(1, min(mh, 4) + 1)))
    py = Planner(cfg)
    nat = native.NativePlanner(cfg)
    for r in Demuxer(clip).video_records():
        a = py.plan_frame(r.frame_char, r.payload)
        b = nat.plan_frame(r.frame_char, r.payload)
        assert a == b, f"seed={seed} {w}x{h} samp={samp} {pattern}"
