"""FrameBatchLoader tests (ML-consumer data path)."""

import numpy as np

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.data import FrameBatchLoader
from tools.encoder import make_clip

CFG = SeqConfig(64, 48)


def test_loader_shapes_and_range():
    clips = [make_clip(CFG, ["IPB"], seed=s) for s in range(2)]
    loader = FrameBatchLoader(CFG, clips, image_size=32)
    batches = [(np.asarray(b), v) for b, v in loader]
    assert len(batches) == 3
    for b, valid in batches:
        assert b.shape == (2, 32, 32, 3)
        assert b.min() >= 0.0 and b.max() <= 1.0
        assert valid == [True, True]


def test_loader_display_order_contiguous_ids():
    clips = [make_clip(CFG, ["IBPBP"], seed=7)]
    loader = FrameBatchLoader(CFG, clips, image_size=16, display_order=True)
    seen = []
    for ready in loader:
        for si, frame in ready:
            assert si == 0
            assert np.asarray(frame).shape == (16, 16, 3)
            seen.append(si)
    assert len(seen) == 5  # every display id delivered exactly once
