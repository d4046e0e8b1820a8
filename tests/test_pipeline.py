"""End-to-end VideoEmbedPipeline tests (BASELINE config 5)."""

import jax
import numpy as np

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.models.vit import ViTConfig
from hvqm4_jax.pipeline import VideoEmbedPipeline
from tools.encoder import make_clip

CFG = SeqConfig(64, 48)
VIT = ViTConfig(image_size=64, patch_size=8, dim=128, depth=2, heads=4)


def test_pipeline_embeddings_finite_and_deterministic():
    clips = [make_clip(CFG, ["IPB"], seed=s) for s in range(3)]
    pipe = VideoEmbedPipeline(CFG, clips, VIT, rng_seed=0)
    embs = [np.asarray(e) for e, _m, _v in pipe.run(pipelined=False)]
    assert len(embs) == 3 and embs[0].shape == (3, VIT.dim)
    assert all(np.isfinite(e).all() for e in embs)
    pipe2 = VideoEmbedPipeline(CFG, clips, VIT, rng_seed=0)
    embs2 = [np.asarray(e) for e, _m, _v in pipe2.run(pipelined=False)]
    for a, b in zip(embs, embs2):
        assert np.array_equal(a, b)


def test_pipeline_sharded_matches_unsharded():
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    mesh = Mesh(devs.reshape(4, 2), ("dp", "tp"))
    clips = [make_clip(CFG, ["IP"], seed=10 + s) for s in range(4)]
    pipe = VideoEmbedPipeline(CFG, clips, VIT, rng_seed=1)
    plain = [np.asarray(e) for e, _m, _v in pipe.run(pipelined=False)]
    with mesh:
        pipe_s = VideoEmbedPipeline(CFG, clips, VIT, mesh=mesh, rng_seed=1)
        sharded = [np.asarray(e) for e, _m, _v in pipe_s.run(pipelined=False)]
    # decode is integer-exact; ViT float path may reassociate across
    # shardings — require close agreement and identical shapes
    for a, b in zip(plain, sharded):
        assert a.shape == b.shape
        assert np.allclose(a, b, rtol=2e-2, atol=2e-2), np.abs(a - b).max()
