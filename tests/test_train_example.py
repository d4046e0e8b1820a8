"""The sharded training example drives real gradients end-to-end."""

import pytest

import jax
import numpy as np

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.models.vit import ViTConfig
from tools.encoder import make_clip

from examples.train_vit import train


# assurance tier: mesh training loop (compile-heavy) (docs/TESTING.md)
pytestmark = pytest.mark.assurance

def test_train_loss_decreases_on_mesh():
    """decode → RGB → ViT → optax over a dp×tp mesh: loss must fall."""
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    assert devs.size == 8, "conftest must provide 8 virtual devices"
    mesh = Mesh(devs.reshape(4, 2), ("dp", "tp"))
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPB"], seed=60 + s) for s in range(8)]
    vcfg = ViTConfig(image_size=32, patch_size=8, dim=64, depth=1, heads=2)
    with mesh:
        losses = train(cfg, clips, vcfg, epochs=3, mesh=mesh, lr=3e-3)
    assert len(losses) >= 6
    assert losses[-1] < losses[0], losses


def test_train_single_device():
    cfg = SeqConfig(64, 48)
    clips = [make_clip(cfg, ["IPB"], seed=70 + s) for s in range(2)]
    vcfg = ViTConfig(image_size=32, patch_size=8, dim=64, depth=1, heads=2)
    losses = train(cfg, clips, vcfg, epochs=3, lr=3e-3)
    assert losses[-1] < losses[0], losses
