"""Sharded training example: `.h4m` corpus → on-device decode → ViT → optax.

Demonstrates the framework as a TRAINING INPUT PIPELINE (BASELINE config 5):
decoded frames never visit the host. The stream axis shards over the mesh's
'dp' axis (the decode path has zero collectives by design), the ViT's
heads/MLP shard over 'tp' (real collectives inside the model), and `jax.jit`
inserts the data-parallel gradient all-reduce automatically from the input
shardings — the standard mesh + sharding annotations recipe.

The objective is deliberately simple (predict each frame's mean RGB from the
CLS embedding through a learned linear head): enough to drive real gradients
through the whole decode → RGB → resize → ViT stack and verify the loss
falls, without pretending to be a research result.

Run:
    python examples/train_vit.py                    # single device
    python examples/train_vit.py --dp 2 --tp 2      # needs 4 devices
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/train_vit.py --dp 4 --tp 2  # virtual 8-device CPU mesh

With fewer devices than dp*tp the example exits with an error; the virtual
CPU mesh above is the way to run a mesh on a machine without that many.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hvqm4_jax.config import SeqConfig  # noqa: E402
from hvqm4_jax.data import FrameBatchLoader  # noqa: E402
from hvqm4_jax.models.vit import (ViTConfig, init_vit,  # noqa: E402
                                  shard_vit_params, vit_encode)


def train(cfg: SeqConfig, clips: list[bytes], vcfg: ViTConfig,
          epochs: int = 3, lr: float = 1e-3, mesh=None,
          seed: int = 0) -> list[float]:
    """Train the mean-RGB probe; returns the per-step loss history."""
    key = jax.random.key(seed)
    params = {
        "vit": init_vit(vcfg, key),
        "head": {
            "w": jnp.zeros((vcfg.dim, 3), jnp.float32),
            "b": jnp.zeros((3,), jnp.float32),
        },
    }
    if mesh is not None:
        params["vit"] = shard_vit_params(params["vit"], mesh, "tp")
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    def loss_fn(params, images, weight):
        emb = vit_encode(params["vit"], vcfg, images)        # (N, dim)
        pred = emb @ params["head"]["w"] + params["head"]["b"]
        target = images.mean(axis=(1, 2))                    # (N, 3)
        per = ((pred - target) ** 2).mean(axis=1)            # (N,)
        return (per * weight).sum() / jnp.maximum(weight.sum(), 1.0)

    @jax.jit
    def step(params, opt_state, images, weight):
        loss, grads = jax.value_and_grad(loss_fn)(params, images, weight)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    losses: list[float] = []
    for _ in range(epochs):
        loader = FrameBatchLoader(cfg, clips, image_size=vcfg.image_size,
                                  mesh=mesh)
        for images, valid in loader:
            # masked loss: finished/poisoned streams contribute zero weight
            weight = jnp.asarray(np.array(valid, np.float32))
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P

                weight = jax.device_put(
                    weight, NamedSharding(mesh, P("dp")))
            params, opt_state, loss = step(params, opt_state, images, weight)
            losses.append(float(loss))
    return losses


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel mesh width (0 = no mesh)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh width")
    args = ap.parse_args()

    from tools.encoder import make_clip

    cfg = SeqConfig(args.width, args.height)
    clips = [make_clip(cfg, ["IPBPB", "IPP"], seed=s)
             for s in range(args.streams)]
    vcfg = ViTConfig(image_size=64, patch_size=8, dim=128, depth=2, heads=4)

    mesh = None
    if args.dp:
        from jax.sharding import Mesh

        n = args.dp * args.tp
        if len(jax.devices()) < n:
            print(f"need {n} devices for dp={args.dp} tp={args.tp}, JAX "
                  f"sees {len(jax.devices())} "
                  f"{jax.devices()[0].platform} device(s) (see the module "
                  f"docstring for the virtual CPU mesh)", file=sys.stderr)
            return 2
        devs = np.array(jax.devices()[:n]).reshape(args.dp, args.tp)
        mesh = Mesh(devs, ("dp", "tp"))
    import contextlib

    ctx = mesh if mesh is not None else contextlib.nullcontext()
    with ctx:
        losses = train(cfg, clips, vcfg, epochs=args.epochs, mesh=mesh)
    where = (f"mesh dp={args.dp} tp={args.tp}" if mesh
             else "single device")
    print(f"steps={len(losses)} first_loss={losses[0]:.5f} "
          f"last_loss={losses[-1]:.5f} ({where})")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    sys.exit(main())
