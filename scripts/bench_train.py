"""Decode→train throughput: .h4m streams → ViT train step, fps on the device.

Extends the config-5 measurement (`bench_embed.py`, forward-only) to the
full TRAINING input path the framework exists to feed: multi-stream decode
→ YUV→RGB → resize → ViT forward + backward + optax adam update, every
pixel device-resident (the objective is `examples/train_vit.py`'s mean-RGB
probe — enough to drive real gradients through the whole stack).

    python scripts/bench_train.py [n_streams] [--clip PATH]

Prints ONE JSON line (train_fps = frames consumed per second by the
training loop, decode included and overlapped with host planning).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hvqm4_jax.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_streams", type=int, nargs="?", default=8)
    ap.add_argument("--clip", default="testdata/retail640.h4m")
    ap.add_argument("--image-size", type=int, default=224)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.data import FrameBatchLoader
    from hvqm4_jax.models.vit import ViTConfig, init_vit, vit_encode

    clip = pathlib.Path(args.clip).read_bytes()
    cfg = Demuxer(clip).info.cfg
    clips = [clip] * args.n_streams
    vcfg = ViTConfig(image_size=args.image_size)

    params = {
        "vit": init_vit(vcfg, jax.random.key(0)),
        "head": {"w": jnp.zeros((vcfg.dim, 3), jnp.float32),
                 "b": jnp.zeros((3,), jnp.float32)},
    }
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def loss_fn(params, images, weight):
        emb = vit_encode(params["vit"], vcfg, images)
        pred = emb @ params["head"]["w"] + params["head"]["b"]
        per = ((pred - images.mean(axis=(1, 2))) ** 2).mean(axis=1)
        return (per * weight).sum() / jnp.maximum(weight.sum(), 1.0)

    # ONE dispatch for the whole epoch's optimization (lax.scan over the
    # decoded step batches): a per-step jit call marshals ~300 param +
    # opt-state buffer handles; scanning amortizes that to one call
    @jax.jit
    def train_epoch(params, opt_state, images, weights):
        def body(carry, xw):
            p, o = carry
            imgs, w = xw
            loss, grads = jax.value_and_grad(loss_fn)(p, imgs, w)
            updates, o = opt.update(grads, o)
            return (optax.apply_updates(p, updates), o), loss
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), (images, weights))
        return params, opt_state, losses

    def epoch(params, opt_state):
        imgs, wts, frames = [], [], 0
        t0 = time.perf_counter()
        for images, valid in FrameBatchLoader(cfg, clips,
                                              image_size=args.image_size):
            frames += int(np.sum(valid))
            imgs.append(images)          # device-resident (decode output)
            wts.append(jnp.asarray(np.array(valid, np.float32)))
        images = jnp.stack(imgs)         # (steps, N, S, S, 3), on device
        weights = jnp.stack(wts)
        jax.block_until_ready(images)
        t_decode = time.perf_counter() - t0
        params, opt_state, losses = train_epoch(params, opt_state,
                                                images, weights)
        jax.block_until_ready(losses)
        # return losses ON DEVICE: the caller reads them only after all
        # timed work, so no d2h sync lands inside the timed epochs
        return params, opt_state, frames, losses, t_decode

    # warmup epoch: compile every decode-step variant + the epoch scan
    params, opt_state, _f, _l, _td = epoch(params, opt_state)

    t0 = time.perf_counter()
    params, opt_state, frames, losses, t_decode = epoch(params, opt_state)
    dt = time.perf_counter() - t0
    last_loss = float(np.asarray(losses)[-1])
    print(json.dumps({
        "config": "decode->rgb->resize->vit_train_step",
        "streams": args.n_streams,
        "clip": args.clip,
        "vit": f"{vcfg.dim}d x{vcfg.depth} p{vcfg.patch_size} "
               f"{vcfg.image_size}px",
        "frames": frames,
        "train_fps": round(frames / dt, 1),
        "decode_s": round(t_decode, 3),
        "train_s": round(dt - t_decode, 3),
        "last_loss": round(last_loss, 6),
        "backend": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
