"""Config-5 throughput: .h4m streams → ViT embeddings, fps on the device.

Measures `VideoEmbedPipeline` (multi-stream decode → YUV→RGB → resize →
ViT encode, all pixels device-resident) end to end, host planning
overlapped (BASELINE.json config 5).

    python scripts/bench_embed.py [n_streams] [--clip PATH]

Prints ONE JSON line.
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
    import numpy as np

    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.models.vit import ViTConfig
    from hvqm4_jax.pipeline import VideoEmbedPipeline

    clip = pathlib.Path(args.clip).read_bytes()
    cfg = Demuxer(clip).info.cfg
    vcfg = ViTConfig(image_size=args.image_size)

    def make():
        return VideoEmbedPipeline(cfg, [clip] * args.n_streams, vcfg)

    pipe = make()  # warmup: compile every step variant + the embed jit
    for _ in pipe.run():
        pass

    pipe = make()
    t0 = time.perf_counter()
    frames = 0
    last = None
    for emb, _metas, valid in pipe.run():
        frames += int(np.sum(valid))
        last = emb
    jax.block_until_ready(last)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "config": "decode->rgb->resize->vit_embed",
        "streams": args.n_streams,
        "clip": args.clip,
        "vit": f"{vcfg.dim}d x{vcfg.depth} p{vcfg.patch_size} "
               f"{vcfg.image_size}px",
        "frames": frames,
        "embed_fps": round(frames / dt, 1),
        "backend": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
