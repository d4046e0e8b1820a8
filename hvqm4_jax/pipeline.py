"""End-to-end on-device pipeline: .h4m streams → ViT embeddings (config 5).

The full BASELINE config-5 path as a library API: multi-stream decode →
YUV→RGB → resize → ViT encode, with every pixel staying on device from plan
upload to embedding. This is what a video-understanding training/serving job
would call to consume HVQM4 corpora directly on the accelerator.

    pipe = VideoEmbedPipeline(cfg, clips, vit_cfg)
    for emb, metas, valid in pipe.run():   # emb: (n_streams, dim) per step
        ...

Sharding: pass `mesh` to shard streams over its 'dp' axis and the ViT over
'tp' (see `models.vit.shard_vit_params`); the decode path stays
collective-free while the ViT inserts its tensor-parallel all-reduces.
"""

from __future__ import annotations

import jax

from .config import SeqConfig
from .models.vit import ViTConfig, init_vit, shard_vit_params, vit_encode
from .ops.csc import frame_to_rgb, resize_bilinear
from .parallel.multistream import MultiStreamDecoder, shard_streams


class VideoEmbedPipeline:
    def __init__(self, cfg: SeqConfig, clips: list[bytes],
                 vit_cfg: ViTConfig | None = None, params: dict | None = None,
                 planner_factory=None, mesh=None, rng_seed: int = 0):
        self.cfg = cfg
        self.vit_cfg = vit_cfg or ViTConfig()
        if planner_factory is None:
            from .planner import default_planner_factory

            planner_factory = default_planner_factory()
        sharding = shard_streams(mesh, "dp") if mesh is not None else None
        self.decoder = MultiStreamDecoder(cfg, clips,
                                          planner_factory=planner_factory,
                                          sharding=sharding)
        self.params = params if params is not None else init_vit(
            self.vit_cfg, jax.random.key(rng_seed))
        if mesh is not None:
            self.params = shard_vit_params(self.params, mesh, "tp")

        vc = self.vit_cfg
        h_samp, v_samp = cfg.h_samp, cfg.v_samp

        @jax.jit
        def embed(frames, params):
            rgb = frame_to_rgb(frames, h_samp, v_samp)   # (N, H, W, 3) u8
            imgs = jax.vmap(lambda im: resize_bilinear(
                im, vc.image_size, vc.image_size))(rgb)
            return vit_encode(params, vc, imgs)

        self._embed = embed

    def run(self, pipelined: bool = True):
        """Yield (embeddings (N, dim) f32, metas, valid) per decode step."""
        it = (self.decoder.run_pipelined() if pipelined else
              iter(self.decoder.step, None))
        for frames, metas, valid in it:
            yield self._embed(frames, self.params), metas, valid
