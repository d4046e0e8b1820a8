"""Parallel decode: vmap multi-stream batching and mesh sharding (SURVEY.md §2.6).

The codec's honest parallelism axes on an accelerator: *within-frame* (the device core's
block grid), *across streams* on one device (`vmap` — the reference's "data
parallelism" analogue), and *across devices* (`shard_map`/NamedSharding over a
`jax.sharding.Mesh` — embarrassingly parallel, zero collectives by design;
the downstream ViT feed adds genuine tensor-parallel collectives).
"""

from .multistream import MultiStreamDecoder, multi_frame_step  # noqa: F401
