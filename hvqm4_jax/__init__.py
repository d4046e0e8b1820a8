"""hvqm4_jax — an HVQM4 (.h4m) video decode framework in JAX.

Architecture (see SURVEY.md §7 and docs/FORMAT.md):

- **Host planner** (`container`, `bitio`, `planner`, optionally `native/`):
  demux + serial entropy decode (Huffman trees, DC/MV prediction chains)
  emitting dense per-block *plan tensors* (`plans`).
- **Device core** (`ops.device_core`): batched JAX/XLA code turning a
  frame's plan + device-resident reference frames + nest into the next YUV
  frame — all pixel math, bit-exact integer semantics.
- **Session layer** (`session`): the reference-shaped frame-at-a-time API
  (init / buffsize / decode-I/P/B, per SURVEY.md §1 L2-L3).
- **Parallel** (`parallel/`): multi-stream vmap batching and `shard_map`
  fleet decode over a device mesh (SURVEY.md §2.6).
- **Models** (`models/`): downstream on-device consumers (ViT video encoder
  feed, BASELINE config 5).

The C oracle under `oracle/` is the executable reference (the upstream mount
was empty — SURVEY.md §0); `refdec` is the readable NumPy golden model.
"""

__version__ = "0.1.0"

from .config import SeqConfig  # noqa: F401
from .container import ContainerError, Demuxer  # noqa: F401
from .planner import Planner, PlannerError  # noqa: F401
from .plans import FramePlan, PlanePlan  # noqa: F401


def __getattr__(name):  # lazy: keep `import hvqm4_jax` free of jax
    if name in ("DecoderSession", "DecodedFrame"):
        from . import session

        return getattr(session, name)
    if name == "MultiStreamDecoder":
        from .parallel.multistream import MultiStreamDecoder

        return MultiStreamDecoder
    if name == "VideoEmbedPipeline":
        from .pipeline import VideoEmbedPipeline

        return VideoEmbedPipeline
    if name == "FrameBatchLoader":
        from .data import FrameBatchLoader

        return FrameBatchLoader
    if name == "NativePlanner":
        from .native import NativePlanner

        return NativePlanner
    if name in ("VideoEncoder", "encode_to_size"):
        from . import encode

        return getattr(encode, name)
    raise AttributeError(name)
