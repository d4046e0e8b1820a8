"""Pinned conformance vector (FORMAT.md Appendix A).

Guards against silent semantic drift: if any implementation change alters
this decode, the appendix (and the format's meaning) changed with it.
"""

from hvqm4_jax.config import SeqConfig
from tools.encoder import make_clip

from .conftest import golden_decode, run_oracle

YUV_HEX = (
    "4a4a526affffffff4a4a526affffffff50505870ffffffff62626a82ffffffff"
    "ffffffffe5d6e5d6ffffffffe5d6e5d6ffffffffe5d6e5d6ffffffffe5d6e5d6"
    "00000000000000000000000000000000bebebebebebebebebebebebebebebebe")


def test_conformance_vector(oracle_bin, tmp_path):
    cfg = SeqConfig(8, 8)
    clip = make_clip(cfg, ["I"], seed=0, dc_shift=0)
    assert len(clip) == 167
    want = bytes.fromhex(YUV_HEX)
    assert run_oracle(oracle_bin, clip, tmp_path) == want
    assert b"".join(f.tobytes() for f in golden_decode(cfg, clip)) == want
