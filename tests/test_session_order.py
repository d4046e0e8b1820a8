"""Display-order reordering and geometry edge cases."""

import pytest

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.session import DecoderSession
from tools.encoder import make_clip

from .conftest import golden_decode, run_oracle


def test_display_order_is_sorted_and_complete():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IBBPBP", "IPB"], seed=31)
    sess = DecoderSession(cfg, backend="numpy")
    decode_order = [f.display_id for f in sess.decode_clip(clip)]
    sess2 = DecoderSession(cfg, backend="numpy")
    display_order = [f.display_id for f in sess2.decode_clip_display_order(clip)]
    assert sorted(decode_order) == display_order
    assert display_order == list(range(len(display_order)))
    assert decode_order != display_order  # B reordering actually happened


def test_display_order_frames_match_decode_order_content():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IBPB" + "P" * 2], seed=32)
    by_decode = {f.display_id: f.yuv_bytes()
                 for f in DecoderSession(cfg, backend="numpy").decode_clip(clip)}
    for f in DecoderSession(cfg, backend="numpy").decode_clip_display_order(clip):
        assert f.yuv_bytes() == by_decode[f.display_id]


@pytest.mark.parametrize("w,h,samp", [(8, 8, 2), (8, 64, 2), (640, 8, 2),
                                      (8, 8, 1), (16, 8, 2)])
def test_tiny_and_extreme_geometry(oracle_bin, tmp_path, w, h, samp):
    """Smallest legal frames and extreme aspect ratios stay bit-exact
    (nest wraps heavily over tiny DC grids; MB grids of one row/column)."""
    cfg = SeqConfig(w, h, samp, samp)
    clip = make_clip(cfg, ["IPBP"], seed=33)
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    got = b"".join(f.tobytes() for f in golden_decode(cfg, clip))
    assert got == oracle_yuv
