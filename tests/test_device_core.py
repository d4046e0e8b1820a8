"""JAX device core vs C oracle: full-clip bit-exactness (BASELINE configs 1-3).

Runs on the XLA CPU backend here (conftest); the same integer ops are exact
on the GPU, where `chip_smoke.py` re-checks them against the oracle.
"""

import pytest

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.session import (
    DecoderSession, HVQM4BuffSize, HVQM4DecodeIpic, HVQM4InitSeqObj,
    HVQM4SetBuffer,
)
from tools.encoder import make_clip

from .conftest import run_oracle

CASES = [
    (64, 48, 2, ["IPBPB", "IPP"], 1),
    (48, 64, 1, ["IPBPB"], 2),            # portrait nest, 4:4:4
    (320, 240, 2, ["I", "I"], 8),          # BASELINE config 1: I-only 320x240
    (128, 96, 2, ["IBBPBP", "IPPP"], 3),
    (32, 16, 2, ["IPB"], 77),              # every frame type, tiny planes
    (256, 192, 2, ["IP"], 79),             # 3072 luma blocks per plane
]


def _session_decode(cfg, clip, backend="jax") -> bytes:
    sess = DecoderSession(cfg, backend=backend)
    return b"".join(f.yuv_bytes() for f in sess.decode_clip(clip))


@pytest.mark.parametrize("w,h,samp,gops,seed", CASES)
def test_jax_core_matches_oracle(oracle_bin, tmp_path, w, h, samp, gops, seed):
    cfg = SeqConfig(w, h, samp, samp)
    clip = make_clip(cfg, gops, seed=seed)
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    got = _session_decode(cfg, clip)
    assert got == oracle_yuv


def test_numpy_backend_matches_jax():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPBPB"], seed=9)
    assert _session_decode(cfg, clip, "jax") == _session_decode(cfg, clip, "numpy")


def test_sdk_shim_api(oracle_bin, tmp_path):
    """The reference-shaped API decodes an I payload identically."""
    cfg = HVQM4InitSeqObj(64, 48)
    assert HVQM4BuffSize(cfg) == 4 * cfg.frame_bytes + 38 * 70
    sess = HVQM4SetBuffer(cfg)
    clip = make_clip(cfg, ["I"], seed=10)
    from hvqm4_jax.container import Demuxer

    payload = next(Demuxer(clip).video_records()).payload
    frame = HVQM4DecodeIpic(sess, payload)
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    assert frame.yuv_bytes() == oracle_yuv


def test_seek_block(oracle_bin, tmp_path):
    """Decoding from block k equals the tail of a full decode (GOP seek)."""
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPP", "IPB", "IP"], seed=11)
    sess = DecoderSession(cfg)
    full = [f.yuv_bytes() for f in sess.decode_clip(clip)]
    sess2 = DecoderSession(cfg)
    tail = [f.yuv_bytes() for f in sess2.decode_clip(clip, start_block=1)]
    assert tail == full[3:]
