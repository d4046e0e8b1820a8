"""IMA-ADPCM audio tests (FORMAT.md §8): Python codec vs the C oracle."""

import numpy as np
import pytest

from hvqm4_jax.audio import decode_record, encode_record
from hvqm4_jax.config import SeqConfig
from tools.encoder import make_clip


@pytest.mark.parametrize("channels", [1, 2])
def test_adpcm_tracks_signal(channels):
    t = np.arange(2048)[:, None]
    sig = (8000 * np.sin(0.02 * t + np.arange(channels)[None, :])).astype(np.int16)
    rec = encode_record(sig)
    out = decode_record(rec, channels)
    assert out.shape == sig.shape
    # ADPCM is lossy; decoded signal must track within step-table resolution
    err = np.abs(out.astype(np.int32) - sig.astype(np.int32))
    assert np.median(err) < 600


def test_adpcm_vs_oracle(oracle_bin, tmp_path):
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["I", "I"], seed=11, audio_channels=2)
    inp = tmp_path / "a.h4m"
    pcm_path = tmp_path / "a.pcm"
    inp.write_bytes(clip)
    import subprocess
    subprocess.run([str(oracle_bin), "--audio", str(pcm_path), str(inp)],
                   check=True)
    oracle_pcm = np.frombuffer(pcm_path.read_bytes(), "<i2").reshape(-1, 2)

    from hvqm4_jax.container import Demuxer
    d = Demuxer(clip)
    recs = [decode_record(r.payload, 2) for r in d.audio_records()]
    py_pcm = np.concatenate(recs, axis=0)
    assert np.array_equal(oracle_pcm, py_pcm)


def test_truncated_audio_rejected():
    sig = np.zeros((100, 1), np.int16)
    rec = encode_record(sig)
    with pytest.raises(Exception):
        decode_record(rec[:10], 1)
    # step_index out of range
    bad = bytearray(rec)
    bad[6] = 99
    with pytest.raises(ValueError):
        decode_record(bytes(bad), 1)
