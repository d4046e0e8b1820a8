"""Content-aware encoder round-trip (encode → decode → quality)."""

import numpy as np
import pytest

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.encode import VideoEncoder

from .conftest import golden_decode, run_oracle


def _synthetic_video(cfg: SeqConfig, n: int, seed: int = 0):
    """Moving-gradient frames: smooth areas + a moving bright square."""
    rng = np.random.default_rng(seed)
    h, w = cfg.plane_shapes[0]
    ch, cw = cfg.plane_shapes[1]
    frames = []
    gx = np.linspace(40, 200, w)[None, :]
    gy = np.linspace(0, 55, h)[:, None]
    for t in range(n):
        y = (gx + gy).astype(np.float64)
        x0 = (5 + 3 * t) % (w - 16)
        y0 = (3 + 2 * t) % (h - 16)
        y[y0:y0 + 16, x0:x0 + 16] = 230
        y = np.clip(y + rng.normal(0, 1.5, (h, w)), 0, 255).astype(np.uint8)
        u = np.full((ch, cw), 110, np.uint8)
        v = np.full((ch, cw), 140, np.uint8)
        frames.append([y, u, v])
    return frames


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("gops", [["IPPP"], ["IBPBP"]])
def test_encode_roundtrip_quality(oracle_bin, tmp_path, gops):
    cfg = SeqConfig(64, 48)
    frames = _synthetic_video(cfg, sum(len(g) for g in gops))
    enc = VideoEncoder(cfg, lambda_bits=2.0)
    clip = enc.encode(frames, gops)

    # the stream must be decodable by BOTH independent decoders, identically
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    decoded = golden_decode(cfg, clip)
    assert b"".join(f.tobytes() for f in decoded) == oracle_yuv

    # quality: decoded luma should resemble the source (decode order vs
    # display order handled via display ids)
    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.planner import Planner

    order = [Planner(cfg).plan_frame(r.frame_char, r.payload).display_id
             for r in Demuxer(clip).video_records()]
    ylen = cfg.plane_shapes[0][0] * cfg.plane_shapes[0][1]
    psnrs = []
    for rec_idx, disp in enumerate(order):
        got_y = decoded[rec_idx][:ylen].reshape(cfg.plane_shapes[0])
        psnrs.append(_psnr(got_y, frames[disp][0]))
    assert min(psnrs) > 26.0, psnrs


def test_encoder_closed_loop_matches_decoder():
    """The encoder's internal reconstruction IS the decoder output (no drift)."""
    cfg = SeqConfig(64, 48)
    frames = _synthetic_video(cfg, 4, seed=3)
    enc = VideoEncoder(cfg)
    clip = enc.encode(frames, ["IPPP"])
    decoded = golden_decode(cfg, clip)
    # encoder's final ref_last should equal the last decoded I/P frame
    last = decoded[-1]
    enc_last = np.concatenate([p.reshape(-1) for p in enc.dec.ref_last])
    assert np.array_equal(enc_last, last)


def test_sliced_encoding_identical_pixels(oracle_bin, tmp_path):
    """slices >= 2 changes only the entropy layout (FORMAT.md §9): the
    decoded pixels must equal the single-slice encode of the same frames,
    and the sliced stream must decode identically on the C oracle."""
    cfg = SeqConfig(64, 48)
    frames = _synthetic_video(cfg, 5, seed=7)
    c1 = VideoEncoder(cfg, seed=0).encode(frames, ["IPBPB"])
    c3 = VideoEncoder(cfg, seed=0, slices=3).encode(frames, ["IPBPB"])
    assert c1 != c3  # different layout...
    d1 = golden_decode(cfg, c1)
    d3 = golden_decode(cfg, c3)
    assert [f.tobytes() for f in d1] == [f.tobytes() for f in d3]  # ...same pixels
    assert b"".join(f.tobytes() for f in d3) == run_oracle(
        oracle_bin, c3, tmp_path)


def test_encode_with_audio_roundtrip(oracle_bin, tmp_path):
    """WAV audio muxes as per-block ADPCM records; the full clip (video +
    audio) still decodes bit-exact on the oracle and the audio tracks the
    source signal."""
    from hvqm4_jax.audio import decode_record
    from hvqm4_jax.container import Demuxer

    cfg = SeqConfig(64, 48)
    gops = ["IPP", "IPP"]
    frames = _synthetic_video(cfg, 6, seed=5)
    rate = 32000
    n = round(6 * 33366e-6 * rate)
    t = np.arange(n)[:, None]
    pcm = (7000 * np.sin(0.02 * t + np.arange(2)[None, :])).astype(np.int16)
    clip = VideoEncoder(cfg, seed=0).encode(frames, gops, audio=pcm,
                                            audio_rate=rate)
    d = Demuxer(clip)
    assert d.info.audio_channels == 2
    assert d.info.audio_sample_rate == rate
    recs = [decode_record(r.payload, 2) for r in d.audio_records()]
    assert len(recs) == 2  # one per GOP block
    got = np.concatenate(recs)
    assert got.shape == pcm.shape
    # ADPCM is lossy: require strong correlation, not equality
    c = np.corrcoef(got[:, 0].astype(np.float64), pcm[:, 0])[0, 1]
    assert c > 0.99, c
    # video path is untouched by the interleaved audio records
    want = run_oracle(oracle_bin, clip, tmp_path)
    assert b"".join(f.tobytes() for f in golden_decode(cfg, clip)) == want


def test_dc_shift_encoding_bitexact(oracle_bin, tmp_path):
    """dc_shift > 0 quantizes DC deltas (FORMAT.md §5.4); the encoder's
    chain simulation keeps its nest identical to the decoder's and the
    stream decodes bit-exact everywhere."""
    cfg = SeqConfig(64, 48)
    frames = _synthetic_video(cfg, 5, seed=21)
    clip = VideoEncoder(cfg, seed=0, dc_shift=3).encode(frames, ["IPBPB"])
    want = run_oracle(oracle_bin, clip, tmp_path)
    got = b"".join(f.tobytes() for f in golden_decode(cfg, clip))
    assert got == want
    # quality must stay in the same ballpark as shift 0 (coarse DCs only)
    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.planner import Planner

    order = [Planner(cfg).plan_frame(r.frame_char, r.payload).display_id
             for r in Demuxer(clip).video_records()]
    decoded = golden_decode(cfg, clip)
    ylen = cfg.plane_shapes[0][0] * cfg.plane_shapes[0][1]
    psnrs = [_psnr(decoded[i][:ylen].reshape(cfg.plane_shapes[0]),
                   frames[disp][0]) for i, disp in enumerate(order)]
    assert min(psnrs) > 24.0, psnrs


def test_rate_control_hits_target():
    """encode_to_size bisects lambda to a byte target within tolerance."""
    from hvqm4_jax.encode import encode_to_size

    cfg = SeqConfig(64, 48)
    frames = _synthetic_video(cfg, 5, seed=9)
    gops = ["IPBPB"]
    big = len(VideoEncoder(cfg, lambda_bits=0.25).encode(frames, gops))
    small = len(VideoEncoder(cfg, lambda_bits=64.0).encode(frames, gops))
    assert small < big
    target = (big + small) // 2
    clip, lam = encode_to_size(cfg, frames, gops, target, tolerance=0.08)
    assert abs(len(clip) - target) <= 0.08 * target, (len(clip), target, lam)
    assert 0.25 <= lam <= 64.0


def test_inter_residuals_emitted_and_bitexact(oracle_bin, tmp_path):
    """The encoder spends AOT bases on MC residuals (FORMAT.md §7.4) where
    they pay, and the result still decodes bit-exactly vs the oracle."""
    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.planner import Planner

    cfg = SeqConfig(64, 48)
    # I frame with per-block-constant random DCs: encodes as weight blocks,
    # so the decoded DC grid (hence the nest) is rich in structure. P frames
    # translate it and add noise: motion search finds the shift but MC can't
    # be exact, so residual bases pay their bits.
    rng = np.random.default_rng(11)
    dcs = rng.integers(40, 220, (12 + 4, 16 + 4)).astype(np.uint8)
    base = np.kron(dcs, np.ones((4, 4), np.uint8))
    frames = []
    for t in range(4):
        y = base[2 * t:2 * t + 48, 3 * t:3 * t + 64].astype(np.int32)
        if t:
            y = np.clip(y + rng.integers(-12, 13, y.shape), 0, 255)
        u = np.full(cfg.plane_shapes[1], 120, np.uint8)
        v = np.full(cfg.plane_shapes[2], 130, np.uint8)
        frames.append([y.astype(np.uint8), u, v])
    clip = VideoEncoder(cfg, seed=2).encode(frames, ["IPPP"])

    pl = Planner(cfg)
    inter_k = 0
    for r in Demuxer(clip).video_records():
        plan = pl.plan_frame(r.frame_char, r.payload)
        for p in plan.planes:
            inter_k += int(((p.cls == 1) & (p.mode > 0)).sum())
    assert inter_k > 0, "no inter residual bases were emitted"

    want = run_oracle(oracle_bin, clip, tmp_path)
    got = b"".join(f.tobytes() for f in golden_decode(cfg, clip))
    assert got == want


def test_psychovisual_weighting_roundtrip(oracle_bin, tmp_path):
    """psy > 0 shifts bits from textured to flat regions; the stream must
    stay spec-valid (oracle-identical decode) and spend FEWER bits on the
    high-activity half at equal lambda."""
    cfg = SeqConfig(64, 48)
    rng = np.random.default_rng(17)
    h, w = cfg.plane_shapes[0]
    frames = []
    for t in range(4):
        y = np.full((h, w), 120, np.float64)
        y[:, : w // 2] += np.linspace(0, 30, w // 2)[None, :]      # flat-ish
        y[:, w // 2:] += rng.normal(0, 40, (h, w // 2))            # textured
        y = np.clip(y + t, 0, 255).astype(np.uint8)
        u = np.full(cfg.plane_shapes[1], 110, np.uint8)
        v = np.full(cfg.plane_shapes[1], 140, np.uint8)
        frames.append([y, u, v])

    clips = {psy: VideoEncoder(cfg, lambda_bits=8.0, seed=0, psy=psy)
             .encode(frames, ["IPPP"]) for psy in (0.0, 1.0)}
    assert clips[0.0] != clips[1.0]
    for psy, clip in clips.items():
        ours = b"".join(b"".join(pl.tobytes() for pl in f)
                        for f in golden_decode(cfg, clip))
        assert run_oracle(oracle_bin, clip, tmp_path) == ours, \
            f"psy={psy} not oracle-identical"

    def textured_bases(clip):
        """AOT bases spent on the textured right half of the I frame."""
        from hvqm4_jax.container import Demuxer
        from hvqm4_jax.planner import Planner

        rec = next(r for r in Demuxer(clip).video_records()
                   if r.frame_char == "I")
        plan = Planner(cfg).plan_frame("I", rec.payload)
        pp = plan.planes[0]
        counts = np.where(((pp.cls == 0) & (pp.mode >= 1) & (pp.mode <= 4)),
                          pp.mode, 0)
        return int(counts[:, counts.shape[1] // 2:].sum())

    assert textured_bases(clips[1.0]) <= textured_bases(clips[0.0])


def test_adaptive_single_pass_rate_control():
    """encode(target_bytes=...) converges toward the target in ONE pass by
    per-GOP lambda adaptation (vs the fixed-lambda encode missing it)."""
    cfg = SeqConfig(64, 48)
    frames = _synthetic_video(cfg, 12, seed=23)
    gops = ["IPP", "IPP", "IPP", "IPP"]
    fixed = VideoEncoder(cfg, lambda_bits=0.5, seed=0).encode(frames, gops)
    target = int(len(fixed) * 0.55)
    enc = VideoEncoder(cfg, lambda_bits=0.5, seed=0)
    adaptive = enc.encode(frames, gops, target_bytes=target)
    # the controller must move lambda and land closer to the target than
    # the fixed encode (late GOPs carry the correction in a single pass)
    assert enc.lam > 0.5
    assert abs(len(adaptive) - target) < abs(len(fixed) - target)
    # stream stays decodable
    assert len(golden_decode(cfg, adaptive)) == 12
