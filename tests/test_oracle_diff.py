"""Differential tests: C oracle vs Python planner+golden (SURVEY.md §4.3).

The central conformance check of the repo: two independent implementations of
docs/FORMAT.md (C scalar decoder vs Python planner + vectorized NumPy core)
must agree byte-for-byte on synthetic corpus clips covering every decode path.
"""

import pytest

from hvqm4_jax.config import SeqConfig
from tools.encoder import make_clip

from .conftest import golden_decode, run_oracle

CASES = [
    # (w, h, samp, version, gops, audio_ch, dc_shift, seed)
    (64, 48, 2, "1.3", ["IPBPB", "IPP"], 2, None, 1),
    (48, 64, 1, "1.5", ["IPBPB"], 0, None, 2),          # portrait nest, 4:4:4
    (320, 240, 2, "1.3", ["IBBPBP", "IPPP"], 1, None, 3),
    (64, 64, 2, "1.3", ["I"], 0, 0, 4),                 # I-only
    (128, 48, 2, "1.3", ["IPBPBPBPB"], 0, 2, 5),        # deep B chains
    (96, 96, 1, "1.3", ["IPB", "IB" + "P" * 6], 0, 7, 6),  # max dc_shift
]


@pytest.mark.parametrize("w,h,samp,ver,gops,ach,shift,seed", CASES)
def test_oracle_matches_golden(oracle_bin, tmp_path, w, h, samp, ver, gops,
                               ach, shift, seed):
    cfg = SeqConfig(w, h, samp, samp, ver)
    clip = make_clip(cfg, gops, seed=seed, audio_channels=ach, dc_shift=shift)
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    frames = golden_decode(cfg, clip)
    got = b"".join(f.tobytes() for f in frames)
    assert len(oracle_yuv) == len(got)
    if oracle_yuv != got:
        fb = cfg.frame_bytes
        for i in range(len(frames)):
            a = oracle_yuv[i * fb:(i + 1) * fb]
            b = got[i * fb:(i + 1) * fb]
            assert a == b, f"first mismatching frame: {i}"
    assert oracle_yuv == got


def test_mv_chain_wrap_conformance(oracle_bin, tmp_path):
    """Extreme MV targets through 16-bit escapes drive the prediction
    chain past the s16 range: every implementation must apply the
    normative wrap (FORMAT.md §7.2) identically — Python planner + golden
    vs C oracle here, and the native planner below."""
    from hvqm4_jax.native import NativePlanner
    from hvqm4_jax.planner import Planner

    cfg = SeqConfig(64, 48)
    for seed in (300, 301, 302):
        clip = make_clip(cfg, ["IPBPB", "IPP"], seed=seed, mv_extreme=True)
        oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
        got = b"".join(f.tobytes() for f in golden_decode(cfg, clip))
        assert oracle_yuv == got, f"seed {seed}"
        # the two host planners resolve identical (wrapped) vectors
        from hvqm4_jax.container import Demuxer

        ppl, npl = Planner(cfg), NativePlanner(cfg)
        for r in Demuxer(clip).video_records():
            a = ppl.plan_frame(r.frame_char, r.payload)
            b = npl.plan_frame(r.frame_char, r.payload)
            for pa, pb in zip(a.planes, b.planes):
                assert (pa.mv == pb.mv).all() and (pa.mv2 == pb.mv2).all()


def test_reserved_fields_rejected(oracle_bin, tmp_path):
    """Nonzero reserved frame-header bytes / nonempty stream 5 are invalid
    (FORMAT.md §10): every implementation rejects, none crashes."""
    import subprocess

    from hvqm4_jax.native import NativePlanner
    from hvqm4_jax.planner import Planner, PlannerError

    cfg = SeqConfig(32, 16)
    clip = make_clip(cfg, ["IP"], seed=303)
    payload_off = 0x44 + 8 + 8          # header + block header + record header
    for off, name in ((payload_off + 10, "reserved header field"),
                      (payload_off + 12 + 4 * 5, "stream 5 size")):
        bad = bytearray(clip)
        bad[off] = 0x01
        bad = bytes(bad)
        from hvqm4_jax.container import Demuxer

        rec = next(iter(Demuxer(bad).video_records()))
        for planner in (Planner(cfg), NativePlanner(cfg)):
            with pytest.raises(PlannerError, match="reserved"):
                planner.plan_frame(rec.frame_char, rec.payload)
        p = tmp_path / "bad.h4m"
        p.write_bytes(bad)
        r = subprocess.run([str(oracle_bin), str(p), str(tmp_path / "o.yuv")],
                           capture_output=True, text=True)
        assert r.returncode == 1 and "reserved" in r.stderr, (name, r.stderr)


def test_huffman_tree_caps():
    """Trees beyond the normative depth/size caps are invalid streams."""
    from hvqm4_jax.bitio import BitReader, BitWriter, read_tree, write_tree

    # 66-deep right comb
    deep = 0
    for _ in range(66):
        deep = (1, deep)
    w = BitWriter()
    write_tree(w, deep)
    with pytest.raises(ValueError, match="too deep"):
        read_tree(BitReader(w.getvalue()))
    # > 1024 internal nodes at depth <= 64: a 32-long comb of 32-internal
    # subtrees (32*33 = 1056 internals, max node depth 64)
    sub = 0
    for _ in range(32):
        sub = (sub, 1)
    wide = 0
    for _ in range(32):
        wide = (sub, wide)
    w = BitWriter()
    write_tree(w, wide)
    with pytest.raises(ValueError, match="too large"):
        read_tree(BitReader(w.getvalue()))


def test_many_seeds(oracle_bin, tmp_path):
    """Seed sweep on a small clip shape — broad random path coverage."""
    cfg = SeqConfig(64, 48)
    for seed in range(20):
        clip = make_clip(cfg, ["IPBPB"], seed=100 + seed)
        oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
        got = b"".join(f.tobytes() for f in golden_decode(cfg, clip))
        assert oracle_yuv == got, f"seed {seed}"
