"""Multi-stream vmap decode (BASELINE config 4) and mesh sharding tests."""

import jax
import numpy as np

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.parallel.multistream import MultiStreamDecoder, shard_streams
from hvqm4_jax.session import DecoderSession
from tools.encoder import make_clip

CFG = SeqConfig(64, 48)


def _single_stream_frames(cfg, clip):
    sess = DecoderSession(cfg)
    return [f.yuv_bytes() for f in sess.decode_clip(clip)]


def _multi_frames(cfg, clips, sharding=None):
    ms = MultiStreamDecoder(cfg, clips, sharding=sharding)
    per_stream = [[] for _ in clips]
    while True:
        out = ms.step()
        if out is None:
            break
        frames, plans, valid = out
        fnp = [np.asarray(p) for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                per_stream[si].append(
                    b"".join(fnp[pi][si].tobytes() for pi in range(3)))
    return per_stream


def test_multistream_matches_single():
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=s) for s in (1, 2)]
    clips.append(make_clip(CFG, ["IPP"], seed=3))  # shorter: masks out early
    expected = [_single_stream_frames(CFG, c) for c in clips]
    got = _multi_frames(CFG, clips)
    for si in range(len(clips)):
        assert got[si] == expected[si], f"stream {si}"


def _pipelined_frames(cfg, clips, **kw):
    ms = MultiStreamDecoder(cfg, clips, **kw)
    per_stream = [[] for _ in clips]
    for frames, _metas, valid in ms.run_pipelined():
        fnp = [np.asarray(p) for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                per_stream[si].append(
                    b"".join(fnp[pi][si].tobytes() for pi in range(3)))
    return per_stream


def test_fused_dispatch_matches_single():
    """K-step fused dispatch (lax.scan superstep) decodes identically,
    including a clip length that is not a multiple of K and a shorter
    stream masking out mid-superstep."""
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=11) for _ in range(2)]
    clips.append(make_clip(CFG, ["IPP"], seed=12))  # 3 frames: tail filler
    expected = [_single_stream_frames(CFG, c) for c in clips]
    for k in (2, 4):
        got = _pipelined_frames(CFG, clips, steps_per_dispatch=k)
        for si in range(len(clips)):
            assert got[si] == expected[si], f"K={k} stream {si}"


def test_fused_dispatch_native_planner():
    from hvqm4_jax.native import NativePlanner

    clips = [make_clip(CFG, ["IBBPBP", "IPP"], seed=13) for _ in range(3)]
    expected = [_single_stream_frames(CFG, c) for c in clips]
    got = _pipelined_frames(CFG, clips, steps_per_dispatch=3,
                            planner_factory=NativePlanner)
    for si in range(len(clips)):
        assert got[si] == expected[si], f"stream {si}"


def test_stage_packed_bitexact():
    """Packed-pass replay (one h2d per dtype, device-side slices feeding
    the per-variant executables) decodes bit-exactly vs per-step staging
    — including fused dispatch and a re-used packed buffer."""
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=21) for _ in range(2)]
    for k in (1, 2):
        ms = MultiStreamDecoder(CFG, clips, steps_per_dispatch=k)
        bufs, expected = [], []
        while any(ms.active):
            buf, _metas, _valid = ms.plan_step()
            bufs.append(ms.snapshot_step(buf))
            ms._cur ^= 1
        ms2 = MultiStreamDecoder(CFG, clips, steps_per_dispatch=k)
        for b in bufs:
            expected.append(
                [np.asarray(p).copy() for p in ms2.device_step(dict(b))])
        for reuse in (None, "again"):
            ms3 = MultiStreamDecoder(CFG, clips, steps_per_dispatch=k)
            packed = ms3.stage_packed(
                bufs, packed if reuse else None) if reuse else \
                ms3.stage_packed(bufs)
            got = [[np.asarray(p).copy() for p in ms3.device_step(b)]
                   for b in bufs]
            for st, (e, g) in enumerate(zip(expected, got)):
                for pi in range(3):
                    assert np.array_equal(e[pi], g[pi]), \
                        f"K={k} step {st} plane {pi} reuse={bool(reuse)}"


def test_fused_dispatch_poisons_failed_stream_only():
    good = make_clip(CFG, ["IPPPP"], seed=14)
    bad = bytearray(make_clip(CFG, ["IPPPP"], seed=15))
    for i in range(len(bad) // 2, len(bad) // 2 + 40):
        bad[i] ^= 0xA5
    results = _pipelined_frames(CFG, [good, bytes(bad)],
                                steps_per_dispatch=2)
    assert results[0] == _single_stream_frames(CFG, good)
    assert len(results[1]) <= 5


def test_multistream_poisons_failed_stream_only():
    good = make_clip(CFG, ["IPP"], seed=4)
    bad = bytearray(make_clip(CFG, ["IPP"], seed=5))
    # corrupt the middle of the file body (frame payloads)
    for i in range(len(bad) // 2, len(bad) // 2 + 40):
        bad[i] ^= 0xA5
    ms = MultiStreamDecoder(CFG, [good, bytes(bad)])
    results = _multi_frames(CFG, [good, bytes(bad)])
    assert results[0] == _single_stream_frames(CFG, good)
    # bad stream produced at most a prefix before being poisoned
    assert len(results[1]) <= 3


def test_sharded_multistream_matches():
    """8 streams over the 8-device CPU mesh: same bytes as unsharded."""
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    assert devs.size == 8, "conftest must provide 8 virtual devices"
    mesh = Mesh(devs, ("dp",))
    clips = [make_clip(CFG, ["IPB"], seed=10 + s) for s in range(8)]
    expected = _multi_frames(CFG, clips)
    got = _multi_frames(CFG, clips, sharding=shard_streams(mesh))
    assert got == expected


def test_sharded_multigop_bitexact_native():
    """dp=4 mesh, 8 streams (2 per shard), multi-GOP P/B clips through the
    native planner + pipelined overlap: every stream, every frame identical
    to single-stream decode. This is the unified arena path under shard_map —
    the same code `bench.py` runs single-chip."""
    from jax.sharding import Mesh

    from hvqm4_jax.native import NativePlanner

    devs = np.array(jax.devices())[:4]
    mesh = Mesh(devs, ("dp",))
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=20 + s) for s in range(8)]
    expected = [_single_stream_frames(CFG, c) for c in clips]
    got = _pipelined_frames(CFG, clips, sharding=shard_streams(mesh),
                            planner_factory=NativePlanner)
    assert got == expected


def test_sharded_fused_dispatch():
    """K=2 fused dispatch (lax.scan superstep) under a dp=2 mesh: state
    rotation across fused steps is per-shard and must match single-stream."""
    from jax.sharding import Mesh

    devs = np.array(jax.devices())[:2]
    mesh = Mesh(devs, ("dp",))
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=30 + s) for s in range(4)]
    expected = [_single_stream_frames(CFG, c) for c in clips]
    got = _pipelined_frames(CFG, clips, sharding=shard_streams(mesh),
                            steps_per_dispatch=2)
    assert got == expected


def test_sharded_poisons_failed_stream_only():
    """A corrupt stream on one shard must not disturb streams on any shard."""
    from jax.sharding import Mesh

    devs = np.array(jax.devices())[:2]
    mesh = Mesh(devs, ("dp",))
    clips = [make_clip(CFG, ["IPPPP"], seed=40 + s) for s in range(4)]
    bad = bytearray(clips[2])
    for i in range(len(bad) // 2, len(bad) // 2 + 40):
        bad[i] ^= 0xA5
    clips[2] = bytes(bad)
    got = _pipelined_frames(CFG, clips, sharding=shard_streams(mesh))
    for si in (0, 1, 3):
        assert got[si] == _single_stream_frames(CFG, clips[si]), f"stream {si}"
    assert len(got[2]) <= 5


def test_sharded_stream_count_must_divide():
    from jax.sharding import Mesh

    import pytest

    devs = np.array(jax.devices())[:4]
    mesh = Mesh(devs, ("dp",))
    clips = [make_clip(CFG, ["IP"], seed=50 + s) for s in range(6)]
    with pytest.raises(ValueError, match="divisible"):
        MultiStreamDecoder(CFG, clips, sharding=shard_streams(mesh))


def _corrupt_second_block_stream_table(clip: bytes) -> bytes:
    """Deterministic poison: overwrite the second GOP block's first video
    frame's stream-size table entry with 0xFFFFFFFF ('stream overruns
    payload', FORMAT.md §4) — every planner rejects it."""
    import struct

    body = 0x44
    (len0,) = struct.unpack_from(">I", clip, body)
    blk1 = body + 8 + len0            # second block header
    rec = blk1 + 8                    # first record header (">HHI")
    payload = rec + 8
    sizes_off = payload + 12          # frame-local header is 12 bytes
    out = bytearray(clip)
    struct.pack_into(">I", out, sizes_off, 0xFFFFFFFF)
    return bytes(out)


def test_fused_dispatch_native_keeps_prefailure_frames():
    """Native fused dispatch must keep the frames a failing stream planned
    BEFORE the corrupt one (same contract as the Python fallback)."""
    from hvqm4_jax.native import NativePlanner

    good = make_clip(CFG, ["IPP", "IPP"], seed=45)
    bad = _corrupt_second_block_stream_table(good)
    got = _pipelined_frames(CFG, [good, bad], steps_per_dispatch=3,
                            planner_factory=NativePlanner)
    want = _single_stream_frames(CFG, good)
    assert got[0] == want
    # the corrupt stream still yields its first GOP (3 frames), decoded
    # identically, before the poison lands at frame 4
    assert got[1] == want[:3], (len(got[1]), "expected the intact prefix")


def test_gop_parallel_skips_poisoned_lane():
    """A corrupt GOP block drops only its lane's frames; every other
    block's frames still stream out in decode order."""
    clip = make_clip(CFG, ["IPP", "IPP", "IPP"], seed=46)
    bad = _corrupt_second_block_stream_table(clip)
    from hvqm4_jax.parallel.multistream import decode_clip_gop_parallel
    from hvqm4_jax.planner import Planner

    want = _single_stream_frames(CFG, clip)
    got = list(decode_clip_gop_parallel(bad, max_streams=3,
                                        planner_factory=Planner))
    got_blocks = [bi for bi, _ in got]
    assert 1 not in got_blocks            # the poisoned block is skipped
    assert got_blocks.count(0) == 3 and got_blocks.count(2) == 3
    by_block = {0: want[0:3], 2: want[6:9]}
    for bi in (0, 2):
        frames = [yuv for b, yuv in got if b == bi]
        assert frames == by_block[bi], f"block {bi}"


def test_gop_parallel_matches_sequential():
    from hvqm4_jax.parallel.multistream import decode_clip_gop_parallel
    from hvqm4_jax.planner import Planner

    clip = make_clip(CFG, ["IPB", "IPP", "IB" + "P" * 3, "I"], seed=77)
    want = _single_stream_frames(CFG, clip)
    got = [yuv for _bi, yuv in decode_clip_gop_parallel(
        clip, max_streams=3, planner_factory=Planner)]
    assert got == want


def test_tiny_frame_pool_tiers():
    """Frames whose pools are smaller than the 64-slot tier floor must not
    slice past the arena (regression: 16x16 raw pool is 24 slots)."""
    cfg = SeqConfig(16, 16)
    clips = [make_clip(cfg, ["IPB"], seed=97)]
    got = _multi_frames(cfg, clips)
    assert got[0] == _single_stream_frames(cfg, clips[0])


def test_gop_rejects_b_without_two_references():
    """Patterns whose decode order yields a B before two anchors are
    rejected at the encoder (FORMAT.md §10 makes such streams invalid)."""
    import pytest

    from hvqm4_jax.gop import reorder_display_to_decode

    for bad in ("IB", "IBB", "B"):
        with pytest.raises(ValueError, match="references|frame type"):
            reorder_display_to_decode(bad)
    assert reorder_display_to_decode("IPB") == [("I", 0), ("P", 1), ("B", 2)]
    assert reorder_display_to_decode("IB" + "P" * 2) == [
        ("I", 0), ("P", 2), ("B", 1), ("P", 3)]


def test_multistream_poisons_b_without_references():
    """A stream whose records present a B before two anchors (possible via
    hand-built record lists / hostile containers) is poisoned, matching the
    oracle's rejection — frames before the invalid one still decode."""
    from hvqm4_jax.container import Demuxer

    clip = make_clip(CFG, ["IPB"], seed=88)
    recs = [(r.block_index, r.frame_char, r.payload)
            for r in Demuxer(clip).video_records()]
    bad_lane = [recs[0], recs[2]]           # I then B: one anchor only
    ms = MultiStreamDecoder(CFG, [], record_lists=[bad_lane])
    decoded = 0
    while True:
        out = ms.step()
        if out is None:
            break
        _frames, _metas, valid = out
        decoded += sum(valid)
    assert ms.streams[0].failed
    assert decoded == 1  # the I frame; the invalid B poisoned the stream


# ---------------------------------------------------------------------------
# Round-3 staging-variant coverage (sparse dc pool, packed meta/mv tiers)
# ---------------------------------------------------------------------------

def test_wide_mv_variant_bitexact():
    """mv_extreme clips overflow the s8 packed tiers -> the step must pick
    the WIDE (two u32/MB) variant and still decode bit-exact."""
    from hvqm4_jax.parallel.multistream import _MV_WIDE

    clips = [make_clip(CFG, ["IPPP"], seed=s, mv_extreme=True)
             for s in (5, 6)]
    expected = [_single_stream_frames(CFG, c) for c in clips]
    ms = MultiStreamDecoder(CFG, clips)
    per_stream = [[] for _ in clips]
    saw_wide = False
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        saw_wide |= buf["variant"][2] == _MV_WIDE
        frames = ms.device_step(buf)
        ms._cur ^= 1
        fnp = [np.asarray(p) for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                per_stream[si].append(
                    b"".join(fnp[pi][si].tobytes() for pi in range(3)))
    assert saw_wide, "mv_extreme clip never selected the WIDE variant"
    for si in range(len(clips)):
        assert per_stream[si] == expected[si], f"stream {si}"


def test_packed8_variant_on_p_steps():
    """P-only steps with small vectors pick PACKED8 (2 MBs/u32, no second
    vector) and I steps pick NONE + carry the nest."""
    from hvqm4_jax.parallel.multistream import _MV_NONE, _MV_PACKED8

    clip = make_clip(CFG, ["IPPP"], seed=9)
    expected = _single_stream_frames(CFG, clip)
    ms = MultiStreamDecoder(CFG, [clip, clip])
    got = []
    modes = []
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        modes.append((buf["variant"][2], buf["variant"][3]))  # (mv, nest)
        frames = ms.device_step(buf)
        ms._cur ^= 1
        fnp = [np.asarray(p) for p in frames]
        if valid[0]:
            got.append(b"".join(fnp[pi][0].tobytes() for pi in range(3)))
    assert got == expected
    assert modes[0] == (_MV_NONE, True)          # I step: no mv, nest ships
    assert all(m[1] is False for m in modes[1:])  # P steps: no nest field
    assert any(m[0] == _MV_PACKED8 for m in modes[1:])


def test_odd_chroma_block_width():
    """width=40 -> 4:2:0 chroma block grid is 5 wide (odd): the 5-per-u32
    meta packing and pool cumsums must handle non-multiple block counts."""
    cfg = SeqConfig(40, 48)
    clips = [make_clip(cfg, ["IPBPB"], seed=s) for s in (11, 12)]
    expected = [_single_stream_frames(cfg, c) for c in clips]
    got = _pipelined_frames(cfg, clips)
    for si in range(len(clips)):
        assert got[si] == expected[si], f"stream {si}"


def test_fused_dispatch_upload_not_inflated():
    """v5 offset-packed pools invariant: fusing K steps into one dispatch
    must not inflate the uploaded bytes beyond the per-step sum plus the
    size-ladder quantization (~12.5% worst per region). The v4 layout
    violated this badly — a window-max tier applied to every slot made an
    I frame inflate all n*K slots' dc region 64x (measured 92.6 vs 55.6
    KB/frame on retail content at K=8)."""
    from hvqm4_jax.native import NativePlanner

    clips = [make_clip(CFG, ["IPBPBPBP", "IPPP"], seed=s) for s in (3, 4)]

    def total_bytes(k):
        ms = MultiStreamDecoder(CFG, clips, planner_factory=NativePlanner,
                                steps_per_dispatch=k)
        tot = 0
        while any(ms.active):
            buf, _m, _v = ms.plan_step()
            s8, s32 = buf["sizes"]
            tot += s8 + s32 * 4
            ms._cur ^= 1
        return tot

    t1, t4 = total_bytes(1), total_bytes(4)
    # K=4 windows mix the I step with inter steps (the v4 worst case);
    # allow ladder quantization + per-window mv/nest-flag widening
    assert t4 < 1.3 * t1, f"fused upload inflated: K=4 {t4} vs K=1 {t1}"


def test_trivial_filler_consumes_no_pools():
    """Finished streams' filler slots must not claim pool slots (an
    all-intra filler would add a dc-pool byte per block and blow the
    step's dc tier)."""
    long = make_clip(CFG, ["IPPPPP"], seed=1)
    short = make_clip(CFG, ["IPP"], seed=2)
    ms = MultiStreamDecoder(CFG, [long, short])
    dc_useds = []
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        if not valid[1]:  # short stream finished -> filler slot in play
            dc_useds.append(int(buf["slot_used"][ms._slot(1, 0)][2]))
        ms.device_step(buf)
        ms._cur ^= 1
    assert dc_useds and all(d == 0 for d in dc_useds)


# -- planning worker pool / prefetch ring (ROADMAP "multi-core host") --------

def test_prefetch_pool_matches_single():
    """plan_ahead > 1 with concurrent planning workers decodes identically:
    the staging ring and out-of-order heavy planning must not change a
    byte (job dequeue stays serial; only entropy work fans out)."""
    clips = [make_clip(CFG, ["IPBPB", "IPP"], seed=61) for _ in range(2)]
    clips.append(make_clip(CFG, ["IPP"], seed=62))  # shorter: masks out early
    expected = [_single_stream_frames(CFG, c) for c in clips]
    for k, depth in ((1, 3), (2, 2)):
        got = _pipelined_frames(CFG, clips, steps_per_dispatch=k,
                                plan_ahead=depth)
        for si in range(len(clips)):
            assert got[si] == expected[si], f"K={k} depth={depth} stream {si}"


def test_prefetch_pool_native_planner():
    from hvqm4_jax.native import NativePlanner

    clips = [make_clip(CFG, ["IBBPBP", "IPP"], seed=63) for _ in range(3)]
    expected = [_single_stream_frames(CFG, c) for c in clips]
    ms = MultiStreamDecoder(CFG, clips, planner_factory=NativePlanner,
                            plan_ahead=3)
    per_stream = [[] for _ in clips]
    for frames, _metas, valid in ms.run_pipelined(plan_workers=2):
        fnp = [np.asarray(p) for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                per_stream[si].append(
                    b"".join(fnp[pi][si].tobytes() for pi in range(3)))
    for si in range(len(clips)):
        assert per_stream[si] == expected[si], f"stream {si}"


def test_prefetch_pool_poisons_failed_stream_only():
    """With lookahead, a stream that poisons at step t may already have
    frames dequeued into steps > t; those must come back masked invalid —
    the caller-visible validity equals the depth-1 path's."""
    good = make_clip(CFG, ["IPPPPPPP"], seed=64)
    bad = bytearray(make_clip(CFG, ["IPPPPPPP"], seed=65))
    for i in range(len(bad) // 2, len(bad) // 2 + 40):
        bad[i] ^= 0xA5
    clips = [good, bytes(bad)]
    baseline = _pipelined_frames(CFG, clips)  # depth-1 reference
    got = _pipelined_frames(CFG, clips, plan_ahead=4)
    assert got[0] == _single_stream_frames(CFG, good)
    assert got[1] == baseline[1]  # same valid prefix, nothing after poison


def test_ring_cursor_continues_after_pipelined_run():
    """run_pipelined advances self._cur (not a local cursor): a later
    plan_step()/step() on the same decoder must stage into the NEXT ring
    slot, never rewrite the slot consumed by the run's final device_step."""
    clip = make_clip(CFG, ["IPPP"], seed=77)
    ms = MultiStreamDecoder(CFG, [clip, clip])
    ring = len(ms._bufs)
    start = ms._cur
    steps = sum(1 for _ in ms.run_pipelined())
    assert steps == 4
    assert ms._cur == (start + steps) % ring


def test_hd_resolution_bitexact(oracle_bin, tmp_path):
    """1280x720 through the production path (native planner, sliced entropy,
    threaded planning): the pool-tier ladder, slice sub-tables, and arena
    sizing must hold at HD scale, not just the suite's small frames."""
    import os

    cfg = SeqConfig(1280, 720)
    clip = make_clip(cfg, ["IPBPB"], seed=321, slices=8)
    old = os.environ.get("HVQM4_PLANNER_THREADS")
    os.environ["HVQM4_PLANNER_THREADS"] = "2"
    try:
        ms = MultiStreamDecoder(cfg, [clip])
        got = b""
        for frames, _m, valid in ms.run_pipelined():
            if valid[0]:
                got += b"".join(np.asarray(frames[pi])[0].tobytes()
                                for pi in range(3))
    finally:
        if old is None:
            os.environ.pop("HVQM4_PLANNER_THREADS", None)
        else:
            os.environ["HVQM4_PLANNER_THREADS"] = old
    from .conftest import run_oracle

    assert got == run_oracle(oracle_bin, clip, tmp_path)


def test_per_mb_mv_grid_matches_oracle(oracle_bin, tmp_path):
    """The arena path carries motion vectors per MACROBLOCK and expands
    them in-jit; a tiny I/P/B clip through `run_pipelined` equals the
    C oracle byte for byte."""
    from .conftest import run_oracle

    cfg = SeqConfig(32, 16)
    clip = make_clip(cfg, ["IPB"], seed=78)
    (got,) = _pipelined_frames(cfg, [clip])
    assert b"".join(got) == run_oracle(oracle_bin, clip, tmp_path)
