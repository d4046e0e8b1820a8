"""Sliced-entropy extension (FORMAT.md §9): conformance + parallel planning.

Slices make the host entropy pass parallelizable (the scaling keystone for
the ≥100x target); these tests pin:
- oracle vs Python golden bit-exactness on sliced streams,
- native(C++) vs Python planner plan equality, single- and multi-threaded,
- prediction-chain resets at slice boundaries (structural),
- rejection of malformed slice tables.
"""

import os
import struct

import numpy as np
import pytest

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.container import Demuxer
from hvqm4_jax.planner import Planner, PlannerError
from tools.encoder import make_clip

from .conftest import golden_decode, run_oracle

CASES = [
    (64, 48, 2, ["IPBPB", "IPP"], 2, 61),
    (64, 48, 2, ["IPBPB"], 3, 62),
    (128, 96, 2, ["IBBPBP"], 8, 63),
    (96, 96, 1, ["IPB"], 4, 64),
    (64, 48, 2, ["I"], 6, 65),          # S == mh (one MB row per slice)
    (48, 64, 1, ["IPB"], 5, 66),        # portrait
]


@pytest.mark.parametrize("w,h,samp,gops,slices,seed", CASES)
def test_sliced_oracle_matches_golden(oracle_bin, tmp_path, w, h, samp, gops,
                                      slices, seed):
    cfg = SeqConfig(w, h, samp, samp)
    clip = make_clip(cfg, gops, seed=seed, slices=slices)
    oracle_yuv = run_oracle(oracle_bin, clip, tmp_path)
    got = b"".join(f.tobytes() for f in golden_decode(cfg, clip))
    assert got == oracle_yuv


@pytest.mark.parametrize("slices", [2, 4])
@pytest.mark.parametrize("threads", ["1", "4"])
def test_sliced_native_matches_python(slices, threads, monkeypatch):
    native = pytest.importorskip("hvqm4_jax.native")
    monkeypatch.setenv("HVQM4_PLANNER_THREADS", threads)
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPBPB"], seed=70 + slices, slices=slices)
    py = Planner(cfg)
    nat = native.NativePlanner(cfg)
    for r in Demuxer(clip).video_records():
        a = py.plan_frame(r.frame_char, r.payload)
        b = nat.plan_frame(r.frame_char, r.payload)
        assert a == b, f"{r.frame_char} frame, S={slices}, threads={threads}"


def test_slice_count_exceeding_mb_rows_rejected():
    cfg = SeqConfig(64, 48)  # mh = 6
    clip = make_clip(cfg, ["I"], seed=80)
    payload = bytearray(next(Demuxer(clip).video_records()).payload)
    payload[9] = 7  # S > mh, and no sub-table present
    with pytest.raises(PlannerError):
        Planner(cfg).plan_frame("I", bytes(payload))


def test_bad_segment_sums_rejected():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["I"], seed=81, slices=2)
    payload = bytearray(next(Demuxer(clip).video_records()).payload)
    # corrupt the first segment size in the sub-table
    (v,) = struct.unpack_from(">I", payload, 36)
    struct.pack_into(">I", payload, 36, v + 1)
    with pytest.raises(PlannerError):
        Planner(cfg).plan_frame("I", bytes(payload))


def test_sliced_fuzz_no_crashes(oracle_bin, tmp_path):
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPB"], seed=82, slices=3)
    rng = np.random.default_rng(0)
    pl = Planner(cfg)
    payloads = [r.payload for r in Demuxer(clip).video_records()]
    for _ in range(200):
        p = bytearray(payloads[int(rng.integers(0, len(payloads)))])
        for _ in range(int(rng.integers(1, 8))):
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
        try:
            pl.plan_frame("IPB"[int(rng.integers(0, 3))], bytes(p))
        except (PlannerError, EOFError):
            pass


def test_sliced_threaded_device_path_matches_oracle(oracle_bin, tmp_path,
                                                    monkeypatch):
    """Threaded slice planning through the production arena path.

    With HVQM4_PLANNER_THREADS > 1 the C planner allocates pool slots in
    nondeterministic order and must compact them back to the canonical
    numbering the device recomputes from meta (`_derive_slots`); a
    mismatch anywhere shows up as wrong pixels here.
    """
    native = pytest.importorskip("hvqm4_jax.native")
    from hvqm4_jax.parallel.multistream import MultiStreamDecoder
    from .conftest import run_oracle

    monkeypatch.setenv("HVQM4_PLANNER_THREADS", "4")
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPBPB", "IPP"], seed=90, slices=4)
    want = run_oracle(oracle_bin, clip, tmp_path)
    ms = MultiStreamDecoder(cfg, [clip],
                            planner_factory=native.NativePlanner)
    got = []
    for frames, _metas, valid in ms.run_pipelined():
        if valid[0]:
            got.append(b"".join(
                np.asarray(frames[pi][0]).tobytes() for pi in range(3)))
    assert b"".join(got) == want
