"""Native (C++) planner vs Python planner: identical FramePlans, and speed."""

import time

import numpy as np
import pytest

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.container import Demuxer
from hvqm4_jax.planner import Planner, PlannerError
from tools.encoder import make_clip

native = pytest.importorskip("hvqm4_jax.native")


CASES = [
    (64, 48, 2, ["IPBPB", "IPP"], 21),
    (48, 64, 1, ["IPBPB"], 22),
    (320, 240, 2, ["IBBPBP"], 23),
]


@pytest.mark.parametrize("w,h,samp,gops,seed", CASES)
def test_native_matches_python(w, h, samp, gops, seed):
    cfg = SeqConfig(w, h, samp, samp)
    clip = make_clip(cfg, gops, seed=seed)
    py = Planner(cfg)
    nat = native.NativePlanner(cfg)
    for r in Demuxer(clip).video_records():
        a = py.plan_frame(r.frame_char, r.payload)
        b = nat.plan_frame(r.frame_char, r.payload)
        assert a == b, f"plan mismatch on {r.frame_char} frame"


def test_native_rejects_corrupt():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPB"], seed=24)
    payloads = [r.payload for r in Demuxer(clip).video_records()]
    nat = native.NativePlanner(cfg)
    rng = np.random.default_rng(0)
    for _ in range(200):
        p = bytearray(payloads[int(rng.integers(0, len(payloads)))])
        for _ in range(int(rng.integers(1, 8))):
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
        try:
            nat.plan_frame("IPB"[int(rng.integers(0, 3))], bytes(p))
        except PlannerError:
            pass


def test_native_speedup():
    cfg = SeqConfig(320, 240)
    clip = make_clip(cfg, ["I" * 3], seed=25)
    recs = list(Demuxer(clip).video_records())
    nat = native.NativePlanner(cfg)
    py = Planner(cfg)

    t0 = time.perf_counter()
    for r in recs:
        nat.plan_frame(r.frame_char, r.payload)
    t_nat_per_frame = (time.perf_counter() - t0) / len(recs)
    t0 = time.perf_counter()
    py.plan_frame(recs[0].frame_char, recs[0].payload)
    t_py_per_frame = time.perf_counter() - t0
    # conservative bound; typical is >100x
    assert t_nat_per_frame < t_py_per_frame / 5, (t_nat_per_frame, t_py_per_frame)
