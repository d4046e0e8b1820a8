"""Fuzzing (SURVEY.md §4.5): malformed input must be *rejected*, never crash.

- Python layers raise ContainerError/PlannerError (or controlled EOFError) —
  no unhandled IndexError/segfault-class failures.
- The ASan+UBSan oracle build must exit(1) cleanly on the same inputs
  (sanitizer aborts would exit with a different status and a report).
"""

import subprocess

import numpy as np
import pytest

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.container import ContainerError, Demuxer
from hvqm4_jax.planner import Planner, PlannerError
from tools.encoder import make_clip

from .conftest import REPO


def _mutate(data: bytes, rng, n_mut: int) -> bytes:
    buf = bytearray(data)
    for _ in range(n_mut):
        i = int(rng.integers(0, len(buf)))
        buf[i] = int(rng.integers(0, 256))
    return bytes(buf)


def test_planner_rejects_random_payloads():
    cfg = SeqConfig(64, 48)
    pl = Planner(cfg)
    rng = np.random.default_rng(0)
    rejected = 0
    for _ in range(200):
        payload = rng.integers(0, 256, size=int(rng.integers(0, 400)),
                               dtype=np.uint8).tobytes()
        try:
            pl.plan_frame("I", payload)
        except (PlannerError, EOFError):
            rejected += 1
    assert rejected > 150  # nearly all random blobs are invalid


def test_planner_survives_bitflips():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPB"], seed=3)
    d = Demuxer(clip)
    payloads = [r.payload for r in d.video_records()]
    pl = Planner(cfg)
    rng = np.random.default_rng(1)
    for _ in range(300):
        p = bytearray(payloads[int(rng.integers(0, len(payloads)))])
        for _ in range(int(rng.integers(1, 8))):
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
        try:
            pl.plan_frame("IPB"[int(rng.integers(0, 3))], bytes(p))
        except (PlannerError, EOFError):
            pass  # rejection is the correct outcome


def test_demuxer_rejects_corrupt_headers():
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["I"], seed=4)
    rng = np.random.default_rng(2)
    rejected = 0
    for _ in range(200):
        mutated = _mutate(clip, rng, int(rng.integers(1, 6)))
        try:
            d = Demuxer(mutated)
            for r in d.records():
                pass
        except ContainerError:
            rejected += 1
    # Most mutations land in payloads (not demuxer territory); what matters is
    # that structural hits are caught and nothing ever crashes.
    assert rejected > 5


@pytest.fixture(scope="module")
def asan_oracle():
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle"), "asan"],
                   check=True)
    return REPO / "oracle" / "hvqm4_oracle_asan"


def test_oracle_sanitizer_clean_on_fuzz(asan_oracle, tmp_path):
    """Mutated clips: oracle must exit 0 (valid) or 1 (rejected) — never a
    sanitizer abort / signal."""
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPB"], seed=5, audio_channels=1)
    rng = np.random.default_rng(3)
    for i in range(60):
        mutated = _mutate(clip, rng, int(rng.integers(1, 10)))
        p = tmp_path / "fuzz.h4m"
        p.write_bytes(mutated)
        res = subprocess.run([str(asan_oracle), str(p), "/dev/null"],
                             capture_output=True)
        assert res.returncode in (0, 1), (
            f"iter {i}: rc={res.returncode}\n{res.stderr.decode()[:2000]}")


def test_oracle_sanitizer_clean_on_sliced_fuzz(asan_oracle, tmp_path):
    """Same contract for the sliced layout (FORMAT.md §9), whose sub-table
    adds structural surface."""
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPB"], seed=6, slices=3)
    rng = np.random.default_rng(4)
    for i in range(60):
        mutated = _mutate(clip, rng, int(rng.integers(1, 10)))
        p = tmp_path / "fuzz_sliced.h4m"
        p.write_bytes(mutated)
        res = subprocess.run([str(asan_oracle), str(p), "/dev/null"],
                             capture_output=True)
        assert res.returncode in (0, 1), (
            f"iter {i}: rc={res.returncode}\n{res.stderr.decode()[:2000]}")


def test_oracle_sanitizer_clean_on_sliced_audio_fuzz(asan_oracle, tmp_path):
    """The sliced+audio CROSS (TESTING.md battery extension): slice
    sub-tables and audio records together cover every record kind the
    container can interleave; mutations must still land on exit 0/1 with
    `--audio` decode active, never a sanitizer abort."""
    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPBPB", "IPP"], seed=7, slices=3,
                     audio_channels=2)
    rng = np.random.default_rng(5)
    for i in range(80):
        mutated = _mutate(clip, rng, int(rng.integers(1, 12)))
        p = tmp_path / "fuzz_sa.h4m"
        p.write_bytes(mutated)
        res = subprocess.run(
            [str(asan_oracle), "--audio", str(tmp_path / "a.pcm"),
             str(p), "/dev/null"],
            capture_output=True)
        assert res.returncode in (0, 1), (
            f"iter {i}: rc={res.returncode}\n{res.stderr.decode()[:2000]}")


def test_native_planner_survives_sliced_audio_bitflips():
    """Mirror battery for the production C++ planner: mutated payloads from
    a sliced+audio clip must raise PlannerError (or decode) — never crash
    the process. Exercises the slice sub-table parser, the threaded-slice
    pool compaction, and the round-3 word-cursor aux reader."""
    from hvqm4_jax.native import NativePlanner

    cfg = SeqConfig(64, 48)
    clip = make_clip(cfg, ["IPBPB", "IPP"], seed=8, slices=3,
                     audio_channels=2)
    payloads = [(r.frame_char, r.payload)
                for r in Demuxer(clip).video_records()]
    pl = NativePlanner(cfg)
    rng = np.random.default_rng(6)
    decoded = rejected = 0
    for _ in range(300):
        fchar, payload = payloads[int(rng.integers(0, len(payloads)))]
        p = bytearray(payload)
        for _ in range(int(rng.integers(1, 8))):
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
        try:
            pl.plan_frame(fchar, bytes(p))
            decoded += 1
        except PlannerError:
            rejected += 1
    assert decoded + rejected == 300 and rejected > 50
