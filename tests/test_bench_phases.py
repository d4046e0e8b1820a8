"""bench.py's phase contract on the CPU: each `--phase X` runs on the
platform JAX picks (the suite's JAX_PLATFORMS=cpu, inherited from
conftest) and emits one JSON line, while `main()` refuses to measure
anything but a GPU."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_phase_link_emits_json():
    """--phase link must emit its probe fields on any backend (on the CPU
    it measures host memcpy, which is fine — the field contract, not the
    number, is what the bench relies on)."""
    r = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--phase", "link"],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["link_h2d_gbps"] > 0
    assert len(out["link_h2d_gbps_samples"]) == 3
    assert out["link_rtt_ms"] >= 0


def test_phase_plan_emits_json():
    env = dict(os.environ,
               HVQM4_BENCH_STREAMS="2",
               HVQM4_BENCH_CLIP=str(REPO / "testdata" / "i320.h4m"))
    r = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--phase", "plan"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["plan_fps"] > 0
    assert out["plan_frames"] > 0
    assert out["planner"] == "native"


@pytest.mark.assurance
def test_phase_device_field_contract():
    """--phase device on the tiny clip (CPU backend, 2 streams): the bench
    relies on the field contract — samples, median, byte table, the
    device it ran on. The NUMBERS are meaningless on the CPU backend
    (jnp.asarray may zero-copy); the bench runs this phase on a GPU."""
    env = dict(os.environ,
               HVQM4_BENCH_STREAMS="2",
               HVQM4_BENCH_CLIP=str(REPO / "testdata" / "i320.h4m"))
    r = subprocess.run(
        [sys.executable, str(REPO / "bench.py"), "--phase", "device"],
        capture_output=True, text=True, timeout=540, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["device_fps"] > 0
    assert out["device_fps_samples"]
    assert out["device_fps_median"] > 0
    assert out["device_bytes_per_frame_by_field"]["wire_payload"] > 0
    assert out["device_packed_staging"] is True
    assert out["backend"] == "cpu"
    # the packed warm pass verifies the timed path against the C oracle
    assert out["device_replay_bitexact"] is True


def test_main_refuses_cpu_platform():
    """With no GPU the bench exits non-zero and prints no result line."""
    r = subprocess.run([sys.executable, str(REPO / "bench.py")],
                       capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no GPU" in r.stderr
