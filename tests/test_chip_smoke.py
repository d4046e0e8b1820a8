"""chip_smoke.py on the CPU: the device gate, the result line, and every
phase's checks at 64x48 (the GPU runs them at 640x480). A phase raises on
any mismatch with its reference."""

import json
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from hvqm4_jax.config import SeqConfig
from hvqm4_jax.models.vit import ViTConfig
from tools.encoder import make_clip

from .conftest import REPO

SMALL_VIT = ViTConfig(image_size=32, patch_size=8, dim=64, depth=2, heads=4)


@pytest.fixture(scope="module")
def clips(tmp_path_factory, oracle_bin):
    """Two distinct 64x48 clips of one SeqConfig, two GOP blocks each."""
    d = tmp_path_factory.mktemp("clips")
    cfg = SeqConfig(64, 48)
    heavy, retail = d / "heavy.h4m", d / "retail.h4m"
    heavy.write_bytes(make_clip(cfg, ["IBBPBP", "IPPP"], seed=7))
    retail.write_bytes(make_clip(cfg, ["IPBPB", "IPP"], seed=8))
    return heavy, retail


def _run(cmd, cwd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=cwd)


def test_device_gate_refuses_cpu():
    """No GPU: non-zero exit, and no result line."""
    r = _run([sys.executable, str(REPO / "chip_smoke.py")], REPO)
    assert r.returncode != 0
    lines = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert lines[-1]["phase"] == "device" and lines[-1]["ok"] is False
    assert "no GPU" in lines[-1]["error"]
    assert not any("device" in ln and ln.get("ok") is True for ln in lines)


def test_alone_without_the_repository_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = _run([sys.executable, "chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert r.stdout == ""


@pytest.mark.parametrize("cards", [1, 4])
def test_result_line_keys(cards):
    """The count is the devices the run used, not all that JAX sees."""
    line = chip_smoke.result_line(jax.devices()[:cards])
    assert set(line) == {"ok", "device"}
    assert set(line["device"]) == {"platform", "kind", "count"}
    assert line["device"]["count"] == cards < len(jax.devices())
    assert json.loads(json.dumps(line)) == line


def test_phase_multistream(clips):
    heavy, retail = clips
    out = chip_smoke.phase_multistream(chip_smoke.Smoke(), heavy, retail,
                                       n=8, k_fused=4)
    assert out["k1_frames_bitexact"] == 4 * 10 + 4 * 8
    assert out["k4_frames_bitexact"] == 8 * 8


def test_phase_gop_parallel(clips):
    assert chip_smoke.phase_gop_parallel(clips[0])["frames_bitexact"] == 10


def test_phase_session(clips):
    out = chip_smoke.phase_session(clips[0])
    assert out["start_block"] == 1 and out["frames_bitexact"] == 4


def test_phase_serve(clips):
    out = chip_smoke.phase_serve(*clips, vit_cfg=SMALL_VIT)
    assert out["rgb_frames_exact"] == 8 and out["embed_frames"] == 8


def test_phase_nest_search(clips):
    out = chip_smoke.phase_nest_search(clips[0])
    assert out["blocks"] == 16 * 12


def test_phase_four_cards_on_virtual_devices(clips):
    """16 streams over dp=4 at K=1 and fused K=28, then the (dp=2, tp=2)
    ViT, on 4 of the 8 virtual CPU devices."""
    out = chip_smoke.phase_four_cards(*clips, SMALL_VIT)
    assert out["decode_mesh"] == "dp=4" and out["vit_mesh"] == "dp=2 tp=2"
    assert out["dispatch"] == [1, 28]
    assert out["frames_bitexact"] == 2 * (8 * 10 + 8 * 8)
