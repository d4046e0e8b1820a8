"""CLI surface tests (in-process, numpy backend to avoid device compiles)."""

import numpy as np
import pytest

from hvqm4_jax import cli
from hvqm4_jax.config import SeqConfig
from tools.encoder import make_clip


@pytest.fixture()
def clip_path(tmp_path):
    cfg = SeqConfig(64, 48)
    p = tmp_path / "c.h4m"
    p.write_bytes(make_clip(cfg, ["IPB"], seed=55, audio_channels=2))
    return p


def test_cli_info(capsys, clip_path):
    assert cli.main(["info", str(clip_path)]) == 0
    out = capsys.readouterr().out
    assert "64x48" in out and "video_frames=3" in out and "IMA-ADPCM" in out


def test_cli_decode_numpy_and_ppm(tmp_path, clip_path, oracle_bin):
    out = tmp_path / "o.yuv"
    ppm = tmp_path / "frames"
    rc = cli.main(["decode", str(clip_path), str(out), "--backend", "numpy",
                   "--ppm", str(ppm)])
    assert rc == 0
    from .conftest import run_oracle

    assert out.read_bytes() == run_oracle(oracle_bin, clip_path.read_bytes(),
                                          tmp_path)
    ppms = sorted(ppm.glob("*.ppm"))
    assert len(ppms) == 3
    assert ppms[0].read_bytes().startswith(b"P6\n64 48\n255\n")


def test_cli_hash_matches_oracle_format(capsys, clip_path, oracle_bin):
    import subprocess

    assert cli.main(["hash", str(clip_path), "--backend", "numpy"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    want = subprocess.run([str(oracle_bin), "--hash", str(clip_path),
                           "/dev/null"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()
    assert got == want


def test_cli_audio_and_stats(tmp_path, capsys, clip_path):
    wav = tmp_path / "a.wav"
    assert cli.main(["audio", str(clip_path), str(wav)]) == 0
    assert wav.read_bytes()[:4] == b"RIFF"
    assert cli.main(["stats", str(clip_path)]) == 0
    assert '"frames"' in capsys.readouterr().out


def test_cli_encode_roundtrip(tmp_path, capsys):
    cfg = SeqConfig(32, 16)
    rng = np.random.default_rng(0)
    raw = b""
    for _ in range(3):
        y = np.clip(np.linspace(30, 220, 16 * 32).reshape(16, 32)
                    + rng.normal(0, 2, (16, 32)), 0, 255).astype(np.uint8)
        u = np.full((8, 16), 120, np.uint8)
        v = np.full((8, 16), 130, np.uint8)
        raw += y.tobytes() + u.tobytes() + v.tobytes()
    src = tmp_path / "in.yuv"
    src.write_bytes(raw)
    out = tmp_path / "enc.h4m"
    rc = cli.main(["encode", str(src), str(out), "--width", "32",
                   "--height", "16", "--gops", "IPP"])
    assert rc == 0
    assert cli.main(["info", str(out)]) == 0
    assert "32x16" in capsys.readouterr().out


def test_cli_rejects_bad_file(tmp_path, capsys):
    bad = tmp_path / "bad.h4m"
    bad.write_bytes(b"not a clip at all" * 10)
    rc = cli.main(["decode", str(bad), "/dev/null", "--backend", "numpy"])
    assert rc == 1
    assert "error" in capsys.readouterr().err


def test_cli_verify(capsys, clip_path, oracle_bin):
    assert cli.main(["verify", str(clip_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("MATCH") == 2 and "MISMATCH" not in out


def test_cli_verify_device(capsys, clip_path, oracle_bin):
    """--device checks the batched production path with the on-device
    checksum (`oracle --csum` == utils.hashing.frame_csum)."""
    assert cli.main(["verify", str(clip_path), "--device"]) == 0
    out = capsys.readouterr().out
    assert "on-device checksum" in out and "MISMATCH" not in out


def test_cli_transcode_roundtrip(tmp_path, clip_path, oracle_bin):
    """transcode re-encodes a decoded clip (audio remuxed) into a stream
    every implementation still decodes; geometry and frame count survive."""
    out = tmp_path / "t.h4m"
    rc = cli.main(["transcode", str(clip_path), str(out),
                   "--backend", "numpy", "--quality", "2"])
    assert rc == 0
    from hvqm4_jax.container import Demuxer

    d = Demuxer(out.read_bytes())
    assert d.info.cfg == SeqConfig(64, 48)
    assert d.info.video_frames == 3
    assert d.info.audio_channels == 2  # audio carried through
    from .conftest import golden_decode, run_oracle

    got = b"".join(f.tobytes() for f in golden_decode(d.info.cfg,
                                                      out.read_bytes()))
    assert got == run_oracle(oracle_bin, out.read_bytes(), tmp_path)


def test_cli_transcode_target_kb(tmp_path, oracle_bin):
    cfg = SeqConfig(64, 48)
    src = tmp_path / "s.h4m"
    src.write_bytes(make_clip(cfg, ["IPPPP"], seed=56))  # no audio
    out = tmp_path / "t.h4m"
    rc = cli.main(["transcode", str(src), str(out), "--backend", "numpy",
                   "--target-kb", "3"])
    assert rc == 0
    assert 0 < out.stat().st_size


def test_cli_remote_roundtrip(tmp_path, capsys, clip_path):
    """`cli remote` decodes through a live service and writes the YUV."""
    import threading

    from hvqm4_jax import serve

    srv = serve.DecodeServer(("127.0.0.1", 0), backend="numpy")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        host, port = srv.server_address
        out = tmp_path / "remote.yuv"
        rc = cli.main(["remote", f"{host}:{port}", str(clip_path), str(out)])
        assert rc == 0
        from .conftest import golden_decode

        cfg = SeqConfig(64, 48)
        want = b"".join(f.tobytes()
                        for f in golden_decode(cfg, clip_path.read_bytes()))
        assert out.read_bytes() == want
        # metrics paths (JSON + Prometheus)
        assert cli.main(["remote", f"{host}:{port}", "--metrics"]) == 0
        assert '"requests_total"' in capsys.readouterr().out
        rc = cli.main(["remote", f"{host}:{port}", "--metrics",
                       "--prometheus"])
        assert rc == 0
        assert "hvqm4_serve_requests_total" in capsys.readouterr().out
    finally:
        srv.shutdown()


def test_cli_remote_errors(capsys, clip_path):
    # unreachable server: clean one-line error, no traceback
    rc = cli.main(["remote", "127.0.0.1:1", str(clip_path), "/dev/null"])
    assert rc == 1
    assert "error" in capsys.readouterr().err
    # malformed address
    assert cli.main(["remote", "nocolon", str(clip_path)]) == 1


def test_cli_decode_y4m_and_frames(tmp_path):
    """--y4m wraps display-order frames in YUV4MPEG2; --frames truncates."""
    cfg = SeqConfig(64, 48)
    clip = tmp_path / "c.h4m"
    clip.write_bytes(make_clip(cfg, ["IPB", "IP"], seed=56))
    out = tmp_path / "o.y4m"
    assert cli.main(["decode", str(clip), str(out), "--backend", "numpy",
                     "--y4m"]) == 0
    data = out.read_bytes()
    header, rest = data.split(b"\n", 1)
    # 33366 usec/frame -> 1000000/33366 reduced
    from fractions import Fraction
    from hvqm4_jax.container import Demuxer

    usec = Demuxer(clip.read_bytes()).info.usec_per_frame
    fps = Fraction(1_000_000, usec)
    assert header == (f"YUV4MPEG2 W64 H48 F{fps.numerator}:{fps.denominator} "
                      f"Ip A1:1 C420jpeg").encode()
    frame_size = 64 * 48 * 3 // 2
    frames = rest.split(b"FRAME\n")
    assert frames[0] == b""  # header is followed directly by the first FRAME
    assert len(frames) == 6 and all(len(f) == frame_size for f in frames[1:])
    # y4m implies display order: payload equals the display-order raw decode
    raw = tmp_path / "o.yuv"
    assert cli.main(["decode", str(clip), str(raw), "--backend", "numpy",
                     "--display-order"]) == 0
    assert b"".join(frames[1:]) == raw.read_bytes()
    # --frames truncation
    out2 = tmp_path / "t.yuv"
    assert cli.main(["decode", str(clip), str(out2), "--backend", "numpy",
                     "--frames", "2"]) == 0
    assert len(out2.read_bytes()) == 2 * frame_size


def test_cli_decode_start_time(tmp_path, capsys):
    """--start-time seeks to the containing GOP block (== --start-block)."""
    cfg = SeqConfig(64, 48)
    clip = tmp_path / "c.h4m"
    clip.write_bytes(make_clip(cfg, ["IPP", "IP"], seed=57))
    from hvqm4_jax.container import Demuxer

    usec = Demuxer(clip.read_bytes()).info.usec_per_frame
    a = tmp_path / "a.yuv"
    b = tmp_path / "b.yuv"
    # a time inside frame 4 (second block starts at frame 3)
    t = 3.5 * usec / 1e6
    assert cli.main(["decode", str(clip), str(a), "--backend", "numpy",
                     "--start-time", str(t)]) == 0
    assert cli.main(["decode", str(clip), str(b), "--backend", "numpy",
                     "--start-block", "1"]) == 0
    assert a.read_bytes() == b.read_bytes()
    # past-the-end clamps to the last block; negative is a clean error
    assert cli.main(["decode", str(clip), str(a), "--backend", "numpy",
                     "--start-time", "9999"]) == 0
    assert cli.main(["decode", str(clip), str(a), "--backend", "numpy",
                     "--start-time", "-1"]) == 1
    assert "non-negative" in capsys.readouterr().err
    # mutually exclusive with --start-block
    assert cli.main(["decode", str(clip), str(a), "--backend", "numpy",
                     "--start-time", "0", "--start-block", "1"]) == 1


def test_cli_encode_from_y4m_roundtrip(tmp_path, capsys):
    """decode --y4m -> encode (self-describing input) -> identical re-decode.

    The y4m carries geometry/chroma/frame-rate, so encode needs no flags;
    the emitted clip preserves the source's usec_per_frame."""
    cfg = SeqConfig(64, 48)
    src = tmp_path / "src.h4m"
    src.write_bytes(make_clip(cfg, ["IPP"], seed=60))
    y4m = tmp_path / "v.y4m"
    assert cli.main(["decode", str(src), str(y4m), "--backend", "numpy",
                     "--y4m"]) == 0
    out = tmp_path / "re.h4m"
    assert cli.main(["encode", str(y4m), str(out), "--quality", "0.5"]) == 0
    from hvqm4_jax.container import Demuxer

    info = Demuxer(out.read_bytes()).info
    assert (info.cfg.width, info.cfg.height) == (64, 48)
    assert info.usec_per_frame == 33366  # from the y4m F tag, not a default
    # conflicting explicit geometry is rejected
    assert cli.main(["encode", str(y4m), str(out), "--width", "128",
                     "--height", "96"]) == 1
    assert "conflict" in capsys.readouterr().err
    # raw input still requires explicit geometry
    raw = tmp_path / "v.yuv"
    raw.write_bytes(b"\x80" * (cfg.frame_bytes * 2))
    assert cli.main(["encode", str(raw), str(out)]) == 1
    assert "--width/--height are required" in capsys.readouterr().err
    assert cli.main(["encode", str(raw), str(out), "--width", "64",
                     "--height", "48"]) == 0


def test_cli_transcode_preserves_frame_rate(tmp_path):
    cfg = SeqConfig(64, 48)
    src = tmp_path / "s.h4m"
    src.write_bytes(make_clip(cfg, ["IPP"], seed=61, usec_per_frame=40000))
    out = tmp_path / "t.h4m"
    assert cli.main(["transcode", str(src), str(out), "--backend", "numpy",
                     "--quality", "8"]) == 0
    from hvqm4_jax.container import Demuxer

    assert Demuxer(out.read_bytes()).info.usec_per_frame == 40000


def test_cli_parser_platform_choices():
    """`--platform` takes JAX's name for a CUDA device and the CPU, and
    nothing else."""
    ap = cli.build_parser()
    assert ap.parse_args(["--platform", "gpu", "info", "c"]).platform == "gpu"
    assert ap.parse_args(["--platform", "cpu", "info", "c"]).platform == "cpu"
    with pytest.raises(SystemExit):
        ap.parse_args(["--platform", "rocm", "info", "c"])


def test_cli_platform_gpu_without_card_fails(capsys, clip_path):
    """Asked for a GPU where there is none, the CLI exits 1 and does no
    work on the CPU."""
    import subprocess
    import sys

    from .conftest import REPO

    r = subprocess.run(
        [sys.executable, "-m", "hvqm4_jax.cli", "--platform", "gpu", "info",
         str(clip_path)], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert r.returncode == 1
    assert "--platform gpu: no gpu device" in r.stderr
    assert r.stdout == ""
