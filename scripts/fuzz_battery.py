"""Extended one-off fuzz battery (superset of tests/test_fuzz.py's sizes).

Mutated clips from varied bases (shapes x slices x audio x version x
dc_shift) are fed to BOTH independent implementations:
  - the ASan/UBSan C oracle (must exit 0/1, never a sanitizer abort)
  - the demuxer + native C++ planner (must decode or raise
    ContainerError/PlannerError, never crash or hang)

    python scripts/fuzz_battery.py [n_mutants] [base_seed]

CPU-only; no JAX. Sized for one-off assurance runs (the in-suite battery
stays small to keep pytest fast). Results are printed per base; any
finding reproduces from (base description, seed printed on failure).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hvqm4_jax.config import SeqConfig  # noqa: E402
from hvqm4_jax.container import ContainerError, Demuxer  # noqa: E402
from hvqm4_jax.native import NativePlanner  # noqa: E402
from hvqm4_jax.planner import PlannerError  # noqa: E402
from tools.encoder import make_clip  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]

BASES = [
    dict(cfg=SeqConfig(64, 48), gops=["IPB"], audio_channels=1),
    dict(cfg=SeqConfig(64, 48), gops=["IPBPB", "IPP"], slices=3,
         audio_channels=2),
    dict(cfg=SeqConfig(32, 16), gops=["I"]),
    dict(cfg=SeqConfig(96, 80, 1, 1), gops=["IBBP"], dc_shift=3),
    dict(cfg=SeqConfig(128, 96), gops=["IPPP"], slices=6, mv_extreme=True),
    dict(cfg=SeqConfig(48, 64, version="1.5"), gops=["IPB", "IP"],
         audio_channels=2, slices=2),
]


def mutate(data: bytes, rng, n_mut: int) -> bytes:
    buf = bytearray(data)
    for _ in range(n_mut):
        buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
    return bytes(buf)


def planner_probe(cfg: SeqConfig, data: bytes) -> None:
    """Demux + plan every video record (the host attack surface)."""
    try:
        d = Demuxer(data)
        if d.info.cfg != cfg:
            return  # header mutation changed the sequence shape: fine
        pl = NativePlanner(cfg)
        for r in d.video_records():
            pl.plan_frame(r.frame_char, r.payload)
    except (ContainerError, PlannerError, ValueError):
        pass  # clean rejection is the contract


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    base_seed = int(sys.argv[2]) if len(sys.argv) > 2 else 11000
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle"), "asan"],
                   check=True)
    asan = REPO / "oracle" / "hvqm4_oracle_asan"
    per_base = n // len(BASES)
    with tempfile.TemporaryDirectory() as td:
        p = pathlib.Path(td) / "m.h4m"
        for bi, spec in enumerate(BASES):
            spec = dict(spec)
            cfg = spec.pop("cfg")
            clip = make_clip(cfg, seed=base_seed + bi, **spec)
            rng = np.random.default_rng(base_seed * 7 + bi)
            for i in range(per_base):
                mutated = mutate(clip, rng, int(rng.integers(1, 14)))
                p.write_bytes(mutated)
                res = subprocess.run(
                    [str(asan), "--audio", str(pathlib.Path(td) / "a.pcm"),
                     str(p), "/dev/null"],
                    capture_output=True, timeout=60)
                assert res.returncode in (0, 1), (
                    f"ORACLE base={bi} iter={i}: rc={res.returncode}\n"
                    + res.stderr.decode()[:2000])
                planner_probe(cfg, mutated)
            print(f"base {bi + 1}/{len(BASES)}: {per_base} mutants clean "
                  f"({cfg.width}x{cfg.height} {spec})", flush=True)
    print(f"PASS: {per_base * len(BASES)} mutants, oracle sanitizer-clean, "
          f"planner decode-or-reject")


if __name__ == "__main__":
    main()
