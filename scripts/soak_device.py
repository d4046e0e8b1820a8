"""Randomized device-path conformance soak (one-off battery).

Where tests/test_soak.py sweeps oracle-vs-golden and native-vs-python, this
sweeps the PRODUCTION path: randomized clips through MultiStreamDecoder's
typed-arena upload + jitted step (device-derived slot indices, per-MB MV
expansion, pool tiers, threaded slice planning + compaction), compared
stream-by-stream against the C oracle.

Run on the CPU backend so every random geometry compiles in seconds:
    JAX_PLATFORMS=cpu python scripts/soak_device.py [n_cases] [base_seed]
"""

import os
import pathlib
import subprocess
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"  # fast compiles for every geometry

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hvqm4_jax.config import SeqConfig  # noqa: E402
from hvqm4_jax.native import NativePlanner  # noqa: E402
from hvqm4_jax.parallel.multistream import MultiStreamDecoder  # noqa: E402
from tools.encoder import make_clip  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def oracle_yuv(oracle_bin, clip: bytes) -> bytes:
    with tempfile.TemporaryDirectory() as d:
        src = pathlib.Path(d) / "c.h4m"
        dst = pathlib.Path(d) / "c.yuv"
        src.write_bytes(clip)
        r = subprocess.run([str(oracle_bin), str(src), str(dst)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            # surface the oracle's diagnostic (names the offending record)
            raise RuntimeError(f"oracle failed: {r.stderr.strip()[:300]}")
        return dst.read_bytes()


def one_case(oracle_bin, seed: int) -> str:
    rng = np.random.default_rng(seed)
    w = 8 * int(rng.integers(2, 13))
    h = 8 * int(rng.integers(2, 13))
    samp = int(rng.choice([1, 2]))
    version = str(rng.choice(["1.3", "1.5"]))
    cfg = SeqConfig(w, h, samp, samp, version=version)
    mh = cfg.mb_grid[0]
    threads = int(rng.choice([1, 4]))
    os.environ["HVQM4_PLANNER_THREADS"] = str(threads)
    n_streams = int(rng.integers(1, 4))
    k = int(rng.choice([1, 2, 4]))  # fused-dispatch factor (virtual slots)
    clips, slices_used = [], []
    for si in range(n_streams):
        pattern = "I" + str(rng.choice(["P", "BP", "BBP", "PBPB", ""]))
        slices = int(rng.integers(1, min(mh, 6) + 1))
        slices_used.append(slices)
        clips.append(make_clip(cfg, [pattern], seed=seed * 17 + si,
                               dc_shift=int(rng.integers(0, 8)),
                               slices=slices))
    desc = (f"seed={seed} {w}x{h} samp={samp} v{version} "
            f"streams={n_streams} "
            f"slices={slices_used} threads={threads} K={k}")
    ms = MultiStreamDecoder(cfg, clips, planner_factory=NativePlanner,
                            steps_per_dispatch=k)
    got = [b""] * n_streams
    for frames, _metas, valid in ms.run_pipelined():
        fnp = [np.asarray(p) for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                got[si] += b"".join(fnp[pi][si].tobytes() for pi in range(3))
    for si, clip in enumerate(clips):
        want = oracle_yuv(oracle_bin, clip)
        if got[si] != want:
            raise AssertionError(f"MISMATCH stream {si}: {desc}")
    return desc


CHUNK = 50  # configs per subprocess: every random geometry JIT-compiles
# several CPU executables, and one process accumulating hundreds of them
# exhausts mmap regions ("LLVM compilation error: Cannot allocate memory"
# observed at ~150+ configs with 124 GB RAM free) — recycle the address
# space instead


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    base = int(sys.argv[2]) if len(sys.argv) > 2 else 5000
    if n > CHUNK and "--child" not in sys.argv:
        done = 0
        while done < n:
            k = min(CHUNK, n - done)
            r = subprocess.run([sys.executable, __file__, str(k),
                                str(base + done), "--child"])
            if r.returncode != 0:
                sys.exit(r.returncode)
            done += k
            print(f"== {done}/{n} configs done ==", flush=True)
        print(f"PASS: {n} randomized device-path configs bit-exact vs oracle")
        return
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    oracle_bin = REPO / "oracle" / "hvqm4_oracle"
    for i in range(n):
        desc = one_case(oracle_bin, base + i)
        if (i + 1) % 10 == 0 or i == 0:
            print(f"[{i + 1}/{n}] ok  {desc}", flush=True)
    print(f"PASS: {n} randomized device-path configs bit-exact vs oracle")


if __name__ == "__main__":
    main()
