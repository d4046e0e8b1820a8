"""One-off: dispatch+compute ceiling of the packed replay config.

Stages one packed pass (one h2d per dtype), then times passes that
REUSE the staged device arenas — zero transfer — so the number is what
the device + dispatch path could sustain if the link were free: the
ceiling above the bench device phase.

Usage: HVQM4_BENCH_STREAMS=16 python scripts/compute_ceiling.py [passes]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from hvqm4_jax.utils.compile_cache import use_compile_cache  # noqa: E402


def main() -> None:
    use_compile_cache()
    import jax

    from bench import _setup

    n_streams = int(os.environ.get("HVQM4_BENCH_STREAMS", "16"))
    n_passes = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    _cfg, _cp, make_ms, _pn = _setup(n_streams)
    ms = make_ms()
    bufs, frames_planned = [], 0
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        bufs.append(ms.snapshot_step(buf))
        ms._cur ^= 1
        frames_planned += int(np.sum(valid))
    ms2 = make_ms()
    ms2.stage_packed(bufs)          # the ONLY h2d
    staged = [b.pop("arenas_staged") for b in bufs]
    # warm (compiles)
    last = None
    for b, st in zip(bufs, staged):
        b["arenas_staged"] = st
        last = ms2.device_step(b)
    jax.block_until_ready(last)
    samples = []
    for _ in range(n_passes):
        msN = make_ms()
        t0 = time.perf_counter()
        last = None
        for b, st in zip(bufs, staged):
            b["arenas_staged"] = st
            last = msN.device_step(b)
        jax.block_until_ready(last)
        samples.append(frames_planned / (time.perf_counter() - t0))
    print({"compute_only_fps_samples": [round(s, 1) for s in samples],
           "compute_only_fps_best": round(max(samples), 1),
           "streams": n_streams, "frames_per_pass": frames_planned,
           "backend": jax.default_backend()})


if __name__ == "__main__":
    main()
