"""Device-throughput decomposition at one stream count.

Measures, for N parallel streams on the device (plans pre-built, so the
host entropy bound is out of the picture):

  - full_fps:     the bench `device` phase — per step: 2 typed-arena
                  host→device uploads (u8 + u32) + one jitted arena-step
                  dispatch
  - compute_fps:  arenas pre-staged on device — pure device execution of the
                  decode step (the kernel ceiling)
  - upload_fps:   the 2 arena transfers alone (the interconnect ceiling)

Prints ONE JSON line, for one stream count per process:

    python scripts/device_sweep.py 8
    python scripts/device_sweep.py 16 --repeat 3
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from hvqm4_jax.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("n_streams", type=int)
    ap.add_argument("--repeat", type=int, default=3,
                    help="timed passes per phase; best is reported")
    ap.add_argument("--skip-upload", action="store_true",
                    help="skip the upload-only phase")
    ap.add_argument("--phase", choices=["all", "full", "compute", "upload"],
                    default="all", help="measure one phase only")
    args = ap.parse_args()
    n = args.n_streams

    import jax
    import jax.numpy as jnp

    from bench import _setup
    from hvqm4_jax.parallel.multistream import _arena_step

    cfg, _clip_path, make_ms, _pn = _setup(n)

    # ---- plan the whole clip once (host side) -----------------------------
    import numpy as np

    ms = make_ms()
    bufs = []
    frames = 0
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        # snapshot only the uploaded staging prefixes (pool tails beyond
        # the tier are never transferred; RAM stays clip-length-independent)
        bufs.append(ms.snapshot_step(buf))
        ms._cur ^= 1
        frames += int(np.sum(valid))
    steps = len(bufs)

    step_bytes = [b["sizes"][0] + b["sizes"][1] * 4 for b in bufs]
    mb_per_step = sum(step_bytes) / steps / 1e6

    # ---- warm each VARIANT's executable once (compile/persistent-cache
    # load) — not every step
    full = None
    if args.phase in ("all", "full"):
        ms2 = make_ms()
        last = None
        seen = set()
        for buf in bufs:
            if buf["variant"] in seen:
                continue
            seen.add(buf["variant"])
            last = ms2.device_step(buf)
        jax.block_until_ready(last)

        # ---- full device phase (upload + dispatch + compute) ---------------
        full_s = []
        for _ in range(args.repeat):
            ms3 = make_ms()
            t0 = time.perf_counter()
            last = None
            for buf in bufs:
                last = ms3.device_step(buf)
            jax.block_until_ready(last)
            full_s.append(time.perf_counter() - t0)
        full = min(full_s)

    # ---- compute-only: pre-stage every step's arenas on device -------------
    compute = None
    if args.phase in ("all", "compute"):
        staged = []
        for buf in bufs:
            aren = {
                "u8": jnp.asarray(buf["staging"]["u8"][0]),
                "u32": jnp.asarray(buf["staging"]["u32"][0]),
            }
            jax.block_until_ready(aren)
            staged.append((aren, buf["variant"]))
        compute_s = []
        for _ in range(args.repeat):
            ms4 = make_ms()
            t0 = time.perf_counter()
            last = None
            for aren, variant in staged:
                step_fn = _arena_step(cfg, n, ms._k, *variant)
                out_frames, ms4.nest, ms4.ref_prev, ms4.ref_last = step_fn(
                    aren, ms4.nest, ms4.ref_prev, ms4.ref_last)
                last = out_frames
            jax.block_until_ready(last)
            compute_s.append(time.perf_counter() - t0)
        compute = min(compute_s)
        del staged

    # ---- upload-only: the 2 staging transfers, synchronous -----------------
    upload = None
    if args.phase in ("all", "upload") and not args.skip_upload:
        upload_s = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            for buf in bufs:
                jax.block_until_ready([
                    jnp.asarray(buf["staging"]["u8"][0]),
                    jnp.asarray(buf["staging"]["u32"][0])])
            upload_s.append(time.perf_counter() - t0)
        upload = min(upload_s)

    out = {
        "streams": n, "steps": steps, "frames": frames,
        "steps_per_dispatch": ms._k,
        "mb_per_step": round(mb_per_step, 3),
        "backend": jax.devices()[0].platform,
    }
    if full is not None:
        out["full_ms_per_step"] = round(full / steps * 1e3, 3)
        out["device_fps"] = round(frames / full, 1)
    if compute is not None:
        out["compute_ms_per_step"] = round(compute / steps * 1e3, 3)
        out["compute_fps"] = round(frames / compute, 1)
    if upload is not None:
        out["upload_ms_per_step"] = round(upload / steps * 1e3, 3)
        out["upload_fps"] = round(frames / upload, 1)
        out["upload_gbps"] = round(mb_per_step / 1e3 / (upload / steps), 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
