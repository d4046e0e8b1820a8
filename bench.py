"""Benchmark harness: prints ONE JSON line.

Measures on the GPU:
  - oracle_fps:  C reference decoder, single core -O2 (the baseline denominator)
  - value:       full-pipeline frames/sec at 640×480 — host planning
                 (native C++ planner) overlapped with plan upload + batched
                 device decode over N parallel streams (the end-to-end
                 number; BASELINE.json metric)
  - device_fps:  device-side decode throughput with plans pre-built (isolates
                 the device core + transfer from the host entropy bound)
  - bitexact:    decoded frames hash-identical to the C oracle on this device
  - plan_fps:    host planning + C++ staging assembly only (no device work)

Each phase runs in its own subprocess (`python bench.py --phase X`, which
runs on whatever platform JAX picks — the tests drive the phases on the
CPU), one after another; the parent never starts JAX, so one process holds
the card at a time. `main()` fails unless every phase ran on a GPU.

Env knobs: HVQM4_BENCH_STREAMS (default 8), HVQM4_BENCH_CLIP (default
testdata/ref640.h4m, generated if missing).
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent


def ensure_oracle() -> pathlib.Path:
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    return REPO / "oracle" / "hvqm4_oracle"


def ensure_clip(path: pathlib.Path):
    from hvqm4_jax.config import SeqConfig
    from hvqm4_jax.container import Demuxer
    from tools.encoder import make_clip

    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(make_clip(
            SeqConfig(640, 480), ["IBBPBP" + "BP" * 8, "IPPPPP"], seed=7,
            audio_channels=2))
    data = path.read_bytes()
    # the cfg comes from the clip itself (HVQM4_BENCH_CLIP may be any shape)
    return Demuxer(data).info.cfg, data


def _setup(n_streams: int):
    clip_path = pathlib.Path(os.environ.get(
        "HVQM4_BENCH_CLIP", str(REPO / "testdata" / "ref640.h4m")))
    cfg, clip = ensure_clip(clip_path)
    k = int(os.environ.get("HVQM4_STEPS_PER_DISPATCH", "1"))

    from hvqm4_jax.parallel.multistream import MultiStreamDecoder
    from hvqm4_jax.planner import Planner

    planner_factory = Planner
    planner_name = "python"
    try:
        from hvqm4_jax.native import NativePlanner

        planner_factory = NativePlanner
        planner_name = "native"
    except Exception as e:  # pragma: no cover - native module optional
        print(f"bench: native planner unavailable ({e})", file=sys.stderr)

    def make_ms():
        return MultiStreamDecoder(cfg, [clip] * n_streams,
                                  planner_factory=planner_factory,
                                  steps_per_dispatch=k)

    return cfg, clip_path, make_ms, planner_name


# ---------------------------------------------------------------------------
# Phases (each runs in its own process: `python bench.py --phase X`)
# ---------------------------------------------------------------------------

def phase_pipeline(n_streams: int) -> dict:
    import jax

    _cfg, _cp, make_ms, planner_name = _setup(n_streams)
    ms = make_ms()  # compile warmup (persistent-cache backed): run the whole
    for _ in ms.run_pipelined():  # clip so every pool-tier executable is warm
        pass
    del ms

    ms = make_ms()
    ms.reset_stats()
    t0 = time.perf_counter()
    frames_done, last = 0, None
    for frames, _metas, valid in ms.run_pipelined():
        frames_done += sum(valid)
        last = frames
    jax.block_until_ready(last)
    wall = time.perf_counter() - t0
    fps = frames_done / wall
    # per-frame stage split: wait/upload/dispatch/dequeue are MAIN-thread
    # time (they sum with `other` to the wall clock); plan/assemble run on
    # the worker thread and OVERLAP them, so the split attributes where the
    # pipeline loses time against the plan_fps bound.
    st = ms.stats
    per = 1000.0 / max(frames_done, 1)
    main = ["dequeue_s", "wait_s", "upload_s", "dispatch_s"]
    split = {k[:-2]: round(st[k] * per, 4) for k in main}
    split["other"] = round(
        (wall - sum(st[k] for k in main)) * per, 4)
    split["worker_plan"] = round(st["plan_s"] * per, 4)
    split["worker_assemble"] = round(st["assemble_s"] * per, 4)
    # h2d staging runs on the worker since round 5 (overlaps the previous
    # step's dispatch); `upload` above stays as the inline-path residue
    split["worker_stage"] = round(st["stage_s"] * per, 4)
    return {"pipeline_fps": round(fps, 2), "planner": planner_name,
            "pipeline_split_ms_per_frame": split,
            "backend": jax.devices()[0].platform}


def _step_byte_fields(ms, buf) -> dict:
    """Per-field byte attribution of one planned step's upload: where every
    uploaded byte beyond the wire payload goes. Sums to size8 + 4*size32
    exactly."""
    from hvqm4_jax.parallel.multistream import (
        _MV_NONE, _MV_PACKED8, _MV_WIDE)

    p8_cap, p32_cap, mv_mode, has_nest, meta_bits = buf["variant"]
    size8, size32 = buf["sizes"]
    su = buf["slot_used"]
    cfg, nvl, shards = ms.cfg, ms._nvl, ms._shards
    nh, nw = cfg.nest_shape
    raw_b = int(su[:, 0].sum()) * 16
    desc_b = int(su[:, 1].sum()) * 4
    dc_b = int(su[:, 2].sum())
    mv2_b = int(su[:, 3].sum()) * 4
    nest_b = sum(int(sh["is_i"].sum()) for sh in buf["shards"]) * nh * nw \
        if has_nest else 0
    tot8, tot32 = buf["used"]
    # u8 pool region: used segments + 16-alignment pad, then tier pad up to
    # p8_cap; replicated per shard row (shard rows share one quantized size)
    f = {
        "raw_pool": raw_b, "dc_pool": dc_b, "nest": nest_b,
        # exact for the bench's single-shard rows; with mesh shards tot8 is
        # the max shard total, so the pads are the uploaded (row-uniform)
        # sizes minus the summed used bytes — still what the wire carried
        "u8_align_pad": shards * tot8 - (raw_b + dc_b + nest_b),
        "u8_tier_pad": shards * (p8_cap - tot8),
        "desc_pool": desc_b,
        "mv2_pool": mv2_b,
        "u32_tier_pad": shards * p32_cap * 4 - desc_b - mv2_b,
        "flags": shards * 2 * nvl,
        "offs": shards * 16 * nvl,
    }
    per_word = 32 // meta_bits
    meta_w = sum((bh * bw + per_word - 1) // per_word
                 for bh, bw in cfg.block_grids)
    f["meta"] = shards * nvl * meta_w * 4
    f["metacb"] = shards * nvl * (1 << meta_bits) if meta_bits < 6 else 0
    mh, mw = cfg.mb_grid
    mv_w = {_MV_NONE: 0, _MV_PACKED8: (mh * mw + 1) // 2,
            _MV_WIDE: mh * mw}[mv_mode]
    f["mv"] = shards * nvl * mv_w * 4
    assert sum(f.values()) == shards * (size8 + size32 * 4), \
        (f, size8, size32)
    return f


def phase_device(n_streams: int) -> dict:
    import jax

    _cfg, _cp, make_ms, _pn = _setup(n_streams)
    ms = make_ms()
    all_bufs = []
    frames_planned = 0
    byte_fields: dict[str, int] = {}
    while any(ms.active):
        buf, _metas, valid = ms.plan_step()
        for k, v in _step_byte_fields(ms, buf).items():
            byte_fields[k] = byte_fields.get(k, 0) + v
        # snapshot only the uploaded staging prefixes (what device_step
        # actually transfers at this step's variant) — NOT the full arenas:
        # peak RSS stays independent of clip length
        all_bufs.append(ms.snapshot_step(buf))
        ms._cur ^= 1
        frames_planned += int(np.sum(valid))
    # wire payload per frame (the irreducible floor): one stream's record
    # payload bytes over its frame count, for the bytes-vs-wire ratio
    recs = ms.streams[0].records
    wire_pf = sum(len(p) for _b, _c, p in recs) / max(len(recs), 1)
    pass_mb = sum(b["sizes"][0] + b["sizes"][1] * 4 for b in all_bufs) / 1e6
    # packed-pass replay: one contiguous h2d per dtype per pass instead of
    # two per step; same bytes, plans and per-variant executables, and
    # bit-exact vs per-step staging (tests/test_multistream.py)
    packed_on = os.environ.get("HVQM4_BENCH_PACKED", "1") != "0"
    packed = None
    replay_ok = None
    # warm the executables (compile / persistent-cache load must not land
    # in the timing): one full pass, which with packed staging doubles as
    # an on-device bit-exactness check of the EXACT path the timed passes
    # run — every step's frame checksums (== `oracle --csum`) accumulate
    # on device, one d2h at the end
    ms2 = make_ms()
    if packed_on:
        from hvqm4_jax.utils.hashing import batch_csum_fn, oracle_digests

        csum_jit = batch_csum_fn()
        packed = ms2.stage_packed(all_bufs)
        step_cs = []
        for buf in all_bufs:
            frames = ms2.device_step(buf)
            if ms2._k == 1:
                step_cs.append(csum_jit(*frames))           # (n,)
            else:
                kk = frames[0].shape[0]
                flat = [p.reshape((-1,) + p.shape[2:]) for p in frames]
                step_cs.append(csum_jit(*flat).reshape(kk, -1))  # (K, n)
        cs = np.concatenate([np.asarray(c).reshape(-1, n_streams)
                             for c in step_cs])              # (frames, n)
        want = oracle_digests(ensure_oracle(), _cp, "csum")
        replay_ok = cs.shape[0] == len(want) and all(
            [f"{cs[fi, si]:08x}" for fi in range(cs.shape[0])] == want
            for si in range(n_streams))
    else:
        last = None
        for buf in all_bufs:
            last = ms2.device_step(buf)
        jax.block_until_ready(last)
    # timed passes: each re-uploads every step's staging prefix, so a pass
    # is a full upload + dispatch + compute measurement
    max_passes = 7
    budget_s = float(os.environ.get("HVQM4_BENCH_DEVICE_S", "300"))
    t_phase = time.perf_counter()
    samples: list[float] = []
    while len(samples) < max_passes:
        ms3 = make_ms()
        t0 = time.perf_counter()
        if packed_on:
            ms3.stage_packed(all_bufs, packed)
        last = None
        for buf in all_bufs:
            last = ms3.device_step(buf)
        jax.block_until_ready(last)
        samples.append(frames_planned / (time.perf_counter() - t0))
        elapsed = time.perf_counter() - t_phase
        if elapsed + elapsed / len(samples) > budget_s:
            break
    med = sorted(samples)[len(samples) // 2]
    out = {"device_fps": round(max(samples), 2),
           "device_streams": n_streams,
           "device_passes": len(samples),
           "device_fps_samples": [round(s, 1) for s in samples],
           "device_fps_median": round(med, 2),
           "device_fps_spread": round(
               (max(samples) - min(samples)) / 2 / med, 3),
           "device_pass_mb": round(pass_mb, 1),
           "device_frames": frames_planned,
           # per-field upload attribution (bytes/frame) + the wire floor
           "device_bytes_per_frame_by_field": dict(
               {k: round(v / frames_planned, 1)
                for k, v in sorted(byte_fields.items(),
                                   key=lambda kv: -kv[1])},
               wire_payload=round(wire_pf, 1)),
           "device_packed_staging": packed_on,
           "backend": jax.devices()[0].platform}
    if replay_ok is not None:
        out["device_replay_bitexact"] = replay_ok
    return out


def phase_plan(n_streams: int) -> dict:
    """Host planning + C++ staging-assembly throughput (no device work):
    plan_step is numpy + the GIL-released C++ planner, so this is the
    host-side bound of the full pipeline."""
    _cfg, _cp, make_ms, planner_name = _setup(n_streams)
    ms = make_ms()  # warm pass: C++ scratch freelist + page cache
    while any(ms.active):
        ms.plan_step()
    ms = make_ms()
    t0 = time.perf_counter()
    frames = 0
    while any(ms.active):
        _buf, _metas, valid = ms.plan_step()
        frames += int(np.sum(valid))
    fps = frames / (time.perf_counter() - t0)
    return {"plan_fps": round(fps, 2), "plan_frames": frames,
            "planner": planner_name}


def phase_platform(_n_streams: int) -> dict:
    """The device JAX picks in a fresh process, as every phase sees it."""
    import jax

    dev = jax.devices()[0]
    return {"backend": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def phase_link(n_streams: int) -> dict:
    """Host-to-device link probe: h2d bandwidth + round-trip dispatch
    latency. With the device phase's bytes per frame, the transfer ceiling
    `link_h2d_gbps / device_mb_per_frame` says what the link allows."""
    import jax

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    # fresh buffer each rep: the PJRT client may elide or cache a repeated
    # identical transfer; fresh bytes measure the real wire path
    sz = 16 * 1024 * 1024
    x = jax.device_put(rng.integers(0, 256, sz, dtype=np.uint8), dev)
    x.block_until_ready()  # warm the path once (not timed)
    bw = []
    for _ in range(3):
        buf = rng.integers(0, 256, sz, dtype=np.uint8)
        t0 = time.perf_counter()
        x = jax.device_put(buf, dev)
        x.block_until_ready()
        bw.append(sz / 1e9 / (time.perf_counter() - t0))
    # RTT on a 1-element op: a reduction over the 16 MiB buffer would fold
    # device compute + a large d2h into the figure (review finding) — the
    # field means pure dispatch round-trip latency
    y = jax.device_put(np.zeros(1, np.float32), dev)
    f = jax.jit(lambda a: a + 1.0)
    y = f(y)
    y.block_until_ready()
    # block EACH dispatch: async enqueueing overlaps the round trips and
    # reports a fraction of the true per-dispatch latency (review finding)
    t0 = time.perf_counter()
    for _ in range(10):
        f(y).block_until_ready()
    rtt_ms = (time.perf_counter() - t0) * 100.0
    return {"link_h2d_gbps": round(max(bw), 3),
            "link_h2d_gbps_samples": [round(b, 3) for b in bw],
            "link_rtt_ms": round(rtt_ms, 2),
            "backend": dev.platform}


def phase_hash(n_streams: int) -> dict:
    """Bit-exactness vs the C oracle, verified on EVERY stream of the same
    batched configuration the throughput phases use (same compiled
    executable): a stream-dependent layout/donation bug on this backend
    would show up in streams 1..N-1 even when stream 0 is right.

    The digest is the position-weighted checksum (`oracle --csum` ==
    utils.hashing.frame_csum) computed ON DEVICE: d2h is 4 bytes per
    frame per stream, not the full YUV. CI still covers the full
    byte-compare + FNV path (tests/test_oracle_diff.py)."""
    import jax

    from hvqm4_jax.utils.hashing import batch_csum_fn, oracle_digests

    _cfg, clip_path, make_ms, _pn = _setup(n_streams)
    csum_jit = batch_csum_fn()
    ms = make_ms()
    # run_pipelined yields per single step for any fused-dispatch factor,
    # so this hashes exactly the configuration the pipeline phases run.
    # Checksums stay device-side until ONE stacked d2h at the end.
    import jax.numpy as jnp

    cs_dev = [csum_jit(*frames)
              for frames, _metas, _valid in ms.run_pipelined()]
    allcs = np.asarray(jnp.stack(cs_dev))  # (steps, N) u32
    per_stream = [[f"{c:08x}" for c in allcs[:, si]]
                  for si in range(n_streams)]

    want = oracle_digests(ensure_oracle(), clip_path, "csum")
    ok = all(h == want for h in per_stream)
    return {"bitexact": ok, "bitexact_streams": n_streams,
            "bitexact_frames": len(want),
            "backend": jax.devices()[0].platform}


PHASES = {"pipeline": phase_pipeline, "device": phase_device,
          "hash": phase_hash, "plan": phase_plan, "link": phase_link,
          "platform": phase_platform}


def run_phase(phase: str, clip_path: pathlib.Path, extra_env: dict) -> dict:
    """One phase in a fresh process; its last stdout line is its JSON."""
    print(f"bench: phase {phase} ({clip_path.name})", file=sys.stderr,
          flush=True)
    env = dict(os.environ, HVQM4_BENCH_CLIP=str(clip_path), **extra_env)
    r = subprocess.run([sys.executable, __file__, "--phase", phase],
                       capture_output=True, text=True, timeout=1500, env=env)
    if r.returncode != 0:
        raise RuntimeError(f"phase {phase} failed (rc={r.returncode}): "
                           f"{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    from hvqm4_jax.utils.compile_cache import use_compile_cache

    use_compile_cache()  # inherited by every phase process
    n_streams = int(os.environ.get("HVQM4_BENCH_STREAMS", "8"))
    if len(sys.argv) == 3 and sys.argv[1] == "--phase":
        print(json.dumps(PHASES[sys.argv[2]](n_streams)))
        return 0

    # Two corpus points (docs/DECISIONS.md): the heavy conformance clip
    # (primary metric) and the retail-bitrate clip (representative FMV
    # statistics, run at fused K=28 dispatch: the whole 28-frame clip in
    # one dispatch per pass).
    ref_clip = pathlib.Path(os.environ.get(
        "HVQM4_BENCH_CLIP", str(REPO / "testdata" / "ref640.h4m")))
    retail_clip = REPO / "testdata" / "retail640.h4m"
    dev = run_phase("platform", ref_clip, {})
    if dev["backend"] != "gpu":
        print(f"bench: no GPU (JAX picked {dev['backend']!r}); the bench "
              f"measures the GPU only", file=sys.stderr)
        return 1
    ensure_clip(ref_clip)
    oracle = ensure_oracle()

    def oracle_fps(clip_path: pathlib.Path) -> float:
        res = subprocess.run([str(oracle), "--bench", "5", str(clip_path)],
                             check=True, capture_output=True, text=True)
        return float(json.loads(res.stdout)["fps"])

    base_fps = oracle_fps(ref_clip)
    retail_base = oracle_fps(retail_clip)
    k28 = {"HVQM4_STEPS_PER_DISPATCH": "28"}
    # pipeline phases: plan-ahead 1 with 2 planning workers
    pl2 = {"HVQM4_PLAN_AHEAD": "1", "HVQM4_PLAN_WORKERS": "2"}
    jobs = [("", ref_clip, "plan", {}),
            ("retail_", retail_clip, "plan", {}),
            ("", ref_clip, "hash", {}),
            ("retail_", retail_clip, "hash", k28),
            ("", ref_clip, "link", {}),
            ("", ref_clip, "device", {"HVQM4_BENCH_STREAMS": "16"}),
            ("retail_", retail_clip, "device", k28),
            ("", ref_clip, "pipeline", pl2),
            ("retail_", retail_clip, "pipeline", pl2)]
    merged: dict = {}
    for prefix, clip_path, phase, extra in jobs:
        res = run_phase(phase, clip_path, extra)
        if res.get("backend", "gpu") != "gpu":
            print(f"bench: phase {phase} ran on {res['backend']!r}",
                  file=sys.stderr)
            return 1
        merged.update({prefix + k: v for k, v in res.items()})

    from hvqm4_jax.container import Demuxer

    cfg = Demuxer(ref_clip.read_bytes()).info.cfg

    def ratio(x, base):
        return round(x / base, 3) if base else 0.0

    pipeline_fps = merged["pipeline_fps"]
    device_fps = merged["device_fps"]
    out = {
        "metric": "fps_per_chip_640x480_full_pipeline",
        "clip": f"{cfg.width}x{cfg.height}",
        "value": pipeline_fps,
        "unit": "frames/s",
        "vs_baseline": ratio(pipeline_fps, base_fps),
        "device_fps": device_fps,
        "device_vs_baseline": ratio(device_fps, base_fps),
        "oracle_fps": round(base_fps, 2),
        "streams": n_streams,
        "planner": merged["planner"],
        "bitexact": merged["bitexact"],
        "bitexact_streams": merged["bitexact_streams"],
        "bitexact_frames": merged["bitexact_frames"],
        "backend": dev["backend"],
        "device_kind": dev["device_kind"],
        "device_count": dev["device_count"],
        # retail-bitrate corpus point (oracle denominator is ITS OWN run
        # on the same clip — light content speeds the oracle up too)
        "retail_pipeline_fps": merged["retail_pipeline_fps"],
        "retail_device_fps": merged["retail_device_fps"],
        "retail_oracle_fps": round(retail_base, 2),
        "retail_vs_baseline": ratio(merged["retail_pipeline_fps"],
                                    retail_base),
        "retail_device_vs_baseline": ratio(merged["retail_device_fps"],
                                           retail_base),
        "retail_bitexact": merged["retail_bitexact"],
        "plan_fps": merged["plan_fps"],
        "plan_vs_baseline": ratio(merged["plan_fps"], base_fps),
        "retail_plan_fps": merged["retail_plan_fps"],
        "retail_plan_vs_baseline": ratio(merged["retail_plan_fps"],
                                         retail_base),
    }
    for key in ("device_fps_samples", "device_fps_spread", "device_passes",
                "device_pass_mb", "device_streams",
                "retail_device_fps_samples",
                "retail_device_fps_spread", "retail_device_passes",
                "retail_device_pass_mb", "retail_device_streams",
                "link_h2d_gbps", "link_h2d_gbps_samples", "link_rtt_ms",
                "pipeline_split_ms_per_frame",
                "retail_pipeline_split_ms_per_frame",
                "device_fps_median", "retail_device_fps_median",
                "device_bytes_per_frame_by_field",
                "retail_device_bytes_per_frame_by_field",
                "device_packed_staging", "retail_device_packed_staging",
                "device_replay_bitexact", "retail_device_replay_bitexact"):
        if key in merged:
            out[key] = merged[key]
    out["device_median_vs_baseline"] = ratio(
        merged.get("device_fps_median", 0.0), base_fps)
    out["retail_device_median_vs_baseline"] = ratio(
        merged.get("retail_device_fps_median", 0.0), retail_base)
    for pfx in ("", "retail_"):
        mb, fr = merged.get(pfx + "device_pass_mb"), merged.get(
            pfx + "device_frames")
        if mb and fr:
            out[pfx + "device_mb_per_frame"] = round(mb / fr, 3)
            if merged.get("link_h2d_gbps"):
                out[pfx + "device_link_ceiling_fps"] = round(
                    merged["link_h2d_gbps"] * 1e3 / (mb / fr), 1)
    print(json.dumps(out))
    return 0 if out["bitexact"] and out["retail_bitexact"] else 1


if __name__ == "__main__":
    sys.exit(main())
