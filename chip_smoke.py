"""Prove that the HVQM4 decode path runs on an NVIDIA GPU, end to end.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the sharded path only

One process holds the card(s). Each phase prints one JSON line with its
verdict, its wall time and the seconds XLA spent compiling in it:

  device        the JAX platform must be "gpu" (no fallback); card name and
                power limit from nvidia-smi, XLA_FLAGS, compile-cache dir
  build         the C oracle (`make -C oracle`) and the native planner
  multistream   8 streams of 640x480 (4x ref640 heavy, 4x retail640,
                interleaved) through `MultiStreamDecoder.run_pipelined`,
                every frame's FNV-1a against `oracle --hash`; then 8 retail
                streams at steps_per_dispatch=28 (the fused lax.scan step)
                checked by on-device checksum against `oracle --csum`
  gop_parallel  `decode_clip_gop_parallel` (the CLI's --gop-parallel)
  session       `DecoderSession` seeking by start_block: the oracle's tail
  serve         `DecodeServer` (continuous batching) in a thread of this
                process, `MuxClient` yuv requests for both clips; one rgb
                request against a NumPy BT.601 reference of the oracle's
                frames; one embed request against the same ViT on the CPU
  nest_search   the encoder's device nest search on a 640x480 I-frame
                against the same search on the CPU

With --four-cards only the sharded path runs (`__graft_entry__.
multichip_check`): 16 streams over a dp=4 mesh, once per step (K=1,
the decoder's default dispatch with its pool-tier step variants) and once
fused (K=28, one compiled step for the whole clip), then the ViT feed on a
(dp=2, tp=2) mesh against one card.

Frame rates printed here are smoke timings of one short run, shown beside
the card's name and power limit; they are not benchmark numbers. The last
line is {"ok": true, "device": {...}} only when every phase passed; a
failed phase exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import threading
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
HEAVY = REPO / "testdata" / "ref640.h4m"
RETAIL = REPO / "testdata" / "retail640.h4m"
ORACLE = REPO / "oracle" / "hvqm4_oracle"


class Smoke:
    """Runs phases, prints one verdict line each, remembers failures."""

    def __init__(self):
        self.ok = True
        self.compile_s = 0.0
        self.card = ""

    def on_event(self, event: str, duration: float, **_kw) -> None:
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration

    def run(self, name: str, fn, *args) -> bool:
        t0, c0 = time.perf_counter(), self.compile_s
        try:
            info, ok = fn(*args) or {}, True
        except Exception as e:  # noqa: BLE001 - reported, exits non-zero
            traceback.print_exc()
            info, ok = {"error": f"{type(e).__name__}: {e}"[:800]}, False
        self.ok &= ok
        print(json.dumps({"phase": name, "ok": ok,
                          "seconds": round(time.perf_counter() - t0, 3),
                          "compile_s": round(self.compile_s - c0, 3),
                          **info}), flush=True)
        return ok


# ---------------------------------------------------------------------------
# Oracle side
# ---------------------------------------------------------------------------

def oracle_lines(clip: pathlib.Path, flag: str) -> list[str]:
    from hvqm4_jax.utils.hashing import oracle_digests

    return oracle_digests(ORACLE, clip, flag)


def oracle_frames(clip: pathlib.Path, frame_bytes: int) -> list[bytes]:
    with tempfile.TemporaryDirectory() as td:
        out = pathlib.Path(td) / "o.yuv"
        subprocess.run([str(ORACLE), str(clip), str(out)], check=True)
        data = out.read_bytes()
    return [data[i:i + frame_bytes] for i in range(0, len(data), frame_bytes)]


def split_planes(frame: bytes, cfg) -> list[np.ndarray]:
    out, off = [], 0
    for h, w in cfg.plane_shapes:
        out.append(np.frombuffer(frame, np.uint8, h * w, off).reshape(h, w))
        off += h * w
    return out


def bt601_rgb(y, u, v, h_samp: int, v_samp: int) -> np.ndarray:
    """NumPy BT.601 full-range fixed point (the formula of ops/csc.py),
    chroma upsampled by replication."""
    u = np.repeat(np.repeat(u, v_samp, 0), h_samp, 1).astype(np.int64) - 128
    v = np.repeat(np.repeat(v, v_samp, 0), h_samp, 1).astype(np.int64) - 128
    yi = y.astype(np.int64)
    r = yi + ((91881 * v + 32768) >> 16)
    g = yi - ((22554 * u + 46802 * v + 32768) >> 16)
    b = yi + ((116130 * u + 32768) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(smoke: Smoke, cards: int) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default platform is "
                           f"{devs[0].platform!r}")
    if len(devs) < cards:
        raise RuntimeError(f"{cards} GPUs needed, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if not smi:
        raise RuntimeError("nvidia-smi printed no card")
    print(smi, flush=True)
    smoke.card = smi.splitlines()[0]
    return {"kind": devs[0].device_kind, "count": len(devs),
            "jax": jax.__version__, "card": smi.splitlines(),
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compile_cache": jax.config.jax_compilation_cache_dir}


def phase_build() -> dict:
    subprocess.run(["make", "-s", "-C", str(REPO / "oracle")], check=True)
    from hvqm4_jax import native

    native._load()
    return {"oracle": str(ORACLE.relative_to(REPO)),
            "planner": native._LIB.name}


def phase_multistream(smoke: Smoke, heavy: pathlib.Path,
                      retail: pathlib.Path, n: int = 8,
                      k_fused: int = 28) -> dict:
    import jax
    import jax.numpy as jnp

    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.native import NativePlanner
    from hvqm4_jax.parallel.multistream import MultiStreamDecoder
    from hvqm4_jax.utils.hashing import batch_csum_fn, stream_hashes

    paths = [heavy if i % 2 == 0 else retail for i in range(n)]
    clips = [p.read_bytes() for p in paths]
    cfg = Demuxer(clips[0]).info.cfg
    want = {p: oracle_lines(p, "hash") for p in (heavy, retail)}
    out = {"streams": n, "shape": f"{cfg.width}x{cfg.height}",
           "card": smoke.card}
    # two runs: the first compiles (or loads the compile cache)
    for run in ("first", "second"):
        ms = MultiStreamDecoder(cfg, clips, planner_factory=NativePlanner)
        t0 = time.perf_counter()
        got, _last = stream_hashes(ms.run_pipelined(), n)
        frames = sum(map(len, got))
        dt = time.perf_counter() - t0
        for si, p in enumerate(paths):
            assert got[si] == want[p], (
                f"K=1 {run} run, stream {si} ({p.name}): {len(got[si])} "
                f"frames, not the oracle's")
        out[f"k1_{run}_smoke_fps"] = round(frames / dt, 1)
    out["k1_frames_bitexact"] = frames

    # fused K-step dispatch on the retail clip, checked on device
    csum = batch_csum_fn()
    want_cs = oracle_lines(retail, "csum")
    rclip = retail.read_bytes()
    for run in ("first", "second"):
        ms = MultiStreamDecoder(cfg, [rclip] * n,
                                planner_factory=NativePlanner,
                                steps_per_dispatch=k_fused)
        t0 = time.perf_counter()
        cs = [csum(*frames) for frames, _m, _v in ms.run_pipelined()]
        allcs = np.asarray(jax.block_until_ready(jnp.stack(cs)))
        dt = time.perf_counter() - t0
        for si in range(n):
            got_cs = [f"{c:08x}" for c in allcs[:, si]]
            assert got_cs == want_cs, (
                f"K={k_fused} {run} run, stream {si}: on-device checksums differ "
                f"from oracle --csum")
        out[f"k{k_fused}_{run}_smoke_fps"] = round(allcs.size / dt, 1)
    out[f"k{k_fused}_frames_bitexact"] = int(allcs.size)
    return out


def phase_gop_parallel(heavy: pathlib.Path) -> dict:
    from hvqm4_jax.native import NativePlanner
    from hvqm4_jax.parallel.multistream import decode_clip_gop_parallel
    from hvqm4_jax.utils.hashing import fnv1a_hex

    want = oracle_lines(heavy, "hash")
    got = [fnv1a_hex(yuv) for _b, yuv in decode_clip_gop_parallel(
        heavy.read_bytes(), planner_factory=NativePlanner)]
    assert got == want, f"{len(got)} of {len(want)} frames, mismatch"
    return {"frames_bitexact": len(got)}


def phase_session(heavy: pathlib.Path) -> dict:
    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.session import DecoderSession
    from hvqm4_jax.utils.hashing import fnv1a_hex

    clip = heavy.read_bytes()
    d = Demuxer(clip)
    start = len(d.block_offsets) - 1
    skip = sum(d.block_video_counts()[:start])
    want = oracle_lines(heavy, "hash")[skip:]
    sess = DecoderSession(d.info.cfg, backend="jax")
    got = [fnv1a_hex(f.yuv_bytes())
           for f in sess.decode_clip(clip, start_block=start)]
    assert got == want, f"seek to block {start}: {len(got)} frames, mismatch"
    return {"start_block": start, "frames_bitexact": len(got)}


def phase_serve(heavy: pathlib.Path, retail: pathlib.Path,
                vit_cfg=None) -> dict:
    import jax

    from hvqm4_jax import serve
    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.models.vit import EMBED_RTOL, embedding_error, vit_encode
    from hvqm4_jax.ops.csc import frame_to_rgb, resize_bilinear
    from hvqm4_jax.utils.hashing import fnv1a_hex

    cfg = Demuxer(retail.read_bytes()).info.cfg
    want = {p: oracle_lines(p, "hash") for p in (heavy, retail)}
    srv = serve.DecodeServer(("127.0.0.1", 0), backend="jax",
                             batch_window_s=0.05, max_batch=8,
                             vit_cfg=vit_cfg)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address
    try:
        with serve.MuxClient(host, port) as cli:
            order = [heavy, retail, heavy, retail]
            ids = [cli.submit(p.read_bytes(), serve.MODE_YUV) for p in order]
            for rid, p in zip(ids, order):
                got = [fnv1a_hex(c) for c in cli.result(rid)]
                assert got == want[p], f"yuv request {rid} ({p.name})"
            rgb = cli.decode(retail.read_bytes(), serve.MODE_RGB)
            emb = cli.decode(retail.read_bytes(), serve.MODE_EMBED)
        vcfg, params = srv._vit
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)

    frames = oracle_frames(retail, cfg.frame_bytes)
    assert len(rgb) == len(frames), (len(rgb), len(frames))
    for i, (chunk, fr) in enumerate(zip(rgb, frames)):
        ref = bt601_rgb(*split_planes(fr, cfg), cfg.h_samp, cfg.v_samp)
        assert chunk == ref.tobytes(), f"rgb frame {i} differs"

    # the same ViT on the CPU device, from the oracle's frames, with the
    # server's own weights
    cpu = jax.devices("cpu")[0]
    got = np.stack([np.frombuffer(c, "<f4") for c in emb])
    planes = [np.stack(ps) for ps in zip(*(split_planes(f, cfg)
                                           for f in frames))]
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, y, u, v: vit_encode(
            p, vcfg, jax.vmap(lambda im: resize_bilinear(
                im, vcfg.image_size, vcfg.image_size))(
                    frame_to_rgb([y, u, v], cfg.h_samp, cfg.v_samp))))(
            jax.device_put(jax.device_get(params), cpu),
            *(jax.device_put(p, cpu) for p in planes))
    err = embedding_error(got, ref)
    assert err <= EMBED_RTOL, f"embed relative error {err:.4g}"
    return {"yuv_requests": len(ids), "rgb_frames_exact": len(rgb),
            "embed_frames": len(emb), "embed_rel_err": err,
            "embed_rtol": EMBED_RTOL}


def phase_nest_search(heavy: pathlib.Path) -> dict:
    import jax

    from hvqm4_jax.container import Demuxer
    from hvqm4_jax.native import NativePlanner
    from hvqm4_jax.nest_search import NestSearch

    clip = heavy.read_bytes()
    d = Demuxer(clip)
    cfg = d.info.cfg
    rec = next(r for r in d.video_records() if r.frame_char == "I")
    nest = NativePlanner(cfg).plan_frame("I", rec.payload).nest
    y = split_planes(oracle_frames(heavy, cfg.frame_bytes)[0], cfg)[0]
    h, w = y.shape
    blocks = (y.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3)
              .reshape(-1, 16).astype(np.int32))
    dcs = np.clip(np.round(blocks.mean(1)), 0, 255).astype(np.int32)
    resid = blocks - dcs[:, None]

    dev = NestSearch(nest).best(resid)
    with jax.default_device(jax.devices("cpu")[0]):
        host = NestSearch(nest).best(resid)
    diff = np.flatnonzero((dev[0] != host[0]).any(1))
    nh, nw = nest.shape

    def score(desc, terms):
        nx, ny, sxb, syb, off = (int(v) for v in desc)
        rows = (ny + np.arange(4) * (syb + 1)) % nh
        cols = (nx + np.arange(4) * (sxb + 1)) % nw
        c = nest[np.ix_(rows, cols)].astype(np.int64).reshape(16) - off
        return c, terms

    for i in diff:
        c_a, t_a = score(dev[0][i], dev[1][i])
        c_b, t_b = score(host[0][i], host[1][i])
        r = resid[i].astype(np.int64)
        # the device search's own gain, dot^2 / |c|^2, in float32
        g_a = np.float32(r @ c_a) ** 2 / np.float32(c_a @ c_a)
        g_b = np.float32(r @ c_b) ** 2 / np.float32(c_b @ c_b)
        sse_a = int(((r - (t_a >> 4)) ** 2).sum())
        sse_b = int(((r - (t_b >> 4)) ** 2).sum())
        assert g_a == g_b and sse_a == sse_b, (
            f"block {i}: device and CPU pick different candidates "
            f"(gains {g_a} vs {g_b}, sse {sse_a} vs {sse_b})")
    return {"blocks": int(len(resid)), "candidates": int(len(NestSearch(
        nest).desc)), "tied_differences": int(len(diff))}


def phase_four_cards(heavy: pathlib.Path, retail: pathlib.Path,
                     vit_cfg, ks=(1, 28)) -> dict:
    import jax

    import __graft_entry__ as graft

    paths = [heavy if i % 2 == 0 else retail for i in range(16)]
    want = {p: oracle_lines(p, "hash") for p in (heavy, retail)}
    return graft.multichip_check(
        jax.devices()[:4], [p.read_bytes() for p in paths],
        [want[p] for p in paths], vit_cfg, ks=ks)


def result_line(devices) -> dict:
    """The last line of a passing run: the devices it ran on, as JAX
    reports them."""
    return {"ok": True, "device": {"platform": devices[0].platform,
                                   "kind": devices[0].device_kind,
                                   "count": len(devices)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path, on four GPUs")
    args = ap.parse_args(argv)
    cards = 4 if args.four_cards else 1
    sys.path.insert(0, str(REPO))
    try:
        from hvqm4_jax.utils.compile_cache import use_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the hvqm4_jax package is not next to "
              f"{pathlib.Path(__file__).name}: {e}", file=sys.stderr)
        return 2
    use_compile_cache()
    # the CPU backend must exist beside the GPU for the CPU references
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax

    smoke = Smoke()
    jax.monitoring.register_event_duration_secs_listener(smoke.on_event)
    t0 = time.perf_counter()
    if not smoke.run("device", phase_device, smoke, cards):
        return 1
    if not smoke.run("build", phase_build):
        return 1
    if args.four_cards:
        from hvqm4_jax.models.vit import ViTConfig

        smoke.run("four_cards", phase_four_cards, HEAVY, RETAIL, ViTConfig())
    else:
        smoke.run("multistream", phase_multistream, smoke, HEAVY, RETAIL)
        smoke.run("gop_parallel", phase_gop_parallel, HEAVY)
        smoke.run("session", phase_session, HEAVY)
        smoke.run("serve", phase_serve, HEAVY, RETAIL)
        smoke.run("nest_search", phase_nest_search, HEAVY)
    print(json.dumps({"total_s": round(time.perf_counter() - t0, 3),
                      "compile_s": round(smoke.compile_s, 3),
                      "all_phases_ok": smoke.ok}), flush=True)
    if not smoke.ok:
        return 1
    print(json.dumps(result_line(jax.devices()[:cards])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
