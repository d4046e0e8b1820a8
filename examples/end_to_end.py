"""End-to-end demo: encode real content → device decode → ViT embeddings.

    python examples/end_to_end.py [--width 128 --height 96 --frames 10]
    JAX_PLATFORMS=cpu python examples/end_to_end.py   # without a GPU

Walks the full framework surface:
1. synthesize a moving-pattern video (or load a raw .yuv with --input)
2. encode it to `.h4m` with the content-aware encoder (mode decision,
   half-pel motion search, B frames)
3. decode it on the default JAX device, bit-exact vs the stream
4. verify against the C oracle if built
5. convert to RGB on device and run the ViT feed, printing embedding stats
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from hvqm4_jax.config import SeqConfig  # noqa: E402
from hvqm4_jax.encode import VideoEncoder  # noqa: E402
from hvqm4_jax.models.vit import ViTConfig  # noqa: E402
from hvqm4_jax.pipeline import VideoEmbedPipeline  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


def synth_video(cfg: SeqConfig, n: int):
    h, w = cfg.plane_shapes[0]
    ch, cw = cfg.plane_shapes[1]
    frames = []
    for t in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (96 + 60 * np.sin(0.05 * xx + 0.3 * t) * np.cos(0.07 * yy))
        x0, y0 = (8 + 4 * t) % (w - 20), (6 + 3 * t) % (h - 20)
        y[y0:y0 + 20, x0:x0 + 20] = 235
        u = np.full((ch, cw), 96 + 8 * (t % 4), np.uint8)
        v = np.full((ch, cw), 150, np.uint8)
        frames.append([np.clip(y, 0, 255).astype(np.uint8), u, v])
    return frames


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=str(
        pathlib.Path(tempfile.gettempdir()) / "e2e_demo.h4m"))
    args = ap.parse_args()

    cfg = SeqConfig(args.width, args.height)
    frames = synth_video(cfg, args.frames)
    pattern = "I" + "BP" * ((args.frames - 1) // 2) + "P" * ((args.frames - 1) % 2)
    print(f"encoding {args.frames} frames ({pattern}) ...")
    t0 = time.time()
    clip = VideoEncoder(cfg, lambda_bits=2.0).encode(frames, [pattern])
    raw = cfg.frame_bytes * args.frames
    print(f"  {len(clip)} bytes ({raw / len(clip):.1f}x vs raw) "
          f"in {time.time() - t0:.1f}s")
    pathlib.Path(args.out).write_bytes(clip)

    oracle = REPO / "oracle" / "hvqm4_oracle"
    if oracle.exists():
        from hvqm4_jax.container import Demuxer
        from hvqm4_jax.planner import Planner
        from hvqm4_jax.refdec import GoldenDecoder
        from hvqm4_jax.utils.hashing import fnv1a_hex

        r = subprocess.run([str(oracle), "--hash", args.out, "/dev/null"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"C oracle failed: {r.stderr.strip()[:200]}")
        got = [ln.split("hash=")[1] for ln in r.stdout.splitlines()
               if "hash=" in ln]
        dec = GoldenDecoder(cfg)
        pl = Planner(cfg)
        want = [fnv1a_hex(b"".join(p.tobytes() for p in dec.decode(
            pl.plan_frame(rec.frame_char, rec.payload))))
            for rec in Demuxer(clip).video_records()]
        if got != want:
            raise SystemExit("C oracle output DIVERGES from the golden "
                             "decoder on this clip")
        print(f"  C oracle decoded {len(got)} frames, hashes match the "
              f"golden decoder")

    print("decoding + embedding on device ...")
    pipe = VideoEmbedPipeline(
        cfg, [clip], ViTConfig(image_size=96, patch_size=8, dim=192,
                               depth=4, heads=6))
    t0 = time.time()
    embs = [np.asarray(e)[0] for e, _m, v in pipe.run() if v[0]]
    if not embs:
        raise SystemExit("no frames decoded")
    print(f"  {len(embs)} embeddings of dim {embs[0].shape[0]} "
          f"in {time.time() - t0:.1f}s on "
          f"{__import__('jax').devices()[0].platform}")
    sims = [float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9))
            for a, b in zip(embs, embs[1:])]
    if sims:
        print(f"  adjacent-frame cosine similarity: "
              f"min {min(sims):.3f} max {max(sims):.3f}")


if __name__ == "__main__":
    main()
