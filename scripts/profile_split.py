"""One-off: measure the host-side cost split of the production pipeline.

Times, per step over a real clip on the device:
  plan   — the batched C planner call (plan_step)
  xfer   — jnp.asarray of the two typed arenas (host->device serialization)
  step   — jitted step dispatch (async; queue cost only)
  sync   — block_until_ready at the end (device residue)

Run: python scripts/profile_split.py [n_streams]
"""
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from hvqm4_jax.utils.compile_cache import use_compile_cache  # noqa: E402

use_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bench import ensure_clip, REPO  # noqa: E402
from hvqm4_jax.native import NativePlanner  # noqa: E402
from hvqm4_jax.parallel.multistream import (  # noqa: E402
    MultiStreamDecoder, _arena_step)

n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
cfg, clip = ensure_clip(REPO / "testdata" / "ref640.h4m")

# warm pass: compile every tier this clip touches
ms = MultiStreamDecoder(cfg, [clip] * n, planner_factory=NativePlanner)
for _ in ms.run_pipelined():
    pass

ms = MultiStreamDecoder(cfg, [clip] * n, planner_factory=NativePlanner)
t_plan = t_xfer = t_step = 0.0
nsteps = 0
bytes_up = 0
last = None
t0 = time.perf_counter()
while any(ms.active):
    t = time.perf_counter()
    buf, metas, valid = ms.plan_step()
    t_plan += time.perf_counter() - t

    t = time.perf_counter()
    size8, size32 = buf["sizes"]
    h8 = buf["staging"]["u8"][0, :size8]
    h32 = buf["staging"]["u32"][0, :size32]
    if jax.default_backend() == "cpu":
        # same zero-copy aliasing guard as device_step: the ping-pong
        # staging is rewritten two steps later
        h8, h32 = h8.copy(), h32.copy()
    arenas = {"u8": jnp.asarray(h8), "u32": jnp.asarray(h32)}
    bytes_up += size8 + size32 * 4
    t_xfer += time.perf_counter() - t

    t = time.perf_counter()
    step_fn = _arena_step(ms.cfg, ms.n, 1, *buf["variant"])
    frames, ms.nest, ms.ref_prev, ms.ref_last = step_fn(
        arenas, ms.nest, ms.ref_prev, ms.ref_last)
    t_step += time.perf_counter() - t
    last = frames
    ms._cur ^= 1
    nsteps += 1

t = time.perf_counter()
jax.block_until_ready(last)
t_sync = time.perf_counter() - t
wall = time.perf_counter() - t0

fr = nsteps * n
print(f"streams={n} steps={nsteps} frames={fr} wall={wall:.2f}s "
      f"fps={fr / wall:.0f}")
print(f"per-step ms: plan={1e3 * t_plan / nsteps:.2f} "
      f"xfer={1e3 * t_xfer / nsteps:.2f} step={1e3 * t_step / nsteps:.2f} "
      f"sync_total={1e3 * t_sync:.1f}")
print(f"upload: {bytes_up / nsteps / 1024:.0f} KiB/step, "
      f"{bytes_up / wall / 1e6:.0f} MB/s effective")
