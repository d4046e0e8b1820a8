"""Oracle-compatible frame hashing.

Two frame digests, each implemented identically by `oracle/hvqm4_oracle.c`:

- FNV-1a (`oracle --hash`): byte-serial, the CI-grade digest. Used by the CLI
  `hash` subcommand and `__graft_entry__.dryrun_multichip`. Inherently
  sequential, so computing it requires the full frame on the host.
- wsum32 (`oracle --csum`): position-weighted u32 sum — a commutative
  reduction, so the device pipeline computes it ON DEVICE (`frame_csum`
  below) and transfers 4 bytes per frame instead of the full YUV. This is
  what `bench.py`'s bit-exactness phase and `cli verify --device` use.
"""

from __future__ import annotations

import numpy as np

_K = 2654435761  # Knuth multiplicative constant; weight_i = i*K + 1 (mod 2^32)


_native_fnv = None   # unresolved; False = unavailable (failure cached —
                     # retrying would re-run the g++ build per call)


def fnv1a(data: bytes) -> int:
    # the recurrence h' = (h ^ b) * p is byte-serial by construction; the
    # native planner exports a C implementation (fnv1a in _entropy.cc) that
    # the CLI prefers — this pure-Python form is the always-available fallback
    global _native_fnv
    if _native_fnv is None:
        try:
            from ..native import native_fnv1a as _native_fnv
        except Exception:
            _native_fnv = False
    if _native_fnv:
        return _native_fnv(data)
    h = 2166136261
    for b in data:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def fnv1a_hex(data: bytes) -> str:
    return f"{fnv1a(data):08x}"


def wsum32(data: bytes, off: int = 0) -> int:
    """Host (numpy) implementation of `oracle --csum`:
    sum_i (data[i]+1) * ((off+i)*K + 1) mod 2^32."""
    b = np.frombuffer(data, np.uint8).astype(np.uint64) + 1
    i = np.arange(off, off + len(b), dtype=np.uint64)
    w = (i * _K + 1) & 0xFFFFFFFF
    return int(np.sum(b * w) & 0xFFFFFFFF)


def wsum32_hex(data: bytes) -> str:
    return f"{wsum32(data):08x}"


def oracle_digests(oracle_path, clip_path, flag: str) -> list[str]:
    """Per-frame digests from `oracle --hash` (flag "hash": FNV-1a) or
    `oracle --csum` (flag "csum": wsum32) — the ONE parse of that output
    format (bench's hash phase, `cli verify --device`, `chip_smoke.py` and
    `__graft_entry__` all compare against it)."""
    import subprocess

    res = subprocess.run([str(oracle_path), f"--{flag}", str(clip_path),
                          "/dev/null"],
                         check=True, capture_output=True, text=True)
    return [line.split(f"{flag}=")[1] for line in res.stdout.splitlines()
            if f"{flag}=" in line]


def stream_hashes(batches, n_streams: int):
    """FNV-1a of every valid frame of every stream, from (frames, metas,
    valid) batches as `MultiStreamDecoder.run_pipelined()` yields them.
    Returns (per-stream lists of hex digests, the last batch's planes on
    the host)."""
    got: list[list[str]] = [[] for _ in range(n_streams)]
    fnp = None
    for frames, _metas, valid in batches:
        fnp = [np.asarray(p) for p in frames]
        for si, ok in enumerate(valid):
            if ok:
                got[si].append(fnv1a_hex(b"".join(
                    p[si].tobytes() for p in fnp)))
    return got, fnp


def batch_csum_fn():
    """Jitted (Y, U, V) batched-frame checksum: (N,H,W) planes → (N,) u32,
    each element == `oracle --csum` for that stream's frame."""
    import jax

    return jax.jit(jax.vmap(lambda y, u, v: frame_csum([y, u, v])))


def frame_csum(planes):
    """On-device wsum32 of one frame's YUV bytes (planes concatenated in
    Y,U,V order, row-major). planes: [(H, W) u8 jax arrays]. Returns a u32
    scalar equal to `oracle --csum` / `wsum32(yuv_bytes)`. vmap over a
    leading stream axis for batched use."""
    import jax.numpy as jnp

    acc = jnp.zeros((), jnp.uint32)
    off = 0
    for p in planes:
        n = int(np.prod(p.shape[-2:]))
        flat = p.reshape(-1).astype(jnp.uint32) + 1
        i = jnp.arange(off, off + n, dtype=jnp.uint32)
        w = i * jnp.uint32(_K & 0xFFFFFFFF) + 1
        acc = acc + jnp.sum(flat * w, dtype=jnp.uint32)
        off += n
    return acc
