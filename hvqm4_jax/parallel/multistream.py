"""Multi-stream decode: N independent `.h4m` streams per device (BASELINE config 4).

Single-stream decode underutilizes an accelerator (a 640×480 frame is
small); the production configuration batches N streams with `vmap` so every kernel works
on (N, ...) tensors, and reference/nest state lives on device as stacked
arrays updated functionally inside one jitted step — the decode analogue of a
training step:

    (plans, nest, ref_prev, ref_last) → (frames, nest', ref_prev', ref_last')

Streams advance in lock-step by *decode index*; per-stream frame types may
differ (the step is type-agnostic: I-frames are all-intra plans whose nest
slot is refreshed, reference rotation is masked per stream). Finished or
corrupt streams are masked inactive and decode a trivial plan (SURVEY.md §5
"fail per-stream without killing the batch").

Host-side cost engineering:
- one batch C call per step plans every stream into per-stream contiguous
  scratch (plan fields, sparse raw/desc/dc pools, upload-form packed meta,
  per-frame mv-variant flags) — no per-frame allocation;
- `_assemble` then packs two dtype-homogeneous staging buffers (u8 + u32)
  in the step's VARIANT layout (v6 "offset-packed pools + coded meta +
  pooled mv2" — see `_layout`): per-slot pool prefixes back-to-back at
  host-computed bases that travel as data, meta as per-slot codebook
  indices at the narrowest width that fits (3-6 bits), forward vectors
  s8-packed with a wide escape, refsel-2 second vectors in a meta-derived
  pool, nest bytes only on I slots — so each step is two h2d transfers
  carrying the SUM of used prefixes (~35 KB/frame at 640×480 retail at
  ANY fused-dispatch factor);
- device state buffers are donated to the step so XLA updates them in place;
- `run_pipelined` plans step k+1 on a worker thread (the C++ planner releases
  the GIL) while the device executes step k.

Sharding (ONE code path with single-chip): the staging buffers are
(S, row_len) — one row per shard of the mesh axis carrying the stream
dimension, each row laid out exactly like the single-chip row for the
shard's n/S streams. The jitted mesh step is `jax.shard_map` of the *same*
step body over that axis, so every chip runs the identical unpack + decode
the single-chip benchmark runs, and no cross-chip communication exists on
the decode path (the correct answer for this workload — SURVEY.md §2.6:
streams are independent; collectives only appear downstream, e.g.
tensor-parallel ViT).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MAX_BASES, SeqConfig
from ..container import Demuxer
from ..ops import device_core
from ..planner import PlannerError
from ..plans import FramePlan

# Per-plane packed fields handed to the C planner (ABI order). `slot` is the
# unified sparse-payload index: a raw-pool slot for raw blocks, a desc-pool
# start otherwise (mutually exclusive per block; meta disambiguates). The
# planner allocates slots in canonical order (plane-major, row-major block
# scan), which makes every slot value an exclusive cumsum over meta-derived
# counts — so slot arrays are host-side scratch and are NEVER uploaded: the
# jitted step recomputes them from meta (see `_derive_slots`).
_PLANE_KEYS = ("meta", "dc", "slot", "meta5")

# Per-step motion-vector encoding of the FIRST (forward) vector grid (part
# of the step variant; each variant is its own persistently-cached compiled
# step). Second (refsel-2 backward) vectors do not ride a dense field at
# all since layout v6: they live in a meta-derived pool appended after each
# slot's desc prefix in the packed u32 region — bi MBs are identifiable
# in-jit from the luma meta (cls==1 & refsel==2 at the MB's top-left
# block), so the pool needs no index upload and costs ZERO bytes on steps
# without bi MBs (measured: mv2 carriers are ~5-6% of MBs on both corpora
# while the dense mv2 half of the old PACKED/WIDE encodings cost 4-19
# KB/frame).
#   NONE    no mv field uploaded — every FORWARD vector in the step is zero
#           (all-I steps, and P steps that happen to be all-copy)
#   PACKED8 TWO MBs per u32 (x.s8, y.s8 each): every mv fits s8 — ±127
#           half-pel covers ±63 px, effectively every real stream
#   WIDE    one u32 per MB (y16 << 16 | x16) — the mv_extreme escape tier
# (mode value 2 was the retired PACKED encoding; 3 keeps its value so
# persistent-cache keys stay distinct from historical PACKED entries)
_MV_NONE, _MV_PACKED8, _MV_WIDE = 0, 1, 3


# ---------------------------------------------------------------------------
# Staging layout: two dtype-homogeneous upload buffers per step (u8 / u32)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pool_caps(cfg: SeqConfig):
    """(raw_cap_full, desc_cap_full, dc_cap_full): worst-case pool slots
    for one frame."""
    total_blocks = sum(bh * bw for bh, bw in cfg.block_grids)
    return total_blocks, MAX_BASES * total_blocks, total_blocks


@functools.lru_cache(maxsize=None)
def _layout(cfg: SeqConfig, n: int, p8_cap: int, p32_cap: int,
            mv_mode: int, has_nest: bool, meta_bits: int = 6):
    """Static element layout of the two staging uploads for one step variant
    (v6 "offset-packed pools + coded meta + pooled mv2").

    u8  = [packed pool region, p8_cap bytes: per-slot segments back-to-back
           (raw ru*16 B, 16-aligned | dc cu B | nest nh*nw B on I slots),
           quantized to a 17/16 ladder | is_i | is_ref | meta codebook
           (n, 1<<meta_bits) when meta_bits < 6]
    u32 = [packed region, p32_cap elems: per-slot prefixes back-to-back —
           desc entries then refsel-2 mv2 pool words (y16 << 16 | x16) —
           | offs (n, 4): per-slot bases (raw B, dc B, nest B, u32 elem)
           | meta planes ×3: ⌊32/meta_bits⌋ codebook indices per u32
           (meta_bits == 6: raw meta values, 5 per u32, no codebook)
           | mv field (see _MV_*)]

    Two dtype-homogeneous buffers → two h2d transfers per step (a single
    mixed-dtype buffer would need an in-jit bitcast; not yet tried on the
    GPU, ROADMAP design item 4). The planner writes every field into
    per-stream CONTIGUOUS scratch (pool stride 1 — cache-friendly at any
    stream count); `_assemble` packs the staging buffers post-planning once
    the step's sizes/modes are known. Unlike the v4 layout — per-slot tier
    REGIONS sized by the max used across every slot of the dispatch — the
    packed region transfers the SUM of used prefixes: under fused K-step
    dispatch one I frame no longer inflates all n*K slots to its intra-heavy
    pool sizes (measured at 640×480 retail K=8: 92.6 → ~56 KB/frame). The
    executable stays one-per-variant because the per-slot bases travel as
    DATA (the `offs` field feeds the in-jit gathers), not as shapes; only
    the two quantized region sizes are static.

    Meta rides as per-slot CODEBOOK indices since v6: real frames use few
    distinct meta bytes (measured ≤12 retail / ≤21 heavy per frame of 64
    possible), so the assembler emits each slot's sorted distinct values
    (≤ 2^meta_bits entries) plus meta_bits-bit indices — 23.0 → 14.4
    KB/frame at 640×480 with meta_bits=4. meta_bits=6 is the no-codebook
    escape for adversarial content (>32 distinct values).

    Returns ({u8 field → (elem_off, shape)}, {u32 ...}, size8, size32).
    """
    u8: dict = {"is_i": (p8_cap, (n,)), "is_ref": (p8_cap + n, (n,))}
    size8 = p8_cap + 2 * n
    if meta_bits < 6:
        u8["metacb"] = (size8, (n, 1 << meta_bits))
        size8 += n * (1 << meta_bits)
    u32: dict = {"offs": (p32_cap, (n, 4))}
    off = p32_cap + 4 * n
    per_word = 32 // meta_bits      # 5 @6 bits, 6 @5, 8 @4, 10 @3
    for pi, (bh, bw) in enumerate(cfg.block_grids):
        nwm = (bh * bw + per_word - 1) // per_word
        u32[f"meta{pi}"] = (off, (n, nwm))
        off += n * nwm
    mh, mw = cfg.mb_grid
    if mv_mode == _MV_PACKED8:
        mwp = (mh * mw + 1) // 2    # two MBs per u32
        u32["mvp8"] = (off, (n, mwp))
        off += n * mwp
    elif mv_mode == _MV_WIDE:
        u32["mv"] = (off, (n, mh, mw))
        off += n * mh * mw
    size32 = off
    return u8, u32, size8, size32


@functools.lru_cache(maxsize=None)
def _packed_tiers(full: int):
    """Size ladder for a packed region: geometric 17/16 steps from a 4096
    floor up to the worst case. A step's totals cluster within ±3% for
    same-type frames, so the ladder's job is only to merge those clusters
    into one (persistently cached) compiled step each; 17/16 keeps the
    mean transfer overshoot ~3% (9/8 measured 9.3% tier pad on the heavy
    corpus's desc region — 9.7 KB/frame of real transfer; a 4/3 ladder
    measured +28-33%), tightening to 33/32 (~1.5% mean) above 64 Ki
    elements where a rung's pad is real kilobytes per step (heavy
    16-stream u32 region ~1.7 MB/step: measured 3.2 KB/frame of tier pad
    under 17/16). The finer ladder roughly doubles the POSSIBLE variant
    count in the big-region range, but the variants a given clip actually
    compiles stay few (per-frame totals cluster) and each is persistently
    cached. Values are 16-multiples so the u8 region keeps raw segments
    aligned at any tier."""
    ts, v = [], 4096
    while v < full:
        ts.append(v)
        num, den = (33, 32) if v >= 65536 else (17, 16)
        v = (v * num // den + 15) & ~15
    ts.append(full)
    return tuple(ts)


def _pick_tier(used: int, full: int) -> int:
    for t in _packed_tiers(full):
        if used <= t:
            return t
    return full


def _unpack_arena(cfg: SeqConfig, n: int, arenas: dict,
                  p8_cap: int, p32_cap: int,
                  mv_mode: int, has_nest: bool, meta_bits: int = 6):
    """In-jit: staging buffers → (plane plan dicts, new_nest|None, is_i,
    is_ref).

    Variant parameters are static (one compiled step per variant). Pool
    payloads are materialized in the device core's plane-layout contract
    (raw as (n, H, W) pixels, desc component-major (n, 4, bh, bw)) by
    gathers straight from the packed pool regions — no intermediate
    carries a trailing dim of 4/16. Each
    slot's pool bases come from the uploaded `offs` field (v5 layout):
    the gather indices were already data-dependent (block slots derive
    from meta cumsums), so a data-dependent base changes nothing about
    how XLA compiles the gathers — while letting the upload carry exact
    used prefixes instead of max-sized per-slot regions. v6 additions:
    meta decodes through a per-slot codebook gather when meta_bits < 6,
    and refsel-2 second vectors gather from a meta-derived pool after
    each slot's desc prefix (base = desc base + meta-derived desc count;
    entry k belongs to the k-th bi MB in row-major MB scan order).
    """
    u8l, u32l, _s8, _s32 = _layout(cfg, n, p8_cap, p32_cap,
                                   mv_mode, has_nest, meta_bits)

    def fld(group, lay, name):
        off, shape = lay[name]
        elems = int(np.prod(shape))
        return jax.lax.slice(arenas[group], (off,),
                             (off + elems,)).reshape(shape)

    sra = device_core._sra
    planes = [dict() for _ in cfg.block_grids]
    per_word = 32 // meta_bits
    mmask = (1 << meta_bits) - 1
    if meta_bits < 6:
        cb = fld("u8", u8l, "metacb").astype(jnp.int32)  # (n, 1<<B)
    for pi, (bh, bw) in enumerate(cfg.block_grids):
        # per_word B-bit values per u32, block-scan order
        w = fld("u32", u32l, f"meta{pi}")
        parts = jnp.stack([(w >> (meta_bits * j)) & mmask
                           for j in range(per_word)],
                          axis=-1).reshape(n, -1)
        vals = jax.lax.slice_in_dim(parts, 0, bh * bw, axis=1)
        if meta_bits < 6:   # codebook indices → meta bytes (one gather)
            vals = jnp.take_along_axis(cb, vals.astype(jnp.int32), axis=1)
        planes[pi]["meta"] = vals.reshape(n, bh, bw).astype(jnp.uint8)

    # forward motion vectors at MB resolution (n, mh, mw) i32
    mh, mw = cfg.mb_grid
    if mv_mode == _MV_NONE:
        z = jnp.zeros((n, mh, mw), jnp.int32)
        mvc = {"mv": (z, z)}
    elif mv_mode == _MV_PACKED8:
        w = fld("u32", u32l, "mvp8").astype(jnp.int32)

        def s8p(k):  # byte k of each u32, sign-extended
            b = sra(w, 8 * k) & 0xFF
            return b - ((b & 0x80) << 1)

        # interleave the two MBs per word back into scan order
        def lanes(x0, x1):
            v = jnp.stack([x0, x1], axis=-1).reshape(n, -1)
            return jax.lax.slice_in_dim(v, 0, mh * mw, axis=1).reshape(
                n, mh, mw)

        mvc = {"mv": (lanes(s8p(0), s8p(2)), lanes(s8p(1), s8p(3)))}
    else:
        v = fld("u32", u32l, "mv").astype(jnp.int32)
        mvc = {"mv": (sra(v << 16, 16), sra(v, 16))}

    extras = {name: fld("u8", u8l, name) for name in ("is_i", "is_ref")}

    # packed pool regions + per-slot bases (offs columns: raw B, dc B,
    # nest B, desc elem). Final indices are clipped into the region; for
    # valid blocks they are in-bounds by construction, and every
    # out-of-construction read (filler slots, non-carrying blocks, non-I
    # nest rows) is masked downstream by meta/is_i.
    pool8 = jax.lax.slice(arenas["u8"], (0,), (p8_cap,))
    desc_flat = jax.lax.slice(arenas["u32"], (0,), (p32_cap,))
    offs = fld("u32", u32l, "offs").astype(jnp.int32)
    raw_b, dc_b = offs[:, 0], offs[:, 1]
    nest_b, desc_e = offs[:, 2], offs[:, 3]

    nh, nw = cfg.nest_shape
    new_nest = None
    if has_nest:
        nidx = jnp.clip(nest_b[:, None] + jnp.arange(nh * nw,
                                                     dtype=jnp.int32)[None],
                        0, p8_cap - 1)
        new_nest = jnp.take(pool8, nidx).reshape(n, nh, nw)

    slots, dc_slots, desc_tot = _derive_slots(
        cfg, n, [pp["meta"] for pp in planes])

    # refsel-2 (bi) second vectors: pool entries (y16 << 16 | x16) after
    # each slot's desc prefix; entry k = the k-th bi MB in row-major MB
    # scan. Carrier-ness comes from the luma meta at each MB's top-left
    # block (cls==1 & refsel==2), so no index field is uploaded and the
    # pool is empty on steps without bi MBs.
    m0 = planes[0]["meta"].astype(jnp.int32)
    mbm = m0[:, ::2, ::2].reshape(n, -1)           # (n, mh*mw)
    carrier = ((sra(mbm, 5) & 1) != 0) & ((sra(mbm, 3) & 3) == 2)
    ci = carrier.astype(jnp.int32)
    # desc base + meta-derived desc count = this slot's mv2 pool base
    pos = jnp.cumsum(ci, axis=1) - ci
    mv2_base = desc_e + desc_tot
    m2idx = jnp.clip(mv2_base[:, None] + pos, 0, p32_cap - 1)
    w2 = jnp.where(carrier, jnp.take(desc_flat, m2idx),
                   jnp.uint32(0)).astype(jnp.int32)
    mvc["mv2"] = (sra(w2 << 16, 16).reshape(n, mh, mw),
                  sra(w2, 16).reshape(n, mh, mw))

    for pi, pp in enumerate(planes):
        bh, bw = cfg.block_grids[pi]
        H, W = bh * 4, bw * 4
        y = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
        x = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
        blk = (y >> 2) * bw + (x >> 2)
        slot = slots[pi].astype(jnp.int32)
        # raw: one gather lands the pixels directly in plane layout
        slot_up = jax.vmap(lambda s: jnp.take(s.reshape(-1), blk))(slot)
        k = (y & 3) * 4 + (x & 3)
        ridx = jnp.clip(raw_b[:, None, None] + slot_up * 16 + k[None],
                        0, p8_cap - 1)
        pp["raw"] = jnp.take(pool8, ridx)
        # desc: (n, 4, bh, bw) component-major
        start = slots[pi].astype(jnp.int32)
        didx = jnp.clip(
            desc_e[:, None, None, None] + start[:, None]
            + jnp.arange(4, dtype=jnp.int32)[None, :, None, None],
            0, p32_cap - 1)
        pp["desc"] = jnp.take(desc_flat, didx)
        # dc grid: sparse pool gather for DC-carrying blocks (intra,
        # mode != 6), constant 128 elsewhere — exactly the planner's dense
        # grid semantics
        m = pp["meta"].astype(jnp.int32)
        is_dc = ((sra(m, 5) & 1) == 0) & ((m & 7) != 6)
        ds = jnp.clip(dc_b[:, None, None] + dc_slots[pi].astype(jnp.int32),
                      0, p8_cap - 1)
        pp["dc"] = jnp.where(is_dc, jnp.take(pool8, ds), 128
                             ).astype(jnp.uint8)
        # chroma half-pel value shift on the shared MB-resolution vectors
        chroma_mb = pi > 0 and cfg.h_samp == 2
        for key in ("mv", "mv2"):
            mvx, mvy = mvc[key]
            if chroma_mb:
                mvx, mvy = sra(mvx, 1), sra(mvy, 1)
            pp[key] = jnp.stack([mvx, mvy], axis=1)
    return planes, new_nest, extras["is_i"] != 0, extras["is_ref"] != 0


def _derive_slots(cfg: SeqConfig, n: int, metas: list):
    """Recompute each block's pool slots from meta alone (in-jit).

    The planner allocates raw/desc/dc pool slots in canonical order — plane
    major, row-major block scan — so a block's raw index is the exclusive
    cumsum of `is_raw`, its desc start the exclusive cumsum of the
    per-block descriptor count, and its dc slot the exclusive cumsum of
    `is_dc` (intra non-raw), all over the concatenated planes. A block is
    never both raw and descriptor-carrying, so those two cumsums share one
    output field (the inapplicable gather is masked by meta downstream).
    This replaces dense u32 uploads per block with ~µs of device work.

    Returns (per-plane unified raw/desc slots, per-plane dc slots,
    per-slot total desc count (n,) i32 — the v6 mv2 pool base offset).
    """
    flat = jnp.concatenate(
        [m.reshape(n, -1).astype(jnp.int32) for m in metas], axis=1)
    cls_ = (flat >> 5) & 1
    mode = flat & 7
    counts = device_core.basis_count(cls_, mode)
    is_raw = ((cls_ == 0) & (mode == 6)).astype(jnp.int32)
    csum = jnp.cumsum(counts, axis=1)
    slot_flat = jnp.where(
        is_raw != 0,
        jnp.cumsum(is_raw, axis=1) - is_raw,
        csum - counts).astype(jnp.uint32)
    is_dc = ((cls_ == 0) & (mode != 6)).astype(jnp.int32)
    dc_flat = (jnp.cumsum(is_dc, axis=1) - is_dc).astype(jnp.uint32)
    out, out_dc, off = [], [], 0
    for bh, bw in cfg.block_grids:
        out.append(jax.lax.slice_in_dim(slot_flat, off, off + bh * bw, axis=1)
                   .reshape(n, bh, bw))
        out_dc.append(jax.lax.slice_in_dim(dc_flat, off, off + bh * bw,
                                           axis=1).reshape(n, bh, bw))
        off += bh * bw
    return out, out_dc, csum[:, -1]


# ---------------------------------------------------------------------------
# The decode step
# ---------------------------------------------------------------------------

def _step_body(plane_plans: list, nest, new_nest, is_i, is_ref,
               ref_prev: list, ref_last: list):
    if new_nest is not None:  # None: statically no I frame in the step
        nest = jnp.where(is_i[:, None, None], new_nest, nest)
    frames = []
    for pi, plans in enumerate(plane_plans):
        frames.append(jax.vmap(device_core.decode_plane_inter)(
            plans, nest, ref_prev[pi], ref_last[pi]))
    m = is_ref
    new_prev = [jnp.where(m[:, None, None], ref_last[pi], ref_prev[pi])
                for pi in range(3)]
    new_last = [jnp.where(m[:, None, None], frames[pi], ref_last[pi])
                for pi in range(3)]
    return frames, nest, new_prev, new_last


@functools.partial(jax.jit, donate_argnums=(1, 5, 6))
def multi_frame_step(plane_plans: list, nest, new_nest, is_i, is_ref,
                     ref_prev: list, ref_last: list):
    """One lock-step decode of N streams (reference form; per-field inputs).

    plane_plans: [plan_dict(N,...)] for Y,U,V     is_i/is_ref: (N,) bool
    nest/new_nest: (N, nh, nw) u8                 ref_*: [(N, ph, pw) u8] x3
    Returns (frames [3], nest', ref_prev', ref_last'). State args are donated.
    """
    return _step_body(plane_plans, nest, new_nest, is_i, is_ref,
                      ref_prev, ref_last)


def _run_steps(cfg: SeqConfig, n: int, k_steps: int,
               p8_cap: int, p32_cap: int,
               mv_mode: int, has_nest: bool, meta_bits: int,
               arenas, nest, ref_prev, ref_last):
    """The shared step body (single-chip jit AND per-shard under shard_map):
    1-D typed arenas for n*k_steps virtual streams → K sequential lock-step
    decodes of n streams.

    With k_steps == 1 frames are [3 x (n, H, W)]; with fused dispatch they
    are stacked per step [3 x (K, n, H, W)] (one upload + one executable
    amortizes the per-dispatch and per-transfer fixed costs K-fold).
    Virtual slot k*n+j is stream j's k-th
    frame ahead, so the host planner and the slot-derivation logic are
    exactly the (n*K)-stream ones.
    """
    nv = n * k_steps
    plane_plans, new_nest, is_i, is_ref = _unpack_arena(
        cfg, nv, arenas, p8_cap, p32_cap, mv_mode, has_nest, meta_bits)
    if k_steps == 1:
        return _step_body(plane_plans, nest, new_nest, is_i, is_ref,
                          ref_prev, ref_last)

    def resh(a):
        return a.reshape((k_steps, n) + a.shape[1:])

    xs = jax.tree.map(resh, (plane_plans, new_nest, is_i, is_ref))

    def body(carry, x):
        nest_c, rp, rl = carry
        plans_k, nn_k, ii_k, ir_k = x
        frames, nest_c, rp, rl = _step_body(
            plans_k, nest_c, nn_k, ii_k, ir_k, rp, rl)
        return (nest_c, rp, rl), frames

    (nest, ref_prev, ref_last), frames = jax.lax.scan(
        body, (nest, ref_prev, ref_last), xs)
    return frames, nest, ref_prev, ref_last


@functools.lru_cache(maxsize=None)
def _arena_step(cfg: SeqConfig, n: int, k_steps: int,
                p8_cap: int, p32_cap: int,
                mv_mode: int, has_nest: bool, meta_bits: int = 6):
    """Jitted production step for one (pool tiers, mv mode, nest, meta
    bits, K) variant."""

    @functools.partial(jax.jit, donate_argnums=(1, 2, 3))
    def step(arenas, nest, ref_prev, ref_last):
        return _run_steps(cfg, n, k_steps, p8_cap, p32_cap,
                          mv_mode, has_nest, meta_bits,
                          arenas, nest, ref_prev, ref_last)

    return step


@functools.lru_cache(maxsize=None)
def _packed_step(cfg: SeqConfig, n: int, k_steps: int,
                 p8_cap: int, p32_cap: int,
                 mv_mode: int, has_nest: bool, meta_bits: int,
                 s8: int, s32: int):
    """Jitted replay step reading its arenas out of a whole-pass packed
    upload: dynamic-slices (s8,)/(s32,) at traced offsets, then runs the
    variant's `_run_steps` body. One dispatch per step with zero eager
    slice ops — offsets ride as data, so one executable serves every
    step of the same (variant, sizes, pass length) shape. See
    `MultiStreamDecoder.stage_packed`."""

    @functools.partial(jax.jit, donate_argnums=(1, 2, 3))
    def step(packed, nest, ref_prev, ref_last):
        arenas = {
            "u8": jax.lax.dynamic_slice(
                packed["u8"], (packed["o8"],), (s8,)),
            "u32": jax.lax.dynamic_slice(
                packed["u32"], (packed["o32"],), (s32,))}
        return _run_steps(cfg, n, k_steps, p8_cap, p32_cap,
                          mv_mode, has_nest, meta_bits,
                          arenas, nest, ref_prev, ref_last)

    return step


@functools.lru_cache(maxsize=None)
def _arena_step_sharded(cfg: SeqConfig, n_local: int, k_steps: int,
                        p8_cap: int, p32_cap: int,
                        mv_mode: int, has_nest: bool, meta_bits: int,
                        mesh, axis: str):
    """Jitted mesh step: `jax.shard_map` of the SAME `_run_steps` body over
    the stream-carrying mesh axis. Each shard sees one (1, arena_len) row —
    its own single-chip-layout arenas for n_local streams — plus its
    (n_local, ...) state blocks; there are no collectives (streams are
    independent), so scaling is collective-free SPMD."""
    from jax.sharding import PartitionSpec as P

    def local_fn(arenas, nest, ref_prev, ref_last):
        arenas = {g: a.reshape(-1) for g, a in arenas.items()}
        return _run_steps(cfg, n_local, k_steps, p8_cap, p32_cap,
                          mv_mode, has_nest, meta_bits,
                          arenas, nest, ref_prev, ref_last)

    st = P(axis)
    frames_spec = st if k_steps == 1 else P(None, axis)
    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=({"u8": P(axis, None), "u32": P(axis, None)}, st, st, st),
        out_specs=(frames_spec, st, st, st))
    return jax.jit(fn, donate_argnums=(1, 2, 3))


@dataclasses.dataclass
class _Stream:
    records: list
    pos: int = 0
    failed: bool = False
    anchors: int = 0       # I/P frames decoded in the current GOP block
    cur_block: int = -1


@dataclasses.dataclass
class FrameMeta:
    ftype: str
    display_id: int


class MultiStreamDecoder:
    """Host orchestration for N parallel streams of one SeqConfig.

    With `sharding` (a NamedSharding whose spec leads with a mesh axis) the
    stream axis is laid over that axis: shard s owns the contiguous streams
    [s*n/S, (s+1)*n/S) and its own arena row, and `device_step` runs the
    identical arena step under `shard_map` — one code path for single-chip
    and mesh.
    """

    def __init__(self, cfg: SeqConfig, clips: list[bytes],
                 planner_factory=None, sharding=None,
                 record_lists: list | None = None,
                 steps_per_dispatch: int = 1,
                 plan_ahead: int | None = None):
        self.cfg = cfg
        if planner_factory is None:
            # default to the PRODUCTION planner: the pure-Python Planner is
            # ~800x slower per frame, and a forgotten factory silently made
            # whole pipelines host-bound
            from ..planner import default_planner_factory

            planner_factory = default_planner_factory()
        self.planner = planner_factory(cfg)
        self.sharding = sharding
        self._k = max(int(steps_per_dispatch), 1)
        if plan_ahead is None:
            plan_ahead = int(os.environ.get("HVQM4_PLAN_AHEAD", "1"))
        # planning lookahead depth: how many steps may be planned (or in
        # flight) ahead of the device. 1 = the classic ping-pong overlap;
        # >1 sizes the staging ring so a multi-core host can keep several
        # planning workers busy (see run_pipelined). Each extra slot costs
        # one max-variant staging buffer of host RAM.
        self._depth = max(int(plan_ahead), 1)
        self.streams = []
        if record_lists is not None:
            for recs in record_lists:
                self.streams.append(_Stream(records=list(recs)))
        else:
            for clip in clips:
                d = Demuxer(clip)
                if d.info.cfg != cfg:
                    raise ValueError("all streams must share one SeqConfig")
                recs = [(r.block_index, r.frame_char, r.payload)
                        for r in d.video_records()]
                self.streams.append(_Stream(records=recs))
        self.n = len(self.streams)
        if sharding is not None:
            self._mesh = sharding.mesh
            self._axis = sharding.spec[0]
            self._shards = int(self._mesh.shape[self._axis])
            if self.n % self._shards:
                raise ValueError(
                    f"{self.n} streams not divisible by mesh axis "
                    f"{self._axis!r} size {self._shards}")
        else:
            self._mesh = self._axis = None
            self._shards = 1
        self._n_local = self.n // self._shards
        nh, nw = cfg.nest_shape
        dev = self._put
        self.nest = dev(np.zeros((self.n, nh, nw), np.uint8))
        self.ref_prev = [dev(np.zeros((self.n, h, w), np.uint8))
                         for h, w in cfg.plane_shapes]
        self.ref_last = [dev(np.zeros((self.n, h, w), np.uint8))
                         for h, w in cfg.plane_shapes]
        # ping-pong host staging buffers (avoid racing an in-flight
        # transfer), one row per shard, sized for the max variant (full
        # pools, wide vectors, nest). Each row serves n_local * K VIRTUAL
        # streams: with fused K-step dispatch, step k's plans occupy a
        # shard's virtual slots [k*n_local, (k+1)*n_local) (see `_slot`).
        # The planner writes every field into per-stream contiguous
        # scratch; `_assemble` packs scratch into the staging variant
        # layout after the step's tiers/modes are known.
        nvl = self._n_local * self._k
        self._nvl = nvl
        rcap, dcap, dccap = _pool_caps(cfg)
        self._raw_cap_full, self._desc_cap_full = rcap, dcap
        self._dc_cap_full = dccap
        # worst-case packed regions: every slot at full pools + a nest,
        # each slot segment padded to 16 (the assembler's alignment rule);
        # the u32 region additionally holds each slot's refsel-2 mv2 pool
        # (worst case: every MB bi)
        mh_, mw_ = cfg.mb_grid
        self._p8_full = nvl * ((rcap * 16 + dccap + nh * nw + 15) & ~15)
        self._p32_full = nvl * (dcap + mh_ * mw_)
        # packed-region offsets are u32 on the wire and int32 in-jit
        # (_unpack_arena casts `offs` to i32 to feed the gathers): a
        # geometry × streams × K product past 2^31 would silently wrap the
        # bases and corrupt the decode instead of erroring
        if max(self._p8_full, self._p32_full) >= 2**31:
            raise ValueError(
                f"staging region too large for int32 offsets: "
                f"p8_full={self._p8_full} p32_full={self._p32_full} "
                f"(streams*K={nvl} at {cfg.width}x{cfg.height}); reduce "
                f"streams or steps_per_dispatch")
        # staging allocation must cover every variant: the u32 side is
        # largest at meta_bits=6 (5 values/word), the u8 side at
        # meta_bits=5 (a 32-entry codebook per slot rides in u8)
        _u8l, _u32l, max8_6, max32 = _layout(cfg, nvl, self._p8_full,
                                             self._p32_full, _MV_WIDE, True, 6)
        _u8l5, _u32l5, max8_5, _m32_5 = _layout(
            cfg, nvl, self._p8_full, self._p32_full, _MV_WIDE, True, 5)
        max8 = max(max8_6, max8_5)
        mh, mw = cfg.mb_grid
        native = hasattr(self.planner, "prepare")
        if native:
            from ..native import StepPlanner, make_pool_struct
        self._bufs = []
        for _ in range(self._depth + 1):
            staging = {"u8": np.zeros((self._shards, max8), np.uint8),
                       "u32": np.zeros((self._shards, max32), np.uint32)}
            shards = []
            stream_views = []
            pool_structs = []
            for s in range(self._shards):
                planes = [{"meta": np.zeros((nvl, bh, bw), np.uint8),
                           "dc": np.full((nvl, bh, bw), 128, np.uint8),
                           "slot": np.zeros((nvl, bh, bw), np.uint32),
                           "meta5": np.zeros(
                               (nvl, (bh * bw + 4) // 5), np.uint32)}
                          for bh, bw in cfg.block_grids]
                # per-stream CONTIGUOUS pool scratch (planner stride 1);
                # `_assemble` copies each stream's exact used prefix into
                # the staging tier region
                pools = {
                    "raw": np.zeros((nvl, rcap, 16), np.uint8),
                    "desc": np.zeros((nvl, dcap), np.uint32),
                    "dc": np.zeros((nvl, dccap), np.uint8),
                }
                sh = {"planes": planes, "pools": pools,
                      "new_nest": np.zeros((nvl, nh, nw), np.uint8),
                      "mv": np.zeros((nvl, mh, mw), np.uint32),
                      "mv2": np.zeros((nvl, mh, mw), np.uint32),
                      "is_i": np.zeros(nvl, np.uint8),
                      "is_ref": np.zeros(nvl, np.uint8)}
                shards.append(sh)
                # per-slot view dicts are stable: precompute once so the
                # planning hot loop is a bare ctypes call (GIL-released C++)
                stream_views.extend(
                    ([{k: pp[k][lv] for k in _PLANE_KEYS} for pp in planes],
                     sh["new_nest"][lv], sh["mv"][lv], sh["mv2"][lv])
                    for lv in range(nvl))
                if native:
                    pool_structs.extend(
                        make_pool_struct(
                            pools["raw"][lv], pools["desc"][lv],
                            pools["dc"][lv],
                            raw_stride=16, desc_stride=1,
                            raw_cap=rcap, desc_cap=dcap, dc_cap=dccap)
                        for lv in range(nvl))
            buf = {"staging": staging, "shards": shards,
                   "stream_views": stream_views,
                   "mv_or": 0, "mv_fit": True,
                   # per-slot used counts: raw slots, desc elems, dc bytes,
                   # refsel-2 mv2 pool entries (v6)
                   "slot_used": np.zeros((self._shards * nvl, 4), np.int64),
                   # per-slot OR of (1 << meta byte): the assembler derives
                   # each slot's codebook and the step's meta_bits from it
                   "meta_mask": np.zeros(self._shards * nvl, np.uint64),
                   "offs": np.zeros((self._shards, nvl, 4), np.uint32),
                   "variant": None, "sizes": None}
            if native:
                buf["step_planner"] = StepPlanner(
                    self.planner, self._shards * nvl, stream_views,
                    pool_structs)
            self._bufs.append(buf)
        self._cur = 0
        # cumulative per-stage wall-clock (seconds), for the pipeline
        # overlap attribution (bench pipeline_split): plan/assemble are
        # recorded per buffer by the planning thread and folded in by the
        # consumer; the device-side stages accumulate on the calling thread
        self.stats: dict[str, float] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        for k in ("plan_s", "assemble_s", "stage_s", "dequeue_s", "wait_s",
                  "upload_s", "dispatch_s", "steps", "frames"):
            self.stats[k] = 0.0

    def _put(self, x):
        return (jax.device_put(x, self.sharding)
                if self.sharding is not None else jnp.asarray(x))

    # -- (stream, step) ↔ virtual arena slot ----------------------------------

    def _slot(self, si: int, k: int = 0) -> int:
        """Global virtual slot of stream si's k-th frame in this dispatch:
        shard-major, then step-major within the shard (matches the
        `stream_views` build order and `_run_steps`'s (K, n) reshape)."""
        s, j = divmod(si, self._n_local)
        return s * self._nvl + k * self._n_local + j

    def _slot_inv(self, v: int) -> tuple[int, int]:
        s, r = divmod(v, self._nvl)
        k, j = divmod(r, self._n_local)
        return s * self._n_local + j, k

    def _shard_of(self, buf, v: int):
        s, lv = divmod(v, self._nvl)
        return buf["shards"][s], lv

    @property
    def active(self) -> list[bool]:
        return [s.pos < len(s.records) and not s.failed for s in self.streams]

    # -- host half -------------------------------------------------------------

    def _fill_trivial(self, buf, v: int) -> None:
        """Inactive-slot filler: all-copy inter blocks with zero vectors
        (consumes NO pool slots — an all-intra filler would claim a dc-pool
        byte per block and blow the step's dc tier; the output is a copy of
        ref_prev, and invalid slots' output is never read)."""
        sh, lv = self._shard_of(buf, v)
        for pp in sh["planes"]:
            pp["meta"][lv] = 0x20   # cls=1 mode=0 refsel=0: copy, no payload
            # the same byte in the packed 5-per-u32 upload form
            pp["meta5"][lv] = 0x20820820
            pp["dc"][lv] = 128
        buf["meta_mask"][v] = np.uint64(1) << np.uint64(0x20)
        # stale vectors from the buffer's previous use must not force the
        # step into a wider mv variant (the device masks them, but
        # `_assemble` picks the encoding by scanning values)
        sh["mv"][lv] = 0
        sh["mv2"][lv] = 0
        sh["is_i"][lv] = 0
        sh["is_ref"][lv] = 0

    def _set_flags(self, buf, v: int, fchar: str) -> None:
        sh, lv = self._shard_of(buf, v)
        sh["is_i"][lv] = 1 if fchar == "I" else 0
        sh["is_ref"][lv] = 1 if fchar in ("I", "P") else 0

    def _pack_sparse(self, buf, v: int, plan: FramePlan):
        """Dense FramePlan → sparse batch views (python-planner fallback).

        Returns (raw_used, desc_used, dc_used, mv2_used)."""
        sh, lv = self._shard_of(buf, v)
        raw_slot = desc_slot = dc_slot = 0
        mask = np.uint64(0)
        for pp, p in zip(sh["planes"], plan.planes):
            desc_blk = device_core.pack_desc(p)        # (bh, bw, 4) wire u32
            pp["meta"][lv] = device_core.pack_meta(p)
            pp["dc"][lv] = p.dc
            # dc pool: canonical-order values for DC-carrying blocks
            dcvals = p.dc[(p.cls == 0) & (p.mode != 6)]
            sh["pools"]["dc"][lv, dc_slot:dc_slot + dcvals.size] = dcvals
            dc_slot += int(dcvals.size)
            is_raw = (p.cls == 0) & (p.mode == 6)
            slot = np.zeros(p.mode.shape, np.uint32)
            for (by, bx) in zip(*np.nonzero(is_raw)):
                sh["pools"]["raw"][lv, raw_slot] = p.raw[by, bx]
                slot[by, bx] = raw_slot
                raw_slot += 1
            counts = np.where(((p.cls == 0) & (p.mode >= 1) & (p.mode <= 4))
                              | (p.cls == 1), p.mode, 0)
            for (by, bx) in zip(*np.nonzero(counts)):
                k = int(counts[by, bx])
                slot[by, bx] = desc_slot
                sh["pools"]["desc"][lv, desc_slot:desc_slot + k] = \
                    desc_blk[by, bx, :k]
                desc_slot += k
            pp["slot"][lv] = slot
            m = pp["meta"][lv].reshape(-1)
            mask |= np.bitwise_or.reduce(
                np.uint64(1) << m.astype(np.uint64))
            nb = m.size
            if nb % 5:
                m = np.pad(m, (0, 5 - nb % 5))
            m5 = m.reshape(-1, 5).astype(np.uint32)
            pp["meta5"][lv] = (m5[:, 0] | (m5[:, 1] << 6) | (m5[:, 2] << 12)
                               | (m5[:, 3] << 18) | (m5[:, 4] << 24))
        buf["meta_mask"][v] = mask
        # per-MB vectors: the luma plan carries them unshifted, one MB = a
        # 2x2 luma block group, so its top-left block is the MB's vector;
        # packed (y16 << 16 | x16) into the u32 arena
        for key, mvs in (("mv", plan.planes[0].mv),
                         ("mv2", plan.planes[0].mv2)):
            mb = mvs[::2, ::2]
            sh[key][lv] = (((mb[..., 1].astype(np.uint32) & 0xFFFF) << 16)
                           | (mb[..., 0].astype(np.uint32) & 0xFFFF))
        # refsel-2 pool length: bi MBs by the device's own carrier rule
        # (luma meta at the MB's top-left block, cls==1 & refsel==2)
        mtl = sh["planes"][0]["meta"][lv][::2, ::2]
        mv2_used = int(((((mtl >> 5) & 1) == 1)
                        & (((mtl >> 3) & 3) == 2)).sum())
        # mv variant flags cover the FIRST vector grid only (v6: second
        # vectors ride the meta-derived pool, never a dense field)
        mv1 = plan.planes[0].mv.reshape(-1, 2)
        any_nz = bool(mv1.any())
        fits = bool((mv1 >= -128).all() and (mv1 <= 127).all())
        any2 = bool(plan.planes[0].mv2.any())
        buf["mv_or"] |= (1 if any_nz else 0) | (4 if any2 else 0)
        buf["mv_fit"] &= fits
        return raw_slot, desc_slot, dc_slot, mv2_used

    def plan_step(self):
        """Plan the next frame of every stream into the current batch buffers.

        Returns (buf, metas, valid). With fused dispatch (K > 1) a call
        plans the next K lock-step frames of every stream and metas/valid
        are nested per step: metas[k][si]. K == 1 is the same machinery
        with the step axis flattened away."""
        buf, metas, valid, _failures = self._plan_step_into(
            self._bufs[self._cur], self._dequeue_jobs())
        if self._k == 1:
            return buf, metas[0], valid[0]
        return buf, metas, valid

    def _dequeue_jobs(self) -> list:
        """Serially advance every stream's cursor, assigning its next K
        lock-step records to virtual slots. Cheap (cursor walk only, no
        entropy work) — but stateful, so it MUST run in step order; the
        heavy planning of the returned jobs (`_plan_step_into`) may then
        run on any thread."""
        n, K = self.n, self._k
        slot_jobs: list = [None] * (K * n)
        for si, s in enumerate(self.streams):
            for k in range(K):
                if s.failed or s.pos >= len(s.records):
                    break
                bi, fchar, _payload = s.records[s.pos]
                if bi != s.cur_block:      # GOP block boundary: refs reset
                    s.cur_block = bi
                    s.anchors = 0
                if fchar == "B" and s.anchors < 2:
                    # invalid stream (FORMAT.md §10: B without two
                    # references) — poison it, keep the batch
                    s.failed = True
                    break
                if fchar in ("I", "P"):
                    s.anchors += 1
                slot_jobs[self._slot(si, k)] = s.records[s.pos]
                s.pos += 1
        return slot_jobs

    def _plan_step_into(self, buf, slot_jobs):
        """Plan pre-dequeued jobs into `buf` and assemble its staging variant.

        Thread-safe across DISTINCT buffers (the native planner's C call
        has no shared mutable state beyond a mutex-guarded scratch
        freelist), so a worker pool can plan several steps concurrently on
        a multi-core host. Returns (buf, metas[k][si], valid[k][si],
        failures) where failures lists (si, k) streams newly poisoned by
        THIS step — the pipelined consumer uses it to invalidate frames of
        later steps that were dequeued before the failure was known."""
        t0 = time.perf_counter()
        buf["mv_or"] = 0
        buf["mv_fit"] = True
        buf["slot_used"][:] = 0
        buf["meta_mask"][:] = 0
        metas, valid, failures = self._plan_super(buf, slot_jobs)
        t1 = time.perf_counter()
        self._assemble(buf)
        # stashed per-buffer (not summed here): workers run concurrently,
        # the consumer folds these into self.stats race-free
        buf["t_split"] = (t1 - t0, time.perf_counter() - t1)
        return buf, metas, valid, failures

    def _plan_and_stage(self, buf, slot_jobs):
        """Worker-side plan + assemble + h2d staging (run_pipelined only:
        the sync `plan_step` API must NOT transfer — callers like the
        bench device phase plan every step up front and upload later).
        Pre-staging moves the transfer off the consumer thread so it
        overlaps the previous step's dispatch and frame handling."""
        out = self._plan_step_into(buf, slot_jobs)
        t0 = time.perf_counter()
        buf["arenas_staged"] = self._stage_arenas(buf)
        buf["t_stage"] = time.perf_counter() - t0
        return out

    def _plan_super(self, buf, slot_jobs):
        """Plan one step's dequeued jobs into one fused arena (virtual slot
        `_slot(si, k)` = stream si's k-th frame of this dispatch).

        With the native planner, one GIL-released C call plans every slot
        (threaded); a failing slot poisons its stream FROM THAT FRAME ON —
        frames planned before the failure stay valid — and the step is
        replanned without the dropped slots (rare; replanning is
        deterministic). Returns (metas[k][si], valid[k][si], failures)."""
        n, K = self.n, self._k
        failures: list[tuple[int, int]] = []
        metas = [[None] * n for _ in range(K)]
        valid = [[False] * n for _ in range(K)]
        if "step_planner" in buf:
            sp = buf["step_planner"]
            jobs = [(j[1], j[2]) if j is not None else None
                    for j in slot_jobs]
            while True:
                rc = sp.plan(jobs)
                if rc == 0:
                    break
                si, kf = self._slot_inv(rc - 1)
                self.streams[si].failed = True
                failures.append((si, kf))
                for k in range(kf, K):  # earlier frames stay valid
                    jobs[self._slot(si, k)] = None
            for v, job in enumerate(jobs):
                si, k = self._slot_inv(v)
                if job is None:
                    self._fill_trivial(buf, v)
                    continue
                fchar = job[0]
                fout = sp.fouts[v]
                self._set_flags(buf, v, fchar)
                buf["slot_used"][v] = (int(fout.raw_used),
                                       int(fout.desc_used),
                                       int(fout.dc_used),
                                       int(fout.mv2_carriers))
                buf["meta_mask"][v] = np.uint64(fout.meta_mask)
                flags = int(fout.mv_flags)
                buf["mv_or"] |= flags
                buf["mv_fit"] &= bool(flags & 2)
                metas[k][si] = FrameMeta(fchar, int(fout.display_id))
                valid[k][si] = True
            return metas, valid, failures
        poisoned_at = [K] * n  # first dropped step per stream
        for v, job in enumerate(slot_jobs):
            si, k = self._slot_inv(v)
            if job is None or k >= poisoned_at[si]:
                self._fill_trivial(buf, v)
                continue
            _block, fchar, payload = job
            try:
                meta = self._plan_into(buf, v, fchar, payload)
            except PlannerError:
                # poison from this slot on; earlier slots stay valid
                self.streams[si].failed = True
                failures.append((si, k))
                poisoned_at[si] = k
                self._fill_trivial(buf, v)
                continue
            self._set_flags(buf, v, fchar)
            metas[k][si] = meta
            valid[k][si] = True
        return metas, valid, failures

    def _plan_into(self, buf, v: int, fchar: str, payload: bytes) -> FrameMeta:
        plan: FramePlan = self.planner.plan_frame(fchar, payload)
        buf["slot_used"][v] = self._pack_sparse(buf, v, plan)
        if plan.nest is not None:
            sh, lv = self._shard_of(buf, v)
            sh["new_nest"][lv] = plan.nest
        return FrameMeta(fchar, plan.display_id)

    # -- assembly + device half ------------------------------------------------

    def _assemble(self, buf) -> None:
        """Post-planning: pick the step's variant (pool tiers, mv encoding,
        nest presence) and pack the scratch fields into the staging
        buffers: each stream's pools at their exact used lengths into the
        tier regions, then the packed dense fields after the pool cut.

        The packing itself is one C call per shard when the native planner
        is active (`hvqm4_assemble_shard`, replacing a Python per-stream
        loop); `_assemble_numpy` is the
        readable reference, the python-planner path, and the parity-test
        golden (tests/test_multistream.py)."""
        cfg, nvl = self.cfg, self._nvl
        has_nest = any(bool(sh["is_i"].any()) for sh in buf["shards"])
        # per-slot packed bases (offs columns: raw B, dc B, nest B, desc
        # elem), vectorized over each shard's slots: every slot's u8
        # segment starts 16-aligned with raw first, so raw stays 16-strided
        # at any base. Bases are shard-row-relative; the SAME quantized
        # region sizes must hold across shards (shard_map rows are uniform)
        # so the tier is picked from the max shard total.
        nh, nw = cfg.nest_shape
        nest_e = (nh * nw) if has_nest else 0
        offs = buf["offs"]
        native_pack = "step_planner" in buf
        if native_pack:
            from .. import native
        tot8 = tot32 = 0
        for s, sh in enumerate(buf["shards"]):
            su = buf["slot_used"][s * nvl:(s + 1) * nvl]
            if native_pack:
                t8, t32 = native.pack_offsets(su, sh["is_i"], nest_e,
                                              offs[s])
            else:
                ru16 = su[:, 0] * 16
                nest_sz = sh["is_i"].astype(np.int64) * nest_e
                seg = (ru16 + su[:, 2] + nest_sz + 15) & ~np.int64(15)
                base = np.concatenate(([0], np.cumsum(seg)[:-1]))
                o = offs[s]
                o[:, 0] = base
                o[:, 1] = base + ru16
                o[:, 2] = base + ru16 + su[:, 2]
                # each slot's u32 prefix = desc entries then mv2 pool words
                du = su[:, 1] + su[:, 3]
                o[:, 3] = np.concatenate(([0], np.cumsum(du)[:-1]))
                t8 = int(base[-1] + seg[-1])
                t32 = int(o[-1, 3] + du[-1])
            tot8 = max(tot8, t8)
            tot32 = max(tot32, t32)
        p8_cap = _pick_tier(tot8, self._p8_full)
        p32_cap = _pick_tier(tot32, self._p32_full)
        buf["used"] = (tot8, tot32)  # pre-tier totals (byte attribution)
        # mv variant from the planner's per-frame flags (no grid re-scans);
        # flags cover the first vector grid only (mv2 is pooled)
        if not (buf["mv_or"] & 1):
            mv_mode = _MV_NONE
        elif not buf["mv_fit"]:
            mv_mode = _MV_WIDE
        else:
            mv_mode = _MV_PACKED8  # two MBs per u32
        # meta width from the per-slot value masks: smallest B whose
        # codebook holds the worst slot's distinct count (6 = raw escape)
        maxpop = max(int(bin(int(m)).count("1"))
                     for m in buf["meta_mask"]) if len(buf["meta_mask"]) \
            else 1
        meta_bits = 3 if maxpop <= 8 else 4 if maxpop <= 16 else \
            5 if maxpop <= 32 else 6
        u8l, u32l, size8, size32 = _layout(cfg, nvl, p8_cap, p32_cap,
                                           mv_mode, has_nest, meta_bits)
        variant = (p8_cap, p32_cap, mv_mode, has_nest, meta_bits)
        if native_pack:
            st8, st32 = buf["staging"]["u8"], buf["staging"]["u32"]
            for s, sh in enumerate(buf["shards"]):
                native.assemble_shard(
                    st8[s], st32[s],
                    raw=sh["pools"]["raw"], desc=sh["pools"]["desc"],
                    dcp=sh["pools"]["dc"],
                    slot_used=buf["slot_used"][s * nvl:(s + 1) * nvl],
                    offs=offs[s],
                    raw_cap_full=self._raw_cap_full,
                    desc_cap_full=self._desc_cap_full,
                    dc_cap_full=self._dc_cap_full,
                    u8l=u8l, u32l=u32l,
                    new_nest=sh["new_nest"] if has_nest else None,
                    is_i=sh["is_i"], is_ref=sh["is_ref"],
                    metas=[pp["meta"] for pp in sh["planes"]],
                    meta5s=[pp["meta5"] for pp in sh["planes"]],
                    meta_mask=buf["meta_mask"][s * nvl:(s + 1) * nvl],
                    meta_bits=meta_bits,
                    mv=sh["mv"], mv2=sh["mv2"], mv_mode=mv_mode)
        else:
            self._assemble_numpy(buf, u8l, u32l, variant)
        buf["variant"] = variant
        buf["sizes"] = (size8, size32)

    def _assemble_numpy(self, buf, u8l, u32l, variant) -> None:
        nvl = self._nvl
        _p8_cap, _p32_cap, mv_mode, has_nest, meta_bits = variant
        st8, st32 = buf["staging"]["u8"], buf["staging"]["u32"]
        per_word = 32 // meta_bits

        def put(st, s, lay, name, arr):
            off, _shape = lay[name]
            st[s, off:off + arr.size] = arr.reshape(-1)

        def pack_bits(idx):
            """(rows, nb) B-bit values → (rows, ceil(nb/per_word)) u32."""
            nb = idx.shape[1]
            pad = (-nb) % per_word
            if pad:
                idx = np.pad(idx, [(0, 0), (0, pad)])
            g = idx.reshape(idx.shape[0], -1, per_word).astype(np.uint32)
            w = g[:, :, 0]
            for j in range(1, per_word):
                w = w | (g[:, :, j] << np.uint32(meta_bits * j))
            return w

        for s, sh in enumerate(buf["shards"]):
            # packed pool regions: per-slot exact used prefixes at the
            # precomputed bases (offs columns: raw B, dc B, nest B, u32 e);
            # the u32 prefix is desc entries then the refsel-2 mv2 pool
            # (one y16|x16 word per bi MB, row-major MB scan — the same
            # carrier rule `_unpack_arena` derives from the luma meta)
            rp, dp = sh["pools"]["raw"], sh["pools"]["desc"]
            cp = sh["pools"]["dc"]
            for lv in range(nvl):
                ru, du, cu, m2u = buf["slot_used"][s * nvl + lv]
                rb, cb, nb, de = buf["offs"][s, lv]
                if ru:
                    st8[s, rb:rb + ru * 16] = rp[lv, :ru].reshape(-1)
                if du:
                    st32[s, de:de + du] = dp[lv, :du]
                if m2u:
                    mtl = sh["planes"][0]["meta"][lv][::2, ::2]
                    car = ((((mtl >> 5) & 1) == 1)
                           & (((mtl >> 3) & 3) == 2)).reshape(-1)
                    vals = sh["mv2"][lv].reshape(-1)[car]
                    assert vals.size == m2u, (vals.size, m2u)
                    st32[s, de + du:de + du + m2u] = vals
                if cu:
                    st8[s, cb:cb + cu] = cp[lv, :cu]
                if has_nest and sh["is_i"][lv]:
                    st8[s, nb:nb + sh["new_nest"][lv].size] = \
                        sh["new_nest"][lv].reshape(-1)
            put(st32, s, u32l, "offs", buf["offs"][s])
            put(st8, s, u8l, "is_i", sh["is_i"])
            put(st8, s, u8l, "is_ref", sh["is_ref"])
            if meta_bits == 6:
                for pi in range(len(self.cfg.block_grids)):
                    # the planner already packed meta 5-per-u32: a row copy
                    put(st32, s, u32l, f"meta{pi}", sh["planes"][pi]["meta5"])
            else:
                # per-slot codebook (set-bit values of the mask, ascending;
                # tail zero) + B-bit indices through the inverse map
                masks = buf["meta_mask"][s * nvl:(s + 1) * nvl]
                cb_size = 1 << meta_bits
                cbk = np.zeros((nvl, cb_size), np.uint8)
                inv = np.zeros((nvl, 64), np.uint8)
                for lv in range(nvl):
                    vals = np.flatnonzero(
                        (int(masks[lv]) >> np.arange(64)) & 1)
                    cbk[lv, :vals.size] = vals
                    inv[lv, vals] = np.arange(vals.size, dtype=np.uint8)
                put(st8, s, u8l, "metacb", cbk)
                for pi in range(len(self.cfg.block_grids)):
                    m = sh["planes"][pi]["meta"].reshape(nvl, -1)
                    idx = np.take_along_axis(inv, m.astype(np.int64), axis=1)
                    put(st32, s, u32l, f"meta{pi}", pack_bits(idx))
            if mv_mode == _MV_PACKED8:
                v = sh["mv"].reshape(nvl, -1)
                # per MB: x.s8 | y.s8<<8 (low bytes of the s16 halves)
                b = (v & 0xFF) | (((v >> 16) & 0xFF) << 8)
                if b.shape[1] % 2:
                    b = np.pad(b, [(0, 0), (0, 1)])
                w = b[:, 0::2] | (b[:, 1::2] << 16)
                put(st32, s, u32l, "mvp8", w)
            elif mv_mode == _MV_WIDE:
                put(st32, s, u32l, "mv", sh["mv"])

    def snapshot_step(self, buf):
        """Minimal copyable upload payload of a planned step — what
        measurement scripts store to replay `device_step` without live
        planning. Holds only the transferred staging prefixes (peak RSS
        stays independent of clip length)."""
        size8, size32 = buf["sizes"]
        return {"staging": {"u8": buf["staging"]["u8"][:, :size8].copy(),
                            "u32": buf["staging"]["u32"][:, :size32].copy()},
                "variant": buf["variant"], "sizes": buf["sizes"]}

    def stage_packed(self, bufs, packed=None):
        """Pre-stage a replay pass of `snapshot_step` payloads with ONE
        h2d transfer per dtype instead of two per step.

        Concatenates every step's staging prefixes into one contiguous
        u8 and one u32 host buffer, uploads the pair, then hands each
        step the whole-pass device arrays plus its slice offsets (which
        ride as data into `_packed_step`, a jitted dynamic-slice wrapper
        around the variant's `_run_steps` body) through the
        `arenas_staged` fast path `device_step` already consumes — one
        dispatch per step, zero eager slice ops, and decode is bit-exact
        vs per-step staging (test_stage_packed_bitexact).

        Built for pre-planned replay where per-transfer latency dominates:
        a 28-step heavy pass is 56 small transfers, or two large ones
        here. Single-shard only — the sharded path uploads per-row
        anyway.

        Returns the packed host buffers; pass them back in to skip the
        concatenation on repeated passes over the same steps.
        """
        assert self.sharding is None, \
            "stage_packed is single-shard replay; use device_step on a mesh"
        if packed is None:
            tot8 = sum(b["sizes"][0] for b in bufs)
            tot32 = sum(b["sizes"][1] for b in bufs)
            big8 = np.empty(tot8, np.uint8)
            big32 = np.empty(tot32, np.uint32)
            offs, o8, o32 = [], 0, 0
            for b in bufs:
                s8, s32 = b["sizes"]
                big8[o8:o8 + s8] = b["staging"]["u8"][0, :s8]
                big32[o32:o32 + s32] = b["staging"]["u32"][0, :s32]
                offs.append((o8, o32))
                o8 += s8
                o32 += s32
            # private copies by construction: safe against the CPU
            # backend's zero-copy aliasing of aligned host buffers
            packed = {"u8": big8, "u32": big32, "offs": offs}
        d8 = jnp.asarray(packed["u8"])
        d32 = jnp.asarray(packed["u32"])
        for b, (o8, o32) in zip(bufs, packed["offs"]):
            s8, s32 = b["sizes"]
            step_fn = _packed_step(self.cfg, self.n, self._k,
                                   *b["variant"], s8, s32)
            b["arenas_staged"] = ({"u8": d8, "u32": d32,
                                   "o8": np.int32(o8),
                                   "o32": np.int32(o32)}, step_fn)
        return packed

    def _stage_arenas(self, buf):
        """Staging slices → device arrays (the h2d transfer) + the jitted
        step for the buffer's variant. Called inline by `device_step`, or
        ahead of it on the planning worker in `run_pipelined` so the
        transfer overlaps the previous step's dispatch and the consumer's
        frame handling instead of serializing on the main thread."""
        p8_cap, p32_cap, mv_mode, has_nest, meta_bits = buf["variant"]
        size8, size32 = buf["sizes"]
        h8 = buf["staging"]["u8"][:, :size8]
        h32 = buf["staging"]["u32"][:, :size32]
        if self.sharding is None:
            # single shard: rows are contiguous, upload 1-D views
            h8r, h32r = h8[0], h32[0]
            if jax.default_backend() == "cpu":
                # the CPU backend may zero-copy-alias aligned numpy buffers;
                # the ping-pong staging is rewritten two steps later, so
                # hand the device a private copy (an accelerator always
                # transfers)
                h8r, h32r = h8r.copy(), h32r.copy()
            arenas = {"u8": jnp.asarray(h8r), "u32": jnp.asarray(h32r)}
            step_fn = _arena_step(self.cfg, self.n, self._k, p8_cap,
                                  p32_cap, mv_mode, has_nest, meta_bits)
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            if jax.default_backend() == "cpu":
                # same zero-copy-aliasing hazard as the single-shard branch:
                # the CPU PJRT client may alias aligned host buffers, and the
                # ping-pong staging is rewritten two steps later while an
                # async sharded step can still be reading it
                h8, h32 = h8.copy(), h32.copy()
            ash = NamedSharding(self._mesh, P(self._axis, None))
            arenas = {"u8": jax.device_put(h8, ash),
                      "u32": jax.device_put(h32, ash)}
            step_fn = _arena_step_sharded(
                self.cfg, self._n_local, self._k, p8_cap, p32_cap,
                mv_mode, has_nest, meta_bits, self._mesh, self._axis)
        return arenas, step_fn

    def device_step(self, buf):
        """Batched decode of one planned step + state rotation — ONE code
        path: two typed staging uploads (u8 + u32) truncated to the step
        variant's size, then the jitted arena step (wrapped in shard_map
        when a mesh sharding is set). Accepts a live ping-pong buffer or a
        `snapshot_step` payload.

        With fused dispatch (K > 1) the returned frames are stacked
        per step: [3 x (K, n, H, W)]."""
        t0 = time.perf_counter()
        pre = buf.pop("arenas_staged", None)
        arenas, step_fn = pre if pre is not None else self._stage_arenas(buf)
        t1 = time.perf_counter()
        frames, self.nest, self.ref_prev, self.ref_last = step_fn(
            arenas, self.nest, self.ref_prev, self.ref_last)
        t2 = time.perf_counter()
        self.stats["upload_s"] += t1 - t0
        self.stats["dispatch_s"] += t2 - t1
        return frames

    def step(self):
        """plan + decode; returns (frames, metas, valid) or None when done.

        With fused dispatch (K > 1): frames [3 x (K, n, H, W)], metas and
        valid nested per step (metas[k][si])."""
        if not any(self.active):
            return None
        buf, metas, valid = self.plan_step()
        frames = self.device_step(buf)
        self._cur = (self._cur + 1) % len(self._bufs)
        return frames, metas, valid

    def run_pipelined(self, plan_workers: int | None = None):
        """Generator over steps with host/device overlap (SURVEY.md §2.6).

        While the device executes step t, worker threads plan steps
        t+1..t+`plan_ahead` into the other slots of the staging ring (the
        native planner releases the GIL inside ctypes, so entropy decode
        genuinely overlaps device dispatch/transfer — and, with
        `plan_workers` > 1 on a multi-core host, overlaps itself across
        steps). Job dequeue stays serial in this generator (stream cursors
        are stateful); only the entropy-heavy planning fans out. Defaults
        (`plan_ahead=1`, one worker) reproduce the classic ping-pong
        schedule exactly.

        A stream that poisons at step t may already have frames dequeued
        into steps > t; those are masked invalid here so the caller sees
        the same per-stream validity as the unpipelined path.

        Yields (frames, metas, valid) per SINGLE step regardless of the
        fused-dispatch factor (stacked frames are sliced lazily —
        device-side views, no transfer)."""
        import collections
        import concurrent.futures as cf

        if plan_workers is None:
            plan_workers = int(os.environ.get("HVQM4_PLAN_WORKERS", "0")) \
                or min(self._depth, os.cpu_count() or 1)
        ring = len(self._bufs)
        pending: collections.deque = collections.deque()
        dead = [False] * self.n

        with cf.ThreadPoolExecutor(max_workers=max(plan_workers, 1)) as ex:
            def submit() -> bool:
                # advance self._cur (not a local cursor) so a later step()/
                # plan_step() on this decoder continues the ring from where
                # the pipelined run left off — a stale _cur could rewrite
                # the staging slot of a still-in-flight device_step
                if not any(self.active):
                    return False
                t0 = time.perf_counter()
                jobs = self._dequeue_jobs()       # serial, in step order
                self.stats["dequeue_s"] += time.perf_counter() - t0
                buf = self._bufs[self._cur]
                self._cur = (self._cur + 1) % ring
                pending.append(ex.submit(self._plan_and_stage, buf, jobs))
                return True

            for _ in range(self._depth):
                if not submit():
                    break
            while pending:
                t0 = time.perf_counter()
                buf, metas, valid, failures = pending.popleft().result()
                self.stats["wait_s"] += time.perf_counter() - t0
                tp, ta = buf["t_split"]
                self.stats["plan_s"] += tp
                self.stats["assemble_s"] += ta
                self.stats["stage_s"] += buf.get("t_stage", 0.0)
                self.stats["steps"] += 1
                self.stats["frames"] += sum(
                    v for row in valid for v in row)
                submit()
                frames = self.device_step(buf)
                for si in range(self.n):
                    if dead[si]:    # poisoned at an earlier step: frames
                        for k in range(self._k):   # planned ahead are void
                            metas[k][si] = None
                            valid[k][si] = False
                for si, _kf in failures:
                    dead[si] = True
                if self._k == 1:
                    yield frames, metas[0], valid[0]
                else:
                    for k in range(self._k):
                        if not any(valid[k]) and k > 0:
                            continue  # trailing filler slots of a short clip
                        yield ([frames[pi][k] for pi in range(3)],
                               metas[k], valid[k])


def shard_streams(mesh, axis: str = "dp"):
    """NamedSharding placing the stream axis over a mesh axis (others replicated)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    return NamedSharding(mesh, P(axis))


def decode_clip_gop_parallel(clip: bytes, max_streams: int = 8,
                             planner_factory=None):
    """Decode ONE `.h4m` clip with its GOP blocks batched as parallel streams.

    GOP blocks are independent seek points (reference state resets at each,
    FORMAT.md §2), so a single long clip decodes at multi-stream throughput:
    blocks are dealt round-robin onto up to `max_streams` lanes and each
    lane's frames are re-assembled into decode order at the end.

    Yields (block_index, yuv_bytes) per frame, in the clip's decode order,
    STREAMING: a frame is yielded as soon as every earlier frame of the
    clip has been (memory is bounded by cross-lane skew, not clip length).
    A corrupt GOP block poisons only its lane; its frames (and that lane's
    later blocks) are skipped while every other lane's frames still arrive.
    Frames round-trip to the host here (this is the export/CLI path — the
    training/serving paths keep frames on device).
    """
    import collections

    d = Demuxer(clip)
    cfg = d.info.cfg
    blocks: list[list] = [[] for _ in d.block_offsets]
    for r in d.video_records():
        blocks[r.block_index].append((r.block_index, r.frame_char, r.payload))
    n = min(max_streams, len(blocks)) or 1
    lanes: list[list] = [[] for _ in range(n)]
    order: list[tuple[int, int]] = []   # decode order: (block, lane)
    for bi, recs in enumerate(blocks):
        lanes[bi % n].extend(recs)
        order.extend((bi, bi % n) for _ in recs)
    if planner_factory is None:
        from ..planner import default_planner_factory

        planner_factory = default_planner_factory()
    ms = MultiStreamDecoder(cfg, [], planner_factory=planner_factory,
                            record_lists=lanes)
    per_lane = [collections.deque() for _ in range(n)]
    pos = 0
    done = False

    def drain():
        nonlocal pos
        while pos < len(order):
            bi, lane = order[pos]
            if per_lane[lane]:
                yield bi, per_lane[lane].popleft()
                pos += 1
            elif done or ms.streams[lane].failed:
                pos += 1    # lost to poisoning/end: skip, keep lanes flowing
            else:
                return      # wait for the lane to catch up

    for frames, _metas, valid in ms.run_pipelined():
        fnp = None
        for si, ok in enumerate(valid):
            if ok:
                if fnp is None:
                    fnp = [np.asarray(p) for p in frames]
                per_lane[si].append(b"".join(
                    fnp[pi][si].tobytes() for pi in range(3)))
        yield from drain()
    done = True
    yield from drain()
