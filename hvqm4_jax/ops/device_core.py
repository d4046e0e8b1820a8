"""JAX device core: plan tensors → pixels, batched over the whole frame.

The data-parallel replacement for the reference's per-block scalar loops
(SURVEY.md §2.3: `WeightImBlock`, `IntraAotBlock`, `OrgBlock`,
`PrediAotBlock`, `_MotionComp*`, B blending). Every pixel of a plane is
computed simultaneously: block modes become masked selects, nest lookups
and motion compensation become gathers, and all arithmetic is exact int32
with arithmetic shifts so the output is bit-identical to the C oracle on
any XLA backend.

Layout: every large tensor is **plane shaped (H, W)** — minor dimension =
the plane width — and per-block plan fields are upsampled to pixels by
gathers indexed with a shared block-index map, so XLA can fuse each
gather into the int32 arithmetic that consumes it.

Plan dict contract (per plane):
    meta (bh, bw) u8       mode bits 0-2, refsel 3-4, cls 5
    dc   (bh, bw) u8       prediction-resolved DC
    desc (4, bh, bw) u32   basis descriptors, wire format — component-MAJOR
    raw  (H, W) u8         raw-block pixels already in plane layout
    mv, mv2 (2, gh, gw) i16  vectors on any power-of-two grid (per-block or
                           per-MB); values already plane-resolved (chroma
                           half-pel shift applied by the producer)

Two entry points per plane shape, each jit-compiled once per `SeqConfig`:
- `decode_plane_intra(plan, nest)`            — I frames
- `decode_plane_inter(plan, nest, ref0, ref1)`— P/B frames
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MAX_BASES
from ..plans import PlanePlan


def pack_meta(p: PlanePlan) -> np.ndarray:
    """PlanePlan → the packed per-block meta byte (mode | refsel | cls)."""
    return (p.mode | (p.refsel << 3) | (p.cls << 5)).astype(np.uint8)


def pack_desc(p: PlanePlan) -> np.ndarray:
    """PlanePlan → basis descriptors in wire u32 form, block-major
    (bh, bw, MAX_BASES) — the exact 32-bit layout of FORMAT.md §6.5."""
    return ((p.basis_nx.astype(np.uint32) << 25)
            | (p.basis_ny.astype(np.uint32) << 18)
            | ((np.maximum(p.basis_sx.astype(np.uint32), 1) - 1) << 17)
            | ((np.maximum(p.basis_sy.astype(np.uint32), 1) - 1) << 16)
            | ((p.basis_off.astype(np.int64) & 0xFF).astype(np.uint32) << 8)
            | (p.basis_scale.astype(np.int64) & 0xFF).astype(np.uint32))


def plane_plan_arrays(p: PlanePlan) -> dict[str, np.ndarray]:
    """PlanePlan → the dense per-plane device plan arrays (host-side).

    Emits the plane-layout contract documented in the module docstring.
    The production multi-stream arena uploads an even tighter encoding
    (unified sparse payload slot, per-MACROBLOCK motion vectors — see
    `parallel.multistream`) and expands to this form inside the jitted
    step.
    """
    bh, bw = p.mode.shape
    raw_plane = (p.raw.reshape(bh, bw, 4, 4).transpose(0, 2, 1, 3)
                 .reshape(bh * 4, bw * 4))
    return {
        "meta": pack_meta(p),
        "dc": p.dc,
        "raw": np.ascontiguousarray(raw_plane),
        "desc": np.ascontiguousarray(pack_desc(p).transpose(2, 0, 1)),
        "mv": np.ascontiguousarray(p.mv.transpose(2, 0, 1)),
        "mv2": np.ascontiguousarray(p.mv2.transpose(2, 0, 1)),
    }


def basis_count(cls_, mode):
    """Per-block AOT basis count from (cls, mode): intra modes 1..4 carry
    `mode` bases, every inter block carries `mode` residual bases, all
    other blocks none (FORMAT.md §5.3). The ONE definition of this rule —
    shared by the XLA core and the multi-stream slot derivation, so the
    two can never diverge."""
    return jnp.where((cls_ != 0) | ((mode >= 1) & (mode <= 4)), mode, 0)


def _sra(x, n):
    """Arithmetic shift right (sign-propagating), explicit for clarity."""
    return jax.lax.shift_right_arithmetic(x, jnp.int32(n))


def _i32(x):
    return x.astype(jnp.int32)


def unpack_desc(desc):
    """Wire-format u32 basis descriptors (FORMAT.md §6.5) → i32 fields."""
    d = _i32(desc.astype(jnp.uint32))  # logical ops below mask sign bits away
    nx = _sra(d, 25) & 0x7F
    ny = _sra(d, 18) & 0x7F
    sx = (_sra(d, 17) & 1) + 1
    sy = (_sra(d, 16) & 1) + 1
    off = _sra(d, 8) & 0xFF
    scale8 = d & 0xFF
    scale = scale8 - ((scale8 & 0x80) << 1)  # sign-extend 8-bit
    return nx, ny, sx, sy, off, scale


# ---------------------------------------------------------------------------
# Plane-layout helpers
# ---------------------------------------------------------------------------

def _pixel_maps(bh: int, bw: int):
    """Shared per-pixel index maps for a (bh, bw) block grid.

    Returns (y, x, by, bx, iw, jw) as (H, W) i32: pixel coords, owning
    block coords, and within-block coords.
    """
    H, W = bh * 4, bw * 4
    y = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    x = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    return y, x, _sra(y, 2), _sra(x, 2), y & 3, x & 3


def _up(grid2d, blk):
    """Per-block value grid (bh, bw) → per-pixel (H, W) i32 via one gather."""
    return jnp.take(_i32(grid2d).reshape(-1), blk)


def _wsel(idx):
    """The smoothing weight table W = [4, 1, 0, 0] as arithmetic on the
    (H, W) within-block index (FORMAT.md §6.3)."""
    return jnp.where(idx == 0, 4, jnp.where(idx == 1, 1, 0))


# ---------------------------------------------------------------------------
# Intra synthesis (WeightImBlock + IntraAotBlock + OrgBlock, per pixel)
# ---------------------------------------------------------------------------

def _intra_pixels_plane(plan, nest):
    """All intra math in plane layout.

    Returns (intra (H,W) i32 unclipped, acc (H,W) i32 AOT accumulator,
    meta_up (H,W) i32 per-pixel meta) — inter blocks reuse acc as their
    residual and meta_up for cls/refsel.
    """
    bh, bw = plan["meta"].shape
    _y, _x, by, bx, iw, jw = _pixel_maps(bh, bw)
    blk = by * bw + bx

    meta_up = _up(plan["meta"], blk)
    cls_u = _sra(meta_up, 5) & 1
    mode_u = meta_up & 7
    # basis count: intra AOT modes 1..4 or inter residual count (cls 1)
    count_u = basis_count(cls_u, mode_u)

    # --- WeightImBlock: DC smoothing against the 4 neighbour DCs ---------
    # (FORMAT.md §6.3). Border rule = edge replication: clamp the
    # neighbour block index, making the out-of-frame neighbour equal the
    # centre DC.
    dcf = _i32(plan["dc"]).reshape(-1)
    dc_c = jnp.take(dcf, blk)
    dcU = jnp.take(dcf, jnp.maximum(by - 1, 0) * bw + bx)
    dcD = jnp.take(dcf, jnp.minimum(by + 1, bh - 1) * bw + bx)
    dcL = jnp.take(dcf, by * bw + jnp.maximum(bx - 1, 0))
    dcR = jnp.take(dcf, by * bw + jnp.minimum(bx + 1, bw - 1))
    wacc = ((dcU - dc_c) * _wsel(iw) + (dcD - dc_c) * _wsel(3 - iw)
            + (dcL - dc_c) * _wsel(jw) + (dcR - dc_c) * _wsel(3 - jw))
    wpx = dc_c + _sra(wacc + 8, 4)

    # --- AOT accumulator: Σ scaled nest samples (FORMAT.md §6.2) ---------
    # One (H, W) gather per basis from the ≤2.7 KB nest — the device-side
    # `GetAotBasis`/`GetMCAotBasis`.
    nh, nw = nest.shape
    nestf = _i32(nest).reshape(-1)
    acc = jnp.zeros_like(meta_up)
    for b in range(MAX_BASES):
        nx, ny, sx, sy, off, scale = unpack_desc(jnp.take(
            plan["desc"][b].reshape(-1).astype(jnp.uint32), blk))
        yy = (ny + iw * sy) % nh
        xx = (nx + jw * sx) % nw
        s = jnp.take(nestf, yy * nw + xx)
        acc = acc + (s - off) * scale * (count_u > b)
    apx = dc_c + _sra(acc, 4)

    rpx = _i32(plan["raw"])
    intra = jnp.where(mode_u == 0, wpx, jnp.where(mode_u == 6, rpx, apx))
    return intra, acc, meta_up


# ---------------------------------------------------------------------------
# Motion compensation (FORMAT.md §7.4) — the device-side `_MotionComp{00,01,10,11}`
# ---------------------------------------------------------------------------

def _mv_pixels(plan, key, y, x):
    """Upsample a (2, gh, gw) vector grid to per-pixel (mvx, mvy) (H,W) i32.

    The grid may be per-block (gh = bh) or per-macroblock (gh = mh); the
    pixel→grid shift is the exact log2 of the resolution ratio. Vector
    values arrive plane-resolved (chroma shift already applied).
    """
    mv = plan[key]
    _, gh, gw = mv.shape
    H, W = y.shape
    sh_y = (H // gh - 1).bit_length()
    sh_x = (W // gw - 1).bit_length()
    mblk = _sra(y, sh_y) * gw + _sra(x, sh_x)
    return (jnp.take(_i32(mv[0]).reshape(-1), mblk),
            jnp.take(_i32(mv[1]).reshape(-1), mblk))


def _mc_plane(ref, y, x, mvx, mvy):
    """Half-pel MC for every pixel → (H, W) i32; clamped addressing."""
    ph, pw = ref.shape
    r = _i32(ref).reshape(-1)
    sx = 2 * x + mvx
    sy = 2 * y + mvy
    ix, hx = _sra(sx, 1), sx & 1
    iy, hy = _sra(sy, 1), sy & 1

    def at(yy, xx):
        return jnp.take(r, jnp.clip(yy, 0, ph - 1) * pw
                        + jnp.clip(xx, 0, pw - 1))

    a = at(iy, ix)
    b = at(iy, ix + 1)
    c = at(iy + 1, ix)
    d = at(iy + 1, ix + 1)
    return jnp.where(
        (hx == 0) & (hy == 0), a,
        jnp.where((hx == 1) & (hy == 0), _sra(a + b + 1, 1),
                  jnp.where((hx == 0) & (hy == 1), _sra(a + c + 1, 1),
                            _sra(a + b + c + d + 2, 2))))


# ---------------------------------------------------------------------------
# Plane entry points
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, donate_argnums=())
def decode_plane_intra(plan, nest):
    """I-frame plane: all blocks intra."""
    intra, _acc, _meta = _intra_pixels_plane(plan, nest)
    return jnp.clip(intra, 0, 255).astype(jnp.uint8)


@functools.partial(jax.jit, donate_argnums=())
def decode_plane_inter(plan, nest, ref0, ref1):
    """P/B plane: masked mix of intra blocks and MC(+residual) blocks.

    ref0 = past (ref_prev for B; ref_last for P), ref1 = ref_last. The
    bidirectional blend is (fwd + bwd + 1) >> 1 before the residual
    (FORMAT.md §7.5).
    """
    bh, bw = plan["meta"].shape
    y, x, _by, _bx, _iw, _jw = _pixel_maps(bh, bw)
    intra, acc, meta_up = _intra_pixels_plane(plan, nest)
    cls_u = _sra(meta_up, 5) & 1
    sel = _sra(meta_up, 3) & 3
    mvx, mvy = _mv_pixels(plan, "mv", y, x)
    mv2x, mv2y = _mv_pixels(plan, "mv2", y, x)
    pf = _mc_plane(ref0, y, x, mvx, mvy)
    pl_ = _mc_plane(ref1, y, x, mvx, mvy)
    pb = _mc_plane(ref1, y, x, mv2x, mv2y)
    pred = jnp.where(sel == 0, pf,
                     jnp.where(sel == 1, pl_, _sra(pf + pb + 1, 1)))
    inter = pred + _sra(acc, 4)
    px = jnp.where(cls_u == 0, intra, inter)
    return jnp.clip(px, 0, 255).astype(jnp.uint8)


