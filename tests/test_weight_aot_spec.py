"""Literal-spec unit tests for WeightImBlock and the AOT accumulator
(FORMAT.md §6.2-6.3), including every border case."""

import jax.numpy as jnp
import numpy as np

from hvqm4_jax.ops import device_core
from hvqm4_jax.refdec import aot_acc, weight_blocks
from hvqm4_jax.plans import PlanePlan

_W = [4, 1, 0, 0]


def _weight_scalar(dcg: np.ndarray) -> np.ndarray:
    """FORMAT.md §6.3 transcribed directly (border → own dc)."""
    bh, bw = dcg.shape
    out = np.zeros((bh, bw, 4, 4), np.int32)
    for by in range(bh):
        for bx in range(bw):
            dc = int(dcg[by, bx])
            dcU = int(dcg[by - 1, bx]) if by > 0 else dc
            dcD = int(dcg[by + 1, bx]) if by < bh - 1 else dc
            dcL = int(dcg[by, bx - 1]) if bx > 0 else dc
            dcR = int(dcg[by, bx + 1]) if bx < bw - 1 else dc
            for i in range(4):
                for j in range(4):
                    acc = ((dcU - dc) * _W[i] + (dcD - dc) * _W[3 - i]
                           + (dcL - dc) * _W[j] + (dcR - dc) * _W[3 - j])
                    out[by, bx, i, j] = dc + ((acc + 8) >> 4)
    return out


def _blocks_to_plane_np(blocks):
    bh, bw = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)


def _device_plan(bh, bw, dc=None, mode=None, desc=None):
    """Minimal plan dict in the device core's plane-layout contract."""
    plan = {
        "meta": np.zeros((bh, bw), np.uint8) if mode is None
        else mode.astype(np.uint8),
        "dc": np.zeros((bh, bw), np.uint8) if dc is None else dc,
        "desc": np.zeros((4, bh, bw), np.uint32) if desc is None else desc,
        "raw": np.zeros((bh * 4, bw * 4), np.uint8),
    }
    return {k: jnp.asarray(v) for k, v in plan.items()}


def test_weight_blocks_spec_all_borders():
    rng = np.random.default_rng(0)
    dcg = rng.integers(0, 256, (5, 7), dtype=np.uint8)  # corners+edges+interior
    want = _weight_scalar(dcg)
    assert np.array_equal(weight_blocks(dcg), want)
    # device core: an all-mode-0 plan makes every pixel the smoothing output
    plan = _device_plan(5, 7, dc=dcg)
    intra, _acc, _meta = device_core._intra_pixels_plane(
        plan, jnp.zeros((38, 70), jnp.uint8))
    assert np.array_equal(np.asarray(intra), _blocks_to_plane_np(want))


def test_aot_acc_spec_modular_and_mask():
    """Modular nest wrap, stride 1/2, signed scale, count masking."""
    rng = np.random.default_rng(1)
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    p = PlanePlan.zeros(1, 1)
    cases = [(69, 37, 2, 2, 10, -128),   # wraps both axes at stride 2
             (0, 0, 1, 1, 255, 127),
             (127, 127, 2, 1, 0, -1)]
    for b, (nx, ny, sx, sy, off, scale) in enumerate(cases[:2]):
        p.basis_nx[0, 0, b] = nx
        p.basis_ny[0, 0, b] = ny
        p.basis_sx[0, 0, b] = sx
        p.basis_sy[0, 0, b] = sy
        p.basis_off[0, 0, b] = off
        p.basis_scale[0, 0, b] = scale
    # third basis present in arrays but masked out by count=2
    p.basis_scale[0, 0, 2] = 99

    want = np.zeros((4, 4), np.int64)
    for b, (nx, ny, sx, sy, off, scale) in enumerate(cases[:2]):
        for i in range(4):
            for j in range(4):
                v = int(nest[(ny + i * sy) % 38, (nx + j * sx) % 70])
                want[i, j] += (v - off) * scale

    count = np.array([[2]], np.int32)
    got = aot_acc(p, nest, count)[0, 0]
    assert np.array_equal(got, want)

    # device core: count comes from meta, so encode an AOT mode-2 block
    p.mode[0, 0] = 2
    arrs = {k: jnp.asarray(v) for k, v in
            device_core.plane_plan_arrays(p).items()}
    _intra, acc, _meta = device_core._intra_pixels_plane(
        arrs, jnp.asarray(nest))
    assert np.array_equal(np.asarray(acc)[0:4, 0:4], want)
