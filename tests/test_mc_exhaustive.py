"""Exhaustive MC rounding/border tests (SURVEY.md §4.4).

Every half-pel phase × border-clamp combination, verified against a
straight-from-the-spec scalar reference (FORMAT.md §7.4), for both the NumPy
golden and the JAX device core.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hvqm4_jax.ops import device_core
from hvqm4_jax.refdec import mc_predict as mc_numpy


def _mc_scalar(ref: np.ndarray, mv, bh, bw) -> np.ndarray:
    """Literal transcription of FORMAT.md §7.4 (the spec text itself)."""
    ph, pw = ref.shape
    out = np.zeros((bh, bw, 4, 4), np.int32)

    def cl(v, hi):
        return min(max(v, 0), hi - 1)

    r = ref.astype(np.int32)
    for by in range(bh):
        for bx in range(bw):
            for i in range(4):
                for j in range(4):
                    sx = 2 * (bx * 4 + j) + mv[0]
                    sy = 2 * (by * 4 + i) + mv[1]
                    ix, hx = sx >> 1, sx & 1
                    iy, hy = sy >> 1, sy & 1
                    a = r[cl(iy, ph), cl(ix, pw)]
                    b = r[cl(iy, ph), cl(ix + 1, pw)]
                    c = r[cl(iy + 1, ph), cl(ix, pw)]
                    d = r[cl(iy + 1, ph), cl(ix + 1, pw)]
                    if hx == 0 and hy == 0:
                        v = a
                    elif hx == 1 and hy == 0:
                        v = (a + b + 1) >> 1
                    elif hx == 0 and hy == 1:
                        v = (a + c + 1) >> 1
                    else:
                        v = (a + b + c + d + 2) >> 2
                    out[by, bx, i, j] = v
    return out


# every phase, and magnitudes that force clamping at all four borders
MVS = [(0, 0), (1, 0), (0, 1), (1, 1), (-1, -1), (2, 3), (-3, 2),
       (-40, 0), (0, -40), (40, 40), (-39, 39), (-200, -200), (200, 200)]


@pytest.mark.parametrize("mv", MVS)
def test_mc_all_phases_and_borders(mv):
    rng = np.random.default_rng(hash(mv) % (2**31))
    ph, pw = 16, 24
    bh, bw = ph // 4, pw // 4
    ref = rng.integers(0, 256, (ph, pw), dtype=np.uint8)
    want = _mc_scalar(ref, mv, bh, bw)

    mv_grid = np.broadcast_to(np.array(mv, np.int16), (bh, bw, 2)).copy()
    got_np = mc_numpy(ref, mv_grid)
    assert np.array_equal(got_np, want), "numpy golden diverges from spec"

    # device core works in plane layout: per-pixel maps + (2, bh, bw) grid
    y, x, _by, _bx, _iw, _jw = device_core._pixel_maps(bh, bw)
    mvx, mvy = device_core._mv_pixels(
        {"mv": jnp.asarray(mv_grid.transpose(2, 0, 1))}, "mv", y, x)
    got_jax = np.asarray(device_core._mc_plane(
        jnp.asarray(ref), y, x, mvx, mvy))
    want_plane = want.transpose(0, 2, 1, 3).reshape(bh * 4, bw * 4)
    assert np.array_equal(got_jax, want_plane), \
        "device core diverges from spec"


def test_mc_rounding_direction():
    """(a+b+1)>>1 rounds half up — pin the exact convention."""
    ref = np.array([[10, 11], [13, 14]], np.uint8)
    mv_grid = np.zeros((1, 1, 2), np.int16)
    mv_grid[0, 0] = (1, 0)  # horizontal half-pel at origin
    got = mc_numpy(np.pad(ref, ((0, 2), (0, 2))), mv_grid)
    assert got[0, 0, 0, 0] == (10 + 11 + 1) >> 1 == 11
    mv_grid[0, 0] = (1, 1)
    got = mc_numpy(np.pad(ref, ((0, 2), (0, 2))), mv_grid)
    assert got[0, 0, 0, 0] == (10 + 11 + 13 + 14 + 2) >> 2 == 12
