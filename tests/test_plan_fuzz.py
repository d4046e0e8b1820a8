"""Random plans through both pixel cores (SURVEY.md §4.5 'random plans
through kernels'): the NumPy golden and the JAX device core must agree on
arbitrary (range-valid) plan tensors, independent of any bitstream."""

import jax.numpy as jnp
import numpy as np
import pytest

from hvqm4_jax.config import MAX_BASES
from hvqm4_jax.ops import device_core
from hvqm4_jax.plans import PlanePlan
from hvqm4_jax.refdec import decode_plane


def _random_plane_plan(rng, bh, bw) -> PlanePlan:
    p = PlanePlan.zeros(bh, bw)
    p.cls[:] = rng.integers(0, 2, (bh, bw))
    mode = rng.integers(0, 7, (bh, bw))
    mode[mode == 5] = 0                       # 5 invalid for intra
    p.mode[:] = np.where(p.cls == 1, rng.integers(0, 5, (bh, bw)), mode)
    p.dc[:] = rng.integers(0, 256, (bh, bw))
    p.raw[:] = rng.integers(0, 256, (bh, bw, 16))
    nb = np.where(p.cls == 1, p.mode,
                  np.where((p.mode >= 1) & (p.mode <= 4), p.mode, 0))
    live = np.arange(MAX_BASES)[None, None, :] < nb[:, :, None]
    p.basis_nx[:] = rng.integers(0, 128, (bh, bw, MAX_BASES)) * live
    p.basis_ny[:] = rng.integers(0, 128, (bh, bw, MAX_BASES)) * live
    p.basis_sx[:] = rng.integers(1, 3, (bh, bw, MAX_BASES)) * live
    p.basis_sy[:] = rng.integers(1, 3, (bh, bw, MAX_BASES)) * live
    p.basis_off[:] = rng.integers(0, 256, (bh, bw, MAX_BASES)) * live
    p.basis_scale[:] = rng.integers(-128, 128, (bh, bw, MAX_BASES)) * live
    p.mv[:] = rng.integers(-300, 301, (bh, bw, 2))      # clamp territory
    p.mv2[:] = rng.integers(-300, 301, (bh, bw, 2))
    p.refsel[:] = rng.integers(0, 3, (bh, bw)) * (p.cls == 1)
    return p


@pytest.mark.parametrize("seed", range(8))
def test_random_plans_golden_vs_device(seed):
    rng = np.random.default_rng(seed)
    bh, bw = int(rng.integers(2, 12)), int(rng.integers(2, 12))
    p = _random_plane_plan(rng, bh, bw)
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    ref0 = rng.integers(0, 256, (bh * 4, bw * 4), dtype=np.uint8)
    ref1 = rng.integers(0, 256, (bh * 4, bw * 4), dtype=np.uint8)

    want = decode_plane(p, nest, ref0, ref1)

    arrs = {k: jnp.asarray(v)
            for k, v in device_core.plane_plan_arrays(p).items()}
    got = np.asarray(device_core.decode_plane_inter(
        arrs, jnp.asarray(nest), jnp.asarray(ref0), jnp.asarray(ref1)))
    assert np.array_equal(want, got), f"seed={seed} {bh}x{bw}"


def _intra_plan(rng, bh, bw) -> PlanePlan:
    """All-intra random plan with every intra mode, raw blocks included."""
    p = _random_plane_plan(rng, bh, bw)
    p.cls[:] = 0
    mode = rng.integers(0, 7, (bh, bw))
    mode[mode == 5] = 6                       # 5 invalid for intra
    p.mode[:] = mode
    p.refsel[:] = 0
    live = (np.arange(MAX_BASES)[None, None, :]
            < np.where((mode >= 1) & (mode <= 4), mode, 0)[:, :, None])
    for f in ("basis_nx", "basis_ny", "basis_sx", "basis_sy", "basis_off",
              "basis_scale"):
        getattr(p, f)[:] *= live
    return p


@pytest.mark.parametrize("bh,bw,nest_shape", [
    (12, 16, (38, 70)), (30, 40, (38, 70)), (60, 80, (38, 70)),
    (16, 12, (70, 38)),                       # portrait nest
])
def test_intra_plane_matches_golden(bh, bw, nest_shape):
    """I-frame planes through `decode_plane_intra` at the sizes the
    planes of real frames take, against the NumPy golden."""
    rng = np.random.default_rng(3)
    p = _intra_plan(rng, bh, bw)
    nest = rng.integers(0, 256, nest_shape, dtype=np.uint8)
    want = decode_plane(p, nest, None, None)
    arrs = {k: jnp.asarray(v)
            for k, v in device_core.plane_plan_arrays(p).items()}
    got = np.asarray(device_core.decode_plane_intra(arrs, jnp.asarray(nest)))
    assert np.array_equal(want, got)


def test_inter_plane_matches_golden():
    """A P/B plane with intra, raw and all three reference selections."""
    rng = np.random.default_rng(9)
    p = _random_plane_plan(rng, 12, 16)
    p.mode[::3, ::2] = np.where(p.cls[::3, ::2] == 0, 6, p.mode[::3, ::2])
    nest = rng.integers(0, 256, (38, 70), dtype=np.uint8)
    ref0 = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    ref1 = rng.integers(0, 256, (48, 64), dtype=np.uint8)
    want = decode_plane(p, nest, ref0, ref1)
    arrs = {k: jnp.asarray(v)
            for k, v in device_core.plane_plan_arrays(p).items()}
    got = np.asarray(device_core.decode_plane_inter(
        arrs, jnp.asarray(nest), jnp.asarray(ref0), jnp.asarray(ref1)))
    assert np.array_equal(want, got)
