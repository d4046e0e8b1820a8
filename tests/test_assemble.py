"""Native step assembly (`hvqm4_assemble_shard`) mirrors the numpy
reference assembly byte-for-byte on every staging variant.

`_assemble` packs the planned scratch into the staging uploads; since the
native planner is the production path, its C-side assembly must produce
exactly the bytes `_assemble_numpy` (the readable reference + python-planner
path) produces for the same planned step — across pool tiers, nest
presence, and all four mv encodings.
"""

import numpy as np
import pytest

from hvqm4_jax.config import SeqConfig
from hvqm4_jax.parallel import multistream as msm
from tools.encoder import make_clip

pytest.importorskip("hvqm4_jax.native")


def _both_assemblies(ms, buf):
    """(native bytes, numpy bytes) for the same planned step, both from
    zeroed staging so pool-slack bytes are deterministic. Each side runs
    the FULL `_assemble` (offset pass + tier pick + packing), so the C
    `hvqm4_pack_offsets` and the numpy offset branch are parity-locked
    along with the packing itself."""
    buf["staging"]["u8"][:] = 0
    buf["staging"]["u32"][:] = 0
    ms._assemble(buf)  # dispatches to the native path (step_planner in buf)
    size8, size32 = buf["sizes"]
    variant = buf["variant"]
    a8 = buf["staging"]["u8"][:, :size8].copy()
    a32 = buf["staging"]["u32"][:, :size32].copy()
    a_offs = buf["offs"].copy()

    buf["staging"]["u8"][:] = 0
    buf["staging"]["u32"][:] = 0
    buf["offs"][:] = 0
    sp = buf.pop("step_planner")   # force the all-numpy path
    try:
        ms._assemble(buf)
    finally:
        buf["step_planner"] = sp
    assert buf["variant"] == variant
    assert buf["sizes"] == (size8, size32)
    np.testing.assert_array_equal(a_offs, buf["offs"])
    b8 = buf["staging"]["u8"][:, :size8].copy()
    b32 = buf["staging"]["u32"][:, :size32].copy()
    return (a8, a32), (b8, b32)


def test_native_assemble_matches_numpy_all_variants():
    from hvqm4_jax.native import NativePlanner

    cfg = SeqConfig(64, 48)
    # I steps (nest, no vectors), P steps (PACKED8), B steps with refsel-2
    # (mv2 pool entries); 3 streams x K=2 exercises the virtual-slot layout
    clips = [make_clip(cfg, ["IPBPB", "IPP"], seed=s) for s in range(3)]
    ms = msm.MultiStreamDecoder(cfg, clips, planner_factory=NativePlanner,
                                steps_per_dispatch=2)
    assert "step_planner" in ms._bufs[0], "native planner required"

    seen = set()
    steps = 0
    mv2_pooled = 0
    while any(ms.active):
        buf, _metas, _valid = ms.plan_step()
        seen.add(buf["variant"][2:])
        mv2_pooled += int(buf["slot_used"][:, 3].sum())
        (a8, a32), (b8, b32) = _both_assemblies(ms, buf)
        np.testing.assert_array_equal(a8, b8)
        np.testing.assert_array_equal(a32, b32)

        if steps == 1:
            # force the WIDE escape encoding (the encoder's small vectors
            # never trigger it): same scratch, widest variant
            buf["mv_or"] |= 1
            buf["mv_fit"] = False
            ms._assemble(buf)
            assert buf["variant"][2] == msm._MV_WIDE
            seen.add(buf["variant"][2:])
            (a8, a32), (b8, b32) = _both_assemblies(ms, buf)
            np.testing.assert_array_equal(a8, b8)
            np.testing.assert_array_equal(a32, b32)
        steps += 1

    # all-I step (mv NONE + nest): K=1 so no P frame shares the dispatch
    ms_i = msm.MultiStreamDecoder(
        cfg, [make_clip(cfg, ["I"], seed=9)], planner_factory=NativePlanner)
    buf, _m, _v = ms_i.plan_step()
    seen.add(buf["variant"][2:])
    (a8, a32), (b8, b32) = _both_assemblies(ms_i, buf)
    np.testing.assert_array_equal(a8, b8)
    np.testing.assert_array_equal(a32, b32)

    mv_modes = {v[0] for v in seen}
    assert msm._MV_NONE in mv_modes          # all-I step
    assert msm._MV_WIDE in mv_modes          # forced escape tier
    assert msm._MV_PACKED8 in mv_modes       # P/B steps, one byte-pair/MB
    # refsel-2 second vectors must be parity-covered through the v6 mv2
    # POOL (the C pool writer is a distinct branch that must not lose
    # coverage silently if the encoder's refsel statistics drift)
    assert mv2_pooled > 0
    # the codebook path (meta_bits < 6) must be covered: tiny synthetic
    # frames use far fewer than 32 distinct meta bytes
    # (seen holds variant[2:] = (mv_mode, has_nest, meta_bits))
    assert any(v[2] < 6 for v in seen)
    assert any(v[1] for v in seen)           # a nest-carrying step
    assert steps >= 4
