"""The sharded decode + model feed (`__graft_entry__.multichip_check`) on
virtual CPU devices: `chip_smoke.py --four-cards` runs the same function on
four GPUs."""

import pytest

import __graft_entry__ as graft

# assurance tier: multi-device compiles (docs/TESTING.md)
pytestmark = pytest.mark.assurance


def test_dryrun_multichip_small_mesh():
    # 2 devices → dp=2 decode, (dp=1, tp=2) ViT on the virtual CPU mesh;
    # exercises the sharded decode step + TP ViT end to end
    graft.dryrun_multichip(2)
