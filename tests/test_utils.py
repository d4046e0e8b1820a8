"""Profiling/observability utilities."""

import time

from hvqm4_jax.utils.profiling import StageTimer


def test_stage_timer_collects_and_reports():
    t = StageTimer(enabled=True)
    with t.stage("plan"):
        time.sleep(0.01)
    with t.stage("device"):
        pass
    rep = t.report()
    assert "plan" in rep and "device" in rep
    assert t.counts["plan"] == 1 and t.totals["plan"] >= 0.01


def test_stage_timer_disabled_is_free():
    t = StageTimer(enabled=False)
    with t.stage("x"):
        pass
    assert not t.totals
    assert t.report() == "(no stages recorded)"
