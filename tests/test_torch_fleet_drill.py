"""The port's fleet autoscaling drill (``tools/torch_fleet_drill.py``)
against the JAX package's (``tools/fleet_drill.py``), on the CPU.

The smoke — a 2-replica port fleet of the tiny translator on the host
with a ``FleetAutoscaler`` on the router's scrape loop, closed-loop load
tripping a scale-up to 3 and its removal a drain back to 2 — runs in a
subprocess with the JAX drill's test's assertions. The decision gate,
the hedge bench's delay rule and its constants are the JAX drill's.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
if str(TOOLS) not in sys.path:
    sys.path.insert(0, str(TOOLS))

import fleet_drill as jdrill  # noqa: E402
import torch_fleet_drill as tdrill  # noqa: E402


def test_fleet_drill_smoke_subprocess(tmp_path):
    out = tmp_path / "fleet_drill_smoke.json"
    r = subprocess.run(
        [sys.executable, str(TOOLS / "torch_fleet_drill.py"), "--smoke", "--out", str(out)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    artifact = json.loads(out.read_text())
    assert artifact["ok"] is True
    assert artifact["gates"] == {
        "scaled_up_2_to_3": True,
        "scaled_down_3_to_2": True,
        "replacement_rank_serves": True,
        "zero_lost_non_in_flight": True,
        "decisions_carry_inputs": True,
    }
    assert artifact["conservation"]["router_ledger"]["in_flight"] == 0
    assert "host_load" in artifact and "contended" in artifact
    actions = [d["action"] for d in artifact["decisions"]]
    assert "scale_up" in actions
    assert "scale_down_start" in actions
    assert "scale_down_complete" in actions


def _decision(action, drop=()):
    full = dict(action=action, burn=0.2, queue_depth=3.0, live=2, target=3, wall=1.0)
    return {k: v for k, v in full.items() if k not in drop}


DECISION_CASES = {
    "empty": [],
    "complete": [_decision("scale_up"), _decision("scale_down_start"), _decision("scale_down_complete")],
    **{f"missing_{key}": [_decision("scale_up"), _decision("scale_down_start", drop=(key,))]
       for key in jdrill.DECISION_INPUT_KEYS},
    "many_missing": [_decision(f"a{i}", drop=("burn",)) for i in range(12)],
}


@pytest.mark.parametrize("case", sorted(DECISION_CASES))
def test_decision_gate_is_the_jax_drills(case):
    decisions = DECISION_CASES[case]
    assert tdrill._decision_gate(decisions) == jdrill._decision_gate(decisions)


def test_hedge_rule_and_constants_are_the_jax_drills():
    assert tdrill.DECISION_INPUT_KEYS == jdrill.DECISION_INPUT_KEYS
    assert (tdrill.HEDGE_P99_GATE, tdrill.HEDGE_SLOW_FACTOR, tdrill.HEDGE_DELAY_FLOOR_MS) == (
        jdrill.HEDGE_P99_GATE, jdrill.HEDGE_SLOW_FACTOR, jdrill.HEDGE_DELAY_FLOOR_MS)
    for p50 in (0.0, 0.01, 0.05, 0.0799, 0.08, 0.1234, 0.5, 2.0):
        # The JAX bench's inline rule (``run_hedge``).
        want = max(jdrill.HEDGE_DELAY_FLOOR_MS, int(jdrill.HEDGE_SLOW_FACTOR * p50 * 1000))
        assert tdrill.hedge_delay_ms(p50) == want


def test_a_full_run_without_a_card_names_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--hedge"]):
        with pytest.raises(RuntimeError, match="'cuda'"):
            tdrill.main(argv)


def test_no_artifact_without_out(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tdrill._write(None, {"ok": True})
    tdrill._write(str(tmp_path / "a" / "b.json"), {"ok": True})
    assert sorted(p.name for p in tmp_path.rglob("*") if p.is_file()) == ["b.json"]
