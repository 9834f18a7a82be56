"""The port's fault drill (``tools/torch_fault_drill.py``) against the JAX
package's (``tools/fault_drill.py``), on the CPU.

The smoke (the two wire scenarios over real sockets: a straggler saved by
hedging, a torn response that is never replayed) runs in a subprocess
with the JAX drill's test's assertions. The scenario table, the smoke's
scenarios, every scenario's fault plan and its artifact keys are the JAX
drill's. ``serving_poison`` runs in process beside the JAX scenario at
the same sizes and must count the same; ``gang_stall`` drives a stalled
2-rank gang end to end and its JAX invariant must hold.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "tools"
if str(TOOLS) not in sys.path:
    sys.path.insert(0, str(TOOLS))

import fault_drill as jdrill  # noqa: E402
import torch_fault_drill as tdrill  # noqa: E402


@pytest.fixture(scope="module")
def smoke_proc(tmp_path_factory):
    """The smoke's subprocess, started by the first test that asks for it
    so that the in-process scenarios run beside it."""
    out = tmp_path_factory.mktemp("fault_smoke") / "fault_smoke.json"
    proc = subprocess.Popen(
        [sys.executable, str(TOOLS / "torch_fault_drill.py"), "--smoke", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def smoke(smoke_proc):
    proc, out = smoke_proc
    stdout, stderr = proc.communicate(timeout=560)
    assert proc.returncode == 0, (stdout[-2000:], stderr[-2000:])
    return json.loads(out.read_text())


def test_serving_poison_counts_as_the_jax_scenario(tmp_path, smoke_proc):
    """The same plan on the same sizes: decode launch 0 fails its rows,
    everything else is served, nothing leaks or recompiles — and both
    packages' engines count it alike."""
    keys = ("submitted", "served", "poisoned", "quarantined", "loop_restarts",
            "recompiles_after_warmup", "kv_slots_leaked")
    ours = tdrill.scenario_serving_poison(str(tmp_path / "torch"))
    theirs = jdrill.scenario_serving_poison(str(tmp_path / "jax"))
    assert ours["ok"] is True and theirs["ok"] is True
    assert {k: ours[k] for k in keys} == {k: theirs[k] for k in keys}
    assert ours["plan"] == theirs["plan"] and ours["flight"]["events"] > 0
    assert set(theirs) <= set(ours)


def test_gang_stall_is_blamed_on_rank_one(tmp_path, smoke_proc):
    """A 2-rank MLP gang whose rank 1 stalls at step 2: the heartbeat
    monitor (timeout 8 s) names rank 1 and the cause, and rank 1 and the
    driver each left a non-empty flight dump."""
    out = tdrill.scenario_gang_stall(str(tmp_path), platform="cpu")
    assert out["ok"] is True, out
    assert (out["detected"], out["cause"], out["rank"]) == (True, "heartbeat", 1)
    assert out["flight"]["events"] > 0 and out["driver_flight"]["events"] > 0
    assert os.environ.get("MLSPARK_FAULTS") is None  # the plan was cleared


def test_fault_drill_wire_smoke_subprocess(smoke):
    assert smoke["all_ok"] is True and smoke["smoke"] is True
    by_name = {s["scenario"]: s for s in smoke["scenarios"]}
    assert set(by_name) == {"straggler_hedge", "torn_response_retry"}
    hedge = by_name["straggler_hedge"]
    assert hedge["ok"] is True
    assert hedge["ledger"]["hedged"] >= 1
    assert hedge["ledger"]["cancelled"] >= 1
    torn = by_name["torn_response_retry"]
    assert torn["ok"] is True
    assert torn["ledger"]["failed"] == 1 and torn["router_retries"] == 0


def test_scenario_tables_are_the_jax_drills():
    assert list(tdrill.SCENARIOS) == list(jdrill.SCENARIOS)
    assert tdrill.SMOKE_SCENARIOS == jdrill.SMOKE_SCENARIOS
    for name, fn in tdrill.SCENARIOS.items():
        assert fn.__name__ == jdrill.SCENARIOS[name].__name__ == f"scenario_{name}"
    assert set(tdrill.GANG_SCENARIOS) | set(tdrill.FLEET_SCENARIOS) | {"serving_poison"} == set(tdrill.SCENARIOS)


def _function(module, name) -> ast.FunctionDef:
    tree = ast.parse(Path(module.__file__).read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)


def _plan(module, name) -> str | None:
    """The constant a scenario assigns to ``plan`` (None: it kills by
    signal and arms no plan)."""
    for node in ast.walk(_function(module, name)):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "plan" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


def _record_keys(module, name) -> set[str]:
    """The keys of the record a scenario returns (the dict literal with a
    ``"scenario"`` key)."""
    for node in ast.walk(_function(module, name)):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "scenario" in keys:
                return keys
    raise AssertionError(f"{name} builds no scenario record")


@pytest.mark.parametrize("name", sorted(jdrill.SCENARIOS))
def test_each_scenarios_plan_is_the_jax_drills(name):
    fn = f"scenario_{name}"
    assert _plan(tdrill, fn) == _plan(jdrill, fn)
    assert (_plan(tdrill, fn) is None) == (name in ("fleet_kill_replica", "preemption_as_scale_down"))


@pytest.mark.parametrize("name", sorted(jdrill.SCENARIOS))
def test_each_scenarios_record_keys_include_the_committed_artifacts(name):
    committed = json.loads((ROOT / "FAULTS_r06.json").read_text())
    want = next(set(s) for s in committed["scenarios"] if s["scenario"] == name)
    assert want <= _record_keys(tdrill, f"scenario_{name}")


def test_smoke_records_carry_the_committed_keys_and_plans(smoke):
    committed = {s["scenario"]: s for s in json.loads((ROOT / "FAULTS_r06.json").read_text())["scenarios"]}
    assert {"artifact", "round", "smoke", "all_ok", "scenarios"} <= set(smoke)
    assert (smoke["artifact"], smoke["round"]) == ("FAULTS", 6)
    for record in smoke["scenarios"]:
        assert set(committed[record["scenario"]]) <= set(record)
        assert record["plan"] == committed[record["scenario"]]["plan"]


def test_a_full_run_without_a_card_names_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'"):
        tdrill.main(["gang_stall"])
