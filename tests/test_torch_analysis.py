"""The port's static analysis (``machine_learning_apache_spark_tpu_torch/
analysis``, ``tools/torch_mlspark_lint.py``) against the JAX package's,
plus the clean-tree gate that wires it into tier-1.

- ``locks``, ``env``, ``trace``, the pragma grammar and the config's
  overrides: the port's passes and the JAX package's run over the same
  synthetic sources (those ``tests/test_analysis.py`` writes) and must
  report the same ``(rule, severity, line, suppressed)`` findings.
- ``recompile`` and ``jit``: the port's own rules (captured CUDA-graph
  programs, ``ProgramCache`` calls). Each rule fires once on a planted
  hazard, naming the root that pulls the function in, and host-only code
  is not flagged.
- Root discovery over the real port finds exactly its six program call
  sites and reaches the training program's K-step closure.
- The gate: the CLI over the port in a subprocess (stdlib only, no
  torch) exits 0 with no error and a non-empty suppression ledger; a
  dirty tree exits 1.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from machine_learning_apache_spark_tpu import analysis as janalysis
from machine_learning_apache_spark_tpu.analysis import core as jcore
from machine_learning_apache_spark_tpu.analysis import envcheck as jenvcheck
from machine_learning_apache_spark_tpu_torch import analysis as tanalysis
from machine_learning_apache_spark_tpu_torch.analysis import core as tcore
from machine_learning_apache_spark_tpu_torch.analysis import envcheck as tenvcheck
from machine_learning_apache_spark_tpu_torch.analysis.callgraph import build_call_graph
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "machine_learning_apache_spark_tpu_torch"

PACKAGES = {
    "jax": (janalysis, jcore, jenvcheck),
    "torch": (tanalysis, tcore, tenvcheck),
}

REGISTRY_SRC = '''
def register(name, *, type="str", default=None, subsystem="core",
             description="", choices=None):
    pass

register("MLSPARK_FOO", type="int", default=3, subsystem="core",
         description="Foo knob.")
register("MLSPARK_MODE", type="str", default="fast", subsystem="serve",
         description="Mode.", choices=("fast", "slow"))
'''


def _lint(analysis, root, source, passes, *, filename="mod.py", config=None):
    path = root / filename
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    cwd = os.getcwd()
    os.chdir(root)
    try:
        return analysis.run_lint([filename], str(root), config=config, passes=passes)
    finally:
        os.chdir(cwd)


def _keys(findings):
    return [(f.rule, f.severity, f.line, f.suppressed) for f in findings]


# -- locks, env, trace: the JAX package's findings ----------------------------------

LOCKS_ATTR = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0  # guarded-by: self._lock

        def inc(self):
            with self._lock:
                self.n += 1

        def ok_caller_locked(self):  # mlspark-lint: holds self._lock
            return self.n

        def bad(self):
            return self.n

        def closure(self):
            with self._lock:
                return lambda: self.n  # a closure does not inherit the lock
"""

SHARED_CASES = {
    "locks_attr": (["locks"], LOCKS_ATTR),
    "locks_global": (["locks"], """
        import threading

        LOCK = threading.Lock()
        COUNT = 0  # guarded-by: LOCK
        # guarded-by: LOCK
        NAMES = {}

        def bump():
            global COUNT
            with LOCK:
                COUNT += 1
                NAMES["a"] = 1

        def peek():
            return COUNT, NAMES
    """),
    "locks_pragma": (["locks"], """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0  # guarded-by: self._lock

            def racy(self):
                return self.n  # mlspark-lint: ok locks-guarded-attr -- a torn read is fine here
    """),
    "trace_unwrapped": (["trace"], """
        from telemetry import events as _events

        def terminal(outcome, log):
            _events.annotate("fleet.request", outcome=outcome)
            log.emit("annotation", "serving.request", attrs={})
    """),
    "trace_with_use_and_escape": (["trace"], """
        from telemetry import events as _events
        from telemetry import tracectx

        def ok(ctx, log):
            with tracectx.use(ctx):
                _events.annotate("fleet.request", outcome="completed")
                log.emit("annotation", "serving.request", attrs={})

        def escape(ctx):
            with tracectx.use(ctx):
                def later():
                    _events.annotate("fleet.request", outcome="x")
                return later
    """),
    "trace_other_annotations": (["trace"], """
        from telemetry import events as _events

        def breadcrumb(log):
            _events.annotate("serving.queue.reject", depth=3)
            log.emit("annotation", "gang.teardown", attrs={})
            log.emit("counter", "fleet.request")
    """),
    "trace_pragmas": (["trace"], """
        from telemetry import events as _events

        def worker(trace):
            _events.annotate("serving.request", t=1)  # mlspark-lint: ok trace-no-context -- ctx re-activated
            # mlspark-lint: ok trace-no-context, locks-guarded-attr -- a pragma line covers the next one
            _events.annotate("fleet.request", t=2)
            _events.annotate("fleet.request", t=3)
    """),
    "trace_file_wide": (["trace", "locks"], """
        # mlspark-lint: ok-file trace-no-context -- a whole module of dynamic contexts
        from telemetry import events as _events

        def worker():
            _events.annotate("serving.request", t=1)
    """),
}


@pytest.mark.parametrize("case", sorted(SHARED_CASES))
def test_locks_and_trace_findings_equal_the_jax_passes(case, tmp_path):
    passes, source = SHARED_CASES[case]
    got = {}
    for tag, (analysis, core, _) in PACKAGES.items():
        got[tag] = _keys(_lint(analysis, tmp_path / tag, source, passes, config=core.LintConfig()))
    assert got["torch"] == got["jax"]
    if case not in ("trace_other_annotations", "trace_file_wide"):
        assert got["torch"], case


ENV_CASES = {
    "direct_reads": """
        import os
        import os as _os

        ENV_FOO = "MLSPARK_FOO"

        def a():
            return os.getenv("MLSPARK_FOO")

        def b():
            return _os.environ.get(ENV_FOO)

        def c():
            return os.environ["MLSPARK_MODE"]

        def d():
            return "MLSPARK_FOO" in os.environ

        def e():
            os.environ.setdefault("MLSPARK_MODE", "slow")  # mlspark-lint: ok env-direct-read -- bootstrap
    """,
    "accessors_and_prose": """
        from utils import env as envcfg

        def a():
            print("set MLSPARK_FOO=1 to enable")
            return envcfg.get_int("MLSPARK_FOO")

        def prefix_family():
            return "MLSPARK_"
    """,
    "unregistered": """
        NAME = "MLSPARK_NOT_IN_REGISTRY"
    """,
}


@pytest.mark.parametrize("docs", ["fresh", "missing", "stale"])
@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_env_findings_equal_the_jax_pass(case, docs, tmp_path):
    """Each package against its own fresh docs (the generated header names
    its own tool and registry), or none, or stale ones."""
    got = {}
    for tag, (analysis, core, envcheck) in PACKAGES.items():
        root = tmp_path / tag
        root.mkdir()
        (root / "reg.py").write_text(REGISTRY_SRC)
        if docs != "missing":
            (root / "docs").mkdir()
            text = envcheck.render_markdown(envcheck.extract_registry(str(root / "reg.py")))
            (root / "docs" / "ENV.md").write_text(text if docs == "fresh" else "# wrong\n")
        cfg = core.LintConfig(env_registry="reg.py", env_docs="docs/ENV.md")
        got[tag] = _keys(_lint(analysis, root, ENV_CASES[case], ["env"], config=cfg))
    assert got["torch"] == got["jax"]
    assert any(k[0] == "env-docs-drift" for k in got["torch"]) == (docs != "fresh")


def test_registry_extraction_equals_the_jax_one(tmp_path):
    (tmp_path / "reg.py").write_text(REGISTRY_SRC)
    rows = [
        [(e.name, e.type, e.default, e.subsystem, e.description, e.choices, e.line)
         for e in envcheck.extract_registry(str(tmp_path / "reg.py"))]
        for _, _, envcheck in PACKAGES.values()
    ]
    assert rows[0] == rows[1] and len(rows[0]) == 2


# -- config ---------------------------------------------------------------------------


def test_severity_overrides_and_excludes_equal_the_jax_config(tmp_path):
    source = SHARED_CASES["trace_unwrapped"][1]
    got = {}
    for tag, (analysis, core, _) in PACKAGES.items():
        cfg = core.LintConfig(severity={"trace-no-context": "warning"}, exclude=["*/native/*"])
        got[tag] = (
            _keys(_lint(analysis, tmp_path / tag, source, ["trace"], config=cfg)),
            [cfg.excluded(p) for p in ("pkg/native/a.py", "native/a.py", "pkg/a.py")],
        )
    assert got["torch"] == got["jax"]
    assert {k[1] for k in got["torch"][0]} == {"warning"}


def test_port_defaults():
    """The port's configuration is its ``LintConfig`` defaults: it reads
    no pyproject table (the repo's ``[tool.mlspark_lint]`` is the JAX
    lint's)."""
    cfg = tcore.LintConfig()
    assert cfg.passes == ["recompile", "locks", "env", "jit", "trace"]
    assert cfg.env_registry == f"{PORT}/utils/env.py"
    assert cfg.env_docs == "docs/ENV_TORCH.md"
    assert cfg.severity == {"jit-donate": "warning"}
    assert sorted(tanalysis.PASSES) == sorted(janalysis.PASSES)
    assert not hasattr(tcore, "load_config")


def test_unknown_pass_raises(tmp_path):
    with pytest.raises(ValueError, match="unknown lint pass"):
        _lint(tanalysis, tmp_path, "x = 1\n", ["nope"])


# -- recompile: the port's rules over captured programs ------------------------------

# A program cache, its program (``step``) and a helper it calls: the
# hazard is planted in ``helper`` at line 9 (after the dedent).
PROGRAM_SRC = """
    import os
    import time
    import numpy as np
    import torch
    from utils.graph_cache import ProgramCache

    def helper(x, flag):
        {hazard}
        return x

    class Engine:
        def __init__(self, device):
            self._programs = ProgramCache(device)

        def _body(self, x, flag):
            return helper(x, flag)

        def run(self, x):
            return self._programs("run", self._body, x, True)
"""

HAZARDS = {
    "recompile-item": ["y = x.item()", "y = x.tolist()"],
    "recompile-cast": ["y = float(x)", "y = int(flag)", "y = bool(x)"],
    "recompile-asarray": ["y = np.asarray(x)", "y = np.array(x)", "y = x.numpy()"],
    "recompile-device-get": ["y = x.cpu()", "torch.cuda.synchronize()", "y = x.nonzero()",
                             "y = torch.nonzero(x)"],
    "recompile-time": ["y = time.time()", "y = time.perf_counter()", "y = time.monotonic()"],
    "recompile-env": ["y = os.environ.get('HOME')", "y = os.getenv('HOME')",
                      "y = os.environ['HOME']"],
}
PLANTED = [(rule, h) for rule, hs in sorted(HAZARDS.items()) for h in hs]


@pytest.mark.parametrize("rule,hazard", PLANTED, ids=[h for _, h in PLANTED])
def test_each_recompile_rule_fires_once_naming_its_root(rule, hazard, tmp_path):
    findings = _lint(tanalysis, tmp_path, PROGRAM_SRC.format(hazard=hazard), ["recompile"])
    assert _keys(findings) == [(rule, "error", 9, False)]
    assert "`mod.Engine._body` captured at mod.py:20" in findings[0].message
    assert "inside `mod.helper`" in findings[0].message


def test_host_only_code_is_not_flagged(tmp_path):
    """The same hazards outside any program, and a program's caller (which
    runs on the host around the replay), are not flagged."""
    findings = _lint(tanalysis, tmp_path, """
        import os
        import time
        from utils.graph_cache import ProgramCache

        def host_loop(x):
            t = time.time()
            os.environ.get("HOME")
            return x.item(), x.cpu(), t

        class Engine:
            def __init__(self, device):
                self._programs = ProgramCache(device)

            def _body(self, x):
                return x * 2

            def run(self, x):
                out = self._programs("run", self._body, x)
                return out.cpu().tolist()
    """, ["recompile"])
    assert findings == []


def test_roots_cuda_graph_blocks_annotations_and_factory_closures(tmp_path):
    """Roots: a cache parameter annotated ``ProgramCache``, the body of a
    ``with torch.cuda.graph(...)`` (a callable passed in is not
    resolved), and a closure a factory returned into ``self.<attr>``."""
    findings = _lint(tanalysis, tmp_path, """
        import torch
        from utils.graph_cache import ProgramCache

        def decode_all(programs: ProgramCache, batches):
            def decode(x):
                return x.item()
            return [programs("decode", decode, b) for b in batches]

        def traced(x):
            return x.tolist()

        def capture(graph, fn, x):
            with torch.cuda.graph(graph):
                fn(x)
                traced(x)

        def make_step(scale):
            def step(x):
                return x.cpu() * scale
            return step

        class Dispatch:
            def __init__(self, device):
                self.programs = ProgramCache(device, eager_first_call=True)
                self._step = make_step(2.0)

            def _program(self, x):
                return self._step(x)

            def group(self, x):
                return self.programs("steps", self._program, x)
    """, ["recompile"])
    assert [(f.rule, f.line) for f in findings] == [
        ("recompile-item", 7), ("recompile-item", 11), ("recompile-device-get", 20),
    ]
    assert "captured at mod.py:14" in findings[1].message  # the with block's line


def test_recompile_pragma_suppresses_but_keeps_the_finding(tmp_path):
    findings = _lint(tanalysis, tmp_path, PROGRAM_SRC.format(
        hazard="y = x.item()  # mlspark-lint: ok recompile-item -- the CPU's eager branch only"),
        ["recompile"])
    assert _keys(findings) == [("recompile-item", "error", 9, True)]


# -- jit: program-cache hygiene -------------------------------------------------------


def test_jit_donate_warns_on_a_state_program_without_eager_first_call(tmp_path):
    findings = _lint(tanalysis, tmp_path, """
        from utils.graph_cache import ProgramCache

        def train_step(state, batch):
            return state

        def eval_step(x):
            return x

        plain = ProgramCache("cuda")
        eager = ProgramCache("cuda", eager_first_call=True)

        def run(state, batch):
            plain("train", train_step, state, batch)
            eager("train", train_step, state, batch)
            plain("eval", eval_step, batch)
    """, ["jit"])
    assert _keys(findings) == [("jit-donate", "warning", 14, False)]
    assert "eager_first_call" in findings[0].message


def test_jit_static_hashable_on_an_unhashable_literal(tmp_path):
    findings = _lint(tanalysis, tmp_path, """
        from utils.graph_cache import ProgramCache

        class Engine:
            def __init__(self):
                self._programs = ProgramCache("cuda")

            def _body(self, x, widths):
                return x

            def run(self, x):
                self._programs("a", self._body, x, [1, 2])
                self._programs("b", self._body, x, (1, 2))
                self._programs("c", self._body, x, {k: 1 for k in "ab"})
    """, ["jit"])
    assert [(f.rule, f.severity, f.line) for f in findings] == [
        ("jit-static-hashable", "error", 12), ("jit-static-hashable", "error", 14),
    ]


def test_severity_override_applies(tmp_path):
    cfg = tcore.LintConfig(severity={"jit-donate": "error"})
    findings = _lint(tanalysis, tmp_path, """
        from utils.graph_cache import ProgramCache

        cache = ProgramCache("cuda")

        def train_step(state):
            return state

        cache("t", train_step, 1)
    """, ["jit"], config=cfg)
    assert [f.severity for f in findings] == ["error"]


# -- the real port ----------------------------------------------------------------------

PORT_PROGRAM_SITES = {
    f"{PORT}/serving/engine.py:302": "serving.engine.ServingEngine._decode_body",
    f"{PORT}/serving/paged_runtime.py:278": "serving.paged_runtime.PagedDecodeRuntime._prefill_body",
    f"{PORT}/serving/paged_runtime.py:461": "serving.paged_runtime.PagedDecodeRuntime._launch_body",
    f"{PORT}/inference.py:369": "inference.Translator._decode",
    f"{PORT}/recipes/translation.py:418": "recipes.translation.bleu_decode.decode",
    f"{PORT}/train/loop.py:283": "train.loop.StepDispatch._program",
}


def test_root_discovery_over_the_port_finds_its_six_program_call_sites(monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    graph = build_call_graph(tcore.load_tree([PORT], tcore.LintConfig()))
    roots = graph.program_roots()
    assert {where: info.qual[len(PORT) + 1:] for info, where in roots} == PORT_PROGRAM_SITES
    reach = graph.reachable(roots)
    # The training program's K steps: StepDispatch._multi is the closure
    # make_multi_step returns, and its body reaches the optimizer update.
    for qual in ("train.loop.make_multi_step.multi_step", "train.state.TrainState.update_on_device",
                 "models.transformer.Transformer.decode_step_paged",
                 "ops.hopper_attention.ragged_paged_attention", "ops.hopper_attention.flash_attention"):
        assert f"{PORT}.{qual}" in reach, qual
    # The host around a program is not reached.
    for qual in ("train.loop.fit", "serving.engine.ServingEngine.submit", "fleet.router.FleetRouter.submit"):
        assert f"{PORT}.{qual}" not in reach, qual


def _cli(*argv, cwd=REPO_ROOT):
    return subprocess.run(
        [sys.executable, os.path.join(REPO_ROOT, "tools", "torch_mlspark_lint.py"), *argv],
        cwd=cwd, capture_output=True, text=True, timeout=300,
    )


def test_port_tree_has_zero_unsuppressed_errors():
    """The enforcement point: the real CLI over the real port, in a
    subprocess with no torch. A new hazard is fixed or waived with a
    justified pragma — landing one silently fails tier-1 here."""
    proc = _cli(PORT, "--json")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["counts"]["error"] == 0, json.dumps(
        [f for f in payload["findings"] if f["severity"] == "error" and not f["suppressed"]],
        indent=2,
    )
    assert payload["counts"]["suppressed"] > 0
    # Every suppression is a pragma with its justification, on the
    # finding's line or on a pragma line just above it.
    for f in payload["findings"]:
        with open(os.path.join(REPO_ROOT, f["path"])) as src:
            lines = src.read().splitlines()
        near = [t for t in lines[max(0, f["line"] - 2):f["line"]] if "mlspark-lint: ok" in t]
        assert near and all(" -- " in t for t in near), f


def test_port_cli_exit_code_on_a_dirty_tree(tmp_path):
    (tmp_path / "dirty.py").write_text(textwrap.dedent("""
        from utils.graph_cache import ProgramCache

        programs = ProgramCache("cuda")

        def step(x):
            return x.item()

        programs("step", step, 1)
    """))
    proc = _cli("dirty.py", "--root", str(tmp_path), "--passes", "recompile")
    assert proc.returncode == 1
    assert "recompile-item" in proc.stdout
    assert "mlspark-lint: 1 error(s)" in proc.stdout


def test_write_env_docs_reproduces_the_committed_file(tmp_path):
    """``--write-env-docs`` over a copy of the registry writes exactly the
    committed ``docs/ENV_TORCH.md`` (the drift rule's other half)."""
    reg = tmp_path / PORT / "utils"
    reg.mkdir(parents=True)
    with open(os.path.join(REPO_ROOT, PORT, "utils", "env.py")) as f:
        (reg / "env.py").write_text(f.read())
    proc = _cli("--root", str(tmp_path), "--write-env-docs")
    assert proc.returncode == 0, proc.stderr
    with open(os.path.join(REPO_ROOT, "docs", "ENV_TORCH.md")) as f:
        assert (tmp_path / "docs" / "ENV_TORCH.md").read_text() == f.read()
