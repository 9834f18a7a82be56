"""Boundaries of the PyTorch/CUDA port.

The port imports torch and numpy, never JAX or the JAX package: an AST
scan of every module (and of ``chip_smoke.py``, the card-only tests with
their helper ``tests/torch_*.py`` and the card's timing tools
``tools/torch_*.py``) checks the import
statements themselves — ``sys.modules`` would not do, since the test
process has JAX loaded already. Entry points run on the card unless the
caller asks for the CPU, and raise when there is no card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401 — this suite runs beside the JAX package's
import pytest
import torch

import machine_learning_apache_spark_tpu_torch as port
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

REPO = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")
JAX_PACKAGE = "machine_learning_apache_spark_tpu"


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN or root == JAX_PACKAGE


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _scanned_files():
    # The card-only tests, their helper and the card's timing tools run
    # where there is no JAX, so they are held to the same rule as the package and the smoke.
    return sorted(PORT_DIR.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "test_torch_gpu.py",
        *sorted((REPO / "tests").glob("torch_*.py")),
        *sorted((REPO / "tools").glob("torch_*.py")),
    ]


def test_port_never_imports_jax_or_the_jax_package():
    files = _scanned_files()
    assert len(files) > 20  # the scan sees the whole package
    assert PORT_DIR / "parallel" / "tensor_parallel.py" in files
    bad = [
        f"{p.relative_to(REPO)}:{line}: import {mod}"
        for p in files
        for line, mod in _imports(p)
        if _forbidden(mod)
    ]
    assert not bad, "the port must stay free of JAX:\n" + "\n".join(bad)


@pytest.mark.parametrize(
    "module,forbidden",
    [("jax.numpy", True), ("flax.linen", True), ("orbax.checkpoint", True),
     ("machine_learning_apache_spark_tpu.ops", True),
     ("machine_learning_apache_spark_tpu", True),
     ("machine_learning_apache_spark_tpu_torch.ops", False),
     ("torch", False), ("numpy", False)],
)
def test_forbidden_rule(module, forbidden):
    assert _forbidden(module) is forbidden


def test_kernel_sources_ship_with_the_package():
    sources = sorted(p.name for p in (PORT_DIR / "csrc").glob("*.cu"))
    assert sources == [
        "flash_attention_bwd.cu", "flash_attention_fwd.cu",
        "ragged_paged_attention.cu",
    ]


def test_entry_points_raise_without_a_card(monkeypatch):
    from machine_learning_apache_spark_tpu_torch.data.text import (
        TextPipeline,
        Vocab,
    )
    from machine_learning_apache_spark_tpu_torch.inference import Translator
    from machine_learning_apache_spark_tpu_torch.models import (
        Transformer,
        TransformerConfig,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = TextPipeline(Vocab(["a", "b"]))
    model = Transformer(TransformerConfig(
        src_vocab_size=6, trg_vocab_size=6, d_model=16, ffn_hidden=16,
        num_heads=2, max_len=8,
    ))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Translator(model, pipe, pipe)
    t = Translator(model, pipe, pipe, device="cpu")
    assert t.device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    """The smoke must exit nonzero and print no result where there is no
    card — here, on the CPU — and where it stands alone, without the
    package beside it."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the smoke would run for real")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:
            (tmp_path / script).write_text((REPO / script).read_text())
        proc = subprocess.run(
            [sys.executable, script], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode != 0, proc.stdout
        assert '"ok": true' not in proc.stdout


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No toolkit, no kernels: the build raises instead of falling back."""
    import torch.utils.cpp_extension as cpp_ext

    from machine_learning_apache_spark_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()


def test_wrappers_take_only_cpu_or_cuda_tensors():
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop

    q = torch.empty(1, 2, 3, 8, device="meta")
    with pytest.raises(ValueError, match="CPU .* or on a CUDA device"):
        hop.flash_attention(q, q, q)
    pages = torch.empty(5, 4, 16, device="meta")
    table = torch.empty(1, 2, dtype=torch.int32, device="meta")
    lengths = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU .* or on a CUDA device"):
        hop.ragged_paged_attention(
            torch.empty(1, 2, 8, device="meta"), pages, pages, table, lengths
        )
