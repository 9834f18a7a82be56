"""The port's ingest bench (``tools/torch_ingest_bench.py``) against the
JAX package's (``tools/ingest_bench.py``), on the CPU.

The smoke (one tiny entry, the semantic gates: the stream's batches are
the sync loader's, two stream epochs agree, no pipeline thread leaks)
runs in a subprocess with the JAX bench's test's assertions. The JAX
bench sets ``XLA_FLAGS`` when it is imported, so its functions run in a
subprocess of their own, started beside the smoke: the corpus it writes
must be the port's byte for byte, its loader's batch checksums over that
file the port's, and its packing sweep's row counts and efficiency the
port's.
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

import torch_ingest_bench as tbench  # noqa: E402

#: The JAX bench's functions, in a process of their own: the corpus of the
#: smoke entry's sizes, its loader's checksums, the packing sweep.
JAX_ORACLE = """
import json, sys
sys.path.insert(0, sys.argv[1])
import ingest_bench as jb
from machine_learning_apache_spark_tpu.data.libsvm import read_libsvm
from machine_learning_apache_spark_tpu.data.loader import ArrayDataset, DataLoader

path, records, features, batch = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
jb._write_corpus(path, records, features, seed=7)
frame = read_libsvm(path, num_features=features)
loader = DataLoader(ArrayDataset(frame.features, frame.labels), batch, shuffle=False, drop_last=True)
print(json.dumps({"sums": jb._batch_checksum(iter(loader)), "packing": jb._packing_sweep(600, seed=11)}))
"""
ENTRY = tbench.SMOKE_ENTRIES[0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The smoke and the JAX oracle, started together."""
    d = tmp_path_factory.mktemp("ingest_bench")
    out, corpus = d / "ingest_bench.json", d / "jax_corpus.libsvm"
    oracle = subprocess.Popen(
        [sys.executable, "-c", JAX_ORACLE, str(TOOLS), str(corpus), str(ENTRY["records"]),
         str(ENTRY["features"]), str(ENTRY["batch"])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    smoke = subprocess.Popen(
        [sys.executable, str(TOOLS / "torch_ingest_bench.py"), "--smoke", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        o_out, o_err = oracle.communicate(timeout=300)
        s_out, s_err = smoke.communicate(timeout=300)
    finally:
        for p in (oracle, smoke):
            if p.poll() is None:
                p.kill()
    assert oracle.returncode == 0, o_err[-2000:]
    return {"smoke_rc": smoke.returncode, "smoke_err": s_err, "artifact": out, "jax_corpus": corpus,
            "jax": json.loads(o_out.strip().splitlines()[-1]), "dir": d}


def test_ingest_bench_smoke_subprocess(runs):
    assert runs["smoke_rc"] == 0, runs["smoke_err"][-2000:]
    art = json.loads(runs["artifact"].read_text())
    assert art["ok"] is True
    assert art["gates"] == {
        "parity_sync_vs_stream": True,
        "determinism": True,
        "threads_clean": True,
    }
    entry = art["sweep"][0]
    assert {"sync", "stream_off", "stream_on"} <= set(entry)
    assert entry["stream_on"]["batches_per_epoch"] > 0
    assert art["packing"]["rows_packed"] < art["packing"]["rows_unpacked"]
    assert art["env"]["device"] == "cpu" and entry["stream_on"]["device"] == "cpu"


def test_corpus_is_the_jax_benchs_byte_for_byte(runs):
    ours = runs["dir"] / "torch_corpus.libsvm"
    tbench._write_corpus(str(ours), ENTRY["records"], ENTRY["features"], seed=7)
    assert ours.read_bytes() == runs["jax_corpus"].read_bytes()


def test_sync_batch_checksums_are_the_jax_loaders(runs):
    from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
    from machine_learning_apache_spark_tpu_torch.data.loader import ArrayDataset, DataLoader

    frame = read_libsvm(str(runs["jax_corpus"]), num_features=ENTRY["features"])
    loader = DataLoader(ArrayDataset(frame.features, frame.labels), ENTRY["batch"], shuffle=False,
                        drop_last=True)
    sums = tbench._batch_checksum(iter(loader))
    assert len(sums) == ENTRY["records"] // ENTRY["batch"]
    assert sums == runs["jax"]["sums"]


def test_packing_sweep_is_the_jax_benchs(runs):
    ours, theirs = tbench._packing_sweep(600, seed=11), runs["jax"]["packing"]
    for key in ("rows_packed", "rows_unpacked", "token_efficiency_packed", "pairs", "src_len", "trg_len"):
        assert ours[key] == theirs[key], key
    assert ours["pack_on"]["batches"] == theirs["pack_on"]["batches"]
    assert ours["pack_off"]["batches"] == theirs["pack_off"]["batches"]


def test_a_full_run_without_a_card_names_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'"):
        tbench.main([])


def test_no_file_without_out(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tbench, "run", lambda *a, **k: {"ok": True, "sweep": []})
    assert tbench.main(["--smoke"]) == 0
    assert json.loads(capsys.readouterr().out) == {"ok": True, "sweep": []}
    assert not list(tmp_path.iterdir())
