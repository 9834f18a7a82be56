"""Sequence parallelism of the port in a gang: one 4-rank gloo gang
(``torch_launcher_workers:sp_four_rank``), spawned once by a module
fixture, against the JAX package's ``ring_attention``,
``ulysses_attention`` and its ``fit`` under ``sequence_parallel`` on the
virtual CPU devices, computed while the gang runs.

On ``{seq: 4}`` and ``{data: 2, seq: 2}``: ring and Ulysses at one
attention site through ``dot_product_attention`` (full; causal with a
``kv_valid`` holding a fully padded row), each data index's output rows
and the gradients of q, k and v against the JAX mechanism at atol 1e-5,
every rank of a seq line the same bits, and the line's collectives
counted (the ring's rotations ``n - 1`` forward and ``2n - 1`` backward).
3 SGD steps of the Transformer's ``fit(mesh=)`` (tiny widths, no dropout,
weights carried over by ``weights.load_flax_params``) under ring on
``{seq: 4}`` and under Ulysses on ``{data: 2, seq: 2}`` against the JAX
``fit`` on the same meshes: parameters at atol 1e-5, the epoch's mean
loss at rtol 1e-5, ``assert_replicas_in_sync`` passing (the seq lines' bits equal),
every rank's parameters the same bits. The recipe under the gang's
``Distributor``: ``sequence_parallel=4`` (ring) against the one-process
recipe (step losses rtol 1e-4: the one extra pad column of the SP targets
changes only the summation order), ``=2`` (Ulysses, BLEU, checkpoints),
and ``sequence_parallel`` beside ``model_parallel`` raising
``NotImplementedError`` with its ROADMAP item. In process: the mesh's
layout and refusals, the gang report's seq-line section, the recipe's
Ulysses head check beside the JAX recipe's.
"""

from __future__ import annotations

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from machine_learning_apache_spark_tpu.models.transformer import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.ops import attention as jattention
from machine_learning_apache_spark_tpu.parallel.mesh import make_mesh as j_make_mesh
from machine_learning_apache_spark_tpu.parallel.ring_attention import ring_attention as j_ring
from machine_learning_apache_spark_tpu.parallel.ulysses_attention import (
    ulysses_attention as j_ulysses,
)
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

GANG_ENV = {"OMP_NUM_THREADS": "1"}
ATOL = 1e-5
TINY = dict(src_vocab_size=37, trg_vocab_size=41, d_model=16, ffn_hidden=32, num_heads=4,
            num_layers=1, max_len=12, dropout=0.0)
RECIPE = dict(data_root="assets/fixtures", d_model=32, ffn_hidden=64, num_heads=4, max_len=24,
              num_layers=1, epochs=1, batch_size=32, dropout=0.0, log_every=0, seed=3)
LR = 0.5
MESHES = {"seq4": {"data": 1, "seq": 4}, "data2 seq2": {"data": 2, "seq": 2}}
FITS = {"seq4 ring": ("seq4", "ring"), "data2 seq2 ulysses": ("data2 seq2", "ulysses")}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _j_mesh(name):
    axes = MESHES[name]
    return j_make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])


def _inputs():
    rng = np.random.default_rng(11)
    qkv = tuple(rng.standard_normal((4, 4, 16, 8)).astype(np.float32) for _ in range(3))
    valid = np.ones((4, 16), bool)
    valid[0] = False
    valid[1, 10:] = False
    valid[3, 5:] = False
    jm = JTransformer(JConfig(**TINY))
    src = rng.integers(1, TINY["src_vocab_size"], (8, 8))
    trg = rng.integers(1, TINY["trg_vocab_size"], (8, 9))
    boxed = jax.jit(jm.init)(jax.random.key(2), src, trg[:, :-1])["params"]
    batches = []
    for _ in range(4):
        s = rng.integers(1, TINY["src_vocab_size"], (8, 8))
        t = rng.integers(1, TINY["trg_vocab_size"], (8, 9))
        s[1, 6:] = 0
        t[2, 5:] = 0
        batches.append((s, t))
    return qkv, valid, jm, boxed, batches


def _jax_attention(qkv, valid):
    """The JAX mechanism per (mesh, method, case): output and gradients of
    sum(out²) over the whole batch."""
    out = {}
    for name in MESHES:
        mesh = _j_mesh(name)
        for method, fn in (("ring", j_ring), ("ulysses", j_ulysses)):
            for case, causal, kv in (("full", False, None), ("causal valid", True, valid)):
                def loss(q, k, v, kv=kv, causal=causal, fn=fn, mesh=mesh):
                    o = fn(q, k, v, mesh, causal=causal,
                           kv_valid=None if kv is None else jnp.asarray(kv))
                    return (o ** 2).sum(), o

                (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
                    *(jnp.asarray(a) for a in qkv))
                out[f"{name} {method} {case}"] = [np.asarray(o), *(np.asarray(g) for g in grads)]
    return out


def _recipe_errors() -> tuple[str, str]:
    """The JAX recipe's and the port's refusal of Ulysses with a head count
    the seq axis cannot divide."""
    from machine_learning_apache_spark_tpu.recipes.translation import (
        train_translator as j_train_translator,
    )

    kw = dict(epochs=1, synthetic_n=64, batch_size=8, max_len=16, d_model=30, ffn_hidden=64,
              num_heads=6, log_every=0, sequence_parallel=4, sequence_parallel_method="ulysses")
    with pytest.raises(ValueError, match="ulysses") as jerr:
        j_train_translator(**kw)
    with pytest.raises(ValueError, match="ulysses") as err:
        train_translator(device="cpu", **kw)
    return str(jerr.value), str(err.value)


def _jax_fit(jm, boxed, batches, mesh_name, method):
    mesh = _j_mesh(mesh_name)
    state = jstate.TrainState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.copy, boxed),
                                     tx=jstate.make_optimizer("sgd", LR))
    with jattention.sequence_parallel(mesh, method=method):
        res = jloop.fit(state, j_make_translation_loss(jm, 0), batches, epochs=1,
                        rng=jax.random.key(0), mesh=mesh, log_every=0, emit=lambda s: None)
    return _flat(jax.tree.map(np.asarray, fnn.unbox(res.state.params))), res


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang's results and the JAX oracles, computed while it runs."""
    qkv, valid, jm, boxed, batches = _inputs()
    tree = jax.tree.map(np.array, fnn.unbox(boxed))
    got: dict = {}

    def run():
        try:
            got["out"] = Distributor(num_processes=4, platform="cpu", timeout=600, env=GANG_ENV).run(
                "torch_launcher_workers:sp_four_rank", qkv, valid, TINY, tree, batches[:3], LR,
                batches[3:], RECIPE, str(tmp_path_factory.mktemp("sp")))
        except BaseException as e:  # noqa: BLE001 - re-raised in the main thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        oracle = {"attention": _jax_attention(qkv, valid),
                  "fit": {label: _jax_fit(jm, boxed, batches[:3], *where)
                          for label, where in FITS.items()},
                  "one": train_translator(device="cpu", _return_state=True, **RECIPE),
                  "heads": _recipe_errors()}
    finally:
        thread.join()
    if "error" in got:
        raise got["error"]
    assert kill_stray_gangs() == 0
    return got["out"], oracle, valid


# -- in process ------------------------------------------------------------------


def test_data_seq_mesh_lays_ranks_out_data_major():
    mesh = make_mesh({"seq": 2, "data": 2}, world=4)
    assert mesh.shape == {"data": 2, "seq": 2}
    assert mesh.axis_ranks("seq") == [0, 1] and mesh.axis_ranks("data") == [0, 2]
    assert make_mesh({"seq": -1}, world=4).shape == {"seq": 4}
    assert make_mesh({"seq": 4}, world=4).ring_neighbours("seq") == (3, 1)


@pytest.mark.parametrize("other", ["model", "pipeline", "expert"])
def test_seq_beside_another_axis_names_its_roadmap_item(other):
    with pytest.raises(NotImplementedError, match="ROADMAP queue A4: seq × model"):
        make_mesh({"data": 1, "seq": 2, other: 2}, world=4)


def test_gang_report_rolls_up_the_seq_line():
    from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

    events = [{"kind": "counter", "name": f"comms.sp_ring_{what}", "rank": r, "value": v,
               "attrs": {"steps": 2}}
              for r in (0, 1) for what, v in (("bytes", 600.0), ("window_seconds", 0.01))]
    report = aggregate.comms_report(events)
    assert report["sequence"] == {"sp_ring": {r: {"bytes_per_step": 300.0, "window_ms_per_step": 5.0}
                                              for r in (0, 1)}}
    assert "pipeline" not in report
    md = aggregate.render_markdown({"ranks": [0, 1], "event_count": len(events), "phases": {},
                                    "skew": {}, "comms": report})
    assert "| seq line | rank | bytes/step | window ms/step |" in md
    assert "| sp_ring | 1 | 300.0 | 5.0 |" in md


# -- the gang --------------------------------------------------------------------


CASES = [f"{m} {method} {case}" for m in MESHES for method in ("ring", "ulysses")
         for case in ("full", "causal valid")]


@pytest.mark.parametrize("case", CASES)
def test_sp_attention_in_the_gang_equals_the_jax_mechanism(gang, case):
    out, oracle, valid = gang
    want = oracle["attention"][case]
    mesh = next(axes for m, axes in MESHES.items() if case.startswith(m + " "))
    n = mesh["seq"]
    rows = 4 // mesh["data"]
    for rank in out["attention"]:
        got = rank[case]
        sl = slice(got["data"] * rows, (got["data"] + 1) * rows)
        for name, g, w in zip(("out", "dq", "dk", "dv"), got["out"], want):
            np.testing.assert_allclose(g, w[sl], rtol=0, atol=ATOL, err_msg=f"{case} {name}")
        assert got["line_equal"], case
        calls = got["calls"]
        if "ring" in case:
            # n - 1 rotations forward; backward n - 1 of K/V and n of dK/dV.
            assert calls == {"sp_ring": (n - 1) + (n - 1) + n, "sp_a2a": 0, "sp_gather": 2}
        else:
            # q, kv and the output each way; kv_valid gathered once.
            assert calls == {"sp_ring": 0, "sp_a2a": 6, "sp_gather": 3 if "valid" in case else 2}
    if "valid" in case:
        # The fully padded row (row 0) gives zeros.
        first = next(r[case] for r in out["attention"] if r[case]["data"] == 0)
        assert np.all(first["out"][0][0] == 0.0)


@pytest.mark.parametrize("label", list(FITS))
def test_sp_fit_in_the_gang_equals_the_jax_fit(gang, label):
    out, oracle, _ = gang
    got = out["fit"][label]
    want, j_res = oracle["fit"][label]
    g = _flat(got["params"])
    for path, w in want.items():
        np.testing.assert_allclose(g[path], w, rtol=0, atol=ATOL, err_msg=f"{label} {path}")
    np.testing.assert_allclose(np.mean(got["step_losses"]), j_res.final_loss, rtol=1e-5)
    assert got["in_sync"] == "ok" and got["ranks_equal"]
    comms = got["comms"]
    # Three sites a step (encoder, decoder self, cross: both lengths 8).
    kind = "sp_ring" if "ring" in label else "sp_a2a"
    assert comms["sp_steps"] == 3 and comms[f"{kind}_calls"] > 0
    assert comms["sp_gather_bytes"] > 0
    assert np.isfinite(got["test_loss"])


def test_the_two_fits_agree(gang):
    out, _, _ = gang
    a, b = (out["fit"][label] for label in FITS)
    np.testing.assert_allclose(a["step_losses"], b["step_losses"], rtol=1e-5)
    np.testing.assert_allclose(a["test_loss"], b["test_loss"], rtol=1e-5)


def test_recipe_trains_under_the_gangs_distributor(gang):
    out, oracle, _ = gang
    rec = out["recipe"]
    ring, uly = rec["ring 4"], rec["ulysses 2"]
    assert ring["mesh"] == {"data": 1, "seq": 4} and uly["mesh"] == {"data": 2, "seq": 2}
    one = oracle["one"]
    np.testing.assert_allclose(ring["step_losses"], one["fit_result"].step_losses, rtol=1e-4)
    np.testing.assert_allclose(ring["test_loss"], one["test_loss"], rtol=1e-4)
    assert ring["line_equal"] and uly["line_equal"]
    assert ring["comms"]["sp_ring_calls"] > 0 and uly["comms"]["sp_a2a_calls"] > 0
    assert np.all(np.isfinite(uly["step_losses"])) and uly["bleu"] is not None
    assert "ROADMAP queue A4: seq × model" in out["seq_model"]


def test_recipe_refuses_indivisible_heads_as_jax_does(gang):
    j_msg, msg = gang[1]["heads"]
    assert msg == j_msg
