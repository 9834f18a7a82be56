"""The seq axis beside the model and expert axes in the port, against the
JAX package's ``ring_attention``, ``ulysses_attention`` and its ``fit``
under ``sequence_parallel`` on the same meshes of the virtual CPU devices.

One 8-rank gloo gang (``torch_launcher_workers:seq_compose_eight_rank``),
spawned once by a module fixture while the JAX oracles compile in the
main thread, on ``{data: 2, model: 2, seq: 2}`` (ring), ``{model: 2,
seq: 4}`` (Ulysses at 4 heads: a model rank's 2 heads do not divide over
4, so the model line's heads are gathered first), ``{expert: 2, model: 2,
seq: 2}`` (ring, 4 experts) and ``{data: 2, expert: 2, seq: 2}``
(Ulysses, 4 experts). On each: one attention site through
``dot_product_attention`` (full; causal with a ``kv_valid`` holding a
fully padded row) on the rank's rows and heads, its output and q/k/v
gradients against the JAX mechanism at atol 1e-5, the seq line's bits
equal and its collectives counted (the ring's rotations ``n - 1``
forward and ``2n - 1`` backward; Ulysses never routed to the ring); 3
SGD steps of the tiny Transformer's ``fit(mesh=)`` (weights carried over
by ``weights.load_flax_params``, no dropout) against the JAX ``fit``:
the parameters gathered from their shards at atol 1e-5, the mean loss
at rtol 1e-5, ``assert_replicas_in_sync`` passing. A checkpointed epoch
on ``{data: 2, model: 2, seq: 2}`` resumed bit for bit, and refused on
``{model: 2, seq: 4}`` with ``TopologyMismatch``.

In process: the mesh's layout (the JAX mesh's device order) and lines on
3- and 4-axis meshes, pipeline × seq refused in the JAX recipe's words,
``dp_mode="zero1"`` refused on a seq × model mesh as in JAX, the
recipe's Ulysses head check on the global head count beside the JAX
recipe's, and the gang report's seq, model and expert lines on one mesh.
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
from machine_learning_apache_spark_tpu_torch.parallel.mesh import _coords, _line_ranks
from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

GANG_ENV = {"OMP_NUM_THREADS": "1"}
ATOL = 1e-5
# Odd target vocabulary: a model axis pads the LM head.
TINY = dict(src_vocab_size=37, trg_vocab_size=41, d_model=16, ffn_hidden=32, num_heads=4,
            num_layers=1, max_len=12, dropout=0.0, logit_pad=1)
TINY_MOE = dict(TINY, moe_experts=4)
LR = 0.5
# name: (axes, method, MoE)
MESHES = {
    "data2 model2 seq2 ring": ({"data": 2, "model": 2, "seq": 2}, "ring", False),
    "model2 seq4 ulysses": ({"data": 1, "model": 2, "seq": 4}, "ulysses", False),
    "expert2 model2 seq2 ring": ({"data": 1, "expert": 2, "model": 2, "seq": 2}, "ring", True),
    "data2 expert2 seq2 ulysses": ({"data": 2, "expert": 2, "seq": 2}, "ulysses", True),
}
CASES = [f"{m} {case}" for m in MESHES for case in ("full", "causal valid")]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _j_mesh(axes):
    return j_make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])


def _model(cfg_kwargs, rng):
    jm = JTransformer(JConfig(**cfg_kwargs))
    src = rng.integers(1, TINY["src_vocab_size"], (8, 8))
    trg = rng.integers(1, TINY["trg_vocab_size"], (8, 9))
    return jm, jax.jit(jm.init)(jax.random.key(2), src, trg[:, :-1])["params"]


def _inputs():
    rng = np.random.default_rng(23)
    qkv = tuple(rng.standard_normal((4, 4, 16, 8)).astype(np.float32) for _ in range(3))
    valid = np.ones((4, 16), bool)
    valid[0] = False
    valid[1, 10:] = False
    valid[3, 5:] = False
    models = {False: _model(TINY, rng), True: _model(TINY_MOE, rng)}
    batches = []
    for _ in range(3):
        s = rng.integers(1, TINY["src_vocab_size"], (8, 8))
        t = rng.integers(1, TINY["trg_vocab_size"], (8, 9))
        s[1, 6:] = 0
        t[2, 5:] = 0
        batches.append((s, t))
    return qkv, valid, models, batches


def _jax_attention(qkv, valid):
    """The JAX mechanism per (mesh, case): the output and the gradients of
    sum(out²) over the whole batch and every head."""
    out = {}
    for name, (axes, method, _) in MESHES.items():
        mesh, fn = _j_mesh(axes), j_ring if method == "ring" else j_ulysses
        for case, causal, kv in (("full", False, None), ("causal valid", True, valid)):
            def loss(q, k, v, kv=kv, causal=causal, fn=fn, mesh=mesh):
                o = fn(q, k, v, mesh, causal=causal,
                       kv_valid=None if kv is None else jnp.asarray(kv))
                return (o ** 2).sum(), o

            (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
                *(jnp.asarray(a) for a in qkv))
            out[f"{name} {case}"] = [np.asarray(o), *(np.asarray(g) for g in grads)]
    return out


def _jax_fit(jm, boxed, batches, axes, method):
    mesh = _j_mesh(axes)
    state = jstate.TrainState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.copy, boxed),
                                     tx=jstate.make_optimizer("sgd", LR))
    with jattention.sequence_parallel(mesh, method=method):
        res = jloop.fit(state, j_make_translation_loss(jm, 0), batches, epochs=1,
                        rng=jax.random.key(0), mesh=mesh, log_every=0, emit=lambda s: None)
    return _flat(jax.tree.map(np.asarray, fnn.unbox(res.state.params))), res


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang's results and the JAX oracles, computed while it runs."""
    qkv, valid, models, batches = _inputs()
    trees = {moe: jax.tree.map(np.array, fnn.unbox(boxed)) for moe, (_, boxed) in models.items()}
    got: dict = {}

    def run():
        try:
            got["out"] = Distributor(num_processes=8, platform="cpu", timeout=600, env=GANG_ENV).run(
                "torch_launcher_workers:seq_compose_eight_rank", qkv, valid, MESHES, TINY,
                trees[False], TINY_MOE, trees[True], batches, LR,
                str(tmp_path_factory.mktemp("seq_compose")))
        except BaseException as e:  # noqa: BLE001 - re-raised in the main thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        oracle = {"attention": _jax_attention(qkv, valid),
                  "fit": {name: _jax_fit(*models[moe], batches, axes, method)
                          for name, (axes, method, moe) in MESHES.items()}}
    finally:
        thread.join()
    if "error" in got:
        raise got["error"]
    assert kill_stray_gangs() == 0
    return got["out"], oracle


# -- in process ------------------------------------------------------------------


@pytest.mark.parametrize("axes", [{"seq": 2, "model": 2, "data": 2}, {"model": 2, "seq": 4},
                                  {"expert": 2, "seq": 2, "model": 2},
                                  {"seq": 2, "expert": 2, "data": 2}])
def test_three_axis_meshes_lay_ranks_out_as_the_jax_mesh_lays_devices(axes):
    mesh = make_mesh(axes, world=8)
    j_mesh = _j_mesh(axes)
    assert tuple(mesh.shape) == tuple(j_mesh.axis_names)
    assert tuple(mesh.shape.values()) == tuple(j_mesh.devices.shape)
    ids = np.vectorize(lambda d: d.id)(j_mesh.devices)
    for rank in range(8):
        at = _coords(rank, mesh.shape)
        assert ids[tuple(at.values())] == rank
        for axis in mesh.shape:
            # The line of ``axis`` through ``rank``: every other
            # coordinate fixed, as the JAX mesh's devices along the axis.
            index = tuple(slice(None) if a == axis else i for a, i in at.items())
            assert _line_ranks(mesh.shape, axis, at) == list(ids[index])


def test_a_four_axis_mesh_gives_each_axis_its_lines():
    mesh = make_mesh({"model": 2, "seq": 2, "expert": 2, "data": 2}, world=16)
    assert tuple(mesh.shape) == ("data", "expert", "seq", "model")
    # rank = ((data · 2 + expert) · 2 + seq) · 2 + model
    at = _coords(13, mesh.shape)
    assert at == {"data": 1, "expert": 1, "seq": 0, "model": 1}
    lines = {axis: _line_ranks(mesh.shape, axis, at) for axis in mesh.shape}
    assert lines == {"data": [5, 13], "expert": [9, 13], "seq": [13, 15], "model": [12, 13]}
    # Every rank lies on exactly one line of each axis.
    for axis in mesh.shape:
        seen = sorted(r for line in {tuple(_line_ranks(mesh.shape, axis, _coords(q, mesh.shape)))
                                     for q in range(16)} for r in line)
        assert seen == list(range(16))


def test_pipeline_beside_seq_is_refused_in_the_jax_recipes_words():
    with pytest.raises(ValueError, match="composes with data parallelism only"):
        make_mesh({"pipeline": 2, "seq": 2}, world=4)
    from machine_learning_apache_spark_tpu.recipes.translation import (
        train_translator as j_train_translator,
    )

    kw = dict(epochs=1, synthetic_n=64, batch_size=8, max_len=16, log_every=0,
              pipeline_parallel=2, sequence_parallel=2)
    with pytest.raises(ValueError, match="composes with data parallelism only") as jerr:
        j_train_translator(**kw)
    with pytest.raises(ValueError, match="composes with data parallelism only") as err:
        train_translator(device="cpu", **kw)
    assert str(err.value) == str(jerr.value)


def test_zero1_step_on_a_seq_model_mesh_is_refused_as_in_jax():
    from machine_learning_apache_spark_tpu.parallel.zero import (
        _require_zero1_mesh as j_require_zero1_mesh,
    )
    from machine_learning_apache_spark_tpu_torch.parallel import zero

    axes = {"data": 2, "seq": 2, "model": 2}
    with pytest.raises(ValueError) as jerr:
        j_require_zero1_mesh(_j_mesh(axes), "data")
    with pytest.raises(ValueError) as err:
        zero._require_zero1_mesh(make_mesh(axes, world=8), "data")
    assert str(err.value) == str(jerr.value) and "'seq': 2" in str(err.value)


def test_recipe_checks_ulysses_heads_globally_as_jax_does():
    from machine_learning_apache_spark_tpu.recipes.translation import (
        train_translator as j_train_translator,
    )

    kw = dict(epochs=1, synthetic_n=64, batch_size=8, max_len=16, d_model=24, ffn_hidden=48,
              num_heads=6, log_every=0, sequence_parallel=4, model_parallel=2,
              sequence_parallel_method="ulysses")
    with pytest.raises(ValueError, match="ulysses") as jerr:
        j_train_translator(**kw)
    with pytest.raises(ValueError, match="ulysses") as err:
        train_translator(device="cpu", **kw)
    assert str(err.value) == str(jerr.value) and "(6)" in str(err.value)


def test_gang_report_shows_the_seq_model_and_expert_lines_of_one_mesh():
    from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

    events = [{"kind": "counter", "name": f"comms.{kind}_{what}", "rank": r, "value": v,
               "attrs": {"steps": 2}}
              for r in (0, 1) for kind in ("sp_ring", "tp_allreduce", "ep_allreduce")
              for what, v in (("calls", 12.0), ("bytes", 600.0), ("window_seconds", 0.01))]
    report = aggregate.comms_report(events)
    want = {r: {"calls_per_step": 6.0, "bytes_per_step": 300.0, "window_ms_per_step": 5.0}
            for r in (0, 1)}
    assert report["sequence"] == {"sp_ring": want}
    assert report["model"] == {"tp_allreduce": want}
    assert report["expert"] == {"ep_allreduce": want}
    md = aggregate.render_markdown({"ranks": [0, 1], "event_count": len(events), "phases": {},
                                    "skew": {}, "comms": report})
    for title in ("| seq line | rank | bytes/step |", "| model line | rank | calls/step |",
                  "| expert line | rank | calls/step |"):
        assert title in md
    assert "| tp_allreduce | 1 | 6.0 | 300.0 | 5.0 |" in md


# -- the gang --------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_attention_on_each_model_ranks_heads_equals_the_jax_mechanism(gang, case):
    out, oracle = gang
    want = oracle["attention"][case]
    name = next(m for m in MESHES if case.startswith(m + " "))
    axes, method, _ = MESHES[name]
    n, ways, m = axes["seq"], axes.get("data", 1), axes.get("model", 1)
    rows, heads = 4 // ways, 4 // m
    for rank in out["attention"]:
        got = rank[case]
        rs = slice(got["data"] * rows, (got["data"] + 1) * rows)
        hs = slice(got["model"] * heads, (got["model"] + 1) * heads)
        for what, g, w in zip(("out", "dq", "dk", "dv"), got["out"], want):
            np.testing.assert_allclose(g, w[rs, hs], rtol=0, atol=ATOL, err_msg=f"{case} {what}")
        assert got["line_equal"], case
        calls = got["calls"]
        if method == "ring":
            # n - 1 rotations forward; backward n - 1 of K/V and n of dK/dV.
            assert calls == {"sp_ring": (n - 1) + (n - 1) + n, "sp_a2a": 0, "sp_gather": 2}
        else:
            # q, kv and the output each way; kv_valid gathered once; the
            # model line's heads gathered once where a rank's do not
            # divide over the line. Never the ring.
            gathered = int(heads % n != 0)
            assert calls == {"sp_ring": 0, "sp_a2a": 6,
                             "sp_gather": 2 + ("valid" in case) + gathered}, case
    if "valid" in case:
        # The fully padded row (row 0) gives zeros.
        for rank in out["attention"]:
            if rank[case]["data"] == 0:
                assert np.all(rank[case]["out"][0][0] == 0.0)


@pytest.mark.parametrize("name", list(MESHES))
def test_fit_on_the_seq_axis_beside_model_and_expert_equals_the_jax_fit(gang, name):
    out, oracle = gang
    got = out["fit"][name]
    want, j_res = oracle["fit"][name]
    params = _flat(got["params"])
    assert params.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(params[path], w, rtol=0, atol=ATOL, err_msg=f"{name} {path}")
    np.testing.assert_allclose(np.mean(got["step_losses"]), j_res.final_loss, rtol=1e-5)
    assert got["in_sync"] == "ok" and got["line_equal"]
    axes, method, moe = MESHES[name]
    comms = got["comms"]
    # Three sites a step (encoder, decoder self, cross: both lengths 8).
    kind = "sp_ring" if method == "ring" else "sp_a2a"
    assert comms["sp_steps"] == 3 and comms[f"{kind}_calls"] > 0 and comms["sp_gather_bytes"] > 0
    if axes.get("model", 1) > 1:
        assert comms["tp_allreduce_steps"] == 3 and comms["tp_allreduce_calls"] > 0
    if moe and axes.get("expert", 1) > 1:
        assert comms["ep_allreduce_steps"] == 3 and comms["ep_allreduce_calls"] == 3 * 2 * 3


def test_resume_on_the_same_seq_model_mesh_is_bit_for_bit(gang):
    out, _ = gang
    res = out["resume"]
    assert res["same_bits"]
    assert res["step_losses"] == res["whole_losses"][3:]


def test_resume_on_another_layout_raises_topology_mismatch(gang):
    out, _ = gang
    crossed = out["crossed"]
    assert "different topology" in crossed, crossed
    assert "'seq': 2" in crossed and "'seq': 4" in crossed
