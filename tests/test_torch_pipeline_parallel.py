"""Pipeline parallelism of the port (``parallel.pipeline_parallel``,
``parallel.pipeline_transformer``, the recipe's ``pipeline_parallel``)
against the JAX package's ``parallel/pipeline_parallel.py``,
``parallel/pipeline_transformer.py`` and its pipelined ``fit`` on the
virtual CPU devices.

In process: the mesh's data-major layout, each ``ValueError`` of
``pipeline_apply`` and ``pipeline_transformer_logits`` beside the JAX
one on the same inputs, the recipe's against ``tests/test_recipes.py``'s,
and ZeRO-1's on a pipeline mesh.

Gangs over gloo (one worker call each, ``tests/torch_launcher_workers``):
2 ranks on ``{data: 1, pipeline: 2}`` — ``pipeline_apply`` of the JAX
tests' residual-MLP stage at (S, M) = (2, 2) and (2, 6), forward and
gradients against the JAX function, and at M = 3 with a per-example and
a per-microbatch aux; the pipelined Transformer's logits
and gradients against the JAX function and Flax's sequential apply, with
and without ``remat``; 3 SGD steps of ``fit`` against the JAX pipelined
``fit`` (params atol 1e-5); 4 steps per call and 1 + 1 epochs against 1
and 2 bit for bit; a crossed resume raising ``TopologyMismatch``;
``train_translator(pipeline_parallel=2)`` against the one-process
recipe. 4 ranks — (4, 4) and (4, 8) on ``{pipeline: 4}``, ``{data: 2,
pipeline: 2}`` with and without aux; 3 SGD steps of ``fit`` on the
residual MLP with its stage parameters stacked (``{pipeline: 4}``) and
listed per stage (``{data: 2, pipeline: 2}``) against SGD on the JAX
``pipeline_apply``'s gradients; and 3 SGD steps of the Transformer's
``fit`` on ``{data: 2, pipeline: 2}`` against the JAX ``fit`` there.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.models.transformer import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.parallel.mesh import make_mesh as j_make_mesh
from machine_learning_apache_spark_tpu.parallel.pipeline_parallel import (
    pipeline_apply as j_pipeline_apply,
)
from machine_learning_apache_spark_tpu.parallel.pipeline_transformer import (
    pipeline_transformer_logits as j_pipeline_transformer_logits,
)
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_pipeline_translation_loss as j_make_pipeline_translation_loss,
    train_translator as j_train_translator,
)
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.parallel import make_mesh, pipeline_apply, zero
from machine_learning_apache_spark_tpu_torch.parallel.pipeline_parallel import bubble_fraction
from machine_learning_apache_spark_tpu_torch.parallel.pipeline_transformer import (
    pipeline_transformer_logits,
)
from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator
from machine_learning_apache_spark_tpu_torch.train.loop import fit
from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
from machine_learning_apache_spark_tpu_torch.weights import export_flax_params, load_flax_params
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

GANG_ENV = {"OMP_NUM_THREADS": "1"}
FIXTURES = "assets/fixtures"
TINY = dict(src_vocab_size=37, trg_vocab_size=41, d_model=16, ffn_hidden=32, num_heads=4,
            num_layers=2, max_len=12, dropout=0.0)
RECIPE = dict(data_root=FIXTURES, d_model=32, ffn_hidden=64, num_heads=2, max_len=24, num_layers=2,
              epochs=1, batch_size=32, dropout=0.0, log_every=0, seed=3)
PROBE_TEXTS = ["a man is walking .", "two dogs play in the snow .", "a woman sings ."]
D = 6  # the residual-MLP width


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def _mlp_params(n_stages, seed):
    rng = np.random.default_rng(seed)
    return {"w": (0.3 * rng.standard_normal((n_stages, D, D))).astype(np.float32),
            "b": (0.1 * rng.standard_normal((n_stages, D))).astype(np.float32)}


def _j_stage(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def _j_aux_stage(p, h, aux_m, rep_m, stage_id, t):
    (s,) = aux_m
    out = h + jnp.tanh(h @ p["w"] + p["b"]) * s
    return out if rep_m is None else out + rep_m * (stage_id + 1)


def _j_mlp(params, x, axes, n_micro, scale=None, shift=None):
    """The JAX pipeline_apply's output and gradients of sum(out²) with
    respect to the stacked params and x."""
    mesh = j_make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])

    def f(p, x):
        if scale is None:
            out = j_pipeline_apply(_j_stage, p, x, mesh, n_micro=n_micro)
        else:
            out = j_pipeline_apply(_j_aux_stage, p, x, mesh, n_micro=n_micro,
                                   aux=(jnp.asarray(scale),),
                                   aux_replicated=None if shift is None else jnp.asarray(shift))
        return (out ** 2).sum(), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(out), {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)


def _j_mlp_sgd(params, batches, axes, n_micro, lr):
    """The stacked params after one SGD step on the mean of out² of the
    JAX pipeline_apply per batch."""
    mesh = j_make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    loss = lambda p, x: (j_pipeline_apply(_j_stage, p, x, mesh, n_micro=n_micro) ** 2).mean()  # noqa: E731
    grad = jax.jit(jax.grad(loss))
    p = jax.tree.map(jnp.asarray, params)
    for x in batches:
        p = jax.tree.map(lambda a, g: a - lr * g, p, grad(p, jnp.asarray(x)))
    return {k: np.asarray(v) for k, v in p.items()}


def _check_mlp(ranks, want_out, want_gp, want_gx, data_ways):
    """Each rank's output rows, its stage's gradients summed over the
    data replicas, and stage 0's input gradient (zero on later stages)
    against the JAX function's."""
    n = len(want_out) // data_ways
    sums: dict = {}
    for r in ranks:
        rows = slice(r["data"] * n, (r["data"] + 1) * n)
        np.testing.assert_allclose(r["out"], want_out[rows], rtol=0, atol=1e-5)
        want = want_gx[rows] if r["stage"] == 0 else np.zeros_like(want_gx[rows])
        np.testing.assert_allclose(r["gx"], want, rtol=0, atol=1e-5)
        assert r["other_stages_zero"]
        acc = sums.setdefault(r["stage"], [0.0, 0.0])
        acc[0] = acc[0] + r["gw"]
        acc[1] = acc[1] + r["gb"]
    for s, (gw, gb) in sums.items():
        np.testing.assert_allclose(gw, want_gp["w"][s], rtol=0, atol=1e-5)
        np.testing.assert_allclose(gb, want_gp["b"][s], rtol=0, atol=1e-5)


# -- in process ----------------------------------------------------------------


def test_data_pipeline_mesh_lays_ranks_out_data_major():
    mesh = make_mesh({"pipeline": 2, "data": 2}, world=4)
    assert mesh.shape == {"data": 2, "pipeline": 2}
    assert mesh.axis_ranks("pipeline") == [0, 1] and mesh.axis_ranks("data") == [0, 2]
    assert make_mesh({"pipeline": -1}, world=4).shape == {"pipeline": 4}
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(2, 8) == pytest.approx(1 / 9)


@pytest.mark.parametrize("case", ["not divisible", "stages", "extra nontrivial axes", "empty"])
def test_pipeline_apply_raises_the_jax_value_errors(case):
    axes = {"pipeline": 4, "model": 2} if case == "extra nontrivial axes" else {"pipeline": 4}
    n = int(np.prod(list(axes.values())))
    stages = 3 if case == "stages" else 4
    params = {} if case == "empty" else _mlp_params(stages, 0)
    x = np.ones((10 if case == "not divisible" else 8, D), np.float32)
    match = "stage_params is empty" if case == "empty" else case
    with pytest.raises(ValueError, match=match) as jerr:
        j_pipeline_apply(_j_stage, jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                         j_make_mesh(axes, devices=jax.devices()[:n]))
    with pytest.raises(ValueError, match=match) as err:
        pipeline_apply(lambda p, h: h, {k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x), make_mesh(axes, world=n, device="cpu"))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["moe", "layers"])
def test_pipeline_transformer_raises_the_jax_value_errors(case):
    kw = dict(TINY, num_layers=4)
    if case == "moe":
        kw["moe_experts"] = 2
    axes = {"pipeline": 2 if case == "moe" else 3}
    n = axes["pipeline"]
    src = np.ones((4, 6), np.int32)
    trg = np.ones((4, 5), np.int32)
    jm = JTransformer(JConfig(**kw))
    params = {}  # both functions refuse before they read a parameter
    match = "does not support MoE" if case == "moe" else "pipeline stages"
    with pytest.raises(ValueError, match=match) as jerr:
        j_pipeline_transformer_logits(jm, params, src, trg, j_make_mesh(axes, devices=jax.devices()[:n]))
    with pytest.raises(ValueError, match=match) as err:
        pipeline_transformer_logits(Transformer(TransformerConfig(**kw)), torch.as_tensor(src),
                                    torch.as_tensor(trg), make_mesh(axes, world=n, device="cpu"))
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("kw,match", [
    (dict(num_layers=3, pipeline_parallel=4), "pipeline stages"),
    (dict(num_layers=4, pipeline_parallel=2, model_parallel=2), "data parallelism only"),
])
def test_recipe_raises_the_jax_recipe_value_errors(kw, match):
    common = dict(epochs=1, synthetic_n=64, batch_size=8, max_len=16, d_model=32, ffn_hidden=64,
                  num_heads=4, log_every=0)
    with pytest.raises(ValueError, match=match) as jerr:
        j_train_translator(**common, **kw)
    with pytest.raises(ValueError, match=match) as err:
        train_translator(device="cpu", **common, **kw)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("kw,match", [
    (dict(pipeline_parallel=2, moe_experts=2), "data parallelism only"),
    (dict(pipeline_parallel=2, bucket_by_length=True), "bucket_by_length"),
    (dict(pipeline_parallel=2, pack_sequences=True), "pack_sequences is incompatible"),
])
def test_recipe_refuses_what_the_jax_recipe_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        train_translator(device="cpu", synthetic_n=64, num_layers=2, **kw)


def test_zero1_refuses_a_pipeline_mesh():
    mesh = make_mesh({"data": 2, "pipeline": 2}, world=4, device="cpu")
    state = TrainState.create(model=Transformer(TransformerConfig(**TINY)), tx=make_optimizer("adam"))
    with pytest.raises(ValueError, match="extra >1 axes {'pipeline': 2}"):
        fit(state, lambda m, b, r: None, [], epochs=1, mesh=mesh, dp_mode="zero1")
    with pytest.raises(ValueError, match="Pipeline/sequence/expert axes restructure the step"):
        zero.shard_optimizer_state(state, mesh, zero.Zero1Config())
    # The implicit form waits for stage-local state (ROADMAP queue A).
    with pytest.raises(NotImplementedError, match="stage-local parameters and moments"):
        fit(state, lambda m, b, r: None, [], epochs=1, mesh=mesh, zero1=True)


# -- the gangs -----------------------------------------------------------------


def _tiny_setup(seed=5):
    rng = np.random.default_rng(seed)
    jm = JTransformer(JConfig(**TINY))
    src = rng.integers(1, TINY["src_vocab_size"], (8, 10))
    trg = rng.integers(1, TINY["trg_vocab_size"], (8, 9))
    src[1, 7:] = 0
    trg[2, 6:] = 0
    boxed = jax.jit(jm.init)(jax.random.key(2), src, trg[:, :-1])["params"]
    batches = []
    for _ in range(4):
        s = rng.integers(1, TINY["src_vocab_size"], (8, 10))
        t = rng.integers(1, TINY["trg_vocab_size"], (8, 9))
        t[0, 5:] = 0
        s[3, 6:] = 0
        batches.append((s, t))
    return jm, boxed, jax.tree.map(np.array, fnn.unbox(boxed)), (src, trg[:, :-1]), batches


def _jax_pipeline_fit(jm, boxed, batches, lr, axes, n_micro):
    mesh = j_make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    state = jstate.TrainState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.copy, boxed),
                                     tx=jstate.make_optimizer("sgd", lr))
    res = jloop.fit(state, j_make_pipeline_translation_loss(jm, 0, mesh, n_micro=n_micro), batches,
                    epochs=1, rng=jax.random.key(0), mesh=mesh, log_every=0, emit=lambda s: None)
    return _flat(jax.tree.map(np.asarray, fnn.unbox(res.state.params))), res


def _grads_tree(model):
    """A copy of ``model`` holding its gradients as parameters, as a Flax tree."""
    out = Transformer(model.cfg)
    out.load_state_dict({n: p.grad for n, p in model.named_parameters()})
    return _flat(export_flax_params(out))


def test_two_rank_pipeline_gang_equals_the_jax_pipeline(tmp_path):
    jm, boxed, tree, probe, batches = _tiny_setup()
    mlp_params = _mlp_params(2, 1)
    rng = np.random.default_rng(2)
    mlp_x = rng.standard_normal((24, D)).astype(np.float32)
    # A per-example scale and a per-microbatch shift (aux_replicated, M = 3).
    mlp_aux = ((rng.random((24, 1)) + 0.5).astype(np.float32),
               (0.1 * rng.standard_normal((3, D))).astype(np.float32))
    lr = 0.5
    out = Distributor(num_processes=2, platform="cpu", timeout=600, env=GANG_ENV).run(
        "torch_launcher_workers:pp_two_rank", mlp_params, mlp_x, mlp_aux, TINY, tree, probe, batches, lr,
        str(tmp_path), RECIPE, PROBE_TEXTS,
    )
    assert kill_stray_gangs() == 0
    assert out["mesh"] == {"data": 1, "pipeline": 2}

    # pipeline_apply at (S, M) = (2, 2), (2, 6): forward and gradients.
    for m in (2, 6):
        _check_mlp([r[m] for r in out["mlp"]], *_j_mlp(mlp_params, mlp_x, {"pipeline": 2}, m), 1)
    _check_mlp([r["aux"] for r in out["mlp"]],
               *_j_mlp(mlp_params, mlp_x, {"pipeline": 2}, 3, *mlp_aux), 1)

    # The pipelined Transformer against the JAX function and Flax's
    # sequential apply; each gradient tensor within 10x the control run's
    # difference (the port's sequential model against Flax).
    src, trg_in = probe
    j_mesh = j_make_mesh({"data": 1, "pipeline": 2}, devices=jax.devices()[:2])
    seq = lambda p: (jm.apply({"params": p}, src, trg_in, deterministic=True) ** 2).mean()  # noqa: E731
    j_seq_grads = _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(seq))(tree)))
    control = load_flax_params(Transformer(TransformerConfig(**TINY)), tree)
    (control(torch.as_tensor(src), torch.as_tensor(trg_in)) ** 2).mean().backward()
    c_grads = _grads_tree(control)
    for remat in (False, True):
        jr = JTransformer(JConfig(**{**TINY, "remat": remat}))
        pipelined = lambda p: j_pipeline_transformer_logits(jr, p, src, trg_in, j_mesh)  # noqa: E731
        j_logits = np.asarray(jax.jit(pipelined)(tree))
        got = out["logits"][remat]
        np.testing.assert_allclose(got["logits"], j_logits, rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            got["logits"], np.asarray(jm.apply({"params": tree}, src, trg_in, deterministic=True)), rtol=0, atol=1e-5)
        j_pp_grads = _flat(jax.tree.map(np.asarray, jax.jit(jax.grad(
            lambda p: (pipelined(p) ** 2).mean()))(tree)))
        g = _flat(got["grads"])
        for path, want in j_pp_grads.items():
            gate = max(10 * float(np.abs(c_grads[path] - j_seq_grads[path]).max()), 1e-7)
            assert float(np.abs(g[path] - want).max()) <= gate, (remat, path)

    # 3 SGD steps of fit(mesh=) against the JAX pipelined fit: params atol 1e-5.
    want, _ = _jax_pipeline_fit(jm, boxed, batches[:3], lr, {"data": 1, "pipeline": 2}, 2)
    got = _flat(out["fit"]["params"])
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    assert out["fit"]["ranks_equal"]
    comms = out["fit"]["comms"]
    # Per step, stage 0: the encoder ring's and the decoder ring's two
    # microbatches sent forward and their cotangents received back, one
    # output broadcast per ring, the memory's cotangent summed once.
    assert comms["pp_steps"] == comms["allreduce_steps"] == 3
    assert comms["pp_send_calls"] == comms["pp_recv_calls"] == 3 * 2 * 2
    assert comms["pp_bcast_calls"] == 3 * 2 and comms["pp_allreduce_calls"] == 3
    assert comms["pp_bcast_bytes"] == 3 * 8 * (10 + 8) * TINY["d_model"] * 4

    # K steps per call and 1 + 1 epochs against 2, bit for bit; a crossed
    # mesh refuses to resume.
    assert out["k_steps"] == {"losses_equal": True, "params_equal": True}
    res = out["resume"]
    assert res["params_equal"] and res["losses_equal"] and res["ranks_equal"]
    assert res["resumed_from"] == res["first_steps"] == len(batches)
    assert "written by a different topology" in out["crossed"]
    assert "'pipeline': 2" in out["crossed"] and "train/reshard.py" in out["crossed"]

    # The recipe: its Translator is the replicated model, and it trains
    # and decodes as the one-process recipe.
    rec = out["recipe"]
    assert rec["mesh"] == {"data": 1, "pipeline": 2} and rec["translator_is_model"]
    assert rec["comms"]["pp_steps"] == len(rec["step_losses"])
    one = train_translator(device="cpu", _return_translator=True, _return_state=True, **RECIPE)
    np.testing.assert_allclose(rec["step_losses"], one["fit_result"].step_losses, rtol=1e-4)
    assert one["translator"](PROBE_TEXTS, max_new_tokens=8) == rec["tokens"]


def test_four_rank_pipeline_gang_equals_the_jax_pipeline():
    jm, boxed, tree, _, batches = _tiny_setup(7)
    params4, params2 = _mlp_params(4, 3), _mlp_params(2, 4)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((24, D)).astype(np.float32)
    scale = (rng.random((24, 1)) + 0.5).astype(np.float32)
    mlp_batches = rng.standard_normal((3, 16, D)).astype(np.float32)
    lr = 0.5
    out = Distributor(num_processes=4, platform="cpu", timeout=600, env=GANG_ENV).run(
        "torch_launcher_workers:pp_four_rank", params4, params2, x, scale, TINY, tree, batches[:3], lr,
        mlp_batches,
    )
    assert kill_stray_gangs() == 0
    assert out["coords"] == [{"data": d, "pipeline": s} for d in (0, 1) for s in (0, 1)]
    for m in (4, 8):
        _check_mlp([r[f"pipeline4 M{m}"] for r in out["mlp"]],
                   *_j_mlp(params4, x, {"pipeline": 4}, m), 1)
    hybrid = {"data": 2, "pipeline": 2}
    _check_mlp([r["data2 pipeline2 M2"] for r in out["mlp"]], *_j_mlp(params2, x, hybrid, 2), 2)
    _check_mlp([r["data2 pipeline2 aux"] for r in out["mlp"]],
               *_j_mlp(params2, x, hybrid, 2, scale=scale), 2)

    # fit(mesh=) on stage parameters given stacked and listed per stage:
    # every stage trains as the JAX pipeline's SGD steps say (params atol
    # 1e-5), not only stage 0.
    for form, p, axes, m in (("stacked", params4, {"pipeline": 4}, 4), ("listed", params2, hybrid, 2)):
        fitted = out["mlp_fit"][form]
        assert fitted["ranks_equal"] and fitted["steps"] == len(mlp_batches), form
        want = _j_mlp_sgd(p, mlp_batches, axes, m, lr)
        for k in ("w", "b"):
            np.testing.assert_allclose(fitted["params"][k], want[k], rtol=0, atol=1e-5, err_msg=f"{form} {k}")

    want, _ = _jax_pipeline_fit(jm, boxed, batches[:3], lr, hybrid, 2)
    got = _flat(out["fit"]["params"])
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    assert out["fit"]["ranks_equal"]
    assert out["fit"]["comms"]["allreduce_steps"] == 3


def test_gang_report_rolls_up_the_pipeline_hops():
    from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

    events = [{"kind": "counter", "name": f"comms.pp_send_{what}", "rank": r, "value": v,
               "attrs": {"steps": 4}}
              for r in (0, 1) for what, v in (("bytes", 4000.0 * (r + 1)), ("window_seconds", 0.02))]
    events.append({"kind": "counter", "name": "comms.bytes_allreduced", "rank": 0, "value": 8.0,
                   "attrs": {"steps": 1}})
    hops = aggregate.comms_report(events)["pipeline"]
    assert hops == {"pp_send": {0: {"bytes_per_step": 1000.0, "window_ms_per_step": 5.0},
                                1: {"bytes_per_step": 2000.0, "window_ms_per_step": 5.0}}}
    assert "pipeline" not in aggregate.comms_report(events[-1:])
    md = aggregate.render_markdown({"ranks": [0, 1], "event_count": len(events), "phases": {},
                                    "skew": {}, "comms": aggregate.comms_report(events)})
    assert "| pp_send | 1 | 2000.0 | 5.0 |" in md
