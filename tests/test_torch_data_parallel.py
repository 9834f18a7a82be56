"""The port's data parallelism (``parallel.{mesh,data_parallel}``,
``train.loop.fit/evaluate(mesh=)``) held against the JAX package on the
same inputs: ``params_fingerprint`` on carried weights,
``pad_batch_to_multiple``, then two 2-rank gloo gangs on the CPU —

- the MLP over 3 SGD steps of ``make_data_parallel_step`` against the JAX
  ``make_data_parallel_step`` on ``data_parallel_mesh(2)`` from the same
  weights and global batches (params atol 1e-5), the replicas' divergence
  (0, and a raise once rank 1 is perturbed) and each rank's own dropout
  draws;
- a tiny Transformer through ``fit(mesh=)`` (SGD, without and with
  accumulation) + ``evaluate(mesh=)`` against the JAX ``fit``/``evaluate``
  on ``data_parallel_mesh(2)``, on global batches whose two halves hold
  very different valid-token counts: each tensor's update is held to the
  JAX one's, a gate that a mean of the ranks' means fails (shown on the
  same data); dropout off, as every port parity test runs.

Each rank takes the contiguous half of every global batch that the JAX
mesh's data axis gives its device (``tests/torch_launcher_workers.py``).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.models import MLP as JMLP
from machine_learning_apache_spark_tpu.models.transformer import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.parallel import data_parallel as jdp
from machine_learning_apache_spark_tpu.parallel.mesh import (
    data_parallel_mesh as j_data_parallel_mesh,
)
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.models import MLP
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.parallel import (
    assert_replicas_in_sync,
    data_parallel_mesh,
    make_mesh,
    pad_batch_to_multiple,
    params_fingerprint,
)
from machine_learning_apache_spark_tpu_torch.weights import (
    load_flax_params,
    random_flax_like,
)
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

TINY = dict(
    src_vocab_size=41, trg_vocab_size=37, d_model=32, ffn_hidden=64,
    num_heads=2, num_layers=1, max_len=16, dropout=0.0,
)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if hasattr(v, "items") else {path: np.asarray(v)})
    return out


def _transformer_params(seed):
    jm = JTransformer(JConfig(**TINY))
    dummy = np.ones((2, 6), np.int32)
    params = fnn.unbox(jax.jit(jm.init)(jax.random.key(seed), dummy, dummy)["params"])
    return jm, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_params_fingerprint_equals_jax(model):
    if model == "mlp":
        tm = MLP((4, 5, 4, 3))
        tree = random_flax_like(tm, 3)
    else:
        _, tree = _transformer_params(3)
        tm = Transformer(TransformerConfig(**TINY))
    load_flax_params(tm, tree)
    want = jdp.params_fingerprint(jax.tree.map(jnp.asarray, tree))
    assert params_fingerprint(tm) == pytest.approx(want, rel=1e-6)
    # a TrainState fingerprints its model; one process is in sync with itself
    state = type("S", (), {"model": tm})()
    assert params_fingerprint(state) == params_fingerprint(tm)
    assert assert_replicas_in_sync(tm) == 0.0


@pytest.mark.parametrize("rows,multiple", [(5, 2), (8, 4), (7, 8), (1, 3)])
def test_pad_batch_to_multiple_equals_jax(rows, multiple):
    rng = np.random.default_rng(rows)
    batch = (rng.normal(size=(rows, 3)).astype(np.float32), np.arange(rows))
    got, n = pad_batch_to_multiple(batch, multiple)
    want, m = jdp.pad_batch_to_multiple(batch, multiple)
    assert n == m
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    tgot, tn = pad_batch_to_multiple(tuple(torch.as_tensor(a) for a in batch), multiple)
    assert tn == n
    for g, w in zip(tgot, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mesh_axes_beyond_data_raise_naming_their_item():
    assert make_mesh({"data": 2, "model": 1}, world=2).shape == {"data": 2, "model": 1}
    # The model axis is ported: ranks lie data-major, model innermost (the
    # JAX mesh's device order).
    mesh = make_mesh({"model": 2, "data": 2}, world=4)
    assert mesh.shape == {"data": 2, "model": 2} and mesh.coords == {"data": 0, "model": 0}
    # So is the seq axis, beside the data axis only.
    assert make_mesh({"seq": -1}, world=2).shape == {"seq": 2}
    # So is the pipeline axis, data-major too.
    mesh = make_mesh({"pipeline": 2, "data": 1}, world=2)
    assert mesh.shape == {"data": 1, "pipeline": 2} and mesh.axis_ranks("pipeline") == [0, 1]
    # Beside the pipeline axis the seq axis is refused in the JAX
    # recipe's words.
    with pytest.raises(ValueError, match="composes with data parallelism only"):
        make_mesh({"data": 1, "pipeline": 2, "seq": 2}, world=4)
    # So is the expert axis, data-major too.
    mesh = make_mesh({"expert": 2}, world=2)
    assert mesh.shape == {"expert": 2} and mesh.axis_ranks("expert") == [0, 1]
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        data_parallel_mesh(2)


def test_mlp_gang_step_equals_jax_data_parallel_step():
    frame = read_libsvm("assets/sample_multiclass_classification_data.txt")
    x, y = frame.arrays()
    batches = [(x[i:i + 16], y[i:i + 16]) for i in (0, 16, 32)]
    tree = random_flax_like(MLP((4, 5, 4, 3)), 11)
    lr = 0.5

    jm = JMLP(layers=(4, 5, 4, 3))
    j_state = jstate.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, tree),
        tx=jstate.make_optimizer("sgd", lr),
    )
    j_step = jdp.make_data_parallel_step(
        jloop.classification_loss(jm.apply), j_data_parallel_mesh(2)
    )
    j_losses = []
    for b in batches:
        j_state, loss, _ = j_step(j_state, b, jax.random.key(0))
        j_losses.append(float(loss))

    out = Distributor(num_processes=2, platform="cpu", timeout=180).run(
        "torch_launcher_workers:mlp_dp_steps", tree, (4, 5, 4, 3), batches, lr
    )
    assert kill_stray_gangs() == 0
    np.testing.assert_allclose(out["losses"], j_losses, rtol=1e-5)
    got, want = _flat(out["params"]), _flat(jax.tree.map(np.asarray, j_state.params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0, err_msg=k)
    assert out["divergence"] == 0.0
    assert out["perturbed_raises"]
    assert out["dropout_draws_differ"]
    assert out["grad_allreduce_steps"] == 3


def _uneven_batches(rng, n_batches, rows):
    """Global batches whose first half has long targets and second half
    short ones: the halves' valid-token counts differ about threefold."""
    out = []
    for _ in range(n_batches):
        src = rng.integers(4, TINY["src_vocab_size"], (rows, 12)).astype(np.int32)
        trg = rng.integers(4, TINY["trg_vocab_size"], (rows, 11)).astype(np.int32)
        lengths = np.concatenate([
            rng.integers(9, 12, rows // 2), rng.integers(2, 5, rows - rows // 2)
        ])
        for i, m in enumerate(lengths):
            trg[i, m:] = 0
            src[i, rng.integers(3, 13):] = 0
        out.append((src, trg))
    return out


# SGD is linear in the gradient, so each tensor's update θ - θ0 carries
# the gradient's weighting straight through: held per tensor to DP_RTOL of
# its largest JAX update coordinate plus DP_FLOOR, the float32 noise floor
# of a tensor whose true gradient is 0 (the attention key biases: softmax
# is invariant to a per-row constant), whose sound readings stay below
# 1e-8 here.
DP_RTOL = 1e-4
DP_FLOOR = 1e-7


def _update_errors(got, want, start) -> dict:
    """Per tensor: ``max|Δgot - Δwant| / (DP_RTOL·max|Δwant| + DP_FLOOR)``
    with ``Δ = θ - θ0`` (a value above 1 fails the gate)."""
    out = {}
    for k in want:
        d_want = want[k].astype(np.float64) - start[k]
        d_got = got[k].astype(np.float64) - start[k]
        limit = DP_RTOL * np.abs(d_want).max() + DP_FLOOR
        out[k] = float(np.abs(d_got - d_want).max() / limit)
    return out


def _jax_sgd_mean_of_means(jm, tree, batches, lr):
    """The SGD trajectory a gang would take by averaging its two ranks'
    own per-token means: each step's gradient is the mean of the halves'
    gradients."""
    loss = j_make_translation_loss(jm, 0, train=False)
    grad = jax.jit(jax.grad(lambda p, b: loss(p, b, None)[0]))
    params = jax.tree.map(jnp.asarray, tree)
    for b in batches:
        half = len(b[0]) // 2
        gs = [grad(params, tuple(a[h * half:(h + 1) * half] for a in b)) for h in (0, 1)]
        params = jax.tree.map(lambda p, g0, g1: p - lr * (g0 + g1) / 2, params, *gs)
    return jax.tree.map(np.asarray, params)


def test_mt_gang_fit_with_unequal_token_counts_equals_jax_fit():
    rng = np.random.default_rng(17)
    batches = _uneven_batches(rng, 4, 8)
    eval_batches = _uneven_batches(rng, 2, 6)
    jm, tree = _transformer_params(5)
    lr = 0.5
    start = _flat(tree)

    mesh = j_data_parallel_mesh(2)
    j_runs = {}
    for k in (1, 2):
        j_state = jstate.TrainState.create(
            apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, tree),
            tx=jstate.make_optimizer("sgd", lr, accumulate_steps=k),
        )
        j_runs[k] = jloop.fit(
            j_state, j_make_translation_loss(jm, 0), batches, epochs=1, mesh=mesh,
            log_every=1,
        )
    j_eval = jloop.evaluate(
        j_runs[1].state, j_make_translation_loss(jm, 0, train=False), eval_batches, mesh=mesh
    )
    # The JAX fit keeps only epoch means; its per-step losses are read by
    # evaluating each step's loss from the same start, step by step.
    j_state = jstate.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, tree),
        tx=jstate.make_optimizer("sgd", lr),
    )
    j_step = jloop.make_train_step(j_make_translation_loss(jm, 0))
    j_losses = []
    for b in batches:
        j_state, loss, _ = j_step(j_state, b, jax.random.key(0))
        j_losses.append(float(loss))

    out = Distributor(num_processes=2, platform="cpu", timeout=240).run(
        "torch_launcher_workers:mt_dp_fit", TINY, tree, batches, eval_batches, lr, (1, 2)
    )
    assert kill_stray_gangs() == 0
    run = out["runs"][1]
    np.testing.assert_allclose(run["step_losses"], j_losses, rtol=1e-4)
    for k in (1, 2):
        np.testing.assert_allclose(
            [h["loss"] for h in out["runs"][k]["history"]],
            [h["loss"] for h in j_runs[k].history], rtol=1e-4,
        )
        errors = _update_errors(
            _flat(out["runs"][k]["params"]),
            _flat(jax.tree.map(np.asarray, j_runs[k].state.params)), start,
        )
        worst = max(errors, key=errors.get)
        assert errors[worst] <= 1.0, (k, worst, errors[worst])
        # one gradient all-reduce per optimizer update
        assert out["runs"][k]["comms"]["allreduce_steps"] == len(batches) // k
    np.testing.assert_allclose(out["eval"]["test_loss"], j_eval["test_loss"], rtol=1e-5)
    # Rows are counted per process, as the JAX loop counts a gang's rows
    # (train/loop.py evaluate: n = len(local batch)); the one-process JAX
    # mesh holds both halves.
    assert out["eval"]["eval_samples"] * 2 == j_eval["eval_samples"] == 12

    # The gate discriminates: the trajectory of a mean of the two halves'
    # own means misses the JAX fit's by far more than it allows.
    wrong = _update_errors(
        _flat(_jax_sgd_mean_of_means(jm, tree, batches, lr)),
        _flat(jax.tree.map(np.asarray, j_runs[1].state.params)), start,
    )
    assert max(wrong.values()) > 100.0
