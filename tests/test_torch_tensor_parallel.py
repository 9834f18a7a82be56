"""Tensor parallelism of the port (``parallel.tensor_parallel``) against the
JAX package's ``parallel/tensor_parallel.py`` and its Flax models.

In process: the logical-axis mapping against the JAX function on the JAX
tests' cases, the slicing (shard → gather is the identity; a fused
``qkv``/``kv`` rank slice holds that rank's heads of q, k and v, as the
JAX model splits them), row-parallel partials summing to the full
``Dense``, the vocab-parallel loss and its gradient against the
full-logit loss and the JAX ``masked_token_cross_entropy`` (the ranks
simulated by threads over a barrier), and ``MLP(tp_rules=True)``
replicating a width the axis cannot divide, loudly.

Gangs over gloo (one worker call each, ``tests/torch_launcher_workers``):
2 ranks on ``{data: 1, model: 2}`` — the sharded Transformer's gradients
against Flax (each tensor within 10× a control run's difference: the
unsharded port model against Flax), 3 SGD steps of ``fit(mesh=)`` against
the JAX ``fit`` on a ``{data: 1, model: 2}`` mesh of the virtual CPU
devices (params atol 1e-5), the ``MLP(tp_rules=True)`` the same way,
1 + 1 epochs equal to 2 bit for bit, a crossed resume raising
``TopologyMismatch``, and ``train_translator(model_parallel=2)``, whose
gathered ``Translator`` decodes as the JAX ``Translator`` on the same
weights and as the one-process port recipe. The 4-rank hybrid ``data ×
model`` gang is in ``tests/test_torch_zero.py``.
"""

from __future__ import annotations

import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from machine_learning_apache_spark_tpu.data.text import translation_pipelines as j_pipelines
from machine_learning_apache_spark_tpu.inference import Translator as JTranslator
from machine_learning_apache_spark_tpu.models import MLP as JMLP
from machine_learning_apache_spark_tpu.models.transformer import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.parallel.mesh import make_mesh as j_make_mesh
from machine_learning_apache_spark_tpu.parallel.tensor_parallel import (
    logical_to_mesh_spec as j_logical_to_mesh_spec,
)
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu.train import losses as jlosses
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu.data.datasets import load_multi30k as j_load_multi30k
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.models import MLP
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Dense,
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel as tp
from machine_learning_apache_spark_tpu_torch.recipes.translation import (
    make_translation_loss,
    train_translator,
)
from machine_learning_apache_spark_tpu_torch.train import losses
from machine_learning_apache_spark_tpu_torch.weights import export_flax_params, load_flax_params
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

GANG_ENV = {"OMP_NUM_THREADS": "1"}
FIXTURES = "assets/fixtures"
# Odd target vocabulary: the TP recipe pads the LM head by one column.
TINY = dict(src_vocab_size=37, trg_vocab_size=41, d_model=16, ffn_hidden=32, num_heads=4,
            num_layers=1, max_len=12, dropout=0.0, logit_pad=1)
RECIPE = dict(data_root=FIXTURES, d_model=32, ffn_hidden=64, num_heads=2, max_len=24,
              epochs=1, batch_size=32, dropout=0.0, log_every=0, seed=3)
PROBE_TEXTS = ["a man is walking .", "two dogs play in the snow .", "a woman sings ."]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


# -- in process ----------------------------------------------------------------


@pytest.mark.parametrize(
    "axes,spec",
    [({"data": 2, "model": 4}, ("embed", "heads")),
     ({"data": 2, "model": 4}, ("mlp", "embed")),
     ({"data": 2, "model": 4}, ("mystery",)),
     ({"data": 8}, ("embed", "heads")),
     ({"data": 2, "model": 4}, (("batch", "seq"), "heads")),
     ({"data": 2, "model": 4}, ("embed", "vocab"))],
)
def test_logical_to_mesh_spec_equals_jax(axes, spec):
    want = j_logical_to_mesh_spec(P(*spec), j_make_mesh(axes))
    got = tp.logical_to_mesh_spec(spec, make_mesh(axes, world=8))
    # PartitionSpec writes a one-axis tuple entry as the axis itself.
    assert P(*got) == want


@pytest.mark.parametrize("parts,ways", [(1, 2), (1, 4), (2, 2), (3, 4)])
def test_shard_then_gather_is_the_identity(parts, ways):
    full = torch.randn(parts * 8, 6, generator=torch.Generator().manual_seed(parts))
    for dim in (0, 1):
        x = full if dim == 0 else full.T.contiguous()
        if x.shape[dim] % (parts * ways):
            continue
        pieces = [tp.shard_slice(x, dim, parts, i, ways) for i in range(ways)]
        assert all(p.shape[dim] == x.shape[dim] // ways for p in pieces)
        assert torch.equal(tp.unshard(pieces, dim, parts), x)


@pytest.mark.parametrize("ways", [2, 4])
def test_fused_qkv_and_kv_rank_slices_are_that_ranks_heads(ways):
    """Rank r's slice of the fused kernel projects exactly heads
    [r·H/M, (r+1)·H/M) of q, k and v as the JAX model splits them
    (``jnp.split`` into thirds/halves, then ``reshape(B, S, H, d_h)``)."""
    cfg = JConfig(**{**TINY, "num_heads": 4})
    h, dh, d = cfg.num_heads, cfg.d_model // cfg.num_heads, cfg.d_model
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    for parts, name in ((3, "qkv"), (2, "kv")):
        kernel = rng.standard_normal((d, parts * d)).astype(np.float32)
        bias = rng.standard_normal(parts * d).astype(np.float32)
        streams = jnp.split(jnp.asarray(x) @ kernel + bias, parts, axis=-1)
        heads = [np.asarray(t.reshape(2, 5, h, dh)) for t in streams]
        layer = Dense(d, parts * d, axes=("embed", "heads"), parts=parts)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(kernel.T))
            layer.bias.copy_(torch.from_numpy(bias))
        for r in range(ways):
            w = tp.shard_slice(layer.weight.detach(), 0, parts, r, ways)
            b = tp.shard_slice(layer.bias.detach(), 0, parts, r, ways)
            local = (torch.from_numpy(x) @ w.T + b).chunk(parts, dim=-1)
            for got, want in zip(local, heads):
                np.testing.assert_allclose(
                    got.reshape(2, 5, h // ways, dh).numpy(),
                    want[:, :, r * h // ways:(r + 1) * h // ways], rtol=0, atol=1e-5,
                    err_msg=f"{name} rank {r}",
                )


@pytest.mark.parametrize("ways", [2, 4])
def test_row_parallel_partials_sum_to_the_full_dense(ways):
    layer = Dense(16, 8)
    x = torch.randn(3, 7, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        layer.bias.normal_(generator=torch.Generator().manual_seed(2))
        want = layer(x)
        total = sum(
            tp.shard_slice(x, 2, 1, r, ways) @ tp.shard_slice(layer.weight, 1, 1, r, ways).T
            for r in range(ways)
        ) + layer.bias
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=0, atol=1e-6)


class _ThreadAxis:
    """A model axis of ``size`` threads: ``all_reduce_`` sums (or maxes)
    the threads' tensors at a barrier, as the collective would."""

    def __init__(self, size):
        self.size = size
        self.barrier = threading.Barrier(size)
        self.slots = [None] * size
        self.local = threading.local()

    def at(self, index):
        view = _ThreadAxisView(self, index)
        return view


class _ThreadAxisView:
    def __init__(self, shared, index):
        self.shared, self.index, self.size = shared, index, shared.size

    def all_reduce_(self, t, op="sum"):
        sh = self.shared
        sh.slots[self.index] = t.detach().clone()
        sh.barrier.wait()
        stacked = torch.stack(sh.slots)
        red = stacked.sum(0) if op == "sum" else stacked.max(0).values
        sh.barrier.wait()
        t.copy_(red)
        return t


@pytest.mark.parametrize("ways", [2, 4])
def test_vocab_parallel_loss_and_grad_equal_the_full_logit_loss_and_jax(ways):
    vocab, pad_id = 41, 0
    padded = vocab + (-vocab) % ways
    rng = np.random.default_rng(ways)
    logits = (rng.standard_normal((3, 9, padded)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 9))
    labels[0, 5:] = pad_id

    full = torch.tensor(logits[..., :vocab], requires_grad=True)
    want = losses.masked_token_cross_entropy(full, torch.from_numpy(labels), pad_id)
    want.backward()
    j_loss, j_grad = jax.value_and_grad(
        lambda z: jlosses.masked_token_cross_entropy(z, jnp.asarray(labels), pad_id)
    )(jnp.asarray(logits[..., :vocab]))

    axis = _ThreadAxis(ways)
    width = padded // ways
    got_loss = [None] * ways
    got_grad = [None] * ways

    def rank(r):
        local = torch.tensor(logits[..., r * width:(r + 1) * width], requires_grad=True)
        lab = torch.from_numpy(labels)
        loss = losses.masked_mean(losses.vocab_parallel_token_cross_entropy(
            local, lab, axis.at(r), r * width, vocab), lab, pad_id)
        loss.backward()
        got_loss[r], got_grad[r] = loss.detach(), local.grad

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(ways)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    grad = torch.cat(got_grad, dim=-1)
    for r in range(ways):
        assert float(got_loss[r]) == pytest.approx(want.item(), abs=1e-6)
        assert float(got_loss[r]) == pytest.approx(float(j_loss), abs=1e-6)
    assert torch.all(grad[..., vocab:] == 0)  # the logit_pad columns
    np.testing.assert_allclose(grad[..., :vocab].numpy(), full.grad.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(grad[..., :vocab].numpy(), np.asarray(j_grad), rtol=0, atol=1e-6)


def test_mlp_tp_rules_replicates_a_width_the_axis_cannot_divide_loudly(monkeypatch):
    warned = []
    monkeypatch.setattr(tp.log, "warning", lambda msg, *a: warned.append(msg % a))
    mesh = make_mesh({"data": 1, "model": 2}, world=2, device="cpu")
    model = tp.shard_params(MLP((4, 8, 5, 3), tp_rules=True), mesh)
    assert [getattr(getattr(model, f"dense_{i}").tp, "mode", None) for i in range(3)] == [
        "column", "row", None
    ]
    assert model.dense_0.weight.shape == (4, 4) and model.dense_1.weight.shape == (5, 4)
    assert model.dense_2.weight.shape == (3, 5)
    assert len(warned) == 1 and "dense_2/kernel dim 1 (size 3) does not divide" in warned[0]
    assert "replicating that dim" in warned[0]


def test_attention_heads_must_divide_the_model_axis():
    mesh = make_mesh({"data": 1, "model": 4}, world=4, device="cpu")
    with pytest.raises(ValueError, match="num_heads=2 does not divide over a 4-way"):
        tp.shard_params(Transformer(TransformerConfig(**{**TINY, "num_heads": 2})), mesh)


# -- the gangs -----------------------------------------------------------------


def _jax_tp_fit(model, boxed, loss_fn, batches, lr, axes):
    state = jstate.TrainState.create(
        apply_fn=model.apply, params=jax.tree.map(jnp.copy, boxed),
        tx=jstate.make_optimizer("sgd", lr),
    )
    mesh = j_make_mesh(axes, devices=jax.devices()[:np.prod(list(axes.values()))])
    res = jloop.fit(state, loss_fn, batches, epochs=1, rng=jax.random.key(0), mesh=mesh,
                    log_every=0, emit=lambda s: None)
    return _flat(jax.tree.map(np.asarray, fnn.unbox(res.state.params)))


def test_two_rank_tp_gang_equals_flax_and_the_jax_tp_fit(tmp_path):
    rng = np.random.default_rng(5)
    jm = JTransformer(JConfig(**TINY))
    src = rng.integers(1, TINY["src_vocab_size"], (4, 10))
    trg = rng.integers(1, TINY["trg_vocab_size"], (4, 9))
    src[1, 7:] = 0
    trg[2, 6:] = 0
    boxed = jax.jit(jm.init)(jax.random.key(2), src, trg[:, :-1])["params"]
    tree = jax.tree.map(np.array, fnn.unbox(boxed))
    batches = []
    for _ in range(3):
        s = rng.integers(1, TINY["src_vocab_size"], (4, 10))
        t = rng.integers(1, TINY["trg_vocab_size"], (4, 9))
        t[0, 5:] = 0
        batches.append((s, t))
    mlp_layers = (4, 8, 8, 4)
    jmlp = JMLP(layers=mlp_layers, tp_rules=True)
    mlp_boxed = jmlp.init(jax.random.key(0), jnp.ones((1, 4)))["params"]
    mlp_tree = jax.tree.map(np.array, fnn.unbox(mlp_boxed))
    mlp_batches = [(rng.standard_normal((8, 4)).astype(np.float32), rng.integers(0, 4, 8))
                   for _ in range(3)]
    lr = 0.5

    out = Distributor(num_processes=2, platform="cpu", timeout=600, env=GANG_ENV).run(
        "torch_launcher_workers:tp_two_rank", TINY, tree, (src, trg), batches, lr,
        mlp_layers, mlp_tree, mlp_batches, str(tmp_path), RECIPE, PROBE_TEXTS,
    )
    assert kill_stray_gangs() == 0
    assert out["mesh"] == {"data": 1, "model": 2} and out["heads_per_rank"] == 2
    # 5 forward all-reduces (encoder out/down, decoder self out/cross
    # out/down), 7 backward (encoder qkv/up, decoder qkv/q/kv/up, lm_head)
    # and 3 of the vocab-parallel loss.
    assert out["probe_tp_calls"] == 15

    # Gradients against Flax, each tensor held to 10x the control run's
    # difference (the unsharded port model against Flax).
    j_loss_fn = j_make_translation_loss(jm, 0, train=False)
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: j_loss_fn(p, (jnp.asarray(src), jnp.asarray(trg)), None), has_aux=True
    )(tree)
    control = load_flax_params(Transformer(TransformerConfig(**TINY)), tree)
    c_loss, _ = make_translation_loss(0, train=False)(control, (torch.as_tensor(src), torch.as_tensor(trg)), None)
    c_loss.backward()
    assert out["probe_loss"] == pytest.approx(float(j_loss), rel=1e-6)
    c_grads = _flat({k: v for k, v in export_flax_params(
        _grads_model(control, TransformerConfig(**TINY))).items()})
    for path, want in _flat(jax.tree.map(np.asarray, j_grads)).items():
        got = _flat(out["probe_grads"])[path]
        gate = max(10 * float(np.abs(c_grads[path] - want).max()), 1e-7)
        assert float(np.abs(got - want).max()) <= gate, path

    # 3 SGD steps of fit(mesh=) against the JAX TP fit: params atol 1e-5.
    want = _jax_tp_fit(jm, boxed, j_make_translation_loss(jm, 0), batches, lr,
                       {"data": 1, "model": 2})
    got = _flat(out["fit"]["params"])
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    assert out["fit"]["comms"]["tp_allreduce_steps"] == 3
    assert out["fit"]["comms"]["tp_allreduce_calls"] == 3 * 15
    want = _jax_tp_fit(jmlp, mlp_boxed, jloop.classification_loss(jmlp.apply), mlp_batches, lr,
                       {"data": 1, "model": 2})
    got = _flat(out["mlp"]["params"])
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0, atol=1e-5, err_msg=path)
    assert out["mlp"]["modes"] == ["column", "row", "column"]
    # {model: 2} without a data axis trains the same bits as {data: 1, model: 2}.
    assert out["mlp_model_only"]["step_losses"] == out["mlp"]["step_losses"]
    for path, w in _flat(out["mlp"]["params"]).items():
        np.testing.assert_array_equal(_flat(out["mlp_model_only"]["params"])[path], w, err_msg=path)
    first, again = out["tp_comms_per_fit"]
    assert again["tp_allreduce_steps"] == first["tp_allreduce_steps"] == 3
    assert again["tp_allreduce_calls"] == first["tp_allreduce_calls"] > 0

    # 1 + 1 epochs equal 2 bit for bit; a crossed mesh refuses to resume.
    res = out["resume"]
    assert res["params_equal"] and res["resumed_from"] == len(batches)
    assert res["losses"][0][len(batches):] == res["losses"][1]
    assert "written by a different topology" in out["crossed"]
    assert "'model': 2" in out["crossed"] and "train/reshard.py" in out["crossed"]

    # The recipe: gathered parameters are the shards concatenated; the
    # gathered Translator decodes as the JAX Translator on its weights
    # and as the one-process port recipe.
    rec = out["recipe"]
    assert rec["gathered_equal_concat"] and not rec["translator_sharded"]
    assert np.isfinite(rec["final_loss"])
    pairs = j_load_multi30k(FIXTURES, "train")
    src_j, trg_j = j_pipelines(pairs, max_len=RECIPE["max_len"])
    pad = (-len(trg_j.vocab.itos)) % 2
    assert rec["logit_pad"] == pad
    jcfg = JConfig(src_vocab_size=len(src_j.vocab.itos), trg_vocab_size=len(trg_j.vocab.itos),
                   d_model=32, ffn_hidden=64, num_heads=2, max_len=24, dropout=0.0, logit_pad=pad)
    jt = JTranslator(JTransformer(jcfg), rec["translator_params"], src_j, trg_j)
    assert jt(PROBE_TEXTS, max_new_tokens=8) == rec["tokens"]
    one = train_translator(device="cpu", _return_translator=True, _return_state=True, **RECIPE)
    np.testing.assert_allclose(rec["step_losses"], one["fit_result"].step_losses, rtol=1e-4)
    assert one["translator"](PROBE_TEXTS, max_new_tokens=8) == rec["tokens"]


def _grads_model(model, cfg):
    """A copy of ``model`` holding its gradients as parameters."""
    out = Transformer(cfg)
    out.load_state_dict({n: p.grad for n, p in model.named_parameters()})
    return out
