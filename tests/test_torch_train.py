"""The port's training slice against the JAX package's, on the CPU.

Pieces first — dropout's explicit generator, the lr schedules, the
optimizer chain (clipping, accumulation) against optax, the masked loss,
the loader's batch order, the Multi30k fixture's vocabularies and ids,
BLEU — then the model's gradients against ``jax.value_and_grad`` with
bridged weights, a 2-epoch ``fit`` + ``evaluate`` trajectory against the
JAX ``fit`` + ``evaluate`` from the same weights and batches, and the
recipe end to end. Inputs come from numpy seeds and cross as numpy arrays;
dropout is off wherever the two packages are compared (their random bits
differ by design). Each tolerance is stated where it is used.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from machine_learning_apache_spark_tpu.data import loader as jloader
from machine_learning_apache_spark_tpu.data.datasets import (
    load_multi30k as j_load_multi30k,
)
from machine_learning_apache_spark_tpu.data.text import (
    translation_pipelines as j_translation_pipelines,
)
from machine_learning_apache_spark_tpu.models import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.recipes import _common as jcommon
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import losses as jlosses
from machine_learning_apache_spark_tpu.train import metrics as jmetrics
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.data import loader as tloader
from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
from machine_learning_apache_spark_tpu_torch.data.text import translation_pipelines
from machine_learning_apache_spark_tpu_torch.models import (
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.models.transformer import Dropout
from machine_learning_apache_spark_tpu_torch.recipes import translation as trecipe
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import losses as tlosses
from machine_learning_apache_spark_tpu_torch.train import metrics as tmetrics
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.weights import (
    export_flax_params,
    load_flax_params,
)
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

FIXTURES = "assets/fixtures"
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


# -- dropout -------------------------------------------------------------------


def test_dropout_masks_follow_the_generator_and_keep_one_minus_rate():
    drop = Dropout(0.1)
    x = torch.ones(1_000_000)

    def run(seed):
        return drop(x, torch.Generator().manual_seed(seed))

    a, b, c = run(5), run(5), run(6)
    assert torch.equal(a, b)  # same seed, same mask
    assert not torch.equal(a, c)  # another seed, another mask
    keep = (a != 0).double().mean().item()
    assert abs(keep - 0.9) < 0.01 * 0.9  # within 1 % of 1 - rate
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))
    assert torch.equal(drop(x, None), x)  # no generator: identity (eval)
    state = torch.random.get_rng_state()
    run(7)
    assert torch.equal(torch.random.get_rng_state(), state)  # global RNG untouched


def test_fit_dropout_is_reproducible_from_the_seed():
    """Two fits from the same weights and seed train identically with
    dropout on; another seed trains differently."""
    rng = np.random.default_rng(40)
    src, trg = _tokens(rng, 16, 10, 41), _tokens(rng, 16, 9, 37)
    base = Transformer(TransformerConfig(**{**TINY, "dropout": 0.3}))
    losses = []
    for seed in (1, 1, 2):
        state = tstate.TrainState.create(
            model=copy.deepcopy(base), tx=tstate.make_optimizer("adam", 1e-3)
        )
        loader = tloader.DataLoader(tloader.ArrayDataset(src, trg), 4, shuffle=True)
        res = tloop.fit(
            state, trecipe.make_translation_loss(0), loader, epochs=1,
            rng=torch.Generator().manual_seed(seed), log_every=0,
        )
        losses.append(res.final_loss)
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]


# -- optimizer side against optax ------------------------------------------------


@pytest.mark.parametrize(
    "schedule,kw",
    [
        ("constant", dict(warmup_steps=4)),
        ("cosine", dict(total_steps=12)),
        ("cosine", dict(total_steps=12, end_value=1e-4)),
        ("warmup_cosine", dict(warmup_steps=3, total_steps=12, end_value=1e-5)),
    ],
    ids=["linear_warmup", "cosine", "cosine_end_value", "warmup_cosine"],
)
def test_schedules_match_optax(schedule, kw):
    want = jstate.make_schedule(1e-3, schedule, **kw)
    got = tstate.make_schedule(1e-3, schedule, **kw)
    for count in range(0, 16):
        assert abs(got(count) - float(want(count))) < 1e-7, count


class _Params(nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(tree["w"].copy()))
        self.b = nn.Parameter(torch.from_numpy(tree["b"].copy()))


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("chain", ["plain", "clip+accum3", "warmup_cosine+clip"])
@pytest.mark.parametrize("name", ["sgd", "adam", "adamw"])
def test_optimizer_chain_matches_optax(name, chain, steps):
    """The same gradients through the port's chain and optax's give the
    same parameters, atol 1e-6 (fp32; the clip norm sums in another
    order). At lr 1e-2: optax computes Adam's bias correction 1 - b2^t in
    float32 (relative error 1.3e-5 at t = 1) where torch uses a double, so
    the two updates differ by that share of the lr."""
    rng = np.random.default_rng(41)
    tree = {
        "b": rng.standard_normal(4).astype(np.float32),
        "w": rng.standard_normal((3, 4)).astype(np.float32),
    }
    kw = dict(
        plain={},
        **{"clip+accum3": dict(grad_clip=1.0, accumulate_steps=3)},
        **{"warmup_cosine+clip": dict(
            schedule="warmup_cosine", warmup_steps=2, total_steps=5, grad_clip=2.0,
        )},
    )[chain]
    extra = dict(momentum=0.9) if name == "sgd" else {}
    tx = jstate.make_optimizer(name, 1e-2, **kw, **extra)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(params)
    module = _Params(tree)
    state = tstate.TrainState.create(
        model=module, tx=tstate.make_optimizer(name, 1e-2, **kw, **extra)
    )
    for _ in range(steps):
        grads = {k: (rng.standard_normal(v.shape) * 0.8).astype(np.float32) for k, v in tree.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, params)
        params = optax.apply_updates(params, updates)
        module.w.grad = torch.from_numpy(grads["w"])
        module.b.grad = torch.from_numpy(grads["b"])
        state.apply_gradients()
    assert state.step == steps
    for k in ("w", "b"):
        np.testing.assert_allclose(
            getattr(module, k).detach().numpy(), np.asarray(params[k]), atol=1e-6, rtol=0
        )


def test_masked_token_cross_entropy_matches_jax():
    rng = np.random.default_rng(42)
    logits = (rng.standard_normal((3, 7, 11)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, 4:] = 0
    labels[2] = 0  # a row of pads only
    want = jlosses.masked_token_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 0)
    got = tlosses.masked_token_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), 0)
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    got_ce = tlosses.cross_entropy(torch.from_numpy(logits[0]), torch.from_numpy(labels[0]))
    want_ce = jlosses.cross_entropy(jnp.asarray(logits[0]), jnp.asarray(labels[0]))
    np.testing.assert_allclose(got_ce.item(), float(want_ce), atol=1e-6, rtol=0)
    allpad = tlosses.masked_token_cross_entropy(
        torch.from_numpy(logits[2:]), torch.from_numpy(labels[2:]), 0
    )
    assert allpad.item() == 0.0  # max(sum(mask), 1): no division by zero


# -- data side -------------------------------------------------------------------


@pytest.mark.parametrize("drop_last,shuffle", [(True, True), (False, False)])
def test_loader_batches_match_jax_loader(drop_last, shuffle):
    rng = np.random.default_rng(43)
    arrays = (rng.integers(0, 50, (37, 5)).astype(np.int32), np.arange(37))
    j = jloader.DataLoader(jloader.ArrayDataset(*arrays), 8, shuffle=shuffle, drop_last=drop_last, seed=3)
    t = tloader.DataLoader(tloader.ArrayDataset(*arrays), 8, shuffle=shuffle, drop_last=drop_last, seed=3, prefetch=2)
    assert len(j) == len(t)
    for epoch in (0, 1):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb)
        for x, y in zip(jb, tb):
            for a, b in zip(x, y):
                np.testing.assert_array_equal(np.asarray(a), b)


def test_multi30k_fixture_vocabs_and_ids_match_jax():
    pairs, j_pairs = load_multi30k(FIXTURES, "train"), j_load_multi30k(FIXTURES, "train")
    assert pairs == j_pairs and len(pairs) == 400
    valid = load_multi30k(FIXTURES, "valid")
    assert valid == j_load_multi30k(FIXTURES, "valid")
    t_src, t_trg = translation_pipelines(pairs, max_len=24)
    j_src, j_trg = j_translation_pipelines(j_pairs, max_len=24)
    assert len(t_src.vocab) == len(j_src.vocab) and len(t_trg.vocab) == len(j_trg.vocab)
    for split in (pairs, valid):
        for t, j, side in ((t_src, j_src, 0), (t_trg, j_trg, 1)):
            texts = [p[side] for p in split]
            np.testing.assert_array_equal(t(texts), np.asarray(j(texts)))


def test_bleu_and_strip_special_ids_match_jax():
    rng = np.random.default_rng(44)
    ids = rng.integers(3, 12, (6, 10))
    ids[:, 0] = 1
    ids[1, 4] = 2
    ids[2, 7:] = 0
    ids[3, 2] = 2
    refs = rng.integers(3, 12, (6, 9))
    refs[:, 0] = 1
    refs[0, 5:] = [2, 0, 0, 0]
    got_c = tmetrics.strip_special_ids(torch.from_numpy(ids))
    want_c = jmetrics.strip_special_ids(ids)
    assert got_c == want_c
    got_r, want_r = tmetrics.strip_special_ids(refs), jmetrics.strip_special_ids(refs)
    assert got_r == want_r
    for smooth in (True, False):
        assert tmetrics.corpus_bleu(got_c, got_r, smooth=smooth) == jmetrics.corpus_bleu(
            want_c, want_r, smooth=smooth
        )
    assert tmetrics.corpus_bleu(got_r, got_r) == pytest.approx(1.0)


# -- model gradients and the trajectory ----------------------------------------------


def _tokens(rng, n, length, vocab):
    toks = rng.integers(4, vocab, (n, length)).astype(np.int32)
    lengths = rng.integers(2, length + 1, n)
    for i, m in enumerate(lengths):
        toks[i, m:] = 0
    return toks


def _bridge(seed=0):
    jm = JTransformer(JConfig(**TINY))
    dummy = np.ones((2, 6), np.int32)
    params = fnn.unbox(jax.jit(jm.init)(jax.random.key(seed), dummy, dummy)["params"])
    params = jax.tree.map(np.asarray, params)
    tm = load_flax_params(Transformer(TransformerConfig(**TINY)), params)
    return jm, params, tm


def test_model_grads_match_jax_value_and_grad():
    """``loss.backward()`` through the port's model (flash ``Function``
    with the plain backward on the CPU) against ``jax.value_and_grad`` of
    the JAX recipe's loss, compared in the Flax layout through
    ``export_flax_params``: atol 1e-5 of the largest gradient."""
    jm, params, tm = _bridge()
    rng = np.random.default_rng(45)
    src, trg = _tokens(rng, 4, 12, TINY["src_vocab_size"]), _tokens(rng, 4, 11, TINY["trg_vocab_size"])
    j_loss = j_make_translation_loss(jm, 0)
    (want_loss, _), want = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        params, (jnp.asarray(src), jnp.asarray(trg)), jax.random.key(0)
    )
    loss, _ = trecipe.make_translation_loss(0)(
        tm, tloop.to_device((src, trg), torch.device("cpu")), None
    )
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    holder = copy.deepcopy(tm)
    with torch.no_grad():
        for p, q in zip(holder.parameters(), tm.parameters()):
            p.copy_(q.grad)
    got, want = _flat(export_flax_params(holder)), _flat(jax.tree.map(np.asarray, want))
    assert got.keys() == want.keys()
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5 * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("name,lr,params_atol", [("sgd", 0.5, 1e-4), ("adam", 1e-3, 5e-3)])
def test_fit_and_evaluate_trajectory_match_jax(name, lr, params_atol):
    """2 epochs of 8 steps from the same bridged weights and the same
    batches, dropout 0: epoch losses rtol 1e-4, test_loss rtol 1e-4,
    eval_samples identical (the eval set's ragged tail of 4 rows counts as
    4), final params atol 1e-4 under SGD.

    Under Adam the final params are held to 5e-3 (5 lr) instead: Adam
    scales every coordinate's step to about lr whatever its gradient's
    size, and some gradients sit at float-noise level — the key biases'
    exactly (softmax is invariant to a per-row constant, so their true
    gradient is zero), rarely active units' nearly. Such a coordinate steps
    by ±lr with the sign of the noise, which differs between two
    frameworks' summation orders (measured: up to 1.7e-3 after 16 steps,
    while the losses agree to 2e-5)."""
    jm, params, tm = _bridge(seed=1)
    rng = np.random.default_rng(46)
    src, trg = _tokens(rng, 64, 12, TINY["src_vocab_size"]), _tokens(rng, 64, 11, TINY["trg_vocab_size"])
    v_src, v_trg = _tokens(rng, 20, 12, TINY["src_vocab_size"]), _tokens(rng, 20, 11, TINY["trg_vocab_size"])

    j_state = jstate.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, params),
        tx=jstate.make_optimizer(name, lr),
    )
    j_res = jloop.fit(
        j_state, j_make_translation_loss(jm, 0),
        jloader.DataLoader(jloader.ArrayDataset(src, trg), 8, shuffle=True, seed=2),
        epochs=2, mesh=None, log_every=0,
    )
    j_eval = jloop.evaluate(
        j_res.state, j_make_translation_loss(jm, 0, train=False),
        jloader.DataLoader(jloader.ArrayDataset(v_src, v_trg), 8, drop_last=False),
    )

    t_state = tstate.TrainState.create(model=tm, tx=tstate.make_optimizer(name, lr))
    t_res = tloop.fit(
        t_state, trecipe.make_translation_loss(0),
        tloader.DataLoader(tloader.ArrayDataset(src, trg), 8, shuffle=True, seed=2),
        epochs=2, log_every=0,
    )
    t_eval = tloop.evaluate(
        t_res.state, trecipe.make_translation_loss(0, train=False),
        tloader.DataLoader(tloader.ArrayDataset(v_src, v_trg), 8, drop_last=False),
    )
    assert t_state.step == 16 and int(j_res.state.step) == 16
    assert [h.keys() for h in t_res.history] == [h.keys() for h in j_res.history]
    np.testing.assert_allclose(
        [h["loss"] for h in t_res.history], [h["loss"] for h in j_res.history], rtol=1e-4
    )
    got, want = _flat(export_flax_params(tm)), _flat(jax.tree.map(np.asarray, j_res.state.params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=params_atol, rtol=0, err_msg=k)
    assert t_eval["eval_samples"] == j_eval["eval_samples"] == 20
    np.testing.assert_allclose(t_eval["test_loss"], j_eval["test_loss"], rtol=1e-4)


# -- the recipe --------------------------------------------------------------------


def test_train_translator_runs_on_the_cpu_with_the_jax_result_keys():
    out = trecipe.train_translator(
        device="cpu", data_root=FIXTURES, d_model=32, ffn_hidden=64,
        num_heads=2, max_len=24, epochs=1, compute_bleu=True, log_every=0,
    )
    # The JAX recipe's result for the same run: its own summarize over a
    # fit result and eval metrics, with the recipe's extras.
    j_fit = jloop.FitResult(state=None, train_seconds=0.0, history=[{"loss": 1.0, "epoch": 0}])
    j_keys = jcommon.summarize(
        j_fit, {"test_loss": 1.0, "eval_samples": 80}, src_vocab=1, trg_vocab=1, bleu=0.0
    ).keys()
    assert out.keys() == j_keys
    assert [h.keys() for h in out["history"]] == [{"loss": 0, "epoch": 0}.keys()]
    assert out["eval_samples"] == 80  # every validation pair, the 16-row tail included
    assert np.isfinite(out["test_loss"]) and np.isfinite(out["final_loss"])
    assert 0.0 <= out["bleu"] <= 1.0


@pytest.mark.parametrize("field", sorted(trecipe.UNPORTED))
def test_unported_recipe_fields_raise(field):
    default = getattr(trecipe.TranslationRecipe(), field)
    value = {bool: True, int: 2, float: 0.5, str: "ulysses", tuple: (8,)}.get(
        type(default), "x"
    )
    # expert_parallel without experts is the JAX recipe's ValueError; with
    # experts it divides, it is the mesh the port lacks.
    extra = {"moe_experts": 4} if field == "expert_parallel" else {}
    with pytest.raises(NotImplementedError, match=field):
        trecipe.train_translator(device="cpu", **{field: value}, **extra)


def _two_process_mesh():
    # A mesh over a 2-process gang, as a gang's rank would hold it; fit
    # refuses what is unported before any collective runs.
    from machine_learning_apache_spark_tpu_torch.parallel.mesh import make_mesh

    return make_mesh({"data": 2}, world=2, device="cpu")


@pytest.mark.parametrize(
    "kw", [
        # A mesh, sync checks and gang checkpoints run; what stays
        # unported on them is an elastic (resharding) resume.
        dict(sync_check_every=1, mesh="gang", checkpointer=object(), resume=True,
             elastic=True),
        dict(elastic=True)],
    ids=lambda kw: next(iter(kw)),
)
def test_unported_fit_arguments_raise(kw):
    state = tstate.TrainState.create(
        model=Transformer(TransformerConfig(**TINY)), tx=tstate.make_optimizer()
    )
    if kw.get("mesh") == "gang":
        kw = {**kw, "mesh": _two_process_mesh()}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tloop.fit(state, trecipe.make_translation_loss(0), [], epochs=1, **kw)


@pytest.mark.parametrize(
    "kw,match", [
        (dict(dp_mode="zero1"), "mesh"),
        (dict(mesh="gang", dp_mode="zero1", zero1=True), "not both"),
        (dict(mesh="gang", dp_mode="zero1", steps_per_call=2), "steps_per_call"),
        (dict(mesh="gang", dp_comms_dtype="bfloat16"), "zero1"),
        (dict(mesh="gang", dp_overlap=False), "zero1"),
        (dict(zero1=True), "requires a mesh"),
    ],
    ids=["zero1-no-mesh", "zero1-and-implicit", "zero1-k-steps", "comms-dtype-replicated",
         "overlap-replicated", "implicit-no-mesh"],
)
def test_fit_rejects_bad_combinations(kw, match):
    """The JAX loop's ``ValueError``s (``tests/test_zero.py``'s
    ``test_fit_rejects_bad_combinations``), raised before any collective."""
    state = tstate.TrainState.create(
        model=Transformer(TransformerConfig(**TINY)), tx=tstate.make_optimizer()
    )
    if kw.get("mesh") == "gang":
        kw = {**kw, "mesh": _two_process_mesh()}
    with pytest.raises(ValueError, match=match):
        tloop.fit(state, trecipe.make_translation_loss(0), [], epochs=1, **kw)


def test_recipe_zero1_needs_a_gang():
    """The recipe's ``zero1`` reaches ``fit(zero1=True)``: one process has
    no data axis to shard the moments over, the JAX loop's error."""
    with pytest.raises(ValueError, match="zero1=True requires a mesh"):
        trecipe.train_translator(device="cpu", zero1=True, d_model=32, ffn_hidden=64,
                                 num_heads=2, max_len=24, synthetic_n=16)


def test_train_translator_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trecipe.train_translator(data_root=FIXTURES, d_model=32, num_heads=2, max_len=24)
