"""The zoo's training path in the port against the JAX package's, on the CPU.

- ``fit`` + ``evaluate`` for each model (MLP on the libsvm sample, TinyVGG
  on a slice of the CIFAR-10 fixture, the LSTM on the AG_NEWS fixture
  with ``last_valid``) against the JAX ``fit`` + ``evaluate`` from the same
  carried weights and batches, dropout off: epoch losses and the test loss
  within 1e-4 relative; final params within 1e-4 under SGD, within 5e-3
  (5 lr) under Adam, whose per-coordinate steps of about lr turn
  float-noise gradients into ±lr moves (as ``tests/test_torch_train.py``
  sets out);
- ``train_{mlp,cnn,lstm}(device="cpu", ...)``: the JAX result keys,
  ``steps_per_call=3`` bit for bit like 1, and 1 + 1 resumed epochs bit
  for bit like 2;
- ``Classifier``: predictions equal to the JAX ``Classifier``'s from the
  same weights, ``classifier.json`` equal to the JAX file, and ``save`` →
  ``load`` giving the same predictions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu import inference as jinference
from machine_learning_apache_spark_tpu.data import loader as jloader
from machine_learning_apache_spark_tpu.data.text import (
    classification_pipeline as j_classification_pipeline,
)
from machine_learning_apache_spark_tpu.models import (
    MLP as JMLP,
    LSTMClassifier as JLSTM,
    TinyVGG as JTinyVGG,
)
from machine_learning_apache_spark_tpu.recipes import _common as jcommon
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch import inference as tinference
from machine_learning_apache_spark_tpu_torch.data import loader as tloader
from machine_learning_apache_spark_tpu_torch.data.datasets import (
    load_ag_news,
    load_cifar10,
)
from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
from machine_learning_apache_spark_tpu_torch.data.text import classification_pipeline
from machine_learning_apache_spark_tpu_torch.models import MLP, LSTMClassifier, TinyVGG
from machine_learning_apache_spark_tpu_torch.recipes.cnn import train_cnn
from machine_learning_apache_spark_tpu_torch.recipes.lstm import train_lstm
from machine_learning_apache_spark_tpu_torch.recipes.mlp import train_mlp
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.weights import (
    export_flax_params,
    load_flax_params,
    random_flax_like,
)

SAMPLE = "assets/sample_multiclass_classification_data.txt"
FIXTURES = "assets/fixtures"
# Small versions of the three recipes over the committed fixtures.
RECIPES = {
    "mlp": (train_mlp, dict(data_path=SAMPLE, epochs=2)),
    "cnn": (train_cnn, dict(data_root=FIXTURES, dataset="cifar10", hidden_units=4, epochs=2)),
    "lstm": (train_lstm, dict(data_root=FIXTURES, max_seq_len=16, embed_dim=8,
                              hidden_size=8, epochs=2, classify_from="last_valid")),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if hasattr(v, "items") else {path: np.asarray(v)})
    return out


def _mlp_case():
    frame = read_libsvm(SAMPLE)
    train, test = frame.random_split([0.6, 0.4], seed=1234)
    return (JMLP(layers=(4, 5, 4, 3)), MLP((4, 5, 4, 3)), train.arrays(), test.arrays(),
            "sgd", 0.03, 30, {})


def _cnn_case():
    train, test = load_cifar10(FIXTURES, train=True), load_cifar10(FIXTURES, train=False)
    x, y = train.arrays()
    tx, ty = test.arrays()
    return (JTinyVGG(hidden_units=4), TinyVGG(4, input_shape=(32, 32, 3)),
            (x[:96], y[:96]), (tx[:40], ty[:40]), "sgd", 0.01, 32, {})


def _lstm_case():
    texts, labels = load_ag_news(FIXTURES, train=True)
    test_texts, test_labels = load_ag_news(FIXTURES, train=False)
    pipe = classification_pipeline(texts, max_seq_len=16, fixed_len=17)
    ids = pipe(texts)
    np.testing.assert_array_equal(
        ids, j_classification_pipeline(texts, max_seq_len=16, fixed_len=17)(texts)
    )
    v = len(pipe.vocab)
    return (JLSTM(vocab_size=v, embed_dim=8, hidden_size=8, dropout=0.0),
            LSTMClassifier(v, 8, 8, dropout=0.0), (ids[:160], labels[:160]),
            (pipe(test_texts)[:50], test_labels[:50]), "adam", 1e-3, 32,
            dict(last_timestep=True, pad_id=0))


@pytest.mark.parametrize("case,params_atol", [("mlp", 1e-4), ("cnn", 1e-4), ("lstm", 5e-3)])
def test_fit_and_evaluate_match_the_jax_fit(case, params_atol):
    jm, tm, (x, y), (tx, ty), opt, lr, batch, loss_kw = {
        "mlp": _mlp_case, "cnn": _cnn_case, "lstm": _lstm_case,
    }[case]()
    tree = random_flax_like(tm, 21)
    load_flax_params(tm, tree)

    j_state = jstate.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, tree),
        tx=jstate.make_optimizer(opt, lr),
    )
    j_res = jloop.fit(
        j_state, jloop.classification_loss(jm.apply, **loss_kw),
        jloader.DataLoader(jloader.ArrayDataset(x, y), batch, shuffle=True, seed=5),
        epochs=2, rng=jax.random.key(0), mesh=None, log_every=0,
    )
    j_eval = jloop.evaluate(
        j_res.state, jloop.classification_loss(jm.apply, train=False, **loss_kw),
        jloader.DataLoader(jloader.ArrayDataset(tx, ty), batch, drop_last=False),
    )
    t_state = tstate.TrainState.create(model=tm, tx=tstate.make_optimizer(opt, lr))
    t_res = tloop.fit(
        t_state, tloop.classification_loss(tm, **loss_kw),
        tloader.DataLoader(tloader.ArrayDataset(x, y), batch, shuffle=True, seed=5),
        epochs=2, log_every=0,
    )
    t_eval = tloop.evaluate(
        t_res.state, tloop.classification_loss(tm, train=False, **loss_kw),
        tloader.DataLoader(tloader.ArrayDataset(tx, ty), batch, drop_last=False),
    )
    assert t_state.step == int(j_res.state.step) == 2 * (len(x) // batch)
    assert [h.keys() for h in t_res.history] == [h.keys() for h in j_res.history]
    np.testing.assert_allclose(
        [h["loss"] for h in t_res.history], [h["loss"] for h in j_res.history], rtol=1e-4
    )
    got, want = _flat(export_flax_params(tm)), _flat(jax.tree.map(np.asarray, j_res.state.params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=params_atol, rtol=0, err_msg=k)
    assert t_eval["eval_samples"] == j_eval["eval_samples"] == len(tx)
    np.testing.assert_allclose(t_eval["test_loss"], j_eval["test_loss"], rtol=1e-4)
    assert t_eval.keys() == j_eval.keys()


def _run(name, **kw):
    fn, base = RECIPES[name]
    return fn(device="cpu", **{**base, **kw, "_return_state": True})


@pytest.fixture(scope="module")
def single_step_runs():
    return {name: _run(name) for name in RECIPES}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipes_give_the_jax_result_keys(single_step_runs, name):
    out = single_step_runs[name]
    extra = {"vocab_size": 1} if name == "lstm" else {}
    j_fit = jloop.FitResult(state=None, train_seconds=0.0, history=[{"loss": 1.0}])
    want = set(jcommon.summarize(
        j_fit, {"test_loss": 1.0, "accuracy": 1.0, "eval_samples": 1}, **extra
    ))
    assert set(out) - {"state", "fit_result"} == want
    assert out["epochs"] == 2 and np.isfinite(out["final_loss"])
    assert [set(h) for h in out["history"]] == [{"loss", "accuracy", "epoch"}] * 2
    assert out["eval_samples"] == {"mlp": 60, "cnn": 128, "lstm": 120}[name]


def _same_training(a, b):
    assert a["fit_result"].step_losses == b["fit_result"].step_losses
    for p, q in zip(a["state"].params, b["state"].params):
        assert torch.equal(p, q)


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_three_steps_per_call_train_bit_for_bit_like_one(single_step_runs, name):
    out = _run(name, steps_per_call=3)
    _same_training(out, single_step_runs[name])
    assert len(out["fit_result"].programs) == 1  # one program: K = 3, no accumulation


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_one_plus_one_resumed_epochs_equal_two(single_step_runs, name, tmp_path):
    first = _run(name, epochs=1, checkpoint_dir=str(tmp_path))
    assert "resumed_from_step" not in first
    second = _run(name, epochs=1, checkpoint_dir=str(tmp_path))
    assert second["resumed_from_step"] == first["state"].step
    whole = single_step_runs[name]
    assert (first["fit_result"].step_losses + second["fit_result"].step_losses
            == whole["fit_result"].step_losses)
    for p, q in zip(second["state"].params, whole["state"].params):
        assert torch.equal(p, q)


def test_lstm_dropout_and_buckets_run_and_repeat():
    """Dropout draws from the fit's generator (the same seed trains the
    same bits); ``bucket_by_length`` reports its padding efficiency and
    refuses K > 1."""
    kw = dict(epochs=1, dropout=0.5)
    a, b = _run("lstm", **kw), _run("lstm", **kw, steps_per_call=3)
    _same_training(a, b)
    bucketed = _run("lstm", epochs=1, bucket_by_length=True)
    assert 0.0 < bucketed["padding_efficiency"] <= 1.0
    with pytest.raises(ValueError, match="bucket_by_length"):
        _run("lstm", bucket_by_length=True, steps_per_call=2)
    with pytest.raises(ValueError, match="classify_from"):
        _run("lstm", classify_from="first")


def test_zoo_entry_points_need_a_card_or_an_explicit_cpu(monkeypatch):
    from machine_learning_apache_spark_tpu_torch.mllib import (
        MultilayerPerceptronClassifier,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, kw in RECIPES.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(**kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinference.Classifier(MLP())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultilayerPerceptronClassifier().fit(read_libsvm(SAMPLE))
    with pytest.raises(ValueError, match="dataset"):
        train_cnn(device="cpu", dataset="mnist")


def _classifier_pair(which):
    """(JAX Classifier, port Classifier, inputs) over the same weights."""
    if which == "lstm":
        texts, _ = load_ag_news(FIXTURES, train=False)
        pipe = classification_pipeline(texts, max_seq_len=16, fixed_len=17)
        jpipe = j_classification_pipeline(texts, max_seq_len=16, fixed_len=17)
        jm = JLSTM(vocab_size=len(pipe.vocab), embed_dim=8, hidden_size=8)
        tm = LSTMClassifier(len(pipe.vocab), 8, 8)
        kw = dict(last_timestep=True, head_pad_id=0)
        jkw, tkw, inputs = dict(kw, pipeline=jpipe), dict(kw, pipeline=pipe), texts[:40]
    elif which == "cnn":
        jm, tm = JTinyVGG(hidden_units=4), TinyVGG(4, input_shape=(28, 28, 1))
        jkw, tkw = {}, {}
        inputs = np.random.default_rng(3).random((20, 28, 28, 1)).astype(np.float32)
    else:
        jm, tm = JMLP(layers=(4, 5, 4, 3)), MLP((4, 5, 4, 3))
        jkw, tkw = {}, {}
        inputs = read_libsvm(SAMPLE).features[:50]
    tree = random_flax_like(tm, 31)
    load_flax_params(tm, tree)
    return (jinference.Classifier(jm, jax.tree.map(jnp.asarray, tree), batch_size=16, **jkw),
            tinference.Classifier(tm, batch_size=16, device="cpu", **tkw), inputs)


@pytest.mark.parametrize("which", ["mlp", "cnn", "lstm"])
def test_classifier_matches_jax_and_round_trips(which, tmp_path):
    jc, tc, inputs = _classifier_pair(which)
    want = np.asarray(jc.predict(inputs))
    np.testing.assert_array_equal(tc.predict(inputs).numpy(), want)
    np.testing.assert_allclose(tc.predict_proba(inputs).numpy(),
                               np.asarray(jc.predict_proba(inputs)), rtol=0, atol=1e-5)
    jc.save(str(tmp_path / "jax"))
    tc.save(str(tmp_path / "port"))
    read = lambda d: json.loads((tmp_path / d / "classifier.json").read_text())  # noqa: E731
    assert read("port") == read("jax")
    loaded = tinference.Classifier.load(str(tmp_path / "port"), device="cpu")
    assert type(loaded.model) is type(tc.model)
    np.testing.assert_array_equal(loaded.predict(inputs).numpy(), want)
    with pytest.raises(ValueError, match="empty"):
        tc.predict([])
