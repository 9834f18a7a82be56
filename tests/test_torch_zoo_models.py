"""The port's zoo models (MLP, TinyVGG, the LSTM classifier) against the
JAX package's Flax models, on the CPU.

Weights are drawn with numpy from a seed in Flax's layout and carried into
both (``weights.load_flax_params``); inputs come from numpy seeds. Logits
agree within 1e-5 absolute and gradients within 1e-5 of the largest
gradient entry (float32, different summation orders). TinyVGG is held on a
non-square, multi-channel input, so that an H/W swap or a channel-order
slip in the NHWC flatten cannot hide; the LSTM on rows padded to
different lengths, with a state passed in and returned.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.models import (
    MLP as JMLP,
    LSTMClassifier as JLSTM,
    TinyVGG as JTinyVGG,
)
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu_torch.models import (
    MLP,
    LSTMClassifier,
    TinyVGG,
)
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.weights import (
    export_flax_params,
    load_flax_params,
    random_flax_like,
)

LOGIT_ATOL = 1e-5
GRAD_RTOL = 1e-5  # of the largest gradient entry


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if hasattr(v, "items") else {path: np.asarray(v)})
    return out


def _grads_tree(model):
    """The model's ``.grad``s as a Flax tree (its parameters' layout)."""
    twin = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(twin.parameters(), model.parameters()):
            p.copy_(q.grad)
    return export_flax_params(twin)


def _assert_grads_close(jax_grads, torch_grads):
    want, got = _flat(jax.tree.map(np.asarray, jax_grads)), _flat(torch_grads)
    assert sorted(want) == sorted(got)
    scale = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=GRAD_RTOL * scale, err_msg=k)


def _pair(jmodel, tmodel, sample, seed):
    """JAX params and the port model with the same carried weights."""
    shapes = jmodel.init(jax.random.key(0), sample)["params"]
    params = jax.tree.map(np.asarray, shapes)
    drawn = random_flax_like(tmodel, seed)
    assert jax.tree.map(np.shape, drawn) == jax.tree.map(np.shape, params)
    load_flax_params(tmodel, drawn)
    return jax.tree.map(jnp.asarray, drawn), tmodel


CASES = {
    "mlp": dict(
        j=lambda: JMLP(layers=(4, 6, 5, 3)),
        t=lambda: MLP((4, 6, 5, 3)),
        x=lambda rng: rng.standard_normal((7, 4)).astype(np.float32),
    ),
    "mlp_relu": dict(
        j=lambda: JMLP(layers=(3, 8, 2), activation=jax.nn.relu),
        t=lambda: MLP((3, 8, 2), activation=torch.relu),
        x=lambda rng: rng.standard_normal((5, 3)).astype(np.float32),
    ),
    "tinyvgg_12x20x3": dict(
        j=lambda: JTinyVGG(hidden_units=4, num_classes=5),
        t=lambda: TinyVGG(4, 5, input_shape=(12, 20, 3)),
        x=lambda rng: rng.random((2, 12, 20, 3)).astype(np.float32),
    ),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_feedforward_models_match_flax(case):
    c = CASES[case]
    rng = np.random.default_rng(11)
    x = c["x"](rng)
    params, model = _pair(c["j"](), c["t"](), jnp.asarray(x), seed=3)
    jmodel = c["j"]()
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=LOGIT_ATOL)

    probe = rng.standard_normal(want.shape).astype(np.float32)
    jgrads = jax.grad(
        lambda p: jnp.sum(jmodel.apply({"params": p}, jnp.asarray(x)) * probe)
    )(params)
    torch.sum(model(torch.from_numpy(x)) * torch.from_numpy(probe)).backward()
    _assert_grads_close(jgrads, _grads_tree(model))


def test_mlp_validates_its_input_width_and_rejects_tp_rules():
    with pytest.raises(ValueError, match="expects 4 input features, got 5"):
        MLP((4, 3))(torch.zeros(2, 5))
    # tp_rules is ported: the JAX module's alternating annotations, and
    # the same function as the plain MLP on one device.
    tp = MLP((4, 8, 8, 3), tp_rules=True)
    assert [tp.dense_0.logical_axes, tp.dense_1.logical_axes, tp.dense_2.logical_axes] == [
        ("embed", "mlp"), ("mlp", "embed"), ("embed", "mlp")
    ]
    plain = MLP((4, 8, 8, 3))
    x = torch.randn(2, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tp(x), plain(x))


def test_tinyvgg_head_rows_are_in_flax_hwc_order():
    """A head weight that reads a single (h, w, c) position of the NHWC
    feature map must light up exactly there: the flatten is Flax's."""
    model = TinyVGG(2, 1, input_shape=(8, 12, 1))
    hw = (8 // 4, 12 // 4)
    tree = random_flax_like(model, 0)
    tree["classifier"]["kernel"][:] = 0.0
    h, w, c = 1, 2, 1
    tree["classifier"]["kernel"][(h * hw[1] + w) * 2 + c, 0] = 1.0
    load_flax_params(model, tree)
    x = torch.rand(1, 8, 12, 1)
    feats = x.permute(0, 3, 1, 2)
    for block in range(2):
        for conv in range(2):
            feats = torch.relu(getattr(model, f"block{block}_conv{conv}")(feats))
        feats = torch.nn.functional.max_pool2d(feats, 2, 2)
    want = feats[0, c, h, w] + model.classifier.bias[0]
    torch.testing.assert_close(model(x)[0, 0], want)


def _lstm_pair(vocab=23, embed=6, hidden=5, layers=2, seed=4):
    jmodel = JLSTM(vocab_size=vocab, embed_dim=embed, hidden_size=hidden,
                   num_classes=3, num_layers=layers, dropout=0.0)
    tmodel = LSTMClassifier(vocab, embed, hidden, 3, layers, 0.0)
    sample = jnp.zeros((1, 4), jnp.int32)
    params, tmodel = _pair(jmodel, tmodel, sample, seed)
    return jmodel, params, tmodel


def _padded_tokens(rng, lengths, width, vocab):
    tokens = np.zeros((len(lengths), width), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(1, vocab, n)
    return tokens


def test_lstm_matches_flax_with_pads_and_state():
    rng = np.random.default_rng(12)
    jmodel, params, model = _lstm_pair()
    tokens = _padded_tokens(rng, [9, 4, 1, 0], 9, 23)
    state = [
        tuple(rng.standard_normal((4, 5)).astype(np.float32) for _ in range(2))
        for _ in range(2)
    ]
    want, want_state = jmodel.apply(
        {"params": params}, jnp.asarray(tokens),
        [tuple(jnp.asarray(a) for a in s) for s in state], return_state=True,
    )
    got, got_state = model(
        torch.from_numpy(tokens).long(),
        [tuple(torch.from_numpy(a) for a in s) for s in state], return_state=True,
    )
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=LOGIT_ATOL)
    for (gh, gc), (wh, wc) in zip(got_state, want_state):
        np.testing.assert_allclose(gh.detach().numpy(), np.asarray(wh), rtol=0, atol=LOGIT_ATOL)
        np.testing.assert_allclose(gc.detach().numpy(), np.asarray(wc), rtol=0, atol=LOGIT_ATOL)
    # No state: zeros, as Flax's None.
    np.testing.assert_allclose(
        model(torch.from_numpy(tokens).long()).detach().numpy(),
        np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens))),
        rtol=0, atol=LOGIT_ATOL,
    )


@pytest.mark.parametrize("pad_id", [None, 0], ids=["last", "last_valid"])
def test_lstm_loss_and_grads_match_jax(pad_id):
    """``classification_loss`` on the last (or last valid) position, its
    accuracy and every gradient against ``jax.value_and_grad``."""
    rng = np.random.default_rng(13)
    jmodel, params, model = _lstm_pair()
    tokens = _padded_tokens(rng, [7, 3, 1, 0, 5], 8, 23)
    labels = rng.integers(0, 3, 5).astype(np.int64)
    jloss = jloop.classification_loss(jmodel.apply, last_timestep=True, pad_id=pad_id)
    (want, want_aux), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params, (jnp.asarray(tokens), jnp.asarray(labels)), jax.random.key(0)
    )
    tloss = tloop.classification_loss(model, last_timestep=True, pad_id=pad_id)
    got, aux = tloss(model, (torch.from_numpy(tokens).long(), torch.from_numpy(labels)), None)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    assert aux.keys() == want_aux.keys() == {"accuracy"}
    assert aux["accuracy"].item() == pytest.approx(float(want_aux["accuracy"]))
    _assert_grads_close(jgrads, _grads_tree(model))


def test_select_last_valid_matches_jax_including_an_all_pad_row():
    rng = np.random.default_rng(14)
    logits = rng.standard_normal((4, 6, 3)).astype(np.float32)
    tokens = _padded_tokens(rng, [6, 2, 0, 1], 6, 9)
    want = np.asarray(jloop.select_last_valid(jnp.asarray(logits), jnp.asarray(tokens), 0))
    got = tloop.select_last_valid(torch.from_numpy(logits), torch.from_numpy(tokens), 0)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[2].numpy(), logits[2, 0])  # all pads: position 0


@pytest.mark.parametrize("train", [True, False])
def test_classification_loss_matches_jax_on_features(train):
    rng = np.random.default_rng(15)
    jmodel = JMLP(layers=(4, 5, 3))
    x = rng.standard_normal((6, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 6).astype(np.int64)
    params, model = _pair(jmodel, MLP((4, 5, 3)), jnp.asarray(x), seed=5)
    want, want_aux = jloop.classification_loss(jmodel.apply, train=train)(
        params, (jnp.asarray(x), jnp.asarray(labels)), jax.random.key(0)
    )
    got, aux = tloop.classification_loss(model, train=train)(
        model, (torch.from_numpy(x), torch.from_numpy(labels)), torch.Generator()
    )
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    assert aux["accuracy"].item() == pytest.approx(float(want_aux["accuracy"]))


@pytest.mark.parametrize("which", ["mlp", "tinyvgg", "lstm"])
def test_export_of_load_is_the_identity(which):
    model = {
        "mlp": lambda: MLP((4, 5, 4, 3)),
        "tinyvgg": lambda: TinyVGG(3, 4, input_shape=(12, 20, 2)),
        "lstm": lambda: LSTMClassifier(17, 6, 5, 4, 2),
    }[which]()
    tree = random_flax_like(model, 9)
    back = export_flax_params(load_flax_params(model, tree))
    a, b = _flat(tree), _flat(back)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_flax_names_and_layouts():
    """Flax's names, and a conv kernel carried HWIO → OIHW."""
    lstm = export_flax_params(LSTMClassifier(11, 4, 3, 2, 2))
    assert sorted(lstm) == ["embedding", "head", "lstm_0", "lstm_1"]
    assert sorted(lstm["lstm_0"]) == ["bias", "w_h", "w_x"]
    assert lstm["lstm_0"]["w_x"].shape == (4, 12) and lstm["lstm_1"]["w_x"].shape == (3, 12)
    cnn = TinyVGG(3, 4, input_shape=(8, 8, 2))
    tree = export_flax_params(cnn)
    assert sorted(tree) == ["block0_conv0", "block0_conv1", "block1_conv0",
                            "block1_conv1", "classifier"]
    kernel = tree["block0_conv0"]["kernel"]
    assert kernel.shape == (3, 3, 2, 3)
    np.testing.assert_array_equal(
        kernel[1, 2, 0, 1], cnn.block0_conv0.weight[1, 0, 1, 2].detach().numpy()
    )
    mlp_tree = export_flax_params(MLP((4, 5, 3)))
    assert sorted(mlp_tree) == ["dense_0", "dense_1"]
    with pytest.raises(ValueError, match=r"missing \['dense_1/kernel', 'dense_1/bias'\]"):
        load_flax_params(MLP((4, 5, 3)), {"dense_0": mlp_tree["dense_0"]})


def test_construction_leaves_the_global_rng_alone():
    state = torch.random.get_rng_state()
    a = LSTMClassifier(13, 4, 3, 2, 2, generator=torch.Generator().manual_seed(1))
    TinyVGG(2, 3, input_shape=(8, 8, 1))
    MLP((4, 3))
    assert torch.equal(torch.random.get_rng_state(), state)
    b = LSTMClassifier(13, 4, 3, 2, 2, generator=torch.Generator().manual_seed(1))
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_lstm_dropout_draws_from_the_callers_generator():
    model = LSTMClassifier(13, 4, 3, 2, 2, dropout=0.5)
    tokens = torch.randint(1, 13, (3, 5), generator=torch.Generator().manual_seed(0))

    def run(seed):
        return model(tokens, dropout_rng=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert not torch.equal(run(1), model(tokens))  # no generator: no dropout
