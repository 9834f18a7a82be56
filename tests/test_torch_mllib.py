"""The port's MLlib engine against the JAX package's, on the CPU.

The L-BFGS fit (optax's algorithm, written out in torch) from the JAX
fit's own initial parameters over the libsvm sample: the first 10
iterations' losses within 1e-4 relative (float32, different summation
orders; the linesearch's branches then agree), the final accuracy equal.
The ``tol`` freeze, the ``gd`` solver, ``setParams`` and the evaluator's
accuracy and macro F1 against the JAX ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from machine_learning_apache_spark_tpu.data.libsvm import read_libsvm as j_read_libsvm
from machine_learning_apache_spark_tpu.mllib import (
    MulticlassClassificationEvaluator as JEvaluator,
    MultilayerPerceptronClassifier as JClassifier,
)
from machine_learning_apache_spark_tpu.mllib.classifier import PredictionFrame as JFrame
from machine_learning_apache_spark_tpu.models import MLP as JMLP
from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
from machine_learning_apache_spark_tpu_torch.mllib import (
    MulticlassClassificationEvaluator,
    MultilayerPerceptronClassifier,
    PredictionFrame,
)
from machine_learning_apache_spark_tpu_torch.mllib.lbfgs import _cubicmin, _quadmin
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

SAMPLE = "assets/sample_multiclass_classification_data.txt"
LAYERS = [4, 5, 4, 3]


def _splits():
    train, test = read_libsvm(SAMPLE).random_split([0.6, 0.4], seed=1234)
    jtrain, jtest = j_read_libsvm(SAMPLE).random_split([0.6, 0.4], seed=1234)
    np.testing.assert_array_equal(train.features, jtrain.features)
    return train, test, jtrain, jtest


def _jax_init(frame, seed):
    """The initial parameters the JAX fit draws (``mlp.init`` on the first
    row under ``jax.random.key(seed)``), as numpy."""
    x = jnp.asarray(frame.arrays()[0])
    params = JMLP(layers=tuple(LAYERS)).init(jax.random.key(seed), x[:1])["params"]
    return jax.tree.map(np.asarray, params)


def _fits(**kw):
    train, test, jtrain, jtest = _splits()
    jmodel = JClassifier(layers=LAYERS, **kw).fit(jtrain)
    tmodel = MultilayerPerceptronClassifier(layers=LAYERS, **kw).fit(
        train, device="cpu", initial_params=_jax_init(jtrain, kw.get("seed", 1234))
    )
    return jmodel, tmodel, test, jtest


@pytest.fixture(scope="module")
def lbfgs_fits():
    return _fits(maxIter=100, seed=1234)


def test_lbfgs_follows_the_jax_trajectory(lbfgs_fits):
    jmodel, tmodel, test, jtest = lbfgs_fits
    want, got = np.asarray(jmodel.loss_history), tmodel.loss_history
    assert got.shape == want.shape == (100,)
    np.testing.assert_allclose(got[:10], want[:10], rtol=1e-4)
    assert got[-1] < 1e-3 and want[-1] < 1e-3
    acc = MulticlassClassificationEvaluator().evaluate(tmodel.transform(test))
    assert acc == JEvaluator().evaluate(jmodel.transform(jtest))
    assert tmodel.transform(test).predictions.shape == (len(test),)


def test_lbfgs_params_and_iterations(lbfgs_fits):
    jmodel, tmodel, _, _ = lbfgs_fits
    assert jax.tree.map(np.shape, tmodel.params) == jax.tree.map(np.shape, jmodel.params)
    # The iteration after the improvement first fell below tol updates no more.
    frozen = int(np.argmax(tmodel.loss_history == tmodel.loss_history[-1]))
    assert 0 < tmodel.iterations <= frozen + 1 < 100


def test_tol_freezes_the_carry_as_the_jax_fit_does():
    jmodel, tmodel, _, _ = _fits(maxIter=30, tol=5e-2, seed=1234)
    want, got = np.asarray(jmodel.loss_history), tmodel.loss_history
    # The freeze comes at the same iteration, and from there the loss is flat.
    first = lambda h: int(np.argmax(h == h[-1]))  # noqa: E731
    assert first(got) == first(want) < 29
    assert np.all(got[first(got):] == got[-1])
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_gd_is_optax_sgd():
    jmodel, tmodel, test, jtest = _fits(maxIter=25, solver="gd", stepSize=0.5, seed=7)
    np.testing.assert_allclose(tmodel.loss_history, np.asarray(jmodel.loss_history), rtol=1e-5)
    assert tmodel.iterations == 25


def test_interpolation_helpers_match_optax():
    from optax._src import linesearch as ls

    rng = np.random.default_rng(3)
    for _ in range(20):
        a, fa, fpa, b, fb, c, fc = rng.standard_normal(7).astype(np.float32)
        want = float(ls._cubicmin(a, fa, fpa, b, fb, c, fc))
        got = float(_cubicmin(*(np.float32(v) for v in (a, fa, fpa, b, fb, c, fc))))
        assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want, rel=1e-4)
        assert float(_quadmin(a, fa, fpa, b, fb)) == pytest.approx(
            float(ls._quadmin(a, fa, fpa, b, fb)), rel=1e-5)


def test_set_params_and_bad_arguments():
    est = MultilayerPerceptronClassifier().setParams(maxIter=3, solver="gd")
    assert (est.maxIter, est.solver) == (3, "gd")
    with pytest.raises(ValueError, match="unknown param 'bogus'"):
        est.setParams(bogus=1)
    frame = read_libsvm(SAMPLE)
    with pytest.raises(ValueError, match="unsupported solver 'newton'"):
        MultilayerPerceptronClassifier(solver="newton").fit(frame, device="cpu")
    # fit(mesh=) is ported: a mesh of one process runs the plain fit.
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh

    model = MultilayerPerceptronClassifier(maxIter=2).fit(
        frame, mesh=data_parallel_mesh(device="cpu"), device="cpu"
    )
    assert model.loss_history.shape == (2,) and model.allreduces == 0


@pytest.mark.parametrize("metric", ["accuracy", "f1"])
def test_evaluator_matches_jax(metric):
    rng = np.random.default_rng(4)
    labels, preds = rng.integers(0, 4, 200), rng.integers(0, 4, 200)
    preds[:120] = labels[:120]
    x = np.zeros((200, 1), np.float32)
    got = MulticlassClassificationEvaluator(metric).evaluate(PredictionFrame(x, labels, preds))
    want = JEvaluator(metric).evaluate(JFrame(x, labels, preds))
    assert got == want
    with pytest.raises(ValueError, match="unknown metric"):
        MulticlassClassificationEvaluator("auc").evaluate(PredictionFrame(x, labels, preds))


# -- fit(mesh=): MLlib's treeAggregate over a gang ------------------------------


def test_mesh_of_one_process_is_the_single_fit_bit_for_bit():
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh

    train, _, jtrain, _ = _splits()
    init = _jax_init(jtrain, 1234)
    trainer = MultilayerPerceptronClassifier(layers=LAYERS, maxIter=5)
    single = trainer.fit(train, device="cpu", initial_params=init)
    meshed = trainer.fit(train, mesh=data_parallel_mesh(device="cpu"), device="cpu",
                         initial_params=init)
    np.testing.assert_array_equal(meshed.loss_history, single.loss_history)
    for a, b in zip(jax.tree.leaves(single.params), jax.tree.leaves(meshed.params)):
        np.testing.assert_array_equal(a, b)
    assert meshed.allreduces == 0 and meshed.evaluations == single.evaluations > 5


def test_two_rank_gang_fit_matches_the_jax_mesh_fit():
    """A 2-rank CPU gang against the JAX ``fit(mesh=make_mesh({"data": 2}))``
    from the JAX fit's own initial parameters, within the JAX
    ``TestMeshFit`` bound (atol 1e-5, rtol 1e-4) at maxIter=5."""
    from machine_learning_apache_spark_tpu.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.launcher import Distributor

    _, _, jtrain, _ = _splits()
    jmesh = make_mesh({"data": 2}, devices=jax.devices()[:2])
    jmodel = JClassifier(layers=LAYERS, maxIter=5).fit(jtrain, mesh=jmesh)
    out = Distributor(num_processes=2, platform="cpu", timeout=300).run(
        "torch_launcher_workers:mllib_mesh_fit", SAMPLE, LAYERS, 5,
        _jax_init(jtrain, 1234), device="cpu",
    )
    assert out["world"] == 2 and out["ranks_agree"]
    # Every evaluation, line-search trials included, is one all-reduce.
    assert out["allreduces"] == out["evaluations"] > 5
    np.testing.assert_allclose(out["loss_history"], np.asarray(jmodel.loss_history), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(jmodel.params), jax.tree.leaves(out["params"])):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=1e-5, rtol=1e-4)
