"""The port's data layer for the zoo recipes against the JAX package's, on
the CPU: ``ArrayFrame.random_split``, the libsvm reader (native and
Python parsers, the committed sample, a malformed line) and writer,
``DataReader``, the fixture loaders and synthetic generators, both
bucketed loaders over two epochs, and the three native bindings. Each
pair must give equal arrays (exact equality: the same files, seeds and
code paths on the host).
"""

import numpy as np
import pytest

from machine_learning_apache_spark_tpu import native as jnative
from machine_learning_apache_spark_tpu.data import bucketing as jbucketing
from machine_learning_apache_spark_tpu.data import datasets as jdatasets
from machine_learning_apache_spark_tpu.data.frame import ArrayFrame as JFrame
from machine_learning_apache_spark_tpu.data.libsvm import (
    read_libsvm as j_read_libsvm,
    write_libsvm as j_write_libsvm,
)
from machine_learning_apache_spark_tpu.data.reader import DataReader as JReader
from machine_learning_apache_spark_tpu.data.text import (
    classification_pipeline as j_classification_pipeline,
)
from machine_learning_apache_spark_tpu_torch import native as tnative
from machine_learning_apache_spark_tpu_torch.data import bucketing as tbucketing
from machine_learning_apache_spark_tpu_torch.data import datasets as tdatasets
from machine_learning_apache_spark_tpu_torch.data.frame import ArrayFrame
from machine_learning_apache_spark_tpu_torch.data.libsvm import (
    read_libsvm,
    write_libsvm,
)
from machine_learning_apache_spark_tpu_torch.data.reader import DataReader
from machine_learning_apache_spark_tpu_torch.data.text import classification_pipeline
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

SAMPLE = "assets/sample_multiclass_classification_data.txt"
FIXTURES = "assets/fixtures"


def _same_frames(got, want):
    np.testing.assert_array_equal(got.features, want.features)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.features.dtype == want.features.dtype
    assert got.labels.dtype == want.labels.dtype


@pytest.mark.parametrize("weights,seed", [([0.6, 0.4], 1234), ([1, 2, 1], 7)])
def test_random_split_is_the_jax_split(weights, seed):
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal((37, 3)).astype(np.float32), rng.integers(0, 3, 37)
    got = ArrayFrame(x, y).random_split(weights, seed=seed)
    want = JFrame(x, y).randomSplit(weights, seed=seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_frames(g, w)
        for a, b in zip(g.arrays(), w.arrays()):
            np.testing.assert_array_equal(a, b)
    assert ArrayFrame(x, y).num_classes == JFrame(x, y).num_classes


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_read_libsvm_matches_jax_on_the_sample(use_native):
    got = read_libsvm(SAMPLE, use_native=use_native)
    _same_frames(got, j_read_libsvm(SAMPLE, use_native=use_native))
    assert got.features.shape == (150, 4) and got.labels.dtype == np.int64
    _same_frames(read_libsvm(SAMPLE, num_features=6, use_native=use_native),
                 j_read_libsvm(SAMPLE, num_features=6, use_native=use_native))
    with pytest.raises(ValueError, match="num_features=3"):
        read_libsvm(SAMPLE, num_features=3, use_native=use_native)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
def test_malformed_line_raises_as_jax_does(tmp_path, use_native):
    path = tmp_path / "bad.txt"
    path.write_text("1 1:0.5 2:1.0\n0 3:oops\n")
    with pytest.raises(ValueError) as want:
        j_read_libsvm(str(path), use_native=use_native)
    with pytest.raises(ValueError) as got:
        read_libsvm(str(path), use_native=use_native)
    assert str(got.value) == str(want.value)


def test_write_libsvm_round_trips_as_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 5)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0.0
    y = rng.integers(0, 4, 9)
    write_libsvm(str(tmp_path / "t.txt"), x, y)
    j_write_libsvm(str(tmp_path / "j.txt"), x, y)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    _same_frames(read_libsvm(str(tmp_path / "t.txt"), num_features=5),
                 j_read_libsvm(str(tmp_path / "j.txt"), num_features=5))


def test_data_reader_formats_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    x, y = rng.standard_normal((6, 3)).astype(np.float32), rng.integers(0, 2, 6)
    np.savez(tmp_path / "d.npz", features=x, labels=y)
    np.savetxt(tmp_path / "d.csv", np.c_[x, y], delimiter=",")
    cases = [
        ("libsvm", {"numFeatures": 5}, SAMPLE),
        ("npz", {}, str(tmp_path / "d.npz")),
        ("csv", {}, str(tmp_path / "d.csv")),
        ("image", {"split": "test"}, FIXTURES),
    ]
    for fmt, options, path in cases:
        t, j = DataReader().format(fmt), JReader().format(fmt)
        for k, v in options.items():
            t, j = t.option(k, v), j.option(k, v)
        _same_frames(t.load(path), j.load(path))
    with pytest.raises(ValueError, match="unsupported format"):
        DataReader().format("parquet").load(SAMPLE)


@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_fixture_loaders_match_jax(train):
    for name in ("load_fashion_mnist", "load_cifar10"):
        got = getattr(tdatasets, name)(FIXTURES, train=train)
        _same_frames(got, getattr(jdatasets, name)(FIXTURES, train=train))
        assert got.features.dtype == np.float32 and got.features.ndim == 4
        assert 0.0 <= got.features.min() and got.features.max() <= 1.0
    texts, labels = tdatasets.load_ag_news(FIXTURES, train=train)
    want_texts, want_labels = jdatasets.load_ag_news(FIXTURES, train=train)
    assert texts == want_texts
    np.testing.assert_array_equal(labels, want_labels)


def test_synthetic_generators_match_jax():
    for kw in (dict(n=64, seed=3), dict(n=40, height=32, width=32, channels=3, seed=4)):
        _same_frames(tdatasets.synthetic_image_classification(**kw),
                     jdatasets.synthetic_image_classification(**kw))
    _same_frames(tdatasets.synthetic_multiclass(90, seed=5),
                 jdatasets.synthetic_multiclass(90, seed=5))
    texts, labels = tdatasets.synthetic_text_classification(50, seed=6)
    want_texts, want_labels = jdatasets.synthetic_text_classification(50, seed=6)
    assert texts == want_texts
    np.testing.assert_array_equal(labels, want_labels)


def _ag_news_ragged():
    texts, labels = tdatasets.load_ag_news(FIXTURES, train=True)
    pipe = classification_pipeline(texts, max_seq_len=32, fixed_len=33)
    jpipe = j_classification_pipeline(texts, max_seq_len=32, fixed_len=33)
    ragged = pipe.ragged(texts)
    assert ragged == jpipe.ragged(texts)
    return ragged, labels


def _same_batches(got_loader, want_loader, epochs=2):
    for epoch in range(epochs):
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        assert len(got_loader) == len(want_loader) > 0
        assert got_loader.padding_efficiency == want_loader.padding_efficiency
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(batch_size=16, boundaries=(8, 16, 33)),
    dict(batch_size=8, boundaries=(12, 40), drop_last=False, seed=3),
    dict(batch_size=8, boundaries=(10, 20), truncate_overlong=True, num_replicas=2, rank=1),
], ids=["drop_last", "ragged_tails", "overlong_rank1of2"])
def test_bucketed_loader_batches_equal_jax_over_two_epochs(kw):
    ragged, labels = _ag_news_ragged()
    _same_batches(
        tbucketing.BucketByLengthLoader(ragged, labels, **kw),
        jbucketing.BucketByLengthLoader(ragged, labels, **kw),
    )


def test_bucketed_pairs_loader_batches_equal_jax_over_two_epochs():
    ragged, labels = _ag_news_ragged()
    trg = [row[: max(2, len(row) // 2)] for row in ragged]
    kw = dict(batch_size=8, boundaries=(16, 33))
    _same_batches(
        tbucketing.BucketByLengthPairsLoader(ragged, trg, labels, **kw),
        jbucketing.BucketByLengthPairsLoader(ragged, trg, labels, **kw),
    )


def test_bucketed_loader_rejects_overlong_rows_as_jax_does():
    ragged, labels = _ag_news_ragged()
    with pytest.raises(ValueError, match="exceeds the largest bucket"):
        tbucketing.BucketByLengthLoader(ragged, labels, batch_size=4, boundaries=(8,))
    assert (tbucketing.assign_buckets([1, 8, 9, 40], (8, 16)).tolist()
            == jbucketing.assign_buckets([1, 8, 9, 40], (8, 16)).tolist())


def test_native_bindings_equal_the_jax_packages():
    assert tnative.available() and jnative.available()
    # The port builds its own copies into build/, not next to the JAX sources.
    assert tnative.library_path().parent.name == "native"
    assert tnative.library_path().parent.parent.name == "build"

    text = open(SAMPLE, "rb").read()
    for a, b in zip(tnative.libsvm_native.parse_text(text),
                    jnative.libsvm_native.parse_text(text)):
        np.testing.assert_array_equal(a, b)

    rng = np.random.default_rng(8)
    src = rng.standard_normal((50, 3, 4)).astype(np.float32)
    idx = rng.integers(-50, 50, 70)
    np.testing.assert_array_equal(tnative.gather_rows(src, idx), jnative.gather_rows(src, idx))
    np.testing.assert_array_equal(tnative.gather_rows(src, idx), src[idx])
    with pytest.raises(IndexError):
        tnative.gather_rows(src, np.array([50]))

    texts, _ = tdatasets.load_ag_news(FIXTURES, train=False)
    pipe = classification_pipeline(texts, max_seq_len=20, fixed_len=21)
    kw = dict(mode=0, max_seq_len=20, fixed_len=21, add_sos=True, add_eos=True,
              sos_id=1, eos_id=2, pad_id=0, default_index=3)
    handles = (tnative.text_native.vocab_handle(pipe.vocab.itos),
               jnative.text_native.vocab_handle(pipe.vocab.itos))
    try:
        got = tnative.text_native.encode(handles[0], texts, **kw)
        want = jnative.text_native.encode(handles[1], texts, **kw)
    finally:
        tnative.text_native.vocab_free(handles[0])
        jnative.text_native.vocab_free(handles[1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pipe(texts))
