"""The port's K-steps-per-call training (``fit(steps_per_call=K)``,
``train.loop.make_multi_step`` on ``utils/graph_cache.ProgramCache``) on
the CPU.

On the card each group of K steps is one CUDA graph
(``tests/test_torch_gpu.py`` replays them); on the CPU the program runs
eagerly and is counted the same way. Here: K steps train bit for bit
like K single steps (``torch.equal`` on every parameter, every step's
loss and the epoch means) with dropout, a schedule, clipping and
accumulation on, for groups that fill the epoch, leave a ragged tail and
exceed it; the port's K-step ``fit`` against the JAX package's
``fit(steps_per_call=3)`` from bridged weights (dropout off, the Adam
tolerances of ``tests/test_torch_train.py``); the program counts; and the
deterministic embedding gradient every training step now takes.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.data import loader as jloader
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.data import loader as tloader
from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
from machine_learning_apache_spark_tpu_torch.models.transformer import EmbeddingLookup
from machine_learning_apache_spark_tpu_torch.recipes import translation as trecipe
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.utils.graph_cache import ProgramCache
from machine_learning_apache_spark_tpu_torch.weights import export_flax_params
from test_torch_train import TINY, _bridge, _flat, _tokens
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

ROWS, BATCH, EPOCHS = 48, 8, 2  # 6 batches an epoch


def _data(seed=50):
    rng = np.random.default_rng(seed)
    return _tokens(rng, ROWS, 10, TINY["src_vocab_size"]), _tokens(rng, ROWS, 9, TINY["trg_vocab_size"])


def _fit(k, *, base, accumulate=2, epochs=EPOCHS):
    """A fit of the tiny model (dropout 0.3) from ``base``'s weights:
    Adam under a cosine schedule, global-norm clipping, accumulation."""
    src, trg = _data()
    state = tstate.TrainState.create(
        model=copy.deepcopy(base),
        tx=tstate.make_optimizer(
            "adam", 3e-3, schedule="cosine", total_steps=ROWS // BATCH * epochs,
            grad_clip=0.5, accumulate_steps=accumulate,
        ),
    )
    loader = tloader.DataLoader(tloader.ArrayDataset(src, trg), BATCH, shuffle=True, seed=4)
    return tloop.fit(
        state, trecipe.make_translation_loss(0), loader, epochs=epochs,
        rng=torch.Generator().manual_seed(9), log_every=5, steps_per_call=k,
    )


@pytest.fixture(scope="module")
def single_steps():
    base = Transformer(TransformerConfig(**{**TINY, "dropout": 0.3}),
                       generator=torch.Generator().manual_seed(3))
    return base, _fit(1, base=base)


# K=3 fills each epoch with two groups, which start at accumulation
# phases 0 and 1: two programs. K=4 leaves a tail of two single steps and
# every group starts at phase 0: one program. K=16 exceeds the epoch:
# every batch runs singly and no program is made.
@pytest.mark.parametrize("k,programs,calls", [(3, 2, 2), (4, 1, 2), (16, 0, 0)],
                         ids=["exact-groups", "ragged-tail", "larger-than-epoch"])
def test_steps_per_call_trains_bit_for_bit_like_single_steps(single_steps, k, programs, calls):
    base, want = single_steps
    got = _fit(k, base=base)
    for a, b in zip(got.state.params, want.state.params):
        assert torch.equal(a, b)
    assert got.step_losses == want.step_losses and len(got.step_losses) == 12
    assert [h["loss"] for h in got.history] == [h["loss"] for h in want.history]
    assert (got.state.step, got.state.updates, got.state.mini_step) == (12, 6, 0)
    assert len(got.programs) == programs
    assert all(p["calls"] == calls and p["name"] == "train_steps" for p in got.programs)


def test_fit_k3_matches_the_jax_fit_with_steps_per_call_3():
    """Both packages' K-step fits from the same bridged weights and
    batches, dropout 0, 2 epochs of 8 steps in groups of 3 (a tail of 2):
    epoch losses rtol 1e-4, final params atol 5e-3 (Adam's float-noise
    coordinates, ``test_fit_and_evaluate_trajectory_match_jax``)."""
    jm, params, tm = _bridge(seed=2)
    rng = np.random.default_rng(51)
    src = _tokens(rng, 64, 12, TINY["src_vocab_size"])
    trg = _tokens(rng, 64, 11, TINY["trg_vocab_size"])
    j_state = jstate.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.asarray, params),
        tx=jstate.make_optimizer("adam", 1e-3),
    )
    j_res = jloop.fit(
        j_state, j_make_translation_loss(jm, 0),
        jloader.DataLoader(jloader.ArrayDataset(src, trg), 8, shuffle=True, seed=2),
        epochs=2, mesh=None, log_every=0, steps_per_call=3,
    )
    t_state = tstate.TrainState.create(model=tm, tx=tstate.make_optimizer("adam", 1e-3))
    t_res = tloop.fit(
        t_state, trecipe.make_translation_loss(0),
        tloader.DataLoader(tloader.ArrayDataset(src, trg), 8, shuffle=True, seed=2),
        epochs=2, log_every=0, steps_per_call=3,
    )
    assert t_state.step == int(j_res.state.step) == 16
    np.testing.assert_allclose(
        [h["loss"] for h in t_res.history], [h["loss"] for h in j_res.history], rtol=1e-4
    )
    got, want = _flat(export_flax_params(tm)), _flat(jax.tree.map(np.asarray, j_res.state.params))
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=5e-3, rtol=0, err_msg=key)
    assert [p["calls"] for p in t_res.programs] == [4]  # 2 groups an epoch, one phase


def test_a_stateful_program_runs_once_per_call_and_is_counted():
    """``eager_first_call``: every call runs the function once (on the
    card the first call is the eager run and the capture executes
    nothing), and the cache counts one program per signature."""
    cache = ProgramCache("cpu", eager_first_call=True)
    acc = torch.zeros(3)

    def bump(x, n):
        acc.add_(x * n)
        return acc.clone()

    for _ in range(3):
        out = cache("bump", bump, torch.ones(3), 2)
    cache("bump", bump, torch.ones(3), 5)
    assert torch.equal(out, torch.full((3,), 6.0)) and torch.equal(acc, torch.full((3,), 11.0))
    assert cache.size() == 2
    assert [(s["calls"], s["replays"]) for s in cache.stats()] == [(3, 3), (1, 1)]


def test_a_group_advances_the_counters_as_single_steps_do():
    """``StepDispatch.group`` over 5 batches from accumulation phase 1
    leaves ``step``, ``updates`` and ``mini_step`` where 5 single steps
    do, and the scheduled lrs are the schedule at the counts each update
    steps at."""
    src, trg = _data()
    batches = [(src[i * 8:(i + 1) * 8], trg[i * 8:(i + 1) * 8]) for i in range(6)]
    base = Transformer(TransformerConfig(**TINY))
    out = []
    for grouped in (False, True):
        state = tstate.TrainState.create(
            model=copy.deepcopy(base),
            tx=tstate.make_optimizer("sgd", 0.1, schedule="cosine", total_steps=4,
                                     accumulate_steps=3),
        )
        dispatch = tloop.StepDispatch(state, trecipe.make_translation_loss(0), torch.Generator())
        dispatch.single(batches[0])
        assert state.mini_step == 1
        if grouped:
            assert state.scheduled_lrs(5).tolist() == [
                state.tx.schedule(0), state.tx.schedule(0), state.tx.schedule(1),
                state.tx.schedule(1), state.tx.schedule(1),
            ]
            losses, _ = dispatch.group(batches[1:])
        else:
            losses = torch.cat([dispatch.single(b)[0] for b in batches[1:]])
        out.append((losses, [p.clone() for p in state.params]))
        assert (state.step, state.updates, state.mini_step) == (6, 2, 0)
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_steps_per_call_below_one_is_refused():
    state = tstate.TrainState.create(
        model=Transformer(TransformerConfig(**TINY)), tx=tstate.make_optimizer()
    )
    with pytest.raises(ValueError, match="steps_per_call"):
        tloop.fit(state, trecipe.make_translation_loss(0), [], epochs=1, steps_per_call=0)


def test_recipe_refuses_steps_per_call_with_length_buckets():
    """The JAX recipe's rule, checked before the bucketed loader's own
    refusal: K stacked batches need one static shape."""
    with pytest.raises(ValueError, match="bucket_by_length"):
        trecipe.train_translator(device="cpu", bucket_by_length=True, steps_per_call=2)


def test_embedding_gradient_is_the_plain_one_summed_in_order():
    """``EmbeddingLookup``: the forward is ``F.embedding``; the weight
    gradient is the embedding's (float64 ``gradcheck``; float32 within
    1e-6 of ``F.embedding``'s) with ids repeated as pads repeat, and ids
    that never occur get zeros."""
    rng = np.random.default_rng(52)
    ids = torch.from_numpy(rng.integers(0, 9, (4, 30)))
    ids[:, 12:] = 0  # a pad-heavy batch
    weight = torch.randn(11, 6, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda w: EmbeddingLookup.apply(w, ids), (weight,))
    w32 = weight.detach().float().requires_grad_()
    grad = torch.from_numpy(rng.standard_normal((4, 30, 6)).astype(np.float32))
    got = torch.autograd.grad(EmbeddingLookup.apply(w32, ids), w32, grad)[0]
    want = torch.autograd.grad(torch.nn.functional.embedding(ids, w32), w32, grad)[0]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got[9:], torch.zeros(2, 6))
