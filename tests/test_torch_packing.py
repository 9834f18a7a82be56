"""The port's sequence packing against the JAX package's, on the CPU.

``pack_translation_pairs`` must give the JAX packer's arrays, pair and
drop counts and efficiencies exactly (fixture ids, and raw rows with
truncation, dropped pairs and a segment cap). The packed loss
(``recipes.translation.make_packed_translation_loss``) and the model's
logits under the segment masks and per-segment positions are held
against the JAX packed loss and logits with the Flax weights carried
across (rtol 1e-5 on the loss, atol 1e-4 / rtol 1e-4 on the logits, as
``tests/test_torch_transformer.py``), and against the same pairs unpacked
in the port (each pair's logits within atol 2e-5 / rtol 2e-4 of its solo
row, the loss within rtol 2e-4, the JAX package's own tolerances). The
recipe packs, reports the JAX result keys and trains at 3 steps per call
bit for bit like 1. Dropout is off wherever the packages are compared.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.data.packing import (
    pack_translation_pairs as j_pack,
)
from machine_learning_apache_spark_tpu.models import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.ops.masks import make_segment_mask as j_segment_mask
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_packed_translation_loss as j_packed_loss,
)
from machine_learning_apache_spark_tpu_torch.data.datasets import load_multi30k
from machine_learning_apache_spark_tpu_torch.data.packing import pack_translation_pairs
from machine_learning_apache_spark_tpu_torch.data.text import PAD_ID, translation_pipelines
from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
from machine_learning_apache_spark_tpu_torch.ops.masks import (
    combine_masks,
    make_causal_mask,
    make_segment_mask,
)
from machine_learning_apache_spark_tpu_torch.recipes import translation as trecipe
from machine_learning_apache_spark_tpu_torch.train.losses import masked_token_cross_entropy
from machine_learning_apache_spark_tpu_torch.train.loop import to_device
from machine_learning_apache_spark_tpu_torch.weights import load_flax_params
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

FIXTURES = "assets/fixtures"
TINY = dict(
    src_vocab_size=32, trg_vocab_size=32, d_model=16, ffn_hidden=32,
    num_heads=2, num_layers=2, max_len=16, dropout=0.0,
)
SRC = [[5, 6, 7], [8, 9], [10, 11, 12, 13], [14], [15, 16, 17, 18, 19, 20]]
TRG = [[1, 20, 21, 2], [1, 22, 2], [1, 23, 24, 25, 2], [1, 26, 2], [1, 27, 28, 2]]

FIELDS = (
    "src", "src_segments", "src_positions", "trg", "trg_segments", "trg_positions",
    "pair_count", "token_efficiency", "unpacked_efficiency", "dropped_pairs",
)


def _same_packing(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_packer_matches_jax_on_the_fixture_corpus():
    pairs = load_multi30k(FIXTURES, "train")
    src_pipe, trg_pipe = translation_pipelines(pairs, max_len=24)
    src = src_pipe.ragged([s for s, _ in pairs])
    trg = trg_pipe.ragged([t for _, t in pairs])
    got = pack_translation_pairs(src, trg, src_len=24, trg_len=24, pad_id=PAD_ID)
    _same_packing(got, j_pack(src, trg, src_len=24, trg_len=24, pad_id=PAD_ID))
    assert got.pair_count == len(pairs) and len(got.src) < len(pairs)
    assert got.token_efficiency > got.unpacked_efficiency


@pytest.mark.parametrize(
    "kw",
    [dict(src_len=8, trg_len=8), dict(src_len=5, trg_len=4), dict(src_len=16, trg_len=16, max_segments=2)],
    ids=["budgets", "truncating", "segment-cap"],
)
def test_packer_matches_jax_on_raw_rows(kw):
    src = [*SRC, [], [3]]  # an empty source and
    trg = [*TRG, [4, 5], [6]]  # a one-token target are dropped
    got = pack_translation_pairs(src, trg, **kw)
    _same_packing(got, j_pack(src, trg, **kw))
    assert got.dropped_pairs == 2
    assert len(got.arrays()) == 6


def test_packer_rejects_what_the_jax_packer_rejects():
    with pytest.raises(ValueError, match="mismatch"):
        pack_translation_pairs([[1]], [], src_len=4, trg_len=4)
    with pytest.raises(ValueError, match="too small"):
        pack_translation_pairs([[1]], [[1, 2]], src_len=4, trg_len=1)


@pytest.fixture(scope="module")
def bridged():
    jm = JTransformer(JConfig(**TINY))
    dummy = np.zeros((1, 8), np.int32)
    params = jax.tree.map(
        np.asarray, nn.unbox(jax.jit(jm.init)(jax.random.key(0), dummy, dummy)["params"])
    )
    tm = load_flax_params(Transformer(TransformerConfig(**TINY)), params)
    packed = pack_translation_pairs(SRC, TRG, src_len=16, trg_len=16)
    assert len(packed.src) == 2  # two rows of several segments
    return jm, params, tm, packed


def _packed_logits(tm, batch):
    src, src_seg, src_pos, trg, trg_seg, trg_pos = batch
    tin_seg = trg_seg[:, :-1]
    with torch.no_grad():
        return tm(
            src, trg[:, :-1],
            src_mask=make_segment_mask(src_seg, src_seg),
            trg_mask=combine_masks(
                make_segment_mask(tin_seg, tin_seg), make_causal_mask(tin_seg.shape[1])
            ),
            cross_mask=make_segment_mask(tin_seg, src_seg),
            src_positions=src_pos, trg_positions=trg_pos[:, :-1],
        )


def test_packed_logits_and_loss_match_jax(bridged):
    jm, params, tm, p = bridged
    tin_seg = p.trg_segments[:, :-1]
    want_logits = jax.jit(
        lambda prm: jm.apply(
            {"params": prm}, p.src, p.trg[:, :-1],
            src_mask=j_segment_mask(p.src_segments, p.src_segments),
            trg_mask=j_segment_mask(tin_seg, tin_seg) & jnp.tril(jnp.ones((1, 1, 15, 15), bool)),
            cross_mask=j_segment_mask(tin_seg, p.src_segments),
            src_positions=p.src_positions, trg_positions=p.trg_positions[:, :-1],
        )
    )(params)
    batch = to_device(p.arrays(), torch.device("cpu"))
    got_logits = _packed_logits(tm, batch)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=1e-4, rtol=1e-4)
    want_loss, _ = jax.jit(j_packed_loss(jm, 0))(
        params, tuple(jnp.asarray(a) for a in p.arrays()), jax.random.key(1)
    )
    got_loss, aux = trecipe.make_packed_translation_loss(0)(tm, batch, None)
    assert aux == {}
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)


def test_a_packed_pair_sees_what_it_sees_alone(bridged):
    """Each pair's logits in its segment equal its logits in a row of its
    own, and the packed loss the unpacked batch's loss."""
    _, _, tm, p = bridged
    batch = to_device(p.arrays(), torch.device("cpu"))
    packed_logits = _packed_logits(tm, batch).numpy()
    s = np.zeros((len(SRC), 16), np.int64)
    t = np.zeros((len(SRC), 16), np.int64)
    for k in range(len(SRC)):
        s[k, : len(SRC[k])] = SRC[k]
        t[k, : len(TRG[k])] = TRG[k]
    with torch.no_grad():
        solo = tm(torch.from_numpy(s), torch.from_numpy(t[:, :-1]))
    # Next-fit in corpus order: pair k is the k-th (row, segment) in order.
    slots = [(i, j) for i in range(len(p.src)) for j in range(1, p.trg_segments[i].max() + 1)]
    assert len(slots) == len(SRC)
    for k, (i, j) in enumerate(slots):
        (pos,) = np.nonzero(p.trg_segments[i, :-1] == j)
        offsets = p.trg_positions[i, pos]
        np.testing.assert_allclose(
            packed_logits[i, pos], solo[k, offsets].numpy(), rtol=2e-4, atol=2e-5,
            err_msg=f"pair {k}",
        )
    packed_loss, _ = trecipe.make_packed_translation_loss(0)(tm, batch, None)
    unpacked = masked_token_cross_entropy(solo, torch.from_numpy(t[:, 1:]), 0)
    np.testing.assert_allclose(packed_loss.item(), unpacked.item(), rtol=2e-4)


RECIPE = dict(
    device="cpu", data_root=FIXTURES, d_model=32, ffn_hidden=64, num_heads=2,
    max_len=24, epochs=1, log_every=0, pack_sequences=True, _return_state=True,
)


def test_packed_recipe_reports_the_jax_keys_and_trains_k_steps_bit_for_bit():
    """With dropout 0.1: 3 steps per call trains bit for bit like 1."""
    one = trecipe.train_translator(**RECIPE, dropout=0.1)
    three = trecipe.train_translator(**RECIPE, dropout=0.1, steps_per_call=3)
    assert one["packed_pairs"] == 400 and one["packed_rows"] < 400
    assert one["packing_token_efficiency"] > one["unpacked_token_efficiency"]
    assert one["eval_samples"] == 80  # eval keeps one pair per row
    assert np.isfinite(one["final_loss"]) and np.isfinite(one["test_loss"])
    assert three["fit_result"].step_losses == one["fit_result"].step_losses
    assert all(torch.equal(a, b) for a, b in zip(three["state"].params, one["state"].params))


def test_packing_rejects_what_the_jax_recipe_rejects():
    with pytest.raises(ValueError, match="pack_sequences is incompatible"):
        trecipe.train_translator(device="cpu", pack_sequences=True, bucket_by_length=True)
