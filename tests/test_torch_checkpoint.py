"""The port's checkpoint/resume (``train/checkpoint.py``, ``fit(
checkpointer=, resume=)``, the recipe's ``checkpoint_dir``) on the CPU —
the single-process parts of ``tests/test_checkpoint.py``
(``TestCheckpointManager``, ``TestFitIntegration``, ``TestRecipeResume``,
``TestDurabilityHelpers``, ``TestParamsOnly``, the topology stamp and the
background writer), with ``torch.save`` payloads in place of orbax's.

Beyond the JAX tests: a resumed ``fit`` trains bit for bit like the
uninterrupted one (``torch.equal``, dropout on, one step at a time and
K at a time), a corrupt newest payload or a missing sidecar falls back a
step, and a resumed cosine schedule follows the JAX recipe's extended
horizon.
"""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.data import loader as tloader
from machine_learning_apache_spark_tpu_torch.models import Transformer, TransformerConfig
from machine_learning_apache_spark_tpu_torch.recipes import translation as trecipe
from machine_learning_apache_spark_tpu_torch.train import checkpoint as ckpt_mod
from machine_learning_apache_spark_tpu_torch.train import loop as tloop
from machine_learning_apache_spark_tpu_torch.train import state as tstate
from machine_learning_apache_spark_tpu_torch.train.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from test_torch_train import TINY, _tokens
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process

FIXTURES = "assets/fixtures"
RECIPE = dict(device="cpu", data_root=FIXTURES, d_model=32, ffn_hidden=64, num_heads=2,
              max_len=24, log_every=0)


def make_state(seed=0, *, accumulate=1, dropout=0.0):
    model = Transformer(TransformerConfig(**{**TINY, "dropout": dropout}),
                        generator=torch.Generator().manual_seed(seed))
    return tstate.TrainState.create(
        model=model, tx=tstate.make_optimizer("adam", 1e-3, accumulate_steps=accumulate)
    )


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return tloop.to_device(
        (_tokens(rng, 4, 10, TINY["src_vocab_size"]), _tokens(rng, 4, 9, TINY["trg_vocab_size"])),
        torch.device("cpu"),
    )


def _step(state, seed=0):
    tloop.make_train_step(trecipe.make_translation_loss(0))(state, _batch(seed), None)


def _same_state(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a.params, b.params))
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert (a.step, a.updates, a.mini_step) == (b.step, b.updates, b.mini_step)


class TestCheckpointManager:
    def test_roundtrip(self, tmp_path):
        state = make_state(accumulate=2)
        for i in range(3):
            _step(state, i)  # an update, then half an accumulation
        with CheckpointManager(str(tmp_path / "ckpt")) as ckpt:
            ckpt.save(state, step=5)
            restored, step = ckpt.restore(make_state(seed=1, accumulate=2))
        assert step == 5
        _same_state(restored, state)
        assert all(torch.equal(x, y) for x, y in zip(restored.acc_grads, state.acc_grads))
        assert any(x.abs().sum() > 0 for x in restored.acc_grads)

    def test_latest_resume_and_retention(self, tmp_path):
        with CheckpointManager(str(tmp_path / "c"), max_to_keep=2) as ckpt:
            for s in (1, 2, 3):
                ckpt.save(make_state(seed=s), step=s)
            assert ckpt.latest_step() == 3 and ckpt.pointed_step() == 3
            assert ckpt.all_steps() == [2, 3]  # max_to_keep pruned step 1
            assert ckpt_mod.sidecar_steps_of(ckpt.directory) == [3, 2]
            _, step = ckpt.restore(make_state())
            assert step == 3

    def test_duplicate_step_save_is_noop(self, tmp_path):
        state = make_state()
        with CheckpointManager(str(tmp_path / "dup")) as ckpt:
            ckpt.save(state, step=4)
            assert ckpt.save(state, step=4) == 4
            assert ckpt.all_steps() == [4]

    def test_prior_run_step_is_overwritten(self, tmp_path):
        with CheckpointManager(str(tmp_path / "o")) as ckpt:
            ckpt.save(make_state(seed=0), step=2)
        state_b = make_state(seed=7)
        with CheckpointManager(str(tmp_path / "o")) as ckpt:
            ckpt.save(state_b, step=2)
            restored, _ = ckpt.restore(make_state(seed=1))
        _same_state(restored, state_b)

    def test_fit_with_empty_epochs_does_not_crash(self, tmp_path):
        state = make_state()
        with CheckpointManager(str(tmp_path / "empty_fit")) as ckpt:
            tloop.fit(state, trecipe.make_translation_loss(0), [], epochs=3, log_every=0,
                      checkpointer=ckpt, checkpoint_every=1)
            assert ckpt.all_steps() == [0]

    def test_restore_empty_raises(self, tmp_path):
        with CheckpointManager(str(tmp_path / "empty")) as ckpt:
            with pytest.raises(FileNotFoundError):
                ckpt.restore(make_state())

    def test_training_continues_after_restore(self, tmp_path):
        """Save after two steps, restore into a fresh template, take one
        more step: identical to the uninterrupted run, the template's own
        parameter tensors kept."""
        state = make_state()
        _step(state, 0)
        _step(state, 1)
        with CheckpointManager(str(tmp_path / "r")) as ckpt:
            ckpt.save(state)
            template = make_state(seed=9)
            ptrs = [p.data_ptr() for p in template.params]
            restored, step = ckpt.restore(template)
        assert step == 2 and [p.data_ptr() for p in restored.params] == ptrs
        _step(state, 2)
        _step(restored, 2)
        _same_state(restored, state)
        assert restored.step == 3

    def test_every_sidecar_carries_topology(self, tmp_path):
        with CheckpointManager(str(tmp_path / "t")) as ck:
            ck.save(make_state(), step=1)
            ck.save(make_state(seed=1), step=2, meta={"epoch": 1})
            for s in (1, 2):
                stamp = ck.read_meta(s)["topology"]
                assert stamp == ckpt_mod.topology_stamp()
                assert set(stamp) == {"world_size", "mesh", "dp_mode", "layout"}
            assert ck.read_meta(2)["epoch"] == 1

    def test_async_save_moves_the_pointer_without_a_next_save(self, tmp_path):
        d = tmp_path / "f"
        ck = CheckpointManager(str(d))
        try:
            ck.save(make_state(), step=1, wait=False)
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and ckpt_mod.pointed_step_of(str(d)) != 1:
                time.sleep(0.05)
            assert ckpt_mod.pointed_step_of(str(d)) == 1
            assert (d / "meta_1.json").exists()
        finally:
            ck.close()

    def test_async_save_writes_the_state_as_it_was(self, tmp_path):
        """A ``wait=False`` save snapshots before it returns: a step taken
        right after does not reach the file."""
        state = make_state()
        want = [p.clone() for p in state.params]
        with CheckpointManager(str(tmp_path / "a")) as ck:
            ck.save(state, step=1, wait=False)
            _step(state, 3)
            ck.wait()
            restored, _ = ck.restore(make_state(seed=5))
        assert all(torch.equal(a, b) for a, b in zip(restored.params, want))


class TestLatestValid:
    def _three(self, tmp_path):
        d = str(tmp_path / "v")
        states = {s: make_state(seed=s) for s in (1, 2, 3)}
        with CheckpointManager(d) as ck:
            for s, st in states.items():
                ck.save(st, step=s, meta={"epoch": s})
        return d, states

    def test_corrupt_newest_payload_falls_back_one_step(self, tmp_path):
        d, states = self._three(tmp_path)
        with open(os.path.join(d, "3", ckpt_mod.PAYLOAD), "wb") as f:
            f.write(b"torn")
        with CheckpointManager(d) as ck:
            assert ck.pointed_step() == 3
            restored, step, meta = ck.restore_latest_valid(make_state(seed=9))
        assert step == 2 and meta["epoch"] == 2
        _same_state(restored, states[2])

    def test_missing_sidecar_is_skipped(self, tmp_path):
        d, states = self._three(tmp_path)
        os.unlink(os.path.join(d, "meta_3.json"))
        with CheckpointManager(d) as ck:
            _, step, _ = ck.restore_latest_valid(make_state(seed=9))
        assert step == 2

    def test_the_pointer_is_tried_first(self, tmp_path):
        d, _ = self._three(tmp_path)
        with open(os.path.join(d, ckpt_mod.LATEST_POINTER), "w") as f:
            json.dump({"step": 1}, f)
        with CheckpointManager(d) as ck:
            assert ck.restore_latest_valid(make_state(seed=9))[1] == 1

    def test_an_unfinished_step_is_never_offered(self, tmp_path):
        """A writer killed mid-save leaves ``<step>.tmp-<pid>``: not a
        durable step, the pointer still on the last complete one."""
        d, _ = self._three(tmp_path)
        os.makedirs(os.path.join(d, "4.tmp-123"))
        with open(os.path.join(d, "4.tmp-123", ckpt_mod.PAYLOAD), "wb") as f:
            f.write(b"half")
        assert ckpt_mod.durable_steps_of(d) == {1, 2, 3}
        assert ckpt_mod.pointed_step_of(d) == 3
        with CheckpointManager(d) as ck:
            assert ck.restore_latest_valid(make_state(seed=9))[1] == 3

    def test_nothing_on_disk_is_none(self, tmp_path):
        with CheckpointManager(str(tmp_path / "n")) as ck:
            assert ck.restore_latest_valid(make_state()) is None


def _fit(state, ckpt, epochs, *, resume=False, k=1):
    rng = np.random.default_rng(60)
    src = _tokens(rng, 32, 10, TINY["src_vocab_size"])
    trg = _tokens(rng, 32, 9, TINY["trg_vocab_size"])
    loader = tloader.DataLoader(tloader.ArrayDataset(src, trg), 8, shuffle=True, seed=1)
    return tloop.fit(
        state, trecipe.make_translation_loss(0), loader, epochs=epochs, log_every=0,
        rng=torch.Generator().manual_seed(11), checkpointer=ckpt, resume=resume,
        steps_per_call=k,
    )


class TestFitIntegration:
    def test_fit_saves_per_epoch(self, tmp_path):
        with CheckpointManager(str(tmp_path / "fit")) as ckpt:
            state = make_state()
            rng = np.random.default_rng(0)
            ds = tloader.ArrayDataset(_tokens(rng, 32, 10, 41), _tokens(rng, 32, 9, 37))
            tloop.fit(state, trecipe.make_translation_loss(0), tloader.DataLoader(ds, 8),
                      epochs=3, log_every=0, checkpointer=ckpt, checkpoint_every=2)
            # saves after epoch 2 (index 1) and the final epoch
            assert ckpt.all_steps() == [8, 12]
            assert ckpt.read_meta(12)["epoch"] == 2

    @pytest.mark.parametrize("k", [1, 3], ids=["single-steps", "steps_per_call-3"])
    def test_resumed_fit_trains_bit_for_bit_like_an_uninterrupted_one(self, tmp_path, k):
        """2 epochs, then ``resume=True`` for 2 more, against 4 epochs in
        one run: dropout 0.3 and accumulation 2 on, equal parameters,
        optimizer state and step losses."""
        base = make_state(seed=4, accumulate=2, dropout=0.3)
        whole = _fit(copy.deepcopy(base), None, 4, k=k)
        with CheckpointManager(str(tmp_path / "r")) as ck:
            first = _fit(copy.deepcopy(base), ck, 2, k=k)
            assert first.resumed_step is None
        with CheckpointManager(str(tmp_path / "r")) as ck:
            second = _fit(make_state(seed=8, accumulate=2, dropout=0.3), ck, 4, resume=True, k=k)
        assert second.resumed_step == 8
        assert [h["epoch"] for h in second.history] == [2, 3]
        assert first.step_losses + second.step_losses == whole.step_losses
        _same_state(second.state, whole.state)

    def test_resume_without_a_checkpoint_is_a_fresh_run(self, tmp_path):
        with CheckpointManager(str(tmp_path / "none")) as ck:
            res = _fit(make_state(), ck, 1, resume=True)
        assert res.resumed_step is None and res.state.step == 4

    def test_an_already_complete_run_reports_its_last_metrics(self, tmp_path):
        with CheckpointManager(str(tmp_path / "done")) as ck:
            first = _fit(make_state(), ck, 2)
        with CheckpointManager(str(tmp_path / "done")) as ck:
            again = _fit(make_state(seed=3), ck, 2, resume=True)
        assert again.resumed_step == 8 and again.history == [first.history[-1]]


class TestRecipeResume:
    def test_translation_recipe_resumes(self, tmp_path):
        kw = dict(RECIPE, epochs=1, checkpoint_dir=str(tmp_path / "mt"),
                  schedule="warmup_cosine", warmup_steps=2)
        first = trecipe.train_translator(**kw)
        assert "resumed_from_step" not in first
        second = trecipe.train_translator(**kw)
        assert second["resumed_from_step"] == 12  # 400 fixture pairs, batch 32
        assert [h["epoch"] for h in second["history"]] == [1]
        third = trecipe.train_translator(**kw, resume=False)
        assert "resumed_from_step" not in third

    def test_resumed_cosine_schedule_follows_the_jax_horizon(self, tmp_path):
        """The resumed run's lr at each update it takes is the JAX
        recipe's: its schedule over ``prior_updates + total_updates``."""
        kw = dict(RECIPE, epochs=1, checkpoint_dir=str(tmp_path / "cos"),
                  schedule="warmup_cosine", warmup_steps=2, grad_accum=2)
        trecipe.train_translator(**kw)
        out = trecipe.train_translator(**kw, _return_state=True)
        prior = out["resumed_from_step"] // 2
        total = 12 // 2
        j_schedule = jstate.make_schedule(
            1e-3, "warmup_cosine", warmup_steps=2, total_steps=prior + total
        )
        counts = range(prior, prior + total)
        got = [out["state"].tx.schedule(c) for c in counts]
        np.testing.assert_allclose(got, [float(j_schedule(c)) for c in counts], rtol=1e-6)
        assert out["state"].updates == prior + total

    def test_recipe_resume_continues_the_uninterrupted_run(self, tmp_path):
        """One epoch, then one more over the same directory, equals two
        epochs in one run, K=3 steps per call on both sides."""
        kw = dict(RECIPE, dropout=0.1, steps_per_call=3, _return_state=True)
        d = str(tmp_path / "cont")
        trecipe.train_translator(epochs=1, checkpoint_dir=d, **kw)
        resumed = trecipe.train_translator(epochs=1, checkpoint_dir=d, **kw)
        whole = trecipe.train_translator(epochs=2, **kw)
        assert resumed["fit_result"].step_losses == whole["fit_result"].step_losses[12:]
        _same_state(resumed["state"], whole["state"])


class TestDurabilityHelpers:
    def test_durable_and_sidecar_steps(self, tmp_path):
        d = tmp_path / "r0"
        d.mkdir()
        for s in (1, 3):
            (d / str(s)).mkdir()
        (d / "2.tmp-0").mkdir()
        for s in (3, 1):
            (d / f"meta_{s}.json").write_text(json.dumps({"step": s}))
        assert ckpt_mod.durable_steps_of(str(d)) == {1, 3}
        assert ckpt_mod.sidecar_steps_of(str(d)) == [3, 1]
        assert ckpt_mod.read_meta_at(str(d), 3) == {"step": 3}
        assert ckpt_mod.read_meta_at(str(d), 2) == {}
        assert ckpt_mod.durable_steps_of(str(tmp_path / "missing")) == set()
        assert ckpt_mod.sidecar_steps_of(str(tmp_path / "missing")) == []
        assert ckpt_mod.pointed_step_of(str(d)) is None

    def test_same_topology_normalises_a_stamp_read_back(self):
        stamp = ckpt_mod.topology_stamp()
        assert ckpt_mod.same_topology(json.loads(json.dumps(stamp)), stamp)
        assert ckpt_mod.same_topology({}, stamp)
        assert not ckpt_mod.same_topology({**stamp, "world_size": 4}, stamp)


class TestParamsOnly:
    def test_save_load(self, tmp_path):
        state = make_state()
        save_params(str(tmp_path / "p"), state.model)
        loaded = load_params(str(tmp_path / "p"))
        assert loaded.keys() == state.model.state_dict().keys()
        fresh = load_params(str(tmp_path / "p"), make_state(seed=3).model)
        assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(), state.model.parameters()))
