"""The port's ZeRO-1 (``parallel.zero``, ``fit(dp_mode="zero1")``,
``fit(zero1=True)``, the 1-D sharded checkpoint case) and the gang's K
steps per call, held against the JAX package on the same inputs.

The JAX ``make_zero1_step`` is not the oracle here: on this host's jax its
``shard_map`` refuses its own ``out_specs`` (``parallel/zero.py:736``, "out_specs
which require replication which can't be statically inferred"), so the
tests hold the port against three things that do run:

- the JAX package's ZeRO-1 contract, that float32 ZeRO-1 equals the
  replicated step: the port's ZeRO-1 gang is compared bit for bit with the
  port's replicated gang and, within the data-parallel gate of
  ``tests/test_torch_data_parallel.py``, with the JAX replicated
  ``fit(mesh=data_parallel_mesh(2))``;
- the JAX functions that need no ``shard_map``, called directly:
  ``resolve_dp_mode``, ``Zero1Config.from_env``, ``make_flat_plan``,
  ``_flatten``, ``_bucket_segment``, ``_unflatten``,
  ``comms_bytes_per_step``, ``plan_layout``, ``opt_state_bytes(_per_chip)``
  (over ``init_sharded``), ``topology_stamp`` and ``same_topology``;
- ``_reduce_scatter_bucket`` (``zero.py:303-326``) run under
  ``jax.vmap(..., axis_name="data")`` over the ranks' stacked segments,
  whose batching of ``psum_scatter``/``pmax`` hands rank i its piece.

Two 2-rank gloo gangs (one thread per rank): the variants of
``torch_launcher_workers:zero1_variants`` (the replicated step at K = 1
and 4 among them) and the recipe's ZeRO-1 checkpoints
(``zero1_recipe_two_plus_two``).

On the hybrid ``data × model`` mesh the JAX oracles do run: one 4-rank
``{data: 2, model: 2}`` gang (``tp_hybrid_four_rank``) on the JAX
``TestHybridMesh`` setup holds the port's replicated hybrid step to the
JAX TP reference step, its ZeRO-1 hybrid step bit for bit to the
replicated hybrid one (moments included) and within 1e-5 to the JAX
hybrid ``make_zero1_step``, the optimizer bytes per rank to ≤
replicated/4 + 64, the bf16 and int8 wires as the JAX tests hold them,
``fit(zero1=True)`` and the recipe's ``MLSPARK_DP_MODE=zero1`` contract
on that mesh; ``make_hybrid_plan``'s arithmetic is checked on its own.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from machine_learning_apache_spark_tpu.models import MLP as JMLP
from machine_learning_apache_spark_tpu.parallel import zero as jzero
from machine_learning_apache_spark_tpu.parallel.mesh import make_mesh as j_make_mesh
from machine_learning_apache_spark_tpu.parallel.mesh import shard_batch as j_shard_batch
from machine_learning_apache_spark_tpu.parallel.tensor_parallel import shard_state as j_shard_state
from machine_learning_apache_spark_tpu.parallel.mesh import (
    data_parallel_mesh as j_data_parallel_mesh,
)
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu.train import checkpoint as jckpt
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
)
from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
from machine_learning_apache_spark_tpu_torch.parallel import zero
from machine_learning_apache_spark_tpu_torch.train import checkpoint as ckpt
from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
from machine_learning_apache_spark_tpu_torch.weights import load_flax_params
from test_torch_data_parallel import (
    TINY,
    _flat,
    _uneven_batches,
    _update_errors,
)
from test_torch_data_parallel import _transformer_params as _init_transformer
from test_torch_tensor_parallel import RECIPE
from test_torch_tensor_parallel import _flat as _flat_tree

# One Flax init per seed for the whole module (each init compiles).
_transformer_params = functools.cache(_init_transformer)

# One intra-op thread per rank: two ranks of a tiny model otherwise spend
# their time contending for the host's cores.
GANG_ENV = {"OMP_NUM_THREADS": "1"}
SGD_LR = 0.5
ADAM_LR = 1e-2
ADAM_ATOL = 5e-3
# The bf16 wire rounds each rank's bucket to bf16 and the sum once more:
# two roundings of unit u = 2**-8 per step, so each step's update is
# within 2u of its largest coordinate. The run's T = 8 SGD steps add
# those up: each tensor's update within 2uT (= 6.25e-2) of its largest
# float32 update coordinate.
BF16_U = 2.0**-8


def _mlp_tree(rng):
    return {
        "Dense_0": {"kernel": rng.standard_normal((5, 7)).astype(np.float32),
                    "bias": rng.standard_normal(7).astype(np.float32)},
        "Dense_1": {"kernel": rng.standard_normal((7, 3)).astype(np.float32),
                    "bias": rng.standard_normal(3).astype(np.float32)},
    }


def _trees():
    _, mt = _transformer_params(3)
    return {"mlp": _mlp_tree(np.random.default_rng(0)), "transformer": mt}


# -- pure functions ------------------------------------------------------------


@pytest.mark.parametrize("tree", ["mlp", "transformer"])
@pytest.mark.parametrize("axis_size,bucket_bytes", [(2, 4), (2, 64), (4, 4096), (3, 2**22)])
def test_flat_plan_layout_and_wire_bytes_equal_jax(tree, axis_size, bucket_bytes):
    params = _trees()[tree]
    got = zero.make_flat_plan(params, axis_size, bucket_bytes)
    want = jzero.make_flat_plan(jax.tree.map(jnp.asarray, params), axis_size, bucket_bytes)
    for f in ("shapes", "sizes", "total", "padded", "shard_len", "buckets"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.dtypes == tuple(d.name for d in want.dtypes)
    assert zero.plan_layout(got) == jzero.plan_layout(want)
    for dt in zero.COMMS_DTYPES:
        for overlap in (True, False):
            cfg, jcfg = (m.Zero1Config(bucket_bytes=bucket_bytes, comms_dtype=dt, overlap=overlap)
                         for m in (zero, jzero))
            assert zero.comms_bytes_per_step(got, cfg) == jzero.comms_bytes_per_step(want, jcfg)


@pytest.mark.parametrize("tree", ["mlp", "transformer"])
def test_flatten_segments_unflatten_equal_jax(tree):
    params = _trees()[tree]
    jparams = jax.tree.map(jnp.asarray, params)
    plan = zero.make_flat_plan(params, 4, 256)
    jplan = jzero.make_flat_plan(jparams, 4, 256)
    flat = zero._flatten(params, plan)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jzero._flatten(jparams, jplan)))
    leaves = jax.tree.leaves(jparams)
    for k in range(len(plan.buckets)):
        np.testing.assert_array_equal(
            zero._bucket_segment(params, plan, k).numpy(),
            np.asarray(jzero._bucket_segment(leaves, jplan, k)),
        )
    back = zero._unflatten(flat, plan)
    for got, want in zip(back, jax.tree.leaves(jzero._unflatten(jnp.asarray(flat.numpy()), jplan))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dt", zero.COMMS_DTYPES)
@pytest.mark.parametrize("world", [2, 4])
def test_bucket_reduce_scatter_equals_jax_under_vmap(dt, world):
    """The port's wire (``encode_bucket``, the sum in the wire dtype as the
    collective runs it, ``decode_piece``) on every rank's segment equals
    the JAX bucket reduce-scatter batched over the ranks: exactly."""
    rng = np.random.default_rng(world)
    segs = (rng.standard_normal((world, 8 * world)) * 3).astype(np.float32)
    segs[:, 5] = 0.0
    want = jax.vmap(
        lambda s: jzero._reduce_scatter_bucket(s, "data", world, dt), axis_name="data"
    )(jnp.asarray(segs))
    t = torch.from_numpy(segs)
    scale = zero.int8_scale(t.abs().amax(dim=1).max().reshape(1), world) if dt == "int8" else None
    wires = [zero.encode_bucket(t[r], dt, scale) for r in range(world)]
    total = wires[0]
    for w in wires[1:]:
        total = total + w  # in the wire dtype, as gloo sums it (int8 wraps)
    pieces = total.reshape(world, -1)
    for r in range(world):
        got = zero.decode_piece(pieces[r], dt, scale)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[r]), err_msg=f"rank {r}")


@pytest.mark.parametrize("env", [
    {}, {"MLSPARK_ZERO1_BUCKET_BYTES": "65536"}, {"MLSPARK_COMMS_DTYPE": "int8"},
    {"MLSPARK_ZERO1_OVERLAP": "off"}, {"MLSPARK_ZERO1_OVERLAP": "maybe"},
    {"MLSPARK_COMMS_DTYPE": "fp8"}, {"MLSPARK_DP_MODE": "zero1"}, {"MLSPARK_DP_MODE": "zero3"},
], ids=lambda e: ",".join(f"{k}={v}" for k, v in e.items()) or "unset")
def test_config_and_dp_mode_from_env_equal_jax(env, monkeypatch):
    for name in ("MLSPARK_ZERO1_BUCKET_BYTES", "MLSPARK_COMMS_DTYPE", "MLSPARK_ZERO1_OVERLAP",
                 "MLSPARK_DP_MODE"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    def outcome(mod, fn):
        try:
            return fn(mod)
        except ValueError as e:
            return ("ValueError", str(e))

    for fn in (lambda m: _config_tuple(m.Zero1Config.from_env()),
               lambda m: _config_tuple(m.Zero1Config.from_env(bucket_bytes=8, overlap=True)),
               lambda m: m.resolve_dp_mode(None), lambda m: m.resolve_dp_mode("replicated")):
        assert outcome(zero, fn) == outcome(jzero, fn)


def _config_tuple(cfg):
    return (cfg.axis, cfg.bucket_bytes, cfg.comms_dtype, cfg.overlap)


def _tiny_zero1_state(bucket_bytes=4096, opt="adam"):
    tree = _transformer_params(3)[1]
    model = load_flax_params(Transformer(TransformerConfig(**TINY)), tree)
    state = TrainState.create(model=model, tx=make_optimizer(opt, ADAM_LR))
    mesh = make_mesh({"data": 2}, world=2, device="cpu")
    zstate = zero.shard_optimizer_state(state, mesh, zero.Zero1Config(bucket_bytes=bucket_bytes))
    zstate.mesh = mesh
    return tree, zstate


def test_zero1_state_stamp_and_optimizer_bytes_equal_jax():
    tree, zstate = _tiny_zero1_state()
    jstate_ = jzero.init_sharded(
        apply_fn=None, params=jax.tree.map(jnp.asarray, tree), tx=optax.adam(ADAM_LR),
        mesh=j_data_parallel_mesh(2), config=jzero.Zero1Config(bucket_bytes=4096),
    )
    stamp = ckpt.topology_stamp(zstate)
    assert stamp == jckpt.topology_stamp(jstate_)
    assert ckpt.same_topology(stamp, jckpt.topology_stamp(jstate_))
    # The moments are built by the first update: one step on zero
    # gradients (the ZeRO-1 step's update of its shard) makes them.
    for piece in zstate.pieces:
        piece.grad = torch.zeros_like(piece)
    zstate.optimizer.step()
    assert zero.opt_state_bytes_per_chip(zstate) == jzero.opt_state_bytes_per_chip(jstate_)
    assert zero.opt_state_bytes_per_chip(zstate) == 2 * 4 * zstate.plan.shard_len + 4
    # The parameters' grads are views into the flat gradient; the shard is
    # this rank's piece of every bucket of the flat parameters (mesh rank 0
    # outside a gang).
    for p, (o, n) in zip(zstate.params, zip(zstate.plan.offsets, zstate.plan.sizes)):
        assert p.grad.data_ptr() == zstate.flat_grad[o:o + n].data_ptr()
    flat = zero._flatten(zstate.params, zstate.plan)
    want = torch.cat([flat[s:s + zstate.plan.piece(k)]
                      for k, (s, _) in enumerate(zstate.plan.buckets)])
    assert torch.equal(zstate.shard, want)
    assert jckpt.same_topology(stamp, {**stamp, "layout": None}) is False


def test_zero1_payload_round_trip_and_attach_local():
    _, a = _tiny_zero1_state()
    for piece in a.pieces:
        piece.grad = torch.full_like(piece, 0.25)
    a.optimizer.step()
    a.step = a.updates = 1
    payload = ckpt.detached_payload(a)
    opt = payload["optimizer"]
    assert opt["exp_avg"].shape == (a.plan.shard_len,) and opt["step"].ndim == 0
    _, b = _tiny_zero1_state()
    b.load_state_dict(payload)
    for key in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(b.opt_state[key], a.opt_state[key])
    # The whole vector (every rank's run, in rank order) gives this rank's.
    whole = torch.cat([torch.zeros(a.plan.shard_len), opt["exp_avg"]])
    assert torch.equal(ckpt.attach_local(whole, a.plan, 1), opt["exp_avg"])
    assert torch.equal(ckpt.attach_local(opt["exp_avg"], a.plan, 1), opt["exp_avg"])
    with pytest.raises(ValueError, match="fits neither"):
        ckpt.attach_local(opt["exp_avg"][:-1], a.plan, 0)


def test_guards_are_the_jax_packages():
    tree = _transformer_params(3)[1]
    state = TrainState.create(model=load_flax_params(Transformer(TransformerConfig(**TINY)), tree),
                              tx=make_optimizer("adam"))
    mesh = make_mesh({"data": 2}, world=2, device="cpu")
    state.step = 3
    with pytest.raises(ValueError, match="step"):
        zero.shard_optimizer_state(state, mesh)

    class FakeMesh:  # the axes the port's make_mesh does not build yet
        def __init__(self, shape):
            self.shape, self.axis_names, self.rank = shape, tuple(shape), 0

    with pytest.raises(ValueError, match="extra >1 axes"):
        zero._require_zero1_mesh(FakeMesh({"data": 2, "pipeline": 2}), "data")
    with pytest.raises(ValueError, match=">1 'data' axis"):
        zero._require_zero1_mesh(FakeMesh({"data": 1}), "data")
    state.step = 0
    # The data x model layout is ported: a mesh with a model axis passes
    # the guard (the hybrid step itself runs in the 4-rank gang test).
    assert zero._require_zero1_mesh(FakeMesh({"data": 2, "model": 2}), "data") == (2, 2)
    with pytest.raises(ValueError, match="comms_dtype"):
        zero.Zero1Config(comms_dtype="fp8")
    with pytest.raises(ValueError, match="bucket_bytes"):
        zero.Zero1Config(bucket_bytes=2)


# -- the gangs -----------------------------------------------------------------


def _jax_fit(jm, tree, batches, opt, lr):
    j_state = jstate.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(lambda a: jnp.array(a, copy=True), tree),
        tx=jstate.make_optimizer(opt, lr),
    )
    res = jloop.fit(j_state, j_make_translation_loss(jm, 0), batches, epochs=1,
                    mesh=j_data_parallel_mesh(2), log_every=1)
    return _flat(jax.tree.map(np.asarray, res.state.params)), [h["loss"] for h in res.history]


def _key_bias(name: str):
    """The key slice of an attention projection's bias (a fused ``qkv``'s
    second third, a cross-attention ``kv``'s first half), or None."""
    d = TINY["d_model"]
    if name.endswith("self_attn/qkv/bias"):
        return slice(d, 2 * d)
    if name.endswith("cross_attn/kv/bias"):
        return slice(0, d)
    return None


def _split_key_biases(params: dict) -> tuple[dict, dict]:
    """``params`` without the key-bias slices, and those slices."""
    rest, keys = {}, {}
    for k, v in params.items():
        sl = _key_bias(k)
        if sl is None:
            rest[k] = v
        else:
            keep = np.ones(v.shape[0], bool)
            keep[sl] = False
            rest[k], keys[k] = v[keep], v[sl]
    return rest, keys


def test_zero1_gang_equals_replicated_and_jax():
    rng = np.random.default_rng(17)
    batches = _uneven_batches(rng, 8, 8)
    jm, tree = _transformer_params(5)
    start = _flat(tree)
    segments = (np.random.default_rng(3).standard_normal((2, 64)) * 3).astype(np.float32)

    out = Distributor(num_processes=2, platform="cpu", timeout=300, env=GANG_ENV).run(
        "torch_launcher_workers:zero1_variants", TINY, tree, batches, segments
    )
    assert kill_stray_gangs() == 0
    runs = out["runs"]
    flat = {name: _flat(r["params"]) for name, r in runs.items()}

    # float32: every schedule and bucket size, Adam and the implicit form,
    # and K = 4, bit for bit the port's replicated gang.
    for name, base in (("replicated_k4", "replicated"), ("zero1_overlap", "replicated"),
                       ("zero1_serial", "replicated"), ("zero1_overlap_4096", "replicated"),
                       ("zero1_serial_4096", "replicated"),
                       ("adam_zero1_overlap_4096", "adam_replicated"),
                       ("adam_zero1_serial", "adam_replicated"), ("adam_implicit", "adam_replicated")):
        assert runs[name]["step_losses"] == runs[base]["step_losses"], name
        for k in flat[base]:
            np.testing.assert_array_equal(flat[name][k], flat[base][k], err_msg=f"{name} {k}")
    assert runs["zero1_overlap_4096"]["layout"]["buckets"] != runs["zero1_overlap"]["layout"]["buckets"]
    assert {runs[n]["type"] for n in runs} == {"TrainState", "Zero1State", "LeadingShardState"}

    # Within the data-parallel gate of the JAX replicated fit on
    # data_parallel_mesh(2): SGD per tensor; Adam per tensor but the key
    # biases, which are held to Adam's bound 2 * lr * steps.
    j_sgd, j_sgd_loss = _jax_fit(jm, tree, batches, "sgd", SGD_LR)
    errors = _update_errors(flat["zero1_overlap_4096"], j_sgd, start)
    assert max(errors.values()) <= 1.0, max(errors.items(), key=lambda kv: kv[1])
    np.testing.assert_allclose(runs["zero1_overlap_4096"]["history"], j_sgd_loss, rtol=1e-4)
    j_adam, j_adam_loss = _jax_fit(jm, tree, batches, "adam", ADAM_LR)
    np.testing.assert_allclose(runs["adam_zero1_overlap_4096"]["history"], j_adam_loss, rtol=1e-4)
    # Adam normalises each coordinate's step, so float noise in a small
    # gradient moves it by up to lr: the port's Adam-vs-JAX tolerance
    # (tests/test_torch_train.py: params 5e-3), and for the key biases,
    # whose true gradient is 0, Adam's bound 2 * lr * steps.
    got_rest, got_keys = _split_key_biases(flat["adam_zero1_overlap_4096"])
    want_rest, want_keys = _split_key_biases(j_adam)
    for k in want_rest:
        np.testing.assert_allclose(got_rest[k], want_rest[k], atol=ADAM_ATOL, rtol=0, err_msg=k)
    assert len(got_keys) == 3
    for k in want_keys:
        assert np.abs(got_keys[k] - want_keys[k]).max() <= 2 * ADAM_LR * len(batches), k

    # The bf16 wire: each tensor's update within BF16_RTOL of its largest
    # float32 update; the int8 wire trains (its epoch losses fall).
    for k, want in flat["zero1_serial_4096"].items():
        d_want = want.astype(np.float64) - start[k]
        d_got = flat["zero1_bf16"][k].astype(np.float64) - start[k]
        bound = 2 * BF16_U * len(batches) * np.abs(d_want).max() + 1e-7
        assert np.abs(d_got - d_want).max() <= bound, k
    int8 = runs["zero1_int8"]["history"]
    assert len(int8) == 3 and int8[0] > int8[1] > int8[2], int8

    for name, r in runs.items():
        if r["layout"] is None:
            continue
        layout, wire, steps = r["layout"], r["wire"], r["steps"]
        # Optimizer bytes per rank: the padded 1/N (SGD keeps none).
        want_bytes = 2 * 4 * layout["shard_len"] + 4 if name.startswith("adam") else 0
        assert r["opt_bytes"] == [want_bytes] * 2, name
        assert layout["padded"] == 2 * layout["shard_len"] >= layout["total"]
        # The counters are the static wire bytes times the steps.
        assert r["counters"] == {
            "bytes_reduce_scattered": wire["reduce_scatter_bytes"] * steps,
            "bytes_allgathered": wire["allgather_bytes"] * steps,
            "bytes_exposed": wire["bytes_exposed"] * steps,
            "bytes_overlapped": wire["bytes_overlapped"] * steps,
        }, name
        nb = len(layout["buckets"])
        assert r["comms"]["reduce_scatter_calls"] == r["comms"]["allgather_calls"] == nb * steps
    adam_replicated = runs["adam_replicated"]["opt_bytes"][0]
    assert runs["adam_zero1_serial"]["opt_bytes"][0] < adam_replicated / 2 + 4 * 64
    assert runs["adam_implicit"]["opt_bytes"][0] < adam_replicated
    assert runs["replicated_k4"]["comms"]["allreduce_steps"] == len(batches)

    # The real bucket reduce-scatter over gloo equals the JAX one batched
    # over the ranks.
    for dt, got in out["wires"].items():
        want = jax.vmap(lambda s, dt=dt: jzero._reduce_scatter_bucket(s, "data", 2, dt),
                        axis_name="data")(jnp.asarray(segments))
        np.testing.assert_array_equal(got, np.asarray(want).reshape(-1), err_msg=dt)
    assert out["sync"] == {"divergence": 0.0, "fingerprint_equal": True, "opt_state_refused": True}


def test_zero1_recipe_gang_two_plus_two_equals_four_and_crossed_stamps_raise(tmp_path):
    recipe = dict(d_model=32, ffn_hidden=64, num_heads=2, max_len=16, synthetic_n=96,
                  batch_size=8, log_every=0, dropout=0.0)
    out = Distributor(num_processes=2, platform="cpu", timeout=300, dp_mode="zero1",
                      env=GANG_ENV).run(
        "torch_launcher_workers:zero1_recipe_two_plus_two", str(tmp_path), recipe, "cpu"
    )
    assert kill_stray_gangs() == 0
    runs = out["runs"]
    assert {r["type"] for r in runs.values()} == {"Zero1State"}
    assert runs["first"]["resumed_from_step"] is None
    assert runs["second"]["resumed_from_step"] == len(runs["first"]["step_losses"])
    split = runs["first"]["step_losses"] + runs["second"]["step_losses"]
    assert split == runs["whole"]["step_losses"]
    for part in ("params", "opt_state"):
        for k, want in runs["whole"][part].items():
            np.testing.assert_array_equal(runs["second"][part][k], want, err_msg=f"{part} {k}")
    assert "'dp_mode': 'zero1'" in out["crossed"]["replicated"]
    assert "'dp_mode': 'replicated'" in out["crossed"]["replicated"]
    assert "[0, 1024]" in out["crossed"]["bucket_4096"]


def test_implicit_form_shards_moments_on_the_leading_dim_and_refuses_a_2d_checkpoint():
    """``fit(zero1=True)``'s state: a parameter whose leading dimension the
    data axis divides is updated on this rank's rows (its moments that
    shape), any other whole; a rank's checkpoint of a 2-D sharded moment
    raises the JAX ``_detach_local`` error."""
    tree = _transformer_params(3)[1]
    model = load_flax_params(Transformer(TransformerConfig(**TINY)), tree)
    state = zero.shard_moments(TrainState.create(model=model, tx=make_optimizer("adam")),
                               make_mesh({"data": 2}, world=2, device="cpu"))
    sharded = [(p, o) for p, o in zip(state.params, state.owned) if o is not p]
    assert sharded and all(o.shape[0] * 2 == p.shape[0] for p, o in sharded)
    assert all(p.shape[0] % 2 for p, o in zip(state.params, state.owned) if o is p)
    for o in state.owned:
        o.grad = torch.ones_like(o)
    state.optimizer.step()
    assert zero.opt_state_bytes_per_chip(state) < zero.opt_state_bytes(
        [torch.zeros(2, p.numel()) for p in state.params])
    with pytest.raises(ValueError, match="multi-dimensional cross-process sharded array"):
        ckpt.detached_payload(state)


# -- the hybrid data x model mesh ----------------------------------------------


def test_hybrid_plan_owns_one_dm_th_of_the_model():
    shards = [torch.zeros(4, 3), torch.zeros(5)]
    replicated = [torch.zeros(7), torch.zeros(2, 2)]
    plan = zero.make_hybrid_plan(shards, replicated, data_ways=2, model_ways=2, bucket_bytes=16)
    # Shards: 17 elements padded to 18 over 2 data ranks, buckets of 4.
    # Replicated: 11 padded to 12 over 2 x 2, buckets of 4 split by 2.
    assert plan.buckets[:5] == ((0, 4), (4, 8), (8, 12), (12, 16), (16, 18))
    assert plan.buckets[5:] == ((18, 22), (22, 26), (26, 30))
    assert plan.subs == (1,) * 5 + (2,) * 3
    assert plan.offsets == (0, 12, 18, 25)
    assert plan.shard_len == 18 // 2 + 12 // 4
    assert [plan.owned(k) for k in range(len(plan.buckets))] == [2, 2, 2, 2, 1, 1, 1, 1]


def test_four_rank_hybrid_zero1_equals_the_replicated_hybrid_and_jax():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((16, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 16)
    layers, steps, lr, bucket = (4, 8, 8, 4), 5, 1e-2, 64
    jm = JMLP(layers=layers, tp_rules=True)
    boxed = jm.init(jax.random.key(0), jnp.asarray(feats[:1]))["params"]
    tree = jax.tree.map(np.array, fnn.unbox(boxed))

    recipe = {**RECIPE, "device": "cpu", "batch_size": 16, "num_heads": 4}
    out = Distributor(num_processes=4, platform="cpu", timeout=600, env=GANG_ENV).run(
        "torch_launcher_workers:tp_hybrid_four_rank", layers, tree, (feats, labels), steps, lr,
        bucket, None, recipe,
    )
    assert kill_stray_gangs() == 0
    assert out["coords"] == [{"data": 0, "model": 0}, {"data": 0, "model": 1},
                             {"data": 1, "model": 0}, {"data": 1, "model": 1}]

    # The JAX references on a {data: 2, model: 2} mesh of 4 virtual devices.
    mesh = j_make_mesh({"data": 2, "model": 2}, devices=jax.devices()[:4])
    loss_fn = jloop.classification_loss(jm.apply)
    batch = (jnp.asarray(feats), jnp.asarray(labels))

    def run(step, state):
        sharded = j_shard_batch(mesh, batch)
        for i in range(steps):
            state, loss, _ = step(state, sharded, jax.random.fold_in(jax.random.key(9), i))
        return _flat_tree(jax.tree.map(np.asarray, jax.device_get(state.params))), float(loss)

    ref = j_shard_state(jstate.TrainState.create(
        apply_fn=jm.apply, params=jax.tree.map(jnp.copy, boxed), tx=jstate.make_optimizer("adam", lr),
    ), mesh)
    ref_params, ref_loss = run(jloop.make_train_step(loss_fn), ref)
    zs = jzero.init_sharded(apply_fn=jm.apply, params=jax.tree.map(jnp.copy, boxed),
                            tx=jstate.make_optimizer("adam", lr), mesh=mesh,
                            config=jzero.Zero1Config(bucket_bytes=bucket))
    z_params, z_loss = run(jzero.make_zero1_step(loss_fn, mesh, zs), zs)

    rep = _flat_tree(out["replicated"]["params"])
    for path, w in ref_params.items():
        np.testing.assert_allclose(rep[path], w, rtol=0, atol=1e-5, err_msg=path)
    assert out["replicated"]["loss"] == pytest.approx(ref_loss, abs=1e-5)
    # fit(zero1=True) with a model axis: the replicated hybrid's bits,
    # the moments of leaves whose leading dim the data axis divides
    # halved.
    imp = out["implicit"]
    assert imp["types"] == ["LeadingShardState"] * 4
    for path in rep:
        np.testing.assert_array_equal(_flat_tree(imp["params"])[path], rep[path], err_msg=path)
    assert all(b < out["replicated_bytes"] for b in imp["opt_bytes"])
    for name in ("fp32_overlap", "fp32_serial"):
        run_ = out[name]
        got = _flat_tree(run_["params"])
        for path in rep:  # bit for bit the replicated hybrid, moments too
            np.testing.assert_array_equal(got[path], rep[path], err_msg=f"{name} {path}")
            np.testing.assert_allclose(got[path], z_params[path], rtol=0, atol=1e-5)
        assert run_["moments_equal"] == [True] * 4
        assert run_["loss"] == pytest.approx(z_loss, abs=1e-5)
        # Each rank keeps 1/(D·M) of the moments (+ the padding and one
        # step count), as the JAX figure's joint (data, model) sharding.
        for b, n in zip(run_["opt_bytes"], run_["shard_len"]):
            assert b == 2 * 4 * n + 4
            assert b <= out["replicated_bytes"] / 4 + 64
    fp32 = out["fp32_overlap"]["wire_fp32"]
    bf16 = out["bf16"]
    for path, w in ref_params.items():
        np.testing.assert_allclose(_flat_tree(bf16["params"])[path], w, rtol=0, atol=1e-2)
    assert bf16["wire"]["reduce_scatter_bytes"] == fp32["reduce_scatter_bytes"] // 2
    assert bf16["wire"]["allgather_bytes"] == fp32["allgather_bytes"]
    i8 = out["int8"]
    for path, w in ref_params.items():
        got = _flat_tree(i8["params"])[path]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, w, rtol=0, atol=0.2)
    n_buckets = len(i8["layout"]["buckets"])
    assert i8["wire"]["reduce_scatter_bytes"] == fp32["reduce_scatter_bytes"] // 4 + 4 * n_buckets
    assert i8["layout"]["subs"] and set(i8["layout"]["subs"]) == {1, 2}
    # The recipe under the gang's MLSPARK_DP_MODE=zero1 contract on
    # {data: 2, model: 2}: the hybrid ZeRO-1 state, the replicated run's
    # step losses bit for bit.
    rec = out["recipe"]
    assert rec["zero1"]["type"] == "Zero1State" and rec["replicated"]["type"] == "TrainState"
    assert rec["zero1"]["mesh"] == rec["replicated"]["mesh"] == {"data": 2, "model": 2}
    assert rec["zero1"]["step_losses"] == rec["replicated"]["step_losses"]
