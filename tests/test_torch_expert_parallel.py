"""Expert parallelism of the port (``parallel.expert_parallel``, the MoE's
sharded forward in ``models/moe.py`` and the two-axis placement of
``parallel.tensor_parallel``) against the JAX package's MoE and its
``fit`` on expert meshes of the virtual CPU devices.

In process, each rank a thread (``tests/torch_thread_line.run_mesh``)
running the port's own code: the sharded ``MoEFeedForward`` on
``{expert: 2}``, ``{expert: 4}``, ``{expert: 2, model: 2}`` and
``{model: 2}`` — its output, ``moe_aux`` and the gradients of ``x``,
``router``, ``w_up`` and ``w_down`` (gathered) against the Flax module's
``jax.value_and_grad`` at atol 1e-5, with a ``valid`` mask, at capacity
factor 1.25 and at 0.5 (tokens drop). The trap the sharded forward
avoids: ``copy_to_expert`` on a replicated input (the router's, or the
aux loss's probabilities) adds N − 1 extra copies of that path's
gradient. Shard-then-gather bit for bit and ``global_sq_norm`` equal to
the whole model's for a leaf on the expert axis only, the model axis
only, both and neither; ``shard_state``'s moments; the mesh's layout.

One 4-rank gloo gang (``torch_launcher_workers:ep_four_rank``), spawned
once by a module fixture while the JAX oracles compile in the main
thread: 3 SGD steps of the MoE Transformer's ``fit(mesh=)`` on
``{expert: 4}``, ``{data: 2, expert: 2}`` and ``{expert: 2, model: 2}``
against the JAX ``fit`` on the same mesh shapes (parameters gathered,
atol 1e-5; at 3 steps per call the bits of single steps), and
``train_translator(moe_experts=4, expert_parallel=2,
model_parallel=2, checkpoint_dir=)`` resumed with ``w_up`` still expert-
and model-sharded (the counterpart of ``tests/test_checkpoint.py``'s
TP × EP resume), ``train_translator(moe_experts=4, model_parallel=2)``
with no expert axis, and a resume on another expert size refused.
"""

from __future__ import annotations

import copy
import dataclasses
import threading

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from machine_learning_apache_spark_tpu.models.moe import MoEFeedForward as JMoE
from machine_learning_apache_spark_tpu.models.transformer import (
    Transformer as JTransformer,
    TransformerConfig as JConfig,
)
from machine_learning_apache_spark_tpu.parallel.mesh import make_mesh as j_make_mesh
from machine_learning_apache_spark_tpu.recipes.translation import (
    make_translation_loss as j_make_translation_loss,
)
from machine_learning_apache_spark_tpu.train import loop as jloop
from machine_learning_apache_spark_tpu.train import state as jstate
from machine_learning_apache_spark_tpu_torch.config import MeshConfig
from machine_learning_apache_spark_tpu_torch.launcher import Distributor, kill_stray_gangs
from machine_learning_apache_spark_tpu_torch.models.moe import MoEFeedForward
from machine_learning_apache_spark_tpu_torch.parallel import (
    ExpertAxis,
    copy_to_expert,
    make_mesh,
)
from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel as tp
from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
from torch_host import one_thread  # noqa: F401 - autouse: one CPU thread a test process
from torch_thread_line import run_mesh

GANG_ENV = {"OMP_NUM_THREADS": "1"}
ATOL = 1e-5
D, F, E = 32, 64, 4
# Odd target vocabulary: the {expert: 2, model: 2} mesh pads the LM head.
TINY = dict(src_vocab_size=37, trg_vocab_size=41, d_model=D, ffn_hidden=F, num_heads=4,
            num_layers=1, max_len=12, dropout=0.0, logit_pad=1, moe_experts=E)
RECIPE = dict(data_root="assets/fixtures", d_model=D, ffn_hidden=F, num_heads=4, max_len=24,
              epochs=1, batch_size=32, dropout=0.0, log_every=0, seed=3)
LR = 0.5
MOE_MESHES = {"expert2": {"expert": 2}, "expert4": {"expert": 4},
              "expert2 model2": {"expert": 2, "model": 2}, "model2": {"model": 2}}
GANG_MESHES = {"expert4": {"data": 1, "expert": 4}, "data2 expert2": {"data": 2, "expert": 2},
               "expert2 model2": {"data": 1, "expert": 2, "model": 2}}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


# -- the sharded MoE FFN, in process ------------------------------------------------


def _moe_case(capacity_factor):
    """The Flax module's params, an input with a ``valid`` mask, a
    cotangent, and the JAX loss ``sum(out·ct) + aux``'s value, output,
    aux and gradients."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 10, D)).astype(np.float32)
    valid = np.ones((3, 10), bool)
    valid[1, 6:] = False
    valid[2, 3:] = False
    ct = rng.standard_normal((3, 10, D)).astype(np.float32)
    jm = JMoE(D, F, E, capacity_factor=capacity_factor)
    params = jax.tree.map(np.asarray, fnn.unbox(
        jm.init(jax.random.key(3), jnp.asarray(x), valid=jnp.asarray(valid))["params"]))

    def loss(p, xx):
        out, state = jm.apply({"params": p}, xx, valid=jnp.asarray(valid), mutable=["losses"])
        aux = state["losses"]["moe_aux"][0]
        return jnp.sum(out * ct) + aux, (out, aux)

    (_, (out, aux)), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    want = {"out": np.asarray(out), "aux": np.asarray(aux), "x": np.asarray(g_x),
            **{k: np.asarray(v) for k, v in g_params.items()}}
    return params, x, valid, ct, want


def _port_moe(params, capacity_factor, cls=MoEFeedForward):
    m = cls(D, F, E, capacity_factor=capacity_factor)
    with torch.no_grad():
        for name, value in params.items():
            getattr(m, name).copy_(torch.from_numpy(np.array(value)))
    return m


def _sharded_run(shape, params, x, valid, ct, capacity_factor, cls=MoEFeedForward, loss=None):
    """Every rank's output, aux and gradients (the sharded weights'
    gathered to full) of the port's MoE sharded over a thread mesh."""

    def rank(mesh):
        m = tp.shard_params(_port_moe(params, capacity_factor, cls), mesh)
        xx = torch.from_numpy(x).requires_grad_()
        aux: list = []
        out = m(xx, valid=torch.from_numpy(valid), aux=aux)
        total = (out * torch.from_numpy(ct)).sum() + aux[0] if loss is None else loss(out, aux[0])
        total.backward()
        grads = {name: tp.gather_full(p, p.grad).numpy() for name, p in m.named_parameters()}
        return {"out": out.detach().numpy(), "aux": aux[0].detach().numpy(),
                "x": xx.grad.numpy(), **grads, "w_up_shape": tuple(m.w_up.shape)}

    return run_mesh(shape, rank)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5-drops"])
@pytest.mark.parametrize("mesh", list(MOE_MESHES))
def test_sharded_moe_equals_the_jax_value_and_grad(mesh, cf):
    params, x, valid, ct, want = _moe_case(cf)
    shape = MOE_MESHES[mesh]
    for got in _sharded_run(shape, params, x, valid, ct, cf):
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=0, atol=ATOL, err_msg=f"{mesh} {key}")
        n, m = shape.get("expert", 1), shape.get("model", 1)
        assert got["w_up_shape"] == (E // n, D, F // m)
    if cf == 0.5:
        # Tokens dropped: some valid token's output is exactly zero.
        assert np.any(np.all(want["out"][valid] == 0.0, axis=-1))


class _RouterInputCopied(MoEFeedForward):
    """The trap: the router's input wrapped in ``copy_to_expert``."""

    def route(self, x):
        return super().route(x if self.ep is None else copy_to_expert(x, self.ep))


class _RouterInputDetached(MoEFeedForward):
    """No gradient through the router's input: what the rest of ``x``'s
    gradient is."""

    def route(self, x):
        return super().route(x.detach())


class _AuxProbsCopied(MoEFeedForward):
    """The trap: the aux loss's probabilities wrapped in ``copy_to_expert``."""

    def balance_loss(self, probs, onehot, vf):
        return super().balance_loss(
            probs if self.ep is None else copy_to_expert(probs, self.ep), onehot, vf)


@pytest.mark.parametrize("n", [2, 4])
def test_copy_to_expert_on_a_replicated_input_multiplies_its_gradient(n):
    """The router and the aux loss run replicated on every rank of the
    line, so their gradients are already whole there: an all-reduce of
    them adds N - 1 extra copies. On the router's input, ``x``'s gradient
    gets N times the router path's part; on the aux loss's probabilities,
    the router's gradient gets N times the aux loss's part. The sharded
    forward wraps neither, and matches the JAX gradients."""
    cf = 1.25
    params, x, valid, ct, want = _moe_case(cf)
    shape = {"expert": n}
    right = _sharded_run(shape, params, x, valid, ct, cf)[0]
    np.testing.assert_allclose(right["x"], want["x"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(right["router"], want["router"], rtol=0, atol=ATOL)

    router_path = want["x"] - _sharded_run({"expert": 1}, params, x, valid, ct, cf,
                                           _RouterInputDetached)[0]["x"]
    assert np.abs(router_path).max() > 1e-3
    copied = _sharded_run(shape, params, x, valid, ct, cf, _RouterInputCopied)[0]
    np.testing.assert_allclose(copied["x"], want["x"] + (n - 1) * router_path, rtol=0, atol=ATOL)
    assert np.abs(copied["x"] - want["x"]).max() > 1e-3

    aux_part = _sharded_run({"expert": 1}, params, x, valid, ct, cf,
                            loss=lambda out, aux: aux)[0]["router"]
    assert np.abs(aux_part).max() > 1e-3
    copied = _sharded_run(shape, params, x, valid, ct, cf, _AuxProbsCopied)[0]
    np.testing.assert_allclose(copied["router"], want["router"] + (n - 1) * aux_part,
                               rtol=0, atol=ATOL)
    assert np.abs(copied["router"] - want["router"]).max() > 1e-3


# -- placement on two axes, in process ---------------------------------------------


class _Leaves(nn.Module):
    """One leaf per placement on an ``{expert, model}`` mesh."""

    param_axes = {"expert_only": ("expert", "embed"), "model_only": ("embed", "mlp"),
                  "both": ("expert", "embed", "mlp"), "neither": ("embed", None)}

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(5)
        for name, shape in (("expert_only", (4, 6)), ("model_only", (6, 8)),
                            ("both", (4, 6, 8)), ("neither", (6, 3))):
            setattr(self, name, nn.Parameter(torch.randn(shape, generator=g)))


LEAF_AXES = {"expert_only": ["expert"], "model_only": ["model"],
             "both": ["expert", "model"], "neither": []}


@pytest.mark.parametrize("leaf", list(LEAF_AXES))
def test_shard_then_gather_is_bit_exact_and_the_norm_whole(leaf):
    full = _Leaves()
    whole = float(torch.sum(torch.square(getattr(full, leaf).detach().double())))

    def rank(mesh):
        m = tp.shard_params(copy.deepcopy(full), mesh)
        p = getattr(m, leaf)
        return {"axes": [line.AXIS for line, _, _ in getattr(p, "shards", ())],
                "shape": tuple(p.shape), "gathered": tp.gather_full(p),
                "norm": float(tp.global_sq_norm([p], [p.detach()])),
                "all": float(tp.global_sq_norm(list(m.parameters()),
                                               [q.detach() for q in m.parameters()]))}

    everything = sum(float(torch.sum(torch.square(q.detach().double())))
                     for q in full.parameters())
    for got in run_mesh({"expert": 2, "model": 2}, rank):
        assert got["axes"] == LEAF_AXES[leaf]
        want = getattr(full, leaf).detach()
        ways = {"expert": 2, "model": 2}
        assert np.prod(got["shape"]) == want.numel() // np.prod(
            [ways[a] for a in LEAF_AXES[leaf]] or [1])
        assert torch.equal(got["gathered"], want)
        assert got["norm"] == pytest.approx(whole, rel=1e-6)
        assert got["all"] == pytest.approx(everything, rel=1e-6)


def test_shard_state_slices_adam_moments_as_their_parameters():
    full = _Leaves()
    state = TrainState.create(model=full, tx=make_optimizer("adam", 1e-2))
    for p in full.parameters():
        p.grad = torch.ones_like(p)
    state.apply_gradients()
    moments = {n: {k: v.clone() for k, v in state.optimizer.state[p].items()
                   if isinstance(v, torch.Tensor) and v.shape == p.shape}
               for n, p in full.named_parameters()}

    def rank(mesh):
        st = copy.deepcopy(state)
        st = tp.shard_state(st, mesh)
        ok = True
        for name, p in st.model.named_parameters():
            for key, full_value in moments[name].items():
                ok &= torch.equal(st.optimizer.state[p][key], tp.local_slice(p, full_value))
                ok &= st.optimizer.state[p][key].shape == p.shape
        return ok and tp.is_sharded(st.model) and st.mesh is mesh

    assert all(run_mesh({"expert": 2, "model": 2}, rank))


def test_expert_mesh_lays_ranks_out_canonically():
    mesh = make_mesh({"model": 2, "expert": 2, "data": 2}, world=8)
    assert mesh.shape == {"data": 2, "expert": 2, "model": 2}
    # rank = (data · N + expert) · M + model
    assert mesh.axis_ranks("expert") == [0, 2] and mesh.axis_ranks("model") == [0, 1]
    assert mesh.axis_ranks("data") == [0, 4]
    assert make_mesh({"expert": -1}, world=4).shape == {"expert": 4}
    axis = ExpertAxis(make_mesh({"expert": 4}, world=4))
    assert (axis.size, axis.index, axis.experts(8)) == (4, 0, slice(0, 2))
    # MeshConfig's expert field reaches the mesh.
    cfg = MeshConfig(data=1, expert=2, model=2)
    assert make_mesh(dataclasses.asdict(cfg), world=4).shape == {
        "data": 1, "pipeline": 1, "expert": 2, "seq": 1, "model": 2}


def test_zero1_and_seq_beside_the_expert_axis_are_refused_as_in_jax():
    from machine_learning_apache_spark_tpu.parallel.zero import (
        _require_zero1_mesh as j_require_zero1_mesh,
    )
    from machine_learning_apache_spark_tpu_torch.parallel import zero

    with pytest.raises(ValueError) as jerr:
        j_require_zero1_mesh(j_make_mesh({"data": 2, "expert": 2},
                                         devices=jax.devices()[:4]), "data")
    with pytest.raises(ValueError) as err:
        zero._require_zero1_mesh(make_mesh({"data": 2, "expert": 2}, world=4), "data")
    assert str(err.value) == str(jerr.value) and "'expert': 2" in str(err.value)
    # A seq axis beside the expert axis now builds; the ZeRO-1 step on it
    # is refused as the JAX package refuses it.
    axes = {"data": 2, "expert": 2, "seq": 2}
    with pytest.raises(ValueError) as jerr:
        j_require_zero1_mesh(j_make_mesh(axes, devices=jax.devices()[:8]), "data")
    with pytest.raises(ValueError) as err:
        zero._require_zero1_mesh(make_mesh(axes, world=8), "data")
    assert str(err.value) == str(jerr.value) and "'seq': 2" in str(err.value)


def test_gang_report_rolls_up_the_expert_line():
    from machine_learning_apache_spark_tpu_torch.telemetry import aggregate

    events = [{"kind": "counter", "name": f"comms.ep_allreduce_{what}", "rank": r, "value": v,
               "attrs": {"steps": 2}}
              for r in (0, 1) for what, v in (("calls", 12), ("bytes", 600.0),
                                              ("window_seconds", 0.01))]
    report = aggregate.comms_report(events)
    assert report["expert"] == {"ep_allreduce": {
        r: {"calls_per_step": 6.0, "bytes_per_step": 300.0, "window_ms_per_step": 5.0}
        for r in (0, 1)}}
    assert "sequence" not in report and "pipeline" not in report
    md = aggregate.render_markdown({"ranks": [0, 1], "event_count": len(events), "phases": {},
                                    "skew": {}, "comms": report})
    assert "| expert line | rank | calls/step | bytes/step | window ms/step |" in md
    assert "| ep_allreduce | 1 | 6.0 | 300.0 | 5.0 |" in md


# -- the gang ---------------------------------------------------------------------


def _inputs():
    rng = np.random.default_rng(13)
    jm = JTransformer(JConfig(**TINY))
    src = rng.integers(1, TINY["src_vocab_size"], (8, 10))
    trg = rng.integers(1, TINY["trg_vocab_size"], (8, 9))
    boxed = jax.jit(jm.init)(jax.random.key(2), src, trg[:, :-1])["params"]
    batches = []
    for _ in range(3):
        s = rng.integers(1, TINY["src_vocab_size"], (8, 10))
        t = rng.integers(1, TINY["trg_vocab_size"], (8, 9))
        s[1, 7:] = 0
        t[2, 5:] = 0
        batches.append((s, t))
    return jm, boxed, batches


def _jax_fit(jm, boxed, batches, axes):
    mesh = j_make_mesh(axes, devices=jax.devices()[:int(np.prod(list(axes.values())))])
    state = jstate.TrainState.create(apply_fn=jm.apply, params=jax.tree.map(jnp.copy, boxed),
                                     tx=jstate.make_optimizer("sgd", LR))
    res = jloop.fit(state, j_make_translation_loss(jm, 0), batches, epochs=1,
                    rng=jax.random.key(0), mesh=mesh, log_every=0, emit=lambda s: None)
    return _flat(jax.tree.map(np.asarray, fnn.unbox(res.state.params))), res


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The gang's results and the JAX oracles, computed while it runs."""
    jm, boxed, batches = _inputs()
    tree = jax.tree.map(np.array, fnn.unbox(boxed))
    got: dict = {}

    def run():
        try:
            got["out"] = Distributor(num_processes=4, platform="cpu", timeout=600, env=GANG_ENV).run(
                "torch_launcher_workers:ep_four_rank", TINY, tree, batches, LR, RECIPE,
                str(tmp_path_factory.mktemp("ep")))
        except BaseException as e:  # noqa: BLE001 - re-raised in the main thread
            got["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    try:
        oracle = {name: _jax_fit(jm, boxed, batches, axes) for name, axes in GANG_MESHES.items()}
    finally:
        thread.join()
    if "error" in got:
        raise got["error"]
    assert kill_stray_gangs() == 0
    return got["out"], oracle


@pytest.mark.parametrize("mesh", list(GANG_MESHES))
def test_ep_fit_in_the_gang_equals_the_jax_fit(gang, mesh):
    out, oracle = gang
    got, (want, j_res) = out["fit"][mesh], oracle[mesh]
    params = _flat(got["params"])
    assert params.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(params[path], w, rtol=0, atol=ATOL, err_msg=f"{mesh} {path}")
    np.testing.assert_allclose(np.mean(got["step_losses"]), j_res.final_loss, rtol=1e-5)
    assert got["in_sync"] == "ok"
    axes = GANG_MESHES[mesh]
    n, m = axes["expert"], axes.get("model", 1)
    assert set(got["w_up_shapes"]) == {(E // n, TINY["d_model"], TINY["ffn_hidden"] // m)}
    comms = got["comms"]
    # Each step: the combine forward and x's and the gate's gradients
    # backward, at the encoder's and the decoder's MoE.
    assert comms["ep_allreduce_steps"] == 3 and comms["ep_allreduce_calls"] == 3 * 2 * 3
    assert comms["ep_allreduce_bytes"] > 0
    if m > 1:
        assert comms["tp_allreduce_calls"] > 0


def test_k_steps_per_call_on_an_expert_mesh_train_the_bits_of_single_steps(gang):
    out, _ = gang
    one, k3 = out["fit"]["data2 expert2"], out["k3"]
    assert k3["step_losses"] == one["step_losses"]
    a, b = _flat(one["params"]), _flat(k3["params"])
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_tp_ep_recipe_resumes_and_keeps_both_shardings(gang):
    out, _ = gang
    first, second = out["recipe"]["first"], out["recipe"]["second"]
    assert first["resumed_from_step"] is None
    assert second["resumed_from_step"] > 0
    for run in (first, second):
        assert run["mesh"] == {"data": 1, "expert": 2, "model": 2}
        assert run["w_up_axes"] == ["expert", "model"]
        assert run["w_up_shape"] == (2, RECIPE["d_model"], RECIPE["ffn_hidden"] // 2)
        assert run["qkv_axes"] == ["model"]
        assert np.isfinite(run["final_loss"]) and 1.0 <= run["moe_aux"] <= 4.0
        assert run["comms"]["ep_allreduce_calls"] > 0 and run["comms"]["tp_allreduce_calls"] > 0
    tp_moe = out["tp_moe"]
    assert tp_moe["mesh"] == {"data": 2, "model": 2}
    assert np.isfinite(tp_moe["final_loss"]) and 1.0 <= tp_moe["moe_aux"] <= 4.0
    assert tp_moe["comms"]["tp_allreduce_calls"] > 0 and "ep_allreduce_calls" not in tp_moe["comms"]
    assert "train/reshard.py" in out["crossed"] and "'expert': 4" in out["crossed"], out["crossed"]
