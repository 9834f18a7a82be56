"""Gang worker functions for the port's launcher, data-parallel and
session tests: each runs in every rank of a ``Distributor`` gang (by
reference, ``torch_launcher_workers:<name>``), and rank 0's return
value comes back to the test. Like the port itself, this module imports
torch and numpy, never JAX.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist


def _rank_world() -> tuple[int, int]:
    return dist.get_rank(), dist.get_world_size()


def ok(x):
    """Rank 0's view of the gang it ran in."""
    from machine_learning_apache_spark_tpu_torch.launcher.coordinator import (
        current_backend,
        current_device,
    )

    rank, world = _rank_world()
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    return {
        "rank": rank, "world": world, "x": x, "sum": float(t),
        "backend": current_backend(), "device": str(current_device()),
    }


def boom():
    rank, _ = _rank_world()
    if rank == 1:
        raise RuntimeError("boom from rank 1")
    return "unreachable for the gang"


def fit_fault():
    """A small MLP's ``fit(mesh=)`` in which rank 1 raises at step 2 (the
    ``MLSPARK_FAULTS`` plan the test hands the gang), while rank 0 goes on
    into that step's all-reduce."""
    from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh
    from machine_learning_apache_spark_tpu_torch.train.loop import classification_loss, fit
    from machine_learning_apache_spark_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )

    rank, _ = _rank_world()
    rng = np.random.default_rng(rank)
    batches = [
        (rng.normal(size=(8, 4)).astype(np.float32), rng.integers(0, 3, 8))
        for _ in range(6)
    ]
    state = TrainState.create(model=MLP((4, 8, 3)), tx=make_optimizer("sgd", 0.1))
    fit(state, classification_loss(), batches, epochs=1,
        mesh=data_parallel_mesh(device="cpu"), log_every=0)
    return "unreachable for the gang"


def flaky():
    """Rank 1 fails on the gang's first attempt only."""
    rank, world = _rank_world()
    attempt = int(os.environ["MLSPARK_GANG_ATTEMPT"])
    if rank == 1 and attempt == 0:
        raise RuntimeError("first attempt fails on rank 1")
    return {"attempt": attempt, "world": world}


def unpicklable():
    return lambda: None


def _rows(batch, rank: int, world: int):
    """This rank's contiguous slice of a global batch — the rows the JAX
    mesh's data axis gives device ``rank``."""
    n = len(batch[0]) // world
    return tuple(np.asarray(a)[rank * n:(rank + 1) * n] for a in batch)


def mlp_dp_steps(flax_params, layers, batches, lr):
    """SGD steps of ``make_data_parallel_step`` over the given global
    batches (each rank its half), from the given Flax weights. Returns rank
    0's parameters, the replicas' divergence, whether a perturbed rank 1
    made ``assert_replicas_in_sync`` raise, and whether the ranks' dropout
    generators in ``fit(mesh=)`` drew differently."""
    from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
    from machine_learning_apache_spark_tpu_torch.parallel import (
        assert_replicas_in_sync,
        data_parallel_mesh,
        make_data_parallel_step,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import (
        classification_loss,
        fit,
        to_device,
    )
    from machine_learning_apache_spark_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )
    from machine_learning_apache_spark_tpu_torch.weights import (
        export_flax_params,
        load_flax_params,
    )

    rank, world = _rank_world()
    mesh = data_parallel_mesh(device="cpu")
    model = load_flax_params(MLP(tuple(layers)), flax_params)
    state = TrainState.create(model=model, tx=make_optimizer("sgd", lr))
    step = make_data_parallel_step(classification_loss(), mesh)
    losses = []
    for batch in batches:
        _, loss, _ = step(state, to_device(_rows(batch, rank, world), torch.device("cpu")), None)
        losses.append(float(loss))
    divergence = assert_replicas_in_sync(state, mesh=mesh)
    params = export_flax_params(model) if rank == 0 else None
    perturbed_raises = False
    if rank == 1:
        with torch.no_grad():
            next(model.parameters()).add_(1.0)
    try:
        assert_replicas_in_sync(state, mesh=mesh)
    except AssertionError:
        perturbed_raises = True

    draws: list[torch.Tensor] = []

    def probe(module, batch, rng):
        draws.append(torch.rand(8, generator=rng))
        return classification_loss()(module, batch, rng)

    fit(state, probe, [_rows(batches[0], rank, world)], epochs=1, mesh=mesh,
        rng=torch.Generator().manual_seed(7), log_every=0)
    gathered = [torch.zeros(8) for _ in range(world)]
    dist.all_gather(gathered, draws[0])
    return {
        "params": params,
        "losses": losses,
        "divergence": divergence,
        "perturbed_raises": perturbed_raises,
        "dropout_draws_differ": not torch.equal(gathered[0], gathered[1]),
        "grad_allreduce_steps": step.comms.steps,
    }


def mt_dp_fit(cfg_kwargs, flax_params, batches, eval_batches, lr, accumulate=(1,)):
    """``fit(mesh=)`` of a tiny Transformer over the given global batches
    (each rank its half) with SGD, once per accumulation count in
    ``accumulate``, each from the given Flax weights, dropout off; then
    ``evaluate(mesh=)`` after the first. Returns rank 0's step losses,
    epoch history, final parameters and comms totals per run, and the
    eval."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate, fit
    from machine_learning_apache_spark_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )
    from machine_learning_apache_spark_tpu_torch.weights import (
        export_flax_params,
        load_flax_params,
    )

    rank, world = _rank_world()
    mesh = data_parallel_mesh(device="cpu")
    cfg = TransformerConfig(**cfg_kwargs)
    runs, metrics = {}, None
    for k in accumulate:
        model = load_flax_params(Transformer(cfg), flax_params)
        state = TrainState.create(
            model=model, tx=make_optimizer("sgd", lr, accumulate_steps=k)
        )
        result = fit(
            state, make_translation_loss(cfg.pad_id),
            [_rows(b, rank, world) for b in batches],
            epochs=1, mesh=mesh, log_every=0, sync_check_every=1,
        )
        if metrics is None:
            metrics = evaluate(
                state, make_translation_loss(cfg.pad_id, train=False),
                [_rows(b, rank, world) for b in eval_batches], mesh=mesh,
            )
        runs[k] = {
            "step_losses": result.step_losses,
            "history": result.history,
            "params": export_flax_params(model),
            "comms": result.comms,
        }
    return {"runs": runs, "eval": metrics}


def session_cnn(fixtures: str):
    """The flagship path's shape on the host: a session whose conf names
    two executors, then ``train_cnn`` under the gang, as
    ``examples/distributed_cnn.py`` runs it."""
    from machine_learning_apache_spark_tpu_torch import Session
    from machine_learning_apache_spark_tpu_torch.recipes.cnn import train_cnn

    spark = Session.builder.appName("DistributedCNN").getOrCreate()
    out = train_cnn(
        device="cpu", data_root=fixtures, dataset="cifar10", hidden_units=4,
        epochs=1, log_every=0,
    )
    out["executor_count"] = spark.executor_count
    out["process_index"] = spark.process_index
    return out


def card_gang(cfg_kwargs, batches):
    """On the card: a tiny Transformer's ``fit(mesh=)`` + ``evaluate`` over
    the given global batches (each rank its half), dropout off. Every
    rank's backend, device, parameters' device, steps and kernel launches
    (counted in its own process), in rank order."""
    from machine_learning_apache_spark_tpu_torch.launcher.coordinator import (
        current_backend,
        current_device,
    )
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import (
        assert_replicas_in_sync,
        data_parallel_mesh,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate, fit
    from machine_learning_apache_spark_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )

    rank, world = _rank_world()
    cfg = TransformerConfig(**cfg_kwargs)
    model = Transformer(cfg, generator=torch.Generator().manual_seed(0)).to("cuda")
    state = TrainState.create(model=model, tx=make_optimizer("adam", 1e-3))
    mesh = data_parallel_mesh()
    hop.reset_launches()
    result = fit(state, make_translation_loss(cfg.pad_id),
                 [_rows(b, rank, world) for b in batches], epochs=1, mesh=mesh, log_every=0)
    train_launches = dict(hop.LAUNCHES)
    evaluate(state, make_translation_loss(cfg.pad_id, train=False),
             [_rows(b, rank, world) for b in batches[:1]], mesh=mesh)
    report = dict(
        rank=rank, backend=current_backend(), device=str(current_device()),
        param_device=str(next(model.parameters()).device), steps=state.step,
        train_launches=train_launches, launches=dict(hop.LAUNCHES),
        divergence=assert_replicas_in_sync(state), losses=result.step_losses,
    )
    out = [None] * world
    dist.all_gather_object(out, report)
    return out


def _worker_device(device):
    """``device`` when given, else the gang's device for this rank (the
    host outside a gang)."""
    from machine_learning_apache_spark_tpu_torch.launcher.coordinator import current_device

    if device is not None:
        return torch.device(device)
    return current_device() or torch.device("cpu")


def _drill_result(rank, res, world=None):
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params

    out = {
        "rank": rank,
        "final_loss": res.final_loss,
        "resumed_step": res.resumed_step,
        "epochs_run": len(res.history),
        "step_losses": list(res.step_losses),
        "params": export_flax_params(res.state.model),
    }
    if world is not None:
        out["world"] = world
    return out


def fault_drill_train(workdir, epochs=4, checkpoint_every=1, device=None):
    """Restart-safe training workload for the fault drill (the port of the
    JAX drill's worker): deterministic per-rank MLP training with per-rank
    checkpoint directories (``<workdir>/ckpt_r<rank>``, the group
    convention) and ``fit(resume=True)``. When the gang is killed mid-run
    and retried, every rank resumes from the group-agreed step and the
    final loss must match an unfaulted run. No mesh: each rank trains the
    same data on its own, as in the JAX worker."""
    from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
    from machine_learning_apache_spark_tpu_torch.parallel.mesh import process_index
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import CheckpointManager
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.losses import cross_entropy
    from machine_learning_apache_spark_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )

    rank = process_index()
    dev = _worker_device(device)
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(32, 4)).astype(np.float32)
    labels = rng.integers(0, 3, 32).astype(np.int64)
    loader = [
        (feats[i * 8:(i + 1) * 8], labels[i * 8:(i + 1) * 8]) for i in range(4)
    ]
    model = MLP((4, 8, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    state = TrainState.create(model=model, tx=make_optimizer("sgd", 0.1))

    def loss_fn(module, batch, step_rng):
        del step_rng
        x, y = batch
        return cross_entropy(module(x), y), {}

    with CheckpointManager(os.path.join(workdir, f"ckpt_r{rank}")) as ckpt:
        res = fit(
            state, loss_fn, loader, epochs=epochs, checkpointer=ckpt,
            checkpoint_every=checkpoint_every, resume=True, log_every=0,
        )
    out = _drill_result(rank, res)
    if dist.is_initialized():
        # Every rank's outcome, in rank order: the crashed rank's resume
        # is the one the drill is about.
        out["ranks"] = [None] * dist.get_world_size()
        dist.all_gather_object(out["ranks"], _drill_result(rank, res))
    return out


def fault_drill_train_mesh(
    workdir, epochs=4, checkpoint_every=1, global_batch=8, steps_per_epoch=4,
    device=None,
):
    """The fault drill's mesh twin: data-parallel MLP training over the
    gang (each rank its contiguous rows of every global batch, the
    gradients all-reduced), Adam, per-rank checkpoint directories and
    ``fit(resume=True)``. A retried gang resumes the group-agreed step on
    every rank and must finish with the unfaulted gang's parameters."""
    from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import CheckpointManager
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.losses import cross_entropy
    from machine_learning_apache_spark_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )

    rank, world = _rank_world()
    if global_batch % world:
        raise ValueError(f"global_batch {global_batch} must divide world {world}")
    rng = np.random.default_rng(7)
    n = global_batch * steps_per_epoch
    feats = rng.normal(size=(n, 4)).astype(np.float32)
    labels = rng.integers(0, 3, n).astype(np.int64)
    loader = [
        _rows((feats[s * global_batch:(s + 1) * global_batch],
               labels[s * global_batch:(s + 1) * global_batch]), rank, world)
        for s in range(steps_per_epoch)
    ]
    dev = _worker_device(device)
    model = MLP((4, 8, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    state = TrainState.create(model=model, tx=make_optimizer("adam", 0.05))

    def loss_fn(module, batch, step_rng):
        del step_rng
        x, y = batch
        return cross_entropy(module(x), y), {}

    with CheckpointManager(os.path.join(workdir, f"ckpt_r{rank}")) as ckpt:
        res = fit(
            state, loss_fn, loader, epochs=epochs, mesh=data_parallel_mesh(),
            checkpointer=ckpt, checkpoint_every=checkpoint_every, resume=True,
            log_every=0,
        )
    return _drill_result(rank, res, world)


def mlp_recipe_two_plus_two(workdir, data_path, device=None):
    """The MLP recipe in this gang, three times: 2 epochs into
    ``<workdir>/split``, 2 more epochs resumed from there, and 4 epochs
    into ``<workdir>/whole``. Each call stands for a run of its own (its
    own ``MLSPARK_GANG_RUN``), so the second trains 2 epochs on rather
    than finishing the first. Every rank's results, in rank order: the
    final parameters, the resumed step and what each rank's checkpoint
    directory holds."""
    from machine_learning_apache_spark_tpu_torch.recipes.mlp import train_mlp
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params

    rank, world = _rank_world()
    dev = _worker_device(device)
    runs = {}
    gang_run = os.environ.get("MLSPARK_GANG_RUN")
    for name, sub, epochs in (("first", "split", 2), ("second", "split", 2),
                              ("whole", "whole", 4)):
        os.environ["MLSPARK_GANG_RUN"] = f"{gang_run}-{name}"
        out = train_mlp(
            device=dev, data_path=data_path, epochs=epochs,
            checkpoint_dir=os.path.join(workdir, sub), _return_state=True,
        )
        runs[name] = {
            "params": export_flax_params(out["state"].model),
            "resumed_from_step": out.get("resumed_from_step"),
            "epochs": out["epochs"],
            "step_losses": list(out["fit_result"].step_losses),
            "dirs": sorted(os.listdir(os.path.join(workdir, sub))),
        }
    gathered = [None] * world
    dist.all_gather_object(gathered, {"rank": rank, "runs": runs})
    return gathered


def mllib_mesh_fit(data_path, layers, max_iter, initial_params, solver="l-bfgs", device=None):
    """``MultilayerPerceptronClassifier.fit(mesh=data_parallel_mesh())``
    on the libsvm file's 60 % split (seed 1234) from the given Flax
    parameters. Rank 0's parameters, loss history and evaluation and
    all-reduce counts, and whether every rank ended on the same
    parameters."""
    from machine_learning_apache_spark_tpu_torch.data.libsvm import read_libsvm
    from machine_learning_apache_spark_tpu_torch.mllib import MultilayerPerceptronClassifier
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh

    rank, world = _rank_world()
    train, _ = read_libsvm(data_path).random_split([0.6, 0.4], seed=1234)
    model = MultilayerPerceptronClassifier(
        layers=list(layers), maxIter=max_iter, solver=solver,
    ).fit(train, mesh=data_parallel_mesh(), device=device, initial_params=initial_params)
    params = model.params
    flat = np.concatenate([np.ravel(v) for v in _leaves(params)])
    gathered = [None] * world
    dist.all_gather_object(gathered, flat)
    return {
        "rank": rank,
        "world": world,
        "params": params,
        "loss_history": model.loss_history,
        "iterations": model.iterations,
        "evaluations": model.evaluations,
        "allreduces": model.allreduces,
        "fit_seconds": model.fit_seconds,
        "ranks_agree": all(np.array_equal(gathered[0], g) for g in gathered),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


#: The comms counters the ZeRO-1 fit emits (train.loop._with_comms_counters).
ZERO1_COUNTERS = ("bytes_reduce_scattered", "bytes_allgathered", "bytes_exposed", "bytes_overlapped")


def zero1_variants(cfg_kwargs, flax_params, batches, segments, device=None):
    """A tiny Transformer through ``fit(mesh=)`` in this gang (on
    ``device``, default the gang's), from the given Flax weights over the
    given global batches (each rank its half), dropout off, once per
    variant: the replicated step at K = 1 and 4, ``dp_mode="zero1"``
    serial and overlapped with one bucket and with several, the bf16 and
    int8 wires, Adam replicated and ZeRO-1, and the implicit
    ``zero1=True``. Then the real bucket reduce-scatter of
    ``segments[rank]`` on each wire, and the sync check on a ZeRO-1 state.
    Rank 0's results per variant: step losses, epoch losses, final
    parameters, the comms totals and counters, the optimizer bytes and
    kernel launches of every rank, the plan's layout and wire
    accounting."""
    from machine_learning_apache_spark_tpu_torch import telemetry
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.parallel import (
        assert_replicas_in_sync,
        data_parallel_mesh,
        params_fingerprint,
    )
    from machine_learning_apache_spark_tpu_torch.parallel import zero
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import (
        TrainState,
        make_optimizer,
    )
    from machine_learning_apache_spark_tpu_torch.weights import (
        export_flax_params,
        load_flax_params,
    )

    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop

    rank, world = _rank_world()
    dev = _worker_device(device)
    mesh = data_parallel_mesh(device=dev)
    cfg = TransformerConfig(**cfg_kwargs)
    local = [_rows(b, rank, world) for b in batches]
    reg = telemetry.get_registry()
    variants = {
        "replicated": dict(opt=("sgd", 0.5)),
        "replicated_k4": dict(opt=("sgd", 0.5), steps_per_call=4),
        "zero1_overlap": dict(opt=("sgd", 0.5), dp_mode="zero1", dp_overlap=True),
        "zero1_serial": dict(opt=("sgd", 0.5), dp_mode="zero1", dp_overlap=False),
        "zero1_overlap_4096": dict(opt=("sgd", 0.5), dp_mode="zero1", dp_overlap=True,
                                   dp_bucket_bytes=4096),
        "zero1_serial_4096": dict(opt=("sgd", 0.5), dp_mode="zero1", dp_overlap=False,
                                  dp_bucket_bytes=4096),
        "zero1_bf16": dict(opt=("sgd", 0.5), dp_mode="zero1", dp_bucket_bytes=4096,
                           dp_comms_dtype="bfloat16"),
        "zero1_int8": dict(opt=("sgd", 0.5), dp_mode="zero1", dp_bucket_bytes=4096,
                           dp_comms_dtype="int8", epochs=3),
        "adam_replicated": dict(opt=("adam", 1e-2)),
        "adam_zero1_overlap_4096": dict(opt=("adam", 1e-2), dp_mode="zero1",
                                        dp_bucket_bytes=4096),
        "adam_zero1_serial": dict(opt=("adam", 1e-2), dp_mode="zero1", dp_overlap=False),
        "adam_implicit": dict(opt=("adam", 1e-2), zero1=True),
    }
    runs, states = {}, {}
    for name, kw in variants.items():
        kw = dict(kw)
        opt, lr = kw.pop("opt")
        epochs = kw.pop("epochs", 1)
        model = load_flax_params(Transformer(cfg), flax_params).to(dev)
        state = TrainState.create(model=model, tx=make_optimizer(opt, lr))
        before = {n: reg.counter("comms", n).value for n in ZERO1_COUNTERS}
        hop.reset_launches()
        t0 = time.perf_counter()
        res = fit(state, make_translation_loss(cfg.pad_id), local, epochs=epochs, mesh=mesh,
                  log_every=0, sync_check_every=1, **kw)
        seconds = time.perf_counter() - t0
        st = res.state
        states[name] = st
        gathered = [None] * world
        dist.all_gather_object(gathered, (zero.opt_state_bytes_per_chip(st), dict(hop.LAUNCHES)))
        plan = getattr(st, "plan", None)
        runs[name] = {
            "step_losses": res.step_losses,
            "history": [h["loss"] for h in res.history],
            "params": export_flax_params(model),
            "comms": res.comms,
            "counters": {n: reg.counter("comms", n).value - before[n] for n in ZERO1_COUNTERS},
            "opt_bytes": [g[0] for g in gathered],
            "launches": [g[1] for g in gathered],
            "layout": zero.plan_layout(plan) if plan is not None else None,
            "wire": zero.comms_bytes_per_step(plan, st.config) if plan is not None else None,
            "steps": st.step,
            "type": type(st).__name__,
            "seconds": seconds,
        }
    wires = {}
    for dt in zero.COMMS_DTYPES:
        seg = torch.as_tensor(segments[rank]).to(dev)
        out = torch.zeros(len(seg) // world, device=dev)
        _, finish = zero._reduce_scatter_bucket(seg.clone(), out, world, dt)
        finish()
        pieces = [None] * world
        dist.all_gather_object(pieces, out.cpu().numpy())
        wires[dt] = np.concatenate(pieces)
    zs = states["zero1_overlap"]
    sync = {"divergence": assert_replicas_in_sync(zs, mesh=mesh),
            "fingerprint_equal": params_fingerprint(zs) == params_fingerprint(zs.model)}
    try:
        assert_replicas_in_sync(zs.opt_state, mesh=mesh)
        sync["opt_state_refused"] = False
    except ValueError as e:
        sync["opt_state_refused"] = "replicat" in str(e)
    return {"runs": runs, "wires": wires, "sync": sync, "world": world}


def zero1_recipe_two_plus_two(workdir, recipe_kw, device=None):
    """The MT recipe under this gang's ``MLSPARK_DP_MODE=zero1``, three
    times: 2 epochs into ``<workdir>/split``, 2 more resumed from there,
    4 into ``<workdir>/whole`` (each call a run of its own). Then
    ``fit(resume=True)`` over the zero1 checkpoints with a replicated
    state and with a ZeRO-1 state of another bucket size, each of which
    must raise ``TopologyMismatch``. Rank 0's results."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.parallel import data_parallel_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_translation_loss,
        train_translator,
    )
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import (
        CheckpointManager,
        TopologyMismatch,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    rank, world = _rank_world()
    dev = _worker_device(device)
    runs = {}
    gang_run = os.environ.get("MLSPARK_GANG_RUN")
    for name, sub, epochs in (("first", "split", 2), ("second", "split", 2),
                              ("whole", "whole", 4)):
        os.environ["MLSPARK_GANG_RUN"] = f"{gang_run}-{name}"
        out = train_translator(
            device=dev, epochs=epochs, checkpoint_dir=os.path.join(workdir, sub),
            _return_state=True, **recipe_kw,
        )
        st = out["state"]
        runs[name] = {
            "params": {k: v.detach().cpu().numpy() for k, v in st.model.state_dict().items()},
            "opt_state": {k: v.detach().cpu().numpy() for k, v in st.opt_state.items()},
            "type": type(st).__name__,
            "resumed_from_step": out.get("resumed_from_step"),
            "step_losses": list(out["fit_result"].step_losses),
        }
    crossed = {}
    mine = os.path.join(workdir, "whole", f"ckpt_r{rank}")
    for label, kw in (("replicated", {"dp_mode": "replicated"}),
                      ("bucket_4096", {"dp_mode": "zero1", "dp_bucket_bytes": 4096})):
        model = Transformer(TransformerConfig(
            src_vocab_size=out["src_vocab"], trg_vocab_size=out["trg_vocab"],
            d_model=recipe_kw["d_model"], ffn_hidden=recipe_kw["ffn_hidden"],
            num_heads=recipe_kw["num_heads"], max_len=recipe_kw["max_len"]))
        state = TrainState.create(model=model, tx=make_optimizer("adam"))
        try:
            fit(state, make_translation_loss(0), [], epochs=5, mesh=data_parallel_mesh(device="cpu"),
                checkpointer=CheckpointManager(mine), resume=True, log_every=0, **kw)
            crossed[label] = "no raise"
        except TopologyMismatch as e:
            crossed[label] = str(e)
    return {"rank": rank, "world": world, "runs": runs, "crossed": crossed}


# -- tensor parallelism ----------------------------------------------------------


def _gathered_tree(model, factory, grads: bool = False):
    """``model``'s parameters (or their gradients) gathered over the model
    axis into ``factory()``'s full model, as a Flax tree."""
    from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import gather_full
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params

    full = {name: gather_full(p, p.grad if grads else None) for name, p in model.named_parameters()}
    out = factory()
    out.load_state_dict(full)
    return export_flax_params(out)


def tp_two_rank(cfg_kwargs, flax_params, probe_batch, batches, lr, mlp_layers, mlp_params,
                mlp_batches, workdir, recipe_kw, probe_texts):
    """Every check of the 2-rank ``{data: 1, model: 2}`` gang, in one gang
    start: the sharded Transformer's loss and gathered gradients on
    ``probe_batch``; 3 SGD steps of ``fit(mesh=)`` over ``batches`` and of
    an ``MLP(tp_rules=True)`` over ``mlp_batches``, the latter also on a
    ``{model: 2}`` mesh; 1 + 1 epochs against 2
    with checkpoints (dropout and Adam), and the crossed resume; then
    ``train_translator(model_parallel=2)``. Rank 0's results."""
    from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel as tp
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_translation_loss,
        train_translator,
    )
    from machine_learning_apache_spark_tpu_torch.train import checkpoint as ckpt
    from machine_learning_apache_spark_tpu_torch.train.loop import (
        classification_loss,
        evaluate,
        fit,
    )
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params, load_flax_params

    rank, world = _rank_world()
    mesh = make_mesh({"data": 1, "model": world}, device="cpu")
    cfg = TransformerConfig(**cfg_kwargs)
    full_cfg = lambda: Transformer(cfg)  # noqa: E731
    out = {"mesh": dict(mesh.shape), "coords": mesh.coords}

    model = load_flax_params(Transformer(cfg), flax_params, mesh=mesh)
    probe = tuple(torch.as_tensor(a) for a in probe_batch)
    loss, _ = make_translation_loss(cfg.pad_id, train=False)(model, probe, None)
    loss.backward()
    out["probe_loss"] = float(loss)
    out["probe_grads"] = _gathered_tree(model, full_cfg, grads=True)
    out["heads_per_rank"] = model.encoder.layers[0].self_attn.heads
    out["probe_tp_calls"] = model.tp_axis.comms.calls["tp_allreduce"]

    model = load_flax_params(Transformer(cfg), flax_params)
    res = fit(TrainState.create(model=model, tx=make_optimizer("sgd", lr)),
              make_translation_loss(cfg.pad_id), batches, epochs=1, mesh=mesh, log_every=0)
    out["fit"] = {"params": _gathered_tree(model, full_cfg), "step_losses": res.step_losses,
                  "comms": res.comms}

    mlp = load_flax_params(MLP(tuple(mlp_layers), tp_rules=True), mlp_params)
    res = fit(TrainState.create(model=mlp, tx=make_optimizer("sgd", lr)), classification_loss(),
              mlp_batches, epochs=1, mesh=mesh, log_every=0)
    out["mlp"] = {"params": _gathered_tree(mlp, lambda: MLP(tuple(mlp_layers), tp_rules=True)),
                  "step_losses": res.step_losses,
                  "modes": [getattr(getattr(mlp, f"dense_{i}").tp, "mode", None)
                            for i in range(len(mlp_layers) - 1)]}
    # A mesh with no data axis: the same TP fit, no data-parallel sums (a
    # replica check compares nothing), so the same bits.
    mlp = load_flax_params(MLP(tuple(mlp_layers), tp_rules=True), mlp_params)
    model_only = make_mesh({"model": world}, device="cpu")
    res = fit(TrainState.create(model=mlp, tx=make_optimizer("sgd", lr)), classification_loss(),
              mlp_batches, epochs=1, mesh=model_only, log_every=0, sync_check_every=1)
    out["mlp_model_only"] = {
        "params": _gathered_tree(mlp, lambda: MLP(tuple(mlp_layers), tp_rules=True)),
        "step_losses": res.step_losses,
    }
    # A second fit after an evaluation reports its own model-axis totals.
    evaluate(res.state, classification_loss(train=False), mlp_batches[:1], mesh=model_only)
    again = fit(res.state, classification_loss(), mlp_batches, epochs=1, mesh=model_only,
                log_every=0)
    out["tp_comms_per_fit"] = (res.comms, again.comms)

    drop_cfg = TransformerConfig(**{**cfg_kwargs, "dropout": 0.1})

    def resumable(tag, epochs, resume):
        m = load_flax_params(Transformer(drop_cfg), flax_params)
        with ckpt.CheckpointManager(os.path.join(workdir, tag, f"ckpt_r{rank}")) as mgr:
            r = fit(TrainState.create(model=m, tx=make_optimizer("adam", lr / 10)),
                    make_translation_loss(cfg.pad_id), batches, epochs=epochs, mesh=mesh,
                    log_every=0, checkpointer=mgr, resume=resume,
                    rng=torch.Generator().manual_seed(11))
        return m, r

    whole, r2 = resumable("whole", 2, False)
    resumable("split", 1, False)
    split, r11 = resumable("split", 2, True)
    out["resume"] = {
        "params_equal": all(torch.equal(a, b) for a, b in zip(whole.parameters(), split.parameters())),
        "losses": (r2.step_losses, r11.step_losses),
        "resumed_from": r11.resumed_step,
    }
    m = load_flax_params(Transformer(drop_cfg), flax_params)
    try:
        with ckpt.CheckpointManager(os.path.join(workdir, "split", f"ckpt_r{rank}")) as mgr:
            fit(TrainState.create(model=m, tx=make_optimizer("adam", lr / 10)),
                make_translation_loss(cfg.pad_id), batches, epochs=3,
                mesh=make_mesh({"data": world}, device="cpu"), log_every=0,
                checkpointer=mgr, resume=True)
        out["crossed"] = "no error"
    except ckpt.TopologyMismatch as e:
        out["crossed"] = str(e)

    res = train_translator(device="cpu", model_parallel=world, _return_translator=True,
                           _return_state=True, **recipe_kw)
    tr = res["translator"]
    sharded = res["state"].model
    gathered = tp.gather_params(sharded)
    concat_ok = True
    for name, p in sharded.named_parameters():
        pieces = [torch.empty_like(p) for _ in range(world)]
        dist.all_gather(pieces, p.detach().contiguous())
        if getattr(p, "tp_axis", None) is not None:
            concat_ok &= torch.equal(gathered[name], tp.unshard(pieces, p.tp_dim, p.tp_parts))
            concat_ok &= torch.equal(pieces[rank], p.detach())
        else:
            concat_ok &= torch.equal(gathered[name], p.detach())
    out["recipe"] = {
        "step_losses": res["fit_result"].step_losses,
        "final_loss": res["final_loss"],
        "test_loss": res.get("test_loss"),
        "logit_pad": sharded.cfg.logit_pad,
        "translator_params": export_flax_params(tr.model),
        "gathered_equal_concat": bool(concat_ok),
        "translator_sharded": tr.model.tp_axis is not None,
        "tokens": tr(list(probe_texts), max_new_tokens=8),
    }
    return out if rank == 0 else None


def tp_hybrid_four_rank(mlp_layers, mlp_params, batch, steps, lr, bucket_bytes, device=None,
                        recipe_kw=None):
    """The 4-rank ``{data: 2, model: 2}`` gang on the JAX ``TestHybridMesh``
    setup: ``steps`` Adam steps of the replicated hybrid step
    (``shard_state`` + ``make_data_parallel_step``) and of the ZeRO-1
    hybrid step (overlapped, serial; float32, bf16 and int8 wires), each
    data index on its half of ``batch``. Rank 0's results: every run's
    gathered parameters and last loss, whether each rank's ZeRO-1 moments
    equal the slices of its replicated moments bit for bit, the
    optimizer bytes per rank, the full model's replicated optimizer
    bytes, and the wire accounting. On ``device`` (default: the gang's).
    With ``recipe_kw``, also ``train_translator(model_parallel=2)``
    replicated and under the ``MLSPARK_DP_MODE=zero1`` contract: their
    step losses and state types."""
    from machine_learning_apache_spark_tpu_torch.models.mlp import MLP
    from machine_learning_apache_spark_tpu_torch.parallel import make_data_parallel_step, make_mesh
    from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel as tp
    from machine_learning_apache_spark_tpu_torch.parallel import zero
    from machine_learning_apache_spark_tpu_torch.train.loop import classification_loss, to_device
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

    rank, world = _rank_world()
    dev = _worker_device(device)
    mesh = make_mesh({"data": 2, "model": 2}, device=dev)
    d = mesh.index("data")
    local = to_device(_rows(batch, d, 2), dev)
    factory = lambda: MLP(tuple(mlp_layers), tp_rules=True)  # noqa: E731
    loss_fn = classification_loss()
    out: dict = {"coords": [None] * world}
    dist.all_gather_object(out["coords"], mesh.coords)

    def fresh():
        return load_flax_params(factory(), mlp_params).to(dev)

    state = tp.shard_state(TrainState.create(model=fresh(), tx=make_optimizer("adam", lr)), mesh)
    step = make_data_parallel_step(loss_fn, mesh)
    for _ in range(steps):
        _, loss, _ = step(state, local, None)
    ref = state
    out["replicated"] = {"params": _gathered_tree(state.model, factory), "loss": float(loss),
                         "grad_allreduce_steps": step.comms.steps,
                         "tp": state.model.tp_axis.comms.stats()}

    full = TrainState.create(model=fresh(), tx=make_optimizer("adam", lr))
    l, _ = loss_fn(full.model, local, None)
    l.backward()
    full.apply_gradients()
    out["replicated_bytes"] = zero.opt_state_bytes(full.optimizer)

    # fit(zero1=True) on the hybrid mesh: the replicated hybrid step with
    # each moment sharded on its leading dim over the data line.
    from machine_learning_apache_spark_tpu_torch.train.loop import fit

    res = fit(TrainState.create(model=fresh(), tx=make_optimizer("adam", lr)), loss_fn,
              [local] * steps, epochs=1, mesh=mesh, zero1=True, log_every=0)
    flags = [None] * world
    dist.all_gather_object(flags, (type(res.state).__name__, zero.opt_state_bytes_per_chip(res.state)))
    out["implicit"] = {"params": _gathered_tree(res.state.model, factory),
                       "types": [f[0] for f in flags], "opt_bytes": [f[1] for f in flags],
                       "step_losses": res.step_losses}

    runs = {"fp32_overlap": dict(overlap=True), "fp32_serial": dict(overlap=False),
            "bf16": dict(comms_dtype="bfloat16"), "int8": dict(comms_dtype="int8")}
    for name, kw in runs.items():
        zs = zero.init_sharded(model=fresh(), tx=make_optimizer("adam", lr), mesh=mesh,
                               config=zero.Zero1Config(bucket_bytes=bucket_bytes, **kw))
        zstep = zero.make_zero1_step(loss_fn, mesh, zs)
        for _ in range(steps):
            _, loss, _ = zstep(zs, local, None)
        moments_equal = None
        if name.startswith("fp32"):
            moments_equal = True
            for key in ("exp_avg", "exp_avg_sq"):
                by_param = [ref.optimizer.state[p][key] for p in ref.params]
                flat = torch.zeros(zs.plan.padded, device=dev)
                for i, o, n in zip(zs.order, zs.plan.offsets, zs.plan.sizes):
                    flat[o:o + n] = by_param[i].reshape(-1)
                want = torch.cat([flat[zs.bucket_span(k)[0]] for k in range(len(zs.plan.buckets))])
                moments_equal &= torch.equal(want, zs.opt_state[key])
        flags = [None] * world
        dist.all_gather_object(flags, (moments_equal, zero.opt_state_bytes_per_chip(zs), zs.plan.shard_len))
        out[name] = {
            "params": _gathered_tree(zs.model, factory), "loss": float(loss),
            "moments_equal": [f[0] for f in flags], "opt_bytes": [f[1] for f in flags],
            "shard_len": [f[2] for f in flags], "wire": zstep.comms_stats,
            "wire_fp32": zero.comms_bytes_per_step(zs.plan, zero.Zero1Config(bucket_bytes=bucket_bytes)),
            "layout": zero.plan_layout(zs.plan),
        }
    if recipe_kw is not None:
        from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

        out["recipe"] = {}
        for mode in ("replicated", "zero1"):
            os.environ["MLSPARK_DP_MODE"] = mode
            try:
                res = train_translator(model_parallel=2, _return_state=True, **recipe_kw)
            finally:
                os.environ.pop("MLSPARK_DP_MODE")
            out["recipe"][mode] = {"step_losses": res["fit_result"].step_losses,
                                   "type": type(res["state"]).__name__,
                                   "mesh": dict(res["state"].mesh.shape)}
    return out if rank == 0 else None


def tp_card_layers(cfg_kwargs, flax_params, batch, device=None):
    """The sharded Transformer's loss and gathered gradients on
    ``device`` (default: the gang's) on a ``{data: 1, model: world}``
    mesh (every rank the whole ``batch``) against the unsharded model on
    the same device; and the
    vocab-parallel loss against the full-logit loss on the same logits.
    Rank 0's largest relative differences and kernel launches."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.parallel import tensor_parallel as tp
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train import losses
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

    rank, world = _rank_world()
    dev = _worker_device(device)
    mesh = make_mesh({"data": 1, "model": world}, device=dev)
    cfg = TransformerConfig(**cfg_kwargs)
    probe = tuple(torch.as_tensor(a).to(dev) for a in batch)
    loss_fn = make_translation_loss(cfg.pad_id, train=False)
    full = load_flax_params(Transformer(cfg), flax_params).to(dev)
    want, _ = loss_fn(full, probe, None)
    want.backward()
    model = tp.shard_params(load_flax_params(Transformer(cfg), flax_params).to(dev), mesh)
    hop.reset_launches()
    got, _ = loss_fn(model, probe, None)
    got.backward()
    launches = dict(hop.LAUNCHES)
    grads = {n: tp.gather_full(p, p.grad) for n, p in model.named_parameters()}
    rel = max(float((grads[n] - p.grad).norm() / p.grad.norm().clamp_min(1e-30))
              for n, p in full.named_parameters())
    logits = torch.randn(*probe[1].shape, cfg.trg_vocab_size + cfg.logit_pad, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    labels = probe[1]
    width = logits.shape[-1] // world
    axis = model.tp_axis
    vp = losses.masked_mean(losses.vocab_parallel_token_cross_entropy(
        logits[..., axis.index * width:(axis.index + 1) * width], labels, axis,
        axis.index * width, cfg.trg_vocab_size), labels)
    plain = losses.masked_token_cross_entropy(logits[..., :cfg.trg_vocab_size], labels)
    out = {"loss": (float(got), float(want)), "grad_rel": rel, "launches": launches,
           "vocab_parallel": (float(vp), float(plain)), "device": str(dev),
           "heads": model.encoder.layers[0].self_attn.heads}
    return out if rank == 0 else None


# -- pipeline parallelism ----------------------------------------------------------


def _mlp_stage(p, x):
    """The JAX tests' residual-MLP stage."""
    return x + torch.tanh(x @ p["w"] + p["b"])


def _aux_stage(p, h, aux_m, rep_m, stage_id, tick):
    (scale,) = aux_m
    out = h + torch.tanh(h @ p["w"] + p["b"]) * scale
    return out if rep_m is None else out + rep_m * (stage_id + 1)


def _pp_mlp_case(mesh, params, x, n_micro, scale=None, shift=None):
    """``pipeline_apply`` of the residual-MLP stage on this rank's data
    rows of ``x``: the output, this stage's gradients of ``sum(out²)``
    and the input's gradient, with the rank's coordinates. ``scale`` is a
    per-example aux, ``shift`` a per-microbatch one (``aux_replicated``)."""
    from machine_learning_apache_spark_tpu_torch.parallel import pipeline_apply

    d, ways = mesh.index("data"), mesh.axis_size("data")
    n = len(x) // ways
    w = torch.tensor(params["w"], requires_grad=True)
    b = torch.tensor(params["b"], requires_grad=True)
    xl = torch.tensor(x[d * n:(d + 1) * n], requires_grad=True)
    if scale is None:
        out = pipeline_apply(_mlp_stage, {"w": w, "b": b}, xl, mesh, n_micro=n_micro)
    else:
        out = pipeline_apply(_aux_stage, {"w": w, "b": b}, xl, mesh, n_micro=n_micro,
                             aux=(torch.tensor(scale[d * n:(d + 1) * n]),),
                             aux_replicated=None if shift is None else torch.tensor(shift))
    (out ** 2).sum().backward()
    s = mesh.index("pipeline")
    return {"data": d, "stage": s, "out": out.detach().numpy(), "gw": w.grad[s].numpy(),
            "gb": b.grad[s].numpy(),
            "gx": (xl.grad if xl.grad is not None else torch.zeros_like(xl)).numpy(),
            "other_stages_zero": bool(torch.all(w.grad[torch.arange(len(w)) != s] == 0))}


def _pp_mlp_fit(mesh, params, batches, lr, n_micro, *, listed=False):
    """3 SGD steps of ``fit(mesh=)`` on the residual MLP's mean of
    ``out²``, its parameters given to ``pipeline_apply`` stacked (a dict of
    ``[S, ...]`` parameters, JAX's form) or, with ``listed``, as a list of
    per-stage dicts; each data index on its rows of ``batches``. The
    parameters stacked, and whether every rank holds the same."""
    from torch import nn

    from machine_learning_apache_spark_tpu_torch.parallel import pipeline_apply
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer

    model = nn.Module()
    if listed:
        model.w = nn.ParameterList([torch.tensor(w) for w in params["w"]])
        model.b = nn.ParameterList([torch.tensor(b) for b in params["b"]])
    else:
        model.w = nn.Parameter(torch.tensor(params["w"]))
        model.b = nn.Parameter(torch.tensor(params["b"]))

    def loss_fn(model, batch, rng):
        if listed:
            stages = [{"w": w, "b": b} for w, b in zip(model.w, model.b)]
        else:
            stages = {"w": model.w, "b": model.b}
        out = pipeline_apply(_mlp_stage, stages, batch[0], mesh, n_micro=n_micro)
        return (out ** 2).mean(), {}

    d, ways = mesh.index("data"), mesh.axis_size("data")
    res = fit(TrainState.create(model=model, tx=make_optimizer("sgd", lr)), loss_fn,
              [_rows((b,), d, ways) for b in batches], epochs=1, mesh=mesh, log_every=0,
              rng=torch.Generator().manual_seed(0))
    got = {k: torch.stack(list(getattr(model, k))).detach().numpy() for k in ("w", "b")}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, got)
    return {"params": got, "ranks_equal": all(_same_tree(e, got) for e in every),
            "steps": res.state.step}


def _owner_grads(model, mesh):
    """Every parameter's gradient taken from a rank of the stage that
    owns it (``pp_stage``, untagged: stage 0), as a Flax tree."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import Transformer
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params

    mine = {n: (getattr(p, "pp_stage", 0), None if p.grad is None else p.grad.numpy())
            for n, p in model.named_parameters()}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.index("pipeline"), mine))
    full = {n: torch.from_numpy(next(g[n][1] for s, g in every if s == owner))
            for n, (owner, _) in mine.items()}
    out = Transformer(model.cfg)
    out.load_state_dict(full)
    return export_flax_params(out)


def _pp_fit(mesh, cfg_kwargs, flax_params, batches, lr, n_micro, *, opt="sgd", epochs=1,
            ckpt=None, resume=False, steps_per_call=1, seed=0):
    """``fit(mesh=)`` of the pipelined MT loss, each data index on its
    rows of ``batches``: the parameters (a Flax tree), step losses, comms
    and whether every rank of the gang holds the same parameters and
    moments bit for bit."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_pipeline_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import CheckpointManager
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params, load_flax_params

    d, ways = mesh.index("data"), mesh.axis_size("data")
    model = load_flax_params(Transformer(TransformerConfig(**cfg_kwargs)), flax_params)
    local = [_rows(b, d, ways) for b in batches]
    mgr = CheckpointManager(ckpt) if ckpt else None
    try:
        res = fit(TrainState.create(model=model, tx=make_optimizer(opt, lr)),
                  make_pipeline_translation_loss(0, mesh, n_micro=n_micro), local, epochs=epochs,
                  mesh=mesh, log_every=0, checkpointer=mgr, resume=resume,
                  steps_per_call=steps_per_call, rng=torch.Generator().manual_seed(seed))
    finally:
        if mgr is not None:
            mgr.close()
    mine = [t.numpy().copy() for t in res.state.state_dict()["model"].values()]
    mine += [v.numpy().copy() for st in res.state.optimizer.state.values()
             for v in st.values() if isinstance(v, torch.Tensor) and v.dim()]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    same = all(all(np.array_equal(a, b) for a, b in zip(e, every[0])) for e in every)
    return {"params": export_flax_params(model), "step_losses": list(res.step_losses),
            "comms": res.comms, "ranks_equal": bool(same), "resumed": res.resumed_step,
            "steps": res.state.step}


def pp_two_rank(mlp_params, mlp_x, mlp_aux, cfg_kwargs, flax_params, probe, batches, lr, workdir,
                recipe_kw, probe_texts):
    """Every check of the 2-rank ``{data: 1, pipeline: 2}`` gang in one
    gang start: ``pipeline_apply`` of the residual MLP at (S, M) = (2, 2)
    and (2, 6), and at M = 3 with a per-example and a per-microbatch aux
    (``mlp_aux``); the pipelined Transformer's logits and owner gradients on
    ``probe``, with and without ``remat``; 3 SGD steps of ``fit``; with
    dropout and Adam, 4 steps per call against 1 and 1 + 1 epochs
    against 2 with checkpoints, and a resume on ``{data: 2}`` that must
    raise; then ``train_translator(pipeline_parallel=2)``. Every rank's
    results where they differ by rank, else rank 0's."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.parallel.pipeline_transformer import (
        pipeline_transformer_logits,
    )
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator
    from machine_learning_apache_spark_tpu_torch.train.checkpoint import TopologyMismatch
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

    rank, world = _rank_world()
    mesh = make_mesh({"data": 1, "pipeline": world}, device="cpu")
    out: dict = {"mesh": dict(mesh.shape)}
    mlp = {m: _pp_mlp_case(mesh, mlp_params, mlp_x, m) for m in (2, 6)}
    mlp["aux"] = _pp_mlp_case(mesh, mlp_params, mlp_x, 3, scale=mlp_aux[0], shift=mlp_aux[1])
    every = [None] * world
    dist.all_gather_object(every, mlp)
    out["mlp"] = every

    src, trg = (torch.as_tensor(a) for a in probe)
    logits = {}
    for remat in (False, True):
        cfg = TransformerConfig(**{**cfg_kwargs, "remat": remat})
        model = load_flax_params(Transformer(cfg), flax_params)
        y = pipeline_transformer_logits(model, src, trg, mesh)
        (y ** 2).mean().backward()
        logits[remat] = {"logits": y.detach().numpy(), "grads": _owner_grads(model, mesh)}
    out["logits"] = logits

    out["fit"] = _pp_fit(mesh, cfg_kwargs, flax_params, batches[:3], lr, 2)
    drop = {**cfg_kwargs, "dropout": 0.1}
    kw = dict(opt="adam", seed=11)
    one = _pp_fit(mesh, drop, flax_params, batches, lr / 10, 2, **kw)
    four = _pp_fit(mesh, drop, flax_params, batches, lr / 10, 2, steps_per_call=4, **kw)
    out["k_steps"] = {"losses_equal": one["step_losses"] == four["step_losses"],
                      "params_equal": _same_tree(one["params"], four["params"])}
    root = os.path.join(workdir, "pp")
    whole = _pp_fit(mesh, drop, flax_params, batches, lr / 10, 2, epochs=2,
                    ckpt=os.path.join(root, "whole", f"ckpt_r{rank}"), **kw)
    first = _pp_fit(mesh, drop, flax_params, batches, lr / 10, 2, epochs=1,
                    ckpt=os.path.join(root, "split", f"ckpt_r{rank}"), **kw)
    second = _pp_fit(mesh, drop, flax_params, batches, lr / 10, 2, epochs=2,
                     ckpt=os.path.join(root, "split", f"ckpt_r{rank}"), resume=True, **kw)
    out["resume"] = {"params_equal": _same_tree(whole["params"], second["params"]),
                     "losses_equal": first["step_losses"] + second["step_losses"] == whole["step_losses"],
                     "resumed_from": second["resumed"], "first_steps": first["steps"],
                     "ranks_equal": whole["ranks_equal"] and second["ranks_equal"]}
    try:
        _pp_fit(make_mesh({"data": world}, device="cpu"), drop, flax_params, batches, lr / 10, 2,
                epochs=3, ckpt=os.path.join(root, "split", f"ckpt_r{rank}"), resume=True, **kw)
        out["crossed"] = "no error"
    except TopologyMismatch as e:
        out["crossed"] = str(e)

    res = train_translator(device="cpu", pipeline_parallel=world, pipeline_microbatches=4,
                           _return_translator=True, _return_state=True, **recipe_kw)
    tr = res["translator"]
    out["recipe"] = {"step_losses": res["fit_result"].step_losses,
                     "mesh": dict(res["state"].mesh.shape),
                     "translator_is_model": tr.model is res["state"].model,
                     "tokens": tr(list(probe_texts), max_new_tokens=8),
                     "comms": res["fit_result"].comms}
    return out if rank == 0 else None


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    return bool(np.array_equal(a, b))


def pp_four_rank(mlp_params4, mlp_params2, mlp_x, scale, cfg_kwargs, flax_params, batches, lr,
                 mlp_batches):
    """The 4-rank gang: ``pipeline_apply`` of the residual MLP on
    ``{pipeline: 4}`` at M = 4 and 8 and on ``{data: 2, pipeline: 2}``
    (M = 2, with and without a per-example aux); 3 SGD steps of ``fit``
    on the residual MLP over ``mlp_batches``, its parameters stacked on
    ``{pipeline: 4}`` and listed per stage on ``{data: 2, pipeline: 2}``;
    then 3 SGD steps of the pipelined Transformer's ``fit`` on ``{data:
    2, pipeline: 2}``. Every rank's MLP results, rank 0's fits."""
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh

    rank, world = _rank_world()
    deep = make_mesh({"pipeline": world}, device="cpu")
    hybrid = make_mesh({"data": 2, "pipeline": world // 2}, device="cpu")
    cases = {f"pipeline4 M{m}": _pp_mlp_case(deep, mlp_params4, mlp_x, m) for m in (4, 8)}
    cases["data2 pipeline2 M2"] = _pp_mlp_case(hybrid, mlp_params2, mlp_x, 2)
    cases["data2 pipeline2 aux"] = _pp_mlp_case(hybrid, mlp_params2, mlp_x, 2, scale=scale)
    every = [None] * world
    dist.all_gather_object(every, cases)
    out = {"mlp": every, "coords": [None] * world}
    dist.all_gather_object(out["coords"], hybrid.coords)
    out["mlp_fit"] = {"stacked": _pp_mlp_fit(deep, mlp_params4, mlp_batches, lr, 4),
                      "listed": _pp_mlp_fit(hybrid, mlp_params2, mlp_batches, lr, 2, listed=True)}
    out["fit"] = _pp_fit(hybrid, cfg_kwargs, flax_params, batches, lr, 2)
    return out if rank == 0 else None


def pp_card_gang(cfg_kwargs, flax_params, batches, lr, n_micro, device=None):
    """SGD steps of the pipelined ``fit`` on ``device`` (default: the gang's) on a
    ``{pipeline: world}`` mesh, every rank the whole batches: rank 0's
    step losses and parameters, whether every rank holds the same
    parameters and moments, and every rank's launches."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import (
        make_pipeline_translation_loss,
    )
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

    rank, world = _rank_world()
    dev = _worker_device(device)
    mesh = make_mesh({"pipeline": world}, device=dev)
    model = load_flax_params(Transformer(TransformerConfig(**cfg_kwargs)), flax_params).to(dev)
    hop.reset_launches()
    res = fit(TrainState.create(model=model, tx=make_optimizer("sgd", lr)),
              make_pipeline_translation_loss(0, mesh, n_micro=n_micro), batches, epochs=1,
              mesh=mesh, log_every=0)
    launches = [None] * world
    dist.all_gather_object(launches, dict(hop.LAUNCHES))
    mine = [t.detach().cpu().numpy() for t in model.state_dict().values()]
    mine += [v.detach().cpu().numpy() for st in res.state.optimizer.state.values()
             for v in st.values() if isinstance(v, torch.Tensor) and v.dim()]
    every = [None] * world
    dist.all_gather_object(every, mine)
    out = {"device": str(dev), "mesh": dict(mesh.shape), "step_losses": res.step_losses,
           "params": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
           "ranks_equal": all(all(np.array_equal(a, b) for a, b in zip(e, every[0])) for e in every),
           "launches": launches}
    return out if rank == 0 else None


# -- sequence parallelism -----------------------------------------------------------


def _sp_line_equal(mesh, arrays) -> bool:
    """Whether every rank of this rank's seq line holds ``arrays`` bit for
    bit (all ranks gather; each line is compared within itself)."""
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (mesh.index("data"), [np.asarray(a) for a in arrays]))
    mine = [e for d, e in every if d == mesh.index("data")]
    return all(all(np.array_equal(a, b) for a, b in zip(e, mine[0])) for e in mine)


def _sp_attention_case(mesh, method, qkv, causal, valid):
    """One site under ``sequence_parallel(mesh, method=)`` through
    ``dot_product_attention``, this data index's rows of the global
    ``qkv``/``valid``: the output and the gradients of sum(out²), the seq
    line's collectives, and whether its ranks agree bit for bit."""
    from machine_learning_apache_spark_tpu_torch.ops.attention import (
        dot_product_attention,
        sequence_parallel,
    )
    from machine_learning_apache_spark_tpu_torch.parallel.sequence import sequence_line

    d, ways = mesh.index("data"), mesh.axis_size("data")
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _rows(qkv, d, ways))
    kv_valid = None if valid is None else torch.from_numpy(_rows((valid,), d, ways)[0])
    line = sequence_line(mesh)
    line.restart_comms()
    with sequence_parallel(mesh, method=method):
        out = dot_product_attention(q, k, v, causal=causal, kv_valid=kv_valid)
    (out ** 2).sum().backward()
    res = [out.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy()]
    stats = line.comms.stats()
    return {"data": d, "out": res, "line_equal": _sp_line_equal(mesh, res),
            "calls": {kind: stats[f"{kind}_calls"] for kind in line.comms.KINDS}}


def _sp_fit(mesh, method, cfg_kwargs, flax_params, batches, lr, eval_batches):
    """3 SGD steps of ``fit(mesh=)`` and an ``evaluate`` under
    ``sequence_parallel(mesh, method=)``, each data index on its rows:
    rank 0's parameters (a Flax tree), the step losses, the eval loss, the
    comms, ``assert_replicas_in_sync``'s verdict and whether every rank
    of the gang holds the same parameters bit for bit."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.ops.attention import sequence_parallel
    from machine_learning_apache_spark_tpu_torch.parallel import assert_replicas_in_sync
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import evaluate, fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import export_flax_params, load_flax_params

    d, ways = mesh.index("data"), mesh.axis_size("data")
    model = load_flax_params(Transformer(TransformerConfig(**cfg_kwargs)), flax_params)
    with sequence_parallel(mesh, method=method):
        res = fit(TrainState.create(model=model, tx=make_optimizer("sgd", lr)),
                  make_translation_loss(0), [_rows(b, d, ways) for b in batches], epochs=1,
                  mesh=mesh, log_every=0)
        metrics = evaluate(res.state, make_translation_loss(0, train=False),
                           [_rows(b, d, ways) for b in eval_batches], mesh=mesh,
                           emit=lambda s: None)
    try:
        assert_replicas_in_sync(res.state, mesh=mesh)
        in_sync = "ok"
    except AssertionError as e:
        in_sync = str(e)
    mine = [t.numpy().copy() for t in model.state_dict().values()]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return {"params": export_flax_params(model), "step_losses": list(res.step_losses),
            "test_loss": metrics["test_loss"], "comms": res.comms, "in_sync": in_sync,
            "ranks_equal": all(all(np.array_equal(a, b) for a, b in zip(e, every[0]))
                               for e in every)}


def sp_four_rank(qkv, valid, cfg_kwargs, flax_params, batches, lr, eval_batches, recipe_kw,
                 workdir):
    """Every check of the 4-rank sequence-parallel gang in one gang start,
    on ``{seq: 4}`` and ``{data: 2, seq: 2}``: ring and Ulysses at one
    attention site (full; causal with ``kv_valid``), forward and
    gradients; 3 SGD steps of the Transformer's ``fit`` under ring on
    ``{seq: 4}`` and under Ulysses on ``{data: 2, seq: 2}``; the recipe
    with ``sequence_parallel=4`` (ring) and ``=2`` (Ulysses, BLEU,
    checkpoints), and ``sequence_parallel`` beside ``model_parallel``.
    Rank 0's results, with every rank's attention rows."""
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import train_translator

    rank, world = _rank_world()
    meshes = {"seq4": make_mesh({"seq": world}, device="cpu"),
              "data2 seq2": make_mesh({"data": 2, "seq": world // 2}, device="cpu")}
    cases = {}
    for name, mesh in meshes.items():
        for method in ("ring", "ulysses"):
            cases[f"{name} {method} full"] = _sp_attention_case(mesh, method, qkv, False, None)
            cases[f"{name} {method} causal valid"] = _sp_attention_case(mesh, method, qkv, True, valid)
    every = [None] * world
    dist.all_gather_object(every, cases)
    out = {"attention": every, "coords": [None] * world}
    dist.all_gather_object(out["coords"], meshes["data2 seq2"].coords)
    out["fit"] = {
        "seq4 ring": _sp_fit(meshes["seq4"], "ring", cfg_kwargs, flax_params, batches, lr,
                             eval_batches),
        "data2 seq2 ulysses": _sp_fit(meshes["data2 seq2"], "ulysses", cfg_kwargs, flax_params,
                                      batches, lr, eval_batches),
    }
    recipes = {}
    for n, method, extra in ((world, "ring", {}),
                             (world // 2, "ulysses", dict(compute_bleu=True, checkpoint_dir=os.path.join(workdir, "sp")))):
        res = train_translator(device="cpu", sequence_parallel=n, sequence_parallel_method=method,
                               _return_state=True, **recipe_kw, **extra)
        recipes[f"{method} {n}"] = {
            "step_losses": res["fit_result"].step_losses, "mesh": dict(res["state"].mesh.shape),
            "test_loss": res["test_loss"], "bleu": res.get("bleu"),
            "comms": res["fit_result"].comms,
            "line_equal": _sp_line_equal(res["state"].mesh, [
                t.numpy() for t in res["state"].model.state_dict().values()])}
    out["recipe"] = recipes
    try:
        train_translator(device="cpu", sequence_parallel=2, model_parallel=2, **recipe_kw)
        out["seq_model"] = "no error"
    except NotImplementedError as e:
        out["seq_model"] = str(e)
    return out if rank == 0 else None


def sp_card_gang(cfg_kwargs, flax_params, batches, lr, device=None):
    """SGD steps of ``fit`` on ``device`` (default: the gang's) under
    ``sequence_parallel`` on a ``{seq: world}`` mesh with ring and with
    Ulysses, every rank the whole batches: per method, rank 0's step
    losses and parameters, whether every rank holds the same parameters,
    and every rank's launches."""
    from machine_learning_apache_spark_tpu_torch.models.transformer import (
        Transformer,
        TransformerConfig,
    )
    from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop
    from machine_learning_apache_spark_tpu_torch.ops.attention import sequence_parallel
    from machine_learning_apache_spark_tpu_torch.parallel import make_mesh
    from machine_learning_apache_spark_tpu_torch.recipes.translation import make_translation_loss
    from machine_learning_apache_spark_tpu_torch.train.loop import fit
    from machine_learning_apache_spark_tpu_torch.train.state import TrainState, make_optimizer
    from machine_learning_apache_spark_tpu_torch.weights import load_flax_params

    rank, world = _rank_world()
    dev = _worker_device(device)
    mesh = make_mesh({"seq": world}, device=dev)
    out = {}
    for method in ("ring", "ulysses"):
        model = load_flax_params(Transformer(TransformerConfig(**cfg_kwargs)), flax_params).to(dev)
        hop.reset_launches()
        with sequence_parallel(mesh, method=method):
            res = fit(TrainState.create(model=model, tx=make_optimizer("sgd", lr)),
                      make_translation_loss(0), batches, epochs=1, mesh=mesh, log_every=0)
        launches = [None] * world
        dist.all_gather_object(launches, dict(hop.LAUNCHES))
        mine = [t.detach().cpu().numpy() for t in model.state_dict().values()]
        every = [None] * world
        dist.all_gather_object(every, mine)
        out[method] = {
            "device": str(dev), "mesh": dict(mesh.shape), "step_losses": res.step_losses,
            "params": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
            "ranks_equal": all(all(np.array_equal(a, b) for a, b in zip(e, every[0])) for e in every),
            "launches": launches}
    return out if rank == 0 else None
