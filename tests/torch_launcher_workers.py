"""Gang worker functions for the port's launcher, data-parallel and
session tests: each runs in every rank of a ``Distributor`` gang (by
reference, ``torch_launcher_workers:<name>``), and rank 0's return
value comes back to the test. Like the port itself, this module imports
torch and numpy, never JAX.
"""

from __future__ import annotations

import os

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
