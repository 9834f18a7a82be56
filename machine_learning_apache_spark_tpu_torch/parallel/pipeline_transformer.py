"""The encoder-decoder Transformer over a ``"pipeline"`` mesh axis — the
port of ``machine_learning_apache_spark_tpu/parallel/pipeline_transformer.py``.

As in the JAX package: the embeddings and the LM head stay outside the
pipelined region (every rank of the line computes them), the encoder
stack and then the decoder stack each run as a GPipe ring
(``parallel.pipeline_parallel.pipeline_apply``) with ``num_layers / S``
layers per stage, the encoder ring's aux carries the source validity and
the decoder ring's ``(memory, target validity, source validity)``, and
``cfg.remat`` recomputes each layer in the backward. MoE layers and a
layer count the stages do not divide raise the JAX ``ValueError``s.

Each rank runs only its stage's layers (``Encoder.run_layers`` /
``Decoder.run_layers``), so a step launches the flash forward, dQ and
dK/dV ``3 · (num_layers / S) · M`` times per rank: encoder
self-attention, decoder self-attention and cross-attention for each of
its layers and microbatches.

Dropout draws from the one generator the caller passes — in ``fit`` the
rank's own, seeded by the fit's seed, the data index and the stage — on
each stage for its own layers, microbatch after microbatch. The JAX
package folds a key per (microbatch, stage, layer, data index): both are
valid dropout patterns, neither is the sequential path's, and they
differ from each other in distribution only.

The model's parameters stay whole on every rank (the JAX memory note:
the ``TrainState`` is replicated; only compute and activations are
pipelined): ``fit`` syncs each stage's gradients from the stage that
computed them (``pipeline_parallel.GradSync``), so every rank applies
the same update.
"""

from __future__ import annotations

import torch

from machine_learning_apache_spark_tpu_torch.parallel.mesh import PIPELINE_AXIS
from machine_learning_apache_spark_tpu_torch.parallel.pipeline_parallel import pipeline_apply


def stage_layers(stack, n_stages: int) -> list:
    """``stack.layers`` cut into ``n_stages`` consecutive runs of
    ``num_layers / n_stages`` (stage ``s`` holds layers ``[s·L/S,
    (s+1)·L/S)``, the JAX ``_stack_layer_params`` order)."""
    per = len(stack.layers) // n_stages
    return [stack.layers[s * per:(s + 1) * per] for s in range(n_stages)]


def pipeline_transformer_logits(
    model,
    src_tokens: torch.Tensor,
    trg_in: torch.Tensor,
    mesh,
    *,
    n_micro: int | None = None,
    generator: torch.Generator | None = None,
    deterministic: bool = True,
) -> torch.Tensor:
    """Teacher-forced logits for ``(src, trg_in)`` with both layer stacks
    pipelined over the mesh's ``"pipeline"`` axis: the same function as
    ``model(src, trg_in)`` (parity with the JAX function and the
    sequential forward is pinned by ``tests/test_torch_pipeline_parallel.py``),
    scheduled as two GPipe rings. ``trg_in`` is the decoder input (the
    caller's ``trg[:, :-1]``). With ``generator`` and
    ``deterministic=False`` dropout runs, from ``generator``."""
    cfg = model.cfg
    if cfg.moe_experts:
        raise ValueError("pipeline parallelism does not support MoE layers")
    n_stages = mesh.axis_size(PIPELINE_AXIS)
    if cfg.num_layers % n_stages:
        raise ValueError(
            f"num_layers={cfg.num_layers} not divisible by {n_stages} pipeline stages"
        )
    per = cfg.num_layers // n_stages
    rng = None if deterministic else generator
    pad = cfg.pad_id
    src_valid = src_tokens != pad
    trg_valid = trg_in != pad
    x = model.encoder.embed(src_tokens, dropout_rng=rng)
    y = model.decoder.embed(trg_in, dropout_rng=rng)

    def enc_stage(layers, h, aux_m, rep_m, stage_id, tick):
        (valid,) = aux_m
        return model.encoder.run_layers(
            h, stage_id * per, (stage_id + 1) * per, None, valid, dropout_rng=rng,
        )

    memory = pipeline_apply(
        enc_stage, stage_layers(model.encoder, n_stages), x, mesh,
        n_micro=n_micro, aux=(src_valid,),
    )

    def dec_stage(layers, h, aux_m, rep_m, stage_id, tick):
        mem, tv, sv = aux_m
        return model.decoder.run_layers(
            h, stage_id * per, (stage_id + 1) * per, mem, None, None, tv, sv,
            self_causal=True, dropout_rng=rng,
        )

    y = pipeline_apply(
        dec_stage, stage_layers(model.decoder, n_stages), y, mesh,
        n_micro=n_micro, aux=(memory, trg_valid, src_valid),
    )
    return model.logits(y)


__all__ = ["pipeline_transformer_logits", "stage_layers"]
