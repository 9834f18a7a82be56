"""Scaled dot-product attention — the model's attention entry points.

The reference's innermost compute (``scaled_dot_product``,
``transformer.py:12-25``) is QKᵀ/√d → mask → softmax → ·V, with boolean
masks (True = attendable) applied as ``where(mask, scores, -inf)`` before
the softmax, and independent query/key lengths.

- ``scaled_dot_product_attention`` — plain PyTorch over a dense mask;
- ``dot_product_attention`` — the model's dispatcher: a dense ``mask``
  takes the plain path (an arbitrary mask cannot stream through the
  blockwise kernel); structured ``causal`` + ``kv_valid`` masks go to
  ``flash_attention`` (the Hopper kernel on the card, its plain version
  on the CPU). Unlike the TPU gate there is no head-dim condition: every
  CUDA tensor takes the kernel;
- ``ragged_paged_attention`` — one decode step over a paged KV store
  (the Hopper kernel on the card, its plain version on the CPU).

Two contexts steer ``dot_product_attention``, as in the JAX package (each
a stack, so they nest):

- ``sequence_parallel(mesh, method=...)`` routes self-attention-shaped
  sites through ring or Ulysses attention over the mesh's ``"seq"`` axis
  (``parallel.sequence.sequence_parallel_attention``): the model code
  never changes;
- ``attention_impl("dense" | "flash")`` pins the structured-mask path:
  ``"dense"`` is the plain ``scaled_dot_product_attention`` over the
  materialised ``[Sq, Sk]`` mask (the reference's core, for the
  long-context bench's contrast), ``"flash"`` the kernel path. An active
  ``sequence_parallel`` context still wins.
"""

from __future__ import annotations

import contextlib
import math

import torch

from machine_learning_apache_spark_tpu_torch.ops.hopper_attention import (
    NEG_INF,
    flash_attention,
    ragged_paged_attention,
)
from machine_learning_apache_spark_tpu_torch.ops.masks import (
    combine_masks,
    make_causal_mask,
)

__all__ = [
    "NEG_INF",
    "attention_impl",
    "dot_product_attention",
    "multi_head_attention_weights",
    "ragged_paged_attention",
    "scaled_dot_product_attention",
    "sequence_parallel",
]

# Active sequence-parallel contexts (a stack, so they nest): while one is
# set, ``dot_product_attention`` sends self-attention-shaped sites through
# the seq line's ring or Ulysses attention.
_SEQ_PARALLEL_CTX: list[tuple] = []


@contextlib.contextmanager
def sequence_parallel(
    mesh,
    *,
    seq_axis: str = "seq",
    batch_axis: str = "data",
    method: str = "ring",
):
    """Route the model's attention sites through sequence-parallel
    attention on ``mesh`` — ``method="ring"`` (K/V chunks rotate around
    the seq line; any head count) or ``method="ulysses"`` (head↔sequence
    all-to-alls; needs ``num_heads % seq_axis_size == 0``).

    Usage (inside a gang, a ``data × seq`` mesh; no model change):

    >>> with sequence_parallel(mesh):
    ...     result = fit(state, loss_fn, loader, mesh=mesh, ...)

    Dispatch per site (``dot_product_attention``): a site with no dense
    mask whose q, k and v have one shape, whose length divides over the
    ``seq_axis`` and whose batch fills this process's rows of the data
    axis goes through the mechanism — the MT model's cross-attention too
    when both lengths are ``max_len``; other sites (``Sq != Sk``, decode
    steps, dense masks) keep their usual paths. Every rank of a seq line
    must run the same sites in the same order."""
    if seq_axis not in mesh.shape:
        raise ValueError(f"mesh {dict(mesh.shape)} has no '{seq_axis}' axis")
    if method not in ("ring", "ulysses"):
        raise ValueError(f"method must be 'ring' or 'ulysses', got {method!r}")
    _SEQ_PARALLEL_CTX.append((mesh, seq_axis, batch_axis, method))
    try:
        yield
    finally:
        _SEQ_PARALLEL_CTX.pop()


def _active_seq_mesh():
    return _SEQ_PARALLEL_CTX[-1] if _SEQ_PARALLEL_CTX else None


# Pinned implementation for structured-mask sites (a stack, so contexts
# nest); empty = the kernel path.
_FORCED_IMPL: list[str] = []


@contextlib.contextmanager
def attention_impl(impl: str):
    """Pin the structured-mask attention implementation inside the block:
    ``"dense"`` (the plain ``[Sq, Sk]`` path) or ``"flash"`` (the kernel
    path, the default). Benchmarking hook: the long-context bench
    measures the kernel against the dense path it replaces at each
    length. Dense-mask sites never go to the kernel, and an active
    ``sequence_parallel`` context still wins."""
    if impl not in ("dense", "flash"):
        raise ValueError(f"impl must be 'dense' or 'flash', got {impl!r}")
    _FORCED_IMPL.append(impl)
    try:
        yield
    finally:
        _FORCED_IMPL.pop()


def multi_head_attention_weights(
    query: torch.Tensor,
    key: torch.Tensor,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """``softmax(QKᵀ/√d)`` with boolean masking, in float32 — the first
    half of ``scaled_dot_product`` (``transformer.py:17-24``)."""
    scores = torch.matmul(query, key.transpose(-1, -2))
    scores = scores / math.sqrt(query.shape[-1])
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    weights = torch.softmax(scores.float(), dim=-1)
    return weights.to(query.dtype)


def scaled_dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    return_weights: bool = False,
):
    """Attention over ``[..., S, d]`` streams with a dense boolean
    ``mask`` broadcastable to ``[..., Sq, Sk]`` (True = attendable)."""
    weights = multi_head_attention_weights(query, key, mask)
    values = torch.matmul(weights, value)
    if return_weights:
        return values, weights
    return values


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: torch.Tensor | None = None,
    *,
    causal: bool = False,
    kv_valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dispatching attention used by the model: structured masks only →
    ``flash_attention``; a dense ``mask`` (combined with any structured
    one), or ``attention_impl("dense")`` → ``scaled_dot_product_attention``.

    Under an active ``sequence_parallel(mesh)`` context a site with no
    dense mask, q/k/v of one shape, a length divisible by the seq axis and
    a batch that fills this process's rows of the data axis goes through
    the context's mechanism (the JAX rule); Ulysses with a head count the
    seq axis cannot divide raises ``ValueError`` instead of falling
    through."""
    ctx = _active_seq_mesh()
    if ctx is not None and mask is None:
        from machine_learning_apache_spark_tpu_torch.parallel.sequence import (
            rows_per_process,
            sequence_parallel_attention,
        )

        mesh, seq_axis, batch_axis, method = ctx
        n = mesh.axis_size(seq_axis)
        if (
            query.shape == key.shape == value.shape
            and query.shape[2] % n == 0
            # A batch must fill this process's rows of the batch axis.
            and query.shape[0] % rows_per_process(mesh, batch_axis) == 0
        ):
            if method == "ulysses" and query.shape[1] % n:
                # A model-config error, not a fall-through: running the
                # ring (or one rank) would misreport the mechanism.
                raise ValueError(
                    f"sequence_parallel(method='ulysses') needs num_heads "
                    f"({query.shape[1]}) divisible by the {seq_axis!r} axis "
                    f"({n}); use method='ring'"
                )
            return sequence_parallel_attention(
                query, key, value, mesh, method=method, causal=causal,
                kv_valid=kv_valid, seq_axis=seq_axis, batch_axis=batch_axis,
            )
    if mask is None and not (_FORCED_IMPL and _FORCED_IMPL[-1] == "dense"):
        return flash_attention(
            query, key, value, causal=causal, kv_valid=kv_valid
        )
    if kv_valid is not None:
        mask = combine_masks(mask, kv_valid[:, None, None, :])
    if causal:
        mask = combine_masks(
            mask,
            make_causal_mask(query.shape[-2], key.shape[-2], device=query.device),
        )
    return scaled_dot_product_attention(query, key, value, mask)
