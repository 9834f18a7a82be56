"""Expert parallelism over the mesh's ``"expert"`` axis.

The JAX package has no such file: its MoE weights carry the logical axis
``"expert"`` on their leading dim (``models/moe.py``), the rules map it
to the mesh's expert axis, and XLA partitions the dispatch and combine
einsums itself. Here the placement is ``tensor_parallel.shard_params``'s
(rank ``r`` of an expert line keeps experts ``[r·E/N, (r+1)·E/N)`` of
``w_up`` and ``w_down``), and the collectives are scheduled by hand in
two autograd ``Function``s over this rank's line of the expert axis,
``ExpertAxis``:

- ``copy_to_expert``: identity forward, all-reduce of the gradient
  backward — on the copy of ``x`` that feeds this rank's dispatch einsum
  and on the gate as it enters its combine, whose gradients each rank
  holds only for the tokens routed to its own experts;
- ``reduce_from_expert``: all-reduce forward, identity backward — on
  this rank's combine, which holds the outputs of the tokens its experts
  took (zeros elsewhere), so the sum is the whole layer's output.

They are all-reduces, not the all-to-all the JAX module's docstring
names: the batch is sharded over ``"data"`` only (``shard_batch``), so
every rank of an expert line already holds every row, and routing runs
replicated on each. An all-to-all would pay off only with the rows split
over the line as well. The router, its softmax, the capacity assignment
and the load-balancing loss stay replicated and outside both
``Function``s: their gradients are the same on every rank of the line,
so an all-reduce there would multiply them by N.

Every expert-axis all-reduce is host-timed into the model's ``EPComms``
(``comms.ep_allreduce`` spans: count, bytes, the window per step).
"""

from __future__ import annotations

import torch

from machine_learning_apache_spark_tpu_torch.parallel.mesh import EXPERT_AXIS, TimedCollectives
from machine_learning_apache_spark_tpu_torch.parallel.tensor_parallel import (
    AxisLine,
    _CopyToLine,
    _ReduceFromLine,
)


class EPComms(TimedCollectives):
    """Host-timed expert-axis all-reduces (``comms.ep_allreduce`` spans),
    each step's window, and the bytes."""

    KINDS = ("ep_allreduce",)
    STEPS = "ep_allreduce_steps"


class ExpertAxis(AxisLine):
    """This rank's line of the mesh's expert axis: ``size`` ranks, this
    one at ``index``, and the timed collectives over them."""

    AXIS, KIND, COMMS = EXPERT_AXIS, "ep_allreduce", EPComms

    def experts(self, num_experts: int) -> slice:
        """The experts this rank holds of ``num_experts``."""
        per = num_experts // self.size
        return slice(self.index * per, (self.index + 1) * per)


def copy_to_expert(x: torch.Tensor, axis: ExpertAxis) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the expert axis."""
    return _CopyToLine.apply(x, axis)


def reduce_from_expert(x: torch.Tensor, axis: ExpertAxis) -> torch.Tensor:
    """``x`` summed over the expert axis; the gradient passed through."""
    return _ReduceFromLine.apply(x, axis)


__all__ = ["EPComms", "ExpertAxis", "copy_to_expert", "reduce_from_expert"]
