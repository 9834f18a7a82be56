"""Programs captured once and replayed: the port's compile-at-warmup cache.

The counterpart of a ``jax.jit`` callable with its cache, and of
``utils/compilation_cache.jit_cache_size`` in the JAX package, which the
JAX serving engine reads for ``compile_count()``. On the card a program
that is built once and replayed is a CUDA graph:

- ``ProgramCache(device)`` holds one runtime's or one engine's programs.
  ``cache(name, fn, *args)`` keys a program by ``name`` and the signature
  of ``args``: each tensor's shape and dtype, and every other argument's
  value (static ints, flags).
- On a CUDA device the first call of a key fills static input buffers
  from ``args``, runs ``fn`` eagerly on a side stream (which builds the
  kernels and warms cuBLAS and the caching allocator), captures it into a
  ``torch.cuda.CUDAGraph`` over those buffers, then replays it. A later
  call copies its tensors into the static buffers (``non_blocking``) and
  replays.
- ``ProgramCache(device, eager_first_call=True)`` is for programs that
  change state (a training step updates parameters and optimizer state
  in place) or that should not run twice on their first call (a one-shot
  decoder): the eager run on the side stream *is* the first call, and
  the capture that follows executes nothing. Later calls replay.
- ``generators``: ``torch.Generator``s on the card that ``fn`` draws from
  (dropout). They are registered with every graph
  (``CUDAGraph.register_generator_state``), so a replay draws the bits
  eager execution would and advances each generator as far.
- Outputs: a call returns the program's outputs; after a replay these
  are its static outputs, which the next replay overwrites. A caller
  that keeps an output past its next call copies it (``clone()``, or a
  copy to the host).
- All programs of one cache share one memory pool: they never run at
  once.
- A capture that fails raises. There is no fallback to eager execution
  on the card.
- On the CPU every call runs ``fn`` eagerly, but the keys are counted
  the same way, so the counting contract holds (and is tested) on the
  CPU too.

``size()`` is the number of keys: the programs this cache compiled.

What ``fn`` may do: take the static buffers as its inputs (host tensors
in ``args`` arrive as device tensors), read and write tensors that live
as long as the cache (weights, page stores, parameters and optimizer
state), draw from the registered generators, and allocate what it
returns. It may not synchronise with the host (``.item()``, ``.cpu()``,
``nonzero``) or change host state that a replay would have to change
again (a Python counter: the caller advances those after each call).
Without ``eager_first_call``, running it twice with the same inputs must
write the same values (the warm run and the first replay both run it).
One thread uses a cache at a time; captures are made in
``thread_local`` mode, so another thread's CUDA calls do not break them.

Kernel launches: a launch made inside a capture is recorded, not counted
(``ops.hopper_attention.recorded_launches``), and every replay adds what
its capture recorded to ``LAUNCHES``, so the counts equal eager
execution's. ``stats()`` lists, per program, its calls and replays and
the launches of one replay beside those of the eager warm run.
"""

from __future__ import annotations

import torch

from machine_learning_apache_spark_tpu_torch.ops import hopper_attention as hop


def signature(args) -> tuple:
    """The key part of ``args``: ``(shape, dtype)`` of each tensor, the
    value of anything else."""
    return tuple(
        (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
        for a in args
    )


def _tensors(out):
    """The tensors of a program's output: a tensor, or a tuple, list or
    dict of them (nested)."""
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


class _Eager:
    """A CPU program: ``fn`` called on the arguments as they are."""

    def __init__(self):
        self.calls = self.replays = 0
        self.launches = self.eager_launches = {}

    def __call__(self, fn, args):
        self.calls += 1
        self.replays += 1
        return fn(*args)


class _Graph:
    """One captured CUDA graph over static input buffers. It keeps no
    reference to ``fn``, whose owner holds the cache: no cycle keeps a
    dropped engine's graphs and their memory alive."""

    def __init__(self, fn, args, device: torch.device, pool, eager_first_call: bool,
                 generators):
        self.static = [
            torch.empty(a.shape, dtype=a.dtype, device=device)
            if isinstance(a, torch.Tensor) else a
            for a in args
        ]
        self._fill(args)
        stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(stream)
        with torch.cuda.stream(side), hop.recorded_launches(counted=True) as eager:
            first = fn(*self.static)
        stream.wait_stream(side)
        # The first call's outputs were allocated on the side stream and
        # are handed to work on this one.
        for t in _tensors(first):
            t.record_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        with hop.recorded_launches(counted=False) as captured, torch.cuda.graph(
            self.graph, pool=pool, capture_error_mode="thread_local"
        ):
            self.out = fn(*self.static)
        self.eager_launches = {k: n for k, n in eager.items() if n}
        self.launches = {k: n for k, n in captured.items() if n}
        self.first = first if eager_first_call else None
        self.calls = self.replays = 0

    def _fill(self, args) -> None:
        for buf, a in zip(self.static, args):
            if isinstance(a, torch.Tensor):
                buf.copy_(a, non_blocking=True)

    def __call__(self, fn, args):
        self.calls += 1
        if self.first is not None:  # the eager run was this call
            out, self.first = self.first, None
            return out
        self._fill(args)
        self.graph.replay()
        hop.add_launches(self.launches)
        self.replays += 1
        return self.out


class ProgramCache:
    """One runtime's, engine's or training run's programs, keyed by name
    and signature; CUDA graphs on the card, eager calls (counted alike)
    on the CPU. ``eager_first_call`` and ``generators``: see the module
    docstring."""

    def __init__(self, device, *, eager_first_call: bool = False, generators=()):
        self.device = torch.device(device)
        self._pool = (
            torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        )
        self._eager_first_call = eager_first_call
        self._generators = tuple(generators)
        self._programs: dict[tuple, _Eager | _Graph] = {}

    def __call__(self, name: str, fn, *args):
        key = (name, *signature(args))
        program = self._programs.get(key)
        if program is None:
            if self._pool is None:
                program = _Eager()
            else:
                with torch.cuda.device(self.device):
                    program = _Graph(
                        fn, args, self.device, self._pool,
                        self._eager_first_call, self._generators,
                    )
            self._programs[key] = program
        return program(fn, args)

    def size(self) -> int:
        """The number of programs: distinct (name, signature) keys."""
        return len(self._programs)

    def stats(self) -> list[dict]:
        """Per program: its key, its calls, its replays (calls, on the
        CPU; calls after the first, on the card with
        ``eager_first_call``), and the kernel launches of one replay and
        of the eager warm run (equal, unless a capture recorded other
        launches than eager code makes; empty on the CPU, where no kernel
        launches)."""
        return [
            dict(
                name=key[0],
                signature=[
                    [list(s[0]), str(s[1])] if isinstance(s, tuple) else s
                    for s in key[1:]
                ],
                calls=p.calls,
                replays=p.replays,
                launches=dict(p.launches),
                eager_launches=dict(p.eager_launches),
            )
            for key, p in self._programs.items()
        ]
