"""Text-in/text-out inference over the port's MT Transformer.

A ``Translator`` bundles a model with the pipelines that tokenize its
input and detokenize its output, translates raw strings greedily, and
serves concurrent callers through the paged engine (``serve()``). It runs
on the card unless ``device="cpu"`` is passed; with no card and no
explicit device it raises.

Not ported yet (ROADMAP): beam and sampling decoders, ``save``/``load``.

>>> t = Translator(model, src_pipe, trg_pipe)        # on the card
>>> t(["a sentence to translate"])                   # → ["ein satz ..."]
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from machine_learning_apache_spark_tpu_torch.data.text import (
    EOS_ID,
    SOS_ID,
    TextPipeline,
)
from machine_learning_apache_spark_tpu_torch.models import (
    Transformer,
    greedy_translate,
)
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device


def strip_special_ids(
    ids, *, pad_id: int = 0, sos_id: int = 1, eos_id: int = 2
) -> list[list[int]]:
    """Decoder output rows → clean token-id lists: drop the leading ``sos``,
    cut at the first ``eos``, drop pads — the form BLEU scores."""
    out = []
    for row in np.asarray(ids):
        toks = [int(t) for t in row]
        if toks and toks[0] == sos_id:
            toks = toks[1:]
        if eos_id in toks:
            toks = toks[: toks.index(eos_id)]
        out.append([t for t in toks if t != pad_id])
    return out


class Translator:
    """MT model + its tokenize/detokenize pipelines, callable on raw
    strings. The model is moved to ``device`` and put in eval mode."""

    def __init__(
        self,
        model: Transformer,
        src_pipe: TextPipeline,
        trg_pipe: TextPipeline,
        *,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.src_pipe = src_pipe
        self.trg_pipe = trg_pipe

    def __call__(
        self,
        texts: Sequence[str],
        *,
        method: str = "greedy",
        max_new_tokens: int | None = None,
    ) -> list[str]:
        if method in ("beam", "sample"):
            raise NotImplementedError(
                f"method={method!r} is not ported yet (ROADMAP.md, queue A)"
            )
        if method != "greedy":
            raise ValueError(
                f"method must be 'greedy', 'beam', or 'sample', got {method!r}"
            )
        src = torch.as_tensor(
            self.src_pipe(list(texts)), dtype=torch.long, device=self.device
        )
        ys = greedy_translate(
            self.model, src, max_new_tokens=max_new_tokens,
            sos_id=SOS_ID, eos_id=EOS_ID,
        )
        rows = strip_special_ids(
            ys.cpu().numpy(), pad_id=self.model.cfg.pad_id,
            sos_id=SOS_ID, eos_id=EOS_ID,
        )
        vocab = self.trg_pipe.vocab
        return [" ".join(vocab.lookup_tokens(row)) for row in rows]

    def serve(self, *, start: bool = True, **engine_kwargs):
        """Continuous-batching paged server over this translator: requests
        decode out of a shared paged KV store, with chunk-padded prefill
        and an LRU prefix cache so repeated prompts skip their prefill.
        ``kv_dtype="int8"`` (or env ``MLSPARK_SERVE_KV_DTYPE``) stores the
        pages in int8 with per-page scales. Outputs equal ``__call__``'s.

        >>> with t.serve(max_active=32, boundaries=(32, 64)) as eng:
        ...     futs = [eng.submit(s) for s in sentences]
        ...     outs = [f.result(timeout=30) for f in futs]

        ``start=False`` returns an unstarted engine; otherwise it arrives
        warmed up and serving. Knobs pass through to
        ``serving.ServingEngine``.
        """
        from machine_learning_apache_spark_tpu_torch.serving import ServingEngine

        engine = ServingEngine(self, **engine_kwargs)
        return engine.start() if start else engine
