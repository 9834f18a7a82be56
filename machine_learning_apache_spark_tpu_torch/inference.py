"""Text-in/text-out inference over the port's MT Transformer.

A ``Translator`` bundles a model with the pipelines that tokenize its
input and detokenize its output, translates raw strings with any of the
three KV-cache decoders (greedy, beam, sampling), and serves concurrent
callers through the serving engine (``serve()``). It runs on the card
unless ``device="cpu"`` is passed; with no card and no explicit device it
raises.

Not ported yet (ROADMAP): ``save``/``load``.

>>> t = Translator(model, src_pipe, trg_pipe)        # on the card
>>> t(["a sentence to translate"])                   # → ["ein satz ..."]
"""

from __future__ import annotations

from typing import Sequence

import torch

from machine_learning_apache_spark_tpu_torch.data.text import (
    EOS_ID,
    SOS_ID,
    TextPipeline,
)
from machine_learning_apache_spark_tpu_torch.models import (
    Transformer,
    beam_translate,
    greedy_translate_cached,
    sample_translate,
)
from machine_learning_apache_spark_tpu_torch.train.metrics import strip_special_ids
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device


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
        beam_size: int = 4,
        length_penalty: float = 0.6,
        temperature: float = 1.0,
        top_k: int | None = None,
        top_p: float | None = None,
        rng: torch.Generator | None = None,
    ) -> list[str]:
        """Translate ``texts``: ``method="greedy"`` (KV-cache),
        ``"beam"`` (``beam_size``, ``length_penalty``) or ``"sample"``
        (``temperature``, ``top_k``, ``top_p``, and ``rng``, a
        ``torch.Generator`` on the translator's device: required, so
        that repeated calls do not return the same "samples")."""
        if method not in ("greedy", "beam", "sample"):
            raise ValueError(
                f"method must be 'greedy', 'beam', or 'sample', got {method!r}"
            )
        if method == "sample" and rng is None:
            raise ValueError(
                "method='sample' requires an explicit rng (e.g. "
                "rng=torch.Generator(translator.device).manual_seed(seed))"
            )
        src = torch.as_tensor(
            self.src_pipe(list(texts)), dtype=torch.long, device=self.device
        )
        kw = dict(max_new_tokens=max_new_tokens, sos_id=SOS_ID, eos_id=EOS_ID)
        if method == "greedy":
            ys = greedy_translate_cached(self.model, src, **kw)
        elif method == "beam":
            ys = beam_translate(
                self.model, src,
                beam_size=beam_size, length_penalty=length_penalty, **kw,
            )
        else:
            ys = sample_translate(
                self.model, src, rng,
                temperature=temperature, top_k=top_k, top_p=top_p, **kw,
            )
        rows = strip_special_ids(
            ys, pad_id=self.model.cfg.pad_id,
            sos_id=SOS_ID, eos_id=EOS_ID,
        )
        vocab = self.trg_pipe.vocab
        return [" ".join(vocab.lookup_tokens(row)) for row in rows]

    def serve(self, *, start: bool = True, **engine_kwargs):
        """Continuous-batching server over this translator. By default
        (``kv_mode="paged"``) requests decode out of a shared paged KV
        store, with chunk-padded prefill and an LRU prefix cache so
        repeated prompts skip their prefill; ``kv_dtype="int8"`` (or env
        ``MLSPARK_SERVE_KV_DTYPE``) stores the pages in int8 with
        per-page scales. ``kv_mode="padded"`` (or env
        ``MLSPARK_SERVE_KV_MODE``) runs shape-bucketed batches through the
        KV-cache decoder, which ``method="beam"`` always takes. Greedy
        outputs equal ``__call__``'s in both modes.

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
