"""Inference over the port's models — the port of
``machine_learning_apache_spark_tpu/inference.py``.

A ``Classifier`` wraps a trained zoo model (MLP, TinyVGG, LSTMClassifier)
and, for text, the pipeline that made its ids, and predicts classes or
probabilities from raw inputs. A ``Translator`` bundles the MT model with
the pipelines that tokenize its input and detokenize its output,
translates raw strings with any of the three KV-cache decoders (greedy,
beam, sampling) and serves concurrent callers through the serving engine
(``serve()``). Both round-trip through ``save``/``load``: the JAX
package's JSON metadata beside the params in the port's own format, so a
trained model is a directory, not a process lifetime. Both run on the
card unless ``device="cpu"`` is passed; with no card and no explicit
device they raise.

>>> t = Translator(model, src_pipe, trg_pipe)        # on the card
>>> t(["a sentence to translate"])                   # → ["ein satz ..."]
>>> t.save("/models/en_de"); t2 = Translator.load("/models/en_de")
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Sequence

import numpy as np
import torch

from machine_learning_apache_spark_tpu_torch import models as zoo
from machine_learning_apache_spark_tpu_torch.data.text import (
    EOS_ID,
    SOS_ID,
    TextPipeline,
    Vocab,
    get_tokenizer,
)
from machine_learning_apache_spark_tpu_torch.models import (
    Transformer,
    TransformerConfig,
    beam_translate,
    greedy_translate_cached,
    sample_translate,
)
from machine_learning_apache_spark_tpu_torch.train.checkpoint import (
    load_params,
    save_params,
)
from machine_learning_apache_spark_tpu_torch.train.metrics import strip_special_ids
from machine_learning_apache_spark_tpu_torch.utils.device import resolve_device
from machine_learning_apache_spark_tpu_torch.utils.graph_cache import ProgramCache

#: ``TransformerConfig`` fields of the JAX package that the port's config
#: lacks, as ``{name: (default, ROADMAP item)}``: what ``translator.json``
#: records for a port model, and a saved config that sets one away from
#: its default cannot load here. Every field is ported (``remat`` and the
#: ``moe_*`` fields since the MoE slice), so it is empty.
UNPORTED_CONFIG: dict[str, tuple] = {}


def _check_registered_tokenizer(pipe: TextPipeline) -> None:
    """The recorded tokenizer name must resolve from the registry on a
    fresh process — and to the SAME callable this pipeline used (a custom
    function whose ``__name__`` shadows a registry key would be silently
    swapped for the built-in on load, tokenizing differently)."""
    name = pipe.spec["tokenizer"]
    try:
        resolved = get_tokenizer(name)
    except Exception as e:
        raise ValueError(
            f"tokenizer {name!r} is not a registered name; save requires "
            "pipelines built with a registry tokenizer so load() can "
            "rebuild them — register custom callables via "
            "data.text.register_tokenizer(name, fn) before building the "
            "pipeline"
        ) from e
    if resolved is not pipe.tokenizer:
        raise ValueError(
            f"tokenizer {name!r} resolves to a different callable than "
            "this pipeline uses; register the custom tokenizer under its "
            "own name (data.text.register_tokenizer) before saving"
        )


def _overwrite_params(path: str, model: torch.nn.Module) -> None:
    """Clear a stale params tree, then save."""
    if os.path.exists(path):
        shutil.rmtree(path)
    save_params(path, model)


def config_to_json(cfg: TransformerConfig) -> dict:
    """The JAX package's ``translator.json`` ``config``: every field of its
    ``TransformerConfig``, ``dtype`` by name."""
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(cfg.dtype).removeprefix("torch.")
    out.update({k: default for k, (default, _) in UNPORTED_CONFIG.items()})
    return out


def config_from_json(saved: dict) -> TransformerConfig:
    cfg = dict(saved)
    for name, (default, item) in UNPORTED_CONFIG.items():
        if cfg.pop(name, default) != default:
            raise NotImplementedError(
                f"translator config {name}={saved[name]!r} is not ported yet "
                f"(ROADMAP queue {item})"
            )
    unknown = sorted(set(cfg) - {f.name for f in dataclasses.fields(TransformerConfig)})
    if unknown:
        raise NotImplementedError(
            f"translator config fields {unknown} are not known to the port's "
            "TransformerConfig"
        )
    cfg["dtype"] = getattr(torch, cfg["dtype"])
    return TransformerConfig(**cfg)


_ACTIVATIONS = {"sigmoid": torch.sigmoid, "relu": torch.relu, "tanh": torch.tanh}


def _model_spec(model: torch.nn.Module) -> dict:
    """The JAX ``classifier.json``'s ``model_class``/``model_kwargs`` for a
    zoo model: its fields (``model.config()``) with activations as
    ``{"__activation__": name}``, dtypes as ``{"__dtype__": name}`` and
    tuples as lists."""
    names = {fn: name for name, fn in _ACTIVATIONS.items()}
    kwargs = {}
    for field, v in model.config().items():
        if isinstance(v, torch.dtype):
            kwargs[field] = {"__dtype__": str(v).removeprefix("torch.")}
        elif callable(v):
            if v not in names:
                raise ValueError(
                    f"field {field!r} holds an unserializable callable "
                    f"{v!r}; use one of {sorted(names.values())}"
                )
            kwargs[field] = {"__activation__": names[v]}
        elif isinstance(v, (list, tuple)):
            kwargs[field] = list(v)
        else:
            kwargs[field] = v
    return {"model_class": type(model).__name__, "model_kwargs": kwargs}


def _model_from_spec(spec: dict, params: dict) -> torch.nn.Module:
    """The zoo model ``spec`` names, shaped to hold ``params`` (a saved
    ``state_dict``) and loaded from it."""
    cls = getattr(zoo, spec["model_class"])
    kwargs = {}
    for k, v in spec["model_kwargs"].items():
        if isinstance(v, dict) and "__activation__" in v:
            kwargs[k] = _ACTIVATIONS[v["__activation__"]]
        elif isinstance(v, dict) and "__dtype__" in v:
            kwargs[k] = getattr(torch, v["__dtype__"])
        elif isinstance(v, list):
            kwargs[k] = tuple(v)
        else:
            kwargs[k] = v
    if cls is zoo.TinyVGG:
        # Flax sizes the head from a sample input; the saved params fix
        # only the channels and (H // 4)·(W // 4), and any input shape of
        # that area builds the same module.
        channels = params["block0_conv0.weight"].shape[1]
        area = params["classifier.weight"].shape[1] // kwargs["hidden_units"]
        kwargs["input_shape"] = (4 * area, 4, channels)
    model = cls(**kwargs)
    model.load_state_dict(params)
    return model


class Classifier:
    """Trained zoo classifier (MLP / TinyVGG / LSTMClassifier) + optional
    text pipeline, callable on raw inputs — the ``model.eval()`` +
    softmax→argmax block every reference script re-implements
    (``pytorch_cnn.py:154-176``), as a reusable predict surface.

    ``inputs``: feature arrays for MLP/CNN, raw strings (via ``pipeline``)
    or token-id arrays for the LSTM. ``last_timestep=True`` scores
    ``logits[:, -1, :]`` (the LSTM recipe's head, ``pytorch_lstm.py:160``);
    with ``head_pad_id`` set, each row's last non-pad position
    (``train.loop.select_last_valid``, the loss's own selection). The
    model is moved to ``device`` (the card unless ``"cpu"``); predictions
    come back on the host, ``batch_size`` rows per forward.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        *,
        pipeline: TextPipeline | None = None,
        last_timestep: bool = False,
        head_pad_id: int | None = None,
        batch_size: int = 256,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.pipeline = pipeline
        self.last_timestep = last_timestep
        self.head_pad_id = head_pad_id
        self.batch_size = batch_size

    @torch.no_grad()
    def _logits(self, inputs) -> torch.Tensor:
        from machine_learning_apache_spark_tpu_torch.train.loop import (
            select_last_valid,
        )

        # len()-based guards: bare truthiness on a multi-element array raises.
        if len(inputs) == 0:
            raise ValueError("predict called with an empty input batch")
        if self.pipeline is not None and isinstance(inputs[0], str):
            inputs = self.pipeline(list(inputs))
        x = torch.as_tensor(np.asarray(inputs))
        if not torch.is_floating_point(x):
            x = x.long()
        outs = []
        for i in range(0, len(x), self.batch_size):
            chunk = x[i : i + self.batch_size].to(self.device)
            logits = self.model(chunk)
            if self.last_timestep:
                if self.head_pad_id is not None:
                    logits = select_last_valid(logits, chunk, self.head_pad_id)
                else:
                    logits = logits[:, -1, :]
            outs.append(logits.float().cpu())
        return torch.cat(outs, dim=0)

    def predict_proba(self, inputs) -> torch.Tensor:
        return torch.softmax(self._logits(inputs), dim=-1)

    def predict(self, inputs) -> torch.Tensor:
        """argmax class ids — the reference's softmax→argmax eval pattern
        (softmax is monotonic, so argmax of logits suffices)."""
        return torch.argmax(self._logits(inputs), dim=-1)

    # -- persistence ----------------------------------------------------------
    def save(self, directory: str) -> None:
        """``params/`` (the port's own format, ``train.checkpoint.save_params``)
        and ``classifier.json`` (the JAX package's schema: the model class
        and fields, the head selection, the pipeline spec and vocab)."""
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        meta = {
            **_model_spec(self.model),
            "last_timestep": self.last_timestep,
            "head_pad_id": self.head_pad_id,
        }
        if self.pipeline is not None:
            _check_registered_tokenizer(self.pipeline)
            meta["pipeline"] = self.pipeline.spec
            meta["vocab"] = self.pipeline.vocab.itos
        # Params first, metadata last — a failed save can leave an old
        # params tree behind, but never NEW metadata pointing at OLD params.
        _overwrite_params(os.path.join(directory, "params"), self.model)
        with open(os.path.join(directory, "classifier.json"), "w") as fh:
            json.dump(meta, fh)

    @classmethod
    def load(
        cls, directory: str, *, device: str | torch.device | None = None
    ) -> "Classifier":
        """The classifier ``save`` wrote, on ``device`` (as ``__init__``)."""
        directory = os.path.abspath(directory)
        with open(os.path.join(directory, "classifier.json")) as fh:
            meta = json.load(fh)
        model = _model_from_spec(meta, load_params(os.path.join(directory, "params")))
        pipeline = None
        if "pipeline" in meta:
            spec = meta["pipeline"]
            pipeline = TextPipeline(
                Vocab(meta["vocab"], specials=()),
                spec["tokenizer"],
                max_seq_len=spec["max_seq_len"],
                fixed_len=spec["fixed_len"],
                add_sos=spec["add_sos"],
                add_eos=spec["add_eos"],
            )
        return cls(
            model,
            pipeline=pipeline,
            last_timestep=meta["last_timestep"],
            head_pad_id=meta.get("head_pad_id"),
            device=device,
        )


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
        # The one-shot greedy and beam decoders, one program per call
        # shape (a CUDA graph on the card, its first call the real one);
        # the lock keeps concurrent callers off one program's buffers.
        self._programs = ProgramCache(self.device, eager_first_call=True)
        self._lock = threading.Lock()

    def programs(self) -> ProgramCache:
        """The one-shot decoders' programs: one per (method, batch,
        source length, ``max_new_tokens``, beam size, length penalty)."""
        return self._programs

    def __call__(self, texts: Sequence[str], **kwargs) -> list[str]:
        """Translate ``texts`` (``translate_ids``' arguments) to text."""
        rows = strip_special_ids(
            self.translate_ids(texts, **kwargs), pad_id=self.model.cfg.pad_id,
            sos_id=SOS_ID, eos_id=EOS_ID,
        )
        vocab = self.trg_pipe.vocab
        return [" ".join(vocab.lookup_tokens(row)) for row in rows]

    def translate_ids(
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
    ) -> torch.Tensor:
        """The decoder's ids for ``texts`` (``[B, max_new_tokens + 1]``
        int64, on the host): ``method="greedy"`` (KV-cache), ``"beam"``
        (``beam_size``, ``length_penalty``) or ``"sample"``
        (``temperature``, ``top_k``, ``top_p``, and ``rng``, a
        ``torch.Generator`` on the translator's device: required, so
        that repeated calls do not return the same "samples"). Greedy and
        beam run as one program per call shape, keyed as a JAX retrace
        would be; sampling draws from the caller's generator and runs
        eagerly."""
        if method not in ("greedy", "beam", "sample"):
            raise ValueError(
                f"method must be 'greedy', 'beam', or 'sample', got {method!r}"
            )
        if method == "sample" and rng is None:
            raise ValueError(
                "method='sample' requires an explicit rng (e.g. "
                "rng=torch.Generator(translator.device).manual_seed(seed))"
            )
        src = torch.as_tensor(self.src_pipe(list(texts)), dtype=torch.long)
        if method == "sample":
            return sample_translate(
                self.model, src.to(self.device), rng,
                temperature=temperature, top_k=top_k, top_p=top_p,
                max_new_tokens=max_new_tokens, sos_id=SOS_ID, eos_id=EOS_ID,
            ).cpu()
        if method == "greedy":  # the beam knobs do not change its program
            beam_size, length_penalty = None, None
        with self._lock:
            ys = self._programs(
                method, self._decode, src, method, max_new_tokens,
                beam_size, length_penalty,
            )
            # Read back before the next call overwrites the outputs.
            return ys.cpu()

    def _decode(self, src, method, max_new_tokens, beam_size, length_penalty):
        """The greedy or beam decoder over ``src`` (a program's body)."""
        kw = dict(max_new_tokens=max_new_tokens, sos_id=SOS_ID, eos_id=EOS_ID)
        if method == "greedy":
            return greedy_translate_cached(self.model, src, **kw)
        return beam_translate(
            self.model, src, beam_size=beam_size, length_penalty=length_penalty, **kw,
        )

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

    # -- persistence ----------------------------------------------------------
    def save(self, directory: str) -> None:
        """One directory = one deployable model: ``params/`` (the port's
        own format, ``train.checkpoint.save_params``) and
        ``translator.json`` (the JAX package's schema: the config, both
        vocabularies' itos and both pipelines' specs)."""
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        # Fail at save time, not at load time with the model already
        # persisted unrecoverably.
        for pipe in (self.src_pipe, self.trg_pipe):
            _check_registered_tokenizer(pipe)
        meta = {
            "config": config_to_json(self.model.cfg),
            "src_vocab": self.src_pipe.vocab.itos,
            "trg_vocab": self.trg_pipe.vocab.itos,
            "src_pipe": self.src_pipe.spec,
            "trg_pipe": self.trg_pipe.spec,
        }
        # Params first, metadata last — a failed save can leave an old
        # params tree behind, but never a NEW translator.json pointing at
        # OLD params.
        _overwrite_params(os.path.join(directory, "params"), self.model)
        with open(os.path.join(directory, "translator.json"), "w") as fh:
            json.dump(meta, fh)

    @classmethod
    def load(
        cls, directory: str, *, device: str | torch.device | None = None
    ) -> "Translator":
        """The translator ``save`` wrote, on ``device`` (as ``__init__``)."""
        directory = os.path.abspath(directory)
        with open(os.path.join(directory, "translator.json")) as fh:
            meta = json.load(fh)
        model = load_params(
            os.path.join(directory, "params"),
            Transformer(config_from_json(meta["config"])),
        )

        def pipe(vocab_tokens, spec):
            # itos is the full ordered token list (specials included) —
            # rebuild verbatim with an empty specials prefix.
            return TextPipeline(
                Vocab(vocab_tokens, specials=()),
                spec["tokenizer"],
                max_seq_len=spec["max_seq_len"],
                fixed_len=spec["fixed_len"],
                add_sos=spec["add_sos"],
                add_eos=spec["add_eos"],
            )

        return cls(
            model,
            pipe(meta["src_vocab"], meta["src_pipe"]),
            pipe(meta["trg_vocab"], meta["trg_pipe"]),
            device=device,
        )
