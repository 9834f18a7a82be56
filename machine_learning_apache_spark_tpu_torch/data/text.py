"""Text preprocessing — tokenizer, vocab, transform chains (reference C13).

The reference builds its text pipelines twice, inline (SURVEY.md §1 L2):

- classification: ``get_tokenizer('basic_english')`` → vocab via
  ``build_vocab_from_iterator`` with specials ``['<pad>','<sos>','<eos>',
  '<unk>']``, ``special_first=True``, default index ``<unk>`` →
  ``VocabTransform → AddToken(sos, begin=True) → Truncate(128) →
  AddToken(eos, begin=False) → ToTensor(padding_value=0)``
  (``pytorch_lstm.py:51-83``, ``distributed_lstm.py:81-107``);
- translation: spacy en/de tokenizers, two vocabs, same chain but
  ``Truncate(199)`` + ``PadTransform(200, <pad>)`` so every sentence is
  exactly length 200 (``pytorch_machine_translator.py:20-98``).

Here the pipeline is one reusable module. Tokenization is pluggable (the
spacy-equivalent seam, SURVEY.md §2.2) with a ``basic_english`` default, and
everything happens *before* the compiled step — the reference tokenizes inside
the hot loop (``pytorch_lstm.py:148``, ``pytorch_machine_translator.py:156-161``),
which would starve a TPU (SURVEY.md §7 hard parts: input pipelines off the
hot path). Outputs are fixed-shape ``np.int32`` arrays, XLA-friendly.

Correctness deltas recorded in SURVEY.md §2.5: the vocab's default index is
its *own* ``<unk>`` (Q11 used a cross-vocab index), and ``padding_idx``
semantics use index 0 = ``<pad>`` (Q10 passed the token string ``'0'``).
"""

from __future__ import annotations

import re
from collections import Counter
from collections.abc import Callable, Iterable, Sequence

import numpy as np

# Special tokens, in the reference's order (special_first=True,
# ``pytorch_lstm.py:58-67``): indices 0..3.
PAD, SOS, EOS, UNK = "<pad>", "<sos>", "<eos>", "<unk>"
SPECIALS = (PAD, SOS, EOS, UNK)
PAD_ID, SOS_ID, EOS_ID, UNK_ID = 0, 1, 2, 3

# ------------------------------------------------------------------ tokenizers

# torchtext's basic_english: lowercase, punctuation split off as own tokens.
_BASIC_PATTERNS = [
    (re.compile(r"\'"), " '  "),
    (re.compile(r"\""), ""),
    (re.compile(r"\."), " . "),
    (re.compile(r"<br \/>"), " "),
    (re.compile(r","), " , "),
    (re.compile(r"\("), " ( "),
    (re.compile(r"\)"), " ) "),
    (re.compile(r"\!"), " ! "),
    (re.compile(r"\?"), " ? "),
    (re.compile(r"\;"), " "),
    (re.compile(r"\:"), " "),
    (re.compile(r"\s+"), " "),
]


def basic_english(text: str) -> list[str]:
    """The ``get_tokenizer('basic_english')`` rule set (``pytorch_lstm.py:51``):
    lowercase, strip double quotes, split sentence punctuation into their own
    tokens, collapse whitespace."""
    text = text.lower()
    for pattern, repl in _BASIC_PATTERNS:
        text = pattern.sub(repl, text)
    return text.split()


_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def word_punct(text: str) -> list[str]:
    """Language-neutral word/punctuation splitter — the pluggable stand-in for
    the reference's spacy ``de_core_news_sm``/``en_core_web_sm`` models
    (``pytorch_machine_translator.py:20-21``); spacy is not required."""
    return _WORD_RE.findall(text.lower())


_TOKENIZERS: dict[str, Callable[[str], list[str]]] = {
    "basic_english": basic_english,
    "word_punct": word_punct,
}


def register_tokenizer(
    name: str, fn: Callable[[str], list[str]], *, overwrite: bool = False
) -> None:
    """Register a custom tokenizer under ``name`` so pipelines built with it
    reconstruct by name — the requirement ``inference.Translator.save`` /
    ``Classifier.save`` enforce (a bare callable cannot be rebuilt by
    ``load()`` in a fresh process; re-register before loading there too).

    Shadowing a built-in (or an earlier registration) raises unless
    ``overwrite=True`` — a silent swap would tokenize differently than the
    vocab was built with.
    """
    if not callable(fn):
        raise TypeError(f"tokenizer must be callable, got {fn!r}")
    if name in _TOKENIZERS and _TOKENIZERS[name] is not fn and not overwrite:
        raise ValueError(
            f"tokenizer {name!r} is already registered; pass overwrite=True "
            "to replace it"
        )
    _TOKENIZERS[name] = fn


def get_tokenizer(name: str | Callable[[str], list[str]]) -> Callable[[str], list[str]]:
    """Resolve a tokenizer by name or pass a callable through — the
    ``torchtext.data.utils.get_tokenizer`` surface."""
    if callable(name):
        return name
    try:
        return _TOKENIZERS[name]
    except KeyError:
        raise ValueError(
            f"unknown tokenizer {name!r}; available: {sorted(_TOKENIZERS)}"
        ) from None


# ------------------------------------------------------------------ vocabulary


class Vocab:
    """Token ↔ id mapping with specials-first layout and an OOV default.

    Mirrors the ``build_vocab_from_iterator(..., specials=[...],
    special_first=True)`` + ``set_default_index(vocab['<unk>'])`` contract
    (``pytorch_lstm.py:55-67``). Lookup of an unknown token returns
    ``default_index`` — this vocab's own ``<unk>`` (fixing quirk Q11).
    """

    def __init__(
        self,
        tokens: Sequence[str],
        specials: Sequence[str] = SPECIALS,
        default_index: int | None = None,
    ):
        special_set = set(specials)
        self._itos: list[str] = list(specials) + [
            t for t in dict.fromkeys(tokens) if t not in special_set
        ]
        self._stoi: dict[str, int] = {t: i for i, t in enumerate(self._itos)}
        if default_index is None:
            default_index = self._stoi.get(UNK, 0)
        self.default_index = default_index

    @classmethod
    def build_from_iterator(
        cls,
        iterator: Iterable[Sequence[str]],
        *,
        min_freq: int = 1,
        specials: Sequence[str] = SPECIALS,
        max_tokens: int | None = None,
    ) -> "Vocab":
        """Frequency-then-lexical ordering, matching torchtext's
        ``build_vocab_from_iterator`` semantics used at
        ``pytorch_lstm.py:55-58`` and ``pytorch_machine_translator.py:53-67``."""
        counter: Counter[str] = Counter()
        for tokens in iterator:
            counter.update(tokens)
        for s in specials:
            counter.pop(s, None)
        ordered = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        if max_tokens is not None:
            ordered = ordered[: max(0, max_tokens - len(specials))]
        kept = [t for t, c in ordered if c >= min_freq]
        return cls(kept, specials=specials)

    def __len__(self) -> int:
        return len(self._itos)

    def __contains__(self, token: str) -> bool:
        return token in self._stoi

    def __getitem__(self, token: str) -> int:
        return self._stoi.get(token, self.default_index)

    def lookup_token(self, index: int) -> str:
        return self._itos[index]

    def lookup_indices(self, tokens: Sequence[str]) -> list[int]:
        return [self[t] for t in tokens]

    def lookup_tokens(self, indices: Sequence[int]) -> list[str]:
        return [self._itos[i] for i in indices]

    @property
    def itos(self) -> list[str]:
        return list(self._itos)


# ------------------------------------------------------------------ transforms
#
# Each transform maps list-of-token-id-lists → list-of-token-id-lists (ragged),
# except ToArray which pads to a rectangle. Composed with Sequential — the
# ``torchtext.transforms.Sequential`` chain shape (``pytorch_lstm.py:70-83``).


class VocabTransform:
    """tokens → ids (``T.VocabTransform``, ``pytorch_lstm.py:79``)."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab

    def __call__(self, batch: Sequence[Sequence[str]]) -> list[list[int]]:
        return [self.vocab.lookup_indices(toks) for toks in batch]


class AddToken:
    """Prepend/append a token id (``T.AddToken(1, begin=True)`` /
    ``T.AddToken(2, begin=False)``, ``pytorch_lstm.py:80-82``)."""

    def __init__(self, token_id: int, begin: bool):
        self.token_id, self.begin = token_id, begin

    def __call__(self, batch: Sequence[Sequence[int]]) -> list[list[int]]:
        if self.begin:
            return [[self.token_id, *ids] for ids in batch]
        return [[*ids, self.token_id] for ids in batch]


class Truncate:
    """Clip to ``max_seq_len`` (``T.Truncate(128)``, ``pytorch_lstm.py:76``)."""

    def __init__(self, max_seq_len: int):
        self.max_seq_len = max_seq_len

    def __call__(self, batch: Sequence[Sequence[int]]) -> list[list[int]]:
        return [list(ids[: self.max_seq_len]) for ids in batch]


class PadToLength:
    """Right-pad every sequence to exactly ``length`` (``T.PadTransform(200,
    pad_value)``, ``pytorch_machine_translator.py:82,97``) — the fixed-shape
    contract XLA wants (SURVEY.md §7: static shapes)."""

    def __init__(self, length: int, pad_value: int = PAD_ID):
        self.length, self.pad_value = length, pad_value

    def __call__(self, batch: Sequence[Sequence[int]]) -> list[list[int]]:
        return [
            list(ids[: self.length]) + [self.pad_value] * (self.length - len(ids))
            for ids in batch
        ]


class ToArray:
    """Ragged → rectangular ``np.int32`` padded with ``padding_value``
    (``T.ToTensor(padding_value=0)``, ``pytorch_lstm.py:83``)."""

    def __init__(self, padding_value: int = PAD_ID):
        self.padding_value = padding_value

    def __call__(self, batch: Sequence[Sequence[int]]) -> np.ndarray:
        if not batch:
            return np.zeros((0, 0), dtype=np.int32)
        width = max(len(ids) for ids in batch)
        out = np.full((len(batch), width), self.padding_value, dtype=np.int32)
        for i, ids in enumerate(batch):
            out[i, : len(ids)] = ids
        return out


class Sequential:
    """Left-to-right transform composition (``T.Sequential``)."""

    def __init__(self, *transforms):
        self.transforms = transforms

    def __call__(self, batch):
        for t in self.transforms:
            batch = t(batch)
        return batch


# ------------------------------------------------------------------ pipelines


class TextPipeline:
    """tokenizer + vocab + transform chain as one precomputation unit.

    ``__call__`` takes raw strings and returns a rectangular id array —
    everything the reference did per-batch *inside* the training loop, hoisted
    out so device steps see only ready tensors.
    """

    def __init__(
        self,
        vocab: Vocab,
        tokenizer: str | Callable[[str], list[str]] = "basic_english",
        *,
        max_seq_len: int = 128,
        fixed_len: int | None = None,
        add_sos: bool = True,
        add_eos: bool = True,
    ):
        if fixed_len is not None and fixed_len < max_seq_len + int(add_eos):
            raise ValueError(
                f"fixed_len={fixed_len} cannot hold max_seq_len={max_seq_len} "
                f"tokens{' + eos' if add_eos else ''}; eos would be clipped"
            )
        self.tokenizer = get_tokenizer(tokenizer)
        self.vocab = vocab
        # Reconstruction spec (inference.Translator.save/load): everything
        # needed to rebuild this pipeline around a saved vocab. A callable
        # tokenizer is recorded by name and must be re-registered on load.
        self.spec = {
            "tokenizer": (
                tokenizer
                if isinstance(tokenizer, str)
                else getattr(tokenizer, "__name__", "custom")
            ),
            "max_seq_len": max_seq_len,
            "fixed_len": fixed_len,
            "add_sos": add_sos,
            "add_eos": add_eos,
        }
        steps: list = [VocabTransform(vocab)]
        if add_sos:
            steps.append(AddToken(SOS_ID, begin=True))
        steps.append(Truncate(max_seq_len))
        if add_eos:
            steps.append(AddToken(EOS_ID, begin=False))
        if fixed_len is not None:
            steps.append(PadToLength(fixed_len, PAD_ID))
        steps.append(ToArray(PAD_ID))
        self.transform = Sequential(*steps)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        # The Python chain only: the native C++ encoder is not part of
        # this package yet (its output is pinned equal to this chain).
        return self.transform([self.tokenizer(t) for t in list(texts)])

    def ragged(self, texts: Sequence[str]) -> list[list[int]]:
        """Token-id lists *before* rectangularization — the input to length
        bucketing (``data.bucketing``), which pads per-bucket instead of
        per-corpus."""
        batch = [self.tokenizer(t) for t in texts]
        for t in self.transform.transforms:
            if isinstance(t, (PadToLength, ToArray)):
                continue
            batch = t(batch)
        return batch

    @classmethod
    def fit(
        cls,
        texts: Iterable[str],
        tokenizer: str | Callable[[str], list[str]] = "basic_english",
        *,
        min_freq: int = 1,
        max_tokens: int | None = None,
        **kwargs,
    ) -> "TextPipeline":
        """Build vocab over ``texts`` then return the ready pipeline — the
        one-call equivalent of the reference's vocab-build + chain-build
        blocks (``pytorch_lstm.py:55-83``)."""
        tok = get_tokenizer(tokenizer)
        vocab = Vocab.build_from_iterator(
            (tok(t) for t in texts), min_freq=min_freq, max_tokens=max_tokens
        )
        # Pass the ORIGINAL argument through (init re-resolves): a string
        # name must reach the reconstruction spec as the registry key, not
        # as the resolved function's __name__.
        return cls(vocab, tokenizer=tokenizer, **kwargs)


def classification_pipeline(
    texts: Iterable[str], *, max_seq_len: int = 128, **kwargs
) -> TextPipeline:
    """The AG_NEWS chain: sos + truncate(max_seq_len) + eos, ragged-padded
    (``pytorch_lstm.py:70-83``; default max_seq_len=128 per ``:76``)."""
    return TextPipeline.fit(
        texts, "basic_english", max_seq_len=max_seq_len, **kwargs
    )


def translation_pipelines(
    pairs: Sequence[tuple[str, str]],
    *,
    max_len: int = 200,
    trg_max_len: int | None = None,
    tokenizer: str | Callable[[str], list[str]] = "word_punct",
    **kwargs,
) -> tuple[TextPipeline, TextPipeline]:
    """The Multi30k dual-vocab chains: truncate(max_len-1) + eos + pad to
    exactly ``max_len`` (``pytorch_machine_translator.py:70-98``). Returns
    (src_pipeline, trg_pipeline) with *separate* vocabs, each defaulting to
    its own ``<unk>`` (fixing quirk Q11).

    ``trg_max_len`` (default: ``max_len``) pads the target stream to a
    different fixed length — sequence-parallel training sets it to
    ``max_len + 1`` so the teacher-forced decoder input (``trg[:, :-1]``,
    one shorter) has length ``max_len`` and divides the ring's seq axis.
    """
    src_texts = [s for s, _ in pairs]
    trg_texts = [t for _, t in pairs]

    def mk(texts, length):
        return TextPipeline.fit(
            texts,
            tokenizer,
            # Truncate runs after the sos prepend, so length-1 keeps sos + up
            # to length-2 content tokens, and the eos append lands within
            # length — the reference's Truncate(199)+Pad(200) capacity.
            max_seq_len=length - 1,
            fixed_len=length,
            **kwargs,
        )

    return (
        mk(src_texts, max_len),
        mk(trg_texts, max_len if trg_max_len is None else trg_max_len),
    )
