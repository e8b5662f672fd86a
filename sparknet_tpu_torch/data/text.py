"""Character-level text source for causal language-model training.

Counterpart of ``sparknet_tpu/data/text.py``, copied: it is host-only
numpy, so the same text and seed give the same batches, bit for bit.  A
char-level corpus needs no tokenizer and no download; the char LM's
examples train on the repo's own documentation (``load_corpus`` over
``README.md`` and ``docs/``).  The model side is ``models.charlm``;
sampling from it is ``models.generate_chars``.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


class CharVocab:
    """Byte-free char vocabulary: id 0 is reserved for <unk>.

    Built from the corpus itself; stable order (sorted by codepoint) so a
    vocab rebuilt from the same text maps identically — checkpoints
    remain usable across runs without serializing the vocab separately
    (though ``to_lines``/``from_lines`` round-trips it for deploy).
    """

    UNK = 0

    def __init__(self, chars: "list[str]"):
        self.chars = list(chars)
        self._ids = {c: i + 1 for i, c in enumerate(self.chars)}

    @classmethod
    def from_text(cls, text: str) -> "CharVocab":
        return cls(sorted(set(text)))

    @property
    def size(self) -> int:
        return len(self.chars) + 1  # + <unk>

    def encode(self, text: str) -> np.ndarray:
        return np.array([self._ids.get(c, self.UNK) for c in text],
                        dtype=np.int32)

    def decode(self, ids) -> str:
        out = []
        for i in np.asarray(ids).reshape(-1):
            i = int(i)
            out.append(self.chars[i - 1] if 1 <= i <= len(self.chars) else "�")
        return "".join(out)

    def to_lines(self) -> "list[str]":
        return [f"U+{ord(c):06X}" for c in self.chars]

    @classmethod
    def from_lines(cls, lines: "list[str]") -> "CharVocab":
        return cls([chr(int(ln.strip()[2:], 16)) for ln in lines if ln.strip()])


def load_corpus(paths: "list[str] | str") -> str:
    """Concatenate UTF-8 text files (a directory = all *.md/*.txt/*.py
    under it, sorted) into one training corpus string."""
    if isinstance(paths, str):
        paths = [paths]
    files: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in sorted(os.walk(p)):
                files += sorted(
                    os.path.join(root, n) for n in names
                    if n.endswith((".md", ".txt", ".py"))
                )
        else:
            files.append(p)
    parts = []
    for f in files:
        with open(f, "r", encoding="utf-8", errors="replace") as fh:
            parts.append(fh.read())
    return "\n\n".join(parts)


def char_lm_batches(
    text: str,
    vocab: CharVocab,
    batch: int,
    seq_len: int,
    seed: int | None = 0,
) -> Iterator[dict]:
    """Endless stream of next-char prediction minibatches.

    Each element: ``{"data": int32 [batch, seq_len],
    "label": int32 [batch, seq_len]}`` with ``label[t] = data[t+1]`` —
    the causal-LM shift done data-side so the model graph stays a plain
    forward net (the reference pattern: supervision arrives as a blob,
    not a graph transform).  Windows start at uniform-random offsets,
    the char-level analog of ``MinibatchSampler``'s contiguous windows
    (ref: src/main/scala/libs/MinibatchSampler.scala:18-27).
    """
    ids = vocab.encode(text)
    if ids.size < seq_len + 2:
        raise ValueError(
            f"corpus has {ids.size} chars; need > seq_len+1 = {seq_len + 1}")
    rs = np.random.RandomState(seed)
    hi = ids.size - seq_len - 1
    while True:
        starts = rs.randint(0, hi, size=batch)
        data = np.stack([ids[s:s + seq_len] for s in starts])
        label = np.stack([ids[s + 1:s + seq_len + 1] for s in starts])
        yield {"data": data, "label": label}
