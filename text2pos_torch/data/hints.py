"""Hint text and tokenization: a copy of ``text2pos_tpu/data/hints.py:19-66``.

One sentence per pose description; lowercase, strip ``.``/``,``, split on
whitespace; index 0 is ``<unk>`` and doubles as the padding index.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from text2pos_torch.data.structs import Pose


def create_hint_description(pose: Pose) -> List[str]:
    """One sentence per description: "The pose is {dir} of a {color}
    {label}."."""
    return [
        f"The pose is {d.direction} of a {d.object_color_text} "
        f"{d.object_label}."
        for d in pose.descriptions
    ]


def tokenize(text: str) -> List[str]:
    return text.replace(".", "").replace(",", "").lower().split()


class Vocabulary:
    """Word → index map with ``<unk>`` = 0."""

    def __init__(self, known_words: Sequence[str]):
        self.known_words = [str(w) for w in known_words]
        self.word_to_index: Dict[str, int] = {
            w: i + 1 for i, w in enumerate(self.known_words)}
        self.word_to_index["<unk>"] = 0
        self.size = len(self.word_to_index)

    def encode(self, text: str, max_len: int) -> Tuple[np.ndarray, int]:
        """Token ids [max_len] (0-padded/truncated) and the true length."""
        ids = [self.word_to_index.get(w, 0) for w in tokenize(text)]
        length = min(len(ids), max_len)
        out = np.zeros(max_len, dtype=np.int32)
        out[:length] = ids[:length]
        return out, length

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        tokens = np.zeros((len(texts), max_len), dtype=np.int32)
        lengths = np.zeros(len(texts), dtype=np.int32)
        for i, t in enumerate(texts):
            tokens[i], lengths[i] = self.encode(t, max_len)
        return tokens, lengths
