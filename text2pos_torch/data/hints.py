"""Hint text, tokenization and flip rewrites: a copy of
``text2pos_tpu/data/hints.py``.

One sentence per pose description; lowercase, strip ``.``/``,``, split on
whitespace; index 0 is ``<unk>`` and doubles as the padding index. A
horizontal flip swaps east and west, a vertical one north and south.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence, Tuple

import numpy as np

from text2pos_torch.data.structs import Cell, Pose


def create_hint_description(pose: Pose, cell: Cell = None) -> List[str]:
    """One sentence per description: "The pose is {dir} of a {color}
    {label}."."""
    return [
        f"The pose is {d.direction} of a {d.object_color_text} "
        f"{d.object_label}."
        for d in pose.descriptions
    ]


def tokenize(text: str) -> List[str]:
    return text.replace(".", "").replace(",", "").lower().split()


def build_vocabulary(hint_lists: Sequence[Sequence[str]]) -> List[str]:
    """Unique sorted word list over all hints."""
    words: List[str] = []
    for hints in hint_lists:
        for hint in hints:
            words.extend(tokenize(hint))
    return list(np.unique(words))


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


def flip_text(text: str, direction: int) -> str:
    """Rewrite direction words for a horizontal (+1) or vertical (-1) flip."""
    assert direction in (-1, 1)
    if direction == 1:
        out = (text.replace("east", "east-flipped").replace("west", "east")
               .replace("east-flipped", "west"))
    else:
        out = (text.replace("north", "north-flipped")
               .replace("south", "north").replace("north-flipped", "south"))
    assert "flipped" not in out
    return out


def flip_pose_in_cell(pose: Pose, cell: Cell, text: str, direction: int,
                      hints: List[str] = None, offsets: np.ndarray = None):
    """Flip a (pose, cell, text[, hints, offsets]) tuple along x (+1) or y
    (-1), on copies."""
    assert direction in (-1, 1)
    assert (hints is None) == (offsets is None)
    pose = copy.deepcopy(pose)
    cell = copy.deepcopy(cell)
    if offsets is not None:
        offsets = offsets.copy()

    axis = 0 if direction == 1 else 1
    pose.pose[axis] = 1.0 - pose.pose[axis]
    for obj in cell.objects:
        obj.xyz[:, axis] = 1.0 - obj.xyz[:, axis]
    for descr in pose.descriptions:
        descr.closest_point[axis] = 1.0 - descr.closest_point[axis]

    text = flip_text(text, direction)
    if hints is not None:
        hints = [flip_text(h, direction) for h in hints]
        offsets[:, axis] *= -1
        return pose, cell, text, hints, offsets
    return pose, cell, text
