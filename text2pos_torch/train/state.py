"""Checkpoint loading (counterpart of ``text2pos_tpu/train/state.py:179``).

Returns the host-side numpy trees; ``utils/convert_jax.py`` turns them into
``state_dict``s. Saving and resuming training state come with the training
slice.
"""

from __future__ import annotations

from typing import Any, Dict

from text2pos_torch.utils.msgpack_io import msgpack_restore


def load_checkpoint(path: str) -> Dict[str, Any]:
    """``{"params": tree, "batch_stats": tree, "extra": dict}`` of numpy
    leaves from a flax msgpack checkpoint."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    payload.setdefault("batch_stats", {})
    payload.setdefault("extra", {})
    return payload
