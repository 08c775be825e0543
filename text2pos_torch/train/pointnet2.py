"""PointNet++ pretraining's one piece the stage trainers use (counterpart of
``text2pos_tpu/train/pointnet2.py:171``): ``load_pretrained_into`` seeds a
model's object encoder with a pretrained PointNet++ checkpoint
(``--pointnet_path``). The pretraining trainer itself is not ported
(ROADMAP Queue 1 item 4)."""

from __future__ import annotations

from torch import nn

from text2pos_torch.train.state import load_checkpoint, load_variables


def load_pretrained_into(model: nn.Module, pointnet_path: str,
                         scope: str = "object_encoder") -> nn.Module:
    """Load the params and BN statistics of a PointNet++ checkpoint (its
    class and colour heads included) into ``model.<scope>.pointnet``."""
    payload = load_checkpoint(pointnet_path)
    load_variables(getattr(model, scope).pointnet, payload)
    return model
