"""PointNet++ object encoder in eval mode (counterpart of
``text2pos_tpu/models/pointnet2.py`` and ``models/pointnet2_fast.py``).

Three set-abstraction levels (FPS ratio 0.5, ball radii 0.2/0.3/0.4, at
most 32 neighbours, first by index), a global abstraction MLP with a max
over points, then ``lin1`` and ``lin2``. FPS picks every level's
centroids at once, before the first level (``ops.fps``
``farthest_point_sampling_levels``: one CUDA launch a forward on the card,
level l + 1 on level l's centroids), and each level takes its own; the
separable first layer is two matmuls (``a = [x, pos]·W1 + b1`` per point,
``c = cent·W1[-3:]`` per centroid), and the rest of the level (ball query,
``a_n − c_s``, BN0, ReLU, the second layer, BN1, ReLU, max over
neighbours) is ``ops.pointconv.pointconv_max``: the CUDA kernel on the
card. The class/colour heads are built only when asked for (``heads``):
encoding never reads them, but a trainer keeps them so that its
checkpoints hold every leaf of the JAX model; ``predict`` gives their
logits too, as the pretraining trainer reads them.

With ``eval_batch_stats`` (``blocks.set_eval_batch_stats``: the
uncalibrated JAX fine model, and step 1 of ``calibrated_for_serving``) every
BN normalizes by its batch's statistics,
a set-abstraction level's over the ``[B, S, K, C]`` neighbour rows that the
ball query selects. The PointConv kernel folds eval-mode BN into its
epilogue and cannot take statistics of its own input, and JAX runs no
Pallas kernel in that mode either, so a level then runs as PyTorch ops on
the card (``SetAbstraction.forward_batch_stats``); FPS still runs its
kernel. The same holds in train mode (``blocks.train_mode``: batch
statistics, running averages updated, differentiable): the PointConv kernel
does not apply, as JAX trains through its unfused PointNet++ too, and FPS,
which chooses centroids and needs no gradient, keeps its kernel.

Module names follow the flax tree (``sa1.conv_mlp.dense_0`` ↔
``sa1/conv_mlp/dense_0``). Profiler ranges ``pointnet.fps`` (the one
launch a forward),
``pointnet.first_layer``, ``pointnet.pointconv`` and ``pointnet.head``
(global abstraction MLP, ``lin1``, ``lin2``) let a trace attribute time.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from text2pos_torch.models.blocks import (MLP, MaskedBatchNorm, bn_affine,
                                         checkpointed, dense, weights_key)
from text2pos_torch.ops.fps import (farthest_point_sampling,
                                   farthest_point_sampling_levels)
from text2pos_torch.ops.pointconv import (ball_neighbors, pointconv_max,
                                          w2_fragments)
from text2pos_torch.ops.pooling import gather_neighbors, masked_max

K_CAP = 32


class ConvMLP(nn.Module):
    """The PointConv MLP's parameters: dense_0 (the separable first
    layer), bn_0, dense_1, bn_1."""

    def __init__(self, in_features: int, c1: int, c2: int):
        super().__init__()
        self.dense_0 = nn.Linear(in_features, c1)
        self.bn_0 = MaskedBatchNorm(c1)
        self.dense_1 = nn.Linear(c1, c2)
        self.bn_1 = MaskedBatchNorm(c2)


class SetAbstraction(nn.Module):
    def __init__(self, in_features: int, ratio: float, radius: float,
                 channels: Tuple[int, int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.ratio, self.radius, self.dtype = ratio, radius, dtype
        self.eval_batch_stats = False      # blocks.set_eval_batch_stats
        self.train_stats = False           # blocks.train_mode
        self.conv_mlp = ConvMLP(in_features + 3, *channels)
        self._w2f = None

    def w2_fragments(self) -> torch.Tensor:
        """W2 in bf16 in the tensor-core kernel's fragment order
        (``ops.pointconv.w2_fragments``), packed once and kept until the
        weights change (loaded, moved or updated in place)."""
        w = self.conv_mlp.dense_1.weight
        key = weights_key(((self.conv_mlp.dense_1._parameters, "weight"),))
        if self._w2f is None or self._w2f[0] != key:
            with torch.no_grad():
                self._w2f = key, w2_fragments(w.t().to(torch.bfloat16))
        return self._w2f[1]

    def pointconv_args(self, x: torch.Tensor, pos: torch.Tensor,
                       cent: Optional[torch.Tensor] = None) -> tuple:
        """FPS and the separable first layer: the arguments of
        ``pointconv_max`` (all but the radius and the cap) for x [B, N, C],
        pos [B, N, 3] f32; their fourth, ``cent`` [B, S, 3], is the level's
        output positions, S = N·ratio: the given ones (``PointNet2``'s one
        FPS launch), else FPS of this level alone."""
        if cent is None:
            S = max(1, int(pos.shape[1] * self.ratio))
            with record_function("pointnet.fps"):
                _, cent = farthest_point_sampling(pos, S)
        m = self.conv_mlp
        xpos = torch.cat([x.float(), pos], dim=-1)
        dt = self.dtype or xpos.dtype
        with record_function("pointnet.first_layer"):
            a = dense(m.dense_0, xpos, dt).to(dt)
            c = torch.matmul(cent.to(dt), m.dense_0.weight[:, -3:].t().to(dt))
        return (a, pos, c, cent, bn_affine(m.bn_0),
                m.dense_1.weight.t().to(dt), m.dense_1.bias.to(dt).float(),
                bn_affine(m.bn_1))

    def forward(self, x: torch.Tensor, pos: torch.Tensor,
                cent: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, N, C], pos [B, N, 3] f32 → (x' [B, S, C2], cent [B, S, 3])
        with S = N·ratio; ``cent``, if given, is the level's FPS output."""
        if self.eval_batch_stats or self.train_stats:
            return self.forward_batch_stats(x, pos, cent)
        args = self.pointconv_args(x, pos, cent)
        a = args[0]
        w2f = (self.w2_fragments()
               if a.is_cuda and a.dtype == torch.bfloat16 else None)
        with record_function("pointnet.pointconv"):
            out = pointconv_max(*args, self.radius, K_CAP, w2f=w2f)
        return out, args[3]

    def forward_batch_stats(self, x: torch.Tensor, pos: torch.Tensor,
                            cent: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``forward`` with both BNs on the statistics of the selected
        neighbour rows (JAX's ``nb_valid`` mask), as PyTorch ops; rounded
        where ``pointconv_max_plain`` rounds."""
        a, pos, c, cent = self.pointconv_args(x, pos, cent)[:4]
        m = self.conv_mlp
        dt = a.dtype
        with record_function("pointnet.pointconv"):
            idx, valid = ball_neighbors(pos, cent, self.radius, K_CAP)
            d = gather_neighbors(a, idx).float() - c.float()[:, :, None, :]
            h = torch.relu(m.bn_0(d, mask=valid)).to(dt)
            z = dense(m.dense_1, h, dt)
            y = torch.relu(m.bn_1(z, mask=valid))
            out = masked_max(y, valid[..., None], dim=2).to(dt)
        return out, cent


class GlobalAbstraction(nn.Module):
    """concat(x, pos) → MLP → max over points."""

    def __init__(self, in_features: int, channels: Tuple[int, int],
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = MLP(in_features + 3, channels, dtype)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        h = self.mlp(torch.cat([x.float(), pos], dim=-1))
        return h.amax(dim=1)


class PointNet2(nn.Module):
    """[B, P, 3] points and colours → ``features2`` [B, 256] f32."""

    def __init__(self, dtype: Optional[torch.dtype] = None, dim0: int = 1024,
                 dim1: int = 512, dim2: int = 256,
                 heads: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.dtype = dtype
        self.sa1 = SetAbstraction(3, 0.5, 0.2, (32, 64), dtype)
        self.sa2 = SetAbstraction(64, 0.5, 0.3, (128, 128), dtype)
        self.sa3 = SetAbstraction(128, 0.5, 0.4, (256, 256), dtype)
        self.ga = GlobalAbstraction(256, (512, dim0), dtype)
        self.lin1 = nn.Linear(dim0, dim1)
        self.lin2 = nn.Linear(dim1, dim2)
        self.remat = False         # the models' --remat
        if heads is not None:      # (classes, colours); read by predict
            self.class_classifier = nn.Linear(dim2, heads[0])
            self.color_classifier = nn.Linear(dim2, heads[1])

    def predict(self, xyz: torch.Tensor, rgb: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """``features2`` [B, 256] and the heads' ``class_pred`` and
        ``color_pred`` logits, all f32: the heads run in f32 on the f32
        features (stored in the compute dtype first), as flax promotes
        them (no compute dtype)."""
        f2 = self(xyz, rgb).to(self.dtype or torch.float32).float()
        return {"features2": f2,
                "class_pred": dense(self.class_classifier, f2),
                "color_pred": dense(self.color_classifier, f2)}

    def forward(self, xyz: torch.Tensor, rgb: torch.Tensor,
                level: int = 2) -> torch.Tensor:
        """``features{level}``: the global abstraction's ``features0``
        [B, 1024], ``features1`` [B, 512] after ``lin1`` or ``features2``
        [B, 256] after ``lin2`` (JAX's three outputs; the object encoder's
        ``pointnet_features``). With ``remat`` and a gradient wanted, each
        abstraction level is recomputed in the backward pass
        (``blocks.checkpointed``), one at a time, so that no more than one
        level's activations are held; the levels' centroids come from the
        one FPS launch before them, so a recomputed level reruns no FPS."""
        run = (checkpointed if self.remat and torch.is_grad_enabled()
               else lambda m, *a: m(*a))
        x, pos = rgb, xyz.float()
        sas = (self.sa1, self.sa2, self.sa3)
        with record_function("pointnet.fps"):
            levels = farthest_point_sampling_levels(
                pos, [sa.ratio for sa in sas])
        for sa, (_, cent) in zip(sas, levels):
            x, pos = run(sa, x, pos, cent)
        with record_function("pointnet.head"):
            f = run(self.ga, x, pos)
            for lin in (self.lin1, self.lin2)[:level]:
                f = torch.relu(dense(lin, f, self.dtype))
            return f
