"""Reference-style checkpoints made from seeds, for the converters' gates.

No reference checkpoint is in the repository, so the converters
(``utils/convert_torch.py``, ``utils/convert_whole_model.py``) are held on
fabricated ones: torch modules with the reference's exact module tree and
attribute names (the Text2Pos reference code's models/cell_retrieval.py:23-67,
superglue_matcher.py:51-84, superglue.py:53-146,183-230, modules.py:11-53,
pointcloud/pointnet2.py:18-65), their weights drawn from ``torch.manual_seed``,
their BatchNorms' affines drawn and their statistics calibrated on a small
synthetic map (SuperGlue's drawn), so that their encodings spread as a
trained model's do. The ``reference_*`` functions are the reference's
forward on these modules, to hold a converted model against.
``save_whole_model`` pickles a model wholesale under the reference's
module paths and removes
those modules again, so that loading must go through the converter's stubs;
``save_pointnet_state_dict`` writes the PointNet++ as a state dict, as the
reference does.

    model, registry = make_fine_model(embed_dim=128, num_layers=6,
                                      words=vocab.known_words, seed=0)
    save_whole_model(model, registry, "fine.pth")
"""

from __future__ import annotations

import argparse
import functools
import sys
import types
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

NUM_CLASSES, NUM_COLORS = 23, 9
HEADS = 4               # the reference's AttentionalPropagation (superglue.py:120)
SA_LEVELS = ((0.5, 0.2), (0.5, 0.3), (0.5, 0.4))   # (FPS ratio, ball radius)
NEIGHBOR_CAP = 32       # PyG ``radius``'s max_num_neighbors
EDGE_K = 8              # DynamicEdgeConv's k (cell_retrieval.py:46-54)


def get_mlp(channels: Sequence[int]) -> nn.Sequential:
    """The reference's modules.py:11-29: nested Sequential((Linear, BN,
    ReLU)) a layer."""
    return nn.Sequential(*[
        nn.Sequential(nn.Linear(channels[i - 1], channels[i]),
                      nn.BatchNorm1d(channels[i]), nn.ReLU())
        for i in range(1, len(channels))])


def sg_mlp(channels: Sequence[int]) -> nn.Sequential:
    """The reference's superglue.py:53-64: flat Conv1d/BN/ReLU."""
    layers: List[nn.Module] = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], 1, bias=True))
        if i < len(channels) - 1:
            layers += [nn.BatchNorm1d(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


class SetAbstractionLayer(nn.Module):
    def __init__(self, mlp: nn.Module):
        super().__init__()
        self.point_conv = nn.Module()
        self.point_conv.local_nn = mlp


class GlobalAbstractionLayer(nn.Module):
    def __init__(self, mlp: nn.Module):
        super().__init__()
        self.mlp = mlp


class CellRetrievalNetwork(nn.Module):
    pass


class DynamicEdgeConv(nn.Module):
    def __init__(self, nn_module: nn.Module):
        super().__init__()
        self.nn = nn_module


class SuperGlueMatch(nn.Module):
    pass


class SuperGlue(nn.Module):
    pass


class AttentionalPropagation(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.attn = nn.Module()
        self.attn.merge = nn.Conv1d(dim, dim, 1)
        self.attn.proj = nn.ModuleList([nn.Conv1d(dim, dim, 1)
                                        for _ in range(3)])
        self.mlp = sg_mlp([2 * dim, 2 * dim, dim])


def make_pointnet() -> nn.Module:
    """The reference's PointNet2 (pointnet2.py:52-65)."""
    pn = nn.Module()
    pn.sa1 = SetAbstractionLayer(get_mlp([3 + 3, 32, 64]))
    pn.sa2 = SetAbstractionLayer(get_mlp([64 + 3, 128, 128]))
    pn.sa3 = SetAbstractionLayer(get_mlp([128 + 3, 256, 256]))
    pn.ga = GlobalAbstractionLayer(get_mlp([256 + 3, 512, 1024]))
    pn.lin1 = nn.Linear(1024, 512)
    pn.lin2 = nn.Linear(512, 256)
    pn.class_classifier = nn.Linear(256, NUM_CLASSES)
    pn.color_classifier = nn.Linear(256, NUM_COLORS)
    pn.dim2 = 256
    return pn


def make_object_encoder(dim: int) -> nn.Module:
    oe = nn.Module()
    oe.class_embedding = nn.Embedding(NUM_CLASSES, dim, padding_idx=0)
    oe.color_embedding = nn.Embedding(NUM_COLORS, dim, padding_idx=0)
    oe.pos_encoder = get_mlp([3, 64, dim])
    oe.color_encoder = get_mlp([3, 64, dim])
    oe.pointnet = make_pointnet()
    oe.mlp_pointnet = get_mlp([256, dim])
    oe.mlp_merge = get_mlp([3 * dim, dim])
    return oe


def make_language_encoder(words: Sequence[str], dim: int) -> nn.Module:
    le = nn.Module()
    le.known_words = {w: i + 1 for i, w in enumerate(words)}
    le.word_embedding = nn.Embedding(len(le.known_words) + 1, dim,
                                     padding_idx=0)
    le.lstm = nn.LSTM(dim, dim, num_layers=1, bidirectional=True)
    return le


def _args(dim: int, num_layers: int, sinkhorn_iters: int
          ) -> argparse.Namespace:
    return argparse.Namespace(
        embed_dim=dim, use_features=["class", "color", "position"],
        variation=0, class_embed=False, color_embed=False,
        num_layers=num_layers, sinkhorn_iters=sinkhorn_iters,
        pointnet_features=2)


def randomize_batch_norms(model: nn.Module, seed: int) -> nn.Module:
    """Non-trivial BN running statistics and affines (a trained model's are
    not (0, 1)), drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm1d):
                n = m.num_features
                m.running_mean.copy_(0.3 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(0.7 + 0.6 * torch.rand(n, generator=gen))
                m.bias.copy_(0.2 * torch.randn(n, generator=gen))
    return model


def calibrate_batch_norms(module: nn.Module, run) -> nn.Module:
    """Every BatchNorm1d's running statistics from one batch, as a trained
    model's match its activations: ``run()`` forwards ``module`` in train
    mode with a cumulative average (momentum None); the affines stay. Drawn
    statistics instead (``randomize_batch_norms``) dwarf the variation of
    activations whose rows are unit vectors, and after a few layers every
    cell encodes to one vector."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm1d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    module.train()
    with torch.no_grad():
        run()
    for m in bns:
        m.momentum = 0.1
    return module.eval()


@functools.lru_cache(maxsize=1)
def calibration_objects(num_points: int = 256) -> Dict[str, torch.Tensor]:
    """The objects of a small synthetic map (the port's generator, seed 3,
    9 cells), prepared as the coarse tower's DB encode prepares them:
    ``coarse_cell_points``' (xyz, rgb, centers, colors, cell)."""
    from text2pos_torch.data.dense import build_cell_bank
    from text2pos_torch.data.synthetic import make_synthetic_dataset
    from text2pos_torch.evaluation.pipeline import (bank_tensors,
                                                    coarse_cell_points)

    cells, _ = make_synthetic_dataset(
        seed=3, scene_name="9903", extent=90.0, cell_size=30.0,
        poses_per_cell=1, objects_per_cell_area=12)
    bt = bank_tensors(build_cell_bank(cells, 28, num_points, seed=0), "cpu")
    idx = torch.arange(bt["mask"].shape[0])
    xyz, rgb, centers, colors, cell, _ = coarse_cell_points(
        bt, idx, torch.Generator().manual_seed(0), num_points=num_points)
    return {"xyz": xyz, "rgb": rgb, "centers": centers, "colors": colors,
            "cell": cell, "num_cells": len(idx)}


Registry = Dict[str, List[type]]


def make_coarse_model(embed_dim: int, words: Sequence[str], seed: int = 0,
                      pointnet: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Tuple[nn.Module, Registry]:
    """A reference ``CellRetrievalNetwork`` and its classes' module paths;
    ``pointnet`` a PointNet++ state dict to hold instead of its own. Its
    BN statistics are calibrated on ``calibration_objects``."""
    torch.manual_seed(seed)
    m = CellRetrievalNetwork()
    m.args = _args(embed_dim, 0, 0)
    m.embed_dim = embed_dim
    m.variation = 0
    m.object_encoder = make_object_encoder(embed_dim)
    m.language_encoder = make_language_encoder(words, embed_dim)
    m.graph1 = DynamicEdgeConv(get_mlp([2 * embed_dim, embed_dim, embed_dim]))
    m.lin = get_mlp([embed_dim, embed_dim, embed_dim])
    randomize_batch_norms(m, seed)
    if pointnet is not None:
        m.object_encoder.pointnet.load_state_dict(pointnet)
    cal = calibration_objects()
    calibrate_batch_norms(m, lambda: reference_encode_cells(
        m, cal["xyz"], cal["rgb"], cal["centers"], cal["colors"],
        cal["cell"], cal["num_cells"]))
    return m, {
        "models.cell_retrieval": [CellRetrievalNetwork],
        "models.pointcloud.pointnet2": [SetAbstractionLayer,
                                        GlobalAbstractionLayer],
        "torch_geometric.nn": [DynamicEdgeConv]}


def make_fine_model(embed_dim: int, num_layers: int, words: Sequence[str],
                    seed: int = 0, sinkhorn_iters: int = 50,
                    pointnet: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[nn.Module, Registry]:
    """A reference ``SuperGlueMatch`` (``num_layers`` self/cross pairs) and
    its classes' module paths; ``pointnet`` as ``make_coarse_model``'s. The
    object encoder's BN statistics are calibrated on
    ``calibration_objects``, SuperGlue's stay drawn."""
    torch.manual_seed(seed)
    m = SuperGlueMatch()
    m.args = _args(embed_dim, num_layers, sinkhorn_iters)
    m.embed_dim = embed_dim
    m.num_layers = num_layers
    m.sinkhorn_iters = sinkhorn_iters
    m.object_encoder = make_object_encoder(embed_dim)
    m.language_encoder = make_language_encoder(words, embed_dim)
    # get_mlp_offset([E, E//2, 2]) = Sequential(Linear, ReLU, Linear)
    m.mlp_offsets = nn.Sequential(nn.Linear(embed_dim, embed_dim // 2),
                                  nn.ReLU(), nn.Linear(embed_dim // 2, 2))
    sg = SuperGlue()
    sg.bin_score = nn.Parameter(torch.tensor(1.234))
    sg.final_proj = nn.Conv1d(embed_dim, embed_dim, 1, bias=True)
    sg.gnn = nn.Module()
    sg.gnn.layers = nn.ModuleList([AttentionalPropagation(embed_dim)
                                   for _ in range(2 * num_layers)])
    m.superglue = sg
    randomize_batch_norms(m, seed)
    if pointnet is not None:
        m.object_encoder.pointnet.load_state_dict(pointnet)
    cal = calibration_objects()
    calibrate_batch_norms(m.object_encoder, lambda: reference_object_encoder(
        m.object_encoder, cal["xyz"], cal["rgb"], cal["centers"],
        cal["colors"]))
    return m.eval(), {
        "models.superglue_matcher": [SuperGlueMatch],
        "models.pointcloud.pointnet2": [SetAbstractionLayer,
                                        GlobalAbstractionLayer],
        "models.superglue": [SuperGlue, AttentionalPropagation]}


def make_pointnet_state_dict(seed: int = 0) -> Dict[str, torch.Tensor]:
    """A reference PointNet++'s state dict (``pointnet_*.pth``), its BN
    statistics calibrated on ``calibration_objects``."""
    torch.manual_seed(seed)
    pn = randomize_batch_norms(make_pointnet(), seed)
    cal = calibration_objects()
    calibrate_batch_norms(pn, lambda: reference_pointnet(pn, cal["xyz"],
                                                         cal["rgb"]))
    return pn.state_dict()


def save_whole_model(model: nn.Module, registry: Registry, path: str) -> None:
    """``torch.save(model)`` with the classes under the reference's module
    paths; the modules made for it, and the classes' own module names, are
    restored afterwards, so loading exercises the converter's stubs."""
    made, old = [], {}
    try:
        for mod_name, classes in registry.items():
            parts = mod_name.split(".")
            for i in range(1, len(parts) + 1):
                name = ".".join(parts[:i])
                if name not in sys.modules:
                    sys.modules[name] = types.ModuleType(name)
                    made.append(name)
            for cls in classes:
                old[cls] = (cls.__module__, cls.__qualname__)
                cls.__module__, cls.__qualname__ = mod_name, cls.__name__
                setattr(sys.modules[mod_name], cls.__name__, cls)
        torch.save(model, path)
    finally:
        for cls, (mod, qual) in old.items():
            cls.__module__, cls.__qualname__ = mod, qual
        for name in made:
            del sys.modules[name]


def save_pointnet_state_dict(path: str, seed: int = 0) -> None:
    torch.save(make_pointnet_state_dict(seed), path)


# ----------------------------------------------------------------------
# The reference's forward on its own modules, to hold a converted model
# against. The sampling and grouping decisions (FPS, the ball's first 32
# points by index, a cell's 8 nearest objects) are made in f32 as the
# port's plain versions make them; the arithmetic runs in the modules'
# dtype (float64 for a gate).
# ----------------------------------------------------------------------
def reference_encode_text(model: nn.Module, tokens: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """``encode_text`` (cell_retrieval.py, modules.py:40-75): the word
    embedding (row 0, the pad, zero), the bi-LSTM over each sequence's own
    length, the mean of its two final hidden states, ``F.normalize``.
    tokens [B, T], lengths [B] → [B, E]."""
    le = model.language_encoder
    packed = nn.utils.rnn.pack_padded_sequence(
        le.word_embedding(tokens), lengths.cpu(), batch_first=True,
        enforce_sorted=False)
    _, (h, _) = le.lstm(packed)
    return F.normalize(h.mean(0), dim=-1)


def reference_pointnet(pn: nn.Module, xyz: torch.Tensor, rgb: torch.Tensor
                       ) -> torch.Tensor:
    """``features2`` [F, 256] (pointnet2.py:18-65): each level's
    ``point_conv.local_nn`` on [x_j, pos_j − pos_i] of the ball's points,
    max-pooled; ``ga.mlp`` on [x, pos], max-pooled; ``lin1`` and ``lin2``,
    each with a ReLU. xyz, rgb [F, P, 3]."""
    from text2pos_torch.ops.fps import farthest_point_sampling_levels_plain
    from text2pos_torch.ops.pointconv import ball_neighbors

    dt = pn.lin1.weight.dtype
    p32 = xyz.float()
    levels = farthest_point_sampling_levels_plain(
        p32, [r for r, _ in SA_LEVELS])
    x, pos = rgb.to(dt), xyz.to(dt)
    for sa, (_, radius), (_, c32) in zip((pn.sa1, pn.sa2, pn.sa3),
                                         SA_LEVELS, levels):
        idx, valid = ball_neighbors(p32, c32, radius, NEIGHBOR_CAP)
        b = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
        cent = c32.to(dt)
        rows = torch.cat([x[b, idx], pos[b, idx] - cent[:, :, None, :]],
                         -1)[valid]
        msg = sa.point_conv.local_nn(rows)
        out = msg.new_full((*idx.shape, msg.shape[-1]), float("-inf"))
        out[valid] = msg
        x, pos, p32 = out.amax(2), cent, c32
    n, s = x.shape[:2]
    h = pn.ga.mlp(torch.cat([x, pos], -1).flatten(0, 1))
    h = h.view(n, s, -1).amax(1)
    return torch.relu(pn.lin2(torch.relu(pn.lin1(h))))


def reference_object_encoder(oe: nn.Module, xyz: torch.Tensor,
                             rgb: torch.Tensor, centers: torch.Tensor,
                             colors: torch.Tensor) -> torch.Tensor:
    """The object encoder with the class, colour and position features
    (the fabricated models' ``use_features``): PointNet++ through
    ``mlp_pointnet``, ``color_encoder``, ``pos_encoder``, each
    ``F.normalize``d, concatenated through ``mlp_merge``. [F, E]."""
    dt = oe.mlp_merge[0][0].weight.dtype
    feats = [oe.mlp_pointnet(reference_pointnet(oe.pointnet, xyz, rgb)),
             oe.color_encoder(colors.to(dt)), oe.pos_encoder(centers.to(dt))]
    return oe.mlp_merge(torch.cat([F.normalize(f, dim=-1) for f in feats],
                                  -1))


def reference_encode_cells(model: nn.Module, xyz: torch.Tensor,
                           rgb: torch.Tensor, centers: torch.Tensor,
                           colors: torch.Tensor, cell: torch.Tensor,
                           num_cells: int) -> torch.Tensor:
    """``encode_objects`` (cell_retrieval.py:69-95) on flat objects, those
    of cell ``cell[f]`` in order: the normalized object encodings,
    ``graph1`` (``nn`` on [x_i, x_j − x_i] over each object's 8 nearest
    objects of its cell, itself included, max-aggregated), the cell's max,
    ``lin``, ``F.normalize``. → [num_cells, E]."""
    x = F.normalize(reference_object_encoder(model.object_encoder, xyz, rgb,
                                             centers, colors), dim=-1)
    dst, src = [], []
    for c in range(num_cells):
        members = (cell == c).nonzero()[:, 0]
        xc = x[members].float()
        d2 = (xc[:, None, :] - xc[None, :, :]).square().sum(-1)
        k = min(EDGE_K, len(members))
        near = torch.sort(d2, dim=-1, stable=True).indices[:, :k]
        dst.append(members[:, None].expand(-1, k).reshape(-1))
        src.append(members[near].reshape(-1))
    dst, src = torch.cat(dst), torch.cat(src)
    msg = model.graph1.nn(torch.cat([x[dst], x[src] - x[dst]], -1))
    h = msg.new_full((x.shape[0], msg.shape[-1]), float("-inf"))
    h = h.scatter_reduce(0, dst[:, None].expand_as(msg), msg, "amax")
    pooled = h.new_full((num_cells, h.shape[-1]), float("-inf"))
    pooled = pooled.scatter_reduce(0, cell[:, None].expand_as(h), h, "amax")
    return F.normalize(model.lin(pooled), dim=-1)
