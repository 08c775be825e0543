"""Weights carried across from the JAX package's checkpoints.

The port's modules use the flax tree's names (``superglue.gnn.layer_0.attn.
proj_q`` ↔ ``superglue/gnn/layer_0/attn/proj_q``), so each ``state_dict``
entry has one JAX leaf:

- ``nn.Linear``: ``weight`` ↔ ``kernel`` transposed (flax is [in, out]),
  ``bias`` ↔ ``bias``;
- ``nn.Embedding``: ``weight`` ↔ ``embedding``;
- ``MaskedBatchNorm``: ``weight`` ↔ ``scale``, ``bias`` ↔ ``bias``, and the
  ``batch_stats`` leaves ``mean``/``var`` ↔ ``running_mean``/``running_var``
  (``[2, 2E]`` for calibrated per-set statistics);
- any other parameter keeps its name (``lstm_fwd_w_ih`` [E, 4E], gates
  i|f|g|o; ``bin_score``).

The same map carries any module of the port across, by its names: the
standalone ``PointNet2`` with both heads (``class_classifier``,
``color_classifier``; the pretraining's checkpoints) and the
``OffsetRegressor`` (``language_encoder``, ``mlp_offsets``) included.

Trees are nested dicts of numpy arrays, as ``train/state.py`` returns them.
``params_to_jax`` and ``jax_to_params`` carry any per-parameter tensors
(Adam's moments) across by the same map.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from text2pos_torch.models.blocks import MaskedBatchNorm

# (state_dict key, collection, path in the JAX tree, transposed)
_Entry = Tuple[str, str, Tuple[str, ...], bool]


def _entries(module: nn.Module) -> Iterator[_Entry]:
    for mname, mod in module.named_modules():
        path = tuple(mname.split(".")) if mname else ()
        pre = f"{mname}." if mname else ""
        if isinstance(mod, nn.Linear):
            yield pre + "weight", "params", path + ("kernel",), True
            yield pre + "bias", "params", path + ("bias",), False
        elif isinstance(mod, nn.Embedding):
            yield pre + "weight", "params", path + ("embedding",), False
        elif isinstance(mod, MaskedBatchNorm):
            yield pre + "weight", "params", path + ("scale",), False
            yield pre + "bias", "params", path + ("bias",), False
            yield pre + "running_mean", "batch_stats", path + ("mean",), False
            yield pre + "running_var", "batch_stats", path + ("var",), False
        else:
            for pname, _ in mod.named_parameters(recurse=False):
                yield pre + pname, "params", path + (pname,), False


def _get(tree: Dict, path: Tuple[str, ...]) -> Any:
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _set(tree: Dict, path: Tuple[str, ...], value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix


def jax_to_state_dict(module: nn.Module, params: Dict,
                      batch_stats: Dict = None) -> Dict[str, torch.Tensor]:
    """``module``'s ``state_dict`` from JAX-layout trees (f32). Raises if a
    leaf the module needs is missing or has the wrong shape."""
    trees = {"params": params, "batch_stats": batch_stats or {}}
    want = module.state_dict()
    out = {}
    for key, coll, path, transpose in _entries(module):
        leaf = _get(trees[coll], path)
        if leaf is None:
            raise KeyError(f"{coll}/{'/'.join(path)} missing for {key}")
        arr = np.asarray(leaf, np.float32)
        if transpose:
            arr = arr.T
        if tuple(arr.shape) != tuple(want[key].shape):
            raise ValueError(f"{key}: JAX leaf {coll}/{'/'.join(path)} has "
                             f"shape {arr.shape}, module wants "
                             f"{tuple(want[key].shape)}")
        out[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out


def load_jax_params(module: nn.Module, params: Dict,
                    batch_stats: Dict = None) -> List[str]:
    """Load the JAX trees into ``module``; returns the JAX leaves it did not
    use (e.g. PointNet's class and colour heads, which encoding never
    reads)."""
    sd = jax_to_state_dict(module, params, batch_stats)
    module.load_state_dict(sd, strict=True)
    used = {(coll, path) for _, coll, path, _ in _entries(module)}
    trees = {"params": params, "batch_stats": batch_stats or {}}
    return ["/".join((coll,) + p) for coll, tree in trees.items()
            for p in _leaves(tree) if (coll, p) not in used]


def module_to_jax(module: nn.Module) -> Tuple[Dict, Dict]:
    """(params, batch_stats) JAX-layout numpy trees of ``module``."""
    sd = module.state_dict()
    trees: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, coll, path, transpose in _entries(module):
        arr = sd[key].detach().float().cpu().numpy()
        _set(trees[coll], path, np.array(arr.T if transpose else arr,
                                         order="C"))
    return trees["params"], trees["batch_stats"]


def param_paths(module: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], bool]]:
    """{parameter name: (path in the JAX ``params`` tree, transposed)}."""
    return {key: (path, transpose)
            for key, coll, path, transpose in _entries(module)
            if coll == "params"}


def params_to_jax(module: nn.Module, values: Dict[str, Any],
                  missing: Any = None) -> Dict:
    """A JAX-layout ``params``-shaped tree of per-parameter ``values``
    ({parameter name: tensor}, e.g. Adam's first moments); a parameter
    without a value gets ``missing`` (a copy of it)."""
    tree: Dict = {}
    for key, (path, transpose) in param_paths(module).items():
        v = values.get(key)
        if v is None:
            leaf = copy.deepcopy(missing)
        else:
            arr = v.detach().float().cpu().numpy()
            leaf = np.array(arr.T if transpose else arr, order="C")
        _set(tree, path, leaf)
    return tree


def jax_to_params(module: nn.Module, tree: Dict) -> Dict[str, torch.Tensor]:
    """{parameter name: f32 tensor} from a JAX-layout ``params``-shaped
    tree; a leaf that is not an array (flax's ``{}`` of a masked leaf) is
    left out."""
    out = {}
    for key, (path, transpose) in param_paths(module).items():
        leaf = _get(tree, path)
        if isinstance(leaf, (np.ndarray, np.generic)):
            arr = np.asarray(leaf, np.float32)
            out[key] = torch.from_numpy(np.array(arr.T if transpose else arr,
                                                 np.float32, order="C"))
    return out
