"""Convert the reference's PointNet++ state dict into the port's
checkpoint (counterpart of ``text2pos_tpu/utils/convert_torch.py``).

The reference ships exactly one state-dict checkpoint — the pretrained
PointNet++ (``pointnet_acc0.86_lr1_p256.pth``, saved by the Text2Pos
reference code's training/pointcloud/pointnet2.py:158 and consumed by
object_encoder.py:46). Its module tree:

    sa{1,2,3}.point_conv.local_nn.<i>.{0,1}.{weight,bias,running_*}
        — get_mlp stacks: <i> indexes the (Linear, BatchNorm1d, ReLU)
          triple, .0 = Linear, .1 = BatchNorm1d
    ga.mlp.<i>.{0,1}.*       — global-abstraction MLP, same layout
    lin1 / lin2              — plain Linear
    class_classifier / color_classifier

This module maps those tensors onto the JAX-layout tree that the port's
``models/pointnet2.py`` reads through ``utils/convert_jax.py`` (the
checkpoints of both packages have it): torch Linear weights are [out, in]
→ transposed; BatchNorm scale/bias/running stats map to MaskedBatchNorm
params and batch_stats. ``save_as_native`` writes the msgpack payload
``{params, batch_stats, extra}`` that ``--pointnet_path`` and
``train/pointnet2.py`` read. The coarse/fine *model* checkpoints are
whole-module pickles: ``utils/convert_whole_model.py``.

    python -m text2pos_torch.utils.convert_torch --path_in P.pth \
        --path_out P.msgpack
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _linear(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": np.asarray(sd[f"{prefix}.weight"]).T.astype(np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"]).astype(np.float32),
    }


def _bn(sd: Dict, prefix: str) -> Tuple[Dict, Dict]:
    params = {
        "scale": np.asarray(sd[f"{prefix}.weight"]).astype(np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"]).astype(np.float32),
    }
    stats = {
        "mean": np.asarray(sd[f"{prefix}.running_mean"]).astype(np.float32),
        "var": np.asarray(sd[f"{prefix}.running_var"]).astype(np.float32),
    }
    return params, stats


def _mlp(sd: Dict, prefix: str, num_layers: int) -> Tuple[Dict, Dict]:
    """A get_mlp stack: (Linear, BN, ReLU) per layer (reference
    modules.py:21-29; layer i lives at ``{prefix}.{i}.0`` / ``.1``)."""
    params, stats = {}, {}
    for i in range(num_layers):
        params[f"dense_{i}"] = _linear(sd, f"{prefix}.{i}.0")
        bn_p, bn_s = _bn(sd, f"{prefix}.{i}.1")
        params[f"bn_{i}"] = bn_p
        stats[f"bn_{i}"] = bn_s
    return params, stats


def convert_pointnet2_state_dict(sd: Dict) -> Dict[str, Dict]:
    """Reference PointNet2 state_dict → {'params', 'batch_stats'}, the
    JAX-layout trees of the port's ``PointNet2`` (both heads included)."""
    sd = {k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
          for k, v in sd.items()}
    params: Dict = {}
    stats: Dict = {}

    for name in ("sa1", "sa2", "sa3"):
        p, s = _mlp(sd, f"{name}.point_conv.local_nn", 2)
        params[name] = {"conv_mlp": p}
        stats[name] = {"conv_mlp": s}

    p, s = _mlp(sd, "ga.mlp", 2)
    params["ga"] = {"mlp": p}
    stats["ga"] = {"mlp": s}

    params["lin1"] = _linear(sd, "lin1")
    params["lin2"] = _linear(sd, "lin2")
    params["class_classifier"] = _linear(sd, "class_classifier")
    params["color_classifier"] = _linear(sd, "color_classifier")

    return {"params": params, "batch_stats": stats}


def load_reference_pointnet(path: str) -> Dict[str, Dict]:
    """Load a reference ``pointnet_*.pth`` checkpoint: a state dict (read
    with ``weights_only=True``), or a whole-module pickle (read by
    ``convert_whole_model.load_whole_model``'s restricted unpickler)."""
    import pickle

    import torch

    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        from text2pos_torch.utils.convert_whole_model import (
            flatten_module, load_whole_model)

        sd = flatten_module(load_whole_model(path))
    return convert_pointnet2_state_dict(sd)


def save_as_native(path_in: str, path_out: str) -> None:
    """Convert a reference PointNet checkpoint to a msgpack one, loadable
    via --pointnet_path."""
    from text2pos_torch.utils.msgpack_io import msgpack_serialize

    variables = load_reference_pointnet(path_in)
    payload = {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "extra": {"converted_from": path_in},
    }
    with open(path_out, "wb") as f:
        f.write(msgpack_serialize(payload))


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="Convert reference pointnet .pth → .msgpack")
    parser.add_argument("--path_in", required=True)
    parser.add_argument("--path_out", required=True)
    args = parser.parse_args()
    save_as_native(args.path_in, args.path_out)
    print(f"converted {args.path_in} → {args.path_out}")
