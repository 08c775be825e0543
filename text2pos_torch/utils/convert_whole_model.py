"""Convert the reference's whole-model pickles into the port's checkpoints
(counterpart of ``text2pos_tpu/utils/convert_whole_model.py``).

The reference saves its coarse/fine models as *whole-module* pickles —
``torch.save(model)`` (the Text2Pos reference code's
training/coarse.py:314-335, fine.py:358-378) — which the released
checkpoints use (its evaluation/pipeline.py:313-314, README.md:45-46).
Unpickling them normally requires torch_geometric and the reference
package. This module loads them WITHOUT either, by extending the
stub-unpickler technique of ``data/legacy.py`` to ``nn.Module`` object
graphs:

 1. every missing module path (``models.*``, ``torch_geometric.*``,
    ``easydict``, …) is registered as a stub module whose attribute
    lookups fabricate attribute-bag classes on demand;
 2. ``torch.load`` then restores the full module tree as plain objects
    (tensors are handled by torch's own persistent-id machinery — torch
    itself is installed);
 3. the tree is walked through ``_parameters``/``_buffers``/``_modules``
    into a flat state_dict, and mapped onto the JAX-layout trees the port's
    modules read through ``utils/convert_jax.py``
    (torch Linear/Conv1d(k=1) kernels transposed, LSTM gate stacks
    transposed + fused biases, BatchNorm running stats → batch_stats);
 4. the model's own attributes (``args``, ``language_encoder.known_words``)
    are mined for the vocab + hyperparameters, so the resulting msgpack
    payload ``{params, batch_stats, extra}`` (``utils/msgpack_io.py``) is
    directly consumable by ``LocalizationPipeline.from_checkpoints``,
    ``evaluation.pipeline.build_pipeline_from_checkpoints`` and the
    trainers' ``--continue_path``.

The reference splits attention heads interleaved (channel c in head
c % heads); the port's heads are contiguous blocks, as JAX's, and the GNN
kernel packs its weights from that layout: ``_attn_head_perm`` re-lays the
q/k/v output channels and the merge's input rows out once, here.

    python -m text2pos_torch.utils.convert_whole_model --path_in M.pth \
        --path_out M.msgpack
"""

from __future__ import annotations

import sys
import types
from typing import Any, Dict, List, Tuple

import numpy as np

from text2pos_torch.utils.convert_torch import convert_pointnet2_state_dict

# Module paths that reference whole-model pickles may refer to and that are
# absent from this environment. Anything importable (torch, numpy, argparse)
# is NOT stubbed.
_STUB_ROOTS = (
    "models",
    "torch_geometric",
    "torch_cluster",
    "torch_scatter",
    "torch_sparse",
    "easydict",
    "datapreparation",
    "dataloading",
)


class _StubBase:
    """Attribute bag standing in for any unavailable class during unpickle.

    Mirrors ``torch.nn.Module.__getattr__``: submodules/params/buffers live
    in ``_modules``/``_parameters``/``_buffers`` dicts, not as direct
    attributes, so attribute access falls through to those."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:  # pragma: no cover - exotic reduce protocols
            self.__dict__["_pickled_state"] = state

    def __getattr__(self, name):
        d = self.__dict__
        for bag in ("_parameters", "_buffers", "_modules"):
            coll = d.get(bag)
            if coll is not None and name in coll:
                return coll[name]
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")


class _StubDict(dict):
    """Stub for dict subclasses (e.g. easydict.EasyDict)."""

    def __init__(self, *args, **kwargs):
        try:
            super().__init__(*args, **kwargs)
        except Exception:
            super().__init__()

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e


class _StubModule(types.ModuleType):
    """Module whose attribute lookups fabricate stub classes on demand."""

    def __getattr__(self, name):
        if name.startswith("__") and name.endswith("__"):
            raise AttributeError(name)
        base = _StubDict if name == "EasyDict" else _StubBase
        cls = type(name, (base,), {"__module__": self.__name__})
        setattr(self, name, cls)
        return cls


def install_stub_modules() -> List[str]:
    """Register stub packages for every missing reference dependency, plus
    lazily-created submodules (``models.superglue`` etc. appear as pickles
    reference them via ``sys.modules`` lookups by the unpickler).

    Returns the list of root names actually stubbed (for later cleanup)."""
    installed: List[str] = []
    for root in _STUB_ROOTS:
        if root in sys.modules:
            continue
        try:
            __import__(root)
            continue  # actually installed — leave it alone
        except ImportError:
            pass
        mod = _StubModule(root)
        # Mark as a package: submodule imports ("models.superglue_matcher")
        # require the parent to expose __path__ or the import machinery
        # aborts with "'models' is not a package" before consulting
        # meta-path finders.
        mod.__path__ = []
        sys.modules[root] = mod
        installed.append(root)

    # The unpickler imports submodules (e.g. models.cell_retrieval) with
    # __import__; make stub roots produce stub submodules on import by
    # pre-registering a meta-path finder.
    if not any(isinstance(f, _StubFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, _StubFinder())
    return installed


class stubbed_modules:
    """Context manager scoping the stub machinery to one ``torch.load``.

    On exit every stub root registered on entry — and any stub submodule
    created under it during unpickling — is removed from ``sys.modules``,
    and the meta-path finder is uninstalled, so a later genuine import of a
    package named e.g. ``models`` resolves normally instead of silently
    hitting a stub attribute-bag."""

    def __enter__(self):
        self._installed = set(install_stub_modules())
        return self

    def __exit__(self, *exc):
        for name in list(sys.modules):
            if name.split(".")[0] in self._installed and isinstance(
                    sys.modules.get(name), _StubModule):
                del sys.modules[name]
        sys.meta_path[:] = [f for f in sys.meta_path
                            if not isinstance(f, _StubFinder)]
        return False


# ----------------------------------------------------------------------
# Restricted unpickling
# ----------------------------------------------------------------------
# ``torch.save(model)`` pickles execute arbitrary callables via __reduce__
# if loaded with a permissive Unpickler. Released checkpoints are untrusted
# input, so find_class only resolves (a) torch's own rebuild machinery,
# (b) numpy reconstruction, (c) a small set of harmless builtins/stdlib
# containers, and (d) the stub roots (which fabricate inert attribute
# bags). Anything else — os.system, subprocess, eval, getattr… — raises.
_SAFE_MODULE_ROOTS = ("torch", "numpy", "collections", "argparse")
_SAFE_BUILTINS = frozenset({
    "set", "frozenset", "list", "dict", "tuple", "complex", "bytearray",
    "int", "float", "bool", "str", "bytes", "slice", "range", "object",
})


def _make_restricted_pickle_module():
    import pickle

    class RestrictedUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            root = module.split(".")[0]
            if root in ("builtins", "__builtin__"):  # torch emits the
                # legacy protocol-2 name "__builtin__" for e.g. set
                if name in _SAFE_BUILTINS:
                    return super().find_class(module, name)
                raise pickle.UnpicklingError(
                    f"blocked unpickle of builtins.{name}")
            if root in _SAFE_MODULE_ROOTS or root in _STUB_ROOTS:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"blocked unpickle of {module}.{name} — not on the "
                "checkpoint-conversion allowlist")

    mod = types.ModuleType("t2p_restricted_pickle")
    mod.Unpickler = RestrictedUnpickler
    mod.load = lambda f, **kw: RestrictedUnpickler(f, **kw).load()
    mod.loads = lambda s, **kw: RestrictedUnpickler(
        __import__("io").BytesIO(s), **kw).load()
    return mod


class _StubFinder:
    """Meta-path finder serving stub submodules under the stub roots."""

    def find_module(self, fullname, path=None):  # pragma: no cover - legacy
        return self if self._ours(fullname) else None

    def find_spec(self, fullname, path=None, target=None):
        if not self._ours(fullname):
            return None
        import importlib.machinery as m

        return m.ModuleSpec(fullname, _StubLoader(), is_package=True)

    @staticmethod
    def _ours(fullname: str) -> bool:
        root = fullname.split(".")[0]
        return root in _STUB_ROOTS and isinstance(
            sys.modules.get(root), _StubModule)


class _StubLoader:
    def create_module(self, spec):
        return _StubModule(spec.name)

    def exec_module(self, module):
        pass


# ----------------------------------------------------------------------
# Unpickle + flatten
# ----------------------------------------------------------------------
def load_whole_model(path: str) -> Any:
    """torch.load a whole-model pickle with scoped stubs and a restricted
    Unpickler (see `_make_restricted_pickle_module`)."""
    import torch

    with stubbed_modules():
        return torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=_make_restricted_pickle_module())


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def flatten_module(obj: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Reconstruct a torch-style flat state_dict from a stub module tree by
    walking _parameters / _buffers / _modules."""
    sd: Dict[str, np.ndarray] = {}
    d = getattr(obj, "__dict__", {})
    for name, t in (d.get("_parameters") or {}).items():
        if t is not None:
            sd[prefix + name] = _to_numpy(t)
    for name, t in (d.get("_buffers") or {}).items():
        if t is not None:
            sd[prefix + name] = _to_numpy(t)
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            sd.update(flatten_module(child, prefix + name + "."))
    return sd


# ----------------------------------------------------------------------
# Tensor-layout converters
# ----------------------------------------------------------------------
def _linear(sd, prefix) -> Dict[str, np.ndarray]:
    return {"kernel": np.asarray(sd[f"{prefix}.weight"], np.float32).T,
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _conv1d(sd, prefix) -> Dict[str, np.ndarray]:
    """Conv1d(k=1) used by SuperGlue's MLP/proj (reference superglue.py:53-64)
    → Dense kernel."""
    w = np.asarray(sd[f"{prefix}.weight"], np.float32)   # [out, in, 1]
    return {"kernel": w[:, :, 0].T,
            "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}


def _bn(sd, prefix) -> Tuple[Dict, Dict]:
    params = {"scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
              "bias": np.asarray(sd[f"{prefix}.bias"], np.float32)}
    stats = {"mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
             "var": np.asarray(sd[f"{prefix}.running_var"], np.float32)}
    return params, stats


def _get_mlp(sd, prefix, num_layers) -> Tuple[Dict, Dict]:
    """reference get_mlp stack: layer i at {prefix}.{i}.0 / .{i}.1
    (modules.py:11-29)."""
    params, stats = {}, {}
    for i in range(num_layers):
        params[f"dense_{i}"] = _linear(sd, f"{prefix}.{i}.0")
        bn_p, bn_s = _bn(sd, f"{prefix}.{i}.1")
        params[f"bn_{i}"] = bn_p
        stats[f"bn_{i}"] = bn_s
    return params, stats


def _attn_head_perm(d_model: int, num_heads: int) -> np.ndarray:
    """Channel permutation mapping the reference's head layout onto ours.

    The reference projects with Conv1d and splits heads as
    ``view(B, dim, heads, N)`` (superglue.py:108-112): torch output channel
    ``c`` belongs to head ``c % heads`` at head-dim ``c // heads``
    (interleaved). The port's attention reshapes ``[B, N, d_model] →
    (B, N, heads, dim)``: channel ``c`` belongs to head ``c // dim``
    (contiguous blocks). perm[h*dim + d] = d*heads + h, so indexing a torch
    channel axis with ``perm`` re-partitions it into our block layout
    without changing the attention function.
    """
    dim = d_model // num_heads
    h = np.repeat(np.arange(num_heads), dim)
    d = np.tile(np.arange(dim), num_heads)
    return d * num_heads + h


def _attn_proj(sd, prefix, perm) -> Dict[str, np.ndarray]:
    """Conv1d q/k/v projection with output channels re-laid-out per-head."""
    p = _conv1d(sd, prefix)
    return {"kernel": p["kernel"][:, perm], "bias": p["bias"][perm]}


def _attn_merge(sd, prefix, perm) -> Dict[str, np.ndarray]:
    """Conv1d merge: its *input* channels are the concatenated heads, so the
    kernel rows get the same re-layout; output channels are plain d_model."""
    p = _conv1d(sd, prefix)
    return {"kernel": p["kernel"][perm, :], "bias": p["bias"]}


def _lstm(sd, prefix) -> Dict[str, np.ndarray]:
    """Packed bi-LSTM (reference modules.py:48-53) → ops/lstm.py layout:
    w = torch_w.T, b = b_ih + b_hh; gate order (i,f,g,o) matches torch."""
    out = {}
    for ours, sfx in (("fwd", ""), ("bwd", "_reverse")):
        out[f"lstm_{ours}_w_ih"] = np.asarray(
            sd[f"{prefix}.weight_ih_l0{sfx}"], np.float32).T
        out[f"lstm_{ours}_w_hh"] = np.asarray(
            sd[f"{prefix}.weight_hh_l0{sfx}"], np.float32).T
        out[f"lstm_{ours}_b"] = (
            np.asarray(sd[f"{prefix}.bias_ih_l0{sfx}"], np.float32)
            + np.asarray(sd[f"{prefix}.bias_hh_l0{sfx}"], np.float32))
    return out


def _language_encoder(sd, prefix) -> Dict:
    p = _lstm(sd, f"{prefix}.lstm")
    p["word_embedding"] = {"embedding": np.asarray(
        sd[f"{prefix}.word_embedding.weight"], np.float32)}
    return p


def _object_encoder(sd, prefix, use_features, class_embed, color_embed
                    ) -> Tuple[Dict, Dict]:
    params: Dict = {}
    stats: Dict = {}
    pn_sd = {k[len(prefix) + len(".pointnet."):]: v for k, v in sd.items()
             if k.startswith(f"{prefix}.pointnet.")}
    pn = convert_pointnet2_state_dict(pn_sd)
    params["pointnet"] = pn["params"]
    stats["pointnet"] = pn["batch_stats"]

    if "class" in use_features:
        if class_embed:
            params["class_embedding"] = {"embedding": np.asarray(
                sd[f"{prefix}.class_embedding.weight"], np.float32)}
        else:
            params["mlp_pointnet"], stats["mlp_pointnet"] = _get_mlp(
                sd, f"{prefix}.mlp_pointnet", 1)
    if "color" in use_features:
        if color_embed:
            params["color_embedding"] = {"embedding": np.asarray(
                sd[f"{prefix}.color_embedding.weight"], np.float32)}
        else:
            params["color_encoder"], stats["color_encoder"] = _get_mlp(
                sd, f"{prefix}.color_encoder", 2)
    if "position" in use_features:
        params["pos_encoder"], stats["pos_encoder"] = _get_mlp(
            sd, f"{prefix}.pos_encoder", 2)
    params["mlp_merge"], stats["mlp_merge"] = _get_mlp(
        sd, f"{prefix}.mlp_merge", 1)
    return params, stats


def _known_words_list(known_words: Dict[str, int]) -> List[str]:
    """LanguageEncoder.known_words maps word → index starting at 1
    (reference modules.py:44); recover the ordered vocab list."""
    return [w for w, _ in sorted(known_words.items(), key=lambda kv: kv[1])]


def _args_of(model) -> Dict[str, Any]:
    args = getattr(model, "args", None)
    d = dict(getattr(args, "__dict__", {}) or {})
    if isinstance(args, dict):
        d = dict(args)
    return d


# ----------------------------------------------------------------------
# Whole-model converters
# ----------------------------------------------------------------------
def convert_cell_retrieval(model) -> Dict[str, Any]:
    """Reference CellRetrievalNetwork pickle → payload
    {'params','batch_stats','extra'} for the coarse model."""
    sd = flatten_module(model)
    a = _args_of(model)
    use_features = tuple(a.get("use_features",
                               ("class", "color", "position")))
    class_embed = bool(a.get("class_embed", False))
    color_embed = bool(a.get("color_embed", False))

    params: Dict = {}
    stats: Dict = {}
    params["language_encoder"] = _language_encoder(sd, "language_encoder")
    oe_p, oe_s = _object_encoder(sd, "object_encoder", use_features,
                                 class_embed, color_embed)
    params["object_encoder"], stats["object_encoder"] = oe_p, oe_s
    # DynamicEdgeConv stores its MLP as attribute `nn`
    # (reference cell_retrieval.py:46-54).
    graph_p, graph_s = _get_mlp(sd, "graph1.nn", 2)
    params["graph1"] = {"edge_mlp": graph_p}
    stats["graph1"] = {"edge_mlp": graph_s}
    params["lin"], stats["lin"] = _get_mlp(sd, "lin", 2)

    known_words = _known_words_list(model.language_encoder.known_words)
    extra = {
        "known_words": known_words,
        "embed_dim": int(a.get("embed_dim", getattr(model, "embed_dim", 256))),
        "variation": int(a.get("variation", getattr(model, "variation", 0))),
        "use_features": list(use_features),
        "converted_from": "reference whole-model pickle",
    }
    return {"params": params, "batch_stats": stats, "extra": extra}


def convert_superglue_match(model) -> Dict[str, Any]:
    """Reference SuperGlueMatch pickle → payload for the fine model."""
    sd = flatten_module(model)
    a = _args_of(model)
    use_features = tuple(a.get("use_features",
                               ("class", "color", "position")))
    class_embed = bool(a.get("class_embed", False))
    color_embed = bool(a.get("color_embed", False))
    num_layers = int(a.get("num_layers", getattr(model, "num_layers", 6)))

    params: Dict = {}
    stats: Dict = {}
    params["language_encoder"] = _language_encoder(sd, "language_encoder")
    oe_p, oe_s = _object_encoder(sd, "object_encoder", use_features,
                                 class_embed, color_embed)
    params["object_encoder"], stats["object_encoder"] = oe_p, oe_s

    # mlp_offsets = get_mlp_offset([E, E//2, 2]): Sequential(Linear, ReLU,
    # Linear) → indices 0 and 2 (reference superglue_matcher.py:29-49,74).
    params["mlp_offsets"] = {"dense_0": _linear(sd, "mlp_offsets.0"),
                             "dense_1": _linear(sd, "mlp_offsets.2")}

    sg: Dict = {"bin_score": np.asarray(sd["superglue.bin_score"], np.float32),
                "final_proj": _conv1d(sd, "superglue.final_proj")}
    sg_stats: Dict = {}
    gnn_p: Dict = {}
    gnn_s: Dict = {}
    embed_dim = int(a.get("embed_dim", getattr(model, "embed_dim", 128)))
    # Reference AttentionalPropagation hardcodes 4 heads (superglue.py:120).
    perm = _attn_head_perm(embed_dim, num_heads=4)
    for i in range(2 * num_layers):
        base = f"superglue.gnn.layers.{i}"
        attn = {"merge": _attn_merge(sd, f"{base}.attn.merge", perm)}
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            attn[name] = _attn_proj(sd, f"{base}.attn.proj.{j}", perm)
        # SuperGlue MLP([2E, 2E, E]): Conv1d(0), BN(1), ReLU(2), Conv1d(3)
        # (reference superglue.py:53-64).
        mlp_p = {"dense_0": _conv1d(sd, f"{base}.mlp.0"),
                 "dense_1": _conv1d(sd, f"{base}.mlp.3")}
        bn_p, bn_s = _bn(sd, f"{base}.mlp.1")
        mlp_p["bn_0"] = bn_p
        gnn_p[f"layer_{i}"] = {"attn": attn, "mlp": mlp_p}
        gnn_s[f"layer_{i}"] = {"mlp": {"bn_0": bn_s}}
    sg["gnn"] = gnn_p
    sg_stats["gnn"] = gnn_s
    params["superglue"] = sg
    stats["superglue"] = sg_stats

    known_words = _known_words_list(model.language_encoder.known_words)
    extra = {
        "known_words": known_words,
        "embed_dim": int(a.get("embed_dim", getattr(model, "embed_dim", 128))),
        "num_layers": num_layers,
        "sinkhorn_iters": int(a.get("sinkhorn_iters",
                                    getattr(model, "sinkhorn_iters", 50))),
        "use_features": list(use_features),
        "converted_from": "reference whole-model pickle",
    }
    return {"params": params, "batch_stats": stats, "extra": extra}


def convert_checkpoint(path_in: str, path_out: str) -> Dict[str, Any]:
    """Detect the model kind from the pickled class name and convert.
    Returns the payload (also written to ``path_out`` as msgpack)."""
    from text2pos_torch.utils.msgpack_io import msgpack_serialize

    model = load_whole_model(path_in)
    kind = type(model).__name__
    if kind == "CellRetrievalNetwork":
        payload = convert_cell_retrieval(model)
    elif kind == "SuperGlueMatch":
        payload = convert_superglue_match(model)
    else:
        raise ValueError(f"Unrecognized reference model class: {kind}")
    payload["extra"]["source_class"] = kind
    with open(path_out, "wb") as f:
        f.write(msgpack_serialize(payload))
    return payload


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(
        description="Convert reference whole-model .pth → .msgpack")
    parser.add_argument("--path_in", required=True)
    parser.add_argument("--path_out", required=True)
    args = parser.parse_args()
    payload = convert_checkpoint(args.path_in, args.path_out)
    print(f"converted {args.path_in} ({payload['extra']['source_class']}) "
          f"→ {args.path_out}")
