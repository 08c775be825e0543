"""The port's reference-checkpoint converters (``text2pos_torch/utils/
convert_torch.py``, ``convert_whole_model.py``) against the JAX package's,
on checkpoints fabricated by ``text2pos_torch/utils/reference_models.py``
(the reference's module trees, seeded weights, non-trivial BN statistics).

Tolerances: the converted trees equal JAX's exactly (keys, shapes, dtypes,
values), as do the msgpack files read back. The converted attention and
GNN block match the fabricated torch modules to 2e-5 and the full
SuperGlue's log-transport to 3e-4, as JAX's
``tests/test_convert_whole_model.py`` holds its own; the GNN kernel's
packed weights (its plain version on the CPU) to the same 3e-4. The
converted coarse tower's f32 text and cell encodings (unit vectors) match
the fabricated module's own forward in float64 to 5e-5 (1.0e-5 and 1.1e-7
measured; a swapped LSTM direction or a halved BN mean moves them by
0.68 and 0.85).
"""

import pickle
import sys

import numpy as np
import pytest
import torch
from torch import nn

from test_superglue_torch_parity import torch_log_optimal_transport
from text2pos_tpu.utils import convert_torch as jct
from text2pos_tpu.utils import convert_whole_model as jcw
from text2pos_torch.utils import convert_torch as ct
from text2pos_torch.utils import convert_whole_model as cw
from text2pos_torch.utils import reference_models as rm
from text2pos_torch.utils.msgpack_io import msgpack_restore

torch.set_num_threads(2)

E = 16
NUM_LAYERS = 2
WORDS = ["the", "pose", "is", "east", "of", "a", "gray", "building",
         "north", "pad"]


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.fixture(params=["coarse", "fine"])
def fabricated(request, tmp_path):
    if request.param == "coarse":
        model, registry = rm.make_coarse_model(E, WORDS, seed=3)
    else:
        model, registry = rm.make_fine_model(E, NUM_LAYERS, WORDS, seed=4,
                                             sinkhorn_iters=5)
    path = str(tmp_path / f"{request.param}.pth")
    rm.save_whole_model(model, registry, path)
    return request.param, model, path, tmp_path


def test_whole_model_trees_equal_jax(fabricated):
    """One fabricated pickle each, converted by both packages: equal
    payloads, and the port's msgpack file reads back to JAX's tree."""
    kind, model, path, tmp = fabricated
    got = cw.convert_checkpoint(path, str(tmp / "port.msgpack"))
    want = jcw.convert_checkpoint(path, str(tmp / "jax.msgpack"))
    assert got["extra"]["source_class"] == type(model).__name__
    assert_trees_equal(got, want)
    with open(tmp / "port.msgpack", "rb") as f:
        back = msgpack_restore(f.read())
    with open(tmp / "jax.msgpack", "rb") as f:
        jback = msgpack_restore(f.read())
    assert_trees_equal(back, jback)
    assert back["extra"]["known_words"] == WORDS
    np.testing.assert_array_equal(
        back["params"]["language_encoder"]["lstm_fwd_w_ih"],
        model.language_encoder.lstm.weight_ih_l0.detach().numpy().T)


def test_converted_models_load_and_run_on_cpu(tmp_path):
    """The converted payloads restore the port's pipeline through
    ``utils/convert_jax.py`` (every leaf used) and run its encoders."""
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline

    paths = []
    for kind in ("coarse", "fine"):
        model, reg = (rm.make_coarse_model(E, WORDS, 1) if kind == "coarse"
                      else rm.make_fine_model(E, NUM_LAYERS, WORDS, 2, 5))
        pth, out = str(tmp_path / f"{kind}.pth"), str(tmp_path / f"{kind}.mp")
        rm.save_whole_model(model, reg, pth)
        cw.convert_checkpoint(pth, out)
        paths.append(out)
    pipe = LocalizationPipeline.from_checkpoints(*paths, dtype=None,
                                                 device="cpu")
    tokens = torch.tensor([[1, 2, 3, 4, 0], [5, 6, 7, 0, 0]])
    lengths = torch.tensor([4, 3])
    with torch.no_grad():
        enc = pipe.coarse.encode_text(tokens, lengths)
        hint = pipe.fine.encode_hints(tokens[:, None], lengths[:, None])
    assert enc.shape == (2, E) and torch.isfinite(enc).all()
    assert hint.shape == (2, 1, E) and torch.isfinite(hint).all()
    assert pipe.fine.superglue.num_layers == NUM_LAYERS


def test_pointnet_state_dict_trees_equal_jax(tmp_path):
    """The reference's PointNet++ state dict: both converters' trees equal,
    the port's file loads into the port's PointNet++ (``--pointnet_path``)
    with every leaf used and runs."""
    from text2pos_torch.models.pointnet2 import PointNet2
    from text2pos_torch.train.state import load_checkpoint, load_variables

    pth = str(tmp_path / "pointnet.pth")
    rm.save_pointnet_state_dict(pth, seed=5)
    got = ct.load_reference_pointnet(pth)
    want = jct.load_reference_pointnet(pth)
    assert_trees_equal(got, want)
    ct.save_as_native(pth, str(tmp_path / "pn.msgpack"))
    payload = load_checkpoint(str(tmp_path / "pn.msgpack"))
    assert_trees_equal({k: payload[k] for k in ("params", "batch_stats")},
                       got)
    pn = PointNet2(heads=(rm.NUM_CLASSES, rm.NUM_COLORS))
    load_variables(pn, payload)
    sd = rm.make_pointnet_state_dict(seed=5)
    np.testing.assert_array_equal(pn.lin1.weight.detach().numpy(),
                                  sd["lin1.weight"].numpy())


def test_malicious_reduce_is_blocked(tmp_path):
    """A checkpoint whose pickle calls ``os.system`` through
    ``__reduce__`` is refused by the restricted unpickler, not run."""

    class Evil:
        def __reduce__(self):
            import os
            return (os.system, ("echo pwned",))

    path = tmp_path / "evil.pth"
    torch.save({"model": Evil()}, str(path))
    with pytest.raises(pickle.UnpicklingError, match="blocked unpickle"):
        cw.load_whole_model(str(path))


def test_stub_modules_are_scoped(tmp_path):
    """After ``load_whole_model`` returns, ``sys.modules`` and
    ``sys.meta_path`` are as they were: no stub package shadows a later
    genuine import of e.g. ``models``."""
    model, registry = rm.make_coarse_model(E, WORDS)
    pth = str(tmp_path / "coarse_scoped.pth")
    rm.save_whole_model(model, registry, pth)
    modules, meta_path = set(sys.modules), list(sys.meta_path)
    loaded = cw.load_whole_model(pth)
    assert type(loaded).__name__ == "CellRetrievalNetwork"
    assert set(sys.modules) == modules
    assert sys.meta_path == meta_path
    assert not [n for n, m in sys.modules.items()
                if isinstance(m, cw._StubModule)]


def test_weights_only_state_dict_and_whole_module_pointnet(tmp_path):
    """A state dict loads with ``weights_only=True``; a whole-module
    PointNet++ pickle goes through the restricted unpickler instead."""
    pn = rm.randomize_batch_norms(rm.make_pointnet(), 2)
    path = str(tmp_path / "whole_pn.pth")
    rm.save_whole_model(pn, {"models.pointcloud.pointnet2": [
        rm.SetAbstractionLayer, rm.GlobalAbstractionLayer]}, path)
    got = ct.load_reference_pointnet(path)
    want = ct.convert_pointnet2_state_dict(pn.state_dict())
    assert_trees_equal(got, want)


def _torch_attention(proj, merge, x_q, x_kv, heads):
    """The reference's MultiHeadedAttention.forward (superglue.py:103-115):
    Conv1d projections, ``view(B, dim, heads, N)``, scaled dot-product
    attention, merge. Inputs [B, D, N]."""
    B, D, _ = x_q.shape
    dim = D // heads
    q = proj[0](x_q).view(B, dim, heads, -1)
    k = proj[1](x_kv).view(B, dim, heads, -1)
    v = proj[2](x_kv).view(B, dim, heads, -1)
    scores = torch.einsum("bdhn,bdhm->bhnm", q, k) / dim ** 0.5
    prob = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhnm,bdhm->bdhn", prob, v)
    return merge(out.contiguous().view(B, dim * heads, -1))


def _attn_tree(sd, prefix):
    perm = cw._attn_head_perm(E, rm.HEADS)
    tree = {"merge": cw._attn_merge(sd, f"{prefix}.attn.merge", perm)}
    for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
        tree[name] = cw._attn_proj(sd, f"{prefix}.attn.proj.{j}", perm)
    return tree


def test_converted_attention_matches_torch():
    from text2pos_torch.models.superglue import MultiHeadedAttention
    from text2pos_torch.utils.convert_jax import load_jax_params

    torch.manual_seed(7)
    lyr = rm.AttentionalPropagation(E)
    x_q, x_kv = torch.randn(2, E, 5), torch.randn(2, E, 7)
    with torch.no_grad():
        want = _torch_attention(list(lyr.attn.proj), lyr.attn.merge, x_q,
                                x_kv, rm.HEADS)
    sd = {f"l.{k}": v.numpy() for k, v in lyr.state_dict().items()}
    ours = MultiHeadedAttention(rm.HEADS, E)
    assert load_jax_params(ours, _attn_tree(sd, "l")) == []
    with torch.no_grad():
        got = ours(x_q.transpose(1, 2), x_kv.transpose(1, 2),
                   x_kv.transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want.numpy(),
                               atol=2e-5)


def test_converted_gnn_block_matches_torch():
    from text2pos_torch.models.superglue import AttentionalPropagation
    from text2pos_torch.utils.convert_jax import load_jax_params

    torch.manual_seed(11)
    lyr = rm.randomize_batch_norms(rm.AttentionalPropagation(E), 11).eval()
    x, src = torch.randn(2, E, 6), torch.randn(2, E, 4)
    with torch.no_grad():
        msg = _torch_attention(list(lyr.attn.proj), lyr.attn.merge, x, src,
                               rm.HEADS)
        want = lyr.mlp(torch.cat([x, msg], dim=1))
    sd = {f"l.{k}": v.numpy() for k, v in lyr.state_dict().items()}
    bn_p, bn_s = cw._bn(sd, "l.mlp.1")
    params = {"attn": _attn_tree(sd, "l"),
              "mlp": {"dense_0": cw._conv1d(sd, "l.mlp.0"),
                      "dense_1": cw._conv1d(sd, "l.mlp.3"), "bn_0": bn_p}}
    ours = AttentionalPropagation(E).eval()
    assert load_jax_params(ours, params, {"mlp": {"bn_0": bn_s}}) == []
    with torch.no_grad():
        got = ours(x.transpose(1, 2), src.transpose(1, 2))
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want.numpy(),
                               atol=2e-5)


def _reference_log_transport(model, d0, d1, iters):
    """The fabricated reference SuperGlue's forward in eval mode
    (superglue.py:130-146,239-266): alternating self/cross blocks with
    shared weights, the final projection, scaled scores, log-OT."""
    x0 = torch.from_numpy(d0).permute(0, 2, 1)
    x1 = torch.from_numpy(d1).permute(0, 2, 1)
    with torch.no_grad():
        for i, lyr in enumerate(model.superglue.gnn.layers):
            src0, src1 = (x1, x0) if i % 2 else (x0, x1)
            m0 = _torch_attention(list(lyr.attn.proj), lyr.attn.merge, x0,
                                  src0, rm.HEADS)
            m1 = _torch_attention(list(lyr.attn.proj), lyr.attn.merge, x1,
                                  src1, rm.HEADS)
            x0 = x0 + lyr.mlp(torch.cat([x0, m0], dim=1))
            x1 = x1 + lyr.mlp(torch.cat([x1, m1], dim=1))
        md0 = model.superglue.final_proj(x0).permute(0, 2, 1)
        md1 = model.superglue.final_proj(x1).permute(0, 2, 1)
        scores = torch.einsum("bmd,bnd->bmn", md0, md1) / E ** 0.5
        return torch_log_optimal_transport(scores, model.superglue.bin_score,
                                           iters).numpy()


def test_converted_superglue_log_transport_matches_torch(tmp_path):
    """The whole fabricated fine pickle converted: the port's SuperGlue
    (module form) and the GNN kernel's packed weights (through its plain
    version on the CPU, then the transport) give the reference's
    log-transport; the head permutation reaches the kernel's pack."""
    from text2pos_torch.models.superglue import SuperGlue
    from text2pos_torch.ops.sinkhorn import log_optimal_transport_plain
    from text2pos_torch.ops.superglue_gnn import gnn_scores_plain
    from text2pos_torch.utils.convert_jax import load_jax_params

    model, registry = rm.make_fine_model(E, NUM_LAYERS, WORDS, seed=23,
                                         sinkhorn_iters=5)
    rng = np.random.default_rng(3)
    d0 = rng.normal(size=(2, 5, E)).astype(np.float32)
    d1 = rng.normal(size=(2, 3, E)).astype(np.float32)
    want = _reference_log_transport(model, d0, d1, 5)

    pth = str(tmp_path / "fine.pth")
    rm.save_whole_model(model, registry, pth)
    payload = cw.convert_checkpoint(pth, str(tmp_path / "fine.msgpack"))
    sg = SuperGlue(E, NUM_LAYERS, 5).eval()
    assert load_jax_params(sg, payload["params"]["superglue"],
                           payload["batch_stats"]["superglue"]) == []
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    with torch.no_grad():
        got = sg(t0, t1)["log_P"].numpy()
        scores = gnn_scores_plain(t0, t1, sg.packed_kernel_params())
        packed = log_optimal_transport_plain(scores, sg.bin_score, 5).numpy()
    np.testing.assert_allclose(got, want, atol=3e-4)
    np.testing.assert_allclose(packed, want, atol=3e-4)


def test_reference_models_are_the_reference_tree():
    """The fabricator's trees carry the reference's names (the JAX test's
    module tree) and its BN statistics are not the defaults."""
    model, registry = rm.make_fine_model(E, 1, WORDS, seed=0)
    sd = model.state_dict()
    for key in ("superglue.gnn.layers.1.attn.proj.2.weight",
                "superglue.gnn.layers.0.mlp.3.bias", "superglue.bin_score",
                "object_encoder.pointnet.sa3.point_conv.local_nn.1.1."
                "running_var", "language_encoder.lstm.weight_hh_l0_reverse",
                "mlp_offsets.2.weight"):
        assert key in sd, key
    bn = model.superglue.gnn.layers[0].mlp[1]
    assert not torch.allclose(bn.running_var, torch.ones_like(
        bn.running_var))
    assert isinstance(model.language_encoder.lstm, nn.LSTM)
    assert set(registry) == {"models.superglue_matcher",
                             "models.pointcloud.pointnet2",
                             "models.superglue"}


def test_converted_coarse_tower_matches_reference_forward(tmp_path):
    """The converted coarse model's text and cell encodings (the port's
    plain versions on the CPU, f32) against the fabricated reference
    module's own forward in float64 (``reference_models``: its modules on
    the port's sampling decisions), on another synthetic map than the one
    its BN statistics were calibrated on; and those cells do not collapse
    onto one encoding."""
    import copy

    from text2pos_torch.data.dense import build_cell_bank
    from text2pos_torch.data.synthetic import make_synthetic_dataset
    from text2pos_torch.evaluation.pipeline import (bank_tensors,
                                                    coarse_cell_points)
    from text2pos_torch.models.cell_retrieval import CellRetrievalNetwork
    from text2pos_torch.utils.convert_jax import load_jax_params

    model, registry = rm.make_coarse_model(E, WORDS, seed=5)
    pth = str(tmp_path / "coarse.pth")
    rm.save_whole_model(model, registry, pth)
    payload = cw.convert_checkpoint(pth, str(tmp_path / "coarse.msgpack"))
    net = CellRetrievalNetwork(len(WORDS) + 1, E).eval()
    unused = load_jax_params(net, payload["params"], payload["batch_stats"])
    assert unused and all(u.split("/")[-2] in ("class_classifier",
                                               "color_classifier")
                          for u in unused), unused
    ref = copy.deepcopy(model).double()

    cells, _ = make_synthetic_dataset(
        seed=5, scene_name="9905", extent=90.0, cell_size=30.0,
        poses_per_cell=1, objects_per_cell_area=12)
    bt = bank_tensors(build_cell_bank(cells, 28, 64, seed=0), "cpu")
    n = bt["mask"].shape[0]
    flat = coarse_cell_points(bt, torch.arange(n),
                              torch.Generator().manual_seed(1), num_points=64)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, len(WORDS) + 1, (6, 9)))
    lengths = torch.as_tensor(rng.integers(1, 10, 6))
    with torch.no_grad():
        got_cells = net.encode_objects(*flat, n, bt["mask"].shape[1])
        want_cells = rm.reference_encode_cells(
            ref, *(t.double() for t in flat[:4]), flat[4], n)
        got_text = net.encode_text(tokens, lengths)
        want_text = rm.reference_encode_text(ref, tokens, lengths)
    np.testing.assert_allclose(got_cells.double(), want_cells, atol=5e-5)
    np.testing.assert_allclose(got_text.double(), want_text, atol=5e-5)
    cos = want_cells @ want_cells.T - 2 * torch.eye(n, dtype=torch.float64)
    assert float(cos.max()) < 0.99
