"""The port's ``fast_graph`` module form of the GNN (``models/blocks.py``
``DenseParams``, ``FastSuperGlueMLP``; fused q/k/v in
``models/superglue.py``) against the plain form and against JAX's
``fast_graph``, and JAX's switch ``T2P_FAST_GRAPH=1`` in the serving
pipeline.

Tolerances, as JAX's ``tests/test_fast_graph.py``: f32 log-transport 2e-5
(absolute and relative) between the forms, hard matches equal on at least
99% of rows; bf16 0.15. Against JAX's fast form on the same parameters,
f32 2e-5, bf16 0.15. Served with the switch, f32 ``top_idx`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.models.superglue import SuperGlue as JSuperGlue
from text2pos_torch.models.blocks import (DenseParams, FastSuperGlueMLP,
                                          SuperGlueMLP, set_eval_batch_stats)
from text2pos_torch.models.superglue import SuperGlue, with_fast_graph
from text2pos_torch.utils.convert_jax import load_jax_params, module_to_jax

torch.set_num_threads(2)

E = 32


def _descriptors(seed, B):
    rng = jax.random.PRNGKey(seed)
    d0 = jax.random.normal(jax.random.fold_in(rng, 1), (B, 8, E))
    d1 = jax.random.normal(jax.random.fold_in(rng, 2), (B, 5, E))
    return rng, d0, d1


def _jax_case(seed, B, dtype=None):
    """JAX's plain model's variables and both JAX forms' log-transport."""
    rng, d0, d1 = _descriptors(seed, B)
    std = JSuperGlue(descriptor_dim=E, num_layers=2, sinkhorn_iterations=10,
                     eval_batch_stats=True, dtype=dtype)
    v = std.init(rng, d0, d1, train=False)
    fast = std.clone(fast_graph=True).apply(v, d0, d1, train=False)
    return (jax.tree.map(np.asarray, v), np.asarray(d0), np.asarray(d1),
            np.asarray(fast["log_P"], np.float32))


def _port(variables, fast, dtype=None):
    sg = SuperGlue(E, 2, 10, dtype=dtype, fast_graph=fast).eval()
    assert load_jax_params(sg, variables["params"],
                           variables.get("batch_stats", {})) == []
    return set_eval_batch_stats(sg, True)


@pytest.mark.parametrize("dtype, tol", [(None, 2e-5),
                                        (torch.bfloat16, 0.15)],
                         ids=["f32", "bf16"])
def test_fast_and_plain_forms_close(dtype, tol):
    v, d0, d1, _ = _jax_case(0 if dtype is None else 3, 6)
    plain, fast = _port(v, False, dtype), _port(v, True, dtype)
    sd_p, sd_f = plain.state_dict(), fast.state_dict()
    assert {k: t.shape for k, t in sd_p.items()} == {
        k: t.shape for k, t in sd_f.items()}
    t0, t1 = torch.from_numpy(d0), torch.from_numpy(d1)
    with torch.no_grad():
        a, b = plain(t0, t1), fast(t0, t1)
    np.testing.assert_allclose(b["log_P"].float().numpy(),
                               a["log_P"].float().numpy(), atol=tol,
                               rtol=tol)
    if dtype is None:
        same = (a["matches0"] == b["matches0"]).float().mean()
        assert float(same) >= 0.99


@pytest.mark.parametrize("dtype, jdtype, tol",
                         [(None, None, 2e-5),
                          (torch.bfloat16, jnp.bfloat16, 0.15)],
                         ids=["f32", "bf16"])
def test_fast_form_matches_jax(dtype, jdtype, tol):
    v, d0, d1, want = _jax_case(1, 4, jdtype)
    fast = _port(v, True, dtype)
    with torch.no_grad():
        got = fast(torch.from_numpy(d0), torch.from_numpy(d1))["log_P"]
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


def test_fast_form_modules_and_switching():
    """The fast form holds ``DenseParams`` and ``FastSuperGlueMLP`` under
    the plain form's names; ``with_fast_graph`` switches either way with the
    same state, BN mode and training flag, and the JAX trees agree."""
    v, d0, d1, _ = _jax_case(2, 2)
    plain = _port(v, False)
    fast = with_fast_graph(plain)
    lyr = fast.gnn.layer_0
    assert isinstance(lyr.mlp, FastSuperGlueMLP)
    assert isinstance(lyr.mlp.dense_0, DenseParams)
    assert isinstance(lyr.attn.proj_q, DenseParams)
    assert type(plain.gnn.layer_0.mlp) is SuperGlueMLP
    assert fast.eval_batch_stats and not fast.training
    k, b = lyr.attn.proj_k()
    assert torch.equal(k, plain.gnn.layer_0.attn.proj_k.weight.t())
    back = with_fast_graph(fast, False)
    for x, y in ((module_to_jax(plain), module_to_jax(fast)),
                 (module_to_jax(plain), module_to_jax(back))):
        jax.tree.map(np.testing.assert_array_equal, x, y)
    assert not back.fast_graph and type(back.gnn.layer_1.mlp) is SuperGlueMLP


def test_switch_serves_same_top_idx(monkeypatch):
    """``T2P_FAST_GRAPH=1`` (read where JAX reads it, when the serving
    pipeline is restored from the DB cache) puts the fine model in the fast
    form; f32 ``top_idx`` on 16 bench queries equals the plain form's."""
    from text2pos_torch.evaluation.pipeline import LocalizationPipeline

    ck = "checkpoints/bench_{}.msgpack"
    fx = np.load("text2pos_torch/fixtures/bench_queries.npz")
    q = [torch.from_numpy(fx[k][:16]) for k in
         ("tokens", "lengths", "hint_tokens", "hint_lengths")]
    outs = {}
    for on in ("0", "1"):
        monkeypatch.setenv("T2P_FAST_GRAPH", on)
        pipe = LocalizationPipeline.from_checkpoints(
            ck.format("coarse"), ck.format("fine"),
            "checkpoints/bench_db_cache.npz", dtype=None, device="cpu")
        assert pipe.fine.superglue.fast_graph == (on == "1")
        with torch.no_grad():
            outs[on] = pipe.serve_batch(*q, 10)
    np.testing.assert_array_equal(outs["0"][0].numpy(), outs["1"][0].numpy())
