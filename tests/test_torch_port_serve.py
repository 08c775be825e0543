"""The port's calibrated ``serve_batch`` against the JAX pipeline's, on the
committed checkpoints, DB cache and bench queries (the fixture written by
``scripts/make_torch_port_fixture.py``)."""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.config import EvalConfig
from text2pos_tpu.data.hints import Vocabulary as JVocabulary
from text2pos_tpu.evaluation.pipeline import build_pipeline_from_checkpoints
from text2pos_torch.evaluation.metrics import served_accuracies
from text2pos_torch.evaluation.pipeline import LocalizationPipeline

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COARSE = os.path.join(ROOT, "checkpoints", "bench_coarse.msgpack")
FINE = os.path.join(ROOT, "checkpoints", "bench_fine.msgpack")
DB = os.path.join(ROOT, "checkpoints", "bench_db_cache.npz")
FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                       "bench_queries.npz")
Q = 16
TOP_K = 10
F16_STEP = 2.0 ** -11   # one f16 step in [0.5, 1): served positions are f16


@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def jax_pipes():
    """JAX serving pipelines (f32 and bf16 bodies) on the calibrated DB."""
    ecfg = EvalConfig(top_k=(1, 5, TOP_K), threshs=(5, 10, 15), pad_size=16,
                      num_mentioned=6, pointnet_numpoints=256)
    with np.load(DB) as z:
        db = (jnp.asarray(z["cell_enc"]), jnp.asarray(z["fine_bank_enc"]),
              jnp.asarray(z["fine_bank_centers"]))
        stats = flax.serialization.msgpack_restore(z["batch_stats"].tobytes())
    pipes = {}
    for dt in ("float32", "bfloat16"):
        pipe, _, _ = build_pipeline_from_checkpoints(ecfg, COARSE, FINE,
                                                     dtype=dt)
        pipes[dt] = pipe.with_calibrated_stats(jax.tree.map(jnp.asarray,
                                                            stats))
    return pipes, db


@pytest.fixture(scope="module")
def ports():
    return {dt: LocalizationPipeline.from_checkpoints(COARSE, FINE, DB,
                                                      dtype=dt, device="cpu")
            for dt in ("float32", "bfloat16")}


def _queries(fx, n=Q, start=0):
    sl = slice(start, start + n)
    return [fx[k][sl] for k in ("tokens", "lengths", "hint_tokens",
                                "hint_lengths")]


def _jax_serve(jax_pipes, dt, queries, *rerank):
    pipes, (cell_enc, fb0, fb1) = jax_pipes
    p = pipes[dt]
    out = p.serve_batch(p.coarse_state, p.fine_state,
                        *map(jnp.asarray, queries), cell_enc, TOP_K, fb0,
                        fb1, *rerank)
    return [np.asarray(o).astype(np.float32) for o in out]


def _port_serve(port, queries, *rerank):
    out = port.serve_batch(*queries, TOP_K, *rerank)
    return [o.numpy().astype(np.float32) for o in out]


def test_serve_f32_matches_jax(fx, jax_pipes, ports):
    """f32: identical top_idx and match counts; served (f16) positions
    within one f16 step."""
    q = _queries(fx)
    want = _jax_serve(jax_pipes, "float32", q)
    got = _port_serve(ports["float32"], q)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, w, atol=F16_STEP, rtol=0)


def test_match_positions_f32_within_1e4(fx, jax_pipes, ports):
    """The f32 in-cell positions before the f16 wire cast, JAX's
    ``_match_chunk_cached`` against the port's matcher core."""
    pipes, (_, fb0, fb1) = jax_pipes
    jp, port = pipes["float32"], ports["float32"]
    _, _, htk, hln = _queries(fx, 8, start=100)
    top_idx = fx["jax_top_idx"][100:108].astype(np.int32)
    _, jmean, joff, jconf, jcs, jsp = jp._match_chunk_cached(
        jp.fine_state, fb0, fb1, jnp.asarray(top_idx), jnp.asarray(htk),
        jnp.asarray(hln))
    flat = torch.as_tensor(top_idx.astype(np.int64)).reshape(-1)
    with torch.no_grad():
        hint_enc = port.fine.encode_hints(torch.as_tensor(htk),
                                          torch.as_tensor(hln))
        got = port._match_from_enc(
            port.fine_bank_enc[flat].reshape(8, TOP_K, 16, -1),
            port.fine_bank_centers[flat].reshape(8, TOP_K, 16, 2), hint_enc)
    for g, w in zip(got, (jmean, joff, jconf, jcs, jsp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_serve_bf16_close_to_jax(fx, jax_pipes, ports):
    """bf16 bodies: retrieval is f32 in both (identical top_idx); the GNN
    rounds at slightly different points, so a match near the 0.2 threshold
    or a near-tie can flip. At least 95% of served positions agree within
    0.01 of a cell, and all within 0.5."""
    q = _queries(fx, start=200)
    want = _jax_serve(jax_pipes, "bfloat16", q)
    got = _port_serve(ports["bfloat16"], q)
    np.testing.assert_array_equal(got[0], want[0])
    d = np.abs(got[2] - want[2]).max(-1)
    assert (d <= 0.01).mean() >= 0.95, (d <= 0.01).mean()
    assert d.max() <= 0.5


def test_serve_rerank_f32_matches_jax(fx, jax_pipes, ports):
    """rerank@128 (λ=4, γ=6): the stable re-rank over 128 candidates gives
    the same top_idx and positions."""
    rr = (128, 4.0, 6.0)
    q = _queries(fx, start=300)
    want = _jax_serve(jax_pipes, "float32", q, *rr)
    got = _port_serve(ports["float32"], q, *rr)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], atol=F16_STEP, rtol=0)


def test_fixture_queries_f32(fx, ports):
    """128 bench queries: top_idx identical to the fixture's JAX outputs
    and the same accuracies on them."""
    n = 128
    got = _port_serve(ports["float32"], _queries(fx, n))
    np.testing.assert_array_equal(got[0], fx["jax_top_idx"][:n])
    sub = {k: fx[k][:n] for k in ("pose_xy", "pose_scene")}
    sub.update({k: fx[k] for k in ("cell_bbox_xy", "cell_size",
                                   "cell_scene")})
    acc = served_accuracies(sub, got[0], got[2], (1, TOP_K))
    want = served_accuracies(sub, fx["jax_top_idx"][:n],
                             fx["jax_pos_offsets"][:n], (1, TOP_K))
    assert acc == want


def test_localize_tokenizes_like_jax(ports):
    port = ports["float32"]
    hints = [["The pose is north of a red car.",
              "The pose is east of a gray building."],
             ["The pose is on-top of a Green vegetation, yes."] * 8, []]
    tok, ln, htk, hln = port.tokenize_queries(hints)
    jv = JVocabulary(port.vocab.known_words)
    want_t, want_l = jv.encode_batch([" ".join(h) for h in hints], 64)
    np.testing.assert_array_equal(tok, want_t)
    np.testing.assert_array_equal(ln, want_l)
    wt, wl = jv.encode_batch(hints[1][:6], 16)
    np.testing.assert_array_equal(htk[1], wt)
    np.testing.assert_array_equal(hln[1], wl)
    assert (htk[2] == 0).all() and (hln[2] == 1).all()
    out = port.localize(hints, top_k=3)
    assert out["top_idx"].shape == (3, 3)
    assert out["pos_in_cell"].shape == (3, 3, 2)
    assert np.isfinite(out["pos_in_cell"]).all()
