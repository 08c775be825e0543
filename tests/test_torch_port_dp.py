"""The port's data parallelism (``text2pos_torch/parallel/dp.py``,
``ops/retrieval.py`` ``sharded_topk_retrieval``) against the JAX package's
``parallel/dp.py`` on its 8-device virtual CPU mesh (``tests/conftest.py``),
the port on meshes of ``[cpu] * D``.

- Sharded retrieval: indices equal to JAX's and to the single-device
  top-k, for C a multiple of D and not, C < D·k, and exact ties across
  shards (the lower global index first, as ``lax.top_k``); scores within
  1e-6 of JAX's (f32 dot products summed in another order).
- Serving on the committed bench checkpoints and DB cache (f32, 16 bench
  queries a case): ``dp_serve_batch`` equal to the port's single-device
  ``serve_batch`` (``top_idx`` and match counts equal, positions within
  1e-5) and to JAX's ``dp_serve_batch`` (``top_idx`` and match counts
  equal, positions within one f16 step, the wire format's rounding, the
  single-device gate of ``test_torch_port_serve.py``), plain, rerank@32,
  the cascade 32 → 16 and its soft form; the ring mode equal to the
  replicated one (every output bit for bit), padded dummies never
  retrieved, with exact ties across shards, and to JAX's ring.
- ``dp_encode_all_cells`` within 2e-5 of JAX's (JAX's own gate,
  ``tests/test_dp_equivalence.py``) on JAX's draws, the evaluator's
  ``--data_parallel`` and the server's ``data_parallel`` / ``shard_db``.

The training steps are in ``test_torch_port_dp_train.py``.
"""

import os
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_eval import (EVAL, jax_point_draws,
                                  save_tiny_checkpoints)
from test_torch_port_train_coarse import corpus
from text2pos_tpu.config import EvalConfig as JEvalConfig
from text2pos_tpu.data.dense import flatten_bank_slice
from text2pos_tpu.data.hints import Vocabulary as JVocab
from text2pos_tpu.data.hints import build_vocabulary as jbuild_vocabulary
from text2pos_tpu.data.hints import create_hint_description as jhints
from text2pos_tpu.data.loaders import CoarseLoader as JCoarseLoader
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.evaluation import pipeline as jpipeline
from text2pos_tpu.ops import retrieval as jretrieval
from text2pos_tpu.parallel import dp as jdp
from text2pos_torch import serving
from text2pos_torch.config import EvalConfig, ServeConfig
from text2pos_torch.data.loaders import CoarseLoader
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.evaluation import pipeline as tpipeline
from text2pos_torch.evaluation.pipeline import LocalizationPipeline
from text2pos_torch.ops.retrieval import (sharded_topk_retrieval,
                                          topk_retrieval, two_key_topk)
from text2pos_torch.parallel import dp
from text2pos_torch.train.state import TrainState

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")
COARSE = os.path.join(CKPT, "bench_coarse.msgpack")
FINE = os.path.join(CKPT, "bench_fine.msgpack")
DB = os.path.join(CKPT, "bench_db_cache.npz")
FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                       "bench_queries.npz")
Q = 16
TOP_K = 10
F16_STEP = 2.0 ** -11   # one f16 step in [0.5, 1): served positions are f16
POS_TOL = 1e-5          # the port's DP against its single-device serving
SCORE_TOL = 1e-6
ENC_TOL = 2e-5          # JAX's dp_encode_all_cells gate
# serve_batch's options after top_k: (rerank_k, λ, γ, prune_m,
# prune_layers, prune_sinkhorn, prune_soft)
MODES = {"plain": (), "rerank": (32, 4.0, 6.0),
         "cascade": (32, 4.0, 6.0, 16, 1, 6),
         "soft": (32, 4.0, 6.0, 16, 1, 6, True)}
OPTS = ("rerank_k", "rerank_lambda", "rerank_gamma", "prune_m",
        "prune_layers", "prune_sinkhorn", "prune_soft")


def cpu_mesh(D):
    return dp.make_mesh(D, "cpu")


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------
def test_mesh_and_collectives():
    mesh = cpu_mesh(4)
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.size == 4
    assert dp.make_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError):
        dp.make_mesh(3, ["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dp.make_mesh(2)
    xs = [torch.full((2,), float(i)) for i in range(4)]
    gathered = dp.all_gather(xs, mesh)
    assert len(gathered) == 4
    assert gathered[3].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert [x.tolist() for x in dp.pmean(xs, mesh)] == [[1.5, 1.5]] * 4
    assert [x[0].item() for x in dp.ppermute(xs, mesh)] == [3, 0, 1, 2]


def test_stack_microbatches_matches_jax():
    """The same [D, ...] stack, ``num_real`` and ``pose_idx`` left out."""
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    loader = JCoarseLoader(cells, poses, vocab, 4, 16, 32, 48, seed=0)
    micro = list(loader.epoch(seed=1))[:3]
    got, want = dp.stack_microbatches(micro), jdp.stack_microbatches(micro)
    assert set(got) == set(want) and "num_real" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(np.array_equal(dp.unstack(got, 2)[k], micro[2][k])
               for k in got)


# ---------------------------------------------------------------------------
# Sharded retrieval
# ---------------------------------------------------------------------------
def _encodings(rng, q, c, e):
    t = rng.standard_normal((q, e)).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    db = rng.standard_normal((c, e)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    return t, db


@pytest.mark.parametrize("D", [2, 8])
@pytest.mark.parametrize("C", [64, 61, 9])  # divisible / padded / C < D·k
def test_sharded_topk_matches_jax(D, C):
    text, cells = _encodings(np.random.default_rng(C), q=16, c=C, e=32)
    k = min(5, C)
    want_s, want_i = jax.device_get(jretrieval.sharded_topk_retrieval(
        jnp.asarray(text), jnp.asarray(cells), k, jdp.make_mesh(D)))
    got_s, got_i = sharded_topk_retrieval(
        torch.from_numpy(text), torch.from_numpy(cells), k, cpu_mesh(D))
    single_s, single_i = topk_retrieval(torch.from_numpy(text),
                                        torch.from_numpy(cells), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_i.numpy(), single_i.numpy())
    np.testing.assert_array_equal(got_s.numpy(), single_s.numpy())
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=SCORE_TOL)
    assert got_i.max() < C


@pytest.mark.parametrize("D", [3, 8])
def test_sharded_topk_exact_ties(D):
    """Cells repeated across the database, so that equal scores lie in
    different shards: the lower global index first, as the single-device
    top-k and JAX's ``lax.top_k`` order them."""
    text, base = _encodings(np.random.default_rng(5), q=8, c=7, e=16)
    cells = np.tile(base, (5, 1))                  # cell c == cell c + 7j
    k = 12
    want = np.asarray(jretrieval.topk_retrieval(
        jnp.asarray(text), jnp.asarray(cells), k)[1])
    got_s, got_i = sharded_topk_retrieval(
        torch.from_numpy(text), torch.from_numpy(cells), k, cpu_mesh(D))
    np.testing.assert_array_equal(got_i.numpy(), want)
    np.testing.assert_array_equal(
        got_i.numpy(), topk_retrieval(torch.from_numpy(text),
                                      torch.from_numpy(cells), k)[1].numpy())
    assert (got_s[:, 0] == got_s[:, 1]).all()      # the ties are there


def test_two_key_topk_orders_ties():
    """Integer scores in a scrambled candidate order: score descending,
    then index ascending (numpy's lexsort)."""
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (6, 40)).astype(np.float32)
    index = np.stack([rng.permutation(100)[:40] for _ in range(6)])
    s, i = two_key_topk(torch.from_numpy(scores), torch.from_numpy(index), 9)
    order = np.stack([np.lexsort((index[r], -scores[r]))[:9]
                      for r in range(6)])
    np.testing.assert_array_equal(i.numpy(),
                                  np.take_along_axis(index, order, 1))
    np.testing.assert_array_equal(s.numpy(),
                                  np.take_along_axis(scores, order, 1))


# ---------------------------------------------------------------------------
# Serving on the bench weights
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fx():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def bench():
    """The port's calibrated f32 pipeline on the CPU, and JAX's with its
    database."""
    ecfg = JEvalConfig(top_k=(1, 5, TOP_K), threshs=(5, 10, 15),
                       pad_size=16, num_mentioned=6, pointnet_numpoints=256)
    with np.load(DB) as z:
        db = (jnp.asarray(z["cell_enc"]), jnp.asarray(z["fine_bank_enc"]),
              jnp.asarray(z["fine_bank_centers"]))
        stats = flax.serialization.msgpack_restore(z["batch_stats"].tobytes())
    jp, _, _ = jpipeline.build_pipeline_from_checkpoints(ecfg, COARSE, FINE,
                                                         dtype="float32")
    jp = jp.with_calibrated_stats(jax.tree.map(jnp.asarray, stats))
    port = LocalizationPipeline.from_checkpoints(COARSE, FINE, DB,
                                                 dtype="float32",
                                                 device="cpu")
    return port, jp, db


def _queries(fx, start, n=Q):
    return [fx[k][start:start + n] for k in ("tokens", "lengths",
                                             "hint_tokens", "hint_lengths")]


def _np(out):
    return [o.float().numpy() if o.is_floating_point() else o.numpy()
            for o in out]


def _assert_served_equal(got, want, pos_tol):
    """top_idx and match counts equal, positions within ``pos_tol``."""
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=0,
                                   atol=pos_tol)


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_serve_matches_single_and_jax(fx, bench, mode):
    port, jp, db = bench
    opts = dict(zip(OPTS, MODES[mode]))
    q = _queries(fx, 400 + 16 * list(MODES).index(mode))
    single = _np(port.serve_batch(*q, TOP_K, **opts))
    for D in (2, 8):
        got = _np(dp.dp_serve_batch(port, cpu_mesh(D), TOP_K, **opts)(*q))
        _assert_served_equal(got, single, POS_TOL)
    jserve = jdp.dp_serve_batch(jp, jdp.make_mesh(8), TOP_K, **opts)
    want = [np.asarray(o) for o in jserve(
        jp.coarse_state, jp.fine_state, *db, *map(jnp.asarray, q))]
    _assert_served_equal(got, want, F16_STEP)


def test_dp_cascade_at_full_depth_is_brute_rerank(fx, bench):
    """MULTICHIP_r05's check on the port: a cheap pass at the matcher's
    full depth and iterations scores as the full pass, so the DP cascade
    returns the DP brute re-rank's outputs."""
    port, _, _ = bench
    sg = port.fine.superglue
    q = _queries(fx, 700)
    mesh = cpu_mesh(4)
    brute = dp.dp_serve_batch(port, mesh, TOP_K, 32, 4.0, 6.0)(*q)
    casc = dp.dp_serve_batch(port, mesh, TOP_K, 32, 4.0, 6.0, 16,
                             sg.num_layers, sg.sinkhorn_iterations)(*q)
    for a, b in zip(brute, casc):
        assert torch.equal(a, b)


def _padded(port, D):
    """The port's pipeline with its database zero-padded to a multiple of
    D cells, as the server pads it."""
    C = port.cell_enc.shape[0]
    pad = (-C) % D
    z = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
    return port.with_database(z(port.cell_enc), z(port.fine_bank_enc),
                              z(port.fine_bank_centers)), C


@pytest.mark.parametrize("D", [3, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_ring_serving_equals_replicated(fx, bench, mode, D):
    """The map split over the mesh (2048 cells over 3 shards: one dummy
    row): every output bit for bit the replicated mode's; no dummy ever
    retrieved."""
    port, _, _ = bench
    opts = dict(zip(OPTS, MODES[mode]))
    q = _queries(fx, 800 + 48 * D + 12 * list(MODES).index(mode), n=12)
    mesh = cpu_mesh(D)
    want = dp.dp_serve_batch(port, mesh, TOP_K, **opts)(*q)
    padded, C = _padded(port, D)
    got = dp.dp_serve_batch_dbsharded(padded, mesh, TOP_K,
                                      num_real_cells=C, **opts)(*q)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[0].max()) < C


def test_ring_serving_exact_ties(fx, bench):
    """A map whose second half repeats its first (cell c == cell c + 1024,
    their fine rows too), so every score ties across shards: the ring's
    two-key order gives the single-device serving's lower indices."""
    port, _, _ = bench
    half = lambda a: torch.cat([a[:1024], a[:1024]])
    dup = port.with_database(half(port.cell_enc), half(port.fine_bank_enc),
                             half(port.fine_bank_centers))
    q = _queries(fx, 1100, n=8)
    for opts in ({}, {"rerank_k": 32, "rerank_lambda": 4.0}):
        want = dup.serve_batch(*q, TOP_K, **opts)
        got = dp.dp_serve_batch_dbsharded(dup, cpu_mesh(4), TOP_K,
                                          **opts)(*q)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        if not opts:       # each tied pair retrieved, the copy second
            for row in got[0].tolist():
                assert row[1::2] == [c + 1024 for c in row[0::2]]


def test_ring_serving_matches_jax_ring(fx, bench):
    """The ring mode against JAX's ``dp_serve_batch_dbsharded`` on a
    padded map (2048 cells over 3 shards), rerank@32: ``top_idx`` and
    match counts equal, positions within one f16 step."""
    port, jp, db = bench
    D = 3
    q = _queries(fx, 1200, n=12)
    padded, C = _padded(port, D)
    got = _np(dp.dp_serve_batch_dbsharded(
        padded, cpu_mesh(D), TOP_K, 32, num_real_cells=C,
        rerank_lambda=4.0, rerank_gamma=6.0)(*q))
    z = lambda a: jnp.concatenate([a, jnp.zeros((1,) + a.shape[1:],
                                                 a.dtype)])
    jserve = jdp.dp_serve_batch_dbsharded(
        jp, jdp.make_mesh(D), TOP_K, 32, num_real_cells=C,
        rerank_lambda=4.0, rerank_gamma=6.0)
    want = [np.asarray(o) for o in jserve(
        jp.coarse_state, jp.fine_state, *map(z, db), *map(jnp.asarray, q))]
    _assert_served_equal(got, want, F16_STEP)


def test_dp_serve_refuses_an_uncalibrated_pipeline():
    pipe = LocalizationPipeline.from_checkpoints(COARSE, FINE, None,
                                                 dtype="float32",
                                                 device="cpu")
    for make in (dp.dp_serve_batch, dp.dp_serve_batch_dbsharded):
        with pytest.raises(ValueError, match="calibrated"):
            make(pipe, cpu_mesh(2), TOP_K)


# ---------------------------------------------------------------------------
# The server, the DB-cell encode and the evaluator on a tiny model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny(synthetic_data, tmp_path_factory):
    """Tiny random-init checkpoints (``test_torch_port_eval.py``'s), the
    synthetic scene, JAX's coarse trainer and state from them."""
    cells, poses = synthetic_data
    pc, pf = save_tiny_checkpoints(cells, poses,
                                   tmp_path_factory.mktemp("dp"))
    jp, jvocab, _ = jpipeline.build_pipeline_from_checkpoints(
        JEvalConfig(**EVAL), pc, pf)
    return dict(cells=cells, poses=poses, paths=(pc, pf), jp=jp,
                jvocab=jvocab)


def test_server_data_parallel_equals_single(tiny):
    """``LocalizationServer(data_parallel=2)`` and with ``shard_db`` (16
    cells over 3 shards: two dummy rows) localize as the single-device
    server: equal cells, positions and counts; a batch of 5 is padded to
    the mesh and cut back."""
    pc, pf = tiny["paths"]
    scfg = ServeConfig(top_k=(1, 3), **{f: EVAL[f] for f in (
        "pad_size", "num_mentioned", "coarse_max_objects",
        "pointnet_numpoints", "max_hint_len", "max_text_len")})
    kw = dict(cfg=scfg, top_k=3, rerank_k=6, dtype=None, device="cpu")
    queries = [jhints(p) for p in tiny["poses"][:5]]
    single = serving.LocalizationServer(pc, pf, tiny["cells"], **kw)
    want = single.localize(queries)
    for dp_kw in ({"data_parallel": 2},
                  {"data_parallel": 3, "shard_db": True}):
        srv = serving.LocalizationServer(pc, pf, tiny["cells"], **kw,
                                         **dp_kw)
        got = srv.localize(queries)
        assert got["cell_ids"] == want["cell_ids"]
        for k in ("top_cells", "positions_k", "confidences"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_serving_cli_data_parallel(tiny, monkeypatch, capsys):
    """``python -m text2pos_torch.serving --data_parallel 2 --shard_db``
    answers every line as the single-device CLI does."""
    import io
    import json

    pc, pf = tiny["paths"]
    lines = "".join(json.dumps({"hints": jhints(p), "id": i}) + "\n"
                    for i, p in enumerate(tiny["poses"][:5]))
    args = ["--path_coarse", pc, "--path_fine", pf, "--synthetic_seed", "0",
            "--device", "cpu", "--dtype", "float32", "--top_k", "3",
            "--batch", "4", *[a for f in ("pad_size", "num_mentioned",
                                          "coarse_max_objects",
                                          "pointnet_numpoints",
                                          "max_hint_len", "max_text_len")
                              for a in (f"--{f}", str(EVAL[f]))]]
    outs = []
    for extra in ([], ["--data_parallel", "2", "--shard_db"]):
        monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
        serving.main(args + extra)
        outs.append([json.loads(x) for x in capsys.readouterr().out.split(
            "\n") if x])
    assert len(outs[0]) == 5 and outs[1] == outs[0]


def jax_dp_cell_draws(bank, B, D, flat_cap, num, seed):
    """JAX's draws of ``dp_encode_all_cells`` (groups of B·D cells, the
    last filled up with cell 0; shard d of group i on ``split(fold_in(key,
    i), D)[d]``), over each shard's flat buffer."""
    key, out = jax.random.PRNGKey(seed), []
    for i in range(0, bank.num_cells, B * D):
        idx = np.arange(i, min(i + B * D, bank.num_cells))
        idx = np.concatenate([idx, np.zeros(B * D - len(idx), np.int64)])
        keys = jax.random.split(jax.random.fold_in(key, i), D)
        group = []
        for d in range(D):
            fb = flatten_bank_slice(bank, idx[d * B:(d + 1) * B], flat_cap)
            group.append(jax_point_draws(
                keys[d], fb["points_xyz"].shape[:-2], num,
                fb["point_count"], fb["points_xyz"].shape[-2]))
        out.append(group)
    return out


@pytest.mark.parametrize("D", [2, 4])
def test_dp_encode_all_cells_matches_jax(tiny, D):
    """13 of the scene's 16 cells, so the last group is partial and filled
    up with cell 0: within 2e-5 of JAX's, on JAX's draws."""
    import dataclasses

    jp = tiny["jp"]
    loader = JCoarseLoader(tiny["cells"], tiny["poses"], tiny["jvocab"], 4,
                           16, 32, 64)
    n = 13
    bank = dataclasses.replace(loader.bank, **{
        f.name: getattr(loader.bank, f.name)[:n]
        for f in dataclasses.fields(loader.bank)})
    want = jdp.dp_encode_all_cells(jp.coarse, jp.coarse_state, bank,
                                   jdp.make_mesh(D), jax.random.PRNGKey(3))
    tp, _, _ = tpipeline.build_pipeline_from_checkpoints(
        EvalConfig(**EVAL, device="cpu"), *tiny["paths"])
    trainer = tp.coarse_trainer()
    got = dp.dp_encode_all_cells(
        trainer, TrainState(tp.coarse), bank, cpu_mesh(D),
        jax_dp_cell_draws(bank, 4, D, 64, 32, 3))
    assert got.shape == (n, 16)
    np.testing.assert_allclose(got, want, rtol=ENC_TOL, atol=ENC_TOL)


def test_evaluator_data_parallel_matches_jax(tiny, capsys, monkeypatch):
    """``python -m text2pos_torch.evaluation.pipeline --data_parallel 2``
    prints JAX's tables (its DB-cell encode over the mesh, JAX's draws
    handed over), and ``run_coarse`` on such a pipeline retrieves JAX's
    cells."""
    from test_torch_port_eval import jax_bank_draws
    from text2pos_tpu.utils.cli import load_split

    pc, pf = tiny["paths"]
    argv = ["--dataset", "SYNTHETIC", "--path_coarse", pc, "--path_fine", pf,
            "--batch_size", "4", "--pad_size", "8", "--pointnet_numpoints",
            "32", "--coarse_max_objects", "16", "--max_hint_len", "12",
            "--top_k", "1", "3", "5", "--data_parallel", "2"]
    monkeypatch.setattr(sys, "argv", ["pipeline"] + argv)
    jpipeline.main()
    want = capsys.readouterr().out
    cells, poses = load_split(JEvalConfig(**EVAL, dataset="SYNTHETIC"),
                              "val")
    bank = JCoarseLoader(cells, poses, JVocab([]), 4, 16, 32, 64).bank
    draws = {"cells": jax_dp_cell_draws(bank, 4, 2, 64, 32, 0),
             "bank": jax_bank_draws(bank.num_cells, 8, 32)}
    tpipeline.main(argv + ["--device", "cpu"], draws)
    got = capsys.readouterr().out
    assert "Coarse" in got and "Fine" in got
    assert got == want

    jmesh = jpipeline.LocalizationPipeline(
        tiny["jp"].coarse, tiny["jp"].coarse_state, tiny["jp"].fine,
        tiny["jp"].fine_state, tiny["jp"].cfg, mesh=jdp.make_mesh(4))
    jloader = JCoarseLoader(tiny["cells"], tiny["poses"], tiny["jvocab"], 4,
                            16, 32, 64)
    jtop, jaccs = jmesh.run_coarse(jloader, tiny["poses"])
    tp, vocab, _ = tpipeline.build_pipeline_from_checkpoints(
        EvalConfig(**EVAL, device="cpu", data_parallel=4), pc, pf)
    assert tp.mesh.size == 4
    tcells, tposes = make_synthetic_dataset(seed=0)
    tloader = CoarseLoader(tcells, tposes, vocab, 4, 16, 32, 64)
    top, accs = tp.run_coarse(tloader, tposes, jax_dp_cell_draws(
        tloader.bank, 4, 4, 64, 32, 0))
    np.testing.assert_array_equal(top, jtop)
    assert accs == jaccs
