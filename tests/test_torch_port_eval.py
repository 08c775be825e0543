"""The port's evaluation entry points (``text2pos_torch/evaluation/
pipeline.py``: ``run_coarse`` with its oracles, ``run_fine`` cached and
uncached with the re-rank, ``run_fine_oracle``, ``print_accuracies`` and
the CLI ``main``) against the JAX package's on the same checkpoints and
data, with JAX's random draws handed to the port (the frameworks'
generators differ).

The tiny configuration is ``tests/test_end_to_end.py``'s (batch 4, embed
16, one block pair, 10 Sinkhorn iterations, 32 points, 8 objects a cell):
random-init weights from the JAX trainers saved as checkpoints that both
packages load, the synthetic scene of ``conftest.synthetic_data`` (16
cells, 25 poses). Numpy paths (oracles, accuracies, the re-rank's order)
and ``top_idx`` must be equal; per-candidate positions within 1e-5 (f32
sums in other orders). ``tests/test_torch_port_eval_fine.py`` runs the
committed bench checkpoints on a 64-cell slice of the bench map.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.config import EvalConfig as JEvalConfig
from text2pos_tpu.config import TrainConfig as JTrainConfig
from text2pos_tpu.data.hints import Vocabulary as JVocab
from text2pos_tpu.data.hints import build_vocabulary as jbuild_vocabulary
from text2pos_tpu.data.hints import create_hint_description as jhints
from text2pos_tpu.data.loaders import CoarseLoader as JCoarseLoader
from text2pos_tpu.data.loaders import FineLoader as JFineLoader
from text2pos_tpu.evaluation import pipeline as jpipeline
from text2pos_tpu.evaluation.metrics import print_accuracies as jprint
from text2pos_tpu.train.coarse import CoarseTrainer as JCoarseTrainer
from text2pos_tpu.train.fine import FineTrainer as JFineTrainer
from text2pos_tpu.train.state import save_checkpoint as jsave
from text2pos_torch.config import EvalConfig, parse_config
from text2pos_torch.data.loaders import CoarseLoader
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.evaluation import pipeline as tpipeline
from text2pos_torch.evaluation.metrics import print_accuracies

torch.set_num_threads(2)

TINY = dict(batch_size=4, embed_dim=16, num_layers=1, sinkhorn_iters=10,
            pointnet_numpoints=32, coarse_max_objects=16, pad_size=8,
            num_mentioned=6, max_text_len=64, max_hint_len=12)
EVAL = dict(top_k=(1, 3, 5), threshs=(5, 10, 15), batch_size=4, pad_size=8,
            num_mentioned=6, max_hint_len=12, max_text_len=64,
            pointnet_numpoints=32, coarse_max_objects=16)
POS_TOL = 1e-5
CHUNK = 8          # run_fine's default: 25 poses leave a last chunk of 1
JBANK_FIELDS = ("points_xyz", "points_rgb", "point_count", "centers",
                "colors", "class_idx", "color_idx", "mask")


def jax_point_draws(key, lead, num, count, stored):
    """JAX's sample indices of ``prepare_object_points(key, augment=False)``
    over objects of leading shape ``lead``."""
    k_sample, _ = jax.random.split(key)
    u = jax.random.uniform(k_sample, lead + (num,))
    return np.asarray(jnp.clip(jnp.floor(u * jnp.asarray(count)[..., None])
                               .astype(jnp.int32), 0, stored - 1))


def jax_cell_draws(bank, batch, flat_cap, num, seed=0):
    """The draws of JAX's ``CoarseTrainer.encode_all_cells`` (steps of
    ``batch`` cells, the last filled up with cell 0) over each step's valid
    objects, as the port's ``encode_all_cells`` takes them."""
    from text2pos_tpu.data.dense import flatten_bank_slice

    key, out = jax.random.PRNGKey(seed), []
    for i in range(0, bank.num_cells, batch):
        idx = np.arange(i, min(i + batch, bank.num_cells))
        idx = np.concatenate([idx, np.zeros(batch - len(idx), np.int64)])
        fb = flatten_bank_slice(bank, idx, flat_cap)
        ii = jax_point_draws(jax.random.fold_in(key, i),
                             fb["points_xyz"].shape[:-2], num,
                             fb["point_count"], fb["points_xyz"].shape[-2])
        out.append(ii[fb["flat_valid"].astype(bool)])
    return out


def jax_fine_draws(key, n, pad, num):
    """JAX's (u, pad_pts) of ``_pad_filled_cell_tensors`` and
    ``prepare_object_points`` for ``n`` cells under ``key``."""
    pad_pts = jax.random.uniform(key, (n, pad, 8, 3)) * 0.001
    k_sample, _ = jax.random.split(jax.random.fold_in(key, 1))
    u = jax.random.uniform(k_sample, (n, pad, num))
    return (torch.from_numpy(np.array(u, np.float32)),
            torch.from_numpy(np.array(pad_pts, np.float32)))


def jax_bank_draws(num_cells, pad, num, seed=0):
    """``precompute_fine_bank``'s draws: one key a 64-cell step."""
    root = jax.random.PRNGKey(seed)
    return [jax_fine_draws(jax.random.fold_in(root, i), tpipeline.DB_CHUNK,
                           pad, num)
            for i in range(0, num_cells, tpipeline.DB_CHUNK)]


def jax_chunk_draws(Q, K, chunk, pad, num, seed=0):
    """The uncached ``run_fine``'s draws: one key a chunk, over its
    ``chunk × K`` cells."""
    root = jax.random.PRNGKey(seed)
    return [jax_fine_draws(jax.random.fold_in(root, i), chunk * K, pad, num)
            for i in range(0, Q, chunk)]


def save_tiny_checkpoints(cells, poses, path):
    """Random-init JAX coarse and fine states at ``TINY``, saved as the
    trainers save them; returns (coarse path, fine path)."""
    cfg = JTrainConfig(**TINY)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    rng = jax.random.PRNGKey(0)
    loader = JCoarseLoader(cells, poses, vocab, 4, 16, 32, 64)
    cstate = JCoarseTrainer(cfg, vocab).init_state(
        next(loader.epoch(seed=0)), rng, 1)
    floader = JFineLoader(cells, poses, vocab, 4, 8, 6, 32, 12)
    fstate = JFineTrainer(cfg, vocab).init_state(
        next(floader.epoch(seed=0)), rng, 1)
    pc, pf = str(path / "coarse.msgpack"), str(path / "fine.msgpack")
    jsave(pc, cstate, extra={"known_words": vocab.known_words,
                             "embed_dim": 16, "variation": 0,
                             "use_features": list(cfg.use_features)})
    jsave(pf, fstate, extra={"known_words": vocab.known_words,
                             "embed_dim": 16, "num_layers": 1,
                             "sinkhorn_iters": 10,
                             "use_features": list(cfg.use_features)})
    return pc, pf


@pytest.fixture(scope="module")
def tiny(synthetic_data, tmp_path_factory):
    """Both pipelines from the same tiny checkpoints, both packages'
    loaders over the same scene, and JAX's coarse draws."""
    cells, poses = synthetic_data
    pc, pf = save_tiny_checkpoints(cells, poses,
                                   tmp_path_factory.mktemp("eval"))
    jcfg = JEvalConfig(**EVAL)
    jp, jvocab, jfvocab = jpipeline.build_pipeline_from_checkpoints(jcfg, pc,
                                                                    pf)
    jloader = JCoarseLoader(cells, poses, jvocab, 4, 16, 32, 64)
    tcells, tposes = make_synthetic_dataset(seed=0)
    cfg = EvalConfig(**EVAL, device="cpu")
    tp, vocab, fvocab = tpipeline.build_pipeline_from_checkpoints(cfg, pc,
                                                                  pf)
    tloader = CoarseLoader(tcells, tposes, vocab, 4, 16, 32, 64)
    assert np.array_equal(tloader.bank.points_xyz, jloader.bank.points_xyz)
    cell_draws = jax_cell_draws(jloader.bank, 4, 64, 32)
    return dict(jp=jp, jloader=jloader, poses=poses, jfvocab=jfvocab, tp=tp,
                tloader=tloader, tposes=tposes, fvocab=fvocab,
                cell_draws=cell_draws, paths=(pc, pf), cache={})


def with_cfg(t, **kw):
    """Both pipelines with the same configuration fields replaced."""
    jp, tp = t["jp"], t["tp"]
    return (jpipeline.LocalizationPipeline(
        jp.coarse, jp.coarse_state, jp.fine, jp.fine_state,
        dataclasses.replace(jp.cfg, **kw)),
        tpipeline.LocalizationPipeline(
            tp.coarse, tp.fine, tp.vocab, tp.fine_vocab,
            cfg=dataclasses.replace(tp.cfg, **kw)))


def coarse_runs(t, **kw):
    """(JAX's, the port's) ``run_coarse`` with ``kw`` set, run once."""
    key = ("coarse",) + tuple(sorted(kw.items()))
    if key not in t["cache"]:
        jp, tp = with_cfg(t, **kw)
        t["cache"][key] = (jp.run_coarse(t["jloader"], t["poses"]),
                           tp.run_coarse(t["tloader"], t["tposes"],
                                         t["cell_draws"]))
    return t["cache"][key]


@pytest.mark.parametrize("kw", [{}, {"rerank": 6}, {"coarse_oracle": True},
                                {"coarse_random": True}],
                         ids=["model", "rerank", "coarse_oracle",
                              "coarse_random"])
def test_run_coarse_matches_jax(tiny, kw):
    """``top_idx`` and the accuracies equal JAX's: the model's retrieval
    (with ``rerank`` it retrieves that many) on JAX's draws, and both
    oracles (numpy)."""
    (jtop, jaccs), (top, accs) = coarse_runs(tiny, **kw)
    assert top.shape == (25, kw.get("rerank", 5))
    np.testing.assert_array_equal(top, jtop)
    assert accs == jaccs


def street_centers(t):
    """Street centres of the scene: one street near the corner cell alone,
    so some poses share their street with fewer than ``max_k`` cells."""
    return np.array([[5.0, 5.0, 0.0], [60.0, 30.0, 0.0], [30.0, 90.0, 0.0],
                     [100.0, 100.0, 0.0]])


@pytest.mark.parametrize("form", ["array", "dict"])
def test_street_oracle_matches_jax(tiny, form):
    """``_street_oracle_retrieval`` with the centres as one array and as a
    {scene: array} dict: JAX's order, the −inf tail included, where a
    pose's street holds fewer than ``max_k`` cells."""
    t = tiny
    centers = street_centers(t)
    if form == "dict":
        centers = {"9999": centers}
    jp, tp = with_cfg(t, street_oracle=True)
    want = jp._street_oracle_retrieval(t["jloader"], t["poses"], 5, centers)
    got = tp._street_oracle_retrieval(t["tloader"], t["tposes"], 5, centers,
                                      t["cell_draws"])
    np.testing.assert_array_equal(got, want)
    # the case the test is about: a street of fewer than 5 cells
    from scipy.spatial.distance import cdist
    bank = t["tloader"].bank
    ctr = 0.5 * (bank.bbox_w[:, 0:3] + bank.bbox_w[:, 3:6])
    street = np.argmin(cdist(ctr, street_centers(t)), axis=1)
    pose_street = np.argmin(cdist(np.array([p.pose_w for p in t["tposes"]]),
                                  street_centers(t)), axis=1)
    sizes = np.bincount(street, minlength=4)
    assert (sizes[pose_street] < 5).any()


def fine_runs(t, use_cache, rerank, gamma):
    """(JAX's, the port's) ``run_fine`` on their own ``run_coarse``
    retrievals (equal, ``test_run_coarse_matches_jax``)."""
    (jtop, _), (top, _) = coarse_runs(t, **({"rerank": rerank} if rerank
                                            else {}))
    jp, tp = with_cfg(t, rerank=rerank, rerank_gamma=gamma)
    want = jp.run_fine(t["jloader"], t["poses"], jtop, t["jfvocab"],
                       chunk=CHUNK, use_cache=use_cache)
    got = tp.run_fine(
        t["tloader"], t["tposes"], top, t["fvocab"], chunk=CHUNK,
        use_cache=use_cache, bank_draws=jax_bank_draws(16, 8, 32),
        chunk_draws=jax_chunk_draws(25, top.shape[1], CHUNK, 8, 32))
    return want, got


@pytest.mark.parametrize("use_cache,rerank,gamma", [
    (True, 0, 0.0), (False, 0, 0.0), (True, 6, 0.0), (True, 6, 6.0),
    (False, 6, 6.0)],
    ids=["cached", "uncached", "rerank", "rerank_gamma6",
         "uncached_rerank_gamma6"])
def test_run_fine_matches_jax(tiny, use_cache, rerank, gamma):
    """``run_fine`` on batch statistics (the bank's 64-cell step filled up
    with cell 0, the matcher's chunks of 8 queries × K, the last chunk of
    25 padded with copies of its first row): the three accuracy dicts
    equal JAX's, re-ranked with γ = 0 and 6."""
    want, got = fine_runs(tiny, use_cache, rerank, gamma)
    for g, w in zip(got, want):
        assert g == w


@pytest.mark.parametrize("use_cache", [True, False], ids=["cached",
                                                         "uncached"])
def test_fine_chunk_positions_match_jax(tiny, use_cache):
    """The last, padded chunk's per-candidate positions (mean and offsets),
    match counts and confidence scores against JAX's within 1e-5."""
    t = tiny
    _, (top, _) = coarse_runs(t)
    K = top.shape[1]
    hints = [jhints(p) for p in t["poses"]]
    htk, hln = tpipeline.hint_arrays(t["fvocab"], hints, 6, 12)
    sl = slice(24, 25)
    idx, tok, lng = (np.concatenate([a[sl], a[sl][:1].repeat(CHUNK - 1, 0)])
                     for a in (top, htk, hln))
    jp, tp = t["jp"], t["tp"]
    bank_dev = {k: jnp.asarray(getattr(t["jloader"].bank, k))
                for k in JBANK_FIELDS}
    if use_cache:
        draws = jax_bank_draws(16, 8, 32)
        jbank = jp.precompute_fine_bank(t["jloader"].bank, bank_dev)
        want = jp._match_chunk_cached(jp.fine_state, jbank[0], jbank[1],
                                      jnp.asarray(idx), jnp.asarray(tok),
                                      jnp.asarray(lng))[1:]
        with torch.no_grad():
            bank = tp.precompute_fine_bank(t["tloader"].bank, draws)
            got = tp._match_chunk_cached(bank, torch.from_numpy(idx),
                                         torch.from_numpy(tok),
                                         torch.from_numpy(lng))
    else:
        key = jax.random.fold_in(jax.random.PRNGKey(0), 24)
        want = jp._fine_chunk(jp.fine_state, bank_dev, jnp.asarray(idx),
                              jnp.asarray(tok), jnp.asarray(lng), key)[1:]
        with torch.no_grad():
            got = tp._fine_chunk(
                tpipeline.bank_tensors(t["tloader"].bank, "cpu"),
                torch.from_numpy(idx), torch.from_numpy(tok),
                torch.from_numpy(lng),
                draws=jax_fine_draws(key, CHUNK * K, 8, 32))
    names = ("pos_mean", "pos_offsets", "confidences", "conf_scores",
             "spreads")
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=POS_TOL, err_msg=name)


@pytest.mark.parametrize("random_oracle", [False, True],
                         ids=["exact", "random"])
def test_fine_oracle_matches_jax(tiny, random_oracle):
    """``run_fine_oracle`` (numpy) on the same ``top_idx``: bit-equal."""
    t = tiny
    (jtop, _), _ = coarse_runs(t)
    want = t["jp"].run_fine_oracle(t["jloader"], t["poses"], jtop,
                                   random_oracle)
    got = t["tp"].run_fine_oracle(t["tloader"], t["tposes"], jtop,
                                  random_oracle)
    assert got == want


@pytest.mark.parametrize("name", ["", "Fine (mean, reranked@6)"])
def test_print_accuracies_matches_jax(name):
    accs = {1: {5: 0.125, 10: 0.5, 15: 1 / 3},
            5: {5: 0.995, 10: 0.0049, 15: 1.0}}
    assert print_accuracies(accs, name, log=lambda s: None) == jprint(
        accs, name, log=lambda s: None)


def test_eval_config_takes_jax_flags():
    """Every field of JAX's ``EvalConfig`` with its default; the flags
    the port does not run raise a ``ValueError`` naming their item, and
    ``--data_parallel`` is taken (``test_torch_port_dp.py`` runs it)."""
    from text2pos_torch.config import check_eval_ported

    ours = {f.name: f for f in dataclasses.fields(EvalConfig)}
    for f in dataclasses.fields(JEvalConfig):
        assert ours[f.name].default == f.default, f.name
    cfg = parse_config(EvalConfig, ["--top_k", "1", "3", "--threshs", "5",
                                    "--rerank", "128", "--rerank_gamma", "6",
                                    "--street_oracle", "--dtype", "bfloat16"])
    assert (cfg.top_k, cfg.threshs, cfg.rerank, cfg.rerank_gamma,
            cfg.street_oracle, cfg.dtype) == ((1, 3), (5,), 128, 6.0, True,
                                              "bfloat16")
    check_eval_ported(parse_config(EvalConfig, ["--data_parallel", "2"]))
    with pytest.raises(ValueError, match="item 7"):
        check_eval_ported(parse_config(EvalConfig, ["--plot_retrievals"]))
    with pytest.raises(ValueError, match="item 8"):
        tpipeline.main(["--dataset", "K360", "--device", "cpu"])


def test_main_needs_cuda_unless_told_cpu(tiny):
    """The CLI runs on the card by default: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pc, pf = tiny["paths"]
    with pytest.raises(RuntimeError, match="cuda"):
        tpipeline.main(["--dataset", "SYNTHETIC", "--path_coarse", pc,
                        "--path_fine", pf])


@pytest.mark.parametrize("extra", [[], ["--rerank", "6", "--rerank_gamma",
                                        "6"], ["--fine_random"]],
                         ids=["plain", "rerank", "fine_random"])
def test_main_prints_jax_tables(tiny, capsys, monkeypatch, extra):
    """``python -m text2pos_torch.evaluation.pipeline --device cpu`` prints
    the tables JAX's CLI prints on the validation scene, with JAX's draws
    handed over."""
    from text2pos_tpu.utils.cli import load_split

    pc, pf = tiny["paths"]
    argv = ["--dataset", "SYNTHETIC", "--path_coarse", pc, "--path_fine", pf,
            "--batch_size", "4", "--pad_size", "8", "--pointnet_numpoints",
            "32", "--coarse_max_objects", "16", "--max_hint_len", "12",
            "--top_k", "1", "3", "5"] + extra
    monkeypatch.setattr(sys, "argv", ["pipeline"] + argv)
    jpipeline.main()
    want = capsys.readouterr().out
    cells, poses = load_split(JEvalConfig(**EVAL, dataset="SYNTHETIC"),
                              "val")
    bank = JCoarseLoader(cells, poses, JVocab([]), 4, 16, 32, 64).bank
    draws = {"cells": jax_cell_draws(bank, 4, 64, 32),
             "bank": jax_bank_draws(bank.num_cells, 8, 32)}
    tpipeline.main(argv + ["--device", "cpu"], draws)
    got = capsys.readouterr().out
    assert "Coarse" in got and "Fine" in got
    assert got == want
