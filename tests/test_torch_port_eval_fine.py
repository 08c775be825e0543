"""The port's fine stage evaluated in isolation (``text2pos_torch/
evaluation/fine.py``: ``run_fine`` and its CLI), the retrieval-by-
confidence probe (``train/fine.py`` ``eval_conf``) and the image-retrieval
baseline (``evaluation/visloc.py``) against the JAX package's, on the same
tiny checkpoint and data with JAX's resampling draws handed over (the
configuration of ``tests/test_torch_port_eval.py``); and the evaluation
pipeline of that file on the committed bench checkpoints, full width and
depth, over a 64-cell slice of the bench map.

Tolerances: the recall, precision and pose-error means within 1e-5 (f32
sums in other orders); the per-threshold accuracies, ``eval_conf`` and the
numpy baseline equal.
"""

import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from text2pos_tpu.config import EvalConfig as JEvalConfig
from text2pos_tpu.config import TrainConfig as JTrainConfig
from text2pos_tpu.data.hints import create_hint_description as jhints
from text2pos_tpu.data.hints import Vocabulary as JVocab
from text2pos_tpu.data.loaders import FineLoader as JFineLoader
from text2pos_tpu.evaluation import fine as jfine
from text2pos_tpu.evaluation import pipeline as jpipeline
from text2pos_tpu.evaluation import visloc as jvisloc
from text2pos_tpu.train.fine import FineTrainer as JFineTrainer
from text2pos_tpu.train.fine import eval_conf as jeval_conf
from text2pos_tpu.train.state import TrainState as JTrainState
from text2pos_tpu.train.state import load_checkpoint as jload
from text2pos_torch.config import EvalConfig, TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.loaders import FineLoader
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.evaluation import fine as tfine
from text2pos_torch.evaluation import pipeline as tpipeline
from text2pos_torch.evaluation import visloc as tvisloc
from text2pos_torch.train.fine import FineTrainer, eval_conf
from text2pos_torch.train.state import (TrainState, load_variables,
                                        restore_variables)
from test_torch_port_eval import (TINY, jax_bank_draws, jax_cell_draws,
                                  jax_point_draws, save_tiny_checkpoints)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_TOL = 1e-5


def batch_draws(key, batches, num):
    """JAX's resampling draws (``idx``) of each batch under
    ``fold_in(key, i)``, i the batch's number or offset (``steps``)."""
    return [{"idx": jax_point_draws(jax.random.fold_in(key, i),
                                    b["points_xyz"].shape[:-2], num,
                                    b["point_count"],
                                    b["points_xyz"].shape[-2])}
            for i, b in batches]


@pytest.fixture(scope="module")
def tiny(synthetic_data, tmp_path_factory):
    """JAX's fine trainer and state from the tiny checkpoint, the port's
    trainer with it loaded, and both packages' loaders."""
    cells, poses = synthetic_data
    _, pf = save_tiny_checkpoints(cells, poses,
                                  tmp_path_factory.mktemp("fine"))
    payload = jload(pf)
    jvocab = JVocab(payload["extra"]["known_words"])
    jt = JFineTrainer(JTrainConfig(**TINY), jvocab)
    jstate = JTrainState.create_eval(payload["params"],
                                     payload["batch_stats"])
    jloader = JFineLoader(cells, poses, jvocab, 4, 8, 6, 32, 16)
    vocab = Vocabulary(payload["extra"]["known_words"])
    trainer = FineTrainer(TrainConfig(**TINY, device="cpu"), vocab)
    load_variables(trainer.model, restore_variables(pf))
    tcells, tposes = make_synthetic_dataset(seed=0)
    loader = FineLoader(tcells, tposes, vocab, 4, 8, 6, 32, 16)
    return dict(jt=jt, jstate=jstate, jloader=jloader, trainer=trainer,
                state=TrainState(trainer.model), loader=loader, path=pf)


def test_run_fine_matches_jax(tiny):
    """``evaluation.fine.run_fine`` over the 25 poses in batches of 4 (the
    last padded, its padding rows in the batch statistics): every mean
    within 1e-5 of JAX's, the per-threshold accuracies equal."""
    t = tiny
    want = jfine.run_fine(t["jt"], t["jstate"], t["jloader"],
                          log=lambda s: None)
    batches = enumerate(t["jloader"].epoch(seed=0, shuffle=False,
                                           drop_last=False))
    draws = batch_draws(jax.random.PRNGKey(0), batches, 32)
    got = tfine.run_fine(t["trainer"], t["state"], t["loader"],
                         log=lambda s: None, draws=draws)
    assert got["stats"].keys() == want["stats"].keys()
    for k, v in want["stats"].items():
        assert abs(got["stats"][k] - v) <= STAT_TOL, k
    assert got["thresh"] == want["thresh"]


def test_gt_matches0_matches_jax():
    gt = np.array([[0, -1, 3, 1, -1, 2], [-1, -1, -1, -1, -1, -1]])
    np.testing.assert_array_equal(tfine._gt_matches0(gt, 8),
                                  jfine._gt_matches0(gt, 8))


@pytest.mark.parametrize("num_cells", [2, 5])
def test_eval_conf_matches_jax(tiny, num_cells):
    """``eval_conf``: the same trials (numpy draws), batches padded with
    their last row, JAX's resampling draws handed over: the same score."""
    t = tiny
    want = jeval_conf(t["jt"], t["jstate"], t["jloader"], num_trials=7,
                      num_cells=num_cells, log=lambda s: None)
    # The batches JAX's eval_conf builds, for their draws: rebuilt from the
    # same numpy stream.
    rng = np.random.default_rng(0)
    samples = []
    for _ in range(7):
        own = t["jloader"].make_sample(int(rng.integers(25)), rng)
        samples.append(own)
        for _ in range(num_cells - 1):
            samples.append(t["jloader"].make_sample(int(rng.integers(25)),
                                                    rng))
    batches = []
    for i in range(0, len(samples), 4):
        chunk = samples[i:i + 4]
        chunk = chunk + [chunk[-1]] * (4 - len(chunk))
        batches.append((i, t["jloader"]._collate(chunk, 4,
                                                 np.zeros(4, np.int32))))
    draws = batch_draws(jax.random.PRNGKey(0), batches, 32)
    got = eval_conf(t["trainer"], t["state"], t["loader"], num_trials=7,
                    num_cells=num_cells, log=lambda s: None, draws=draws)
    assert got == want


def test_fine_main_prints_jax_table(tiny, capsys, monkeypatch):
    """``python -m text2pos_torch.evaluation.fine --device cpu`` on
    SYNTHETIC-FINE's validation split prints JAX's lines, with JAX's draws
    handed over."""
    from text2pos_tpu.utils.cli import load_split

    argv = ["--dataset", "SYNTHETIC-FINE", "--path_fine", tiny["path"],
            "--batch_size", "4", "--pad_size", "8", "--pointnet_numpoints",
            "32"]
    monkeypatch.setattr(sys, "argv", ["fine"] + argv)
    jfine.main()
    want = capsys.readouterr().out
    cells, poses = load_split(JEvalConfig(dataset="SYNTHETIC-FINE",
                                          pad_size=8), "val")
    loader = JFineLoader(cells, poses, tiny["jloader"].vocab, 4, 8, 6, 32, 16)
    draws = batch_draws(jax.random.PRNGKey(0), enumerate(loader.epoch(
        seed=0, shuffle=False, drop_last=False)), 32)
    tfine.main(argv + ["--device", "cpu"], draws)
    got = capsys.readouterr().out
    assert got.startswith("Fine-in-isolation:")
    assert got == want


def test_fine_main_needs_cuda_unless_told_cpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tfine.main(["--dataset", "SYNTHETIC-FINE", "--path_fine",
                    tiny["path"]])


def test_visloc_matches_jax(tmp_path):
    """``evaluate_features`` (numpy) and the CLI's table equal JAX's."""
    rng = np.random.default_rng(5)
    db = {"features": rng.standard_normal((40, 8)),
          "poses": rng.uniform(0, 50, (40, 3))}
    query = {"features": db["features"][:12] + 0.3 * rng.standard_normal(
        (12, 8)), "poses": db["poses"][:12] + rng.normal(0, 4, (12, 3))}
    want = jvisloc.evaluate_features(db["features"], db["poses"],
                                     query["features"], query["poses"])
    got = tvisloc.evaluate_features(db["features"], db["poses"],
                                    query["features"], query["poses"])
    assert got == want
    paths = []
    for name, d in (("db", db), ("query", query)):
        paths.append(str(tmp_path / f"{name}.pkl"))
        with open(paths[-1], "wb") as f:
            pickle.dump(d, f)
    args = ["--db_path", paths[0], "--query_path", paths[1], "--top_k", "1",
            "3", "--threshs", "10", "20"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    outs = [subprocess.run([sys.executable, "-m", f"{pkg}.evaluation.visloc"]
                           + args + extra, cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=120,
                           check=True).stdout
            for pkg, extra in (("text2pos_tpu", []),
                               ("text2pos_torch", ["--device", "cpu"]))]
    assert "VisLoc" in outs[0] and outs[1] == outs[0]


def test_visloc_main_needs_cuda_unless_told_cpu(tmp_path):
    """The visloc CLI asks for the card by default: without one it raises
    before reading its inputs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    missing = str(tmp_path / "absent.pkl")
    with pytest.raises(RuntimeError, match="cuda"):
        tvisloc.main(["--db_path", missing, "--query_path", missing])


def test_bench_weights_slice_matches_jax():
    """The committed bench checkpoints (full width and depth, f32) on the
    first 64 cells of the bench map and its first 16 queries, top-k (1, 5,
    10) and ``rerank`` 32 (γ = 6): ``top_idx`` and all four accuracy
    tables equal JAX's on JAX's draws."""
    from text2pos_tpu.data.dense import CellBank as JCellBank
    from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
    from text2pos_torch.data.dense import CellBank

    pc = os.path.join(ROOT, "checkpoints", "bench_coarse.msgpack")
    pf = os.path.join(ROOT, "checkpoints", "bench_fine.msgpack")
    kw = dict(top_k=(1, 5, 10), rerank=32, rerank_gamma=6.0)
    jp, jvocab, jfvocab = jpipeline.build_pipeline_from_checkpoints(
        JEvalConfig(**kw), pc, pf)
    tp, vocab, fvocab = tpipeline.build_pipeline_from_checkpoints(
        EvalConfig(**kw, device="cpu"), pc, pf)
    cells, poses = make_bench_dataset()
    full = bench_cell_bank(cells)
    sub = {f: getattr(full, f)[:64] for f in CellBank.__dataclass_fields__}
    poses = poses[:16]

    class Loader:
        """A ``CoarseLoader`` over the slice: the bank, the poses' cells
        and their joined texts."""
        def __init__(self, bank, vocab):
            self.bank = bank
            ids = {c: i for i, c in enumerate(bank.cell_ids)}
            self.pose_cell_idx = np.array([ids[p.cell_id] for p in poses],
                                          np.int32)
            self.vocab = vocab

        def all_query_tokens(self):
            return self.vocab.encode_batch(
                [" ".join(jhints(p)) for p in poses], 64)

    jloader = Loader(JCellBank(**{f: sub[f] for f in
                                  JCellBank.__dataclass_fields__}), jvocab)
    tloader = Loader(CellBank(**sub), vocab)
    jtop, jcoarse = jp.run_coarse(jloader, poses)
    top, coarse = tp.run_coarse(tloader, poses,
                                jax_cell_draws(jloader.bank, 32, 32 * 28,
                                               256))
    np.testing.assert_array_equal(top, jtop)
    assert coarse == jcoarse
    want = jp.run_fine(jloader, poses, jtop, jfvocab)
    got = tp.run_fine(tloader, poses, top, fvocab,
                      bank_draws=jax_bank_draws(64, 16, 256))
    for g, w in zip(got, want):
        assert g == w
