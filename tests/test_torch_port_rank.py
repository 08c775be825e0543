"""The rank-aware fine loss of the port against the JAX package's:
``soft_rank_score`` and ``listwise_rank_loss`` on random inputs,
``SuperGlueMatch.forward_rank`` (the transport of R rolled negatives, and
the GNN's BN statistics after its R + 1 momentum updates) on a tiny fine
batch, the rank-aware training step with its gradients, and the CLI with
``--rank_weight``.

Sizes as the fine step tests' (batch 4, embed 32, 2 block pairs, 10 Sinkhorn
iterations, 8 objects, 32 points; R = 2), on JAX's prepared points. The
batch is the loader's first, unshuffled: its first three poses share a
cell, so rolled negatives land on the query's own cell and are left out.
Tolerances: scores and the listwise loss within 1e-6 (relative); the
transports within 1e-5 (absolute, on probabilities); BN statistics within
1e-5 of each leaf's scale; the step's loss within 1e-5 (relative) of
JAX's, and its gradient leaves (relative L2; a leaf under 1e-4 of the
global norm within 1e-5 of it) and BN statistics held, as the step
tests', to the port's float64 step: the port's f32 step on its own ReLU and max choices
replayed (``Decisions``; each other choice a near-tie within 1e-5), JAX's
f32 step on the float64 step's own, both within 1e-3 and 1e-5.
"""

import contextlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_coarse import (F64_BN_TOL, F64_GRAD_TOL,
                                          F64_LOSS_TOL, F64_ZERO_GRAD_TOL,
                                          NO_FUSION, assert_grads_close,
                                          assert_stats_close, corpus,
                                          jax_float64, to_float64)
from text2pos_tpu.config import TrainConfig as JConfig
from text2pos_tpu.data.hints import Vocabulary as JVocab
from text2pos_tpu.data.hints import build_vocabulary as jbuild_vocabulary
from text2pos_tpu.data.hints import create_hint_description as jhints
from text2pos_tpu.data.loaders import FineLoader as JFineLoader
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.train import losses as jlosses
from text2pos_tpu.train.fine import FineTrainer as JFineTrainer
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.train import losses
from text2pos_torch.train.fine import FineTrainer
from text2pos_torch.train.state import TrainState, make_optimizer
from text2pos_torch.utils.convert_jax import (load_jax_params, module_to_jax,
                                              params_to_jax)
from text2pos_torch.utils.float64 import Decisions, float64_pins

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(batch_size=4, embed_dim=32, num_layers=2, sinkhorn_iters=10,
            pointnet_numpoints=32, coarse_max_objects=16, pad_size=8,
            num_mentioned=6, max_text_len=48, max_hint_len=12,
            rank_weight=1.0, rank_negatives=2)
SCORE_TOL = 1e-6
P_TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
BN_TOL = 1e-5
NEAR_TIE_TOL = 1e-5


def random_transport(rng, lead, M, N):
    p = rng.random(lead + (M + 1, N + 1)).astype(np.float32)
    return p / p.sum((-2, -1), keepdims=True) * min(M, N)


@pytest.mark.parametrize("gamma", [0.0, 2.0])
def test_soft_rank_score_matches_jax(gamma):
    rng = np.random.default_rng(0)
    P = random_transport(rng, (3, 5), 8, 6)
    ctr = rng.random((3, 5, 8, 2)).astype(np.float32)
    off = (0.1 * rng.standard_normal((1, 5, 6, 2))).astype(np.float32)
    want = np.asarray(jlosses.soft_rank_score(P, ctr, off, gamma))
    got = losses.soft_rank_score(*map(torch.from_numpy, (P, ctr, off)),
                                 gamma).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=0)


def test_listwise_rank_loss_matches_jax():
    """With −inf negatives (left out of the softmax) and a temperature."""
    rng = np.random.default_rng(1)
    pos = rng.standard_normal(6).astype(np.float32)
    neg = rng.standard_normal((3, 6)).astype(np.float32)
    neg[1, 2] = neg[0, 4] = neg[:, 5] = -np.inf
    for tau in (1.0, 0.5):
        want = float(jlosses.listwise_rank_loss(pos, neg, tau))
        got = float(losses.listwise_rank_loss(torch.from_numpy(pos),
                                              torch.from_numpy(neg), tau))
        assert abs(got - want) <= SCORE_TOL * abs(want)


def jax_rank(trainer, state, jb, key):
    """JAX's prepared points, ``forward_rank``'s outputs and BN statistics,
    and the rank-aware loss, gradients and statistics (compiled without
    fusion) on batch ``jb``."""
    pts, cols = jax.jit(lambda b, r: trainer._prep(b, r, augment=True))(
        jb, key)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    out, upd = jax.jit(lambda v: trainer.model.apply(
        v, jb["hint_tokens"], jb["hint_lengths"], pts, cols, jb["centers"],
        jb["colors"], jb["class_idx"], jb["color_idx"], 2, True,
        mutable=["batch_stats"], method=type(trainer.model).forward_rank))(
            variables)
    vg = jax.jit(jax.value_and_grad(lambda p: trainer._loss_fn(
        p, state.batch_stats, jb, pts, cols), has_aux=True)).lower(
            state.params).compile(compiler_options=NO_FUSION)
    (loss, (stats, _, _, _)), grads = vg(state.params)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(points=(np.asarray(pts), np.asarray(cols)),
                P=np.asarray(out["P"]), neg_P=np.asarray(out["neg_P"]),
                rank_stats=to_np(upd["batch_stats"]), loss=float(loss),
                grads=to_np(grads), stats=to_np(stats))


@pytest.fixture(scope="module")
def case():
    """JAX's tiny rank-aware fine trainer on a batch of poses (0, 0, 1, 2)
    (pose 0's sample twice, as a cell shared by two poses of a batch gives
    the same centres), in f32 and in float64 (its own draws from the same
    key)."""
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    loader = JFineLoader(cells, poses, vocab, 4, 8, 6, 32, 12, seed=0)
    trainer = JFineTrainer(JConfig(**TINY), vocab)
    state = trainer.init_state(next(loader.epoch(seed=0)),
                               jax.random.PRNGKey(0), 5)
    rng = np.random.default_rng(0)
    s0, s1, s2 = (loader.make_sample(i, rng) for i in range(3))
    batch = loader._collate([s0, s0, s1, s2], 4, np.array([0, 0, 1, 2]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in ("num_real", "pose_idx")}
    key = jax.random.PRNGKey(7)
    out = jax_rank(trainer, state, jb, key)
    with jax_float64():
        state64 = state.replace(params=to_float64(state.params),
                                batch_stats=to_float64(state.batch_stats))
        out["f64"] = jax_rank(trainer, state64, to_float64(jb), key)
    assert out["f64"]["points"][0].dtype == np.float64
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(out, vocab=vocab, batch=batch, params=to_np(state.params),
                batch_stats=to_np(state.batch_stats))


def port_trainer(case):
    tr = FineTrainer(TrainConfig(**TINY, device="cpu"),
                     Vocabulary(case["vocab"].known_words))
    assert load_jax_params(tr.model, case["params"],
                           case["batch_stats"]) == []
    return tr, TrainState(tr.model, make_optimizer(tr.model, 1e-3))


def test_batch_has_own_cell_negatives(case):
    ctr = case["batch"]["centers"][..., :2]
    same = [np.array_equal(np.roll(ctr, r, 0)[b], ctr[b])
            for r in (1, 2) for b in range(4)]
    assert any(same) and not all(same)


def forward_rank(case, f64=False):
    """The port's ``forward_rank`` (R = 2) on JAX's points: (outputs, BN
    statistics after it); in float64 with ``f64``."""
    tr, state = port_trainer(case)
    want = case["f64"] if f64 else case
    with float64_pins() if f64 else contextlib.nullcontext(), \
            torch.no_grad():
        if f64:
            state.model.double()
        tb = tr.tensors(case["batch"])
        pts, cols = (torch.from_numpy(a) for a in want["points"])
        out = state.model.forward_rank(tb["hint_tokens"], tb["hint_lengths"],
                                       pts, cols, tb["centers"],
                                       tb["colors"], 2)
        return out, module_to_jax(state.model)[1]


def test_forward_rank_matches_jax(case):
    """``neg_P`` and ``P``, and the GNN's BN statistics after the R + 1
    passes (the negatives first, the true pairs last): in f32 within 1e-4
    (measured 2.8e-5: the encoders' f32 rounding through two block pairs
    and ten Sinkhorn iterations) and 1e-5, in float64 within 1e-12."""
    out, stats = forward_rank(case)
    assert out["neg_P"].shape == (2,) + case["P"].shape
    np.testing.assert_allclose(out["P"].numpy(), case["P"], rtol=0,
                               atol=P_TOL)
    np.testing.assert_allclose(out["neg_P"].numpy(), case["neg_P"], rtol=0,
                               atol=P_TOL)
    assert_stats_close(stats, case["rank_stats"], BN_TOL)
    out, stats = forward_rank(case, f64=True)
    want = case["f64"]
    for k in ("P", "neg_P"):
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=0,
                                   atol=F64_BN_TOL)
    assert_stats_close(stats, want["rank_stats"], F64_BN_TOL)


def rank_step(case, f64=False, points=None):
    """The port's rank-aware step on JAX's points (``points``, else its f32
    ones): (loss, gradients, BN statistics); in float64 with ``f64``."""
    tr, state = port_trainer(case)
    points = points or case["points"]
    with float64_pins() if f64 else contextlib.nullcontext():
        if f64:
            state.model.double()
            points = tuple(np.asarray(a, np.float64) for a in points)
        loss = tr.forward_backward(state, case["batch"],
                                   draws={"points": points})[0]
        grads = params_to_jax(state.model, {
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in state.model.named_parameters()})
        return float(loss), grads, module_to_jax(state.model)[1]


def test_rank_step_matches_jax(case):
    """The f32 loss against JAX's; the f32 step against the float64 step
    on its own choices replayed; the float64 step against JAX's on JAX's
    float64 points (loss 1e-12, gradient leaves 1e-9, BN 1e-12). JAX's
    f32 step falls on the other side of a near-tie here (its PointNet++
    leaves are 3.8e-2 from the float64 step's own choices)."""
    decisions = Decisions()
    with decisions.record():
        loss, grads, stats = rank_step(case)
    assert abs(loss - case["loss"]) <= LOSS_TOL * abs(case["loss"])
    with decisions.replay():
        ref = rank_step(case, f64=True)
    assert decisions.margin <= NEAR_TIE_TOL, decisions.margin
    assert abs(loss - ref[0]) <= LOSS_TOL * abs(ref[0])
    assert_grads_close(grads, ref[1], GRAD_TOL)
    assert_stats_close(stats, ref[2], BN_TOL)
    want = case["f64"]
    loss64, grads64, stats64 = rank_step(case, True, want["points"])
    assert abs(loss64 - want["loss"]) <= F64_LOSS_TOL * abs(want["loss"])
    assert_grads_close(grads64, want["grads"], F64_GRAD_TOL,
                       F64_ZERO_GRAD_TOL)
    assert_stats_close(stats64, want["stats"], F64_BN_TOL)


def test_rank_term_reaches_gradients(case):
    """The rank term moves the loss and reaches the GNN's gradients."""
    tr, state = port_trainer(case)
    tr.rank_negatives = 0
    plain = tr.forward_backward(state, case["batch"],
                                draws={"points": case["points"]})[0]
    assert float(plain) < case["loss"]
    g = state.model.superglue.bin_score.grad.clone()
    tr2, state2 = port_trainer(case)
    tr2.forward_backward(state2, case["batch"],
                         draws={"points": case["points"]})
    assert not torch.equal(g, state2.model.superglue.bin_score.grad)


def test_rank_cli_one_epoch(tmp_path):
    """``python -m text2pos_torch.train.fine --rank_weight 1 --remat
    --device cpu``: one epoch on the synthetic dataset."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "text2pos_torch.train.fine", "--device",
         "cpu", "--dataset", "SYNTHETIC", "--epochs", "1", "--batch_size",
         "8", "--embed_dim", "32", "--num_layers", "1", "--sinkhorn_iters",
         "5", "--pad_size", "8", "--pointnet_numpoints", "32",
         "--max_hint_len", "12", "--max_batches", "2", "--rank_weight", "1",
         "--rank_negatives", "3", "--remat"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "best checkpoint:" in out.stdout
    assert list((tmp_path / "checkpoints").glob("fine_acc*.msgpack"))
