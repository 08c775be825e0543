"""``--remat`` in the port: the object encoder's PointNet++ recomputed in
the backward pass a level at a time (``blocks.checkpointed``) gives the
step without it, bit for bit with
PyTorch's deterministic algorithms: the loss, every gradient and the BN
running statistics, which move once a step (the recompute holds them, as
under flax's ``nn.remat``; a second write would move them twice). The
coarse host step, the fused coarse step with the bank and the rank-aware
fine step, on the tiny configuration of the step tests; and the coarse CLI.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_port_train_coarse import corpus
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import (Vocabulary, build_vocabulary,
                                       create_hint_description)
from text2pos_torch.data.loaders import CoarseLoader, FineLoader
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.models.blocks import MaskedBatchNorm
from text2pos_torch.train.coarse import CoarseTrainer, step_generator
from text2pos_torch.train.fine import FineTrainer
from text2pos_torch.train.fused_coarse import FusedCoarseTrainer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(batch_size=4, embed_dim=32, num_layers=2, sinkhorn_iters=10,
            pointnet_numpoints=32, coarse_max_objects=16, pad_size=8,
            num_mentioned=6, max_text_len=48, max_hint_len=12, device="cpu")


@pytest.fixture(scope="module")
def data():
    cells, poses = corpus(make_synthetic_dataset)
    vocab = Vocabulary(build_vocabulary([create_hint_description(p)
                                         for p in poses]))
    return cells, poses, vocab


def step(data, stage, remat):
    """One training step's forward and backward from the same weights and
    draws: (loss, {name: gradient}, {name: BN statistic after}, BN
    statistics before, calls of the first abstraction level)."""
    cells, poses, vocab = data
    gen = step_generator(torch.device("cpu"), 11)
    if stage == "fine":
        cfg = TrainConfig(**TINY, rank_weight=1.0, rank_negatives=2,
                          remat=remat)
        tr = FineTrainer(cfg, vocab)
        batch = next(FineLoader(cells, poses, vocab, 4, 8, 6, 32, 12,
                                seed=0).epoch(seed=1))
    elif stage == "coarse":
        tr = CoarseTrainer(TrainConfig(**TINY, remat=remat), vocab)
        batch = next(CoarseLoader(cells, poses, vocab, 4, 16, 32, 48,
                                  shuffle_hints=True, flip_poses=True,
                                  seed=0).epoch(seed=1))
    else:
        tr = FusedCoarseTrainer(TrainConfig(
            **TINY, remat=remat, neg_bank=True, neg_bank_hardest=2),
            vocab, cells, poses)
    state = tr.init_state(3)
    before = {n: b.clone() for n, b in state.model.named_buffers()}
    calls = []
    state.model.object_encoder.pointnet.sa1.register_forward_pre_hook(
        lambda *a: calls.append(1))
    if stage == "fused":
        tr.neg_weight = 1.0
        tr.refresh_neg_bank(state)
        calls.clear()
        before = {n: b.clone() for n, b in state.model.named_buffers()}
        loss = tr.fused_forward_loss(state, torch.arange(4), generator=gen)
        loss.backward()
    else:
        out = tr.forward_backward(state, batch, gen)
        loss = out if stage == "coarse" else out[0]
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if p.grad is not None}
    return (float(loss), grads, dict(state.model.named_buffers()), before,
            len(calls))


@pytest.mark.parametrize("stage", ["coarse", "fused", "fine"])
def test_remat_matches_no_remat(data, stage):
    torch.use_deterministic_algorithms(True)
    try:
        plain = step(data, stage, False)
        remat = step(data, stage, True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert remat[0] == plain[0]
    assert remat[1].keys() == plain[1].keys()
    for k in plain[1]:
        assert torch.equal(remat[1][k], plain[1][k]), k
    moved = [k for k in plain[2] if not torch.equal(plain[2][k],
                                                    plain[3][k])]
    assert moved
    for k in plain[2]:
        assert torch.equal(remat[2][k], plain[2][k]), k
    # The first abstraction level started twice under remat (forward and
    # the recompute, which stops once it has what the backward needs).
    assert (plain[4], remat[4]) == (1, 2)


def test_recompute_holds_running_statistics(data):
    """A BN that the recompute reaches is held, and released after."""
    held = []
    orig = MaskedBatchNorm.batch_stats

    def spy(self, *a, **k):
        held.append(self.hold_stats)
        return orig(self, *a, **k)

    MaskedBatchNorm.batch_stats = spy
    try:
        step(data, "coarse", True)
    finally:
        MaskedBatchNorm.batch_stats = orig
    assert True in held and False in held
    cells, poses, vocab = data
    tr = CoarseTrainer(TrainConfig(**TINY, remat=True), vocab)
    assert not any(m.hold_stats for m in tr.model.modules()
                   if isinstance(m, MaskedBatchNorm))


def test_remat_cli_one_epoch(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "text2pos_torch.train.coarse", "--device",
         "cpu", "--remat", "--dataset", "SYNTHETIC", "--epochs", "1",
         "--batch_size", "8", "--embed_dim", "32", "--pointnet_numpoints",
         "32", "--coarse_max_objects", "16", "--max_batches", "2",
         "--top_k", "1", "3"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert np.isfinite(float(out.stdout.split("loss ")[1].split()[0]))
