"""The port's data-parallel training steps (``text2pos_torch/parallel/
dp.py``: ``dp_coarse_train_step`` with and without ``global_negatives``,
``dp_fine_train_step``, ``dp_train_epoch`` through the trainers' CLIs)
against the JAX package's on its 8-device virtual CPU mesh
(``tests/conftest.py``), the port on meshes of ``[cpu] * D``, at the
training step tests' tiny configurations.

One DP coarse step (with and without ``global_negatives``) and one DP fine
step against JAX's on JAX's per-shard points, leaf by leaf with JAX's
``_trees_close`` (|x − y|∞ ≤ 1e-4 + 6e-4·|x|∞,
``tests/test_dp_equivalence.py:37``): the gradients (one SGD(1) step's
parameter change in both packages), the BN statistics after the step, and
the loss within 1e-5 (relative). PointNet++'s leaves, where JAX's f32 step
takes the other side of a near-tie, are held to the port's float64 step on
the f32 step's own choices instead, and the float64 steps of both packages
to each other (loss 1e-12, leaves 1e-9, BN 1e-12: the step tests' float64
limits). JAX's steps are compiled without XLA's fusion pass, as every port
training test compiles its reference (with fusion its CPU program drops
part of the max-poolings' gradients); the points are JAX's, prepared by a
program compiled the same way. A port step without global negatives is
also the mean of its shards' single-device steps (within 1e-6). The
trainers' CLIs with ``--data_parallel 2`` on SYNTHETIC.
"""

import contextlib
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_train_coarse import (F64_BN_TOL, F64_GRAD_TOL,
                                          F64_LOSS_TOL, F64_ZERO_GRAD_TOL,
                                          assert_grads_close,
                                          assert_stats_close, corpus,
                                          jax_float64, to_float64)
from test_torch_port_train_coarse import TINY as COARSE_TINY
from test_torch_port_train_fine import TINY as FINE_TINY
from text2pos_tpu.config import TrainConfig as JTrainConfig
from text2pos_tpu.data.hints import Vocabulary as JVocab
from text2pos_tpu.data.hints import build_vocabulary as jbuild_vocabulary
from text2pos_tpu.data.hints import create_hint_description as jhints
from text2pos_tpu.data.loaders import CoarseLoader as JCoarseLoader
from text2pos_tpu.data.loaders import FineLoader as JFineLoader
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.ops.transforms import prepare_object_points as jprepare
from text2pos_tpu.parallel import dp as jdp
from text2pos_tpu.train.coarse import CoarseTrainer as JCoarseTrainer
from text2pos_tpu.train.fine import FineTrainer as JFineTrainer
from text2pos_tpu.train.state import TrainState as JTrainState
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.parallel import dp
from text2pos_torch.train.coarse import CoarseTrainer
from text2pos_torch.train.fine import FineTrainer
from text2pos_torch.train.state import TrainState
from text2pos_torch.utils.convert_jax import load_jax_params, module_to_jax
from text2pos_torch.utils.float64 import Decisions, float64_pins

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5         # relative
TREE_ATOL, TREE_RTOL = 1e-4, 6e-4
NEAR_TIE_TOL = 1e-5     # a choice the float64 replay would make otherwise
NO_FUSION = {"xla_disable_hlo_passes": "fusion"}


def cpu_mesh(D):
    return dp.make_mesh(D, "cpu")


def trees_close(a, b, atol=TREE_ATOL, rtol=TREE_RTOL):
    """JAX's ``_trees_close``: the leaves where |x − y|∞ > atol +
    rtol·|x|∞, x of ``a``."""
    bad = []

    def walk(x, y, path):
        if isinstance(y, dict):
            for k in y:
                walk(x[k], y[k], f"{path}/{k}")
            return
        x, y = np.asarray(x), np.asarray(y)
        if np.abs(x - y).max() > atol + rtol * np.abs(x).max():
            bad.append(path)
    walk(a, b, "")
    return bad


def _diff(a, b):
    return jax.tree.map(lambda x, y: np.asarray(x) - np.asarray(y), a, b)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_dp_step(make_step, trainer, state, micro, key, f64=False):
    """JAX's DP step on ``micro`` (compiled without fusion) from ``state``
    on SGD(1), in float64 with ``f64``: (its gradient as the parameters'
    change, its BN statistics, its loss, the shards' points as the port
    takes them: valid objects only where the batch has a flat buffer)."""
    with jax_float64() if f64 else contextlib.nullcontext():
        cast = to_float64 if f64 else (lambda t: t)
        state = JTrainState.create(cast(state.params),
                                   cast(state.batch_stats), optax.sgd(1.0))
        stacked = cast({k: jnp.asarray(v) for k, v in
                        jdp.stack_microbatches(micro).items()})
        step = make_step(trainer, jdp.make_mesh(len(micro)))
        new, loss = step.lower(state, stacked, key).compile(
            compiler_options=NO_FUSION)(state, stacked, key)
        keys = ("points_xyz", "points_rgb", "point_count")
        rngs = jax.random.split(key, len(micro))
        prep = jax.jit(lambda b, r: jprepare(
            b["points_xyz"], b["points_rgb"], b["point_count"],
            trainer.cfg.pointnet_numpoints, r, augment=True)).lower(
                {k: stacked[k][0] for k in keys}, rngs[0]).compile(
                    compiler_options=NO_FUSION)
        draws = []
        for d, batch in enumerate(micro):
            pts, cols = (np.array(a) for a in prep(
                {k: stacked[k][d] for k in keys}, rngs[d]))
            if "flat_valid" in batch:
                valid = batch["flat_valid"].astype(bool)
                pts, cols = pts[valid], cols[valid]
            draws.append({"points": (pts, cols)})
        return (_to_np(_diff(state.params, new.params)),
                _to_np(new.batch_stats), float(loss), draws)


def _port_dp_step(make_trainer, make_step, jstate, micro, draws, f64=False,
                  decisions=contextlib.nullcontext()):
    """The port's DP step from JAX's weights on SGD(1), in float64
    (``float64_pins``) with ``f64``, inside ``decisions``: (gradient as
    the parameters' change, BN statistics, loss)."""
    trainer = make_trainer()
    assert load_jax_params(trainer.model, _to_np(jstate.params),
                           _to_np(jstate.batch_stats)) == []
    with float64_pins() if f64 else contextlib.nullcontext(), decisions:
        if f64:
            trainer.model.double()
        before = module_to_jax(trainer.model)[0]
        state = TrainState(trainer.model, torch.optim.SGD(
            trainer.model.parameters(), lr=1.0))
        loss = make_step(trainer, cpu_mesh(len(micro)))(
            state, dp.stack_microbatches(micro), draws=draws)
        after, stats = module_to_jax(trainer.model)
    return _diff(before, after), stats, float(loss)


def _check_dp_step(make_trainer, make_port_step, make_jax_step, jt, jstate,
                   micro, key):
    """The port's f32 DP step against JAX's: the loss within 1e-5; every
    leaf outside PointNet++ and every BN statistic within JAX's
    ``_trees_close``; every leaf within it of the port's float64 step on
    the f32 step's own ReLU, max, FPS, ball and kNN choices
    (``Decisions``), each choice that step would have made otherwise a
    near-tie within 1e-5. The port's float64 step against JAX's float64
    step on JAX's float64 points within the step tests' float64 limits."""
    *want, draws = _jax_dp_step(make_jax_step, jt, jstate, micro, key)
    decisions = Decisions()
    got = _port_dp_step(make_trainer, make_port_step, jstate, micro, draws,
                        decisions=decisions.record())
    assert abs(got[2] - want[2]) <= LOSS_TOL * abs(want[2])
    assert all("/pointnet/" in p for p in trees_close(got[0], want[0]))
    assert not trees_close(got[1], want[1])
    draws64 = [{"points": tuple(a.astype(np.float64) for a in d["points"])}
               for d in draws]
    ref = _port_dp_step(make_trainer, make_port_step, jstate, micro,
                        draws64, True, decisions.replay())
    assert decisions.margin <= NEAR_TIE_TOL, decisions.margin
    assert abs(got[2] - ref[2]) <= LOSS_TOL * abs(ref[2])
    assert not trees_close(got[0], ref[0])
    assert not trees_close(got[1], ref[1])
    assert any(np.abs(v).max() > 0 for v in jax.tree.leaves(got[0]))

    micro64 = [{k: np.asarray(v, np.float64)
                if np.asarray(v).dtype.kind == "f" else v
                for k, v in b.items()} for b in micro]
    *want64, draws64 = _jax_dp_step(make_jax_step, jt, jstate, micro64, key,
                                    f64=True)
    got64 = _port_dp_step(make_trainer, make_port_step, jstate, micro64,
                          draws64, True)
    assert abs(got64[2] - want64[2]) <= F64_LOSS_TOL * abs(want64[2])
    assert_grads_close(got64[0], want64[0], F64_GRAD_TOL, F64_ZERO_GRAD_TOL)
    assert_stats_close(got64[1], want64[1], F64_BN_TOL)


@pytest.fixture(scope="module")
def coarse_case():
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    loader = JCoarseLoader(cells, poses, vocab, 4, 16, 32, 48,
                           shuffle_hints=True, flip_poses=True, seed=0)
    trainer = JCoarseTrainer(JTrainConfig(**COARSE_TINY), vocab)
    state = trainer.init_state(next(loader.epoch(seed=0)),
                               jax.random.PRNGKey(0), 5)
    batches = list(loader.epoch(seed=1)) + list(loader.epoch(seed=2))
    return trainer, state, vocab, batches


@pytest.mark.parametrize("D,global_negatives", [(2, False), (4, True)])
def test_dp_coarse_step_matches_jax(coarse_case, D, global_negatives):
    """With ``global_negatives`` every shard's ranking loss is over the
    gathered global batch, and the gradient JAX's step returns for it
    (the transpose of its ``all_gather``, then the ``pmean``) is the
    port's: the gradient of the global loss. On these batches one ReLU
    input of PointNet++ lies 7e-8 (relative) from its tie, and JAX's f32
    step takes the other side: its PointNet++ leaves move beyond
    ``_trees_close`` (see ``_check_dp_step``)."""
    jt, jstate, vocab, batches = coarse_case
    _check_dp_step(
        lambda: CoarseTrainer(TrainConfig(**COARSE_TINY, device="cpu"),
                              Vocabulary(vocab.known_words)),
        lambda tr, mesh: dp.dp_coarse_train_step(tr, mesh, global_negatives),
        lambda tr, mesh: jdp.dp_coarse_train_step(
            tr, mesh, global_negatives=global_negatives),
        jt, jstate, batches[:D], jax.random.PRNGKey(42))


@pytest.fixture(scope="module")
def fine_case():
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    loader = JFineLoader(cells, poses, vocab, 4, 8, 6, 32, 12, seed=0)
    trainer = JFineTrainer(JTrainConfig(**FINE_TINY), vocab)
    state = trainer.init_state(next(loader.epoch(seed=0)),
                               jax.random.PRNGKey(0), 5)
    return trainer, state, vocab, list(loader.epoch(seed=1))


def test_dp_fine_step_matches_jax(fine_case):
    """Two shards; PointNet++'s near-ties as in the coarse step (3e-7)."""
    jt, jstate, vocab, batches = fine_case
    _check_dp_step(
        lambda: FineTrainer(TrainConfig(**FINE_TINY, device="cpu"),
                            Vocabulary(vocab.known_words)),
        dp.dp_fine_train_step, jdp.dp_fine_train_step, jt, jstate,
        batches[:2], jax.random.PRNGKey(7))


def test_dp_step_is_the_mean_of_shard_steps(coarse_case):
    """Without global negatives a DP step is the mean of the shards'
    single-device steps from the same weights (JAX's equivalence test on
    the port): gradients and BN statistics within float32's reassociation
    (1e-6 of each leaf's scale), losses averaged; the shards' BN updates
    start from the master's statistics, not from each other's."""
    jt, jstate, vocab, batches = coarse_case
    micro = batches[:3]
    to_np = lambda t: jax.tree.map(np.asarray, t)
    gens = lambda: [torch.Generator().manual_seed(d) for d in range(3)]

    def port():
        tr = CoarseTrainer(TrainConfig(**COARSE_TINY, device="cpu"),
                           Vocabulary(vocab.known_words))
        load_jax_params(tr.model, to_np(jstate.params),
                        to_np(jstate.batch_stats))
        return tr

    tr = port()
    state = TrainState(tr.model,
                       torch.optim.SGD(tr.model.parameters(), lr=0.0))
    before = module_to_jax(tr.model)[1]
    loss = dp.dp_coarse_train_step(tr, cpu_mesh(3))(
        state, dp.stack_microbatches(micro), gens())
    grads = {n: p.grad for n, p in tr.model.named_parameters()}
    assert all(g is None for g in grads.values())     # stepped and cleared
    want_loss, want_grads, want_stats = [], [], []
    for d, g in enumerate(gens()):
        ref = port()
        st = TrainState(ref.model)
        want_loss.append(float(ref.forward_backward(st, micro[d], g)))
        want_grads.append({n: p.grad.clone() for n, p in
                           ref.model.named_parameters() if p.grad is not None})
        want_stats.append(module_to_jax(ref.model)[1])
    assert abs(float(loss) - np.mean(want_loss)) <= 1e-6 * abs(float(loss))
    mean_stats = jax.tree.map(lambda *x: sum(x) / 3, *want_stats)
    stats = module_to_jax(tr.model)[1]
    for got, want, b in zip(jax.tree.leaves(stats),
                            jax.tree.leaves(mean_stats),
                            jax.tree.leaves(before)):
        assert np.abs(got - want).max() <= 1e-6 * max(1, np.abs(want).max())
    assert any(np.abs(g - b).max() > 0 for g, b in zip(
        jax.tree.leaves(stats), jax.tree.leaves(before)))
    # the gradients: replay the step, reading them before the optimizer
    tr2 = port()
    reps = dp.TrainReplicas(tr2.model, cpu_mesh(3))
    sum(tr2.forward_loss(TrainState(m), micro[d], g)
        for d, (m, g) in enumerate(zip(reps.models, gens()))).backward()
    reps.reduce()
    for n, p in tr2.model.named_parameters():
        want = sum(w[n] for w in want_grads if n in w) / 3
        if p.grad is None:
            assert all(n not in w for w in want_grads), n
            continue
        err = (p.grad - want).abs().max() / max(1e-30, want.abs().max())
        assert err <= 1e-6, (n, float(err))


@pytest.mark.parametrize("stage", ["coarse", "fine"])
def test_cli_data_parallel(tmp_path, stage):
    """``python -m text2pos_torch.train.{coarse,fine} --device cpu
    --data_parallel 2`` (coarse with ``--global_negatives``): one epoch on
    SYNTHETIC, a finite loss and a checkpoint."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               T2P_METRICS_JSONL=str(tmp_path / "m.jsonl"))
    common = ["--device", "cpu", "--dataset", "SYNTHETIC", "--epochs", "1",
              "--batch_size", "4", "--pointnet_numpoints", "32",
              "--max_batches", "2", "--data_parallel", "2"]
    extra = (["--embed_dim", "32", "--coarse_max_objects", "16",
              "--global_negatives"] if stage == "coarse" else
             ["--embed_dim", "32", "--num_layers", "1", "--sinkhorn_iters",
              "5", "--pad_size", "8", "--max_hint_len", "12"])
    out = subprocess.run(
        [sys.executable, "-m", f"text2pos_torch.train.{stage}", *common,
         *extra], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = [json.loads(x) for x in open(tmp_path / "m.jsonl")]
    loss = rec[-1]["loss"] if stage == "coarse" else rec[-1]["train"]["loss"]
    assert np.isfinite(loss)
    kept = os.listdir(tmp_path / "checkpoints")
    assert len(kept) == 1 and kept[0].startswith(f"{stage}_acc")
