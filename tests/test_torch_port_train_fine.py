"""The port's fine training against the JAX package's, at a tiny
configuration (embed 32, 2 block pairs, 10 Sinkhorn iterations, 32 points,
batch 4, a 2-scene synthetic corpus): the matching loss and metrics, one
training step (loss, every gradient leaf, BN running statistics), the eval
step, the loaders' batches, the Sinkhorn's autograd Function and the CLI.

As in ``test_torch_port_train_coarse.py``: JAX's reference is
``jax.value_and_grad`` over ``model.apply`` compiled with XLA's fusion pass
off (with fusion, the max-poolings' gradients drop entries), on points JAX
prepared and handed to the port. Tolerances: loss 1e-5 (relative); every
gradient leaf 2e-4 (relative L2; measured 5e-5, f32 sums in another order
through 4 GNN blocks and 10 Sinkhorn iterations); leaves whose exact
gradient is zero (a bias followed by BatchNorm) within 1e-5 of the global
gradient norm; BN running statistics 2e-6 of each leaf's scale.

The step in float64 (JAX with ``jax_enable_x64`` and its float32 pins
widened, compiled without fusion, on its own draws from the same key; the
port through ``utils/float64.py`` on its own augmentation of those draws)
holds the port's function to JAX's beyond f32's rounding: loss 1e-12
(relative; measured 4.1e-15), gradient leaves 1e-9 (relative L2; measured
1.7e-13), zero-gradient leaves within 1e-12 of the global norm (measured
1.4e-15), BN running statistics 1e-12 (measured 7.8e-15).
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
from text2pos_torch.data.loaders import FineLoader
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.ops.sinkhorn import LogOptimalTransport
from text2pos_torch.train import losses
from text2pos_torch.train.fine import FineTrainer
from text2pos_torch.train.state import TrainState, make_optimizer
from text2pos_torch.utils.convert_jax import (load_jax_params, module_to_jax,
                                              params_to_jax)
from text2pos_torch.utils.float64 import float64_pins

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(batch_size=4, embed_dim=32, num_layers=2, sinkhorn_iters=10,
            pointnet_numpoints=32, coarse_max_objects=16, pad_size=8,
            num_mentioned=6, max_text_len=48, max_hint_len=12)
LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
ZERO_GRAD_TOL = 1e-5
BN_TOL = 2e-6
F64_LOSS_TOL = 1e-12
F64_GRAD_TOL = 1e-9
F64_ZERO_GRAD_TOL = 1e-12
F64_BN_TOL = 1e-12
NO_FUSION = {"xla_disable_hlo_passes": "fusion"}


def corpus(make):
    cells, poses = [], []
    for s in (0, 1):
        c, p = make(seed=s, scene_name=f"999{s}", extent=60.0,
                    num_mentioned=6, poses_per_cell=3)
        cells += c
        poses += p
    return cells, poses


def leaf_errors(got, want):
    out = []

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(None if a is None else a.get(k), b[k], f"{path}/{k}")
            return
        b = np.asarray(b, np.float64)
        a = np.zeros_like(b) if a is None else np.asarray(a, np.float64)
        n = np.linalg.norm(b)
        out.append((np.linalg.norm(a - b) / max(n, 1e-30), path, n))
    walk(got, want, "")
    return out


def assert_grads_close(got, want, tol, zero_tol):
    errs = leaf_errors(got, want)
    total = np.sqrt(sum(n * n for _, _, n in errs))
    bad = [(e, p) for e, p, n in errs
           if (e > tol if n > 1e-4 * total else e * n > zero_tol * total)]
    assert not bad, sorted(bad, reverse=True)[:5]


def assert_stats_close(got, want, tol, path=""):
    if isinstance(want, dict):
        for k in want:
            assert_stats_close(got[k], want[k], tol, f"{path}/{k}")
        return
    err = np.abs(np.asarray(got) - want).max() / max(1.0, np.abs(want).max())
    assert err <= tol, (path, err)


@contextlib.contextmanager
def jax_float64():
    """JAX in float64: ``jax_enable_x64``, and the JAX package's float32
    pins (``jnp.float32`` in its BN statistics and casts) made float64."""
    f32 = jnp.float32
    with jax.enable_x64(True):
        jnp.float32 = jnp.float64
        try:
            yield
        finally:
            jnp.float32 = f32


def to_float64(tree):
    return jax.tree.map(lambda a: jnp.asarray(
        np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
        else a), tree)


def loader(cells, poses, vocab, cls):
    return cls(cells, poses, vocab, 4, 8, 6, 32, 12, seed=0)


@pytest.fixture(scope="module")
def case():
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    jl = loader(cells, poses, vocab, JFineLoader)
    trainer = JFineTrainer(JConfig(**TINY), vocab)
    rng = jax.random.PRNGKey(0)
    state = trainer.init_state(next(jl.epoch(seed=0)), rng, 5)
    batch = next(jl.epoch(seed=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in ("num_real", "pose_idx")}
    step_rng = jax.random.fold_in(rng, 7)
    pts, cols = jax.jit(lambda b, r: trainer._prep(b, r, augment=True))(
        jb, step_rng)

    def loss_fn(params):
        return trainer._loss_fn(params, state.batch_stats, jb, pts, cols)

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        state.params).compile(compiler_options=NO_FUSION)
    (loss, (stats, out, lm, lo)), grads = vg(state.params)
    eval_pts, eval_cols = jax.jit(
        lambda b, r: trainer._prep(b, r, augment=False))(jb, step_rng)
    metrics, eval_out = jax.jit(trainer.eval_step)(state, jb, step_rng)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(vocab=vocab, loader=jl, batch=batch, trainer=trainer,
                step_rng=step_rng,
                points=(np.asarray(pts), np.asarray(cols)),
                eval_points=(np.asarray(eval_pts), np.asarray(eval_cols)),
                loss=float(loss), grads=to_np(grads), stats=to_np(stats),
                params=to_np(state.params),
                batch_stats=to_np(state.batch_stats),
                metrics=to_np(metrics), eval_out=to_np(eval_out))


@pytest.fixture(scope="module")
def case64(case):
    """JAX's step of ``case`` in float64: loss, gradients, BN
    statistics, and the draws (sample indices, angles) of its own
    augmentation, uniforms drawn in float64 from the same key."""
    trainer, batch = case["trainer"], case["batch"]
    with jax_float64():
        jb = {k: to_float64(v) for k, v in batch.items()
              if k not in ("num_real", "pose_idx")}
        pts, cols = trainer._prep(jb, case["step_rng"], augment=True)
        assert pts.dtype == jnp.float64
        params = to_float64(case["params"])
        vg = jax.jit(jax.value_and_grad(
            lambda p: trainer._loss_fn(p, to_float64(case["batch_stats"]),
                                       jb, pts, cols),
            has_aux=True)).lower(params).compile(compiler_options=NO_FUSION)
        (loss, (stats, _, _, _)), grads = vg(params)
        k_sample, k_rot = jax.random.split(case["step_rng"])
        lead = jb["points_xyz"].shape[:-2]
        u = jax.random.uniform(k_sample, lead + (32,))
        idx = jnp.clip(jnp.floor(u * jb["point_count"][..., None]).astype(
            jnp.int32), 0, jb["points_xyz"].shape[-2] - 1)
        deg = jax.random.uniform(k_rot, lead, minval=-120.0, maxval=120.0)
        to_np = lambda t: jax.tree.map(np.asarray, t)
        return dict(loss=float(loss), grads=to_np(grads), stats=to_np(stats),
                    draws={"idx": np.asarray(idx), "angles": np.asarray(deg)})


def port(case):
    cfg = TrainConfig(**TINY, device="cpu")
    trainer = FineTrainer(cfg, Vocabulary(case["vocab"].known_words))
    assert load_jax_params(trainer.model, case["params"],
                           case["batch_stats"]) == []
    return trainer, TrainState(trainer.model,
                               make_optimizer(trainer.model, 1e-3))


def test_one_step_matches_jax(case):
    trainer, state = port(case)
    loss, *_ = trainer.forward_backward(state, case["batch"],
                                        draws={"points": case["points"]})
    assert abs(float(loss) - case["loss"]) <= LOSS_TOL * abs(case["loss"])
    got = params_to_jax(state.model, {n: p.grad for n, p in
                                      state.model.named_parameters()})
    assert_grads_close(got, case["grads"], GRAD_TOL, ZERO_GRAD_TOL)
    assert_stats_close(module_to_jax(state.model)[1], case["stats"], BN_TOL)
    for name in ("language_encoder.lstm_fwd_w_hh",
                 "language_encoder.word_embedding.weight",
                 "superglue.gnn.layer_0.attn.proj_q.weight",
                 "superglue.bin_score"):
        g = dict(state.model.named_parameters())[name].grad
        assert float(g.abs().sum()) > 0, name


def test_float64_step_matches_jax(case, case64):
    """The port's step in float64, on its own augmentation of JAX's draws,
    against JAX's float64 step: the same function, to float64's rounding
    (the GNN, the Sinkhorn's Function and the offsets head included)."""
    trainer, state = port(case)
    with float64_pins():
        state.model.double()
        loss, *_ = trainer.forward_backward(state, case["batch"],
                                            draws=case64["draws"])
        got = params_to_jax(state.model, {n: p.grad for n, p in
                                          state.model.named_parameters()})
        stats = module_to_jax(state.model)[1]
    assert abs(float(loss) - case64["loss"]) <= (F64_LOSS_TOL
                                                 * abs(case64["loss"]))
    assert_grads_close(got, case64["grads"], F64_GRAD_TOL, F64_ZERO_GRAD_TOL)
    assert_stats_close(stats, case64["stats"], F64_BN_TOL)


def test_eval_step_matches_jax(case):
    """Batch statistics, no running update; recall, precision and the pose
    errors as JAX's eval step (matches from the same transport, 1e-5)."""
    trainer, state = port(case)
    before = module_to_jax(state.model)[1]
    metrics, out = trainer.eval_step(state, case["batch"],
                                     draws={"points": case["eval_points"]})
    np.testing.assert_array_equal(out["matches0"].numpy(),
                                  case["eval_out"]["matches0"])
    for k, v in case["metrics"].items():
        assert abs(float(metrics[k]) - float(v)) <= 1e-5, k
    after = module_to_jax(state.model)[1]
    jax.tree.map(np.testing.assert_array_equal, after, before)


def test_matching_losses_and_metrics_match_jax():
    rng = np.random.default_rng(4)
    B, M, N = 3, 5, 4
    log_P = rng.standard_normal((B, M + 1, N + 1)).astype(np.float32)
    am = rng.integers(0, 4, (B, 7, 2)).astype(np.int32)
    counts = np.array([7, 3, 5], np.int32)
    want = jlosses.matching_loss(log_P, am, counts)
    got = losses.matching_loss(torch.from_numpy(log_P), torch.from_numpy(am),
                               torch.from_numpy(counts))
    assert abs(float(got) - float(want)) <= 1e-6
    gt = np.array([[0, -1, 2, 1], [3, 3, -1, -1], [-1, -1, -1, -1]],
                  np.int32)
    m0 = np.array([[0, 3, 2, -1, 1], [-1, -1, -1, 0, 1], [2, -1, -1, -1, 0]],
                  np.int32)
    m1 = np.array([[0, 4, 2, 1], [3, 4, -1, -1], [4, -1, 0, -1]], np.int32)
    mask = np.array([True, True, False])
    for sm in (None, mask):
        w = jlosses.calc_recall_precision(gt, m0, m1, sample_mask=sm)
        g = losses.calc_recall_precision(
            *map(torch.from_numpy, (gt, m0, m1)),
            sample_mask=None if sm is None else torch.from_numpy(sm))
        assert np.allclose([float(x) for x in g], [float(x) for x in w],
                           atol=1e-6)
    ctr = rng.uniform(0, 1, (B, M, 2)).astype(np.float32)
    pose = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    off = rng.standard_normal((B, 4, 2)).astype(np.float32)
    for kw in ({"use_mid_pred": True}, {}, {"offsets": off}):
        w = jlosses.calc_pose_error(ctr, m0, pose, sample_mask=mask, **kw)
        tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        g = losses.calc_pose_error(torch.from_numpy(ctr),
                                   torch.from_numpy(m0),
                                   torch.from_numpy(pose),
                                   sample_mask=torch.from_numpy(mask), **tkw)
        assert abs(float(g) - float(w)) <= 1e-6


def test_loader_batches_match_jax(case):
    """Same seed, same batches (padding objects, hint tokens, matches,
    offsets), shuffled training epochs and unshuffled padded eval epochs."""
    cells, poses = corpus(make_synthetic_dataset)
    port_loader = loader(cells, poses, Vocabulary(case["vocab"].known_words),
                         FineLoader)
    for kw in ({"seed": 3}, {"seed": 4, "shuffle": False,
                             "drop_last": False}):
        for got, want in zip(port_loader.epoch(**kw),
                             case["loader"].epoch(**kw)):
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sinkhorn_function_gradcheck():
    """``LogOptimalTransport`` in float64: the gradient reaches the scores
    and the dustbin score."""
    g = torch.Generator().manual_seed(0)
    scores = torch.randn(2, 4, 3, generator=g, dtype=torch.float64,
                         requires_grad=True)
    alpha = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda s, a: LogOptimalTransport.apply(s, a, 5), (scores, alpha))


def test_cli_one_epoch(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "text2pos_torch.train.fine", "--device",
         "cpu", "--dataset", "SYNTHETIC", "--epochs", "1", "--batch_size",
         "8", "--embed_dim", "32", "--num_layers", "1", "--sinkhorn_iters",
         "5", "--pointnet_numpoints", "32", "--pad_size", "8",
         "--max_hint_len", "12", "--max_batches", "2"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "best checkpoint:" in out.stdout
    assert list((tmp_path / "checkpoints").glob("fine_acc*.msgpack"))
