"""The port's coarse training against the JAX package's, at a tiny
configuration (embed 32, 32 points, batch 4, a 2-scene synthetic corpus):
ranking losses, one training step (loss, every gradient leaf, BN running
statistics) with JAX's point draws handed over, the bf16 step, the loaders'
batches, the LSTM's autograd Function, the CLI and the option
combinations that are refused.

JAX's reference gradient is ``jax.value_and_grad`` over ``model.apply``
compiled with XLA's fusion pass off, on points that JAX prepared (its draws,
rotation and NormalizeScale), handed to the port. Compiled with fusion (as
``CoarseTrainer.train_step`` is), XLA's CPU backend recomputes an
activation inside the backward's fusion with other fused multiply-adds than
the forward's, so the max's gradient (``eq(operand, max)``) drops entries:
on this batch the global abstraction's weight gradients are 43% off float64
and finite differences, against 5e-7 without fusion.

Tolerances: the loss within 1e-5 (relative). Gradient leaves within 1e-3
(relative L2; measured 2e-4): the coarse step is ill-conditioned at this
size, its gradient moves by 1e-4 when the points move by 1e-7 relative
(measured on this batch), so f32 sums in another order reach 1e-4. Leaves
whose exact gradient is zero (a bias followed by BatchNorm) are held
absolutely, within 1e-5 of the global gradient norm. BN running statistics
within 1e-5 of each leaf's scale (measured 4e-6: the variance of ``lin``'s
BN over the batch's 4 cells, f32 sums in another order). The port's own augmentation from JAX's
draws (sample indices and angles) is held against JAX's points within
1e-5 on their [-1, 1] range: XLA fuses the rotation into NormalizeScale's
sums in an order the port does not repeat, so 77% of the coordinates differ
in the last bits, enough to move a ball query's boundary on this batch (a
step on the port's own points then differs by up to 1e-2 in PointNet++'s
leaves).

The same step in float64 holds the port's function to JAX's beyond f32's
rounding: JAX with ``jax_enable_x64`` and its float32 pins (BN statistics,
casts) widened (``jax_float64``), compiled without fusion, on its own draws
from the same key; the port through ``utils/float64.py`` on its own
augmentation of those draws (sampling, rotation, NormalizeScale).
Tolerances: loss 1e-12 (relative; measured 3.5e-15), gradient leaves 1e-9
(relative L2; measured 2.4e-13), zero-gradient leaves within 1e-12 of the
global norm (measured 1.2e-15), BN running statistics 1e-12 (measured
6.8e-15).
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
from text2pos_tpu.data.loaders import CoarseLoader as JCoarseLoader
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.ops.transforms import prepare_object_points as jprepare
from text2pos_tpu.train import losses as jlosses
from text2pos_tpu.train.coarse import CoarseTrainer as JCoarseTrainer
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.loaders import CoarseLoader
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.ops.lstm import LSTMFinalHidden
from text2pos_torch.train import losses
from text2pos_torch.train.coarse import CoarseTrainer
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
GRAD_TOL = 1e-3
ZERO_GRAD_TOL = 1e-5
BN_TOL = 1e-5
F64_LOSS_TOL = 1e-12
F64_GRAD_TOL = 1e-9
F64_ZERO_GRAD_TOL = 1e-12
F64_BN_TOL = 1e-12
NO_FUSION = {"xla_disable_hlo_passes": "fusion"}


def corpus(make):
    """Two synthetic scenes of 2x2 cells, three poses a cell."""
    cells, poses = [], []
    for s in (0, 1):
        c, p = make(seed=s, scene_name=f"999{s}", extent=60.0,
                    num_mentioned=6, poses_per_cell=3)
        cells += c
        poses += p
    return cells, poses


def leaf_errors(got, want):
    """[(relative L2 error, path, |want|)] over the leaves of ``want``;
    a missing leaf of ``got`` counts as zeros."""
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


def assert_grads_close(got, want, tol, zero_tol=ZERO_GRAD_TOL):
    errs = leaf_errors(got, want)
    total = np.sqrt(sum(n * n for _, _, n in errs))
    bad = [(e, p) for e, p, n in errs
           if (e > tol if n > 1e-4 * total else e * n > zero_tol * total)]
    assert not bad, sorted(bad, reverse=True)[:5]
    return max(e for e, _, n in errs if n > 1e-4 * total)


def assert_stats_close(got, want, tol=BN_TOL):
    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        b = np.asarray(b)
        err = np.abs(np.asarray(a) - b).max() / max(1.0, np.abs(b).max())
        assert err <= tol, (path, err)
    walk(got, want, "")


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


def jax_draws(rng, shape_lead, num, count, stored):
    """JAX's (sample indices, angles) of ``prepare_object_points(rng,
    augment=True)`` over objects of leading shape ``shape_lead``."""
    k_sample, k_rot = jax.random.split(rng)
    u = jax.random.uniform(k_sample, shape_lead + (num,))
    idx = jnp.clip(jnp.floor(u * count[..., None]).astype(jnp.int32), 0,
                   stored - 1)
    deg = jax.random.uniform(k_rot, shape_lead, minval=-120.0, maxval=120.0)
    return np.asarray(idx), np.asarray(deg)


@pytest.fixture(scope="module")
def case():
    """JAX's tiny coarse trainer, state, a training batch with its draws,
    and JAX's loss, gradients and BN statistics after the step."""
    cells, poses = corpus(jsynthetic)
    jcfg = JConfig(**TINY)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    loader = JCoarseLoader(cells, poses, vocab, 4, 16, 32, 48,
                           shuffle_hints=True, flip_poses=True, seed=0)
    trainer = JCoarseTrainer(jcfg, vocab)
    rng = jax.random.PRNGKey(0)
    state = trainer.init_state(next(loader.epoch(seed=0)), rng, 5)
    batch = next(loader.epoch(seed=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in ("num_real", "pose_idx")}
    step_rng = jax.random.fold_in(rng, 0)
    pts, cols = jax.jit(lambda b, r: jprepare(
        b["points_xyz"], b["points_rgb"], b["point_count"], 32, r,
        augment=True))(jb, step_rng)

    def loss_fn(params, model=trainer.model):
        (text, cells_), upd = model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jb["tokens"], jb["lengths"], pts, cols, jb["centers"],
            jb["colors"], jb["class_idx"], jb["color_idx"], jb["flat_valid"],
            jb["cell_idx"], jb["slot_idx"], 4, 16, train=True,
            mutable=["batch_stats"])
        return jlosses.pairwise_ranking_loss(text, cells_, 0.35), \
            upd["batch_stats"]

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        state.params).compile(compiler_options=NO_FUSION)
    (loss, stats), grads = vg(state.params)
    idx, deg = jax_draws(step_rng, jb["points_xyz"].shape[:-2], 32,
                         jb["point_count"], jb["points_xyz"].shape[-2])
    valid = batch["flat_valid"].astype(bool)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(cells=cells, poses=poses, vocab=vocab, loader=loader,
                trainer=trainer, state=state, batch=batch,
                draws={"idx": idx[valid], "angles": deg[valid]},
                points=(np.asarray(pts)[valid], np.asarray(cols)[valid]),
                jax_points=(np.asarray(pts), np.asarray(cols)),
                loss=float(loss), grads=to_np(grads), stats=to_np(stats),
                params=to_np(state.params),
                batch_stats=to_np(state.batch_stats), rng=rng)


@pytest.fixture(scope="module")
def case64(case):
    """JAX's step of ``case`` in float64: its loss, gradients,
    BN statistics, and the draws of its own augmentation (uniforms drawn in
    float64 from the same key) over the valid objects."""
    batch, trainer = case["batch"], case["trainer"]
    with jax_float64():
        jb = {k: to_float64(v) for k, v in batch.items()
              if k not in ("num_real", "pose_idx")}
        step_rng = jax.random.fold_in(case["rng"], 0)
        pts, cols = jprepare(jb["points_xyz"], jb["points_rgb"],
                             jb["point_count"], 32, step_rng, augment=True)

        def loss_fn(params):
            (text, cells_), upd = trainer.model.apply(
                {"params": params,
                 "batch_stats": to_float64(case["batch_stats"])},
                jb["tokens"], jb["lengths"], pts, cols, jb["centers"],
                jb["colors"], jb["class_idx"], jb["color_idx"],
                jb["flat_valid"], jb["cell_idx"], jb["slot_idx"], 4, 16,
                train=True, mutable=["batch_stats"])
            return jlosses.pairwise_ranking_loss(text, cells_, 0.35), \
                upd["batch_stats"]

        params = to_float64(case["params"])
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
            params).compile(compiler_options=NO_FUSION)
        (loss, stats), grads = vg(params)
        idx, deg = jax_draws(step_rng, jb["points_xyz"].shape[:-2], 32,
                             jb["point_count"], jb["points_xyz"].shape[-2])
        valid = batch["flat_valid"].astype(bool)
        to_np = lambda t: jax.tree.map(np.asarray, t)
        assert np.asarray(pts).dtype == np.float64
        return dict(loss=float(loss), grads=to_np(grads), stats=to_np(stats),
                    draws={"idx": idx[valid], "angles": deg[valid]})


def port_model(case, dtype="float32"):
    cfg = TrainConfig(**TINY, device="cpu", dtype=dtype)
    trainer = CoarseTrainer(cfg, Vocabulary(case["vocab"].known_words))
    assert load_jax_params(trainer.model, case["params"],
                           case["batch_stats"]) == []
    return trainer, TrainState(trainer.model,
                               make_optimizer(trainer.model, 1e-3))


def grads_of(model):
    return params_to_jax(model, {n: p.grad for n, p in
                                 model.named_parameters()})


def test_augmentation_matches_jax(case):
    trainer, _ = port_model(case)
    pts, cols = trainer.points(trainer.objects(case["batch"]), True,
                               draws=case["draws"])
    np.testing.assert_array_equal(cols.numpy(), case["points"][1])
    np.testing.assert_allclose(pts.numpy(), case["points"][0], rtol=0,
                               atol=1e-5)


def test_one_step_matches_jax(case):
    trainer, state = port_model(case)
    loss = float(trainer.forward_backward(
        state, case["batch"], draws={"points": case["points"]}))
    assert abs(loss - case["loss"]) <= LOSS_TOL * abs(case["loss"])
    worst = assert_grads_close(grads_of(state.model), case["grads"],
                               GRAD_TOL)
    assert worst > 0
    assert_stats_close(module_to_jax(state.model)[1], case["stats"])


def test_float64_step_matches_jax(case, case64):
    """The port's step in float64, on its own augmentation of JAX's draws,
    against JAX's float64 step: the same function, to float64's rounding."""
    trainer, state = port_model(case)
    with float64_pins():
        state.model.double()
        loss = float(trainer.forward_backward(state, case["batch"],
                                              draws=case64["draws"]))
        grads, stats = grads_of(state.model), module_to_jax(state.model)[1]
    assert abs(loss - case64["loss"]) <= F64_LOSS_TOL * abs(case64["loss"])
    worst = assert_grads_close(grads, case64["grads"], F64_GRAD_TOL,
                               F64_ZERO_GRAD_TOL)
    assert worst > 0
    assert_stats_close(stats, case64["stats"], F64_BN_TOL)


def test_gradients_reach_every_tower(case):
    """The LSTM's Function passes gradients to the embedding, W_ih, b and
    W_hh; PointNet++ and EdgeConv train too (not detached by a kernel)."""
    trainer, state = port_model(case)
    trainer.forward_backward(state, case["batch"], draws=case["draws"])
    for name in ("language_encoder.word_embedding.weight",
                 "language_encoder.lstm_fwd_w_ih",
                 "language_encoder.lstm_bwd_w_hh",
                 "language_encoder.lstm_bwd_b",
                 "object_encoder.pointnet.sa1.conv_mlp.dense_1.weight",
                 "graph1.edge_mlp.dense_0.weight"):
        g = dict(state.model.named_parameters())[name].grad
        assert g is not None and float(g.abs().sum()) > 0, name


def test_bf16_step_close_to_jax(case):
    """``--dtype bfloat16``: the object tower's bodies in bf16. The loss
    within 3e-2 (relative; measured 1.35e-2) of JAX's bf16 loss on the same
    points. The modules round where XLA stores bf16 values, and XLA's
    compiled train step stores in bf16 exactly what its eval forward stores
    (``scripts/check_bf16_train_stores.py``); the distance starts in the
    set abstractions' train-mode BNs, where XLA's f32 statistics sums move
    values near a bf16 rounding boundary to the other side (ROADMAP Queue
    3). The gradients are finite and reach every tower; they are
    not held against JAX's leaf by leaf: at this size bf16 moves the loss
    7% from f32's, which turns the ranking hinges on and off, and JAX's own
    bf16 gradients, compiled with or without fusion, differ from each other
    by more than that."""
    jt = JCoarseTrainer(JConfig(**TINY, dtype="bfloat16"), case["vocab"])
    jb = {k: jnp.asarray(v) for k, v in case["batch"].items()
          if k not in ("num_real", "pose_idx")}
    pts, cols = (jnp.asarray(a) for a in case["jax_points"])
    (text, cells_), _ = jax.jit(lambda p: jt.model.apply(
        {"params": p, "batch_stats": case["batch_stats"]},
        jb["tokens"], jb["lengths"], pts, cols, jb["centers"], jb["colors"],
        jb["class_idx"], jb["color_idx"], jb["flat_valid"], jb["cell_idx"],
        jb["slot_idx"], 4, 16, train=True, mutable=["batch_stats"]))(
            case["params"])
    jloss = float(jlosses.pairwise_ranking_loss(text, cells_, 0.35))
    trainer, state = port_model(case, "bfloat16")
    loss = float(trainer.forward_backward(
        state, case["batch"], draws={"points": case["points"]}))
    assert abs(loss - jloss) <= 3e-2 * abs(jloss)
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    for name in ("language_encoder.lstm_fwd_w_hh", "lin.dense_0.weight",
                 "object_encoder.pointnet.sa1.conv_mlp.dense_1.weight"):
        assert bool(torch.isfinite(grads[name]).all())
        assert float(grads[name].abs().sum()) > 0, name


@pytest.mark.parametrize("name", ["pairwise", "hardest", "triplet"])
def test_ranking_losses_match_jax(name):
    rng = np.random.default_rng(3)
    a, p, n = (rng.standard_normal((6, 8)).astype(np.float32)
               for _ in range(3))
    if name == "triplet":
        want = jlosses.triplet_margin_loss(a, p, n, 0.35)
        got = losses.triplet_margin_loss(*map(torch.from_numpy, (a, p, n)),
                                         0.35)
    else:
        fn = f"{name}_ranking_loss"
        want = getattr(jlosses, fn)(a, p, 0.35)
        got = getattr(losses, fn)(torch.from_numpy(a), torch.from_numpy(p),
                                  0.35)
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


def test_loader_batches_match_jax(case):
    """Same seed, same batches: tokens (hint shuffles and east/west,
    north/south flips included), points, pose indices."""
    cells, poses = corpus(make_synthetic_dataset)
    vocab = Vocabulary(case["vocab"].known_words)
    port = CoarseLoader(cells, poses, vocab, 4, 16, 32, 48,
                        shuffle_hints=True, flip_poses=True, seed=0)
    for epoch in (1, 2):
        for got, want in zip(port.epoch(seed=epoch),
                             case["loader"].epoch(seed=epoch)):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(port.all_query_tokens()[0],
                                  case["loader"].all_query_tokens()[0])


def test_loader_close_cell_batches_match_jax(case):
    """With ``sample_close_cell`` too (a close-by cell drawn between the
    hint shuffle and the flips), and a padded tail batch: the same
    batches as JAX's loader, through the one path that draws, then
    builds with ``batch_with``."""
    vocab = Vocabulary(case["vocab"].known_words)
    kw = dict(shuffle_hints=True, flip_poses=True, sample_close_cell=True,
              seed=0)
    port = CoarseLoader(*corpus(make_synthetic_dataset), vocab, 5, 16, 32,
                        48, **kw)
    jax_loader = JCoarseLoader(*corpus(jsynthetic), case["vocab"], 5, 16,
                               32, 48, **kw)
    n = 0
    for got, want in zip(port.epoch(seed=3, drop_last=False),
                         jax_loader.epoch(seed=3, drop_last=False)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        n += 1
    assert n == port.num_batches(drop_last=False) > 1


def test_lstm_function_gradcheck():
    """``LSTMFinalHidden`` in float64 (its CPU forward is the plain
    version, its backward the plain version's recomputed gradient)."""
    g = torch.Generator().manual_seed(0)
    V, H, B, T = 7, 4, 3, 5
    tables = [torch.randn(V, 4 * H, generator=g, dtype=torch.float64,
                          requires_grad=True) for _ in range(2)]
    w_hh = [(0.3 * torch.randn(H, 4 * H, generator=g, dtype=torch.float64)
             ).requires_grad_() for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), generator=g)
    lengths = torch.tensor([5, 2, 1])
    assert torch.autograd.gradcheck(
        lambda *a: LSTMFinalHidden.apply(tokens, lengths, *a),
        (*tables, *w_hh))


@pytest.mark.parametrize("stage,flag", [
    ("coarse", ["--fused"]), ("fine", ["--fused"]),
    ("fine", ["--rank_weight", "1"])])
def test_data_parallel_exclusions_raise(stage, flag):
    """``--data_parallel`` with ``--fused`` raises, as JAX asserts
    (``train/coarse.py:289``, ``train/fine.py:264``); with the fine
    stage's ``--rank_weight``, which JAX's data-parallel step would leave
    out, too."""
    from text2pos_torch.config import parse_config
    from text2pos_torch.train.fine import FineTrainer

    cfg = parse_config(TrainConfig, ["--device", "cpu", "--embed_dim", "32",
                                     "--data_parallel", "2", *flag])
    with pytest.raises(ValueError, match="--data_parallel exclude"):
        (CoarseTrainer if stage == "coarse" else FineTrainer)(
            cfg, Vocabulary(["a"]))


def test_k360_and_kernel_width_raise(tmp_path):
    """``--dataset K360`` (the default) reads the split's scenes from
    ``--base_path``: with none there the reader raises for the first train
    scene (``test_torch_port_dataprep.py`` loads prepared ones); the LSTM
    kernel's width range."""
    from text2pos_torch.constants import SCENE_NAMES_TRAIN
    from text2pos_torch.utils.cli import load_split

    with pytest.raises(FileNotFoundError, match=SCENE_NAMES_TRAIN[0]):
        load_split(TrainConfig(dataset="K360", base_path=str(tmp_path),
                               device="cpu"), "train")
    from text2pos_torch.ops.lstm import check_kernel_width

    check_kernel_width(256)
    check_kernel_width(300)
    with pytest.raises(ValueError, match=r"\[1, 512\]"):
        check_kernel_width(513)


def test_cli_one_epoch(tmp_path):
    """``python -m text2pos_torch.train.coarse --device cpu`` end to end:
    one epoch on the synthetic dataset, evaluation, the best checkpoint,
    the metrics log and the resume file."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               T2P_METRICS_JSONL=str(tmp_path / "m.jsonl"))
    out = subprocess.run(
        [sys.executable, "-m", "text2pos_torch.train.coarse", "--device",
         "cpu", "--dataset", "SYNTHETIC", "--epochs", "1", "--batch_size",
         "8", "--embed_dim", "32", "--pointnet_numpoints", "32",
         "--coarse_max_objects", "16", "--max_batches", "2", "--top_k", "1",
         "3", "--resume_path", str(tmp_path / "r.msgpack")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "best checkpoint:" in out.stdout
    assert (tmp_path / "m.jsonl").is_file()
    assert (tmp_path / "r.msgpack").is_file()
    assert list((tmp_path / "checkpoints").glob("coarse_acc*.msgpack"))
