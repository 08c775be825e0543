"""PointNet++ pretraining in the port (``train/pointnet2.py``) against the
JAX package's: ``ObjectsDataset``'s arrays and batches exactly, one
``PointNet2Trainer`` step (the class head's cross-entropy and accuracy, its
gradients and BN statistics), the eval-mode predictions on JAX's draws,
the pretraining checkpoint read by the other package's
``load_pretrained_into`` both ways, and the CLI.

Sizes: the two-scene tiny corpus of the step tests (96 objects), batches of
16 objects of 32 points. The step on JAX's prepared points: the loss
within 1e-5 (relative) of JAX's and the accuracy equal; the gradients
(relative L2 1e-3; a leaf under 1e-4 of the global norm within 1e-5 of
it) and BN statistics (1e-5) of the f32 step against the port's float64
step on the f32 step's ReLU and max choices (``Decisions``, each other
choice a near-tie within 1e-5); the port's float64 step against JAX's on
JAX's float64 points (loss 1e-12, leaves 1e-9, BN 1e-12). JAX's reference
is its own ``train_step`` compiled without XLA's fusion pass (ROADMAP
Queue 3).
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

from test_torch_port_fused import Capture
from test_torch_port_train_coarse import (F64_BN_TOL, F64_GRAD_TOL,
                                          F64_LOSS_TOL, F64_ZERO_GRAD_TOL,
                                          NO_FUSION, assert_grads_close,
                                          assert_stats_close, corpus,
                                          jax_float64, to_float64)
from text2pos_tpu.config import TrainConfig as JConfig
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.train import pointnet2 as jpn
from text2pos_tpu.train.state import save_checkpoint as jsave_checkpoint
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.train import pointnet2
from text2pos_torch.train.coarse import CoarseTrainer
from text2pos_torch.train.state import save_checkpoint
from text2pos_torch.utils.convert_jax import (load_jax_params, module_to_jax,
                                              params_to_jax)
from text2pos_torch.utils.float64 import Decisions, float64_pins

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(batch_size=16, pointnet_numpoints=32, learning_rate=1e-3)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
BN_TOL = 1e-5
NEAR_TIE_TOL = 1e-5


def jax_pretrain_step(trainer, state, batch, rng):
    """JAX's train step, compiled without fusion: (loss, accuracy,
    gradients, BN statistics) and its prepared points."""
    step = type(trainer).train_step.__wrapped__
    fn = jax.jit(lambda p, bs, b, r: step(trainer, Capture(p, bs), b, r))
    args = (state.params, state.batch_stats, batch, rng)
    (grads, stats), loss, acc = fn.lower(*args).compile(
        compiler_options=NO_FUSION)(*args)
    pts, cols = jax.jit(lambda b, r: jpn.prepare_object_points(
        b["xyz"], b["rgb"], b["counts"], 32, r, augment=True))(batch, rng)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(loss=float(loss), acc=float(acc), grads=to_np(grads),
                stats=to_np(stats), points=(np.asarray(pts),
                                            np.asarray(cols)))


@pytest.fixture(scope="module")
def case():
    cells, _ = corpus(jsynthetic)
    ds = jpn.ObjectsDataset(cells, 32, seed=0)
    trainer = jpn.PointNet2Trainer(JConfig(**CFG))
    batch = next(ds.epoch(16, seed=3))
    state = trainer.init_state(batch, jax.random.PRNGKey(0), 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(5)
    out = jax_pretrain_step(trainer, state, jb, rng)
    with jax_float64():
        state64 = state.replace(params=to_float64(state.params),
                                batch_stats=to_float64(state.batch_stats))
        out["f64"] = jax_pretrain_step(trainer, state64, to_float64(jb), rng)
    eval_acc = float(trainer.eval_step(state, jb, rng))
    k_sample, _ = jax.random.split(rng)
    u = np.asarray(jax.random.uniform(k_sample, (16, 32)))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(out, cells=cells, dataset=ds, trainer=trainer, state=state,
                batch=batch, params=to_np(state.params),
                batch_stats=to_np(state.batch_stats), eval_acc=eval_acc,
                eval_idx=np.clip(np.floor(u * batch["counts"][:, None]), 0,
                                 31).astype(np.int64))


def port_trainer(case):
    tr = pointnet2.PointNet2Trainer(TrainConfig(**CFG, device="cpu"))
    state = tr.init_state(2)
    assert load_jax_params(state.model, case["params"],
                           case["batch_stats"]) == []
    return tr, state


def test_objects_dataset_matches_jax(case):
    cells, _ = corpus(make_synthetic_dataset)
    ds = pointnet2.ObjectsDataset(cells, 32, seed=0)
    want = case["dataset"]
    assert len(ds) == len(want) == 96
    for k in ("xyz", "rgb", "counts", "classes", "colors"):
        got = getattr(ds, k)
        assert got.dtype == getattr(want, k).dtype
        np.testing.assert_array_equal(got, getattr(want, k), err_msg=k)
    for shuffle in (True, False):
        got = list(ds.epoch(16, seed=3, shuffle=shuffle))
        ref = list(want.epoch(16, seed=3, shuffle=shuffle))
        assert len(got) == len(ref) == 6
        for a, b in zip(got, ref):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def pretrain_step(case, f64=False, points=None):
    tr, state = port_trainer(case)
    points = points or case["points"]
    with float64_pins() if f64 else contextlib.nullcontext():
        if f64:
            state.model.double()
            points = tuple(np.asarray(a, np.float64) for a in points)
        loss, acc = tr.forward_loss(state, case["batch"],
                                    draws={"points": points})
        loss.backward()
        grads = params_to_jax(state.model, {
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in state.model.named_parameters()})
        return float(loss), float(acc), grads, module_to_jax(state.model)[1]


def test_pretrain_step_matches_jax(case):
    decisions = Decisions()
    with decisions.record():
        loss, acc, grads, stats = pretrain_step(case)
    assert abs(loss - case["loss"]) <= LOSS_TOL * abs(case["loss"])
    assert acc == case["acc"]
    with decisions.replay():
        ref = pretrain_step(case, True)
    assert decisions.margin <= NEAR_TIE_TOL, decisions.margin
    assert_grads_close(grads, ref[2], GRAD_TOL)
    assert_stats_close(stats, ref[3], BN_TOL)
    # Only the class head trains: the colour head has no gradient.
    assert not np.any(grads["color_classifier"]["kernel"])
    want = case["f64"]
    loss64, _, grads64, stats64 = pretrain_step(case, True, want["points"])
    assert abs(loss64 - want["loss"]) <= F64_LOSS_TOL * abs(want["loss"])
    assert_grads_close(grads64, want["grads"], F64_GRAD_TOL,
                       F64_ZERO_GRAD_TOL)
    assert_stats_close(stats64, want["stats"], F64_BN_TOL)


def test_eval_predictions_match_jax(case):
    """Eval mode (running statistics) on JAX's draws: JAX's accuracy."""
    tr, state = port_trainer(case)
    acc = float(tr.eval_step(state, case["batch"],
                             draws={"idx": case["eval_idx"]}))
    assert acc == case["eval_acc"]


def test_checkpoint_port_to_jax(case, tmp_path):
    """A port-written pretraining checkpoint, grafted by JAX's
    ``load_pretrained_into`` under a model's ``object_encoder``, holds the
    port's weights and statistics, both heads included."""
    tr, state = port_trainer(case)
    tr.train_step(state, case["batch"], pointnet2.eval_generator(
        tr.device, 0))
    path = str(tmp_path / "pointnet_acc0.50.msgpack")
    save_checkpoint(path, state, extra={"val_acc": 0.5})
    variables = {"params": {"object_encoder": {"mlp_merge": {}}},
                 "batch_stats": {"object_encoder": {}}}
    grafted = jpn.load_pretrained_into(variables, path)
    params, stats = module_to_jax(state.model)
    got = grafted["params"]["object_encoder"]["pointnet"]
    jax.tree.map(np.testing.assert_array_equal, got, params)
    jax.tree.map(np.testing.assert_array_equal,
                 grafted["batch_stats"]["object_encoder"]["pointnet"], stats)
    assert set(got) >= {"class_classifier", "color_classifier", "sa1", "ga"}


def test_checkpoint_jax_to_port(case, tmp_path):
    """A JAX-written pretraining checkpoint through the port's
    ``load_pretrained_into`` (the stage trainers' ``--pointnet_path``)."""
    path = str(tmp_path / "pointnet.msgpack")
    jsave_checkpoint(path, case["state"], extra={"val_acc": 0.5})
    cfg = TrainConfig(embed_dim=32, pointnet_numpoints=32, device="cpu",
                      pointnet_path=path)
    state = CoarseTrainer(cfg, Vocabulary(["a"])).init_state(1)
    params, stats = module_to_jax(state.model.object_encoder.pointnet)
    jax.tree.map(np.testing.assert_array_equal, params, case["params"])
    jax.tree.map(np.testing.assert_array_equal, stats, case["batch_stats"])


def test_pretrain_cli(tmp_path):
    """``python -m text2pos_torch.train.pointnet2 --device cpu``: two
    epochs on the synthetic dataset; one best checkpoint is kept, named by
    its validation accuracy."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "text2pos_torch.train.pointnet2", "--device",
         "cpu", "--dataset", "SYNTHETIC", "--epochs", "2", "--batch_size",
         "32", "--pointnet_numpoints", "32", "--learning_rate", "3e-3"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    kept = list((tmp_path / "checkpoints").glob("pointnet_acc*.msgpack"))
    assert len(kept) == 1, kept
    best = out.stdout.split("best checkpoint:")[1].strip()
    assert os.path.basename(best) == kept[0].name
    accs = [float(line.split("val-acc ")[1]) for line in
            out.stdout.splitlines() if "val-acc" in line]
    assert kept[0].name == f"pointnet_acc{max(accs):0.2f}.msgpack"


def test_bench_pointnet_predictions_match_fixture():
    """``bench_pointnet`` in eval mode on the first 256 objects of the
    recipe's validation scene, on JAX's draws from
    ``fixtures/bench_recipe.npz``: JAX's class predictions exactly (the
    card holds all 3136, ``chip_smoke.py`` phase 9)."""
    from text2pos_torch.train.state import load_checkpoint, load_variables

    fx = np.load(os.path.join(ROOT, "text2pos_torch", "fixtures",
                              "bench_recipe.npz"))
    cells, _ = make_synthetic_dataset(
        seed=77, scene_name="7077", extent=30.0 * 16, cell_size=30.0,
        poses_per_cell=1, objects_per_cell_area=12)
    ds = pointnet2.ObjectsDataset(cells, 256, seed=0)
    assert len(fx["pretrain_val_pred"]) == len(ds) // 64 * 64 == 3136
    np.testing.assert_array_equal(fx["pretrain_val_labels"],
                                  ds.classes[:3136])
    tr = pointnet2.PointNet2Trainer(TrainConfig(batch_size=64,
                                                device="cpu"))
    state = tr.init_state(1)
    load_variables(state.model, load_checkpoint(os.path.join(
        ROOT, "checkpoints", "bench_pointnet.msgpack")))
    for i, b in enumerate(ds.epoch(64, 0, shuffle=False)):
        if i == 4:
            break
        s = slice(64 * i, 64 * (i + 1))
        got = tr.predictions(state, b, draws={
            "idx": fx["pretrain_val_idx"][s].astype(np.int64)}).numpy()
        np.testing.assert_array_equal(got, fx["pretrain_val_pred"][s])
