"""The offsets trainer of the port (``models/offsets.py``,
``train/offsets.py``) against the JAX package's: ``OffsetRegressor`` on
JAX's weights, a training step (loss and gradients), ``eval_step`` (the
direction MSE and the oracle intersection error), the oracle's scatter
with two hints on one object, ``get_pos_in_cell_intersect`` with fewer
than two matches and with a summed hint index past the last hint (NaN, as
JAX's gather fills it), and the CLI.

Sizes: regressor width 32, batches of 4 poses with 6 hints on the tiny
two-scene corpus. Tolerances: directions and positions within 1e-5
(absolute); the loss and MSE within 1e-5 (relative); gradient leaves
within 1e-4 (relative L2; the model has no BN and no near-tie moves a
ReLU here); the intersection error within 1e-5 (relative).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_fused import Capture
from test_torch_port_train_coarse import assert_grads_close, corpus
from text2pos_tpu.config import TrainConfig as JConfig
from text2pos_tpu.data.hints import Vocabulary as JVocab
from text2pos_tpu.data.hints import build_vocabulary as jbuild_vocabulary
from text2pos_tpu.data.hints import create_hint_description as jhints
from text2pos_tpu.data.loaders import FineLoader as JFineLoader
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.models.matcher import \
    get_pos_in_cell_intersect as jintersect
from text2pos_tpu.train.offsets import OffsetsTrainer as JOffsetsTrainer
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.models.matcher import get_pos_in_cell_intersect
from text2pos_torch.train.offsets import OffsetsTrainer, oracle_matches
from text2pos_torch.utils.convert_jax import load_jax_params, params_to_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(batch_size=4, regressor_dim=32, pad_size=8, num_mentioned=6,
           max_hint_len=12, pointnet_numpoints=32, learning_rate=1e-3)
TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def case():
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    loader = JFineLoader(cells, poses, vocab, 4, 8, 6, 32, 12)
    trainer = JOffsetsTrainer(JConfig(**CFG), vocab)
    batch = next(loader.epoch(seed=2))
    state = trainer.init_state(batch, jax.random.PRNGKey(0), 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in ("num_real", "pose_idx")}
    pred = trainer.model.apply({"params": state.params}, jb["hint_tokens"],
                               jb["hint_lengths"], train=False)
    step = type(trainer).train_step.__wrapped__
    grads, loss = jax.jit(lambda p, b: step(trainer, Capture(p), b))(
        state.params, jb)
    mse, err = trainer.eval_step(state, jb)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(vocab=vocab, batch=batch, params=to_np(state.params),
                pred=np.asarray(pred), loss=float(loss), grads=to_np(grads),
                mse=float(mse), err=float(err))


def port(case):
    tr = OffsetsTrainer(TrainConfig(**CFG, device="cpu"),
                        Vocabulary(case["vocab"].known_words))
    state = tr.init_state(3)
    assert load_jax_params(state.model, case["params"]) == []
    return tr, state


def test_regressor_matches_jax(case):
    tr, state = port(case)
    tb = tr.tensors(case["batch"])
    with torch.no_grad():
        got = state.model(tb["hint_tokens"], tb["hint_lengths"]).numpy()
    assert got.shape == (4, 6, 2)
    np.testing.assert_allclose(got, case["pred"], rtol=0, atol=TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)


def test_train_step_matches_jax(case):
    tr, state = port(case)
    loss = tr.forward_loss(state, tr.tensors(case["batch"]))
    loss.backward()
    assert abs(float(loss) - case["loss"]) <= TOL * case["loss"]
    assert_grads_close(params_to_jax(state.model, {
        n: p.grad for n, p in state.model.named_parameters()}),
        case["grads"], GRAD_TOL)
    before = state.model.mlp_offsets.dense_0.weight.clone()
    state.apply_gradients()
    assert not torch.equal(before, state.model.mlp_offsets.dense_0.weight)


def test_eval_step_matches_jax(case):
    tr, state = port(case)
    mse, err = tr.eval_step(state, case["batch"])
    assert abs(float(mse) - case["mse"]) <= TOL * case["mse"]
    assert abs(float(err) - case["err"]) <= TOL * case["err"]


def jax_oracle(gt, O):
    """JAX's ``eval_step`` scatter, verbatim (``train/offsets.py:72-84``)."""
    B, H = gt.shape
    hint_ids = jnp.broadcast_to(jnp.arange(H)[None, :], gt.shape)
    valid = gt >= 0
    safe = jnp.where(valid, gt, 0)
    accum = jnp.zeros((B, O), jnp.int32).at[
        jnp.arange(B)[:, None], safe].add(
            ((hint_ids + 1) * valid).astype(jnp.int32))
    return np.asarray(jnp.where(accum > 0, accum - 1, -1))


def test_oracle_and_intersection_match_jax():
    """Rows: two hints (0, 1) on object 3 (it takes hint 1 + 2 - 1 = 2) and
    two more matches; one match only (the cell middle); none; hints 4 and 5
    on object 0 (index 10, past the last hint: NaN in both)."""
    gt = np.array([[3, 3, -1, 0, 5, -1], [-1, 2, -1, -1, -1, -1],
                   [-1] * 6, [-1, -1, 1, 2, 0, 0]], np.int32)
    want_m = jax_oracle(jnp.asarray(gt), 8)
    m = oracle_matches(torch.from_numpy(gt), 8).numpy()
    np.testing.assert_array_equal(m, want_m)
    assert m[0, 3] == 2 and m[3, 0] == 10
    rng = np.random.default_rng(0)
    ctr = rng.random((4, 8, 2)).astype(np.float32)
    d = rng.standard_normal((4, 6, 2)).astype(np.float32)
    want = np.asarray(jintersect(jnp.asarray(ctr), jnp.asarray(want_m),
                                 jnp.asarray(d)))
    got = get_pos_in_cell_intersect(torch.from_numpy(ctr),
                                    torch.from_numpy(m),
                                    torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL, equal_nan=True)
    np.testing.assert_array_equal(got[1:3], 0.5)
    assert np.isnan(got[3]).all() and np.isfinite(got[:3]).all()


def test_intersection_batched_matches_jax():
    """Random matches over a [2, 5] batch of cells, some rows with fewer
    than two."""
    rng = np.random.default_rng(1)
    ctr = rng.random((2, 5, 8, 2)).astype(np.float32)
    m = rng.integers(-1, 6, (2, 5, 8)).astype(np.int32)
    m[0, 0] = -1
    m[1, 2, 1:] = -1
    d = rng.standard_normal((2, 5, 6, 2)).astype(np.float32)
    want = np.asarray(jintersect(jnp.asarray(ctr), jnp.asarray(m),
                                 jnp.asarray(d)))
    got = get_pos_in_cell_intersect(*map(torch.from_numpy,
                                         (ctr, m, d))).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_offsets_cli_one_epoch(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "text2pos_torch.train.offsets", "--device",
         "cpu", "--dataset", "SYNTHETIC", "--epochs", "2", "--batch_size",
         "16", "--regressor_dim", "32", "--pad_size", "8",
         "--pointnet_numpoints", "32", "--max_hint_len", "12"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if "val-err" in ln]
    assert len(lines) == 2
    assert all(np.isfinite(float(ln.split("val-mse ")[1].split()[0]))
               for ln in lines)


@pytest.mark.parametrize("module,flags", [
    ("offsets", []), ("pointnet2", []), ("coarse", ["--fused", "--neg_bank"]),
    ("fine", ["--fused", "--rank_weight", "1", "--remat"])])
def test_new_clis_need_cuda_unless_told_cpu(module, flags):
    """The new entry points ask for the card by default: without one they
    raise rather than run on the CPU."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    main = importlib.import_module(f"text2pos_torch.train.{module}").main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--dataset", "SYNTHETIC", "--epochs", "1", "--embed_dim", "32",
              "--regressor_dim", "32", *flags])
