"""The port's device-resident trainers (``train/fused_coarse.py``,
``train/fused_fine.py``) against the JAX package's, at the size of JAX's
``TINY`` (tests/test_fused.py: batch 8, embed 32, 32 points, 16 objects, 6
hints of 12 tokens, text of 72) on the two-scene synthetic corpus: the
swap tables and ``_assemble_text`` exactly, the assembly against the host
loader exactly, one fused coarse step with the bank active, the bank loss,
the refresh, the epoch plan (order, segments, refresh points) exactly, and
the CLI with ``--fused --neg_bank``
(``test_torch_port_fused_fine.py`` holds the fine one).

JAX's steps are its own ``_step_core`` compiled with XLA's fusion pass off
(its fused CPU program drops part of the max-poolings' gradients, ROADMAP
Queue 3), through a stand-in state whose ``apply_gradients`` returns the
gradients and BN statistics it is given. JAX's draws (flips, hint order and
the prepared points, from the step's key as ``_step_core`` splits it) are
handed to the port. Tolerances, as the training step tests': the loss
within 1e-5 (relative); gradient leaves within 1e-3 (relative L2; a leaf
whose norm is under 1e-4 of the global norm within 1e-5 of it) and BN
running statistics within 1e-5 of each leaf's scale, against the port's
float64 step on the f32 step's own choices, the float64 step against JAX's
within the step tests' float64 limits (see the step test). The bank loss
within 1e-6 (relative), the refresh's rows within 1e-5 (absolute, on unit vectors:
eval-mode encodings of JAX's draws, f32 sums in another order).
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
from text2pos_tpu.data.loaders import CoarseLoader as JCoarseLoader
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.ops.transforms import prepare_object_points as jprepare
from text2pos_tpu.train import fused_coarse as jfused
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.loaders import CoarseLoader
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.train import fused_coarse
from text2pos_torch.train.coarse import CoarseTrainer
from text2pos_torch.train.state import TrainState, make_optimizer
from text2pos_torch.utils.convert_jax import (load_jax_params, module_to_jax,
                                              params_to_jax)
from text2pos_torch.utils.float64 import Decisions, float64_pins

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(batch_size=8, embed_dim=32, pointnet_numpoints=32,
            coarse_max_objects=16, num_mentioned=6, max_hint_len=12,
            max_text_len=72, learning_rate=1e-3, epochs=1)
BANK = dict(neg_bank=True, neg_bank_hardest=4, neg_bank_warmup=0)
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
BN_TOL = 1e-5
BANK_LOSS_TOL = 1e-6
REFRESH_TOL = 1e-5
NEAR_TIE_TOL = 1e-5


class Capture:
    """A stand-in train state: ``apply_gradients`` hands back what it is
    given, so that a jitted JAX step returns its gradients (and BN
    statistics, where it passes them)."""

    def __init__(self, params, batch_stats=None):
        self.params, self.batch_stats = params, batch_stats

    def apply_gradients(self, grads, batch_stats=None):
        return grads if batch_stats is None else (grads, batch_stats)


_COMPILED = {}


def jax_step(trainer, state, dev, idx, rng):
    """(loss, gradients, BN statistics) of JAX's fused ``_step_core``,
    compiled without fusion (once a trainer and dtype)."""
    args = (state.params, state.batch_stats, dev, idx, rng)
    key = (id(trainer), jax.tree.leaves(state.params)[0].dtype)
    if key not in _COMPILED:
        fn = jax.jit(lambda p, bs, d, i, r: trainer._step_core(
            Capture(p, bs), d, i, r))
        _COMPILED[key] = fn.lower(*args).compile(compiler_options=NO_FUSION)
    (grads, stats), loss = _COMPILED[key](*args)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return float(loss), to_np(grads), to_np(stats)


def port_grads(model):
    return params_to_jax(model, {n: p.grad for n, p in
                                 model.named_parameters()})


@pytest.fixture(scope="module")
def data():
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    pcells, pposes = corpus(make_synthetic_dataset)
    return dict(cells=cells, poses=poses, vocab=vocab, pcells=pcells,
                pposes=pposes, pvocab=Vocabulary(vocab.known_words))


def jax_draws(jt, dev, idx, rng):
    """JAX's draws of ``_step_core(rng)``: flips, hint order, and the
    prepared points and colours of the valid objects."""
    B = idx.shape[0]
    k_flip, k_shuffle, k_points = jax.random.split(rng, 3)
    flips = jax.random.bernoulli(k_flip, 0.5, (B, 2))
    perm = jnp.argsort(jax.random.uniform(k_shuffle, (B, 6)), axis=1)
    cell = dev["pose_cell_idx"][idx]
    xyz = dev["points_xyz"][cell]
    sign = jnp.where(flips, -1.0, 1.0)
    off = jnp.where(flips, 1.0, 0.0)
    xyz = xyz.at[..., :2].set(off[:, None, None, :]
                              + sign[:, None, None, :] * xyz[..., :2])
    pts, cols = jprepare(xyz, dev["points_rgb"][cell],
                         dev["point_count"][cell], 32, k_points,
                         augment=True)
    mask = np.asarray(dev["mask"][cell]).ravel()
    return {"flips": np.asarray(flips), "perm": np.asarray(perm),
            "points": (np.asarray(pts).reshape(-1, 32, 3)[mask],
                       np.asarray(cols).reshape(-1, 32, 3)[mask])}


@pytest.fixture(scope="module")
def coarse(data):
    """JAX's fused coarse trainer with the bank, its state, the bank
    refreshed, and one step's draws, loss, gradients and statistics, in
    f32 and in float64 (``jax_enable_x64`` with its float32 pins widened;
    draws of its own from the same key)."""
    cfg = JConfig(**TINY, **BANK)
    jt = jfused.FusedCoarseTrainer(cfg, data["vocab"], data["cells"],
                                   data["poses"])
    host = JCoarseLoader(data["cells"], data["poses"], data["vocab"], 8, 16,
                         32, 72)
    state = jt.init_state(next(host.epoch(seed=0)), jax.random.PRNGKey(0), 1)
    jt.refresh_neg_bank(state)
    jt.dev["neg_weight"] = jnp.asarray(1.0, jnp.float32)
    idx = jnp.arange(8, dtype=jnp.int32)
    rng = jax.random.PRNGKey(3)
    draws = jax_draws(jt, jt.dev, idx, rng)
    loss, grads, stats = jax_step(jt, state, jt.dev, idx, rng)
    with jax_float64():
        dev64 = to_float64(jt.dev)
        state64 = state.replace(params=to_float64(state.params),
                                batch_stats=to_float64(state.batch_stats))
        draws64 = jax_draws(jt, dev64, idx, rng)
        assert draws64["points"][0].dtype == np.float64
        f64 = jax_step(jt, state64, dev64, idx, rng)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(trainer=jt, state=state, params=to_np(state.params),
                batch_stats=to_np(state.batch_stats),
                bank=np.asarray(jt.dev["neg_bank"]), loss=loss, grads=grads,
                stats=stats, draws=draws, draws64=draws64, f64=f64)


def port_coarse(data, coarse, **kw):
    cfg = TrainConfig(**{**TINY, **BANK, "device": "cpu", **kw})
    tr = fused_coarse.FusedCoarseTrainer(cfg, data["pvocab"], data["pcells"],
                                         data["pposes"])
    assert load_jax_params(tr.model, coarse["params"],
                           coarse["batch_stats"]) == []
    return tr, TrainState(tr.model, make_optimizer(tr.model, 1e-3))


@pytest.mark.parametrize("direction", [1, -1])
def test_swap_tables_match_jax(data, direction):
    got = fused_coarse.build_token_swap(data["pvocab"], direction)
    np.testing.assert_array_equal(
        got, jfused.build_token_swap(data["vocab"], direction))
    assert (got != np.arange(len(got))).sum() == 2


def test_assemble_text_matches_jax(data, coarse):
    """JAX's packing of JAX's flips and hint order, token for token."""
    jt = coarse["trainer"]
    tr, _ = port_coarse(data, coarse)
    key = jax.random.PRNGKey(5)
    k_flip, k_perm = jax.random.split(key)
    flips = np.asarray(jax.random.bernoulli(k_flip, 0.5, (13, 2)))
    want_tok, want_len = jt._assemble_text(
        jt.dev["hint_tokens"], jt.dev["hint_lengths"], jnp.asarray(flips[:, 0]),
        jnp.asarray(flips[:, 1]), k_perm)
    perm = np.asarray(jnp.argsort(jax.random.uniform(k_perm, (13, 6)),
                                  axis=1))
    tok, ln = tr._assemble_text(
        tr.dev["hint_tokens"], tr.dev["hint_lengths"],
        torch.from_numpy(flips[:, 0]), torch.from_numpy(flips[:, 1]),
        torch.from_numpy(perm))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(ln.numpy(), np.asarray(want_len))


def test_assembly_equals_host_loader(data, coarse):
    """Tokens, lengths, flipped points and centres, and the flat object
    layout of the fused assembly equal ``CoarseLoader``'s batch for the same
    poses, flips and hint order."""
    tr, _ = port_coarse(data, coarse, max_text_len=48)
    host = CoarseLoader(data["pcells"], data["pposes"], data["pvocab"], 8,
                        16, 32, 48)
    g = torch.Generator().manual_seed(0)
    pose_idx = torch.randperm(13, generator=g)[:8]
    counts = tr.dev["point_count"][tr.dev["pose_cell_idx"][pose_idx]]
    d = tr.draw(8, counts, g)
    F = tr.num_objects(pose_idx.numpy())
    got = tr.assemble(pose_idx, F, d)
    want = host.batch_with(pose_idx.numpy(), d["perm"].numpy(),
                           d["flips"].numpy())
    valid = want["flat_valid"]
    assert valid.sum() == F
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    assert d["flips"].any() and not d["flips"].all()
    for k in ("points_xyz", "points_rgb", "point_count", "centers", "colors",
              "cell_idx", "slot_idx"):
        np.testing.assert_array_equal(got[k].numpy(), want[k][valid],
                                      err_msg=k)


def coarse_step(data, coarse, f64=False, draws=None):
    """The port's fused step with the bank active on JAX's bank and draws
    (``draws``, else JAX's f32 ones): (loss, gradients, BN statistics); in
    float64 (``float64_pins``) with ``f64``."""
    tr, state = port_coarse(data, coarse)
    tr.dev["neg_bank"] = torch.from_numpy(coarse["bank"])
    tr.neg_weight = 1.0
    draws = draws or coarse["draws"]
    with float64_pins() if f64 else contextlib.nullcontext():
        if f64:
            state.model.double()
            tr.dev = {k: v.double() if v.is_floating_point() else v
                      for k, v in tr.dev.items()}
            draws = dict(draws, points=tuple(np.asarray(p, np.float64)
                                             for p in draws["points"]))
        loss = tr.fused_forward_loss(state, torch.arange(8), draws=draws)
        loss.backward()
        grads = params_to_jax(state.model, {
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in state.model.named_parameters()})
        return float(loss), grads, module_to_jax(state.model)[1]


def test_fused_coarse_step_with_bank_matches_jax(data, coarse):
    """The f32 loss against JAX's. The f32 step's gradients and BN
    statistics against the port's float64 step on the f32 step's own ReLU
    and max choices (``Decisions``; each choice the float64 step would
    have made otherwise a near-tie within 1e-5 of its tensor's largest
    magnitude): on this batch one ReLU input lies 1.8e-8 (relative) from
    its tie, and JAX's f32 step takes the other side, which moves
    PointNet++'s BN bias gradients by 4e-3 between the two f32 steps. The
    port's float64 step against JAX's on JAX's float64 draws: loss 1e-12,
    gradient leaves 1e-9, BN 1e-12 (the step tests' float64 tolerances)."""
    decisions = Decisions()
    with decisions.record():
        loss, grads, stats = coarse_step(data, coarse)
    assert abs(loss - coarse["loss"]) <= LOSS_TOL * abs(coarse["loss"])
    with decisions.replay():
        ref = coarse_step(data, coarse, f64=True)
    assert decisions.margin <= NEAR_TIE_TOL, decisions.margin
    assert abs(loss - ref[0]) <= LOSS_TOL * abs(ref[0])
    assert_grads_close(grads, ref[1], GRAD_TOL)
    assert_stats_close(stats, ref[2], BN_TOL)
    want = coarse["f64"]
    loss64, grads64, stats64 = coarse_step(data, coarse, True,
                                           coarse["draws64"])
    assert abs(loss64 - want[0]) <= F64_LOSS_TOL * abs(want[0])
    assert_grads_close(grads64, want[1], F64_GRAD_TOL, F64_ZERO_GRAD_TOL)
    assert_stats_close(stats64, want[2], F64_BN_TOL)


def test_neg_bank_loss_matches_jax(data, coarse):
    jt = coarse["trainer"]
    tr, _ = port_coarse(data, coarse)
    rng = np.random.default_rng(4)
    unit = lambda a: (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(
        np.float32)
    text, cells = (unit(rng.standard_normal((8, 32))) for _ in range(2))
    bank = unit(rng.standard_normal((8, 32)))
    pose_idx = np.array([0, 3, 5, 6, 7, 9, 11, 12])
    cell_idx = np.asarray(jt.dev["pose_cell_idx"])[pose_idx]
    dev = dict(jt.dev, neg_bank=jnp.asarray(bank))
    want = float(jt._neg_bank_loss(dev, jnp.asarray(pose_idx),
                                   jnp.asarray(cell_idx), jnp.asarray(text),
                                   jnp.asarray(cells)))
    tr.dev["neg_bank"] = torch.from_numpy(bank)
    got = float(tr._neg_bank_loss(torch.from_numpy(pose_idx),
                                  torch.from_numpy(cell_idx).long(),
                                  torch.from_numpy(text),
                                  torch.from_numpy(cells)))
    assert want > 0
    assert abs(got - want) <= BANK_LOSS_TOL * want


def test_refresh_matches_jax(data, coarse):
    """The bank after a refresh on JAX's draws (``PRNGKey(0)``'s for every
    chunk) against JAX's ``refresh_neg_bank``; and each row equals
    ``encode_all_cells``'s encoding of that cell on those draws."""
    jt = coarse["trainer"]
    tr, state = port_coarse(data, coarse)
    k_sample, _ = jax.random.split(jax.random.PRNGKey(0))
    u = np.asarray(jax.random.uniform(k_sample, (8, 16, 32)))
    chunks = tr.refresh_chunks()
    assert np.array_equal(chunks.ravel(), np.arange(chunks.size) % 8)
    tr.refresh_neg_bank(state, u=torch.from_numpy(u))
    got = tr.dev["neg_bank"].numpy()
    np.testing.assert_allclose(got, coarse["bank"], rtol=0, atol=REFRESH_TOL)
    counts, mask = tr.bank.point_count, tr.bank.mask
    draws = []
    for i in range(0, 8, 8):
        cells = np.arange(i, min(i + 8, 8))
        idx = np.clip(np.floor(u[:len(cells)] * counts[cells][..., None]),
                      0, 31).astype(np.int64)
        draws.append(idx[mask[cells]])
    direct = CoarseTrainer.encode_all_cells(tr, state, tr.bank, draws)
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-6)


def test_inactive_bank_matches_no_bank(data, coarse):
    """With the bank's weight 0 (warm-up), the step equals the step of a
    trainer without the bank: loss and gradients bit for bit, with
    PyTorch's deterministic algorithms (otherwise the CPU's threaded
    accumulation into the LSTM's token tables varies run to run in the
    last bits)."""
    out = []
    torch.use_deterministic_algorithms(True)
    for kw in (dict(neg_bank=False), {}):
        tr, state = port_coarse(data, coarse, **kw)
        tr.dev.setdefault("neg_bank", torch.from_numpy(coarse["bank"]))
        loss = tr.fused_forward_loss(state, torch.arange(8),
                                     draws=coarse["draws"])
        loss.backward()
        out.append((float(loss), {n: p.grad.clone() for n, p in
                                  state.model.named_parameters()
                                  if p.grad is not None}))
    torch.use_deterministic_algorithms(False)
    assert out[0][0] == out[1][0]
    assert out[0][1].keys() == out[1][1].keys()
    assert all(torch.equal(out[0][1][k], out[1][1][k]) for k in out[0][1])


@pytest.mark.parametrize("poses,batch,seg,refresh,epoch", [
    (13, 8, "128", 1, 1), (53, 4, "3", 2, 2), (53, 4, "3", 4, 3),
    (40, 4, "0", 3, 1), (41, 5, "4", 1, 5)])
def test_epoch_plan_matches_jax(data, coarse, monkeypatch, poses, batch, seg,
                                refresh, epoch):
    """JAX's epoch, its steps and bank refreshes recorded, against
    ``epoch_plan`` and the port's epoch so recorded."""
    monkeypatch.setenv("T2P_FUSED_SEG", seg)
    jt = coarse["trainer"]
    calls = []
    monkeypatch.setattr(jt, "_fused_epoch", lambda s, d, e, r: (
        calls.append(("steps", np.asarray(e).tolist())) or (s, 0.0)))
    monkeypatch.setattr(jt, "refresh_neg_bank",
                        lambda s: calls.append(("refresh",)))
    monkeypatch.setattr(jt, "num_poses", poses)
    monkeypatch.setattr(jt, "cfg", JConfig(**{**TINY, **BANK,
                                              "batch_size": batch,
                                              "neg_bank_refresh": refresh}))
    jt.fused_train_epoch(None, epoch, jax.random.PRNGKey(0))
    step_idx, segs, refresh_at = fused_coarse.epoch_plan(poses, batch, 0,
                                                         epoch, refresh)
    want = [("refresh",)]
    for i, (s0, s1) in enumerate(segs):
        want += [("refresh",)] * (i in refresh_at)
        want.append(("steps", step_idx[s0:s1].tolist()))
    assert calls == want

    tr, _ = port_coarse(data, coarse, batch_size=batch,
                        neg_bank_refresh=refresh)
    got = []
    monkeypatch.setattr(tr, "num_poses", poses)
    monkeypatch.setattr(tr, "num_objects", lambda idx: 0)
    monkeypatch.setattr(tr, "refresh_neg_bank",
                        lambda s: got.append(("refresh",)))
    monkeypatch.setattr(tr, "fused_train_step", lambda s, i, n, g: (
        got.append(("step", i.tolist())) or torch.zeros(())))
    tr.fused_train_epoch(None, epoch)
    flat = [("refresh",)]
    for c in want[1:]:
        flat += [c] if c[0] == "refresh" else [("step", r) for r in c[1]]
    assert got == flat


def fused_cli(tmp_path, stage, flags):
    """``python -m text2pos_torch.train.<stage> --fused --device cpu``:
    one epoch on the synthetic dataset, two segments, evaluation and the
    best checkpoint."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               T2P_FUSED_SEG="4", T2P_FUSED_VERBOSE="1")
    out = subprocess.run(
        [sys.executable, "-m", f"text2pos_torch.train.{stage}", "--device",
         "cpu", "--fused", "--dataset", "SYNTHETIC", "--epochs", "1",
         "--batch_size", "8", "--embed_dim", "32", "--pointnet_numpoints",
         "32", "--top_k", "1", "3", *flags],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "seg 1 " in out.stdout and "best checkpoint:" in out.stdout
    assert list((tmp_path / "checkpoints").glob(f"{stage}_acc*.msgpack"))


def test_fused_cli_one_epoch(tmp_path):
    fused_cli(tmp_path, "coarse", [
        "--neg_bank", "--neg_bank_warmup", "0", "--neg_bank_refresh", "2",
        "--coarse_max_objects", "16"])
