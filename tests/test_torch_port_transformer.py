"""The port's transformer matcher ablation (``text2pos_torch/models/
transformer.py``, ``train/transformer.py``) against the JAX package's, at a
tiny configuration (embed 32 = 4 heads of 8, 2 blocks, 10 Sinkhorn
iterations, 32 points, batch 4, a 2-scene synthetic corpus): JAX's
parameters carried over by ``utils/convert_jax.py``, JAX's points handed
over.

Tolerances: the eval forward's log-transport, offsets and aux heads 1e-5
(absolute; f32 sums in another order), its matches equal. One training
step, JAX's gradient by ``jax.value_and_grad`` over ``model.apply``
compiled with XLA's fusion pass off (``test_torch_port_train_fine.py``
says why): loss 1e-5 (relative), every gradient leaf 1e-3 (relative L2),
leaves whose exact gradient is zero within 1e-5 of the global norm, BN
running statistics 2e-6 of each leaf's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_train_fine import (NO_FUSION, assert_grads_close,
                                        assert_stats_close, corpus)
from text2pos_tpu.config import TrainConfig as JConfig
from text2pos_tpu.data.hints import Vocabulary as JVocab
from text2pos_tpu.data.hints import build_vocabulary as jbuild_vocabulary
from text2pos_tpu.data.hints import create_hint_description as jhints
from text2pos_tpu.data.loaders import FineLoader as JFineLoader
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.train.losses import matching_loss as jmatching_loss
from text2pos_tpu.train.transformer import (
    TransformerTrainer as JTransformerTrainer)
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.models.transformer import (LayerNorm, TransformerMatch,
                                               init_extra_parameters)
from text2pos_torch.train.state import TrainState, make_optimizer
from text2pos_torch.train.transformer import TransformerTrainer
from text2pos_torch.utils.convert_jax import (load_jax_params, module_to_jax,
                                              params_to_jax)

torch.set_num_threads(2)

TINY = dict(batch_size=4, embed_dim=32, num_layers=2, sinkhorn_iters=10,
            pointnet_numpoints=32, pad_size=8, num_mentioned=6,
            max_hint_len=12)
FWD_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
ZERO_GRAD_TOL = 1e-5
BN_TOL = 2e-6


@pytest.fixture(scope="module")
def case():
    """JAX's trainer with the aux heads, its initial state, a batch, its
    prepared points (augmented and not), its eval forward with and without
    the aux heads (the same parameters less theirs) and one step's loss,
    gradients and BN statistics."""
    aux = True
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    jl = JFineLoader(cells, poses, vocab, 4, 8, 6, 32, 12)
    trainer = JTransformerTrainer(JConfig(**TINY), vocab,
                                  with_aux_heads=aux)
    rng = jax.random.PRNGKey(0)
    state = trainer.init_state(next(jl.epoch(seed=0)), rng, 5)
    batch = next(jl.epoch(seed=1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in ("num_real", "pose_idx")}
    step_rng = jax.random.fold_in(rng, 7)
    prep = jax.jit(trainer._prep, static_argnums=(2,))
    pts, cols = prep(jb, step_rng, True)
    eval_pts, eval_cols = prep(jb, step_rng, False)
    variables = {"params": state.params}
    if state.batch_stats:
        variables["batch_stats"] = state.batch_stats
    eval_args = (jb["hint_tokens"], jb["hint_lengths"], eval_pts, eval_cols,
                 jb["centers"], jb["colors"], jb["class_idx"],
                 jb["color_idx"])
    eval_out = {True: trainer.model.apply(variables, *eval_args,
                                          train=False)}
    plain = {**variables, "params": {k: v for k, v in state.params.items()
                                     if not k.startswith("aux_")}}
    eval_out[False] = trainer.model.clone(with_aux_heads=False).apply(
        plain, *eval_args, train=False)

    def loss_fn(params):
        # JAX's train_step's loss (train/transformer.py:78-96), on the
        # points prepared above.
        out, updates = trainer.model.apply(
            {**variables, "params": params}, jb["hint_tokens"],
            jb["hint_lengths"], pts, cols, jb["centers"], jb["colors"],
            jb["class_idx"], jb["color_idx"], train=True,
            mutable=["batch_stats"])
        loss = jmatching_loss(out["log_P"], jb["all_matches"],
                              jb["all_matches_count"])
        loss = loss + 5.0 * jnp.mean((out["offsets"] - jb["offsets"]) ** 2)
        if "class_pred" in out:
            loss = loss + 0.1 * jnp.mean(
                optax.softmax_cross_entropy_with_integer_labels(
                    out["class_pred"], jb["class_idx"]))
        return loss, updates.get("batch_stats", {})

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(
        state.params).compile(compiler_options=NO_FUSION)
    (loss, stats), grads = vg(state.params)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dict(aux=aux, vocab=vocab, batch=batch,
                params=to_np(state.params),
                batch_stats=to_np(state.batch_stats),
                points=(np.asarray(pts), np.asarray(cols)),
                eval_points=(np.asarray(eval_pts), np.asarray(eval_cols)),
                eval_out=to_np(eval_out), loss=float(loss),
                grads=to_np(grads), stats=to_np(stats))


def port(case, aux=True):
    cfg = TrainConfig(**TINY, device="cpu")
    trainer = TransformerTrainer(cfg, Vocabulary(case["vocab"].known_words),
                                 with_aux_heads=aux)
    unused = load_jax_params(trainer.model, case["params"],
                             case["batch_stats"])
    assert sorted(unused) == ([] if aux else [
        f"params/{h}/{k}" for h in ("aux_class", "aux_color")
        for k in ("bias", "kernel")])
    return trainer, TrainState(trainer.model,
                               make_optimizer(trainer.model, 1e-3))


def test_parameter_tree_is_jax(case):
    """Every JAX leaf has its place in the port's module, and back:
    ``segment_embed``, ``bin_score``, the attention's DenseGeneral
    kernels, the LayerNorms, ``mlp_offsets`` and the aux heads."""
    trainer, _ = port(case)
    params, stats = module_to_jax(trainer.model)
    flat = lambda t: {jax.tree_util.keystr(p): np.shape(v) for p, v in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    assert flat(params) == flat(case["params"])
    assert flat(stats) == flat(case["batch_stats"])
    blk = case["params"]["block_0"]["MultiHeadDotProductAttention_0"]
    assert blk["query"]["kernel"].shape == (32, 4, 8)
    assert blk["out"]["kernel"].shape == (4, 8, 32)
    assert "aux_class" in params


@pytest.mark.parametrize("aux", [False, True], ids=["plain", "aux"])
def test_eval_forward_matches_jax(case, aux):
    trainer, state = port(case, aux)
    tb = trainer.tensors(case["batch"])
    pts, cols = (torch.tensor(a) for a in case["eval_points"])
    with torch.no_grad():
        out = trainer._forward(state, tb, pts, cols, train=False)
    want = case["eval_out"][aux]
    assert ("class_pred" in out) == aux
    for k in ("log_P", "offsets") + (("class_pred", "color_pred")
                                      if aux else ()):
        np.testing.assert_allclose(out[k].numpy(), want[k], atol=FWD_TOL,
                                   err_msg=k)
    for k in ("matches0", "matches1"):
        np.testing.assert_array_equal(out[k].numpy(), want[k])


def test_one_step_matches_jax(case):
    trainer, state = port(case)
    draws = {"points": case["points"]}
    tb = trainer.tensors(case["batch"])
    pts, cols = trainer.points(tb, True, None, draws)
    out = trainer._forward(state, tb, pts, cols, True)
    loss, _, _ = trainer.loss(out, tb)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - case["loss"]) <= LOSS_TOL * abs(case["loss"])
    got = params_to_jax(state.model, {n: p.grad for n, p in
                                      state.model.named_parameters()})
    assert_grads_close(got, case["grads"], GRAD_TOL, ZERO_GRAD_TOL)
    assert_stats_close(module_to_jax(state.model)[1], case["stats"], BN_TOL)
    named = dict(state.model.named_parameters())
    for name in ("segment_embed", "bin_score",
                 "language_encoder.lstm_fwd_w_hh",
                 "block_1.MultiHeadDotProductAttention_0.query.kernel",
                 "block_0.LayerNorm_1.scale", "mlp_offsets.dense_1.weight"):
        assert float(named[name].grad.abs().sum()) > 0, name


def test_train_step_applies_adam(case):
    """``train_step`` (forward, backward, one Adam step): the loss of the
    step above and parameters moved by at most the learning rate."""
    trainer, state = port(case)
    before = {n: p.detach().clone() for n, p in
              state.model.named_parameters()}
    metrics = trainer.train_step(state, case["batch"],
                                 draws={"points": case["points"]})
    assert abs(float(metrics["loss"]) - case["loss"]) <= (
        LOSS_TOL * abs(case["loss"]))
    assert 0.0 <= float(metrics["recall"]) <= 1.0
    moved = max(float((p - before[n]).abs().max()) for n, p in
                state.model.named_parameters())
    assert 0 < moved <= 1.001e-3          # lr, plus a parameter's rounding
    assert state.step == 1


def test_layer_norm_is_flax():
    """ε = 1e-6 and the variance as E[x²] − E[x]², as flax's LayerNorm;
    torch's LayerNorm (ε = 1e-5) is farther."""
    import flax.linen as fnn

    x = np.random.default_rng(0).normal(size=(3, 5, 12)).astype(np.float32)
    x[0, 0] = 3e-3 * x[0, 0] + 0.5           # small variance: ε matters
    want = np.asarray(fnn.LayerNorm().apply(
        {"params": {"scale": jnp.ones(12), "bias": jnp.zeros(12)}},
        jnp.asarray(x)))
    got = LayerNorm(12)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    torch_ln = torch.nn.functional.layer_norm(torch.from_numpy(x), (12,))
    assert np.abs(torch_ln.numpy() - want).max() > 1e-3


def test_init_draws_every_leaf():
    """``init_extra_parameters`` draws what ``init_parameters`` does not:
    no attention kernel or segment embedding is left zero."""
    from text2pos_torch.train.state import init_parameters

    m = init_extra_parameters(init_parameters(TransformerMatch(
        50, 32, num_layers=1, with_aux_heads=True), 0), 1)
    for name, p in m.named_parameters():
        if name.endswith(("kernel", "segment_embed", "weight")) or (
                name.endswith("scale")):
            assert float(p.abs().sum()) > 0, name
    attn = m.block_0.MultiHeadDotProductAttention_0
    assert abs(float(attn.query.kernel.std()) - (1 / 32) ** 0.5) < 0.05
    assert abs(float(m.segment_embed.std()) - 0.02) < 0.01


def test_cli_a_few_steps(capsys):
    """``python -m text2pos_torch.train.transformer --device cpu`` (its
    ``main``) runs a few steps and prints a finite loss."""
    from text2pos_torch.train import transformer

    transformer.main(["--device", "cpu", "--dataset", "SYNTHETIC-FINE",
                      "--epochs", "1", "--batch_size", "4", "--embed_dim",
                      "16", "--num_layers", "1", "--sinkhorn_iters", "5",
                      "--pad_size", "8", "--pointnet_numpoints", "16",
                      "--max_hint_len", "12", "--max_batches", "2"])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("epoch 0 ")][0]
    assert np.isfinite(float(line.split()[3]))
