"""The object encoder's model variants (``--variation 1``, ``--class_embed``,
``--color_embed``, ``--use_features`` subsets, ``--pointnet_features`` 0 and
1) against the JAX package's, at the tiny configuration of
``test_torch_port_train_coarse.py``: JAX's randomly initialised variables
converted into the port's modules (every leaf used, both ways), one
training step of each stage and the coarse object tower's eval-mode
forward held to JAX's.

The steps and the forward are compared in float64, as the default model's
``test_float64_step_matches_jax``: JAX under ``jax_float64`` on its own
augmentation, the port through ``float64_pins`` on its own augmentation of
JAX's draws. In f32 these variants sit at the edge of the default model's
f32 limits on this batch (the ``lin`` BN's variance over 4 cells 1.1e-5
against 1e-5; a kNN near-tie of two colour embeddings in the colour-only
tower moves a cell by 2.8e-4), so float64 is what holds the function.
Tolerances: loss 1e-12 (relative), gradient leaves 1e-9 (relative L2),
zero-gradient leaves 1e-12 of the global norm, BN statistics 1e-12, the
forward 1e-10. JAX's class-embedding gradient has NaN in row 0 (see
``_class_row0``): that row alone is held to the port's 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_train_coarse import (F64_BN_TOL, F64_GRAD_TOL,
                                          F64_LOSS_TOL, F64_ZERO_GRAD_TOL,
                                          NO_FUSION, TINY, assert_grads_close,
                                          assert_stats_close, corpus,
                                          jax_float64, to_float64)
from test_torch_port_train_fine import loader as fine_loader
from text2pos_tpu.config import TrainConfig as JConfig
from text2pos_tpu.data.hints import Vocabulary as JVocab
from text2pos_tpu.data.hints import build_vocabulary as jbuild_vocabulary
from text2pos_tpu.data.hints import create_hint_description as jhints
from text2pos_tpu.data.loaders import CoarseLoader as JCoarseLoader
from text2pos_tpu.data.loaders import FineLoader as JFineLoader
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.ops.transforms import prepare_object_points as jprepare
from text2pos_tpu.train import losses as jlosses
from text2pos_tpu.train.coarse import CoarseTrainer as JCoarseTrainer
from text2pos_tpu.train.fine import FineTrainer as JFineTrainer
from text2pos_torch.config import TrainConfig, parse_config
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.train.coarse import CoarseTrainer
from text2pos_torch.train.fine import FineTrainer
from text2pos_torch.train.state import TrainState, make_optimizer
from text2pos_torch.utils.convert_jax import (load_jax_params, module_to_jax,
                                              params_to_jax)
from text2pos_torch.utils.float64 import float64_pins

torch.set_num_threads(2)

F64_FORWARD_TOL = 1e-10

COARSE_VARIANTS = {
    "variation1": dict(variation=1),
    "class_embed": dict(class_embed=True),
    "color_embed": dict(color_embed=True),
    "class_position": dict(use_features=("class", "position")),
    "color_only": dict(use_features=("color",)),
    "features0": dict(pointnet_features=0),
    "features1": dict(pointnet_features=1),
}
FINE_VARIANTS = {
    "both_embeds": dict(class_embed=True, color_embed=True),
    "class_position_features1": dict(use_features=("class", "position"),
                                     pointnet_features=1),
}


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix


def _grads(model):
    return params_to_jax(model, {n: p.grad for n, p in
                                 model.named_parameters()})


def _class_row0(want, got):
    """JAX's gradient of the class embedding's row 0 (unknown class, the
    flat buffer's padding tail) is NaN: the row is zeroed, and the norm's
    derivative at 0 is 0/0 (``jnp.linalg.norm``), which the mask's 0 does
    not cancel; torch's norm takes 0 there. Only that row: the port's is 0
    (the row never reaches an output), every other entry is compared."""
    emb = want.get("object_encoder", {}).get("class_embedding")
    if emb is None:
        return want
    w = np.array(emb["embedding"])
    g = np.asarray(got["object_encoder"]["class_embedding"]["embedding"])
    assert np.isfinite(g).all()
    assert np.isfinite(np.delete(w, 0, axis=0)).all()
    if not np.isfinite(w[0]).all():
        assert (g[0] == 0).all()
        w[0] = 0
    emb = dict(emb, embedding=w)
    oe = dict(want["object_encoder"], class_embedding=emb)
    return dict(want, object_encoder=oe)


@pytest.fixture(scope="module")
def data():
    cells, poses = corpus(jsynthetic)
    vocab = JVocab(jbuild_vocabulary([jhints(p) for p in poses]))
    return cells, poses, vocab


def _jax_step64(model_apply_loss, params, batch_stats):
    """JAX's float64 step (compiled without fusion): (loss, stats,
    grads) as numpy trees."""
    params = to_float64(params)
    vg = jax.jit(jax.value_and_grad(
        lambda p: model_apply_loss(p, to_float64(batch_stats)),
        has_aux=True)).lower(params).compile(compiler_options=NO_FUSION)
    (loss, aux), grads = vg(params)
    stats = aux[0] if isinstance(aux, tuple) else aux
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return float(loss), to_np(stats), to_np(grads)


def _draws64(rng, jb, num):
    """JAX's float64 draws (sample indices, angles) of its augmentation
    from ``rng`` over objects of ``jb``'s leading shape."""
    k_sample, k_rot = jax.random.split(rng)
    lead = jb["points_xyz"].shape[:-2]
    u = jax.random.uniform(k_sample, lead + (num,))
    idx = jnp.clip(jnp.floor(u * jb["point_count"][..., None]).astype(
        jnp.int32), 0, jb["points_xyz"].shape[-2] - 1)
    deg = jax.random.uniform(k_rot, lead, minval=-120.0, maxval=120.0)
    return np.asarray(idx), np.asarray(deg)


def _coarse_case(data, opts):
    """JAX's coarse trainer with ``opts``: its f32 variables, a training
    batch, its float64 step on its own augmentation, the float64 draws of
    that augmentation over the valid objects, and the float64 eval-mode
    object tower on those points."""
    cells, poses, vocab = data
    loader = JCoarseLoader(cells, poses, vocab, 4, 16, 32, 48,
                           shuffle_hints=True, flip_poses=True, seed=0)
    trainer = JCoarseTrainer(JConfig(**TINY, **opts), vocab)
    rng = jax.random.PRNGKey(0)
    state = trainer.init_state(next(loader.epoch(seed=0)), rng, 5)
    batch = next(loader.epoch(seed=1))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    valid = batch["flat_valid"].astype(bool)
    out = dict(batch=batch, valid=valid, params=to_np(state.params),
               batch_stats=to_np(state.batch_stats))
    with jax_float64():
        jb = {k: to_float64(v) for k, v in batch.items()
              if k not in ("num_real", "pose_idx")}
        step_rng = jax.random.fold_in(rng, 0)
        pts, cols = jprepare(jb["points_xyz"], jb["points_rgb"],
                             jb["point_count"], 32, step_rng, augment=True)
        args = (pts, cols, jb["centers"], jb["colors"], jb["class_idx"],
                jb["color_idx"], jb["flat_valid"], jb["cell_idx"],
                jb["slot_idx"], 4, 16)

        def loss_fn(params, stats):
            (text, cells_), upd = trainer.model.apply(
                {"params": params, "batch_stats": stats},
                jb["tokens"], jb["lengths"], *args, train=True,
                mutable=["batch_stats"])
            return jlosses.pairwise_ranking_loss(text, cells_, 0.35), \
                upd["batch_stats"]

        out["loss"], out["stats"], out["grads"] = _jax_step64(
            loss_fn, out["params"], out["batch_stats"])
        idx, deg = _draws64(step_rng, jb, 32)
        out["draws"] = {"idx": idx[valid], "angles": deg[valid]}
        out["points"] = (np.asarray(pts)[valid], np.asarray(cols)[valid])
        out["cell_enc"] = np.asarray(trainer.model.apply(
            {"params": to_float64(state.params),
             "batch_stats": to_float64(state.batch_stats)}, *args,
            train=False, method=trainer.model.encode_objects))
    return out


def _port(cls, data, case, opts):
    cfg = TrainConfig(**TINY, **opts, device="cpu")
    trainer = cls(cfg, Vocabulary(data[2].known_words))
    assert load_jax_params(trainer.model, case["params"],
                           case["batch_stats"]) == []
    # Both ways: the port's trees hold exactly JAX's leaves.
    params, stats = module_to_jax(trainer.model)
    assert set(_leaf_paths(params)) == set(_leaf_paths(case["params"]))
    assert set(_leaf_paths(stats)) == set(_leaf_paths(case["batch_stats"]))
    return trainer, TrainState(trainer.model,
                               make_optimizer(trainer.model, 1e-3))


def _step64(trainer, state, batch, draws):
    with float64_pins():
        state.model.double()
        out = trainer.forward_backward(state, batch, draws=draws)
        loss = out[0] if isinstance(out, tuple) else out
        return (float(loss), _grads(state.model),
                module_to_jax(state.model)[1])


def _check_step(got, case):
    loss, grads, stats = got
    assert abs(loss - case["loss"]) <= F64_LOSS_TOL * abs(case["loss"])
    assert_grads_close(grads, _class_row0(case["grads"], grads),
                       F64_GRAD_TOL, F64_ZERO_GRAD_TOL)
    assert_stats_close(stats, case["stats"], F64_BN_TOL)


@pytest.mark.parametrize("name", sorted(COARSE_VARIANTS))
def test_coarse_variant_step_and_forward_match_jax(data, name):
    opts = COARSE_VARIANTS[name]
    case = _coarse_case(data, opts)
    trainer, state = _port(CoarseTrainer, data, case, opts)
    oe = state.model.object_encoder
    assert hasattr(oe, "pointnet") != bool(opts.get("class_embed"))
    _check_step(_step64(trainer, state, case["batch"], case["draws"]), case)

    # The eval-mode object tower on JAX's variables and points.
    trainer, state = _port(CoarseTrainer, data, case, opts)
    b, v = case["batch"], case["valid"]
    t = lambda k: torch.from_numpy(np.asarray(b[k])[v])
    with torch.no_grad(), float64_pins():
        got = state.model.double().eval().encode_objects(
            *map(torch.from_numpy, case["points"]), t("centers").double(),
            t("colors").double(), t("cell_idx").long(), t("slot_idx").long(),
            4, 16, t("class_idx"), t("color_idx"))
    np.testing.assert_allclose(got.numpy(), case["cell_enc"], rtol=0,
                               atol=F64_FORWARD_TOL)


@pytest.mark.parametrize("name", sorted(FINE_VARIANTS))
def test_fine_variant_step_matches_jax(data, name):
    opts = FINE_VARIANTS[name]
    cells, poses, vocab = data
    jl = fine_loader(cells, poses, vocab, JFineLoader)
    trainer = JFineTrainer(JConfig(**TINY, **opts), vocab)
    rng = jax.random.PRNGKey(0)
    state = trainer.init_state(next(jl.epoch(seed=0)), rng, 5)
    batch = next(jl.epoch(seed=1))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    case = dict(params=to_np(state.params),
                batch_stats=to_np(state.batch_stats))
    with jax_float64():
        jb = {k: to_float64(v) for k, v in batch.items()
              if k not in ("num_real", "pose_idx")}
        step_rng = jax.random.fold_in(rng, 7)
        pts, cols = trainer._prep(jb, step_rng, augment=True)
        case["loss"], case["stats"], case["grads"] = _jax_step64(
            lambda p, st: trainer._loss_fn(p, st, jb, pts, cols),
            case["params"], case["batch_stats"])
        idx, deg = _draws64(step_rng, jb, 32)
    ptrainer, pstate = _port(FineTrainer, data, case, opts)
    _check_step(_step64(ptrainer, pstate, batch,
                        {"idx": idx, "angles": deg}), case)


@pytest.mark.parametrize("flags,attrs", [
    (["--variation", "1"], {"graph1.pool": "masked_mean"}),
    (["--class_embed"], {"object_encoder.class_embedding": "Embedding"}),
    (["--color_embed"], {"object_encoder.color_embedding": "Embedding"}),
    (["--use_features", "class", "position"],
     {"object_encoder.use_features": "('class', 'position')"}),
    (["--pointnet_features", "0"],
     {"object_encoder.mlp_pointnet.dense_0.in_features": "1024"}),
])
def test_variant_flags_build_their_modules(flags, attrs):
    """The trainers take the variant flags (``check_ported`` refuses none
    of them) and build the modules JAX's flags build."""
    cfg = parse_config(TrainConfig, ["--device", "cpu", "--embed_dim", "32",
                                     *flags])
    model = CoarseTrainer(cfg, Vocabulary(["a"])).model
    for path, want in attrs.items():
        obj = model
        for part in path.split("."):
            obj = getattr(obj, part)
        got = (obj.__name__ if callable(obj) and hasattr(obj, "__name__")
               else type(obj).__name__ if isinstance(obj, torch.nn.Module)
               else str(obj))
        assert got == want, (path, got)


def test_id_variants_need_the_ids():
    """An encoder that embeds ids raises without them (no quiet zeros)."""
    from text2pos_torch.models.object_encoder import ObjectEncoder

    enc = ObjectEncoder(16, class_embed=True)
    assert enc.needs_ids and not hasattr(enc, "pointnet")
    x = torch.zeros(3, 8, 3)
    with pytest.raises(ValueError, match="class_idx"):
        enc(x, x, torch.zeros(3, 3), torch.zeros(3, 3))
    out = enc.eval()(x, x, torch.zeros(3, 3), torch.zeros(3, 3),
                     torch.tensor([0, 2, 3]), torch.tensor([1, 1, 4]))
    assert out.shape == (3, 16) and bool(torch.isfinite(out).all())
