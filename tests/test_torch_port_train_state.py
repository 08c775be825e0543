"""The port's training state against the JAX package's: the msgpack writer
(flax's bytes), Adam (``optax.adam`` with its schedules and frozen group,
and optax's state-dict layout), checkpoints and resume files across the two
packages, the port's own resume (bit for bit on the CPU), the kernels'
weight caches after an optimizer step, and the kernel wrappers' refusal to
drop gradients."""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from text2pos_tpu.config import TrainConfig as JConfig
from text2pos_tpu.data.synthetic import make_synthetic_dataset as jsynthetic
from text2pos_tpu.train import state as jstate
from text2pos_torch.config import TrainConfig
from text2pos_torch.data.hints import Vocabulary
from text2pos_torch.data.synthetic import make_synthetic_dataset
from text2pos_torch.models.cell_retrieval import CellRetrievalNetwork
from text2pos_torch.ops import _build
from text2pos_torch.train import state as tstate
from text2pos_torch.utils import msgpack_io
from text2pos_torch.utils.convert_jax import (jax_to_params, load_jax_params,
                                              module_to_jax)

torch.set_num_threads(2)

TINY = dict(batch_size=4, embed_dim=32, num_layers=2, sinkhorn_iters=10,
            pointnet_numpoints=32, coarse_max_objects=16, pad_size=8,
            num_mentioned=6, max_text_len=48, max_hint_len=12)


def _tree_equal(a, b, path=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), (path, a, b)
        for k in b:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def test_msgpack_writer_gives_flax_bytes(monkeypatch):
    rng = np.random.default_rng(0)
    tree = {"b": {"k": rng.standard_normal((3, 4)).astype(np.float32),
                  "i": np.arange(5, dtype=np.int32)},
            "a": [1, 200, -70000, 2 ** 40, 0.5, "x" * 40, None, True,
                  np.float32(2.5), np.asarray(3, np.int32), {"z": {}}],
            "extra": {"val_acc": 0.875, "known_words": ["red", "car"]}}
    assert msgpack_io.msgpack_serialize(tree) == \
        flax.serialization.msgpack_serialize(tree)
    big = {"x": np.arange(50, dtype=np.float32)}
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    data = msgpack_io.msgpack_serialize(big)
    assert data == flax.serialization.msgpack_serialize(big)
    np.testing.assert_array_equal(
        msgpack_io.msgpack_restore(data)["x"], big["x"])


@pytest.fixture(scope="module")
def model_and_params():
    model = CellRetrievalNetwork(11, 32, pointnet_heads=(23, 9))
    tstate.init_parameters(model, 3)
    return model, module_to_jax(model)


@pytest.mark.parametrize("kind", ["constant", "decay", "warmup", "freeze"])
def test_adam_matches_optax(kind, model_and_params):
    """Three steps on the same gradients: parameters within 1e-6 (relative
    to each leaf's scale) of optax's, and the optimizer state in optax's
    state-dict layout with the same moments and counts."""
    _, (params, stats) = model_and_params
    model = CellRetrievalNetwork(11, 32, pointnet_heads=(23, 9))
    load_jax_params(model, params, stats)
    if kind == "warmup":
        from text2pos_torch.train.fine import warmup_schedule

        def jsched(step):
            base = jnp.where(step < 3 * 2, 1e-5, 1e-3)
            return base * (0.9 ** (step // 2))
        tx = optax.adam(jsched)
        opt = tstate.make_optimizer(model, 0.0, schedule=warmup_schedule(
            1e-3, 0.9, 2))
    else:
        freeze = ("object_encoder/pointnet",) if kind == "freeze" else ()
        gamma = 1.0 if kind == "constant" else 0.9
        tx = jstate.make_optimizer(1e-3, gamma, 1, params=params,
                                   freeze_paths=freeze)
        opt = tstate.make_optimizer(model, 1e-3, gamma, 1,
                                    freeze_paths=freeze)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    rng = np.random.default_rng(1)
    for step in range(3):
        grads = jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32)
            * (1e-4 if step == 1 else 1.0), params)
        upd, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        named = dict(model.named_parameters())
        for name, g in jax_to_params(model, grads).items():
            named[name].grad = g
        opt.step()

    def close(a, b, path=""):
        if isinstance(b, dict):
            for k in b:
                close(a[k], b[k], f"{path}/{k}")
            return
        b = np.asarray(b)
        err = np.abs(np.asarray(a) - b).max() / max(1.0, np.abs(b).max())
        assert err <= 1e-6, (path, err)
    close(module_to_jax(model)[0], jparams)
    want = flax.serialization.to_state_dict(jax.device_get(opt_state))
    got = opt.to_optax(model)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    close(got, want)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """JAX's tiny coarse run: a resume file after epoch 1 and the state of
    a straight 2-epoch run."""
    from text2pos_tpu.train import coarse as jcoarse

    d = tmp_path_factory.mktemp("runs")
    cells, poses = [], []
    for s in (0, 1):
        c, p = jsynthetic(seed=s, scene_name=f"999{s}", extent=60.0,
                          num_mentioned=6, poses_per_cell=3)
        cells += c
        poses += p
    quiet = lambda *a: None
    resume = str(d / "resume.msgpack")
    jcoarse.train(JConfig(**TINY, epochs=1, resume_path=resume), cells,
                  poses, cells, poses, checkpoint_dir=str(d), log=quiet)
    state2, res2 = jcoarse.train(JConfig(**TINY, epochs=2), cells, poses,
                                 cells, poses, checkpoint_dir=str(d),
                                 log=quiet)
    return dict(dir=d, resume=resume, cells=cells, poses=poses,
                straight=state2, vocab=res2["vocab"],
                loss2=res2["history"]["train_loss"][1])


def _port_coarse(tiny_runs, **kw):
    from text2pos_torch.train.coarse import CoarseTrainer

    cfg = TrainConfig(**TINY, device="cpu", **kw)
    trainer = CoarseTrainer(cfg, Vocabulary(tiny_runs["vocab"].known_words))
    return trainer, trainer.init_state(6)


def test_jax_resume_file_resumes_in_the_port(tiny_runs, tmp_path):
    """The port reads JAX's resume file (params, BN, Adam's moments and
    count, progress), writes one JAX reads back equal, and continues
    JAX's run: epoch 2 on JAX's batches and points has a mean loss within
    1e-3 (relative) of JAX's straight run's (JAX's jitted steps drop part
    of the max-poolings' gradients, so the trajectories part a little)."""
    from text2pos_tpu.data.loaders import CoarseLoader as JLoader
    from text2pos_tpu.ops.transforms import prepare_object_points as jprep

    trainer, state = _port_coarse(tiny_runs)
    state, epoch, best_acc, best_path = tstate.load_resume_checkpoint(
        tiny_runs["resume"], state)
    with open(tiny_runs["resume"], "rb") as f:
        payload = flax.serialization.msgpack_restore(f.read())
    assert epoch == 1 and state.step == payload["step"] > 0
    _tree_equal(module_to_jax(state.model)[0], payload["params"])
    _tree_equal(state.optimizer.to_optax(state.model), payload["opt_state"])

    out = str(tmp_path / "port_resume.msgpack")
    tstate.save_resume_checkpoint(out, state, epoch, best_acc, best_path)
    from text2pos_tpu.train.coarse import CoarseTrainer as JTrainer

    jt = JTrainer(JConfig(**TINY), tiny_runs["vocab"])
    jl = JLoader(tiny_runs["cells"], tiny_runs["poses"], tiny_runs["vocab"],
                 4, 16, 32, 48, shuffle_hints=True, flip_poses=True, seed=0)
    jstate0 = jt.init_state(next(jl.epoch(seed=0)), jax.random.PRNGKey(0), 6)
    back, e2, _, _ = jstate.load_resume_checkpoint(out, jstate0)
    assert e2 == 1
    _tree_equal(back.params, payload["params"])
    _tree_equal(flax.serialization.to_state_dict(back.opt_state),
                payload["opt_state"])

    rng = jax.random.PRNGKey(0)
    prep = jax.jit(lambda b, r: jprep(b["points_xyz"], b["points_rgb"],
                                      b["point_count"], 32, r, augment=True))
    losses = []
    for i, batch in enumerate(jl.epoch(seed=2)):
        jb = {k: jnp.asarray(batch[k]) for k in ("points_xyz", "points_rgb",
                                                 "point_count")}
        pts, cols = prep(jb, jax.random.fold_in(rng, i))
        valid = batch["flat_valid"].astype(bool)
        losses.append(float(trainer.train_step(state, batch, draws={
            "points": (np.asarray(pts)[valid], np.asarray(cols)[valid])})))
    assert abs(np.mean(losses) - tiny_runs["loss2"]) <= \
        1e-3 * abs(tiny_runs["loss2"])


def test_port_checkpoint_serves_in_jax(tiny_runs, tmp_path):
    """``save_checkpoint`` writes what JAX's ``load_checkpoint`` and
    ``restore_variables`` read, and JAX encodes the same with it."""
    from text2pos_tpu.train.coarse import build_model

    trainer, state = _port_coarse(tiny_runs)
    tstate.load_variables(state.model, tstate.restore_variables(
        tiny_runs["resume"]))
    path = str(tmp_path / "c.msgpack")
    tstate.save_checkpoint(path, state, extra={"val_acc": 0.5,
                                               "known_words": ["a", "b"]})
    payload = jstate.load_checkpoint(path)
    assert payload["extra"] == {"val_acc": 0.5, "known_words": ["a", "b"]}
    variables = jstate.restore_variables(path)
    want = jstate.restore_variables(tiny_runs["resume"])
    _tree_equal(variables, want)
    model = build_model(JConfig(**TINY), tiny_runs["vocab"].size)
    tok = jnp.asarray(np.random.default_rng(0).integers(0, 5, (3, 9)),
                      jnp.int32)
    ln = jnp.asarray([9, 4, 1], jnp.int32)
    enc = lambda v: np.asarray(model.apply(v, tok, ln,
                                           method=model.encode_text))
    np.testing.assert_array_equal(enc(variables), enc(want))


def test_port_resume_equals_straight_run(tiny_runs, tmp_path):
    """Bit for bit on the CPU: 2 epochs straight against 1 epoch, a resume
    file, and the second epoch from it."""
    from text2pos_torch.train import coarse

    cells, poses = [], []
    for s in (0, 1):
        c, p = make_synthetic_dataset(seed=s, scene_name=f"999{s}",
                                      extent=60.0, num_mentioned=6,
                                      poses_per_cell=3)
        cells += c
        poses += p
    quiet = lambda *a: None
    resume = str(tmp_path / "r.msgpack")
    kw = dict(**TINY, device="cpu")
    coarse.train(TrainConfig(epochs=1, resume_path=resume, **kw), cells,
                 poses, cells, poses, checkpoint_dir=str(tmp_path), log=quiet)
    resumed, _ = coarse.train(TrainConfig(epochs=2, resume_path=resume, **kw),
                              cells, poses, cells, poses,
                              checkpoint_dir=str(tmp_path), log=quiet)
    straight, _ = coarse.train(TrainConfig(epochs=2, **kw), cells, poses,
                               cells, poses, checkpoint_dir=str(tmp_path),
                               log=quiet)
    assert resumed.step == straight.step > 0
    for (n, a), b in zip(resumed.model.state_dict().items(),
                         straight.model.state_dict().values()):
        assert torch.equal(a, b), n
    _tree_equal(resumed.optimizer.to_optax(resumed.model),
                straight.optimizer.to_optax(straight.model))


def test_kernel_caches_follow_an_optimizer_step():
    """``SetAbstraction.w2_fragments`` and ``SuperGlue.packed_kernel_params``
    change after an in-place ``optimizer.step()`` and equal a fresh pack."""
    from text2pos_torch.models.pointnet2 import SetAbstraction
    from text2pos_torch.models.superglue import SuperGlue
    from text2pos_torch.ops import pointconv as tpc

    sa = SetAbstraction(3, 0.5, 0.2, (32, 64), torch.bfloat16)
    sg = SuperGlue(128, num_layers=1, stat_groups=2)
    for mod in (sa, sg):
        tstate.init_parameters(mod, 0)
    f, p = sa.w2_fragments(), sg.packed_kernel_params()
    params = [*sa.parameters(), *sg.parameters()]
    opt = torch.optim.SGD(params, lr=0.1)
    for q in params:
        q.grad = torch.ones_like(q)
    opt.step()
    f2, p2 = sa.w2_fragments(), sg.packed_kernel_params()
    assert not torch.equal(f2, f)
    assert torch.equal(f2, tpc.w2_fragments(
        sa.conv_mlp.dense_1.weight.detach().t().to(torch.bfloat16)))
    assert not torch.equal(p2["wqkv"], p["wqkv"])
    sg._packed = None
    fresh = sg.packed_kernel_params()
    for k in fresh:
        assert torch.equal(p2[k], fresh[k]), k
    with torch.no_grad():
        sg.gnn.layer_0.mlp.bn_0.running_mean.add_(1.0)
    assert not torch.equal(sg.packed_kernel_params()["t0"], fresh["t0"])


def _wrapper_calls():
    from text2pos_torch.ops import lstm, pointconv, sinkhorn, superglue_gnn

    leaf = lambda *s: torch.zeros(*s, requires_grad=True)
    E, T0, T1 = superglue_gnn.KERNEL_SHAPE
    packed = superglue_gnn.pack_gnn_params(
        superglue_gnn.random_folded_params(1, width=E), torch.float32, "cpu")
    return {
        "lstm": lambda: lstm._lstm_kernel(
            [leaf(5, 128)] * 2, [leaf(32, 128)] * 2,
            torch.zeros(2, 3, dtype=torch.int32), torch.ones(2)),
        "lot": lambda: sinkhorn._lot_kernel(leaf(2, 3, 4), leaf(()), 5),
        "sinkhorn": lambda: sinkhorn._sinkhorn_kernel(
            leaf(2, 4, 5), torch.zeros(2, 4), torch.zeros(2, 5), 5),
        "pointconv": lambda: pointconv._pointconv_kernel(
            leaf(2, 8, 32), torch.zeros(2, 8, 3), torch.zeros(2, 4, 32),
            torch.zeros(2, 4, 3), (torch.ones(32), torch.zeros(32)),
            torch.zeros(32, 64), torch.zeros(64),
            (torch.ones(64), torch.zeros(64)), 0.2, 32),
        "gnn": lambda: superglue_gnn._gnn_kernel(
            leaf(2, T0, E), torch.zeros(2, T1, E), packed),
    }


@pytest.mark.parametrize("name", ["lstm", "lot", "sinkhorn", "pointconv",
                                  "gnn"])
def test_kernel_wrappers_refuse_to_drop_gradients(name, monkeypatch):
    """Called directly on an input that requires grad, with grad mode on,
    each wrapper raises before it builds or launches anything."""
    def no_build(*a, **k):
        raise AssertionError("the wrapper reached the build")

    monkeypatch.setattr(_build, "entry", no_build)
    call = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="requires grad"):
        call()
