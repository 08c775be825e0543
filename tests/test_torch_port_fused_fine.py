"""The port's fused fine trainer (``train/fused_fine.py``) against the JAX
package's: a fused epoch of two steps of 6 poses (JAX's ``TINY`` otherwise:
embed 32, 32 points, 8 objects, one block pair, 10 Sinkhorn iterations) on
JAX's points, each step's loss, gradients and BN statistics against JAX's
steps (its own ``_step_core`` compiled without fusion, JAX's second step
after its own Adam update); and the CLI with ``--fused``. Tolerances as PR
7's: loss 1e-5 (relative), gradient leaves 1e-3 (relative L2), BN 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_port_fused import (BN_TOL, GRAD_TOL, LOSS_TOL, TINY,
                                   assert_grads_close, assert_stats_close,
                                   data, fused_cli, jax_step, port_grads)
from text2pos_tpu.config import TrainConfig as JConfig
from text2pos_tpu.ops.transforms import prepare_object_points as jprepare
from text2pos_tpu.train.fused_fine import FusedFineTrainer as JFusedFine
from text2pos_torch.config import TrainConfig
from text2pos_torch.train.fused_fine import FusedFineTrainer
from text2pos_torch.utils.convert_jax import load_jax_params, module_to_jax

FINE = dict(TINY, batch_size=6, num_layers=1, sinkhorn_iters=10, pad_size=8)
assert data  # the corpus fixture


def test_fused_fine_epoch_matches_jax(data):
    """Two steps of a fused fine epoch (6 poses a step) from the same
    weights: each step's loss, gradients and BN statistics against JAX's
    steps (JAX's second step after its own Adam update)."""
    cfg = JConfig(**FINE)
    jt = JFusedFine(cfg, data["vocab"], data["cells"], data["poses"])
    rng = jax.random.PRNGKey(0)
    state = jt.init_state(next(jt.loader.epoch(seed=0)), rng, 2)
    order = np.random.default_rng(0).permutation(13)[:12].reshape(2, 6)
    keys = jax.random.split(jax.random.fold_in(rng, 0), 2)
    ref, draws = [], []
    to_np = lambda t: jax.tree.map(np.asarray, t)
    params0, stats0 = to_np(state.params), to_np(state.batch_stats)
    for s in range(2):
        idx = jnp.asarray(order[s], jnp.int32)
        b = {k: jt.dev[k][idx] for k in ("points_xyz", "points_rgb",
                                         "point_count")}
        pts, cols = jax.jit(lambda b, r: jprepare(
            b["points_xyz"], b["points_rgb"], b["point_count"], 32, r,
            augment=True))(b, keys[s])
        draws.append({"points": (np.asarray(pts), np.asarray(cols))})
        loss, grads, stats = jax_step(jt, state, jt.dev, idx, keys[s])
        ref.append((loss, grads, stats))
        state = state.apply_gradients(jax.tree.map(jnp.asarray, grads),
                                      jax.tree.map(jnp.asarray, stats))

    tr = FusedFineTrainer(TrainConfig(**FINE, device="cpu"), data["pvocab"],
                          data["pcells"], data["pposes"])
    for k in ("hint_tokens", "points_xyz", "all_matches", "offsets"):
        np.testing.assert_array_equal(tr.dev[k].numpy(), np.asarray(
            jt.dev[k]), err_msg=k)
    pstate = tr.init_state(2)
    assert load_jax_params(pstate.model, params0, stats0) == []
    seen = []
    apply = pstate.apply_gradients

    def record():
        seen.append((port_grads(pstate.model),
                     module_to_jax(pstate.model)[1]))
        apply()
    pstate.apply_gradients = record
    _, loss = tr.fused_train_epoch(pstate, 0, draws=draws)
    want = np.mean([r[0] for r in ref])
    assert abs(loss - want) <= LOSS_TOL * abs(want)
    for (g, st), (_, jg, jst) in zip(seen, ref):
        assert_grads_close(g, jg, GRAD_TOL)
        assert_stats_close(st, jst, BN_TOL)
    assert len(seen) == 2


def test_fused_fine_cli_one_epoch(tmp_path):
    fused_cli(tmp_path, "fine", ["--pad_size", "8", "--num_layers", "1",
                                 "--sinkhorn_iters", "5", "--max_hint_len",
                                 "12"])
