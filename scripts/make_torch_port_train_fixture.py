"""Write the training fixture that ``chip_smoke.py``'s phase 7 holds the
PyTorch port's training against: ``text2pos_torch/fixtures/
bench_train_step.npz``.

JAX on the CPU, at the sizes of the committed checkpoints' recipe
(``scripts/train_bench_ckpts.py``): coarse batch 64, embed 256, 24 object
slots, 256 points, pairwise loss, margin 0.35; fine batch 32, embed 128, 6
block pairs, 50 Sinkhorn iterations, pad 16, 6 hints. The data are the
recipe's: training scene seed 100 (tag "7", 3 poses a cell) and the seed-77
validation scene (1 pose a cell), with the checkpoints' vocabulary.

- One training step of each stage from the committed checkpoints: the
  first batch of epoch 1 of ``CoarseLoader`` / ``FineLoader`` (seed 0;
  batches of 32 cells and 16 poses, half the recipe's, for the CPU's
  memory),
  points prepared by JAX from ``fold_in(PRNGKey(0), 0)``, and
  ``jax.value_and_grad`` of ``CoarseTrainer.train_step``'s and
  ``FineTrainer._loss_fn``'s loss over ``model.apply``, run op by op: under
  ``jax.jit`` XLA's CPU backend recomputes activations inside the backward's
  fusions with other fused multiply-adds than the forward's, and the
  max-poolings' gradients drop entries (compiled with the fusion pass off,
  the coarse step needs more than 24 GB). Stored: the
  batch's tokens and pose indices, the draws (sample indices as uint8, as
  each object stores 256 points, and angles in degrees, over the valid
  objects), the loss, every gradient
  leaf's L2 norm, the full gradient of ``w_hh`` (both directions), of the
  last MLP's kernel and of ``bin_score``, and every BN running statistic
  after the step.
- The evaluation of each checkpoint on the validation scene: coarse top-k
  and close-by accuracy as ``CoarseTrainer.eval_epoch`` (cell steps of 64,
  keys ``fold_in(PRNGKey(0), i)``), fine recall, precision and pose errors
  as ``FineTrainer.run_epoch(train=False)`` at epoch 0, with their draws.

Every array is named ``{coarse,fine}_...``; names are listed in
``fixture["names"]`` style pairs ``*_leaf_names`` / ``*_leaf_norms``. The
script adds only the arrays the file lacks and keeps the others byte for
byte (delete the file to write it anew). It imports JAX and the JAX package
and is not part of the port. Run from the repository root (a few minutes;
it stops itself above 24 GB of resident memory):

    JAX_PLATFORMS=cpu python scripts/make_torch_port_train_fixture.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "text2pos_torch", "fixtures", "bench_train_step.npz")
# The steps' batches: half the recipe's, so that JAX's reference on the CPU
# stays under 24 GB (op by op, the selection tensors of the recipe's
# batches need more).
COARSE_STEP_BATCH = 32
FINE_STEP_BATCH = 16     # half the recipe's 32 poses, likewise
CKPT = {s: os.path.join(ROOT, "checkpoints", f"bench_{s}.msgpack")
        for s in ("coarse", "fine")}
RECIPE = dict(coarse=dict(batch_size=64, embed_dim=256, learning_rate=1e-3,
                          lr_gamma=0.9, coarse_max_objects=24,
                          pointnet_numpoints=256, pad_size=16,
                          num_mentioned=6),
              fine=dict(batch_size=32, embed_dim=128, learning_rate=3e-4,
                        num_layers=6, sinkhorn_iters=50,
                        coarse_max_objects=24, pointnet_numpoints=256,
                        pad_size=16, num_mentioned=6))


def corpus():
    from text2pos_tpu.data.synthetic import make_synthetic_dataset

    train = make_synthetic_dataset(
        seed=100, scene_name="7100", extent=30.0 * 16, cell_size=30.0,
        poses_per_cell=3, objects_per_cell_area=12)
    val = make_synthetic_dataset(
        seed=77, scene_name="7077", extent=30.0 * 16, cell_size=30.0,
        poses_per_cell=1, objects_per_cell_area=12)
    return train, val


def flat(tree, prefix=""):
    """[(path, leaf)] of a nested dict, paths '/'-joined, sorted."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flat(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, np.asarray(tree))]


def draws(rng, lead, num, count, stored, augment):
    """JAX's sample indices (and angles with ``augment``) of
    ``prepare_object_points(rng)`` over objects of leading shape ``lead``."""
    import jax
    import jax.numpy as jnp

    k_sample, k_rot = jax.random.split(rng)
    u = jax.random.uniform(k_sample, lead + (num,))
    idx = jnp.clip(jnp.floor(u * jnp.asarray(count)[..., None]).astype(
        jnp.int32), 0, stored - 1)
    deg = jax.random.uniform(k_rot, lead, minval=-120.0, maxval=120.0)
    idx = np.asarray(idx)
    assert idx.max() < 256       # stored points per object: 256
    return idx.astype(np.uint8), np.asarray(deg, np.float32)


def step_arrays(stage, loss, grads, stats):
    """The stored summary of one step's gradients and statistics."""
    g = flat(grads)
    s = flat(stats)
    out = {f"{stage}_loss": np.float32(loss),
           f"{stage}_leaf_names": np.array([p for p, _ in g]),
           f"{stage}_leaf_norms": np.array(
               [np.linalg.norm(v.astype(np.float64)) for _, v in g]),
           f"{stage}_stat_names": np.array([p for p, _ in s]),
           f"{stage}_stats": np.concatenate([v.ravel() for _, v in s]
                                            ).astype(np.float32),
           f"{stage}_stat_sizes": np.array([v.size for _, v in s])}
    full = dict(g)
    for key in ("language_encoder/lstm_fwd_w_hh",
                "language_encoder/lstm_bwd_w_hh", "lin/dense_1/kernel",
                "superglue/bin_score", "mlp_offsets/dense_1/kernel"):
        if key in full:
            out[f"{stage}_grad/{key}"] = full[key].astype(np.float32)
    return out


def coarse_arrays(train, val, vocab):
    import jax
    import jax.numpy as jnp

    from text2pos_tpu.config import TrainConfig
    from text2pos_tpu.data.dense import flatten_bank_slice
    from text2pos_tpu.data.loaders import CoarseLoader
    from text2pos_tpu.ops.retrieval import topk_retrieval
    from text2pos_tpu.ops.transforms import prepare_object_points
    from text2pos_tpu.train.coarse import CoarseTrainer
    from text2pos_tpu.train.losses import pairwise_ranking_loss
    from text2pos_tpu.train.state import TrainState, restore_variables

    cfg = TrainConfig(**RECIPE["coarse"])
    trainer = CoarseTrainer(cfg, vocab)
    v = restore_variables(CKPT["coarse"])
    state = TrainState.create_eval(v["params"], v["batch_stats"])
    loader = CoarseLoader(*train, vocab, COARSE_STEP_BATCH, 24, 256, 64,
                          shuffle_hints=True, flip_poses=True, seed=0)
    batch = next(loader.epoch(seed=cfg.seed * 10_000 + 1))
    valid = batch["flat_valid"].astype(bool)
    nv = int(valid.sum())
    assert valid[:nv].all()
    # The padding tail changes no valid output; leaving it out halves the
    # selection tensors.
    jb = {k: jnp.asarray(batch[k][:nv] if batch[k].shape[:1] == valid.shape
                         else batch[k])
          for k in batch if k not in ("num_real", "pose_idx")}
    rng = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0)
    # The draws cover the whole flat buffer, as the step draws them.
    pts, cols = jax.jit(lambda b, r: prepare_object_points(
        b["points_xyz"], b["points_rgb"], b["point_count"], 256, r,
        augment=True))({k: jnp.asarray(batch[k]) for k in (
            "points_xyz", "points_rgb", "point_count")}, rng)
    pts, cols = pts[:nv], cols[:nv]

    def loss_fn(params):
        (text, cells), upd = trainer.model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            jb["tokens"], jb["lengths"], pts, cols, jb["centers"],
            jb["colors"], jb["class_idx"], jb["color_idx"], jb["flat_valid"],
            jb["cell_idx"], jb["slot_idx"], COARSE_STEP_BATCH, 24, train=True,
            mutable=["batch_stats"])
        return pairwise_ranking_loss(text, cells, cfg.margin), \
            upd["batch_stats"]

    t0 = time.time()
    (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        state.params)
    print(f"coarse step: {nv} objects, loss {float(loss):.6f} "
          f"({time.time() - t0:.0f} s)", flush=True)
    idx, deg = draws(rng, batch["points_xyz"].shape[:-2], 256,
                     batch["point_count"], batch["points_xyz"].shape[-2],
                     True)
    out = {"coarse_tokens": batch["tokens"],
           "coarse_lengths": batch["lengths"],
           "coarse_pose_idx": batch["pose_idx"],
           "coarse_idx": idx[valid], "coarse_angles": deg[valid]}
    out.update(step_arrays("coarse", float(loss), grads, stats))

    # Evaluation as eval_epoch: every query, cells in steps of 64.
    t0 = time.time()
    vloader = CoarseLoader(*val, vocab, 64, 24, 256, 64, flat_cap=cfg.flat_cap,
                           seed=0)
    text = trainer.encode_all_queries(state, vloader)
    bank = vloader.bank
    key = jax.random.PRNGKey(cfg.seed)
    prep = jax.jit(lambda b, r: prepare_object_points(
        b["points_xyz"], b["points_rgb"], b["point_count"], 256, r,
        augment=False))
    enc_cells = jax.jit(lambda p, c, b, n: trainer.model.apply(
        {"params": state.params, "batch_stats": state.batch_stats}, p, c,
        b["centers"], b["colors"], b["class_idx"], b["color_idx"],
        b["flat_valid"], b["cell_idx"], b["slot_idx"], n, 24, train=False,
        method=type(trainer.model).encode_objects), static_argnums=(3,))
    cell_enc, eval_idx = [], []
    for i in range(0, bank.num_cells, 64):
        cells = np.arange(i, min(i + 64, bank.num_cells))
        fb = flatten_bank_slice(bank, cells, cfg.flat_cap)
        r = jax.random.fold_in(key, i)
        ii, _ = draws(r, fb["points_xyz"].shape[:-2], 256, fb["point_count"],
                      fb["points_xyz"].shape[-2], False)
        v_ = fb["flat_valid"].astype(bool)
        eval_idx.append(ii[v_])
        p_, c_ = prep({k: jnp.asarray(fb[k]) for k in
                       ("points_xyz", "points_rgb", "point_count")}, r)
        # Eight cells a call keep the selection tensors small; in eval mode
        # a cell's encoding does not depend on the others.
        for j in range(0, len(cells), 8):
            sel = (fb["cell_idx"] >= j) & (fb["cell_idx"] < j + 8) & v_
            sub = {k: jnp.asarray(fb[k][sel]) for k in fb}
            sub["cell_idx"] = sub["cell_idx"] - j
            n = int(min(8, len(cells) - j))
            cell_enc.append(np.asarray(enc_cells(p_[sel], c_[sel], sub, n)))
    cell_enc = np.concatenate(cell_enc)
    _, top = topk_retrieval(jnp.asarray(text), jnp.asarray(cell_enc), 5)
    top = np.asarray(top)
    hit = top == vloader.pose_cell_idx[:, None]
    centers = 0.5 * (bank.bbox_w[:, 0:2] + bank.bbox_w[:, 3:5])
    pose_w = np.array([p.pose_w[0:2] for p in vloader.poses])
    dist = np.linalg.norm(centers[top] - pose_w[:, None], axis=2)
    acc = [float(np.mean(hit[:, :k].any(1))) for k in (1, 3, 5)]
    close = [float(np.mean((dist[:, :k] <= bank.cell_size[0] / 2).any(1)))
             for k in (1, 3, 5)]
    print(f"coarse eval: top-1/3/5 {acc}, close {close}, "
          f"{len(top)} queries ({time.time() - t0:.0f} s)", flush=True)
    offsets = np.cumsum([0] + [len(x) for x in eval_idx])
    out.update({"coarse_eval_acc": np.array(acc),
                "coarse_eval_close": np.array(close),
                "coarse_eval_top_idx": top.astype(np.int32),
                "coarse_eval_idx": np.concatenate(eval_idx),
                "coarse_eval_offsets": offsets})
    return out


def fine_arrays(train, val, vocab):
    import jax
    import jax.numpy as jnp

    from text2pos_tpu.config import TrainConfig
    from text2pos_tpu.data.loaders import FineLoader
    from text2pos_tpu.train.fine import FineTrainer
    from text2pos_tpu.train.state import TrainState, restore_variables

    cfg = TrainConfig(**RECIPE["fine"])
    trainer = FineTrainer(cfg, vocab)
    v = restore_variables(CKPT["fine"])
    state = TrainState.create_eval(v["params"], v["batch_stats"])

    def make(split):
        return FineLoader(*split, vocab, 32, 16, 6, 256, 16, seed=0)

    batch = next(FineLoader(*train, vocab, FINE_STEP_BATCH, 16, 6, 256, 16,
                            seed=0).epoch(seed=cfg.seed * 10_000 + 1))
    jb = {k: jnp.asarray(v) for k, v in batch.items()
          if k not in ("num_real", "pose_idx")}
    rng = jax.random.fold_in(jax.random.PRNGKey(cfg.seed), 0)
    pts, cols = jax.jit(lambda b, r: trainer._prep(b, r, augment=True))(
        jb, rng)
    t0 = time.time()
    (loss, (stats, _, _, _)), grads = jax.value_and_grad(
        lambda p: trainer._loss_fn(p, state.batch_stats, jb, pts, cols),
        has_aux=True)(state.params)
    print(f"fine step: loss {float(loss):.6f} ({time.time() - t0:.0f} s)",
          flush=True)
    idx, deg = draws(rng, batch["points_xyz"].shape[:-2], 256,
                     batch["point_count"], batch["points_xyz"].shape[-2],
                     True)
    out = {"fine_hint_tokens": batch["hint_tokens"],
           "fine_pose_idx": batch["pose_idx"], "fine_idx": idx,
           "fine_angles": deg}
    out.update(step_arrays("fine", float(loss), grads, stats))

    t0 = time.time()
    key = jax.random.PRNGKey(cfg.seed)
    eval_step = jax.jit(trainer.eval_step)
    rows, eval_idx, real = [], [], []
    for i, b in enumerate(make(val).epoch(seed=cfg.seed * 10_000 + 0,
                                          shuffle=False, drop_last=False)):
        jb = {k: jnp.asarray(v) for k, v in b.items()
              if k not in ("num_real", "pose_idx")}
        B = b["gt_obj_for_hint"].shape[0]
        jb["sample_mask"] = jnp.arange(B) < int(b["num_real"])
        r = jax.random.fold_in(key, 0 * 100_000 + i)
        metrics, _ = eval_step(state, jb, r)
        rows.append([float(metrics[k]) for k in
                     ("recall", "precision", "pose_mid", "pose_mean",
                      "pose_offsets")])
        eval_idx.append(draws(r, b["points_xyz"].shape[:-2], 256,
                              b["point_count"], b["points_xyz"].shape[-2],
                              False)[0])
        real.append(int(b["num_real"]))
    rows = np.array(rows)
    print(f"fine eval: recall {rows[:, 0].mean():.4f} precision "
          f"{rows[:, 1].mean():.4f} ({len(rows)} batches, "
          f"{time.time() - t0:.0f} s)", flush=True)
    out.update({"fine_eval_metrics": rows, "fine_eval_idx":
                np.stack(eval_idx), "fine_eval_real": np.array(real)})
    return out


def main():
    import threading

    import jax

    from text2pos_tpu.data.hints import Vocabulary
    from text2pos_tpu.train.state import load_checkpoint

    def watchdog(limit_gb=24.0):
        while True:
            with open("/proc/self/status") as f:
                rss = [int(line.split()[1]) for line in f
                       if line.startswith("VmRSS")][0] / 2 ** 20
            if rss > limit_gb:
                print(f"resident memory {rss:.1f} GB above {limit_gb} GB; "
                      "stopping", flush=True)
                os._exit(3)
            time.sleep(0.5)
    threading.Thread(target=watchdog, daemon=True).start()

    have = dict(np.load(OUT)) if os.path.isfile(OUT) else {}
    t0 = time.time()
    train, val = corpus()
    vocab = Vocabulary(load_checkpoint(CKPT["coarse"])["extra"][
        "known_words"])
    print(f"corpus: {len(train[0])} train cells, {len(train[1])} poses; "
          f"{len(val[0])} val cells, {len(val[1])} poses "
          f"({time.time() - t0:.0f} s)", flush=True)
    for stage, fn in (("coarse", coarse_arrays), ("fine", fine_arrays)):
        if any(k.startswith(stage + "_") for k in have):
            continue
        new = fn(train, val, vocab)
        jax.clear_caches()
        have.update({k: v for k, v in new.items() if k not in have})
        np.savez_compressed(OUT, **have)
        print(f"{OUT}: {len(new)} arrays added, "
              f"{os.path.getsize(OUT) / 2 ** 20:.2f} MiB", flush=True)


if __name__ == "__main__":
    main()
