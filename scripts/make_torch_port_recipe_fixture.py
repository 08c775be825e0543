"""Write the pretraining fixture that the PyTorch port is checked against.

Runs the JAX package's PointNet++ pretraining evaluation
(``text2pos_tpu/train/pointnet2.py``, ``PointNet2Trainer.eval_step``) in
float32 on the CPU with the committed ``checkpoints/bench_pointnet.msgpack``
over the validation scene of the recipe (``scripts/train_bench_ckpts.py``:
seed 77, scene "7077", 16 x 16 cells of 30 m, 12 objects a cell area, one
pose a cell): ``ObjectsDataset(cells, 256, seed=0)``, batches of 64 objects
(the tail dropped), every batch on the draws of ``PRNGKey(0)`` as
``train`` evaluates. Saves to ``text2pos_torch/fixtures/bench_recipe.npz``:

- ``pretrain_val_idx`` (uint8 [objects, 256]): each object's sample
  indices, ``floor(u · count)`` of the batch's one set of uniforms;
- ``pretrain_val_pred`` (uint8 [objects]): JAX's class prediction
  (argmax of ``class_pred``, first on ties) for every object of the full
  batches; ``pretrain_val_labels`` (uint8) the classes;
- ``pretrain_val_acc``: the mean over batches of each batch's accuracy,
  what ``train`` reports as ``val-acc``.

This script imports JAX and the JAX package; it is not part of the port,
which only reads the file (``chip_smoke.py`` phase 9). Run from the
repository root (about a minute):

    JAX_PLATFORMS=cpu python scripts/make_torch_port_recipe_fixture.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "text2pos_torch", "fixtures", "bench_recipe.npz")
CKPT = os.path.join(ROOT, "checkpoints", "bench_pointnet.msgpack")
BATCH, POINTS = 64, 256


def main() -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from text2pos_tpu.config import TrainConfig
    from text2pos_tpu.data.synthetic import make_synthetic_dataset
    from text2pos_tpu.train.pointnet2 import ObjectsDataset, PointNet2Trainer
    from text2pos_tpu.train.state import TrainState, load_checkpoint

    t0 = time.time()
    cells, _ = make_synthetic_dataset(
        seed=77, scene_name="7077", extent=30.0 * 16, cell_size=30.0,
        poses_per_cell=1, objects_per_cell_area=12)
    ds = ObjectsDataset(cells, POINTS, seed=0)
    trainer = PointNet2Trainer(TrainConfig(batch_size=BATCH,
                                           pointnet_numpoints=POINTS))
    payload = load_checkpoint(CKPT)
    state = TrainState.create(payload["params"], payload["batch_stats"],
                              optax.adam(1e-3))
    rng = jax.random.PRNGKey(0)
    k_sample, _ = jax.random.split(rng)
    u = np.asarray(jax.random.uniform(k_sample, (BATCH, POINTS)))

    @jax.jit
    def predict(st, b):
        from text2pos_tpu.ops.transforms import prepare_object_points

        pts, cols = prepare_object_points(b["xyz"], b["rgb"], b["counts"],
                                          POINTS, rng, augment=False)
        out = trainer.model.apply(
            {"params": st.params, "batch_stats": st.batch_stats}, pts, cols,
            train=False)
        return jnp.argmax(out["class_pred"], -1)

    preds, accs, idx = [], [], []
    for b in ds.epoch(BATCH, 0, shuffle=False):
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        p = np.asarray(predict(state, jb))
        acc = float(trainer.eval_step(state, jb, rng))
        assert acc == float(np.mean(p == b["classes"]))
        preds.append(p)
        accs.append(acc)
        idx.append(np.clip(np.floor(u * b["counts"][:, None]), 0,
                           POINTS - 1))
    n = len(preds) * BATCH
    np.savez_compressed(
        OUT, pretrain_val_idx=np.concatenate(idx).astype(np.uint8),
        pretrain_val_pred=np.concatenate(preds).astype(np.uint8),
        pretrain_val_labels=ds.classes[:n].astype(np.uint8),
        pretrain_val_acc=np.float64(np.mean(accs)))
    print(f"{len(ds)} objects, {len(preds)} batches of {BATCH}: val-acc "
          f"{np.mean(accs):.6f}; wrote {OUT} ({os.path.getsize(OUT)} bytes) "
          f"in {time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
