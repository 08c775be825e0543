"""Write the DB-encode fixture that the PyTorch port's offline encoders are
checked against.

Builds the bench map (``bench.make_bench_dataset``, ``CoarseLoader``'s bank)
and encodes its first 64 cells with the JAX package on the CPU, as
``bench.py`` encodes them when it has no DB cache: the fine object tower as
``precompute_fine_bank``'s first chunk (cells 0-63, key
``fold_in(PRNGKey(0), 0)``) and the coarse tower as ``encode_all_cells``'
first two steps of 32 cells (keys ``fold_in(PRNGKey(0), i)``, i = 0, 32), in
float32 and in bfloat16, the fine tower with the calibrated statistics of
the committed DB cache. It saves JAX's random draws (the padding objects'
points and the ``fixed_points`` uniforms) and JAX's outputs to
``text2pos_torch/fixtures/bench_db_subset.npz``:

- ``fine_pad_pts`` [64, 16, 8, 3] and ``fine_u`` [64, 16, 256];
- ``coarse_u`` [F, 256]: the draws of the F valid objects of cells 0-63, in
  the order of JAX's flat buffers (cell by cell, slots ascending);
- ``{f32,bf16}_fine_bank_enc`` [64, 16, 128], ``{f32,bf16}_fine_bank_centers``
  [64, 16, 2] and ``{f32,bf16}_cell_enc`` [64, 256], float32.

The model runs one cell per call on the draws of the whole chunk or step, so
that the CPU never holds the selection tensors of more than one cell; in
eval mode each cell's encoding does not depend on the others. The script
prints how close its bf16 rows come to the committed cache. It imports JAX
and the JAX package and is not part of the port. Run from the repository
root:

    JAX_PLATFORMS=cpu python scripts/make_torch_port_db_fixture.py

With ``--spread`` it writes nothing and measures resampling noise instead:
the same 64 cells encoded in bf16 with the key ``PRNGKey(1)`` in place of
``PRNGKey(0)``, row cosines against the key-0 encodings and against the
cache.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "text2pos_torch", "fixtures", "bench_db_subset.npz")
CELLS = 64          # the first fine chunk (precompute_fine_bank's chunk)
COARSE_STEP = 32    # encode_all_cells' batch (EvalConfig.batch_size)


def _rows_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def encode_subset(pipe, ecfg, bank, bank_dev, seed: int) -> dict:
    """The first 64 cells through both towers as ``bench.py`` encodes them
    with key ``PRNGKey(seed)``: the encodings and the draws."""
    import jax
    import jax.numpy as jnp

    from text2pos_tpu.data.dense import flatten_bank_slice
    from text2pos_tpu.models.cell_retrieval import CellRetrievalNetwork
    from text2pos_tpu.ops.transforms import prepare_object_points

    out = {}
    P, pad = ecfg.pointnet_numpoints, ecfg.pad_size

    # Fine: precompute_fine_bank's first chunk, as _encode_cells_chunk
    # draws it.
    t0 = time.time()
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    idx = jnp.arange(CELLS)
    xyz, rgb, count, centers, colors, cls, col = (
        pipe._pad_filled_cell_tensors(bank_dev, idx, rng))
    pts, cols = jax.jit(lambda a, b, c: prepare_object_points(
        a, b, c, P, jax.random.fold_in(rng, 1), augment=False))(
        xyz, rgb, count)
    fine_vars = {"params": pipe.fine_state.params,
                 "batch_stats": pipe.fine_state.batch_stats}
    model = pipe.fine.model
    enc_cell = jax.jit(lambda *a: model.apply(
        fine_vars, *a, train=False, method=type(model).encode_cell_objects))
    out["fine_bank_enc"] = np.concatenate([np.asarray(enc_cell(
        *(t[c:c + 1] for t in (pts, cols, centers, colors, cls, col))),
        np.float32) for c in range(CELLS)])
    out["fine_bank_centers"] = np.asarray(centers[..., 0:2], np.float32)
    out["fine_pad_pts"] = np.asarray(
        jax.random.uniform(rng, (CELLS, pad, 8, 3)) * 0.001, np.float32)
    k_sample, _ = jax.random.split(jax.random.fold_in(rng, 1))
    out["fine_u"] = np.asarray(jax.random.uniform(k_sample, (CELLS, pad, P)),
                               np.float32)
    print(f"# fine: {CELLS} cells in {time.time() - t0:.1f}s", flush=True)

    # Coarse: encode_all_cells' first two steps, as encode_cells_step draws
    # them.
    t0 = time.time()
    cvars = {"params": pipe.coarse_state.params,
             "batch_stats": pipe.coarse_state.batch_stats}
    O = ecfg.coarse_max_objects
    enc_objects = jax.jit(lambda *a: pipe.coarse.model.apply(
        cvars, *a, 1, O, train=False,
        method=CellRetrievalNetwork.encode_objects))
    cell_enc, coarse_u = [], []
    for i in range(0, CELLS, COARSE_STEP):
        flat = flatten_bank_slice(bank, np.arange(i, i + COARSE_STEP),
                                  COARSE_STEP * O)
        step_rng = jax.random.fold_in(jax.random.PRNGKey(seed), i)
        k_sample, _ = jax.random.split(step_rng)
        u = np.asarray(jax.random.uniform(k_sample, (COARSE_STEP * O, P)),
                       np.float32)
        pts, cols = jax.jit(lambda a, b, c: prepare_object_points(
            a, b, c, P, step_rng, augment=False))(
            flat["points_xyz"], flat["points_rgb"], flat["point_count"])
        pts, cols = np.asarray(pts), np.asarray(cols)
        nvalid = int(flat["flat_valid"].sum())
        coarse_u.append(u[:nvalid])
        for b in range(COARSE_STEP):
            rows = np.flatnonzero(flat["flat_valid"]
                                  & (flat["cell_idx"] == b))
            take = np.zeros(O, np.int64)           # invalid tail: row 0
            take[:len(rows)] = rows
            valid = np.arange(O) < len(rows)
            args = [a[take] for a in (pts, cols, flat["centers"],
                                      flat["colors"], flat["class_idx"],
                                      flat["color_idx"])]
            cell_enc.append(np.asarray(enc_objects(
                *args, valid, np.zeros(O, np.int32),
                np.where(valid, flat["slot_idx"][take], 0)), np.float32))
    out["cell_enc"] = np.concatenate(cell_enc)
    out["coarse_u"] = np.concatenate(coarse_u)
    print(f"# coarse: {CELLS} cells in {time.time() - t0:.1f}s", flush=True)
    return out


def _print_cos(what, got, want):
    for name in ("cell_enc", "fine_bank_enc"):
        cos = _rows_cos(got[name], want[name])
        print(f"# {what} {name} (cells 0-{CELLS - 1}): row cosine median "
              f"{np.median(cos):.6f}, 1st percentile "
              f"{np.quantile(cos, 0.01):.6f}, min {cos.min():.6f}")


def main() -> None:
    import flax
    import jax
    import jax.numpy as jnp

    import bench
    from text2pos_tpu.config import EvalConfig
    from text2pos_tpu.data.dense import build_cell_bank
    from text2pos_tpu.evaluation.pipeline import (
        build_pipeline_from_checkpoints)

    ap = argparse.ArgumentParser()
    ap.add_argument("--spread", action="store_true")
    spread = ap.parse_args().spread
    os.chdir(ROOT)
    t0 = time.time()
    cells, _ = bench.make_bench_dataset()
    ecfg = EvalConfig(top_k=(1, 5, 10), threshs=(5, 10, 15), pad_size=16,
                      num_mentioned=6, pointnet_numpoints=256)
    bank = build_cell_bank(cells, ecfg.coarse_max_objects,
                           ecfg.pointnet_numpoints, seed=0)
    assert ecfg.batch_size == COARSE_STEP and ecfg.seed == 0
    with np.load(bench.DB_CACHE) as z:
        stats = flax.serialization.msgpack_restore(z["batch_stats"].tobytes())
        cache = {k: z[k][:CELLS] for k in ("cell_enc", "fine_bank_enc",
                                           "fine_bank_centers")}
    bank_dev = {k: jnp.asarray(getattr(bank, k)) for k in (
        "points_xyz", "points_rgb", "point_count", "centers", "colors",
        "class_idx", "color_idx", "mask")}
    print(f"# bank of {bank.num_cells} cells in {time.time() - t0:.1f}s",
          flush=True)

    def pipeline(dtype):
        pipe, _, _ = build_pipeline_from_checkpoints(
            ecfg, bench.CKPT_COARSE, bench.CKPT_FINE, dtype=dtype)
        return pipe.with_calibrated_stats(jax.tree.map(jnp.asarray, stats))

    if spread:
        pipe = pipeline("bfloat16")
        ref = encode_subset(pipe, ecfg, bank, bank_dev, ecfg.seed)
        other = encode_subset(pipe, ecfg, bank, bank_dev, ecfg.seed + 1)
        _print_cos(f"bf16, key {ecfg.seed + 1} vs key {ecfg.seed}:", other,
                   ref)
        _print_cos(f"bf16, key {ecfg.seed + 1} vs the committed DB cache:",
                   other, cache)
        _print_cos(f"bf16, key {ecfg.seed} vs the committed DB cache:", ref,
                   cache)
        return

    out = {}
    for label, dtype in (("f32", "float32"), ("bf16", "bfloat16")):
        res = encode_subset(pipeline(dtype), ecfg, bank, bank_dev, ecfg.seed)
        for name in ("fine_bank_enc", "fine_bank_centers", "cell_enc"):
            out[f"{label}_{name}"] = res[name]
        if label == "f32":
            for name in ("fine_pad_pts", "fine_u", "coarse_u"):
                out[name] = res[name]

    _print_cos("bf16 vs the committed DB cache:",
               {k: out[f"bf16_{k}"] for k in ("cell_enc", "fine_bank_enc")},
               cache)
    err = np.abs(out["bf16_fine_bank_centers"] - cache["fine_bank_centers"])
    print(f"# bf16 fine_bank_centers vs the cache: max abs diff "
          f"{err.max():.3g}")
    np.savez_compressed(OUT, **out)
    print(f"# wrote {OUT} ({os.path.getsize(OUT) / 1e6:0.2f} MB)")


if __name__ == "__main__":
    main()
