"""The port's offline DB encode against the JAX package on the CPU: the
copied map generator, the fine and coarse object towers with the committed
weights on JAX-prepared points, the DB fixture's draws, and the converter
on the full coarse and fine trees.

Tolerances: the map and the prepared points must be bit-identical (they
decide FPS and the ball query); f32 encodings within 1e-4 absolute on the
L2-normalized rows (the chip run's gate on the same quantities).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.config import EvalConfig
from text2pos_tpu.data import dense as jdense
from text2pos_tpu.data import synthetic as jsyn
from text2pos_tpu.evaluation.pipeline import build_pipeline_from_checkpoints
from text2pos_tpu.ops.transforms import prepare_object_points as jprepare
from text2pos_torch.data import dense as tdense
from text2pos_torch.data import synthetic as tsyn
from text2pos_torch.data.bench import bench_cell_bank, make_bench_dataset
from text2pos_torch.evaluation.pipeline import (
    LocalizationPipeline, bank_tensors, encode_coarse_cells, encode_fine_cells,
    fine_cell_points)
from text2pos_torch.train.state import load_checkpoint
from text2pos_torch.utils.convert_jax import module_to_jax

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = {k: os.path.join(ROOT, "checkpoints", f"bench_{k}.msgpack")
        for k in ("coarse", "fine")}
DB = os.path.join(ROOT, "checkpoints", "bench_db_cache.npz")
DB_FIXTURE = os.path.join(ROOT, "text2pos_torch", "fixtures",
                          "bench_db_subset.npz")
F32_TOL = 1e-4
NCELLS = 2


def _bank_arrays(bank):
    return {k: getattr(bank, k) for k in (
        "points_xyz", "points_rgb", "point_count", "centers", "colors",
        "class_idx", "color_idx", "mask", "bbox_w", "cell_size")}


def test_synthetic_scene_bit_identical():
    """One synthetic scene through both generators: equal cells, poses,
    descriptions and dense bank."""
    kw = dict(seed=3, scene_name="9903", extent=90.0, cell_size=30.0,
              poses_per_cell=2, objects_per_cell_area=12)
    jc, jp = jsyn.make_synthetic_dataset(**kw)
    tc, tp = tsyn.make_synthetic_dataset(**kw)
    assert [c.id for c in tc] == [c.id for c in jc]
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.pose_w, b.pose_w)
        assert a.cell_id == b.cell_id
        assert repr(a.descriptions) == repr(b.descriptions)
    want = _bank_arrays(jdense.build_cell_bank(jc, 28, 256, seed=0))
    got = _bank_arrays(tdense.build_cell_bank(tc, 28, 256, seed=0))
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_bench_map_first_scene_matches_fixture():
    """The port's bench map (first scene) has the cell boxes, sizes and
    scenes the serving fixture records."""
    bank = bench_cell_bank(make_bench_dataset(num_scenes=1)[0])
    with np.load(os.path.join(ROOT, "text2pos_torch", "fixtures",
                              "bench_queries.npz")) as z:
        n = bank.num_cells
        np.testing.assert_array_equal(bank.bbox_w[:, 0:2],
                                      z["cell_bbox_xy"][:n])
        np.testing.assert_array_equal(bank.cell_size, z["cell_size"][:n])
        assert list(z["cell_scene"][:n]) == ["9900"] * n


@pytest.fixture(scope="module")
def bench_case():
    """The bench map's first 8 cells (scene 9900, built by the JAX
    package's generator as ``bench.py`` does), JAX's f32 pipeline with the
    calibrated statistics, and the port's on the CPU."""
    cells, _ = jsyn.make_synthetic_dataset(
        seed=0, scene_name="9900", extent=480.0, cell_size=30.0,
        poses_per_cell=2, objects_per_cell_area=12)
    bank = jdense.build_cell_bank(cells[:8], 28, 256, seed=0)
    ecfg = EvalConfig(top_k=(1, 5, 10), threshs=(5, 10, 15), pad_size=16,
                      num_mentioned=6, pointnet_numpoints=256)
    jpipe, _, _ = build_pipeline_from_checkpoints(
        ecfg, CKPT["coarse"], CKPT["fine"], dtype="float32")
    import flax

    with np.load(DB) as z:
        stats = flax.serialization.msgpack_restore(z["batch_stats"].tobytes())
    jpipe = jpipe.with_calibrated_stats(jax.tree.map(jnp.asarray, stats))
    tpipe = LocalizationPipeline.from_checkpoints(
        CKPT["coarse"], CKPT["fine"], DB, dtype="float32", device="cpu")
    return bank, jpipe, tpipe


def test_fine_cells_match_jax(bench_case):
    """``encode_fine_cells`` against ``_encode_cells_chunk`` on two bench
    cells with JAX's pad points and resampling draws."""
    bank, jpipe, tpipe = bench_case
    bank_dev = {k: jnp.asarray(getattr(bank, k)) for k in (
        "points_xyz", "points_rgb", "point_count", "centers", "colors",
        "class_idx", "color_idx", "mask")}
    rng = jax.random.PRNGKey(5)
    want_enc, want_ctr = jpipe._encode_cells_chunk(
        jpipe.fine_state, bank_dev, jnp.arange(NCELLS), rng)
    pad_pts = jax.random.uniform(rng, (NCELLS, 16, 8, 3)) * 0.001
    u = jax.random.uniform(jax.random.split(jax.random.fold_in(rng, 1))[0],
                           (NCELLS, 16, 256))
    with torch.inference_mode():
        enc, ctr = encode_fine_cells(
            tpipe.fine, bank_tensors(bank, "cpu"), torch.arange(NCELLS), 16,
            u=torch.from_numpy(np.array(u)),
            pad_pts=torch.from_numpy(np.array(pad_pts)))
    # A padding object's centre is the mean of its 8 points, which XLA
    # sums in an order of its choosing: within an f32 step.
    np.testing.assert_allclose(ctr.numpy(), np.asarray(want_ctr), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(enc.numpy(), np.asarray(want_enc),
                               atol=F32_TOL)


def test_coarse_cells_match_jax(bench_case):
    """``encode_coarse_cells`` against ``encode_cells_step`` on two bench
    cells; JAX also runs PointNet on its flat buffer's invalid tail, whose
    draws the port skips."""
    bank, jpipe, tpipe = bench_case
    idx = np.arange(NCELLS)
    flat = jdense.flatten_bank_slice(bank, idx, NCELLS * 28)
    rng = jax.random.PRNGKey(6)
    want = jpipe.coarse.encode_cells_step(
        jpipe.coarse_state, {k: jnp.asarray(v) for k, v in flat.items()},
        NCELLS, rng)
    u = jax.random.uniform(jax.random.split(rng)[0], (NCELLS * 28, 256))
    nvalid = int(flat["flat_valid"].sum())
    with torch.inference_mode():
        got = encode_coarse_cells(
            tpipe.coarse, bank_tensors(bank, "cpu"), torch.from_numpy(idx),
            u=torch.from_numpy(np.array(u)[:nvalid]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def test_db_fixture_draws_give_jax_points(bench_case):
    """The DB fixture's draws make, through the port's transforms, the
    points JAX's transforms make from its own key at the fixture's chunk
    shape (the first 8 cells of its 64-cell chunk), bit for bit."""
    bank, jpipe, _ = bench_case
    with np.load(DB_FIXTURE) as z:
        u, pad_pts = z["fine_u"], z["fine_pad_pts"]
    n = bank.num_cells
    bank_dev = {k: jnp.asarray(getattr(bank, k)) for k in (
        "points_xyz", "points_rgb", "point_count", "centers", "colors",
        "class_idx", "color_idx", "mask")}
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    xyz, rgb, count, _, _, _, _ = jpipe._pad_filled_cell_tensors(
        bank_dev, jnp.arange(64) % n, rng)
    want, _ = jax.jit(lambda a, b, c: jprepare(
        a, b, c, 256, jax.random.fold_in(rng, 1), augment=False))(
        xyz, rgb, count)
    got, _, _, _ = fine_cell_points(
        bank_tensors(bank, "cpu"), torch.arange(n), 16,
        u=torch.from_numpy(u[:n]), pad_pts=torch.from_numpy(pad_pts[:n]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])


def test_db_fixture_cells_match_port(bench_case):
    """The fixture's f32 JAX encodings of two cells, reproduced by the port
    from the fixture's draws (the chip run's gate, here on the CPU)."""
    bank, _, tpipe = bench_case
    with np.load(DB_FIXTURE) as z:
        fx = {k: z[k] for k in z.files}
    bt = bank_tensors(bank, "cpu")
    idx = torch.arange(NCELLS)
    nvalid = int(bank.mask[:NCELLS].sum())
    with torch.inference_mode():
        enc, ctr = encode_fine_cells(
            tpipe.fine, bt, idx, 16, u=torch.from_numpy(fx["fine_u"][:NCELLS]),
            pad_pts=torch.from_numpy(fx["fine_pad_pts"][:NCELLS]))
        cell = encode_coarse_cells(
            tpipe.coarse, bt, idx,
            u=torch.from_numpy(fx["coarse_u"][:nvalid]))
    np.testing.assert_array_equal(ctr.numpy(),
                                  fx["f32_fine_bank_centers"][:NCELLS])
    np.testing.assert_allclose(enc.numpy(), fx["f32_fine_bank_enc"][:NCELLS],
                               atol=F32_TOL)
    np.testing.assert_allclose(cell.numpy(), fx["f32_cell_enc"][:NCELLS],
                               atol=F32_TOL)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree, np.float32)


@pytest.mark.parametrize("which", ["coarse", "fine"])
def test_converter_round_trips_full_tree(bench_case, which):
    """Every leaf of the checkpoint, object tower included, goes into the
    port's model and comes back unchanged; only PointNet's class and colour
    heads, which encoding never reads, stay behind."""
    _, _, tpipe = bench_case
    ck = load_checkpoint(CKPT[which])
    model = tpipe.coarse if which == "coarse" else tpipe.fine
    params, stats = module_to_jax(model)
    got = dict(_flat(params))
    want = dict(_flat(ck["params"]))
    heads = {p for p in want if p[-2] in ("class_classifier",
                                          "color_classifier")}
    assert heads and set(got) == set(want) - heads
    for p, w in want.items():
        if p not in heads:
            np.testing.assert_array_equal(got[p], w, err_msg="/".join(p))
    got_stats = dict(_flat(stats))
    if which == "coarse":
        want_stats = dict(_flat(ck["batch_stats"]))
        assert set(got_stats) == set(want_stats)
        for p, w in want_stats.items():
            np.testing.assert_array_equal(got_stats[p], w)
    else:      # the fine statistics are the DB cache's calibrated ones
        assert {p[0] for p in got_stats} == {"object_encoder", "superglue"}
