"""The port's PointNet++ object towers against the JAX package, module by
module, on numpy-seeded inputs (CPU: the plain PyTorch twin of the PointConv
kernel).

Tolerances: f32 outputs within 2e-4 absolute (1e-4 for the ops), the same
floor as ``tests/test_pointconv_pallas.py`` for two f32 formulations of one
SA level. Discrete choices (FPS indices, ball membership, kNN neighbours)
must be identical. bf16 models are compared relative to the largest
output: the frameworks round bf16 at slightly different points (a Dense's
bias add, the L2 norms), and one bf16 step is 2^-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.models.cell_retrieval import CellRetrievalNetwork as JCell
from text2pos_tpu.models.cell_retrieval import EdgeConv as JEdgeConv
from text2pos_tpu.models.object_encoder import ObjectEncoder as JObjectEncoder
from text2pos_tpu.models.pointnet2 import PointNet2 as JPointNet2
from text2pos_tpu.models.pointnet2 import SetAbstraction as JSetAbstraction
from text2pos_tpu.models.pointnet2_fast import _bn_affine
from text2pos_tpu.ops import fps as jfps
from text2pos_tpu.ops import neighbors as jnb
from text2pos_tpu.ops import pooling as jpool
from text2pos_tpu.ops import transforms as jtf
from text2pos_tpu.ops.pointconv_pallas import separable_pointconv_max
from text2pos_torch.models.cell_retrieval import CellRetrievalNetwork, EdgeConv
from text2pos_torch.models.object_encoder import ObjectEncoder
from text2pos_torch.models.pointnet2 import PointNet2, SetAbstraction
from text2pos_torch.ops import fps, neighbors, pooling, transforms
from text2pos_torch.ops.pointconv import ball_neighbors, pointconv_max_plain
from text2pos_torch.utils.convert_jax import load_jax_params

torch.set_num_threads(2)

F32_TOL = 2e-4
BF16_REL = 3e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _objects(rng, B, P=256, pads=2):
    """Resampled, normalize-scaled objects as the encoders see them: blobs
    sampled with replacement from 20-60 stored points (duplicates), the
    last ``pads`` ones padding objects (8 points in [0, 0.001)³)."""
    xyz = (rng.standard_normal((B, P, 3)) * [2.0, 2.0, 0.5] + 5).astype(
        np.float32)
    rgb = rng.random((B, P, 3)).astype(np.float32)
    counts = rng.integers(20, 61, B).astype(np.int32)
    xyz[B - pads:] = 0.0
    xyz[B - pads:, :8] = rng.random((pads, 8, 3)) * 0.001
    counts[B - pads:] = 8
    u = rng.random((B, P)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    return xyz, rgb, counts, u, key


def _randomize(tree, seed):
    """Non-trivial params and running statistics for eval-mode BN."""
    rng = np.random.default_rng(seed)

    def f(path, v):
        v = np.asarray(v)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.3, 2.0, v.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.3 * rng.standard_normal(v.shape)).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return v

    return jax.tree_util.tree_map_with_path(f, tree)


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` under ``jax.jit``: one compile instead of op-by-op
    dispatch. Python scalars and None are static."""
    dyn = [not isinstance(a, (bool, int, float, type(None))) for a in args]

    def f(*arrays):
        it = iter(arrays)
        return fn(*[next(it) if d else a for a, d in zip(args, dyn)], **kw)

    return jax.jit(f)(*[a for a, d in zip(args, dyn) if d])


def _variables(module, seed, *args, **kw):
    v = _jit(module.init, jax.random.PRNGKey(seed), *args, **kw)
    return {"params": _randomize(jax.device_get(v["params"]), seed),
            "batch_stats": _randomize(jax.device_get(v["batch_stats"]),
                                      seed + 1)}


# --------------------------------------------------------------------------
# ops


def test_prepare_points_bit_identical():
    """FixedPoints with JAX's own draws and NormalizeScale (eight-block
    mean) give the same bits as the jitted JAX transform."""
    rng = np.random.default_rng(0)
    xyz, rgb, counts, _, key = _objects(rng, 12, pads=3)
    fn = jax.jit(lambda a, b, c, k: jtf.prepare_object_points(
        a, b, c, 256, k, augment=False))
    jx, jr = fn(xyz, rgb, counts, key)
    u = jax.random.uniform(jax.random.split(key)[0], (12, 256))
    tx, tr = transforms.prepare_object_points(_t(xyz), _t(rgb), _t(counts),
                                              256, u=_t(u))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("S", [128, 31])
def test_fps_duplicates_and_pads(S):
    """Duplicate points everywhere and pad-like blobs: the same indices
    (first index on exact ties)."""
    rng = np.random.default_rng(1)
    xyz, rgb, counts, _, key = _objects(rng, 10, pads=3)
    pts, _ = jtf.prepare_object_points(xyz, rgb, counts, 256, key,
                                       augment=False)
    pts = np.array(pts)
    pts[0, 100:] = pts[0, :156]          # exact duplicates of earlier points
    want = np.asarray(jax.jit(lambda p: jfps.farthest_point_sampling(p, S))(
        pts))
    got, cent = fps.farthest_point_sampling_plain(_t(pts), S)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cent.numpy(), np.take_along_axis(pts, want[..., None], 1))


def test_pairwise_sqdist_bit_identical_and_knn_ties():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((4, 40, 3)).astype(np.float32)
    b = rng.standard_normal((4, 70, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jnb.pairwise_sqdist)(a, b))
    np.testing.assert_array_equal(
        neighbors.pairwise_sqdist(_t(a), _t(b)).numpy(), want)

    # kNN over embeddings: exact duplicates (ties), sets smaller than k,
    # an empty set; invalid entries are +inf.
    x = rng.standard_normal((4, 12, 16)).astype(np.float32)
    x[:, 5] = x[:, 2]
    x[:, 9] = x[:, 2]
    mask = np.arange(12)[None, :] < np.array([12, 6, 3, 0])[:, None]
    widx, wvalid = jax.jit(lambda x, m: jnb.masked_knn(x, m, 8))(x, mask)
    gidx, gvalid = neighbors.masked_knn(_t(x), _t(mask), 8)
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    wv = np.asarray(wvalid)
    np.testing.assert_array_equal(gidx.numpy()[wv], np.asarray(widx)[wv])
    np.testing.assert_allclose(
        neighbors.pairwise_sqdist(_t(x), _t(x)).numpy(),
        np.asarray(jnb.pairwise_sqdist(x, x)), atol=1e-5)


def test_pooling_ops():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 7, 4)).astype(np.float32)
    mask = rng.random((3, 5, 7, 1)) < 0.4
    mask[0, 0] = False
    for dim in (1, 2):
        np.testing.assert_array_equal(
            pooling.masked_max(_t(x), _t(mask), dim).numpy(),
            np.asarray(jpool.masked_max(x, mask, dim)))
        np.testing.assert_allclose(
            pooling.masked_mean(_t(x), _t(mask), dim).numpy(),
            np.asarray(jpool.masked_mean(x, mask, dim)), atol=1e-6)
    idx = rng.integers(0, 5, (3, 4, 6))
    np.testing.assert_array_equal(
        pooling.gather_neighbors(_t(x[:, :, 0]), _t(idx)).numpy(),
        np.asarray(jpool.gather_neighbors(x[:, :, 0], idx)))


# --------------------------------------------------------------------------
# one set-abstraction level


@pytest.fixture(scope="module")
def sa_case():
    """sa1-shaped level on 8 objects (2 pads) with randomized params."""
    rng = np.random.default_rng(4)
    xyz, rgb, counts, _, key = _objects(rng, 8)
    pos, x = jtf.prepare_object_points(xyz, rgb, counts, 256, key,
                                       augment=False)
    pos, x = np.array(pos), np.array(x)
    jm = JSetAbstraction(0.5, 0.2, (32, 64))
    v = _variables(jm, 4, x, pos, None, False)
    return jm, v, x, pos


def _port_sa(v, dtype=None):
    tm = SetAbstraction(3, 0.5, 0.2, (32, 64), dtype)
    load_jax_params(tm, v["params"], v["batch_stats"])
    return tm


def test_sa_level_matches_jax_f32(sa_case):
    jm, v, x, pos = sa_case
    want, wcent = _jit(jm.apply, v, x, pos, None, False)
    with torch.no_grad():
        got, gcent = _port_sa(v)(_t(x), _t(pos))
    np.testing.assert_array_equal(gcent.numpy(), np.asarray(wcent))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def test_sa_level_matches_jax_bf16(sa_case):
    jm, v, x, pos = sa_case
    want, _ = _jit(jm.clone(dtype=jnp.bfloat16).apply, v, x, pos, None,
                   False)
    want = np.asarray(want.astype(jnp.float32))
    with torch.no_grad():
        got, _ = _port_sa(v, torch.bfloat16)(_t(x), _t(pos))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())


def test_plain_matches_pallas_interpret(sa_case):
    """The plain twin against the Pallas kernel in interpret mode, with
    BN folded into a, c, W2 and b2 as ``pointnet2_fast`` folds it."""
    _, v, x, pos = sa_case
    p, s = v["params"]["conv_mlp"], v["batch_stats"]["conv_mlp"]
    pos = pos[:, :64]                        # N=64, S=32: a quick interpret
    cent = pos[:, ::2]
    xpos = np.concatenate([x[:, :64], pos], -1)
    s1, t1 = _bn_affine(p["bn_0"], s["bn_0"])
    s2, t2 = _bn_affine(p["bn_1"], s["bn_1"])
    a = (xpos @ p["dense_0"]["kernel"] + p["dense_0"]["bias"]) * s1 + t1
    c = (cent @ p["dense_0"]["kernel"][-3:]) * s1
    w2 = p["dense_1"]["kernel"] * s2[None, :]
    b2 = p["dense_1"]["bias"] * s2 + t2
    want = separable_pointconv_max(a, pos, c, cent, w2, b2, 0.2, 32,
                                   s_tile=32, n_chunk=64, interpret=True)
    one, zero = torch.ones(32), torch.zeros(32)
    got = pointconv_max_plain(
        _t(a), _t(pos), _t(c), _t(cent), (one, zero), _t(w2), _t(b2),
        (torch.ones(64), torch.zeros(64)), 0.2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def test_ball_neighbors_first_k_by_index():
    """Fewer and more than K in-ball points; the first K by index."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1, 1, (2, 100, 3)).astype(np.float32)
    pos[0, :50] = 0.01 * pos[0, :50]         # 50 points in every small ball
    cent = pos[:, [0, 60, 99]]
    idx, valid = ball_neighbors(_t(pos), _t(cent), 0.2, 32)
    d2 = np.asarray(jnb.pairwise_sqdist(cent, pos)) <= 0.2 * 0.2
    for b in range(2):
        for s in range(3):
            want = np.flatnonzero(d2[b, s])[:32]
            n = int(valid[b, s].sum())
            assert n == len(want)
            np.testing.assert_array_equal(idx[b, s, :n].numpy(), want)
    assert int(valid[0, 0].sum()) == 32


# --------------------------------------------------------------------------
# whole towers


def test_pointnet2_matches_jax():
    rng = np.random.default_rng(6)
    xyz, rgb, counts, _, key = _objects(rng, 6, P=64)
    pos, col = jtf.prepare_object_points(xyz, rgb, counts, 64, key,
                                         augment=False)
    jm = JPointNet2(23, 9)
    v = _variables(jm, 6, pos, col, train=False)
    want = _jit(jm.apply, v, pos, col, train=False)["features2"]
    tm = PointNet2()
    unused = load_jax_params(tm, v["params"], v["batch_stats"])
    assert sorted({u.split("/")[1] for u in unused}) == [
        "class_classifier", "color_classifier"]
    with torch.no_grad():
        got = tm(_t(pos), _t(col))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL)


def _level_by_level(tm, xyz, rgb):
    """PointNet2's forward with each level running its own FPS (no
    centroids handed in), as before the levels entry."""
    x, pos = rgb, xyz.float()
    for sa in (tm.sa1, tm.sa2, tm.sa3):
        x, pos = sa(x, pos)
    f = tm.ga(x, pos)
    for lin in (tm.lin1, tm.lin2):
        f = torch.relu(lin(f))
    return f


@pytest.mark.parametrize("mode", ["eval", "train", "remat"])
def test_pointnet2_one_fps_call_equals_level_by_level(monkeypatch, mode):
    """The forward calls the levels entry once and no per-level FPS, in
    eval mode, on batch statistics, and rematerialised (whose backward
    recomputes the levels without rerunning FPS); features and gradients
    equal the level-by-level path's bit for bit, and the features JAX's
    PointNet++ forward within F32_TOL (eval)."""
    import text2pos_torch.models.pointnet2 as pn
    from text2pos_torch.models.blocks import train_mode

    rng = np.random.default_rng(6)
    xyz, rgb, counts, _, key = _objects(rng, 6, P=64)
    pos, col = jtf.prepare_object_points(xyz, rgb, counts, 64, key,
                                         augment=False)
    jm = JPointNet2(23, 9)
    v = _variables(jm, 6, pos, col, train=False)
    tm = PointNet2()
    load_jax_params(tm, v["params"], v["batch_stats"])
    tm.remat = mode == "remat"
    calls = {"levels": 0, "level": 0}
    levels, level = pn.farthest_point_sampling_levels, \
        pn.farthest_point_sampling

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    def run(fn):
        rgb_t = _t(col).requires_grad_(True)
        with train_mode(tm, mode != "eval"):
            out = fn(_t(pos), rgb_t)
            out.sum().backward()
        return out.detach(), rgb_t.grad

    monkeypatch.setattr(pn, "farthest_point_sampling_levels",
                        count("levels", levels))
    monkeypatch.setattr(pn, "farthest_point_sampling", count("level", level))
    got, ggot = run(tm)
    assert calls == {"levels": 1, "level": 0}
    want, gwant = run(lambda a, b: _level_by_level(tm, a, b))
    assert calls == {"levels": 1, "level": 3}
    assert torch.equal(got, want) and torch.equal(ggot, gwant)
    if mode == "eval":
        jwant = _jit(jm.apply, v, pos, col, train=False)["features2"]
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant),
                                   atol=F32_TOL)


@pytest.fixture(scope="module")
def encoder_case():
    rng = np.random.default_rng(7)
    F, E = 6, 16
    xyz, rgb, counts, _, key = _objects(rng, F, P=64)
    pos, col = jtf.prepare_object_points(xyz, rgb, counts, 64, key,
                                         augment=False)
    centers = rng.standard_normal((F, 3)).astype(np.float32)
    colors = rng.random((F, 3)).astype(np.float32)
    ids = np.zeros(F, np.int32)
    jm = JObjectEncoder(E, 23, 9)
    args = (np.asarray(pos), np.asarray(col), centers, colors, ids, ids)
    v = _variables(jm, 7, *args, None, False)
    return jm, v, args


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_object_encoder_matches_jax(encoder_case, dtype):
    jm, v, args = encoder_case
    jdt, tdt = ((None, None) if dtype is None
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(_jit(jm.clone(dtype=jdt).apply, v, *args, None,
                           False))
    tm = ObjectEncoder(16, dtype=tdt)
    load_jax_params(tm, v["params"], v["batch_stats"])
    with torch.no_grad():
        got = tm(*(_t(a) for a in args[:4])).numpy()
    if dtype is None:
        np.testing.assert_allclose(got, want, atol=F32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=BF16_REL * np.abs(want).max())


def test_edgeconv_matches_jax():
    """Sets of 10, 5 and 0 valid objects (fewer than k=8 in two)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 10, 16)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    mask = np.arange(10)[None, :] < np.array([10, 5, 0])[:, None]
    x = x * mask[..., None]
    jm = JEdgeConv(16, k=8)
    v = _variables(jm, 8, x, mask, False)
    want = np.asarray(_jit(jm.apply, v, x, mask, False))
    tm = EdgeConv(16, 8)
    load_jax_params(tm, v["params"], v["batch_stats"])
    with torch.no_grad():
        got = tm(_t(x), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL)


def test_coarse_encode_objects_matches_jax():
    """Three cells of 4, 2 and 5 objects in a flat buffer with an invalid
    tail: JAX runs PointNet on the tail and masks it; the port encodes the
    valid objects only."""
    rng = np.random.default_rng(9)
    E, O, cap = 16, 6, 14
    per_cell = [4, 2, 5]
    xyz, rgb, counts, _, key = _objects(rng, cap, P=64, pads=0)
    pos, col = (np.asarray(a) for a in jtf.prepare_object_points(
        xyz, rgb, counts, 64, key, augment=False))
    cell_idx = np.zeros(cap, np.int32)
    slot_idx = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    f = 0
    for b, n in enumerate(per_cell):
        cell_idx[f:f + n] = b
        slot_idx[f:f + n] = rng.permutation(O)[:n]
        valid[f:f + n] = True
        f += n
    centers = rng.standard_normal((cap, 3)).astype(np.float32)
    colors = rng.random((cap, 3)).astype(np.float32)
    ids = np.zeros(cap, np.int32)
    tokens = np.ones((3, 4), np.int32)
    jm = JCell(vocab_size=5, embed_dim=E, num_classes=23, num_colors=9)
    flat = (pos, col, centers, colors, ids, ids, valid, cell_idx, slot_idx)
    v = _variables(jm, 9, tokens, np.full(3, 4, np.int32), *flat, 3, O,
                   train=False)
    want = np.asarray(_jit(jm.apply, v, *flat, 3, O, train=False,
                           method=JCell.encode_objects))
    tm = CellRetrievalNetwork(5, E)
    load_jax_params(tm, v["params"], v["batch_stats"])
    with torch.no_grad():
        got = tm.encode_objects(*(_t(a[valid]) for a in flat[:4]),
                                _t(cell_idx[valid]).long(),
                                _t(slot_idx[valid]).long(), 3, O).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL)
