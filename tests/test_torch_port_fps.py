"""The port's farthest-point sampling against the JAX package (CPU: the plain
version, which is both the CPU path and the spec of the ``csrc/fps.cu``
kernel; the kernel itself is held bit for bit against it on the card by
``test_torch_port_kernels.py``). The levels entry (a PointNet++ forward's
three levels, each on the last one's centroids) against JAX's function
applied level by level, past the kernel's old 1024 points too; a mirror of
the kernel's selection rule (blocked lanes, the lane's first maximum by a
tree, warp max, ballot, lowest lane, lowest warp, and the strided form past
4096 points) against ``argmax`` on rows of exact ties.

Indices must be identical: they choose the centroids, and the centroids
every later ball. Inputs carry the ties the DB encode sees: objects
resampled with replacement (exact duplicates), padding objects of 8
distinct points, objects of one repeated point.
"""

import jax
import numpy as np
import pytest
import torch

from text2pos_tpu.ops import fps as jfps
from text2pos_torch.ops import fps

torch.set_num_threads(2)


def _points(B, N, seed):
    """Blobs resampled from 20-60 distinct points; object 0 one repeated
    point, object 1 eight distinct points in [0, 0.001)^3 repeated."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((B, 60, 3)) * [2.0, 2.0, 0.5] + 5
    counts = rng.integers(20, 61, (B, 1))
    pick = (rng.random((B, N)) * counts).astype(np.int64)
    pts = np.take_along_axis(base, pick[..., None], 1).astype(np.float32)
    if B > 1:
        pts[0] = 0.25
        pts[1] = (rng.random((8, 3)) * 1e-3)[np.arange(N) % 8]
    return pts


def _jax_fps(pts, S):
    return np.asarray(jax.jit(
        lambda p: jfps.farthest_point_sampling(p, S))(pts))


@pytest.mark.parametrize("N,S", [(201, 100), (255, 127), (33, 16), (7, 7),
                                 (256, 1), (1, 1)])
def test_plain_matches_jax_odd_sizes(N, S):
    """Odd N (lanes of the kernel's warp left empty), S = N, S = 1."""
    pts = _points(6, N, N)
    idx, cent = fps.farthest_point_sampling_plain(torch.from_numpy(pts), S)
    np.testing.assert_array_equal(idx.numpy(), _jax_fps(pts, S))
    assert idx.dtype == torch.long
    np.testing.assert_array_equal(
        cent.numpy(), np.take_along_axis(pts, idx.numpy()[..., None], 1))


def test_plain_matches_jax_through_the_tower_levels():
    """256 -> 128 -> 64 -> 32, each level's centroids the next level's
    points, as the PointNet++ tower chains them."""
    pts = _points(10, 256, 3)
    got, want = torch.from_numpy(pts), pts
    for S in (128, 64, 32):
        idx, got = fps.farthest_point_sampling_plain(got, S)
        widx = _jax_fps(want, S)
        np.testing.assert_array_equal(idx.numpy(), widx)
        want = np.take_along_axis(want, widx[..., None].astype(np.int64), 1)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N,ratios", [
    (256, (0.5, 0.5, 0.5)),          # the tower's levels
    (1100, (0.02, 0.5)),             # past 1024 points: a CTA an object
    (2048, (0.01, 0.5, 0.5)),
])
def test_levels_plain_matches_jax(N, ratios):
    """Indices equal and centroids bit for bit, each level on the last
    one's centroids, against JAX's function jitted level by level."""
    pts = _points(8, N, N)
    got = fps.farthest_point_sampling_levels_plain(torch.from_numpy(pts),
                                                   ratios)
    sizes = fps.level_sizes(N, ratios)
    assert [tuple(i.shape) for i, _ in got] == [(8, S) for S in sizes]
    want = pts
    for (idx, cent), S in zip(got, sizes):
        widx = _jax_fps(want, S).astype(np.int64)
        want = np.take_along_axis(want, widx[..., None], 1)
        np.testing.assert_array_equal(idx.numpy(), widx)
        np.testing.assert_array_equal(cent.numpy(), want)


def test_level_sizes_follow_the_set_abstraction_rule():
    assert fps.level_sizes(256, (0.5, 0.5, 0.5)) == [128, 64, 32]
    assert fps.level_sizes(3, (0.5, 0.5, 0.5)) == [1, 1, 1]
    assert fps.level_sizes(201, (0.5, 0.3)) == [100, 30]


def test_levels_wrapper_cpu_path_is_the_plain_loop():
    pts = torch.from_numpy(_points(5, 128, 9))
    got = fps.farthest_point_sampling_levels(pts, (0.5, 0.5, 0.5))
    want = fps.farthest_point_sampling_levels_plain(pts, (0.5, 0.5, 0.5))
    for (i, c), (wi, wc) in zip(got, want, strict=True):
        assert torch.equal(i, wi) and torch.equal(c, wc)


def _lane_points(N, G=32):
    """csrc/fps.cu ``lane_points``: exact up to 4, then 6, 8, 12, 16, 24,
    32."""
    p = -(-N // G)
    return p if p <= 4 else next(q for q in (6, 8, 12, 16, 24, 32) if p <= q)


def _first_max_tree(v, lo, hi):
    """The lane's tree over slots [lo, hi) of v [..., P]: (value, slot),
    the right half only where strictly larger."""
    if hi - lo == 1:
        return v[..., lo], np.full(v.shape[:-1], lo)
    mid = lo + (hi - lo + 1) // 2
    a, sa = _first_max_tree(v, lo, mid)
    b, sb = _first_max_tree(v, mid, hi)
    take = b > a
    return np.where(take, b, a), np.where(take, sb, sa)


def _pick(key, n):
    """Largest key over the last axis, then the lowest index among equal
    keys: (key, index)."""
    top = key.max(-1)
    first = np.where(key == top[..., None], n, np.iinfo(np.int64).max)
    return top, first.min(-1)


def kernel_first_argmax(d):
    """The kernel's choice of the first maximum of each row of d [R, N]
    (distances >= 0, -1 in empty slots), step by step as csrc/fps.cu takes
    it."""
    R, N = d.shape
    if N <= 4096:
        # Blocked: a warp (N <= 1024) or W warps of 16 points a lane.
        P = _lane_points(N) if N <= 1024 else 16
        T = 32 if N <= 1024 else 32 * -(-N // 512)
        v = np.full((R, T * P), -1.0, np.float32)
        v[:, :N] = d
        best, slot = _first_max_tree(v.reshape(R, T, P), 0, P)
        key = best.view(np.int32).reshape(R, T // 32, 32)
        n = (np.arange(T) * P + slot).reshape(R, T // 32, 32)
        top = key.max(-1)
        owner = np.argmax(key == top[..., None], -1)    # __ffs(ballot)
        wkey = np.take_along_axis(key, owner[..., None], -1)[..., 0]
        wn = np.take_along_axis(n, owner[..., None], -1)[..., 0]
    else:
        # Strided: thread t owns t, t + 256, ... (a strictly-larger chain),
        # then each warp's largest key and lowest index among its equals.
        T = 256
        K = -(-N // T)
        v = np.full((R, K * T), -1.0, np.float32)
        v[:, :N] = d
        v = v.reshape(R, K, T).transpose(0, 2, 1)
        k = np.argmax(v, -1)                            # first of the chain
        key = np.take_along_axis(v, k[..., None], -1)[..., 0].view(np.int32)
        n = np.arange(T) + T * k
        wkey, wn = _pick(key.reshape(R, T // 32, 32),
                         n.reshape(R, T // 32, 32))
    return _pick(wkey, wn)[1]     # across warps: largest, then lowest index


@pytest.mark.parametrize("N", [1, 31, 33, 64, 1000, 1025, 4097])
def test_kernel_selection_rule_is_first_argmax(N):
    """Rows of exact ties (values from four levels, all equal, the largest
    once at the end, a zero row), as FPS's minima are."""
    rng = np.random.default_rng(N)
    d = rng.choice(np.float32([0, 0.25, 1, 4]), (64, N)).astype(np.float32)
    d[0] = 1.0
    d[1] = 0.0
    d[2, :] = 0.25
    d[2, -1] = 4.0
    d[3] = rng.choice(np.float32([0.5, 2]), N, p=[0.99, 0.01])
    np.testing.assert_array_equal(kernel_first_argmax(d), np.argmax(d, -1))


def test_one_repeated_point_selects_index_zero():
    idx, cent = fps.farthest_point_sampling_plain(torch.full((3, 40, 3), 0.7),
                                                  9)
    assert bool((idx == 0).all()) and bool((cent == 0.7).all())


def test_wrapper_cpu_path_is_plain_with_a_gather():
    """On a CPU tensor the wrapper runs the plain version; its centroids are
    the gather of the points at the indices."""
    pts = torch.from_numpy(_points(5, 128, 4))
    idx, cent = fps.farthest_point_sampling(pts, 64)
    widx, _ = fps.farthest_point_sampling_plain(pts, 64)
    assert torch.equal(idx, widx)
    assert torch.equal(cent, torch.gather(pts, 1,
                                          idx[..., None].expand(5, 64, 3)))


@pytest.mark.parametrize("shape,S,dtype,err", [
    ((0, 16, 3), 8, torch.float32, ValueError),     # no object
    ((2, 16, 3), 17, torch.float32, ValueError),    # more samples than points
    ((2, 16, 3), 0, torch.float32, ValueError),
    ((2, 16, 3), 8, torch.float64, TypeError),
    ((2, 16, 2), 8, torch.float32, ValueError),     # not [B, N, 3]
])
def test_kernel_wrapper_rejects_before_building(shape, S, dtype, err):
    """The kernel wrapper's checks run before any build or launch, so they
    hold here too."""
    with pytest.raises(err):
        fps._fps_kernel(torch.zeros(shape, dtype=dtype), S)


@pytest.mark.parametrize("shape,ratios,dtype,err", [
    ((2, 16, 3), (0.5,) * 4, torch.float32, ValueError),  # over 3 levels
    ((2, 16, 3), (), torch.float32, ValueError),          # no level
    ((2, 16, 3), (0.5, 2.0), torch.float32, ValueError),  # more than N_l
    ((0, 16, 3), (0.5,), torch.float32, ValueError),      # no object
    ((2, 16, 3), (0.5,), torch.float64, TypeError),
    ((2, 16, 2), (0.5,), torch.float32, ValueError),      # not [B, N, 3]
    ((16, 3), (0.5,), torch.float32, ValueError),
])
def test_levels_kernel_wrapper_rejects_before_building(shape, ratios, dtype,
                                                       err):
    with pytest.raises(err):
        fps._fps_levels_kernel(torch.zeros(shape, dtype=dtype), ratios)
