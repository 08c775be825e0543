"""The port's farthest-point sampling against the JAX package (CPU: the plain
version, which is both the CPU path and the spec of the ``csrc/fps.cu``
kernel; the kernel itself is held bit for bit against it on the card by
``test_torch_port_kernels.py``).

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
    ((2, 1025, 3), 8, torch.float32, ValueError),   # over the kernel's 1024
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
