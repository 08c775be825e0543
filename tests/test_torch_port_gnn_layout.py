"""Host-side layout code of the port's tensor-core GNN kernel
(``text2pos_torch/ops/superglue_gnn.py``): the fragment order of the bf16
weights, the set-major row layout of a CTA, and the plain version on the
packed weights against the JAX package's Pallas kernel in interpret mode.
All of it is index code and runs on the CPU; the kernel itself is held
against the plain version on the card by ``test_torch_port_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2pos_tpu.ops.superglue_gnn_pallas import gnn_scores_pallas
from text2pos_torch.ops import superglue_gnn as tgnn

torch.set_num_threads(2)

F32_TOL = 1e-4   # f32 on both sides, different summation order


def _folded(E, L, seed=0):
    return tgnn.random_folded_params(L, seed, width=E)


# The bf16 kernel's row layout (``csrc/superglue_gnn.cu``, namespace tc),
# repeated here so that what the card tests and ``chip_smoke.py`` assume of
# it (which hints of which pair lie in different 16-row tiles) is checked
# where no card is: a CTA holds G pairs in ROWS rows, set-major.
G, ROWS = tgnn.TC_PAIRS, 96
_, T0, T1 = tgnn.KERNEL_SHAPE


def cta_rows(n_pairs):
    """``(obj [N, 16], hint [N, 6])`` of global row numbers ``ROWS · cta +
    row``: a CTA's rows are its pairs' objects, then their hints, then
    padding."""
    pair = np.arange(n_pairs)
    base, p = ROWS * (pair // G), pair % G
    obj = (base + T0 * p)[:, None] + np.arange(T0)
    hint = (base + G * T0 + T1 * p)[:, None] + np.arange(T1)
    return obj, hint


def cta_row_tokens(n_pairs):
    """Inverse of ``cta_rows``: for every row of every CTA the token it
    holds as ``(pair, set, index)``, or ``(-1, -1, -1)`` for a padding row
    (zero rows and the rows of pairs past the last)."""
    rows = np.arange(-(-n_pairs // G) * ROWS)
    cta, r = rows // ROWS, rows % ROWS
    is_obj, is_hint = r < G * T0, r < G * (T0 + T1)
    u = r - G * T0
    pair = G * cta + np.where(is_obj, r // T0, u // T1)
    out = np.stack([pair, np.where(is_obj, 0, 1),
                    np.where(is_obj, r % T0, u % T1)], axis=1)
    out[~is_hint | (pair >= n_pairs)] = -1
    return out


@pytest.mark.parametrize("shape", [(16, 8), (32, 96), (3, 64, 24),
                                   (2, 256, 128)])
def test_fragment_order_round_trips(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    f = tgnn.to_fragment_order(w)
    K, N = shape[-2:]
    assert f.shape == shape[:-2] + (N // 8, K // 16, 32, 4)
    back = tgnn.from_fragment_order(torch.from_numpy(np.ascontiguousarray(f)))
    np.testing.assert_array_equal(back.numpy(), w)


def test_fragment_order_is_the_mma_b_operand():
    """Lane 4·g + t of the (n-tile, k-step) block holds column g of the tile
    at k = 2t, 2t + 1 (first register) and 2t + 8, 2t + 9 (second)."""
    K, N = 64, 40
    w = np.arange(K * N, dtype=np.float32).reshape(K, N)
    f = tgnn.to_fragment_order(w)
    for nt, ks, lane in [(0, 0, 0), (4, 3, 31), (2, 1, 13), (3, 2, 6)]:
        g, t = lane // 4, lane % 4
        rows = 16 * ks + np.array([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9])
        np.testing.assert_array_equal(f[nt, ks, lane], w[rows, 8 * nt + g])


def test_fragment_order_rejects_ragged_shapes():
    with pytest.raises(ValueError):
        tgnn.to_fragment_order(np.zeros((24, 16), np.float32))
    with pytest.raises(ValueError):
        tgnn.to_fragment_order(np.zeros((32, 12), np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unpacking_gives_the_folded_weights_back(dtype):
    folded = _folded(32, 2)
    packed = tgnn.pack_gnn_params(folded, dtype, "cpu")
    assert packed["wqkv"].shape[0] == 2 and packed["wqkv"].dtype == dtype
    if dtype == torch.bfloat16:
        # Heads of 8 channels padded to 16: the width 32 is packed as 64.
        assert packed["w0"].shape == (2, 16, 8, 32, 4)
        assert packed["wf"].shape == (8, 4, 32, 4)
    else:
        assert packed["w0"].shape == (2, 64, 64)
    mats = tgnn.matmul_weights(packed)
    want = dict(folded, wqkv=np.concatenate(
        [folded["wq"], folded["wk"], folded["wv"]], axis=2))
    for name in tgnn.MATMUL_WEIGHTS:
        w = torch.from_numpy(want[name]).to(dtype).float()
        torch.testing.assert_close(mats[name], w, atol=0, rtol=0)
    stripped = tgnn.gnn_weights(packed)
    for name in ("bm", "s0", "t0", "b1", "bf"):
        assert packed[name].dtype == torch.float32
        np.testing.assert_array_equal(stripped[name].numpy(), folded[name])


@pytest.mark.parametrize("dtype,jdtype,tol", [
    (torch.float32, jnp.float32, None), (torch.bfloat16, jnp.bfloat16, 0.05)])
def test_plain_on_packed_weights_matches_pallas(dtype, jdtype, tol):
    """The same check as ``test_torch_port_ops.TestGNN`` at another width
    and depth: f32 to 1e-4; bf16 to 5% of the score scale (the Pallas kernel
    keeps its residual in bf16, the port in f32 as the XLA eval path)."""
    E, layers, N = 64, 2, 5
    folded = _folded(E, 2 * layers, seed=3)
    rng = np.random.default_rng(4)
    d0 = rng.standard_normal((N, 16, E)).astype(np.float32)
    d1 = rng.standard_normal((N, 6, E)).astype(np.float32)
    want = np.asarray(gnn_scores_pallas(
        jnp.asarray(d0), jnp.asarray(d1),
        {k: jnp.asarray(v) for k, v in folded.items()}, layers,
        pairs_per_program=4, dtype=jdtype, interpret=True))
    packed = tgnn.pack_gnn_params(folded, dtype, "cpu")
    got = tgnn.gnn_scores(torch.from_numpy(d0), torch.from_numpy(d1),
                          packed).numpy()
    if tol is None:
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < tol


@pytest.mark.parametrize("n_pairs", [1, 3, 4, 5, 37])
def test_cta_rows_round_trip(n_pairs):
    R = ROWS
    obj, hint = cta_rows(n_pairs)
    tokens = cta_row_tokens(n_pairs)
    n_ctas = -(-n_pairs // G)
    assert obj.shape == (n_pairs, T0) and hint.shape == (n_pairs, T1)
    assert tokens.shape == (n_ctas * R, 3)
    pair = np.arange(n_pairs)[:, None]
    for rows, s, T in ((obj, 0, T0), (hint, 1, T1)):
        np.testing.assert_array_equal(tokens[rows][..., 0],
                                      np.broadcast_to(pair, rows.shape))
        assert (tokens[rows][..., 1] == s).all()
        np.testing.assert_array_equal(tokens[rows][..., 2],
                                      np.broadcast_to(np.arange(T),
                                                      rows.shape))
    # Every token has its own row; the rest is padding.
    used = np.concatenate([obj.ravel(), hint.ravel()])
    assert len(np.unique(used)) == n_pairs * (T0 + T1)
    real = tokens[:, 0] >= 0
    assert real.sum() == n_pairs * (T0 + T1)
    for r in np.flatnonzero(real):
        p, s, i = tokens[r]
        assert (obj if s == 0 else hint)[p, i] == r
    # A 16-row tile belongs to one set, a pair's objects are one tile, and a
    # pair stays inside its CTA.
    sets = np.where(real, tokens[:, 1], -1).reshape(-1, 16)
    for tile in sets:
        assert len(set(tile[tile >= 0])) <= 1
    assert (obj // 16 == obj[:, :1] // 16).all()
    assert (obj // R == pair // G).all() and (hint // R == pair // G).all()


def test_duplicate_hints_can_straddle_tiles():
    """Hints 3 and 4 of a CTA's third pair lie in different 16-row tiles:
    the case the card tests use for exact ties across tiles."""
    _, hint = cta_rows(8)
    tile = hint % ROWS // 16
    # The closed form chip_smoke.py counts straddling ties with.
    pair, j = np.arange(8)[:, None], np.arange(T1)
    np.testing.assert_array_equal(tile, (G * T0 + T1 * (pair % G) + j) // 16)
    assert tile[2, 3] != tile[2, 4] and tile[6, 3] != tile[6, 4]
    assert (tile[[0, 1, 3]] == tile[[0, 1, 3], :1]).all()


def test_kernel_wrapper_rejects_other_layouts():
    """The shape and dtype checks come before any build or launch."""
    E, T0, T1 = tgnn.KERNEL_SHAPE
    folded = _folded(E, 1)
    d0, d1 = torch.zeros(2, T0, E), torch.zeros(2, T1, E)
    packed = tgnn.pack_gnn_params(folded, torch.bfloat16, "cpu")
    row_major = dict(packed, w0=torch.zeros(1, 2 * E, 2 * E,
                                            dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="w0"):
        tgnn._gnn_kernel(d0, d1, row_major)
    mixed = dict(packed, wm=packed["wm"].float())
    with pytest.raises(ValueError, match="wm"):
        tgnn._gnn_kernel(d0, d1, mixed)
    # Width 64 goes to the second form, which takes it, but not with
    # weights of width 128.
    with pytest.raises(ValueError, match="weight wqkv"):
        tgnn._gnn_kernel(torch.zeros(2, T0, 64), torch.zeros(2, T1, 64),
                         packed)
    half = {k: v.half() for k, v in packed.items()}
    with pytest.raises(TypeError):
        tgnn._gnn_kernel(d0, d1, half)
