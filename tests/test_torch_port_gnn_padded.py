"""The GNN's padded weight layout (``pack_gnn_params``), which both CUDA
forms read, and the second form's plan (``any_plan``), on the CPU.

- Every head is padded to a multiple of 16 channels in bf16 and of 4 in
  f32; the pads are exactly zero in every weight, bias and BN affine, and
  stripping them (``gnn_weights``) gives the folded weights back.
- Run at the padded width (descriptors padded with zeros, q|k|v by head),
  the plain arithmetic keeps every padded channel at exactly 0 and gives the
  plain version's scores: f32 within 1e-6 of the largest score (the same
  values summed by matrix products of other sizes, which the CPU blocks
  otherwise), bf16 within 1e-2 (such a sum can land on the other side of a
  bf16 rounding boundary, one bf16 step, 2^-8 relative).
- At E = 300 with one block pair and (T0, T1) in {(16, 6), (24, 6),
  (32, 32)} the plain version on the padded pack matches JAX's
  ``gnn_scores_pallas`` in interpret mode on numpy inputs from a seed: f32
  within 1e-5 (as ``test_torch_port_widths``), bf16 within 5% of the score
  scale (the JAX package's own bf16 bound: the Pallas kernel keeps its
  residual in bf16, the port in f32).
- The plan puts every bf16 shape of JAX's configurations at E <= 320 on
  the tensor-core route, fits each CTA's rows in 64 (bf16 and f32) and
  in an H100 CTA's shared memory, and matches the kernel's own row layout.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_widths import _gnn_trees
from text2pos_tpu.ops.superglue_gnn_pallas import fold_gnn_params as jfold
from text2pos_tpu.ops.superglue_gnn_pallas import gnn_scores_pallas
from text2pos_torch.ops import superglue_gnn as tgnn

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.bfloat16]
PAD_TOL = {torch.float32: 1e-6, torch.bfloat16: 1e-2}
JAX_TOL = {torch.float32: 1e-5, torch.bfloat16: 0.05}


def _pack(E, dtype, L=2, seed=0):
    folded = tgnn.random_folded_params(L, seed, width=E)
    return folded, tgnn.pack_gnn_params(folded, dtype, "cpu")


def _row_major(packed):
    """The pack's matmul weights row-major at the padded width."""
    frag = tgnn.fragment_ordered(packed)
    return {k: (tgnn.from_fragment_order(packed[k]) if frag
                else packed[k]).float() for k in tgnn.MATMUL_WEIGHTS}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E", [4, 128, 300, 512])
def test_pads_are_zero_and_strip_back(E, dtype):
    folded, packed = _pack(E, dtype)
    Ep = tgnn.padded_width(E, dtype)
    unit = 64 if dtype == torch.bfloat16 else 16
    assert Ep % unit == 0 and Ep - unit < E <= Ep
    assert tgnn.packed_width(packed) == Ep and tgnn.real_width(packed) == E
    assert tgnn.fragment_ordered(packed) == (dtype == torch.bfloat16)
    # Every entry outside the real rows and columns is exactly zero.
    mats = _row_major(packed)
    real_rows = {"wqkv": E, "wm": E, "w0": 2 * E, "w1": 2 * E, "wf": E}
    idx = tgnn._pad_index(E, Ep)
    arrays = {**mats, **{k: packed[k] for k in ("bqkv", "bm", "s0", "t0",
                                                "b1", "bf")}}
    for name, x in arrays.items():
        rows, cols = idx[name]
        keep = torch.zeros(x.shape[-2:] if rows is not None else x.shape[-1:],
                           dtype=torch.bool)
        if rows is None:
            keep[cols] = True
        else:
            keep[rows[:, None], cols[None, :]] = True
            assert len(rows) == real_rows[name]
        assert bool((x[..., ~keep] == 0).all()), name
        assert int(keep.sum()) == np.prod([len(i) for i in idx[name]
                                           if i is not None])
    # The real entries are the folded weights (matmul weights rounded to
    # the pack's dtype).
    want = dict(folded, wqkv=np.concatenate(
        [folded["wq"], folded["wk"], folded["wv"]], axis=2),
        bqkv=np.concatenate([folded["bq"], folded["bk"], folded["bv"]], 1))
    got = tgnn.gnn_weights(packed)
    assert set(got) == set(idx)
    for name, x in got.items():
        w = torch.from_numpy(want[name])
        if name in tgnn.MATMUL_WEIGHTS:
            w = w.to(dtype).float()
        assert torch.equal(x, w), name


def test_heads_are_padded_one_by_one():
    """q|k|v and the messages keep head h at h·Dp: channel c of E = 300
    (heads of 75) at 80·(c // 75) + c % 75 in bf16, 76·(c // 75) + c % 75
    in f32."""
    np.testing.assert_array_equal(tgnn.head_index(300, 320)[[0, 74, 75, 299]],
                                  [0, 74, 80, 314])
    np.testing.assert_array_equal(tgnn.head_index(300, 304)[[0, 74, 75, 299]],
                                  [0, 74, 76, 302])
    np.testing.assert_array_equal(tgnn.head_index(128, 128), np.arange(128))


def _largest(x):
    return float(x.abs().max()) if x.numel() else 0.0


def _padded_plain(desc0, desc1, packed):
    """The plain arithmetic at the padded width: descriptors padded with
    zeros, heads of Dp channels (the pads add zero terms), the scales of
    the real widths. Returns the scores and the largest magnitude any
    padded channel of the residual, q|k|v or md reaches."""
    dt = packed["wqkv"].dtype

    def rnd(x):
        return x.to(dt).float()

    E, Ep = tgnn.real_width(packed), tgnn.packed_width(packed)
    D, Dp = E // tgnn.HEADS, Ep // tgnn.HEADS
    mats = _row_major(packed)

    def w(name, l=None):
        x = mats[name] if name in mats else packed[name].float()
        return x if l is None else x[l]

    pad = torch.ones(Ep, dtype=torch.bool)
    pad[:E] = False
    head_pad = torch.ones(Ep, dtype=torch.bool)
    head_pad[torch.from_numpy(tgnn.head_index(E, Ep))] = False
    N, T0, _ = desc0.shape
    res = torch.nn.functional.pad(torch.cat([desc0, desc1], 1).float(),
                                  (0, Ep - E))
    set1 = torch.arange(res.shape[1]) >= T0
    leak = 0.0
    for l in range(packed["wqkv"].shape[0]):
        cross = l % 2 == 1
        a = rnd(res)
        qkv = rnd(a @ w("wqkv", l) + w("bqkv", l))
        q, k, v = (x.unflatten(-1, (tgnn.HEADS, Dp)) for x in qkv.split(Ep, -1))
        leak = max(leak, _largest(qkv.unflatten(-1, (3, Ep))[..., head_pad]))
        msg = torch.empty_like(q)
        for own, other in ((slice(0, T0), slice(T0, None)),
                           (slice(T0, None), slice(0, T0))):
            src = other if cross else own
            s = torch.einsum("bnhd,bmhd->bhnm", q[:, own], k[:, src])
            p = rnd(torch.softmax(s / math.sqrt(D), dim=-1))
            msg[:, own] = torch.einsum("bhnm,bmhd->bnhd", p, v[:, src])
        m = rnd(rnd(msg.flatten(2)) @ w("wm", l) + w("bm", l))
        h = torch.cat([a, m], dim=-1) @ w("w0", l)
        s0 = torch.where(set1[:, None], w("s0", l)[1], w("s0", l)[0])
        t0 = torch.where(set1[:, None], w("t0", l)[1], w("t0", l)[0])
        h1 = rnd(torch.relu(h * s0 + t0))
        res = res + rnd(h1 @ w("w1", l) + w("b1", l))
        leak = max(leak, _largest(res[..., pad]))
    md = rnd(rnd(res) @ w("wf") + w("bf"))
    leak = max(leak, _largest(md[..., pad]))
    return md[:, :T0] @ md[:, T0:].transpose(1, 2) / math.sqrt(E), leak


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,T0,T1", [(300, 16, 6), (300, 24, 6), (4, 3, 2),
                                     (128, 16, 16)])
def test_padded_arithmetic_equals_the_plain_version(E, T0, T1, dtype):
    _, packed = _pack(E, dtype, L=4, seed=E)
    rng = np.random.default_rng(T0)
    d0 = torch.from_numpy(rng.standard_normal((3, T0, E)).astype(np.float32))
    d1 = torch.from_numpy(rng.standard_normal((3, T1, E)).astype(np.float32))
    want = tgnn.gnn_scores_plain(d0, d1, packed)
    got, leak = _padded_plain(d0, d1, packed)
    assert leak == 0.0
    torch.testing.assert_close(got, want, rtol=0, atol=PAD_TOL[dtype]
                               * float(want.abs().max()))


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("T0,T1", [(16, 6), (24, 6), (32, 32)])
def test_padded_plain_matches_pallas_at_e300(T0, T1, dtype, jdtype):
    """One block pair at JAX's default width, the plain version on the
    padded pack against JAX's Pallas kernel in interpret mode."""
    E = 300
    trees = _gnn_trees(E, 1, seed=E + T0 + T1)
    rng = np.random.default_rng(T0 + T1)
    d0 = rng.standard_normal((3, T0, E)).astype(np.float32)
    d1 = rng.standard_normal((3, T1, E)).astype(np.float32)
    folded = jfold(*trees, 1)
    want = np.asarray(gnn_scores_pallas(
        jnp.asarray(d0), jnp.asarray(d1),
        {k: jnp.asarray(v) for k, v in folded.items()}, 1,
        pairs_per_program=4, dtype=jdtype, interpret=True))
    packed = tgnn.pack_gnn_params(tgnn.fold_gnn_params(*trees, 1), dtype,
                                  "cpu")
    assert tgnn.packed_width(packed) == (320 if dtype == torch.bfloat16
                                         else 304)
    got = tgnn.gnn_scores(torch.from_numpy(d0), torch.from_numpy(d1),
                          packed).numpy()
    assert got.shape == (3, T0, T1)
    tol = JAX_TOL[dtype]
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    else:
        assert np.abs(got - want).max() / np.abs(want).max() < tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_sums_in_float64(dtype):
    """``acc=torch.float64`` changes only the sums' precision: f32 scores,
    within the f32 checks' 1e-5 of the largest score of the f32 sums (with
    f32 weights nothing is rounded between the sums), and within the bf16
    checks' 1e-2 with bf16 weights (a changed sum can move a value by one
    bf16 step at a rounding point)."""
    _, packed = _pack(300, dtype)
    g = torch.Generator().manual_seed(11)
    d0, d1 = torch.randn(3, 24, 300, generator=g), torch.randn(3, 6, 300,
                                                             generator=g)
    f32 = tgnn.gnn_scores_plain(d0, d1, packed)
    f64 = tgnn.gnn_scores_plain(d0, d1, packed, acc=torch.float64)
    assert f64.dtype == torch.float32 and f64.shape == (3, 24, 6)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    assert float((f64 - f32).abs().max()) <= tol * float(f32.abs().max())


def test_plain_version_refuses_another_width():
    _, packed = _pack(300, torch.float32)
    with pytest.raises(ValueError, match="width 300"):
        tgnn.gnn_scores_plain(torch.zeros(2, 16, 296), torch.zeros(2, 6, 296),
                              packed)


# (E, pad_size, num_mentioned) of JAX's configurations at E <= 320: the
# default width at every pad_size, the bench width past its tuned shape.
JAX_SHAPES = [(E, T0, T1) for E in (300, 128, 256, 320) for T0 in (16, 24, 32)
              for T1 in (1, 6, 8, 16, T0) if T1 <= T0]


@pytest.mark.parametrize("E,T0,T1", JAX_SHAPES)
def test_plan_takes_the_tensor_cores_in_bf16(E, T0, T1):
    plan = tgnn.any_plan(E, T0, T1, torch.bfloat16)
    assert plan.route == "superglue_gnn_any"
    assert plan.width == tgnn.padded_width(E, torch.bfloat16)
    rows = 16 * (-(-plan.pairs * T0 // 16) + -(-plan.pairs * T1 // 16))
    assert plan.rows == rows <= tgnn.MAX_TC_ROWS and rows % 16 == 0
    assert plan.smem == rows * 2 * (2 * plan.width + 8) * 2 \
        <= tgnn.SMEM_OPTIN
    # One more pair would not fit.
    more = 16 * (-(-(plan.pairs + 1) * T0 // 16)
                 + -(-(plan.pairs + 1) * T1 // 16))
    assert more > tgnn.MAX_TC_ROWS or \
        more * 2 * (2 * plan.width + 8) * 2 > tgnn.SMEM_OPTIN


@pytest.mark.parametrize("E,T0,T1,dtype,route,pairs", [
    (300, 16, 6, torch.bfloat16, "superglue_gnn_any", 2),   # the headline
    (300, 16, 6, torch.float32, "superglue_gnn_any", 2),
    (300, 24, 6, torch.float32, "superglue_gnn_any", 1),
    (300, 32, 32, torch.float32, "superglue_gnn_any_wide", 1),
    (512, 32, 32, torch.bfloat16, "superglue_gnn_any_wide", 2),
    (448, 32, 32, torch.bfloat16, "superglue_gnn_any", 1),
    (512, 16, 6, torch.bfloat16, "superglue_gnn_any", 2),
    (300, 24, 6, torch.bfloat16, "superglue_gnn_any", 2),   # 64 rows
    (4, 1, 1, torch.bfloat16, "superglue_gnn_any", 32),
])
def test_plan_routes(E, T0, T1, dtype, route, pairs):
    plan = tgnn.any_plan(E, T0, T1, dtype)
    assert (plan.route, plan.pairs) == (route, pairs)


@pytest.mark.parametrize("E,T0,T1", JAX_SHAPES)
def test_plan_gives_the_first_hint_row(E, T0, T1):
    """On the tensor-core route the CTA's hints start at the first 16-row
    tile past its pairs' objects, and all of them fit in its rows; the f32
    shared route keeps rows pair by pair and has no such row, the wide
    route is set-major in f32 too."""
    plan = tgnn.any_plan(E, T0, T1, torch.bfloat16)
    h = plan.hint_row
    assert h % 16 == 0 and h - 16 < plan.pairs * T0 <= h
    assert h + plan.pairs * T1 <= plan.rows
    f32 = tgnn.any_plan(E, T0, T1, torch.float32)
    if f32.route == "superglue_gnn_any":
        assert f32.hint_row is None
    else:
        assert f32.hint_row == 16 * -(-f32.pairs * T0 // 16)


def test_hint_rows_of_the_tensor_core_route():
    """The bf16 route's rows at G = 2: at (16, 6) objects in rows 0-31,
    hint j of the CTA's pair p in row 32 + 6·p + j, padding rows 44-47; at
    (16, 12) hint j of pair p in row 32 + 12·p + j, so hints 3 and 4 of the
    second pair (rows 47 and 48) straddle two 16-row tiles, the case the
    card tests use for exact ties across tiles."""
    for T1, rows in ((6, 48), (12, 64)):
        plan = tgnn.any_plan(300, 16, T1, torch.bfloat16)
        G = plan.pairs
        hint_row = plan.hint_row + T1 * np.arange(G)[:, None] + np.arange(T1)
        assert (G, plan.hint_row, plan.rows) == (2, 32, rows)
        assert hint_row.max() < plan.rows
    tiles = hint_row // 16
    assert tiles[1, 3] != tiles[1, 4] and (tiles[0] == 2).all()
