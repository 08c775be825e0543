"""The port past JAX's default widths, against the JAX package on the CPU:
every width JAX runs, which the kernels take since the LSTM's grid form
(H > 512), the GNN second form's wide route for any E a multiple of 4 and
any T1 <= T0 (past 32 objects every shape) and Sinkhorn's wide form (past
32 x 16 couplings).

- The LSTM's plain version (what every form computes) against JAX's
  ``bilstm_final_hidden(impl="xla")`` at H = 544 and 768, f32 within 1e-5
  (the grid form's W_hh fragments: ``test_torch_port_widths``).
- ``gnn_scores`` on the CPU against JAX's Pallas kernel in interpret mode
  at (516, 16, 6), (768, 16, 6), (300, 40, 6) and (128, 48, 48), one block
  pair, f32 within 1e-5; the padded pack at E = 516, 768 and 1024 (zero pads,
  stripped back to the folded weights); ``any_plan``'s route at the new
  shapes, and the parent's plan at every shape the parent took on a
  shared route; the wide route's plan (G pairs a CTA, set-major rows, the
  first hint row) and its workspace formula, held to the L2 budget at
  phase 14's shape.
- Sinkhorn's plain version against JAX's ``log_optimal_transport`` at
  couplings past 32 x 16.
- The slice: ``test_torch_port_calibration``'s pipelines at embed_dim 768,
  pad_size 48, one block pair: ``encode_text`` within 1e-5 of JAX's, and
  calibrated f32 ``serve_batch`` with JAX's ``top_idx`` and match counts,
  positions within 2^-11.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_gnn_padded as padded
from test_torch_port_kernels_wide import wide_workspace_bytes
from test_torch_port_calibration import TINY as CAL_TINY
from test_torch_port_calibration import _bank_draws, _draws, make_tiny
from test_torch_port_widths import _gnn_trees
from text2pos_tpu.ops.lstm import LSTMParams as JLSTMParams
from text2pos_tpu.ops.lstm import bilstm_final_hidden as jbilstm
from text2pos_tpu.ops.sinkhorn import log_optimal_transport as jlot
from text2pos_tpu.ops.superglue_gnn_pallas import fold_gnn_params as jfold
from text2pos_tpu.ops.superglue_gnn_pallas import gnn_scores_pallas
from text2pos_torch.ops import lstm as tlstm
from text2pos_torch.ops import sinkhorn as tsink
from text2pos_torch.ops import superglue_gnn as tgnn

torch.set_num_threads(2)

F32_TOL = 1e-5
WIDEST = dict(CAL_TINY, embed_dim=768, num_layers=1, pad_size=48,
              coarse_max_objects=48)
TOP_K, Q = 3, 8


@pytest.mark.parametrize("H", [544, 768, 1024, 2048])
def test_lstm_plain_matches_jax_past_512(H):
    """Both directions' mean over embedded tokens: the port's
    ``bilstm_final_hidden`` (x·W_ih + b as a table, then the plain
    recurrence the grid form computes) against JAX's XLA scan."""
    rng = np.random.default_rng(H)
    B, T, E = 5, 7, 24
    x = rng.standard_normal((B, T, E)).astype(np.float32)
    lengths = np.array([7, 1, 4, 7, 2], np.int32)
    params = [tuple((rng.standard_normal(s) * c).astype(np.float32)
                    for s, c in (((E, 4 * H), E ** -0.5),
                                 ((H, 4 * H), H ** -0.5), ((4 * H,), 0.1)))
              for _ in range(2)]
    want = np.asarray(jbilstm(jnp.asarray(x), jnp.asarray(lengths),
                              *(JLSTMParams(*map(jnp.asarray, p))
                                for p in params), impl="xla"))
    got = tlstm.bilstm_final_hidden(
        torch.from_numpy(x), torch.from_numpy(lengths),
        *(tlstm.LSTMParams(*map(torch.from_numpy, p)) for p in params))
    assert got.shape == (B, H)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("E,T0,T1", [(516, 16, 6), (768, 16, 6),
                                     (300, 40, 6), (128, 48, 48)])
def test_gnn_plain_matches_pallas_past_512_and_32(E, T0, T1):
    """The second form's plain twin against JAX's Pallas kernel, f32, one
    block pair."""
    trees = _gnn_trees(E, 1, seed=E + T0)
    rng = np.random.default_rng(T0 + T1)
    d0 = rng.standard_normal((3, T0, E)).astype(np.float32)
    d1 = rng.standard_normal((3, T1, E)).astype(np.float32)
    want = np.asarray(gnn_scores_pallas(
        jnp.asarray(d0), jnp.asarray(d1),
        {k: jnp.asarray(v) for k, v in jfold(*trees, 1).items()}, 1,
        pairs_per_program=4, dtype=jnp.float32, interpret=True))
    packed = tgnn.pack_gnn_params(tgnn.fold_gnn_params(*trees, 1),
                                  torch.float32, "cpu")
    got = tgnn.gnn_scores(torch.from_numpy(d0), torch.from_numpy(d1),
                          packed).numpy()
    assert got.shape == (3, T0, T1)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("dtype", padded.DTYPES)
@pytest.mark.parametrize("E", [516, 768, 1024])
def test_pack_pads_are_zero_and_strip_back_past_512(E, dtype):
    padded.test_pads_are_zero_and_strip_back(E, dtype)


def _parent_any_plan(E, T0, T1, dtype):
    """``any_plan`` as it stood when the second form took T0 <= 32 and E <=
    512 only: the plan every such shape must still get."""
    Ep = tgnn.padded_width(E, dtype)
    bf16 = dtype == torch.bfloat16
    if bf16:
        def rows(g):
            return 16 * (-(-g * T0 // 16) + -(-g * T1 // 16))
        cap, row_bytes = 64, 2 * (2 * Ep + 8) * 2
    else:
        def rows(g):
            return g * (T0 + T1)
        cap, row_bytes = 64, 2 * (2 * Ep + 4) * 4
    g = 0
    while rows(g + 1) <= cap and rows(g + 1) * row_bytes <= 232448:
        g += 1
    if g == 0:
        return tgnn.AnyPlan("superglue_gnn_any_wide", Ep, 1, T0 + T1, 0, None)
    return tgnn.AnyPlan("superglue_gnn_any", Ep, g, rows(g),
                        rows(g) * row_bytes,
                        16 * -(-g * T0 // 16) if bf16 else None)


@pytest.mark.parametrize("dtype", padded.DTYPES)
def test_plan_unchanged_where_the_parent_took_the_shape(dtype):
    """Every E a multiple of 4 up to 512 and 1 <= T1 <= T0 <= 32: the
    shared routes' plans as they were; where the parent took the wide
    route, the wide route still, at the pairs a CTA ``wide_plan`` gives."""
    for E in range(4, 513, 4):
        for T0 in range(1, 33):
            for T1 in range(1, T0 + 1):
                got = tgnn.any_plan(E, T0, T1, dtype)
                want = _parent_any_plan(E, T0, T1, dtype)
                if want.route == "superglue_gnn_any_wide":
                    assert got == tgnn.wide_plan(E, T0, T1, dtype), \
                        (E, T0, T1)
                else:
                    assert got == want, (E, T0, T1)


# (E, T0, T1, dtype, route, pairs a CTA): the wide route takes G pairs a
# CTA, set-major, up to 128 rows and WIDE_L2_BUDGET of re-read rows.
PLANS_PAST_512_AND_32 = [
    (768, 48, 6, torch.bfloat16, "superglue_gnn_any_wide", 1),  # phase 14
    (768, 48, 6, torch.float32, "superglue_gnn_any_wide", 1),
    (516, 16, 6, torch.bfloat16, "superglue_gnn_any", 2),
    (516, 16, 6, torch.float32, "superglue_gnn_any", 1),
    (768, 16, 6, torch.bfloat16, "superglue_gnn_any", 1),
    (768, 16, 6, torch.float32, "superglue_gnn_any_wide", 2),
    (896, 16, 6, torch.bfloat16, "superglue_gnn_any", 1),       # 32 rows
    (960, 16, 6, torch.bfloat16, "superglue_gnn_any_wide", 2),
    (1024, 64, 16, torch.bfloat16, "superglue_gnn_any_wide", 1),
    (300, 33, 6, torch.bfloat16, "superglue_gnn_any_wide", 2),  # 33 objects
    (4, 33, 1, torch.float32, "superglue_gnn_any_wide", 3),
    (128, 128, 6, torch.bfloat16, "superglue_gnn_any_wide", 1),
]


@pytest.mark.parametrize("E,T0,T1,dtype,route,pairs", PLANS_PAST_512_AND_32)
def test_plan_routes_past_512_and_32(E, T0, T1, dtype, route, pairs):
    """Past SHARED_MAX_T objects every shape takes the wide route; past E =
    512 the shared routes take what fits in a CTA's shared memory."""
    plan = tgnn.any_plan(E, T0, T1, dtype)
    assert (plan.route, plan.pairs) == (route, pairs)
    assert plan.width == tgnn.padded_width(E, dtype)
    if route == "superglue_gnn_any":
        assert plan.smem <= tgnn.SMEM_OPTIN
        assert T0 <= tgnn.MAX_SHARED_SET


@pytest.mark.parametrize("E,T0,T1,dtype,route,pairs", [
    p for p in PLANS_PAST_512_AND_32 if p[4] == "superglue_gnn_any_wide"])
def test_wide_plan_rows_and_hint_row(E, T0, T1, dtype, route, pairs):
    """The wide plan's G pairs are set-major in 16-row tiles (objects of
    all G, then their hints from ``hint_row``), at most one m-chunk of
    128 rows and WIDE_L2_BUDGET of re-read rows unless G = 1, and one more
    pair would pass one of the two."""
    plan = tgnn.any_plan(E, T0, T1, dtype)
    G, Ep = plan.pairs, plan.width
    assert plan.hint_row == 16 * -(-G * T0 // 16)
    assert plan.rows == plan.hint_row + 16 * -(-G * T1 // 16)
    assert plan.rows == tgnn.set_major_rows(G, T0, T1) and plan.rows % 16 == 0
    assert plan.hint_row + G * T1 <= plan.rows
    assert plan.smem == tgnn.WIDE_SMEM[dtype] <= tgnn.SMEM_OPTIN

    def fits(g):
        rows = tgnn.set_major_rows(g, T0, T1)
        return rows <= tgnn.WIDE_MAX_ROWS and \
            tgnn.wide_hot_bytes(Ep, rows, dtype) <= tgnn.WIDE_L2_BUDGET

    assert G == 1 or fits(G)
    assert not fits(G + 1)


@pytest.mark.parametrize("dtype", padded.DTYPES)
def test_wide_workspace_under_the_l2_budget_at_phase_14(dtype):
    """At phase 14's (768, 48, 6) on an H100 the wide route runs a CTA an
    SM (132) of 64 rows, one pair each; the rows its CTAs re-read within a
    product stay under WIDE_L2_BUDGET in bf16 (26 MB of 107 MB of slices,
    the card tests hold the C side to ``wide_workspace_bytes``); in f32 one
    pair's rows already pass it (52 MB), and G stays 1."""
    plan = tgnn.any_plan(768, 48, 6, dtype)
    assert (plan.pairs, plan.rows) == (1, 64)
    ws = wide_workspace_bytes(48, dtype, plan, 1280)
    hot = tgnn.wide_hot_bytes(768, 64, dtype)
    if dtype == torch.bfloat16:
        assert ws == 132 * (64 * 768 * 16 + 8 * 3 * 1024)
        assert hot == 132 * 64 * 1536 * 2 <= tgnn.WIDE_L2_BUDGET
    else:
        assert ws == 132 * (64 * 768 * 24 + 64 * 4 * 48 * 4)
        assert hot == 132 * 64 * 1536 * 4 > tgnn.WIDE_L2_BUDGET
    assert ws < 2 ** 28


@pytest.mark.parametrize("B,M,N,iters", [(4, 48, 6, 50), (3, 32, 6, 20),
                                         (2, 64, 40, 10), (2, 16, 16, 5),
                                         (4, 48, 6, 0), (4, 48, 6, 1),
                                         (3, 64, 16, 50), (2, 32, 32, 50),
                                         (2, 32, 32, 1)])
def test_sinkhorn_plain_matches_jax_past_32_by_16(B, M, N, iters):
    """Dustbins, marginals and - norm around the plain Sinkhorn (what the
    wide form computes) against JAX's XLA loop, scores [B, M, N] to +-30."""
    rng = np.random.default_rng(M * N)
    scores = np.clip(10 * rng.standard_normal((B, M, N)), -30,
                     30).astype(np.float32)
    want = np.asarray(jlot(jnp.asarray(scores), jnp.asarray(0.7), iters,
                           impl="xla"))
    got = tsink.log_optimal_transport_plain(
        torch.from_numpy(scores), torch.tensor(0.7), iters).numpy()
    assert got.shape == (B, M + 1, N + 1)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.fixture(scope="module")
def widest(synthetic_data, tmp_path_factory):
    """``test_torch_port_calibration``'s pipelines at embed_dim 768, one
    block pair, pad_size 48, and both calibrated."""
    t = make_tiny(synthetic_data, tmp_path_factory.mktemp("widest"), WIDEST)
    jcal, jbank = t["jpipe"].calibrated_for_serving(
        t["bank"], t["bank_dev"], t["htk"], t["hln"], t["cal_idx"])
    cfg = t["cfg"]
    n = min(t["bank"].num_cells, 128)
    tcal = t["port"].calibrated_for_serving(
        t["tbank"], t["htk"], t["hln"], t["cal_idx"],
        sample_draws=_draws(jax.random.PRNGKey(0), n, cfg.pad_size,
                            cfg.pointnet_numpoints),
        bank_draws=_bank_draws(t))
    return dict(t, jcal=jcal, jbank=jbank, tcal=tcal)


def test_widest_encode_text_matches_jax(widest):
    tok, ln = widest["args"][:2]
    jp = widest["jcal"]
    want = np.asarray(jp.coarse.model.apply(
        {"params": jp.coarse_state.params,
         "batch_stats": jp.coarse_state.batch_stats},
        jnp.asarray(tok), jnp.asarray(ln),
        method=jp.coarse.model.encode_text))
    with torch.no_grad():
        got = widest["tcal"].coarse.encode_text(torch.from_numpy(tok),
                                                torch.from_numpy(ln))
    assert got.shape == (Q, 768)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


def test_widest_calibrated_serving_matches_jax(widest):
    """f32 serving from the calibrated pipelines at E = 768, pad_size 48:
    identical top_idx and match counts, positions within 2^-11."""
    jcal, jbank, tcal = widest["jcal"], widest["jbank"], widest["tcal"]
    assert tcal.fine_bank_enc.shape[1:] == (48, 768)
    want = jcal.serve_batch(jcal.coarse_state, jcal.fine_state,
                            *map(jnp.asarray, widest["args"]),
                            jnp.asarray(widest["cell_enc"]), TOP_K, jbank[0],
                            jbank[1])
    got = tcal.serve_batch(*widest["args"], TOP_K)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].float().numpy(),
                               np.asarray(want[2], np.float32),
                               atol=2.0 ** -11, rtol=0)
