"""The kernels' host side at the widths JAX's configurations give, and the
port at JAX's default embed_dim 300 against the JAX package on the CPU.

- The LSTM wrapper pads H to a multiple of 32 (``kernel_width``): the
  padded plain recurrence keeps every padded unit at exactly 0 and the real
  units at the unpadded values (within 1e-6: the CPU's matrix products
  block sums by the padded width; the kernel adds the padding's zero terms
  after the real ones, which leaves them bit for bit). Past 256 the kernel
  reads W_hh in the fragment order ``w_hh_fragments`` packs, held against a
  Python mirror of the kernel's own fill loop.
- The GNN's plain version, on a pack padded to heads of 76 (f32) and
  stripped back to the real width: at E = 300 (heads of 75, scales 1/√75
  and 1/√300), T0 = 24 and T0 = 32 against JAX's Pallas kernel in
  interpret mode, f32 within 1e-5 (as ``test_torch_port_ops``); the padded
  layout itself is ``test_torch_port_gnn_padded``'s.
- The wrappers' range checks take every width JAX takes (the LSTM any
  H >= 1, the GNN any E a positive multiple of 4 and 1 <= T1 <= T0) and
  raise ``ValueError`` naming the range for the rest, before any build.
- At embed_dim 300, pad_size 24: ``encode_text`` against JAX's, the
  kernel's plain twin against the module form of the calibrated matcher,
  and calibrated ``serve_batch`` against JAX's (identical ``top_idx`` and
  match counts, positions within one f16 step), on JAX's checkpoints.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_calibration import TINY as CAL_TINY
from test_torch_port_calibration import _bank_draws, _draws, make_tiny
from text2pos_tpu.ops.superglue_gnn_pallas import fold_gnn_params as jfold
from text2pos_tpu.ops.superglue_gnn_pallas import gnn_scores_pallas
from text2pos_torch.ops import fps as tfps
from text2pos_torch.ops import lstm as tlstm
from text2pos_torch.ops import superglue_gnn as tgnn

torch.set_num_threads(2)

F32_TOL = 1e-5
PAD_TOL = 1e-6
WIDE = dict(CAL_TINY, embed_dim=300, num_layers=1, pad_size=24,
            coarse_max_objects=24)
TOP_K, Q = 3, 8


@pytest.mark.parametrize("H", [20, 75, 300])
def test_lstm_padding_keeps_real_units(H):
    g = torch.Generator().manual_seed(H)
    Hp = tlstm.kernel_width(H)
    assert Hp % 32 == 0 and Hp - 32 < H <= Hp
    V, B, T = 13, 6, 9
    tables = [torch.randn(V, 4 * H, generator=g) for _ in range(2)]
    w_hh = [torch.randn(H, 4 * H, generator=g) / H ** 0.5 for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), generator=g)
    lengths = torch.tensor([9, 4, 1, 0, 7, 9])
    want = tlstm.lstm_final_hidden_plain(tables, w_hh, tokens, lengths)
    got = tlstm.lstm_final_hidden_plain(
        [tlstm.pad_gates(t, H, Hp) for t in tables],
        [tlstm.pad_w_hh(w, H, Hp) for w in w_hh], tokens, lengths)
    assert got.shape == (2, B, Hp)
    assert bool((got[..., H:] == 0).all())
    torch.testing.assert_close(got[..., :H], want, rtol=0, atol=PAD_TOL)


def test_lstm_pad_gates_layout():
    """Each gate block i|f|g|o keeps its columns and gains zeros."""
    x = torch.arange(12.0).view(1, 12)            # H = 3
    got = tlstm.pad_gates(x, 3, 5)
    want = torch.tensor([[0, 1, 2, 0, 0, 3, 4, 5, 0, 0, 6, 7, 8, 0, 0,
                          9, 10, 11, 0, 0]], dtype=torch.float32)
    assert torch.equal(got, want)
    w = tlstm.pad_w_hh(torch.ones(3, 12), 3, 5)
    assert w.shape == (5, 20) and float(w[3:].abs().sum()) == 0


@pytest.mark.parametrize("H", [32, 64, 320, 544, 608, 2048])
def test_w_hh_fragments_mirror_the_kernel_fill(H):
    """``w_hh_fragments`` against a loop that copies ``csrc/lstm.cu``'s fill
    of a CTA's shared-memory slice, CTA after CTA."""
    w = torch.randn(H, 4 * H, generator=torch.Generator().manual_seed(H))
    got = tlstm.w_hh_fragments(w).numpy()
    flat = w.numpy().reshape(-1)
    want = np.empty(4 * H * H, np.float32)
    U = 32
    for rank in range(H // U):
        base = rank * H * U * 4
        i = np.arange(H * 4 * U)
        u, gate, k = i % U, (i // U) & 3, i // (4 * U)
        row = 8 * (gate & 1) + (u & 7)
        ln = 4 * (row & 7) + (k & 3)
        j = 2 * ((k & 7) >> 2) + (row >> 3)
        dst = ((((k >> 3) * 2 + (gate >> 1)) * 4 + (u >> 3)) * 32 + ln) * 4 + j
        want[base + dst] = flat[k * 4 * H + gate * H + rank * U + u]
    np.testing.assert_array_equal(got, want)


def test_lstm_wrapper_range_checks_run_before_building(monkeypatch):
    """Any H of at least 1 is taken, as JAX takes it: H = 513 and 600 pass
    the checks and reach the grid form's launch (recorded here instead of
    built); H = 0 is refused, naming the range, before any build."""
    launched = []
    monkeypatch.setattr(tlstm, "_lstm_grid",
                        lambda *args: launched.append(args[-2]))
    for H in (513, 600):
        tlstm.check_kernel_width(H)
        tables = [torch.zeros(3, 4 * H) for _ in range(2)]
        w_hh = [torch.zeros(H, 4 * H) for _ in range(2)]
        out = tlstm._lstm_kernel(tables, w_hh,
                                 torch.zeros(2, 3, dtype=torch.int32),
                                 torch.ones(2, dtype=torch.int32))
        assert out.shape == (2, 2, H)
    assert launched == [544, 608]               # padded to 32·k
    tlstm.check_kernel_width(300)
    with pytest.raises(ValueError, match="at least 1"):
        tlstm._lstm_kernel([torch.zeros(3, 0)] * 2, [torch.zeros(0, 0)] * 2,
                           torch.zeros(2, 3, dtype=torch.int32),
                           torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="at least 1"):
        tlstm.check_kernel_width(0)


@pytest.mark.parametrize("taken,refused,match", [
    (((2, 16, 516), (2, 6, 516)), ((2, 16, 302), (2, 6, 302)),
     "positive multiple of 4"),                   # E = 516 past 512; E = 302
    (((2, 16, 768), (2, 6, 768)), ((2, 16, 0), (2, 6, 0)),
     "positive multiple of 4"),                   # E = 768; E = 0
    (((2, 33, 300), (2, 6, 300)), ((2, 16, 300), (2, 17, 300)),
     "1 <= T1 <= T0"),                            # T0 = 33; T1 > T0
    (((2, 48, 300), (2, 48, 300)), ((2, 48, 300), (2, 49, 300)),
     "1 <= T1 <= T0"),                            # T0 = T1 = 48; T1 > T0
])
def test_gnn_wrapper_range_checks_run_before_building(taken, refused, match):
    """What JAX takes passes the wrapper's shape checks and gets a route
    (E a positive multiple of 4, any 1 <= T1 <= T0); what JAX refuses
    raises, naming the range, before any build."""
    (N, T0, E), (_, T1, _) = taken
    tgnn._check_any_shape(torch.zeros(taken[0]), torch.zeros(taken[1]))
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(1, width=E),
                                  torch.float32, "cpu")
    assert tgnn._check_weights(packed, E, 1, torch.float32,
                               torch.zeros(taken[0])) == \
        tgnn.padded_width(E, torch.float32)
    assert tgnn.any_plan(E, T0, T1, torch.float32).route in (
        "superglue_gnn_any", "superglue_gnn_any_wide")
    packed = tgnn.pack_gnn_params(tgnn.random_folded_params(1, width=4),
                                  torch.float32, "cpu")
    with pytest.raises(ValueError, match=match):
        tgnn._gnn_kernel(torch.zeros(refused[0]), torch.zeros(refused[1]),
                         packed)


def test_fps_plain_past_256_points_matches_first_index_rule():
    """1024 points with duplicates: the plain loop's first-index ties, the
    rule the kernel keeps at 32 points a lane."""
    g = torch.Generator().manual_seed(1)
    base = torch.randn(2, 40, 3, generator=g)
    pts = base[:, torch.randint(0, 40, (1024,), generator=g)]
    idx, cent = tfps.farthest_point_sampling(pts, 512)
    assert idx.shape == (2, 512) and torch.equal(
        cent, torch.gather(pts, 1, idx[..., None].expand(2, 512, 3)))
    first = {tuple(p.tolist()): i for i, p in reversed(list(enumerate(pts[0])))}
    assert all(first[tuple(pts[0, i].tolist())] == i for i in idx[0].tolist())


def test_pack_layout_follows_the_width():
    """bf16 weights in fragment order at every width, padded to heads of a
    multiple of 16 channels (E = 300 as 320; the tuned kernel's E = 128 as
    it is); f32 always row-major, heads padded to a multiple of 4 (300 as
    304)."""
    wide = tgnn.pack_gnn_params(tgnn.random_folded_params(1, width=300),
                                torch.bfloat16, "cpu")
    assert tgnn.fragment_ordered(wide)
    assert wide["wqkv"].shape == (1, 960 // 8, 320 // 16, 32, 4)
    assert tgnn.packed_width(wide) == 320 and tgnn.real_width(wide) == 300
    bench = tgnn.pack_gnn_params(tgnn.random_folded_params(1, width=128),
                                 torch.bfloat16, "cpu")
    assert tgnn.fragment_ordered(bench)
    assert bench["wqkv"].shape == (1, 384 // 8, 128 // 16, 32, 4)
    f32 = tgnn.pack_gnn_params(tgnn.random_folded_params(1, width=128),
                               torch.float32, "cpu")
    assert not tgnn.fragment_ordered(f32)
    wide32 = tgnn.pack_gnn_params(tgnn.random_folded_params(1, width=300),
                                  torch.float32, "cpu")
    assert not tgnn.fragment_ordered(wide32)
    assert wide32["wqkv"].shape == (1, 304, 912)


def _gnn_trees(E, layers, seed=0):
    """JAX-layout SuperGlue params and per-set [2, 2E] calibrated
    statistics from a seed (``TestGNN.trees`` at any width)."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)
                           ).astype(np.float32),
                "bias": (0.1 * rng.standard_normal(o)).astype(np.float32)}

    gnn, stats = {}, {}
    for i in range(2 * layers):
        gnn[f"layer_{i}"] = {
            "attn": {n: dense(E, E) for n in
                     ("proj_q", "proj_k", "proj_v", "merge")},
            "mlp": {"dense_0": dense(2 * E, 2 * E),
                    "dense_1": dense(2 * E, E),
                    "bn_0": {"scale": rng.uniform(0.5, 1.5, 2 * E
                                                  ).astype(np.float32),
                             "bias": (0.1 * rng.standard_normal(2 * E)
                                      ).astype(np.float32)}}}
        stats[f"layer_{i}"] = {"mlp": {"bn_0": {
            "mean": (0.3 * rng.standard_normal((2, 2 * E))
                     ).astype(np.float32),
            "var": rng.uniform(0.2, 2.0, (2, 2 * E)).astype(np.float32)}}}
    params = {"superglue": {"gnn": gnn, "final_proj": dense(E, E),
                            "bin_score": np.float32(1.0)}}
    return params, {"superglue": {"gnn": stats}}


@pytest.mark.parametrize("E,T0,T1", [(300, 16, 6), (300, 24, 6),
                                     (128, 24, 6), (256, 32, 8)])
def test_gnn_plain_matches_pallas_at_wide_shapes(E, T0, T1):
    """The kernel's plain twin (what the second form computes) against
    JAX's Pallas kernel, f32, one block pair."""
    trees = _gnn_trees(E, 1, seed=E + T0)
    rng = np.random.default_rng(T0)
    d0 = rng.standard_normal((3, T0, E)).astype(np.float32)
    d1 = rng.standard_normal((3, T1, E)).astype(np.float32)
    folded = jfold(*trees, 1)
    want = np.asarray(gnn_scores_pallas(
        jnp.asarray(d0), jnp.asarray(d1),
        {k: jnp.asarray(v) for k, v in folded.items()}, 1,
        pairs_per_program=4, dtype=jnp.float32, interpret=True))
    packed = tgnn.pack_gnn_params(tgnn.fold_gnn_params(*trees, 1),
                                  torch.float32, "cpu")
    got = tgnn.gnn_scores(torch.from_numpy(d0), torch.from_numpy(d1),
                          packed).numpy()
    assert got.shape == (3, T0, T1)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


@pytest.fixture(scope="module")
def wide(synthetic_data, tmp_path_factory):
    """``test_torch_port_calibration``'s pipelines at embed_dim 300, one
    block pair, pad_size 24, and both calibrated."""
    t = make_tiny(synthetic_data, tmp_path_factory.mktemp("wide"), WIDE)
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


def test_wide_encode_text_matches_jax(wide):
    tok, ln = wide["args"][:2]
    jp = wide["jcal"]
    want = np.asarray(jp.coarse.model.apply(
        {"params": jp.coarse_state.params,
         "batch_stats": jp.coarse_state.batch_stats},
        jnp.asarray(tok), jnp.asarray(ln),
        method=jp.coarse.model.encode_text))
    with torch.no_grad():
        got = wide["tcal"].coarse.encode_text(torch.from_numpy(tok),
                                              torch.from_numpy(ln))
    assert got.shape == (Q, 300)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL)


def test_wide_kernel_twin_matches_module_form(wide):
    """The calibrated matcher at E = 300, T0 = 24: the GNN kernel's plain
    twin on the folded weights against the module form (what serving runs
    on the CPU and JAX's eval path computes), f32 within 1e-5 relative, on
    L2-normalized descriptors as the encoders give them."""
    sg = wide["tcal"].fine.superglue
    rng = np.random.default_rng(3)
    d0, d1 = (torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)), dim=-1)
        for s in ((5, 24, 300), (5, 6, 300)))
    with torch.no_grad():
        want = sg.scores(d0, d1)
        got = tgnn.gnn_scores_plain(d0, d1, sg.packed_kernel_params())
    assert got.shape == (5, 24, 6)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=F32_TOL * float(want.abs().max()))


def test_wide_calibrated_serving_matches_jax(wide):
    """f32 serving from the calibrated pipelines at E = 300, pad_size 24:
    identical top_idx and match counts, positions within one f16 step."""
    jcal, jbank, tcal = wide["jcal"], wide["jbank"], wide["tcal"]
    want = jcal.serve_batch(jcal.coarse_state, jcal.fine_state,
                            *map(jnp.asarray, wide["args"]),
                            jnp.asarray(wide["cell_enc"]), TOP_K, jbank[0],
                            jbank[1])
    got = tcal.serve_batch(*wide["args"], TOP_K)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(got[2].float().numpy(),
                               np.asarray(want[2], np.float32),
                               atol=2.0 ** -11, rtol=0)
