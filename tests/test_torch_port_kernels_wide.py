"""The kernels at the widths JAX's configurations give, against their plain
PyTorch versions: the LSTM past 256 units (JAX's default embed_dim 300, up
to 512 in clusters, the grid form past 512: 544, 768, 1024, 2048, and
several 32-unit slices a CTA), the second GNN form
(``csrc/superglue_gnn_any.cu``) at any E a multiple of 4 and any
1 <= T1 <= T0 on each of its routes (``any_plan``: bf16 on the tensor
cores and f32 on the CUDA cores, both ``superglue_gnn_any``, and
``superglue_gnn_any_wide``, which takes every shape past 32 objects and
every pair whose rows pass shared memory: G pairs a CTA, weight tiles in
shared memory, bf16 products on the tensor cores), Sinkhorn's wide form past 32 x
16 couplings (copied into shared memory, or past it read from global
memory), FPS past 256 points; every LSTM form (W_hh in shared memory,
from L2 past 256 units, the grid form) against a float64 evaluation on
long, sensitive text (the bench text encoder, zero-padded to the wider
widths); and the four trainers built on the card at embed_dim and
regressor_dim 768.

Imports only torch and numpy, so it also runs on a card machine without JAX:

    python -m pytest --noconftest tests/test_torch_port_kernels_wide.py -q

Without a CUDA device every test skips (the kernels have no CPU mode).
"""

import pytest
import torch

from text2pos_torch.ops import _build
from text2pos_torch.ops import fps as tfps
from text2pos_torch.ops import lstm as tlstm
from text2pos_torch.ops import superglue_gnn as tgnn

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


def _lstm_case(T, B, H, V=29, seed=0):
    g = torch.Generator().manual_seed(seed)
    tables = [torch.randn(V, 4 * H, generator=g) for _ in range(2)]
    w_hh = [(torch.rand(H, 4 * H, generator=g) - 0.5) / H ** 0.5
            for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), generator=g, dtype=torch.int32)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0], lengths[-1] = 1, T
    return tables, w_hh, tokens, lengths


@pytest.mark.parametrize("T,B,H", [
    (24, 70, 300),      # JAX's default width: padded to 320, 10 CTAs
    (9, 33, 384),       # 12 CTAs
    (12, 40, 512),      # the largest cluster, 16 CTAs
    (7, 35, 100),       # padded to 128, W_hh on chip
    (5, 3, 288),        # the first width past the on-chip form
    (11, 65, 416),      # 13 CTAs, three tiles
    (8, 96, 480),       # 15 CTAs
])
def test_lstm_kernel_wide_matches_plain(cuda, T, B, H):
    """Both directions in one launch against the plain version at the
    unpadded width (f32 on both sides, other summation order)."""
    tables, w_hh, tokens, lengths = _lstm_case(T, B, H, seed=H)
    args = ([t.to(cuda) for t in tables], [w.to(cuda) for w in w_hh],
            tokens.to(cuda), lengths.to(cuda))
    got = _launches("lstm", lambda: tlstm.lstm_final_hidden(*args))
    want = tlstm.lstm_final_hidden_plain(*args)
    assert got.shape == (2, B, H)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_lstm_kernel_wide_generic_path(cuda):
    """``bilstm_final_hidden`` (x·W_ih + b as a table of T·B rows) at
    H = 300."""
    g = torch.Generator().manual_seed(4)
    B, T, E = 21, 10, 300
    x = torch.randn(B, T, E, generator=g)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    params = [tlstm.LSTMParams(torch.randn(E, 4 * E, generator=g) / E ** 0.5,
                               torch.randn(E, 4 * E, generator=g) / E ** 0.5,
                               torch.randn(4 * E, generator=g))
              for _ in range(2)]
    on_card = [tlstm.LSTMParams(*(t.to(cuda) for t in p)) for p in params]
    want = tlstm.bilstm_final_hidden(x, lengths, *params)
    got = _launches("lstm", lambda: tlstm.bilstm_final_hidden(
        x.to(cuda), lengths.to(cuda), *on_card))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)


def test_lstm_kernel_wide_clusters_resident(cuda):
    """The non-portable cluster sizes are accepted: at least one cluster of
    each form fits on the card, the C side's plan is ``cluster_plan``'s,
    and the L2 form holds more CTAs at once than the card has SMs at every
    width (three an SM; its earlier form held one an SM past 448)."""
    import ctypes
    fn = _build.entry("lstm", "t2p_lstm_max_active_clusters",
                      [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)])
    plan = _build.entry("lstm", "t2p_lstm_cluster_plan",
                        [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for H in (128, 256, 288, 320, 384, 416, 448, 480, 512):
        n = ctypes.c_int(0)
        assert fn(H, 2048, ctypes.byref(n)) == 0
        assert n.value >= 1, H
        got = (ctypes.c_int * 2)()
        assert plan(H, got) == 0
        assert tuple(got) == tlstm.cluster_plan(H), H
        if H > tlstm.SMEM_HIDDEN:
            assert n.value * (H // 32) > sms, (H, n.value)


@pytest.mark.parametrize("H", [288, 300, 416, 512])
def test_lstm_l2_form_ragged_repeats_bit_for_bit(cuda, H):
    """The L2 form on ragged lengths with zero-length sequences and a tile
    of them only (no step), B not a multiple of 32: against the plain
    version, and bit for bit from one launch to the next."""
    T, B = 9, 77
    tables, w_hh, tokens, lengths = _lstm_case(T, B, H, seed=H + 7)
    lengths[3] = 0
    lengths[32:64] = 0
    args = ([t.to(cuda) for t in tables], [w.to(cuda) for w in w_hh],
            tokens.to(cuda), lengths.to(cuda))
    got = _launches("lstm", lambda: tlstm.lstm_final_hidden(*args))
    want = tlstm.lstm_final_hidden_plain(*args)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert bool((got[:, 32:64] == 0).all()) and bool((got[:, 3] == 0).all())
    assert torch.equal(got, tlstm.lstm_final_hidden(*args))


def _bench_text():
    """The bench coarse model's text encoder on long, sensitive text: its
    gate-input tables and W_hh (``checkpoints/bench_coarse.msgpack``,
    H = 256) and the bench fixture's 2048 queries (48-54 tokens), with
    6.4% of the tokens (seeded) made the unknown word (row 0: the bias
    alone), the share in the KITTI360 server's calibration text, where
    the earlier 3xTF32 arithmetic lay 1.4e-4 from float64."""
    import os

    import numpy as np

    from text2pos_torch.train.state import load_checkpoint

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir)
    le = load_checkpoint(os.path.join(root, "checkpoints",
                                      "bench_coarse.msgpack"))["params"][
        "language_encoder"]
    params = [tlstm.LSTMParams(*(torch.as_tensor(np.array(
        le[f"lstm_{d}_{k}"]), dtype=torch.float32)
        for k in ("w_ih", "w_hh", "b"))) for d in ("fwd", "bwd")]
    tables = tlstm.token_tables(torch.as_tensor(np.array(
        le["word_embedding"]["embedding"]), dtype=torch.float32), *params)
    fx = np.load(os.path.join(root, "text2pos_torch", "fixtures",
                              "bench_queries.npz"))
    tokens = fx["tokens"].astype(np.int32)
    rng = np.random.default_rng(0)
    tokens = np.where(rng.random(tokens.shape) < 0.064, 0, tokens)
    return (tables, [p.w_hh for p in params], torch.as_tensor(tokens),
            torch.as_tensor(fx["lengths"].astype(np.int64)))


def _text_errors(cuda, H):
    """The kernel on ``_bench_text`` zero-padded from 256 to H units
    (``pad_gates``, ``pad_w_hh``: the padded units stay 0 and add nothing
    to the real ones): its largest error on the real units against the
    plain recurrence in float64 and against the plain f32 version, and the
    plain f32 version's against float64."""
    from text2pos_torch.utils.float64 import float64_pins

    tables, w_hh, tokens, lengths = _bench_text()
    args = ([tlstm.pad_gates(t, 256, H).to(cuda) for t in tables],
            [tlstm.pad_w_hh(w, 256, H).to(cuda) for w in w_hh],
            tokens.to(cuda), lengths.to(cuda))
    form = "lstm" if H <= tlstm.CLUSTER_HIDDEN else "lstm_grid"
    got = _launches(form, lambda: tlstm.lstm_final_hidden(*args))
    assert got.shape == (2, len(tokens), H)
    got = got[..., :256]
    plain = tlstm.lstm_final_hidden_plain(*args)[..., :256]
    with float64_pins():
        ref = tlstm.lstm_final_hidden_plain(
            [t.double() for t in args[0]], [w.double() for w in args[1]],
            args[2], args[3])[..., :256]
    return (float((got.double() - ref).abs().max()),
            float((got - plain).abs().max()),
            float((plain.double() - ref).abs().max()))


def test_lstm_shared_form_holds_float64_on_text(cuda):
    """The shared-memory form (H = 256, the rounded 3xTF32 arithmetic) on
    the bench text encoder: within 2e-5 of the plain recurrence evaluated
    in float64 (1.28e-5 on the KITTI360 text, where the plain f32 version
    lies 8.1e-6 and the earlier arithmetic 1.4e-4) and within 1e-4
    (chip_smoke's TOL["lstm"]) of the plain f32 version."""
    err64, err, plain64 = _text_errors(cuda, 256)
    assert err64 <= 2e-5, (err64, plain64)
    assert err <= 1e-4


@pytest.mark.parametrize("H", [300, 384, 512])
def test_lstm_l2_form_holds_float64_on_text(cuda, H):
    """The form that reads W_hh from L2 (H > 256: clusters of 10, 12 and
    16 CTAs), which shares the shared-memory form's arithmetic, on the same
    text zero-padded to H: within 2e-5 of float64 (the arithmetic it had
    before lay 1.4e-4 from float64 on the KITTI360 text padded to H = 300)
    and within 1e-4 of the plain f32 version."""
    err64, err, plain64 = _text_errors(cuda, H)
    assert err64 <= 2e-5, (err64, plain64)
    assert err <= 1e-4


@pytest.mark.parametrize("H", [768, 1024, 2048])
def test_lstm_grid_form_holds_float64_on_text(cuda, H):
    """The grid form (past 512 units), which runs the L2 form's step, on
    the same text zero-padded to H (W_hh in L2 at 768 and 1024, past it at
    2048): within 2e-5 of float64 and within 1e-4 of the plain f32
    version."""
    err64, err, plain64 = _text_errors(cuda, H)
    assert err64 <= 2e-5, (err64, plain64)
    assert err <= 1e-4


@pytest.mark.parametrize("T,B,H,ctas", [
    (12, 70, 544, 0),       # the first width past the largest cluster
    (16, 300, 768, 0),      # 24 CTAs a group, ten tiles
    (9, 33, 1024, 0),
    (9, 33, 1024, 3),       # 3 CTAs a group: up to 11 slices a CTA
    (12, 65, 2048, 0),      # W_hh 67 MB: past L2
    (5, 1, 608, 0),         # one sequence, H = 600 padded
])
def test_lstm_grid_form_matches_plain(cuda, T, B, H, ctas):
    """Both directions in one cooperative launch against the plain version;
    lengths 1 to T, and a whole tile of empty sequences where B allows."""
    tables, w_hh, tokens, lengths = _lstm_case(T, B, H, seed=H + B)
    if B > 64:
        lengths[32:64] = 0
    args = ([t.to(cuda) for t in tables], [w.to(cuda) for w in w_hh],
            tokens.to(cuda), lengths.to(cuda))
    got = _launches("lstm_grid", lambda: tlstm._lstm_kernel(*args,
                                                             ctas=ctas))
    want = tlstm.lstm_final_hidden_plain(*args)
    assert got.shape == (2, B, H)
    if B > 64:
        assert float(got[:, 32:64].abs().max()) == 0.0
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_lstm_grid_form_repeats_bit_for_bit(cuda):
    """Two calls give the same bits (no atomics in the sums; the barrier
    orders every exchange), and ``bilstm_final_hidden`` takes the form."""
    tables, w_hh, tokens, lengths = _lstm_case(10, 97, 800, seed=5)
    args = ([t.to(cuda) for t in tables], [w.to(cuda) for w in w_hh],
            tokens.to(cuda), lengths.to(cuda))
    a = tlstm.lstm_final_hidden(*args)
    b = tlstm.lstm_final_hidden(*args)
    assert torch.equal(a, b)
    g = torch.Generator().manual_seed(6)
    B, T, E, H = 7, 6, 40, 576
    x = torch.randn(B, T, E, generator=g)
    ln = torch.randint(1, T + 1, (B,), generator=g)
    params = [tlstm.LSTMParams(torch.randn(E, 4 * H, generator=g) / E ** 0.5,
                               torch.randn(H, 4 * H, generator=g) / H ** 0.5,
                               torch.randn(4 * H, generator=g))
              for _ in range(2)]
    want = tlstm.bilstm_final_hidden(x, ln, *params)
    on_card = [tlstm.LSTMParams(*(t.to(cuda) for t in p)) for p in params]
    got = _launches("lstm_grid", lambda: tlstm.bilstm_final_hidden(
        x.to(cuda), ln.to(cuda), *on_card))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)


# Grid-form cases off its 32-sequence tile: (H, B, T, CTAs a group; 0 lets
# the plan choose).
GRID_RAGGED_CASES = [(544, 130, 9, 0), (768, 257, 12, 0), (608, 37, 7, 0),
                     (1024, 300, 10, 3), (2048, 131, 6, 0)]


@pytest.mark.parametrize("H,B,T,ctas", GRID_RAGGED_CASES)
def test_lstm_grid_form_ragged_with_a_nan_token(cuda, H, B, T, ctas):
    """The grid form against the plain version with ragged lengths that
    include 0 and T, B not a multiple of the tile, and a token outside
    [0, V) that makes its sequence's gates NaN from its step on (both
    directions read it) and no other sequence's; a second launch repeats
    the first bit for bit."""
    tables, w_hh, tokens, lengths = _lstm_case(T, B, H, seed=ctas * H + B)
    lengths[1], lengths[2], lengths[-2] = 0, T, 0
    lengths[5] = T
    tokens[5, T // 2] = 1000                        # past V = 29
    args = ([t.to(cuda) for t in tables], [w.to(cuda) for w in w_hh],
            tokens.to(cuda), lengths.to(cuda))
    got = _launches("lstm_grid", lambda: tlstm._lstm_kernel(*args,
                                                             ctas=ctas))
    assert got.shape == (2, B, H)
    assert bool(torch.isnan(got[:, 5]).all())
    keep = torch.arange(B) != 5
    tok = tokens.clone()
    tok[5, T // 2] = 0
    want = tlstm.lstm_final_hidden_plain(args[0], args[1], tok.to(cuda),
                                         args[3])
    torch.testing.assert_close(got[:, keep], want[:, keep], atol=1e-5,
                               rtol=1e-4)
    assert float(got[:, 1].abs().max()) == 0.0
    assert float(got[:, -2].abs().max()) == 0.0
    again = tlstm._lstm_kernel(*args, ctas=ctas)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(again))


@pytest.mark.parametrize("B,M,N,iters", [
    (1280, 49, 7, 50),      # pad_size 48, 6 hints: the phase-14 coupling
    (37, 33, 7, 6),         # pad_size 32
    (5, 17, 40, 10),        # 39 hints
    (9, 130, 65, 7),
    (3, 40, 5, 0),          # no iteration: the couplings less - norm
    (1281, 49, 7, 1),       # B not a multiple of the 4 couplings a CTA
    (1279, 49, 7, 0),
    (6, 65, 17, 50),        # pad_size 64, 16 hints
    (7, 65, 17, 1),
    (5, 33, 33, 50),        # 32 objects, 32 hints: 1 lane a row and column
    (3, 33, 33, 0),
    (2, 300, 300, 3),       # past shared memory: the workspace route
    (3, 201, 200, 2),       # one coupling a CTA
])
def test_sinkhorn_wide_form_matches_plain(cuda, B, M, N, iters):
    """Couplings past 32 x 16 (dustbins included) on the wide form, scores
    up to +-60, against the plain dustbin couplings + Sinkhorn - norm."""
    import numpy as np
    from text2pos_torch.ops import sinkhorn as tsink

    rng = np.random.default_rng(M * N)
    scores = torch.tensor(np.clip(20 * rng.standard_normal(
        (B, M - 1, N - 1)), -60, 60), dtype=torch.float32).to(cuda)
    alpha = torch.tensor(1.3, device=cuda)
    got = _launches("sinkhorn_wide", lambda: tsink.log_optimal_transport(
        scores, alpha, iters))
    want = tsink.log_optimal_transport_plain(scores, alpha, iters)
    assert got.shape == (B, M, N)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    again = tsink.log_optimal_transport(scores, alpha, iters)
    assert torch.equal(got, again)


@pytest.mark.parametrize("M,N", [(49, 7), (65, 17), (33, 33), (300, 300),
                                 (201, 200), (120, 120)])
def test_sinkhorn_wide_plan_matches_the_mirror(cuda, M, N):
    """The C side's plan on this card (``t2p_sinkhorn_wide_plan``) is
    ``wide_plan`` with the card's shared memory."""
    import ctypes
    from text2pos_torch.ops import sinkhorn as tsink

    fn = _build.entry("sinkhorn", "t2p_sinkhorn_wide_plan",
                      [ctypes.c_int] * 2 + [ctypes.c_void_p])
    out = (ctypes.c_int * 3)()
    assert fn(M, N, out) == 0
    p = tsink.wide_plan(M, N, torch.cuda.get_device_properties(
        cuda).shared_memory_per_block_optin)
    assert list(out) == [int(p.route == "smem"), p.couplings, p.smem]


def test_trainers_take_widths_past_512(cuda):
    """The four trainers build on the card at embed_dim (offsets:
    regressor_dim) 768 and pad_size 48: nothing but JAX's own limits is
    refused."""
    from text2pos_torch.config import TrainConfig
    from text2pos_torch.data.hints import Vocabulary
    from text2pos_torch.train.coarse import CoarseTrainer
    from text2pos_torch.train.fine import FineTrainer
    from text2pos_torch.train.offsets import OffsetsTrainer
    from text2pos_torch.train.transformer import TransformerTrainer

    vocab = Vocabulary(["a", "b"])
    for cls, kw in ((CoarseTrainer, dict(embed_dim=768)),
                    (FineTrainer, dict(embed_dim=768, pad_size=48)),
                    (TransformerTrainer, dict(embed_dim=768, pad_size=48)),
                    (OffsetsTrainer, dict(regressor_dim=768, pad_size=48))):
        trainer = cls(TrainConfig(dataset="SYNTHETIC", device="cuda", **kw),
                      vocab)
        assert trainer.device.type == "cuda"


def _packed(E, dtype, device, L):
    return tgnn.pack_gnn_params(tgnn.random_folded_params(L, width=E), dtype,
                                device)


REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _gnn_case(cuda, dtype, E, T0, T1, N, L, seed=None):
    """Kernel against plain on seeded descriptors; the launch is counted
    under the name of the route ``any_plan`` gives. Tolerance relative to
    the largest score, as the tuned kernel's test: both sides sum in f32 in
    different orders; in bf16 that can move a value by one bf16 step."""
    packed = _packed(E, dtype, cuda, L)
    g = torch.Generator().manual_seed(E + T0 + T1 if seed is None else seed)
    d0 = torch.randn(N, T0, E, generator=g).to(cuda)
    d1 = torch.randn(N, T1, E, generator=g).to(cuda)
    route = tgnn.any_plan(E, T0, T1, dtype).route
    got = _launches(route, lambda: tgnn.gnn_scores(d0, d1, packed))
    want = tgnn.gnn_scores_plain(d0, d1, packed)
    assert got.shape == (N, T0, T1) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=REL_TOL[dtype]
                               * float(want.abs().max()))
    return route


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,T0,T1,N,L", [
    (300, 16, 6, 37, 4),         # JAX's default width
    (128, 24, 6, 9, 4),          # pad_size 24 at the bench width
    (256, 32, 8, 5, 4),          # the largest rows of the phase-12 shapes
    (300, 16, 6, 3, 0),          # 0 blocks: the final projection alone
    (300, 32, 32, 3, 0),
    (512, 32, 32, 3, 2),         # the largest shape: the wide route
    (128, 16, 16, 4, 2),         # T1 = T0
    (4, 1, 1, 2, 2),             # the smallest
])
def test_gnn_any_kernel_matches_plain(cuda, dtype, E, T0, T1, N, L):
    _gnn_case(cuda, dtype, E, T0, T1, N, L)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T0,T1", [(16, 6), (24, 6), (32, 32)])
@pytest.mark.parametrize("which", ["one", "G+1", "37"])
def test_gnn_any_ragged_pair_counts(cuda, dtype, T0, T1, which):
    """N not a multiple of the pairs a CTA takes: one pair, G + 1, 37."""
    G = tgnn.any_plan(300, T0, T1, dtype).pairs
    N = {"one": 1, "G+1": G + 1, "37": 37}[which]
    _gnn_case(cuda, dtype, 300, T0, T1, N, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T0", [16, 24, 32])
@pytest.mark.parametrize("T1", ["1", "6", "T0"])
def test_gnn_any_set_sizes(cuda, dtype, T0, T1):
    T1 = T0 if T1 == "T0" else int(T1)
    _gnn_case(cuda, dtype, 300, T0, T1, 5, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E", [4, 300, 320, 512])
@pytest.mark.parametrize("T0,T1", [(16, 6), (32, 32)])
def test_gnn_any_widths(cuda, dtype, E, T0, T1):
    _gnn_case(cuda, dtype, E, T0, T1, 3, 2)


@pytest.mark.parametrize("E,T0,T1", [
    (E, T0, T1) for E in (64, 128, 192, 256, 300, 320)
    for T0, T1 in ((16, 6), (16, 16), (24, 6), (32, 32))
    if (E, T0, T1) != tgnn.KERNEL_SHAPE])
def test_gnn_any_bf16_takes_the_tensor_cores(cuda, E, T0, T1):
    """Every bf16 shape at E <= 320 but the tuned kernel's runs on the
    second form's tensor-core route."""
    wide = tgnn.any_plan(E, T0, T1, torch.bfloat16).route
    before = _build.LAUNCHES["superglue_gnn_any_wide"]
    route = _gnn_case(cuda, torch.bfloat16, E, T0, T1, 4, 2)
    assert route == wide == "superglue_gnn_any"
    assert _build.LAUNCHES["superglue_gnn_any_wide"] == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("T0,T1,dup", [(24, 6, (1, 4)), (16, 12, (3, 4))])
def test_gnn_any_kernel_keeps_exact_ties(cuda, dtype, T0, T1, dup):
    """Identical hints give bit-identical score columns at E = 300; at
    (16, 12) in bf16, hints 3 and 4 of a CTA's second pair lie in different
    16-row tiles."""
    packed = _packed(300, dtype, cuda, 2)
    g = torch.Generator().manual_seed(3)
    d0 = torch.randn(5, T0, 300, generator=g).to(cuda)
    d1 = torch.randn(5, T1, 300, generator=g).to(cuda)
    i, j = dup
    d1[:, j] = d1[:, i]
    s = tgnn.gnn_scores(d0, d1, packed)
    torch.testing.assert_close(s[:, :, j], s[:, :, i], atol=0, rtol=0)


@pytest.mark.parametrize("T0,T1", [(16, 6), (24, 6), (16, 12)])
def test_gnn_any_bf16_scores_do_not_depend_on_pairs_a_cta(cuda, monkeypatch,
                                                          T0, T1):
    """Every m-tile count sums each k-step's products with the same rounded
    adds, so a pair's bf16 scores are bit-identical whether its CTA holds
    the plan's G = 2 pairs (3 m-tiles at (16, 6), 4 at (24, 6) and
    (16, 12)) or one pair (2 or 3 m-tiles)."""
    packed = _packed(300, torch.bfloat16, cuda, 2)
    g = torch.Generator().manual_seed(5)
    d0 = torch.randn(7, T0, 300, generator=g).to(cuda)
    d1 = torch.randn(7, T1, 300, generator=g).to(cuda)
    plan = tgnn.any_plan(300, T0, T1, torch.bfloat16)
    assert plan.pairs == 2
    got = tgnn.gnn_scores(d0, d1, packed)
    monkeypatch.setattr(tgnn, "any_plan",
                        lambda *args: plan._replace(pairs=1))
    alone = _launches("superglue_gnn_any",
                      lambda: tgnn.gnn_scores(d0, d1, packed))
    torch.testing.assert_close(alone, got, atol=0, rtol=0)


def test_gnn_any_kernel_takes_fragment_ordered_weights(cuda):
    """At E = 128 bf16 weights come in the tuned kernel's fragment order,
    and the second form reads the same pack at other set sizes."""
    packed = _packed(128, torch.bfloat16, cuda, 2)
    assert tgnn.fragment_ordered(packed) and tgnn.packed_width(packed) == 128
    g = torch.Generator().manual_seed(8)
    d0 = torch.randn(6, 24, 128, generator=g).to(cuda)
    d1 = torch.randn(6, 6, 128, generator=g).to(cuda)
    got = _launches("superglue_gnn_any",
                    lambda: tgnn.gnn_scores(d0, d1, packed))
    want = tgnn.gnn_scores_plain(d0, d1, packed)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-2 * float(want.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,T0,T1,N,L", [
    (516, 16, 6, 9, 2),          # past 512: bf16 on the tensor cores
    (768, 16, 6, 9, 2),          # f32 past shared memory: the wide route
    (1024, 64, 16, 3, 2),
    (300, 48, 6, 7, 2),          # pad_size 48: the wide route
    (300, 64, 64, 3, 2),
    (128, 128, 6, 3, 2),
    (300, 33, 1, 4, 0),          # one object past the shared routes
])
def test_gnn_any_kernel_past_512_and_32(cuda, dtype, E, T0, T1, N, L):
    """Shapes past E = 512 and past 32 objects, which JAX takes: each on
    the route ``any_plan`` gives (the wide one past 32 objects)."""
    route = _gnn_case(cuda, dtype, E, T0, T1, N, L)
    if T0 > tgnn.MAX_SHARED_SET:
        assert route == "superglue_gnn_any_wide"


@pytest.mark.parametrize("T0,T1", [(48, 6), (40, 40)])
def test_gnn_any_wide_route_keeps_exact_ties_and_ragged_counts(cuda, T0, T1):
    """On the wide route, bf16: identical hints give bit-identical score
    columns, and a pair's scores are the same bits in a batch of 1, 2 or
    5 pairs."""
    packed = _packed(300, torch.bfloat16, cuda, 2)
    g = torch.Generator().manual_seed(T0 + T1)
    d0 = torch.randn(5, T0, 300, generator=g).to(cuda)
    d1 = torch.randn(5, T1, 300, generator=g).to(cuda)
    d1[:, 4] = d1[:, 1]
    s = tgnn.gnn_scores(d0, d1, packed)
    torch.testing.assert_close(s[:, :, 4], s[:, :, 1], atol=0, rtol=0)
    for n in (1, 2):
        alone = tgnn.gnn_scores(d0[:n].contiguous(), d1[:n].contiguous(),
                                packed)
        torch.testing.assert_close(alone, s[:n], atol=0, rtol=0)


# The redesigned wide route: phase 14's path shape (one pair a CTA, 64
# rows), 33 objects at E = 300 (2 pairs, 96 rows), 128 objects (two
# m-chunks) and the smallest width (3 pairs, 128 rows).
WIDE_SHAPES = [(768, 48, 6), (300, 33, 6), (128, 128, 6), (4, 33, 1)]


def wide_workspace_bytes(T0, dtype, plan, n_pairs, sms=tgnn.H100_SMS):
    """``t2p_superglue_gnn_any_workspace`` on the wide route, mirrored: a
    slice for each persistent CTA (one an SM, at most one a unit of
    ``plan.pairs`` pairs) of its rows' f32 residual (bf16 only), a | m,
    q | k | v, the messages and the attention's scratch (bf16: 8 warps'
    logits, 8 floats a lane a 16-key chunk; f32: the probabilities of 4
    heads), each part aligned to 256 bytes."""
    Ep, R = plan.width, plan.rows
    bf16 = dtype == torch.bfloat16
    s = 2 if bf16 else 4
    parts = [R * Ep * 4 if bf16 else 0, R * 2 * Ep * s, R * 3 * Ep * s,
             R * Ep * s,
             8 * -(-T0 // 16) * 32 * 8 * 4 if bf16 else R * 4 * T0 * 4]
    return min(-(-n_pairs // plan.pairs), sms) * sum(
        -(-p // 256) * 256 for p in parts)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,T0,T1", WIDE_SHAPES)
def test_gnn_wide_workspace_is_the_mirrored_formula(cuda, dtype, E, T0, T1):
    """The C side's workspace on this card is ``wide_workspace_bytes`` at
    its SM count, for a ragged and a full batch."""
    plan = tgnn.any_plan(E, T0, T1, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n in (2 * plan.pairs + 1, 1280):
        assert tgnn.any_workspace_bytes(
            E, T0, T1, plan, n, int(dtype == torch.bfloat16), cuda) == \
            wide_workspace_bytes(T0, dtype, plan, n, sms)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,T0,T1", WIDE_SHAPES)
def test_gnn_wide_route_matches_plain(cuda, dtype, E, T0, T1):
    """G pairs a CTA, weight and row k-slices staged through shared memory,
    bf16 products on the tensor cores: against the plain version on 2G + 1
    pairs (the last CTA ragged), 2 blocks."""
    plan = tgnn.any_plan(E, T0, T1, dtype)
    assert plan.route == "superglue_gnn_any_wide"
    _gnn_case(cuda, dtype, E, T0, T1, 2 * plan.pairs + 1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,T0,T1", WIDE_SHAPES)
def test_gnn_wide_route_ties_and_ragged_counts_bit_for_bit(cuda, monkeypatch,
                                                           dtype, E, T0, T1):
    """Identical hints (in every pair, so in every slot of a CTA) give
    bit-identical score columns; a pair's scores are the same bits in a
    batch of 1 .. G + 1 pairs and at one pair a CTA."""
    packed = _packed(E, dtype, cuda, 2)
    G = tgnn.any_plan(E, T0, T1, dtype).pairs
    g = torch.Generator().manual_seed(E + T0)
    N = 2 * G + 1
    d0 = torch.randn(N, T0, E, generator=g).to(cuda)
    d1 = torch.randn(N, T1, E, generator=g).to(cuda)
    if T1 > 1:
        d1[:, T1 - 1] = d1[:, 0]
    s = _launches("superglue_gnn_any_wide",
                  lambda: tgnn.gnn_scores(d0, d1, packed))
    if T1 > 1:
        torch.testing.assert_close(s[:, :, T1 - 1], s[:, :, 0], atol=0,
                                   rtol=0)
    for n in range(1, G + 2):
        alone = tgnn.gnn_scores(d0[:n].contiguous(), d1[:n].contiguous(),
                                packed)
        torch.testing.assert_close(alone, s[:n], atol=0, rtol=0)
    plan = tgnn.any_plan(E, T0, T1, dtype)
    monkeypatch.setattr(tgnn, "any_plan",
                        lambda *args: tgnn.wide_plan(*args)._replace(
                            pairs=1, rows=tgnn.set_major_rows(1, T0, T1),
                            hint_row=16 * -(-T0 // 16)))
    one = tgnn.gnn_scores(d0, d1, packed)
    torch.testing.assert_close(one, s, atol=0, rtol=0)
    assert plan.pairs == G


def test_gnn_wide_route_holds_float64_at_depth(cuda):
    """Phase 14's shape at 12 blocks in bf16, 64 pairs: every score within
    twice the bf16 tolerance (1% of the largest score) of the float64
    evaluation at the same rounding points, the depth gate's bound on its
    largest pair."""
    packed = _packed(768, torch.bfloat16, cuda, 12)
    g = torch.Generator().manual_seed(12)
    d0 = torch.nn.functional.normalize(torch.randn(64, 48, 768, generator=g),
                                       dim=-1).to(cuda)
    d1 = torch.nn.functional.normalize(torch.randn(64, 6, 768, generator=g),
                                       dim=-1).to(cuda)
    got = _launches("superglue_gnn_any_wide",
                    lambda: tgnn.gnn_scores(d0, d1, packed))
    ref = tgnn.gnn_scores_plain(d0, d1, packed, acc=torch.float64)
    err = float((got.double() - ref).abs().max())
    assert err <= 2 * REL_TOL[torch.bfloat16] * float(ref.abs().max())


def test_gnn_any_kernel_rejects_bad_input(cuda):
    packed = _packed(300, torch.float32, cuda, 2)
    d0 = torch.zeros(2, 16, 300, device=cuda)
    with pytest.raises(ValueError, match="T1 <= T0"):
        tgnn.gnn_scores(d0, torch.zeros(2, 17, 300, device=cuda), packed)
    with pytest.raises(ValueError):            # weights of another width
        tgnn.gnn_scores(torch.zeros(2, 16, 296, device=cuda),
                        torch.zeros(2, 6, 296, device=cuda), packed)


@pytest.mark.parametrize("N", [1024, 512, 700, 257])
def test_fps_kernel_wide_bit_equal_to_plain(cuda, N):
    """Indices and centroids bit for bit past 256 points (12, 16, 24 and
    32 points a lane), on ties everywhere (duplicated points)."""
    g = torch.Generator().manual_seed(N)
    base = torch.randn(9, 60, 3, generator=g)
    pick = torch.randint(0, 60, (9, N), generator=g)
    pts = torch.gather(base, 1, pick[..., None].expand(9, N, 3)).to(cuda)
    for S in (N // 2, N):
        idx, cent = _launches("fps",
                              lambda: tfps.farthest_point_sampling(pts, S))
        widx, wcent = tfps.farthest_point_sampling_plain(pts, S)
        assert torch.equal(idx, widx)
        assert torch.equal(cent, wcent)
