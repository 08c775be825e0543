"""The port's hand-written CUDA kernels against their plain PyTorch versions.

Imports only torch and numpy, so it also runs on a card machine without JAX:

    python -m pytest --noconftest tests/test_torch_port_kernels.py -q

Without a CUDA device every test skips (the kernels have no CPU mode).
"""

import ctypes

import numpy as np
import pytest
import torch

from text2pos_torch.ops import _build
from text2pos_torch.ops import fps as tfps
from text2pos_torch.ops import lstm as tlstm
from text2pos_torch.ops import pointconv as tpc
from text2pos_torch.ops import sinkhorn as tsink
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
    """Tables with a nonzero row 0, tokens holding unk (0) inside the
    valid length, lengths 1 … T (1 and T always present)."""
    g = torch.Generator().manual_seed(seed)
    tables = [torch.randn(V, 4 * H, generator=g) for _ in range(2)]
    w_hh = [(torch.rand(H, 4 * H, generator=g) - 0.5) / H ** 0.5
            for _ in range(2)]
    tokens = torch.randint(0, V, (B, T), generator=g, dtype=torch.int32)
    tokens[::3, 0] = 0
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0], lengths[-1] = 1, T
    return tables, w_hh, tokens, lengths


@pytest.mark.parametrize("T,B,H", [
    (9, 37, 32),        # ragged B: one full tile and a partial one
    (64, 40, 256),      # the coarse encoder's width, a cluster of 8
    (16, 19, 128),      # the fine encoder's width, fewer than a tile
    (5, 70, 96),        # a cluster of 3
])
def test_lstm_kernel_matches_plain(cuda, T, B, H):
    """Both directions in one launch against the plain version (f32 on
    both sides, other summation order)."""
    tables, w_hh, tokens, lengths = _lstm_case(T, B, H, seed=T)
    args = ([t.to(cuda) for t in tables], [w.to(cuda) for w in w_hh],
            tokens.to(cuda), lengths.to(cuda))
    got = _launches("lstm", lambda: tlstm.lstm_final_hidden(*args))
    want = tlstm.lstm_final_hidden_plain(*args)
    assert got.shape == (2, B, H)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_lstm_kernel_generic_path(cuda):
    """``bilstm_final_hidden`` on any input runs the same kernel over a
    table of T·B rows; against the plain version on the CPU."""
    g = torch.Generator().manual_seed(4)
    B, T, E = 45, 12, 64
    x = torch.randn(B, T, E, generator=g)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    params = [tlstm.LSTMParams(torch.randn(E, 4 * E, generator=g) / E ** 0.5,
                               torch.randn(E, 4 * E, generator=g) / E ** 0.5,
                               torch.randn(4 * E, generator=g))
              for _ in range(2)]
    want = tlstm.bilstm_final_hidden(x, lengths, *params)
    on_card = [tlstm.LSTMParams(*(t.to(cuda) for t in p)) for p in params]
    got = _launches("lstm", lambda: tlstm.bilstm_final_hidden(
        x.to(cuda), lengths.to(cuda), *on_card))
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)


def test_lstm_kernel_rejects_unsupported_width(cuda):
    """H = 0 is refused; H = 544, past the largest cluster, is taken by
    the grid form (JAX takes any H)."""
    tables, w_hh, tokens, lengths = _lstm_case(3, 2, 0)
    with pytest.raises(ValueError, match="at least 1"):     # H = 0
        tlstm.lstm_final_hidden([t.to(cuda) for t in tables],
                                [w.to(cuda) for w in w_hh], tokens.to(cuda),
                                lengths.to(cuda))
    tables, w_hh, tokens, lengths = _lstm_case(3, 2, 544)
    args = ([t.to(cuda) for t in tables], [w.to(cuda) for w in w_hh],
            tokens.to(cuda), lengths.to(cuda))
    got = _launches("lstm_grid", lambda: tlstm.lstm_final_hidden(*args))
    torch.testing.assert_close(got, tlstm.lstm_final_hidden_plain(*args),
                               atol=1e-5, rtol=1e-4)


def test_lstm_kernel_rejects_bad_input(cuda):
    tables, w_hh, tokens, lengths = _lstm_case(3, 2, 32)
    tables = [t.to(cuda) for t in tables]
    w_hh = [w.to(cuda) for w in w_hh]
    tokens, lengths = tokens.to(cuda), lengths.to(cuda)
    with pytest.raises(TypeError):         # bf16 tables
        tlstm.lstm_final_hidden([t.bfloat16() for t in tables], w_hh,
                                tokens, lengths)
    with pytest.raises(ValueError):        # w_hh on the CPU
        tlstm.lstm_final_hidden(tables, [w.cpu() for w in w_hh], tokens,
                                lengths)
    with pytest.raises(ValueError):        # float tokens
        tlstm.lstm_final_hidden(tables, w_hh, tokens.float(), lengths)


def _sinkhorn_inputs(B, M, N, scale, seed):
    rng = np.random.default_rng(seed)
    Z = np.clip(scale / 3 * rng.standard_normal((B, M, N)), -scale, scale)
    Z[0, 0, 0] = scale
    mu = np.log(rng.dirichlet(np.ones(M), B))
    nu = np.log(rng.dirichlet(np.ones(N), B))
    return [torch.tensor(a, dtype=torch.float32) for a in (Z, mu, nu)]


@pytest.mark.parametrize("B,M,N", [
    (1000, 17, 7),                          # the serving coupling
    (45, 17, 8), (45, 16, 7),               # around it: the generic one
    (33, 1, 1), (77, 32, 16), (5, 9, 13)])
@pytest.mark.parametrize("iters", [0, 1, 50])
def test_sinkhorn_kernel_matches_plain(cuda, B, M, N, iters):
    """Given couplings (scores up to +-60) and marginals, ragged B."""
    args = [a.to(cuda) for a in _sinkhorn_inputs(B, M, N, 60.0, M * N)]
    got = _launches("sinkhorn", lambda: tsink.log_sinkhorn(*args, iters))
    want = tsink.log_sinkhorn_plain(*args, iters)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,M,N", [
    (20480 // 7, 16, 6),                    # the serving coupling
    (33, 16, 7), (41, 1, 1), (37, 31, 15)])
@pytest.mark.parametrize("iters", [0, 1, 6, 50])    # 6: the cascade's
def test_sinkhorn_kernel_fused_dustbins(cuda, B, M, N, iters):
    """Scores → log transport with the dustbins built in the kernel,
    against the plain dustbin couplings + Sinkhorn - norm."""
    scores = _sinkhorn_inputs(B, M, N, 60.0, B)[0].to(cuda)
    alpha = torch.tensor(1.3, device=cuda)
    got = _launches("sinkhorn", lambda: tsink.log_optimal_transport(
        scores, alpha, iters))
    want = tsink.log_optimal_transport_plain(scores, alpha, iters)
    assert got.shape == (B, M + 1, N + 1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_sinkhorn_kernel_rejects_bad_input(cuda):
    """33 rows and 17 columns go to the wide form (JAX takes any
    coupling); marginals of another shape, no rows and f64 marginals are
    refused."""
    z = torch.zeros(3, 33, 7, device=cuda)
    got = _launches("sinkhorn_wide", lambda: tsink.log_sinkhorn(
        z, torch.zeros(3, 33, device=cuda), torch.zeros(3, 7, device=cuda),
        5))
    assert got.shape == (3, 33, 7)
    got = _launches("sinkhorn_wide", lambda: tsink.log_optimal_transport(
        torch.zeros(3, 16, 16, device=cuda), torch.tensor(1.0, device=cuda),
        5))
    assert got.shape == (3, 17, 17) and bool(torch.isfinite(got).all())
    with pytest.raises(ValueError):        # marginals of another shape
        tsink.log_sinkhorn(z, torch.zeros(3, 32, device=cuda),
                           torch.zeros(3, 7, device=cuda), 5)
    with pytest.raises(ValueError):        # no rows
        tsink.log_sinkhorn(torch.zeros(3, 0, 7, device=cuda),
                           torch.zeros(3, 0, device=cuda),
                           torch.zeros(3, 7, device=cuda), 5)
    with pytest.raises(TypeError):         # f64 marginals
        tsink.log_sinkhorn(torch.zeros(3, 17, 7, device=cuda),
                           torch.zeros(3, 17, device=cuda).double(),
                           torch.zeros(3, 7, device=cuda), 5)


def _packed(dtype, device, L=4):
    return tgnn.pack_gnn_params(tgnn.random_folded_params(L), dtype, device)


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5),
                                           (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("N,L", [
    (37, 4),                     # ragged: a quarter (bf16) or half (f32) CTA
    (1, 4), (tgnn.TC_PAIRS - 1, 4), (tgnn.TC_PAIRS, 4),
    (tgnn.TC_PAIRS + 1, 4),      # around one CTA of the bf16 kernel
    (37, 2),                     # the cascade's depth
])
def test_gnn_kernel_matches_plain(cuda, dtype, rel_tol, N, L):
    """Tolerance relative to the largest score: both sides sum in f32 in
    different orders; in bf16 that can move a value by one bf16 step."""
    packed = _packed(dtype, cuda, L)
    g = torch.Generator().manual_seed(2)
    d0 = torch.randn(N, 16, 128, generator=g).to(cuda)
    d1 = torch.randn(N, 6, 128, generator=g).to(cuda)
    got = _launches("superglue_gnn", lambda: tgnn.gnn_scores(d0, d1, packed))
    want = tgnn.gnn_scores_plain(d0, d1, packed)
    assert got.shape == (N, 16, 6) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel_tol * float(want.abs().max()))


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5),
                                           (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("L", [0, 2])
@pytest.mark.parametrize("N", [37, tgnn.TC_PAIRS])
def test_gnn_kernel_cut_depth_from_sliced_stacks(cuda, dtype, rel_tol, L, N):
    """The cascade's cheap pass: the first L blocks of a 12-block fold,
    sliced views of its stacks, the final projection shared; at L = 0 the
    final projection and scores of the input descriptors alone."""
    full = _packed(dtype, cuda, 12)
    packed = {k: v if k in tgnn.UNSTACKED else v[:L] for k, v in full.items()}
    g = torch.Generator().manual_seed(5 + L)
    d0 = torch.randn(N, 16, 128, generator=g).to(cuda)
    d1 = torch.randn(N, 6, 128, generator=g).to(cuda)
    got = _launches("superglue_gnn", lambda: tgnn.gnn_scores(d0, d1, packed))
    want = tgnn.gnn_scores_plain(d0, d1, packed)
    assert got.shape == (N, 16, 6) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel_tol * float(want.abs().max()))


def _f32_form_pairs(cuda, G, offset=0):
    """A pair count at which the tuned f32 kernel takes G pairs a CTA:
    ``offset`` past a multiple of 4 that leaves no SM idle at G (1: one
    pair an SM; 2: past one wave of single pairs; 4: past one of two)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n = {1: 0, 2: 4 * -(-sms // 4), 4: 4 * -(-(2 * sms + 4) // 4)}[G] + offset
    assert tgnn.f32_pairs(n, cuda) == G
    return n


@pytest.mark.parametrize("dtype,form", [(torch.bfloat16, None)] + [
    (torch.float32, g) for g in (1, 2, 4)])
@pytest.mark.parametrize("equal", [
    (1, 4),       # within one 16-row tile of the bf16 kernel's layout
    (3, 4),       # in two tiles for a CTA's third pair (pairs 2 and 6 here)
    (0, 3, 4),    # three equal hints
])
def test_gnn_kernel_keeps_exact_ties(cuda, dtype, form, equal):
    """Identical hints must give bit-identical score columns (mutual-max
    extraction then takes the first, as JAX does), wherever their rows lie
    in the kernel's tiles; in f32 also with each pairs-a-CTA form, reached
    by the launch's size (hint rows in either of a pair's two 11-row
    thread tiles)."""
    packed = _packed(dtype, cuda)
    n = 8 if form is None else _f32_form_pairs(cuda, form, 8)
    g = torch.Generator().manual_seed(3)
    d0 = torch.randn(n, 16, 128, generator=g).to(cuda)
    d1 = torch.randn(n, 6, 128, generator=g).to(cuda)
    for j in equal[1:]:
        d1[:, j] = d1[:, equal[0]]
    s = tgnn.gnn_scores(d0, d1, packed)
    for j in equal[1:]:
        torch.testing.assert_close(s[:, :, j], s[:, :, equal[0]], atol=0,
                                   rtol=0)


@pytest.mark.parametrize("form", (1, 2, 4))
@pytest.mark.parametrize("offset", [1, 3, 4, 5, 37])
def test_gnn_f32_kernel_pairs_a_cta(cuda, form, offset):
    """Each pairs-a-CTA form of the f32 kernel, reached by the launch's
    size, with its last CTA holding 1, G − 1, G or G + 1 (mod G) pairs
    and ragged: within 1e-5 of the plain version, bit-identical to a
    second run and to the same pairs launched in another form (a pair's
    sums do not depend on its CTA's other pairs): the first 8 in one pair
    a CTA, or all of them at the head of a launch in four."""
    packed = _packed(torch.float32, cuda)
    n = _f32_form_pairs(cuda, form, offset)
    g = torch.Generator().manual_seed(40 + n)
    d0 = torch.randn(n, 16, 128, generator=g).to(cuda)
    d1 = torch.randn(n, 6, 128, generator=g).to(cuda)
    got = tgnn.gnn_scores(d0, d1, packed)
    want = tgnn.gnn_scores_plain(d0, d1, packed)
    assert got.shape == (n, 16, 6) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got, tgnn.gnn_scores(d0, d1, packed))
    if form == 4:
        k = min(n, 8)
        assert torch.equal(got[:k], tgnn.gnn_scores(d0[:k], d1[:k], packed))
    else:
        m = _f32_form_pairs(cuda, 4, 8)
        pad = torch.randn(m, 22, 128, generator=g).to(cuda)
        whole = tgnn.gnn_scores(torch.cat([d0, pad[:m - n, :16]]),
                                torch.cat([d1, pad[:m - n, 16:]]), packed)
        assert torch.equal(got, whole[:n])


def test_gnn_f32_kernel_chooses_pairs_by_size(cuda):
    """Few pairs take one a CTA (every pair its own SM), two past one wave
    of those, four past one wave of pairs, the headline's 20,480 four; the
    choice never falls as the pairs grow past a wave."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tgnn.f32_pairs(1) == 1 and tgnn.f32_pairs(sms) == 1
    assert tgnn.f32_pairs(sms + 1) == 2 and tgnn.f32_pairs(2 * sms) == 2
    assert tgnn.f32_pairs(2 * sms + 1) == 4
    assert tgnn.f32_pairs(20480) == 4 and tgnn.f32_pairs(262144) == 4
    assert all(tgnn.f32_pairs(n) in (1, 2, 4) for n in range(1, 4 * sms + 3))


def test_gnn_kernel_layout_constants(cuda):
    """The wrapper's constants are the kernel's static shape and the pairs
    a CTA of the bf16 kernel takes."""
    fn = _build.entry("superglue_gnn", "t2p_superglue_gnn_shape",
                      [ctypes.POINTER(ctypes.c_int)] * 4)
    vals = [ctypes.c_int() for _ in range(4)]
    assert fn(*map(ctypes.byref, vals)) == 0
    assert tuple(v.value for v in vals) == tgnn.KERNEL_SHAPE + (
        tgnn.TC_PAIRS,)


def test_gnn_kernel_rejects_bad_input(cuda):
    packed = _packed(torch.bfloat16, cuda)
    d0 = torch.zeros(2, 16, 128, device=cuda)
    with pytest.raises(ValueError, match="T1 <= T0"):   # more hints than
        tgnn.gnn_scores(d0, torch.zeros(2, 17, 128, device=cuda), packed)
    with pytest.raises(ValueError):           # weights on another device
        tgnn.gnn_scores(d0, torch.zeros(2, 6, 128, device=cuda),
                        {k: v.cpu() for k, v in packed.items()})


def _pointconv_case(device, dtype, B, N, S, C1, C2, spread, seed):
    """One SA level's inputs: points uniform in [-spread, spread]³, the
    first S points as centroids, random projections and BN affines."""
    g = torch.Generator().manual_seed(seed)
    pos = (torch.rand(B, N, 3, generator=g) * 2 - 1) * spread
    cent = pos[:, :S].clone()
    a = torch.randn(B, N, C1, generator=g)
    c = 0.3 * torch.randn(B, S, C1, generator=g)
    w2 = torch.randn(C1, C2, generator=g) / C1 ** 0.5
    vecs = [torch.rand(n, generator=g) + o for n, o in
            ((C1, 0.5), (C1, -0.5), (C2, -0.5), (C2, 0.5), (C2, -0.5))]
    s0, t0, b2, s1, t1 = (v.to(device) for v in vecs)
    return (a.to(device, dtype), pos.to(device), c.to(device, dtype),
            cent.to(device), (s0, t0), w2.to(device, dtype), b2, (s1, t1))


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5),
                                           (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("B,N,S,C1,C2,radius,spread", [
    (37, 256, 128, 32, 64, 0.2, 1.0),    # sa1 widths, odd object count
    (5, 128, 64, 128, 128, 0.3, 1.0),    # sa2
    (3, 64, 32, 256, 256, 0.4, 1.0),     # sa3
    (7, 40, 5, 32, 64, 0.2, 1.0),        # S smaller than a CTA's tile
    (4, 200, 16, 32, 64, 0.05, 1.0),     # fewer than K in most balls
    (3, 300, 24, 128, 128, 0.9, 0.3),    # more than K in every ball
])
def test_pointconv_kernel_matches_plain(cuda, dtype, rel_tol, B, N, S, C1, C2,
                                        radius, spread):
    """Tolerance relative to the largest output: both sides sum the second
    layer in f32 in different orders; in bf16 that can move a value by one
    bf16 step (2^-8 relative)."""
    args = _pointconv_case(cuda, dtype, B, N, S, C1, C2, spread, B * N)
    got = _launches("pointconv", lambda: tpc.pointconv_max(*args, radius, 32))
    want = tpc.pointconv_max_plain(*args, radius, 32)
    assert got.dtype == dtype and got.shape == (B, S, C2)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel_tol * float(want.float().abs().max()))
    if dtype == torch.bfloat16:   # W2 packed once by the caller: the same
        w2f = tpc.w2_fragments(args[5])
        assert torch.equal(tpc.pointconv_max(*args, radius, 32, w2f=w2f), got)


def test_pointconv_kernel_launch_shapes_per_width(cuda):
    """The bf16 kernel works out a launch's shape once per (device, C2) and
    keeps it: a narrow W2 after a wide one, then the wide one again, each
    still launches (the shared-memory limit is not lowered) and agrees."""
    for C2 in (1024, 64, 1024, 64):
        args = _pointconv_case(cuda, torch.bfloat16, 3, 128, 64, 64, C2, 1.0,
                               C2)
        got = _launches("pointconv", lambda: tpc.pointconv_max(*args, 0.3,
                                                               32))
        want = tpc.pointconv_max_plain(*args, 0.3, 32)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=1e-2 * float(want.float().abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pointconv_kernel_all_duplicate_points(cuda, dtype):
    """Every point of an object at one place (a padding object resampled):
    every ball holds all N points and the first K by index are taken."""
    args = list(_pointconv_case(cuda, dtype, 9, 256, 128, 32, 64, 1.0, 7))
    args[1] = torch.full_like(args[1], 0.25)
    args[3] = torch.full_like(args[3], 0.25)
    idx, valid = tpc.ball_neighbors(args[1], args[3], 0.2, 32)
    assert bool(valid.all())
    assert bool((idx == torch.arange(32, device=cuda)).all())
    got = _launches("pointconv", lambda: tpc.pointconv_max(*args, 0.2, 32))
    want = tpc.pointconv_max_plain(*args, 0.2, 32)
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=1e-2 * float(want.float().abs().max()))


def test_pointconv_kernel_rejects_bad_input(cuda):
    args = list(_pointconv_case(cuda, torch.float32, 2, 64, 32, 30, 64, 1.0,
                                1))
    with pytest.raises(ValueError):       # C1 not a multiple of 4
        tpc.pointconv_max(*args, 0.2, 32)
    args = list(_pointconv_case(cuda, torch.float32, 2, 64, 32, 32, 64, 1.0,
                                1))
    args[2] = args[2].to(torch.bfloat16)
    with pytest.raises(TypeError):        # mixed compute dtypes
        tpc.pointconv_max(*args, 0.2, 32)
    for C1, C2 in ((48, 64), (256, 512)):  # not a bf16 instantiation; W2 too big
        args = _pointconv_case(cuda, torch.bfloat16, 2, 64, 32, C1, C2, 1.0, 1)
        with pytest.raises(ValueError):
            tpc.pointconv_max(*args, 0.2, 32)


COUNTS = (0, 1, 2, 15, 16, 17, 31, 32, 45)   # neighbours of centroid s % 9


def _counted_case(device, dtype, B, S, C1, C2, seed):
    """Centroid s of every object has exactly COUNTS[s % 9] points in its
    ball (45: more than the cap), scattered among the others by a random
    permutation; the rest lie far away. Ragged S. Every third BN1 scale is
    negative: there the bf16 kernel's max over rows takes the smallest
    product."""
    args = list(_pointconv_case(device, dtype, B, 1, S, C1, C2, 1.0, seed))
    s1, t1 = args[7]
    flip = torch.ones_like(s1)
    flip[::3] = -1.0
    args[7] = (s1 * flip, t1)
    g = torch.Generator().manual_seed(seed + 1)
    counts = [COUNTS[s % len(COUNTS)] for s in range(S)]
    cent = torch.zeros(B, S, 3)
    cent[..., 0] = torch.arange(S, dtype=torch.float32)[None] * 3.0
    pos = []
    for s, k in enumerate(counts):
        pos.append(cent[:, s:s + 1] + 0.1 * (torch.rand(B, k, 3, generator=g)
                                             - 0.5))
    pos.append(torch.full((B, 7, 3), -50.0) + torch.rand(B, 7, 3, generator=g))
    pos = torch.cat(pos, 1)
    pos = pos[:, torch.randperm(pos.shape[1], generator=g)]
    N = pos.shape[1]
    args[0] = torch.randn(B, N, C1, generator=g).to(device, dtype)
    args[1], args[3] = pos.to(device), cent.to(device)
    return args, torch.tensor(counts)


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5),
                                           (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("B,S,C1,C2", [
    (6, 13, 32, 64), (3, 11, 128, 128), (5, 9, 256, 256),
    # Around the f32 route's CTA of 8 centroids (31 and 32 of them: a
    # partial and a full fourth CTA), and C2 not a multiple of 128 (two
    # consecutive columns a lane).
    (1, 31, 32, 64), (1, 32, 128, 128), (3, 11, 256, 256),
    (5, 13, 128, 192)])
def test_pointconv_kernel_neighbour_counts(cuda, dtype, rel_tol, B, S, C1,
                                           C2):
    """0, 1, 16, 17, exactly 32 and more than 32 neighbours (one or two
    16-row tiles of the bf16 kernel, a partial and a full last tile; 0-4
    8-row tiles of the f32 kernel) at the model's three widths, S not a
    multiple of a CTA's warps; a second run is bit-identical."""
    args, counts = _counted_case(cuda, dtype, B, S, C1, C2, B * S)
    _, valid = tpc.ball_neighbors(args[1], args[3], 0.5, 32)
    assert valid.sum(-1).cpu().equal(counts.clamp(max=32).expand(B, S))
    got = _launches("pointconv", lambda: tpc.pointconv_max(*args, 0.5, 32))
    want = tpc.pointconv_max_plain(*args, 0.5, 32)
    assert bool((got[:, counts == 0] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=rel_tol * float(want.float().abs().max()))
    assert torch.equal(got, tpc.pointconv_max(*args, 0.5, 32))


def test_pointconv_kernel_takes_rows_off_16_byte_boundaries(cuda):
    """The bf16 kernel reads rows of a and c and pairs of b2 and BN1
    columns as vectors: contiguous views that start one element into their
    storage give the aligned result."""
    args = list(_pointconv_case(cuda, torch.bfloat16, 3, 64, 32, 128, 128,
                                1.0, 8))
    want = tpc.pointconv_max(*args, 0.3, 32)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        assert y.is_contiguous() and y.data_ptr() % 8
        return y

    args[0], args[2], args[6] = (shifted(args[i]) for i in (0, 2, 6))
    args[7] = tuple(shifted(v) for v in args[7])
    got = _launches("pointconv", lambda: tpc.pointconv_max(*args, 0.3, 32))
    assert torch.equal(got, want)


def _fps_points(B, N, seed):
    """Objects as the encoders see them: blobs resampled with replacement
    from 20-60 distinct points (exact duplicates), one object of a single
    repeated point and one padding-like object (8 distinct points in
    [0, 0.001)^3, the rest of it copies of them)."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(B, 60, 3, generator=g) * torch.tensor([2.0, 2.0, 0.5])
    pick = (torch.rand(B, N, generator=g)
            * torch.randint(20, 61, (B, 1), generator=g)).long()
    pts = torch.gather(base, 1, pick[..., None].expand(B, N, 3))
    pts[0] = 0.25
    pad = torch.rand(8, 3, generator=g) * 1e-3
    pts[1] = pad[torch.arange(N) % 8]
    return pts


@pytest.mark.parametrize("N", [256, 128, 64, 200, 33, 1])
def test_fps_kernel_bit_equal_to_plain(cuda, N):
    """Indices and centroids bit for bit, at every level's S = N/2 and at
    S = N, on ties everywhere."""
    pts = _fps_points(37, N, N).to(cuda)
    for S in sorted({max(1, N // 2), N}):
        idx, cent = _launches("fps",
                              lambda: tfps.farthest_point_sampling(pts, S))
        widx, wcent = tfps.farthest_point_sampling_plain(pts, S)
        assert idx.dtype == torch.long and idx.shape == (37, S)
        assert torch.equal(idx, widx)
        assert torch.equal(cent, wcent)
    # All points equal: every step ties everywhere; the first index wins.
    assert bool((idx[0] == 0).all())


def test_fps_kernel_chains_the_three_levels(cuda):
    """sa1 -> sa2 -> sa3 as the tower runs it: each level's centroids are
    the next level's points."""
    pts = _fps_points(300, 256, 5).to(cuda)
    got = want = pts
    for S in (128, 64, 32):
        got = tfps.farthest_point_sampling(got, S)[1]
        want = tfps.farthest_point_sampling_plain(want, S)[1]
        assert torch.equal(got, want)


@pytest.mark.parametrize("N,S", [(1025, 512), (2048, 1024), (4097, 64),
                                 (4096, 4096)])
def test_fps_kernel_past_1024_points_bit_equal_to_plain(cuda, N, S):
    """A CTA an object (up to 4096 points in registers), then the minima in
    global memory; ties everywhere."""
    pts = _fps_points(9, N, N).to(cuda)
    idx, cent = _launches("fps", lambda: tfps.farthest_point_sampling(pts, S))
    widx, wcent = tfps.farthest_point_sampling_plain(pts, S)
    assert torch.equal(idx, widx) and torch.equal(cent, wcent)


@pytest.mark.parametrize("B,N,ratios", [
    (300, 256, (0.5, 0.5, 0.5)),    # the DB encode's levels
    (37, 64, (0.5, 0.5, 0.5)),      # sa3-sized: half a warp where packed
    (5, 2048, (0.25, 0.5, 0.5)),    # a CTA an object at every level
    (3, 5000, (0.01, 0.5)),         # global memory, then registers
])
def test_fps_levels_kernel_one_launch_bit_equal_to_plain(cuda, B, N, ratios):
    """The levels entry makes one launch and equals the plain loop level by
    level (each level on the last one's centroids), bit for bit."""
    pts = _fps_points(B, N, B + N).to(cuda)
    got = _launches("fps", lambda: tfps.farthest_point_sampling_levels(
        pts, ratios))
    want = tfps.farthest_point_sampling_levels_plain(pts, ratios)
    assert len(got) == len(want) == len(ratios)
    for (idx, cent), (widx, wcent) in zip(got, want):
        assert idx.dtype == torch.long and idx.shape == widx.shape
        assert torch.equal(idx, widx) and torch.equal(cent, wcent)


def test_fps_kernel_rejects_bad_input(cuda):
    with pytest.raises(ValueError):       # no object
        tfps.farthest_point_sampling(torch.zeros(0, 16, 3, device=cuda), 8)
    with pytest.raises(ValueError):       # more samples than points
        tfps.farthest_point_sampling(torch.zeros(2, 16, 3, device=cuda), 17)
    with pytest.raises(TypeError):        # f64 points
        tfps.farthest_point_sampling(
            torch.zeros(2, 16, 3, device=cuda, dtype=torch.float64), 8)
    with pytest.raises(ValueError):       # not [B, N, 3]
        tfps.farthest_point_sampling(torch.zeros(2, 16, 2, device=cuda), 8)


@pytest.mark.parametrize("calibrated", [True, False])
def test_serving_launch_counts(cuda, calibrated):
    """Calibrated serving runs the LSTM, GNN and Sinkhorn kernels; on batch
    statistics (the uncalibrated model) the GNN runs as PyTorch ops and the
    LSTM and Sinkhorn kernels still run, one launch per encoder and one
    Sinkhorn launch a batch."""
    import os

    from text2pos_torch.evaluation.pipeline import LocalizationPipeline

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ck = os.path.join(root, "checkpoints")
    db_cache = os.path.join(ck, "bench_db_cache.npz")
    fx = np.load(os.path.join(root, "text2pos_torch", "fixtures",
                              "bench_queries.npz"))
    pipe = LocalizationPipeline.from_checkpoints(
        os.path.join(ck, "bench_coarse.msgpack"),
        os.path.join(ck, "bench_fine.msgpack"),
        db_cache if calibrated else None, device=cuda)
    if not calibrated:
        with np.load(db_cache) as z:
            pipe = pipe.with_database(*(
                torch.as_tensor(z[k]).float().to(cuda) for k in (
                    "cell_enc", "fine_bank_enc", "fine_bank_centers")))
    args = [fx[k][:64] for k in ("tokens", "lengths", "hint_tokens",
                                 "hint_lengths")]
    _build.LAUNCHES.clear()
    out = pipe.serve_batch(*args, 10)
    torch.cuda.synchronize()
    assert out[0].shape == (64, 10)
    assert bool(torch.isfinite(out[2].float()).all())
    launches = dict(_build.LAUNCHES)
    assert launches.get("lstm", 0) == 2 and launches.get("sinkhorn", 0) == 1
    assert launches.get("superglue_gnn", 0) == (1 if calibrated else 0)


def test_kernels_launch_on_their_tensors_card(cuda):
    """Every kernel on tensors of the second card while the first is
    current (each wrapper makes its tensors' card current around the
    launch), against its plain version there, at the tolerances of the
    tests above; FPS bit for bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    dev = torch.device("cuda", 1)
    before = dict(_build.LAUNCHES)
    with torch.cuda.device(0):
        tables, w_hh, tokens, lengths = _lstm_case(9, 37, 32)
        args = ([t.to(dev) for t in tables], [w.to(dev) for w in w_hh],
                tokens.to(dev), lengths.to(dev))
        got = tlstm.lstm_final_hidden(*args)
        torch.testing.assert_close(got, tlstm.lstm_final_hidden_plain(*args),
                                   atol=1e-5, rtol=1e-4)
        scores = _sinkhorn_inputs(45, 16, 6, 60.0, 3)[0].to(dev)
        alpha = torch.tensor(1.3, device=dev)
        got = tsink.log_optimal_transport(scores, alpha, 50)
        torch.testing.assert_close(
            got, tsink.log_optimal_transport_plain(scores, alpha, 50),
            atol=1e-4, rtol=1e-4)
        packed = _packed(torch.bfloat16, dev)
        g = torch.Generator().manual_seed(2)
        d0 = torch.randn(37, 16, 128, generator=g).to(dev)
        d1 = torch.randn(37, 6, 128, generator=g).to(dev)
        got, want = (tgnn.gnn_scores(d0, d1, packed),
                     tgnn.gnn_scores_plain(d0, d1, packed))
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-2 * float(want.abs().max()))
        args = _pointconv_case(dev, torch.bfloat16, 37, 256, 128, 32, 64,
                               1.0, 11)
        got = tpc.pointconv_max(*args, 0.2, 32)
        want = tpc.pointconv_max_plain(*args, 0.2, 32)
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=1e-2 * float(want.float().abs().max()))
        pts = _fps_points(37, 256, 3).to(dev)
        idx, cent = tfps.farthest_point_sampling(pts, 128)
        widx, wcent = tfps.farthest_point_sampling_plain(pts, 128)
        assert torch.equal(idx, widx) and torch.equal(cent, wcent)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)
    for name in ("lstm", "sinkhorn", "superglue_gnn", "pointconv", "fps"):
        assert _build.LAUNCHES[name] == before.get(name, 0) + 1, name


def test_kernels_refuse_tensors_on_two_devices(cuda):
    """A wrapper given one input on the CPU and the rest on the card
    raises; nothing is moved for it."""
    tables, w_hh, tokens, lengths = _lstm_case(9, 37, 32)
    with pytest.raises(ValueError, match="different devices"):
        tlstm.lstm_final_hidden([t.to(cuda) for t in tables],
                                [w.to(cuda) for w in w_hh], tokens.to(cuda),
                                lengths)
    z, mu, nu = _sinkhorn_inputs(3, 17, 7, 60.0, 1)
    with pytest.raises(ValueError, match="different devices"):
        tsink.log_sinkhorn(z.to(cuda), mu, nu.to(cuda), 5)
    with pytest.raises(ValueError, match="different devices"):
        tsink.log_optimal_transport(z.to(cuda), torch.tensor(1.0), 5)
    packed = _packed(torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="different devices"):
        tgnn.gnn_scores(torch.zeros(2, 16, 128, device=cuda),
                        torch.zeros(2, 6, 128), packed)
    args = list(_pointconv_case(cuda, torch.float32, 2, 64, 32, 32, 64, 1.0,
                                1))
    args[1] = args[1].cpu()
    with pytest.raises(ValueError, match="not on a's device"):
        tpc.pointconv_max(*args, 0.2, 32)
