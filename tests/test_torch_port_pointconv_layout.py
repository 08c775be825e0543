"""Host side of the port's tensor-core PointConv kernel
(``text2pos_torch/ops/pointconv.py``, ``csrc/pointconv.cu`` namespace tc):
W2 in the ``mma.sync`` B operand's fragment order, packed once a level by
the model, the wrapper's checks, and the warp's ball query by ballot rank
(mirrored here, where no card is, against ``ball_neighbors``). The kernel
itself is held against the plain version on the card by
``test_torch_port_kernels.py``.
"""

import numpy as np
import pytest
import torch

from text2pos_torch.models.pointnet2 import SetAbstraction
from text2pos_torch.ops import pointconv as tpc
from text2pos_torch.ops import superglue_gnn as tgnn
from text2pos_torch.ops.neighbors import pairwise_sqdist

torch.set_num_threads(2)


@pytest.mark.parametrize("C1,C2", [(16, 64), (32, 64), (128, 128),
                                   (256, 256)])
def test_w2_fragments_round_trips(C1, C2):
    """The same order as the GNN kernel's weights, and back."""
    w = torch.from_numpy(np.random.default_rng(C1).standard_normal(
        (C1, C2)).astype(np.float32))
    f = tpc.w2_fragments(w)
    assert f.shape == (C2 // 8, C1 // 16, 32, 4) and f.is_contiguous()
    np.testing.assert_array_equal(f.numpy(), tgnn.to_fragment_order(w.numpy()))
    assert torch.equal(tgnn.from_fragment_order(f), w)


def test_w2_fragments_is_the_mma_b_operand():
    """Lane 4·g + t of the (n-tile, k-step) block holds column g of the tile
    at k = 2t, 2t + 1 (first register) and 2t + 8, 2t + 9 (second), and a
    non-contiguous W2 (the model's transposed weight) packs the same."""
    C1, C2 = 64, 128
    w = torch.arange(C1 * C2, dtype=torch.float32).reshape(C2, C1).t()
    f = tpc.w2_fragments(w)
    for nt, ks, lane in [(0, 0, 0), (15, 3, 31), (2, 1, 13), (7, 2, 6)]:
        g, t = lane // 4, lane % 4
        rows = 16 * ks + torch.tensor([2 * t, 2 * t + 1, 2 * t + 8,
                                       2 * t + 9])
        assert torch.equal(f[nt, ks, lane], w[rows, 8 * nt + g])


def test_w2_fragments_rejects_ragged_widths():
    with pytest.raises(ValueError):
        tpc.w2_fragments(torch.zeros(24, 64))


def warp_ball_rows(pos, cent, radius, k_cap):
    """The kernel's ``ball_query``, lane by lane: 32 points a ballot, four
    ballots a pass, each in-ball point ranked by the count so far plus the
    in-ball lanes below it, ranks under k_cap stored, stop after the pass
    that finds k_cap. Returns the [B, S, 32] index lists (-1 past the count)
    and the counts."""
    in_ball = (pairwise_sqdist(cent, pos) <= radius * radius).numpy()
    B, S, N = in_ball.shape
    nbr = np.full((B, S, 32), -1)
    cnt = np.zeros((B, S), np.int64)
    for b in range(B):
        for s in range(S):
            c = 0
            for base in range(0, N, 32):
                if base % 128 == 0 and c >= k_cap:
                    break
                ballot = in_ball[b, s, base:base + 32]
                ranks = c + np.cumsum(ballot) - ballot
                for lane in np.flatnonzero(ballot & (ranks < k_cap)):
                    nbr[b, s, ranks[lane]] = base + lane
                c += int(ballot.sum())
            cnt[b, s] = min(c, k_cap)
    return nbr, cnt


def _level(seed, B=3, N=100, S=20, C1=32, C2=64, dtype=torch.float32):
    """A level whose balls hold from none to more than 32 points: clusters
    of 0-45 points around the centroids, the rest far off. Centroid 0 stands
    apart with an empty ball; centroid 1's cluster, placed last, holds
    min(45, N) points."""
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-3, 3, (B, S, 3)).astype(np.float32)
    cent[:, 0] = -10.0
    pos = rng.uniform(20, 30, (B, N, 3)).astype(np.float32)
    for b in range(B):
        for s in range(S - 1, 0, -1):
            k = min(45, N) if s == 1 else rng.integers(0, min(45, N) + 1)
            at = rng.choice(N, k, replace=False)
            pos[b, at] = cent[b, s] + rng.uniform(-0.05, 0.05, (k, 3))
    g = torch.Generator().manual_seed(seed)
    vecs = [torch.rand(n, generator=g) + o for n, o in
            ((C1, 0.5), (C1, -0.5), (C2, -0.5), (C2, 0.5), (C2, -0.5))]
    return (torch.randn(B, N, C1, generator=g).to(dtype),
            torch.from_numpy(pos), (0.3 * torch.randn(B, S, C1,
                                                      generator=g)).to(dtype),
            torch.from_numpy(cent), (vecs[0], vecs[1]),
            (torch.randn(C1, C2, generator=g) / C1 ** 0.5).to(dtype),
            vecs[2], (vecs[3], vecs[4]))


@pytest.mark.parametrize("seed,N", [(0, 100), (1, 64), (2, 33), (3, 256)])
def test_warp_ballot_reproduces_ball_neighbors(seed, N):
    """Counts and index lists of the ballot selection equal the first k_cap
    in-ball points by index, over ragged last ballots of N."""
    args = _level(seed, N=N)
    pos, cent = args[1], args[3]
    nbr, cnt = warp_ball_rows(pos, cent, 0.2, 32)
    idx, valid = tpc.ball_neighbors(pos, cent, 0.2, 32)
    np.testing.assert_array_equal(cnt, valid.sum(-1).numpy())
    k = idx.shape[-1]
    got = np.where(valid.numpy(), nbr[..., :k], -1)
    np.testing.assert_array_equal(got, np.where(valid.numpy(), idx.numpy(),
                                                -1))
    assert cnt.max() == min(32, N) and cnt.min() == 0


@pytest.mark.parametrize("C1,C2", [(48, 64), (256, 512), (512, 64)])
def test_kernel_wrapper_rejects_bf16_widths_before_building(C1, C2):
    """Widths the bf16 kernel has no instantiation or shared memory for
    raise in the wrapper, before any build or launch."""
    args = _level(6, B=1, N=8, S=2, C1=C1, C2=C2, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tpc._pointconv_kernel(*args, 0.2, 32)


@pytest.mark.parametrize("C1,C2", [(516, 64), (30, 64), (32, 96),
                                   (32, 1088)])
def test_kernel_wrapper_rejects_f32_widths_before_building(C1, C2):
    """Widths the f32 kernel does not take (C1 past 512 or not a multiple
    of 4, C2 not a multiple of 64 or past 1024, whose rows of W2 it reads
    in 16-byte pieces) raise in the wrapper, before any build or launch."""
    args = _level(9, B=1, N=8, S=2, C1=C1, C2=C2)
    with pytest.raises(ValueError):
        tpc._pointconv_kernel(*args, 0.2, 32)


@pytest.mark.parametrize("bad", ["shape", "dtype", "layout"])
def test_kernel_wrapper_rejects_a_bad_packed_w2(bad):
    """A packed W2 that is not ``w2_fragments(w2)``'s shape, dtype or
    layout raises in the wrapper, before any build or launch."""
    args = _level(7, B=1, N=8, S=2, C1=32, C2=64, dtype=torch.bfloat16)
    w2f = tpc.w2_fragments(args[5])
    w2f = {"shape": w2f[:4], "dtype": w2f.float(),
           "layout": w2f.transpose(0, 1).contiguous().transpose(0, 1)}[bad]
    with pytest.raises(ValueError):
        tpc._pointconv_kernel(*args, 0.2, 32, w2f)


def test_set_abstraction_packs_w2_once():
    """The level packs W2 once and repacks it only when weights are loaded
    again; the CPU path gives the same output with or without it."""
    sa = SetAbstraction(3, 0.5, 0.2, (32, 64), torch.bfloat16)
    f = sa.w2_fragments()
    assert sa.w2_fragments() is f
    assert torch.equal(f, tpc.w2_fragments(
        sa.conv_mlp.dense_1.weight.detach().t().to(torch.bfloat16)))
    sd = {k: v + 1.0 if k == "conv_mlp.dense_1.weight" else v
          for k, v in sa.state_dict().items()}
    sa.load_state_dict(sd)
    g = sa.w2_fragments()
    assert g is not f
    assert torch.equal(g, tpc.w2_fragments(
        sd["conv_mlp.dense_1.weight"].t().to(torch.bfloat16)))
    args = _level(8, B=2, N=40, S=10, C1=32, C2=64, dtype=torch.bfloat16)
    torch.testing.assert_close(
        tpc.pointconv_max(*args, 0.2, 32, w2f=tpc.w2_fragments(args[5])),
        tpc.pointconv_max(*args, 0.2, 32), rtol=0, atol=0)
